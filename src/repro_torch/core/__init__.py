"""GraphCage core on PyTorch: TOCAB cache-aware graph processing.

Public surface:

* :mod:`repro_torch.core.graph` — CSR graph containers + generators
* :mod:`repro_torch.core.partition` — TOCAB static 1D blocking + local-ID
  compaction
* :mod:`repro_torch.core.balance` — build-time sparsity classification
  and the balanced engines
* :mod:`repro_torch.core.tocab` — blocked pull/push engines + reduction phase
* :mod:`repro_torch.core.pagerank` / :mod:`repro_torch.core.spmv` /
  :mod:`repro_torch.core.traversal` — the paper's benchmark algorithms
"""
from .graph import (  # noqa: F401
    DeviceGraph,
    Graph,
    GraphValidationError,
    device_graph_from_arrays,
    from_edges,
    graph_fingerprint,
    grid_graph,
    rmat_graph,
    uniform_random_graph,
    validate_graph,
)
from .partition import (  # noqa: F401
    REDUCE_IDENTITY,
    BlockedGraph,
    blocked_from_arrays,
    build_blocked,
    choose_block_size,
)
from .balance import (  # noqa: F401
    ADD_EDGE,
    BIN_NAMES,
    UNWEIGHTED,
    BlockSchedule,
    balanced_edge_reduce,
    balanced_pull,
    balanced_push,
    fused_block_order,
    make_schedule,
    require_schedule,
)
from .tocab import (  # noqa: F401
    baseline_pull,
    baseline_push,
    blocked_edge_values,
    cb_pull,
    reduce_partials,
    segment_reduce,
    timed,
    tocab_edge_reduce,
    tocab_gather_src,
    tocab_pull,
    tocab_pull_partials,
    tocab_push,
)
from .pagerank import PR_VARIANTS, pagerank, pagerank_iteration  # noqa: F401
from .spmv import SPMV_VARIANTS, spmv  # noqa: F401
from .traversal import (  # noqa: F401
    DEFAULT_ALPHA, INF_DEPTH, bc, bfs, connected_components, sssp,
)
