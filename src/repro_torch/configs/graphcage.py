"""The paper's own configuration: the GraphCage graph-algorithm suite.

Mirrors the evaluation setup of the paper (§4): PR / SpMV / BC over a suite
of scale-free graphs, TOCAB block size as the tunable (Fig. 11), plus the
cache-model parameters of the GTX 1080Ti the paper measured on.  The
reference's fields and values (``repro.configs.graphcage``), but for the
window budget, which is the card's (half of the H100's L2, as
:func:`~repro_torch.core.partition.choose_block_size` sizes it), and
without the reference's fields that nothing reads: ``tune_db_dir``
('experiments/tune'; :func:`repro_torch.tune.db.default_dir` says where
the DB lives), ``retry_attempts`` (3), ``retry_base_delay`` (0.05),
``trial_timeout_s`` (None; ``python -m repro_torch.tune tune
--trial-timeout``) and ``allow_engine_fallback`` (None; the port's ladder
arms only on a call's own ``allow_fallback=True``).
"""
from __future__ import annotations

import dataclasses

from repro_torch.core.partition import L2_WINDOW_BYTES


@dataclasses.dataclass(frozen=True)
class GraphCageCfg:
    # graph suite (scaled-down, same generator family as Kron21/Twitter)
    scales: tuple = (14, 15, 16)
    edge_factor: int = 8
    # TOCAB
    block_size: int = 8192  # vertices per subgraph (Fig. 11 sweep default)
    fast_mem_bytes: int = L2_WINDOW_BYTES  # the window's budget on the card
    # paper GPU cache model (Fig. 9/10)
    llc_bytes: int = int(2.75 * 1024 * 1024)
    line_bytes: int = 128
    ways: int = 16
    # algorithms
    pr_damping: float = 0.85
    pr_tol: float = 1e-6
    bfs_alpha: float = 15.0
    # autotuner (repro_torch.tune) — the Fig. 11 sensitivity axes the
    # search sweeps around this config's defaults
    tune_block_sizes: tuple = (1024, 2048, 4096, 8192, 16384)
    tune_alphas: tuple = (4.0, 15.0, 64.0)
    tune_impls: tuple = ("slab", "fused")


DEFAULT = GraphCageCfg()
