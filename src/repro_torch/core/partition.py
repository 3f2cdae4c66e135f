"""TOCAB static 1D blocking with local-ID compaction (paper §3.1).

Pull direction = *column blocking*: edges are grouped by the block of their
**source** vertex, so the randomly-read ``contributions`` array is confined to
a cache-sized contiguous window per block.  Destinations touched by a block
are compacted to dense local IDs; partial results go to a dense
``partial_sums[local_budget]`` slab and are merged in a second reduction
phase (or, fused, straight into the output).

Push direction = *row blocking*: identical code path on the transposed roles
(the paper: "the same preprocessing code works for both push and pull").

Every block owns an identical-shape padded slab, as in the reference
(``repro.core.partition``); :func:`build_blocked` reproduces the reference's
layout slot for slot, computed with torch sort / scan ops on the device that
will hold it.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.obs.trace import span
from .graph import Graph, GraphValidationError, graph_fingerprint, \
    validate_graph

__all__ = ["BlockedGraph", "build_blocked", "blocked_from_arrays",
           "choose_block_size", "REDUCE_IDENTITY", "L2_WINDOW_BYTES"]

# Bin thresholds forwarded to repro_torch.core.balance.make_schedule.
DEFAULT_BIN_THRESHOLDS = (4.0, 32.0)

# Identity elements per reduction op (used to neutralize padded edge slots).
REDUCE_IDENTITY = {
    "sum": 0.0,
    "min": float("inf"),
    "max": float("-inf"),
}

#: H100 L2 cache (NVIDIA H100 data sheet: 50 MB).
H100_L2_BYTES = 50 * 1024 * 1024

#: Default value-window budget: half of the H100's L2.  The window is what
#: TOCAB keeps cache-resident while a block's edges stream past it; the
#: other half is left to what every block touches besides its window — the
#: edge slabs streaming through, the ``id_map`` lookups and the
#: read-modify-write traffic of the output rows the block's atomics hit.
#: A window sized to the whole L2 would be evicted by that traffic.
L2_WINDOW_BYTES = H100_L2_BYTES // 2


def _roundup(x: int, to: int) -> int:
    return int(math.ceil(max(x, 1) / to) * to)


@dataclasses.dataclass(frozen=True)
class BlockedGraph:
    """TOCAB blocked-CSR representation (static shapes, tensors on one
    device).

    Role of the two index planes depends on ``direction``:

    =============  =======================  =======================
    field          pull (column blocking)   push (row blocking)
    =============  =======================  =======================
    window_idx     src − block·B (gather    dst − block·B (scatter
                   side, contiguous cache   side, contiguous window
                   window of values)        of the output)
    compact_idx    dst local ID (scatter    src local ID (gather
                   side → partial_sums)     side → block_contrib)
    id_map         local dst → global dst   local src → global src
    =============  =======================  =======================
    """

    n: int
    m: int
    direction: str
    block_size: int
    num_blocks: int
    edge_budget: int
    local_budget: int
    window_idx: torch.Tensor  # int32[num_blocks, edge_budget]
    compact_idx: torch.Tensor  # int32[num_blocks, edge_budget]
    edge_mask: torch.Tensor  # bool[num_blocks, edge_budget]
    id_map: torch.Tensor  # int32[num_blocks, local_budget]  (pad = n)
    n_local: torch.Tensor  # int32[num_blocks]
    n_edges: torch.Tensor  # int32[num_blocks]
    edge_perm: Optional[torch.Tensor] = None  # int32[nb, eb] edge id (pad = m)
    edge_vals: Optional[torch.Tensor] = None  # f32[num_blocks, edge_budget]
    # distinct window-side vertices per block (reduction rows in push)
    n_window: Optional[torch.Tensor] = None  # int32[num_blocks]
    # static sparsity classification (repro_torch.core.balance.BlockSchedule)
    schedule: Optional[object] = None
    # structural fingerprint of the source graph
    fingerprint: Optional[str] = None

    @property
    def num_subgraphs(self) -> int:  # paper Table 4 metric
        return self.num_blocks

    @property
    def flat_partial_size(self) -> int:
        return self.num_blocks * self.local_budget

    @property
    def device(self) -> torch.device:
        return self.window_idx.device

    def padding_fraction(self) -> float:
        return 1.0 - self.m / (self.num_blocks * self.edge_budget)

    def window_lo(self) -> torch.Tensor:
        """Per-block start of the contiguous window (int32[num_blocks])."""
        return torch.arange(self.num_blocks, dtype=torch.int32,
                            device=self.device) * self.block_size


def choose_block_size(
    n: int,
    value_bytes: int = 4,
    fast_mem_bytes: int = L2_WINDOW_BYTES,
    align: int = 128,
) -> int:
    """Pick the source-window size so the value window fits the cache
    budget.  The paper sizes TOCAB windows to a GPU's L2 (256-vertex blocks
    for a 2.75 MB L2); on the H100 the default budget is half of its 50 MB
    L2 (:data:`L2_WINDOW_BYTES`, reason there) — 6,553,600 fp32 values."""
    bs = min(max(align, fast_mem_bytes // value_bytes), max(n, align))
    return _roundup(bs, align)


def _as_numpy(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy()


def build_blocked(
    g: Graph,
    block_size: Optional[int] = None,
    direction: str = "pull",
    pad_edges_to: int = 128,
    pad_locals_to: int = 8,
    fast_mem_bytes: int = L2_WINDOW_BYTES,
    classify: bool = True,
    bin_thresholds: Union[Tuple[float, float], str] = DEFAULT_BIN_THRESHOLDS,
    validate: Optional[str] = None,
    device="cuda",
) -> BlockedGraph:
    """TOCAB preprocessing (paper §3.1 phase 1), computed on ``device`` (the
    card unless the caller names another) where the layout will live.

    ``direction='pull'`` blocks by source range; ``'push'`` by destination
    range.  Edges within a block are sorted by their *scatter-side* index so
    accumulation is segment-contiguous.  ``classify=True`` attaches the
    build-time sparsity :class:`~repro_torch.core.balance.BlockSchedule`.
    ``validate="cheap"`` / ``"full"`` runs CSR validation on ``g`` first;
    padded slab sizes are always checked against int32 addressing.

    The result equals ``repro.core.build_blocked`` field for field: the
    reference's ``np.lexsort((compact, block))`` is one stable sort of the
    key ``block·n + compact``, and its ``np.*.at`` passes are scatters.

    Traced (:mod:`repro_torch.obs.trace`), the build is a
    ``partition.build_blocked`` span whose children end at the build's
    own host reads: ``partition.upload``, ``.sort``, ``.compaction``,
    ``.slab_fill`` (no read: its device work is waited for in
    ``.schedule``, and its device markers time it), ``.schedule`` and
    ``.fingerprint``."""
    if direction not in ("pull", "push"):
        raise ValueError(f"unknown direction {direction!r}")
    if validate is not None:
        validate_graph(g, level=validate)
    if block_size is None:
        block_size = choose_block_size(g.n, fast_mem_bytes=fast_mem_bytes)
    n, m = g.n, g.m
    with span("partition.build_blocked", device=device,
              direction=direction, n=n, m=m):
        with span("partition.upload", device=device):
            i64 = dict(dtype=torch.int64)
            rowptr = torch.from_numpy(
                np.ascontiguousarray(g.rowptr, np.int64)).to(device)
            dev = rowptr.device
            src = torch.repeat_interleave(
                torch.arange(n, device=dev, **i64),
                rowptr[1:] - rowptr[:-1], output_size=m)
            del rowptr
            dst = torch.from_numpy(
                np.ascontiguousarray(g.colidx, np.int32)).to(dev).long()
            # pull: gather from the src window, compact dst; push: scatter
            # to the dst window, compact src
            if direction == "pull":
                window_g, compact_g = src, dst
            else:
                window_g, compact_g = dst, src
            del src, dst

        with span("partition.sort", device=dev):
            num_blocks = max(1, -(-n // block_size))
            # Distinct window-side vertices per block — the reduction-row
            # count of the push direction.  A window vertex lies in exactly
            # one block, so this counts the vertices of each block with any
            # window-side edge.
            touched = torch.zeros(num_blocks * block_size,
                                  dtype=torch.int32, device=dev)
            touched[window_g] = 1
            n_window = touched.view(num_blocks, block_size).sum(
                1, dtype=torch.int32)
            del touched

            # Sort edges by (block, compact-global): blocked CSR with the
            # compacted side contiguous (local-ID assignment becomes a
            # run-length pass, and the scatter side is sorted for the
            # kernels).  Stable, like lexsort.
            blk = torch.div(window_g, block_size, rounding_mode="floor")
            order = torch.sort(blk * n + compact_g, stable=True).indices
            blk, window_g = blk[order], window_g[order]
            compact_g = compact_g[order]

            edge_counts = torch.bincount(blk, minlength=num_blocks)
            max_count = int(edge_counts.max()) if m else 0
            edge_budget = _roundup(max(max_count, 1), pad_edges_to)

        with span("partition.compaction", device=dev):
            # Local-ID compaction: within each block, unique compact-side
            # vertices in sorted order get ids 0..n_local-1 (paper Fig. 4).
            new_run = torch.ones(m, dtype=torch.bool, device=dev)
            if m > 1:
                new_run[1:] = ((blk[1:] != blk[:-1])
                               | (compact_g[1:] != compact_g[:-1]))
            run_id = torch.cumsum(new_run, 0) - 1  # global run index
            first_edge = torch.cumsum(edge_counts, 0) - edge_counts
            has_edges = edge_counts > 0
            block_start_run = torch.zeros(num_blocks, device=dev, **i64)
            block_start_run[has_edges] = run_id[first_edge[has_edges]]
            local_id = run_id - torch.repeat_interleave(
                block_start_run, edge_counts, output_size=m)
            del run_id
            n_local = torch.zeros(num_blocks, device=dev, **i64)
            if m:
                n_local.scatter_reduce_(0, blk, local_id + 1, reduce="amax")
            local_budget = _roundup(max(int(n_local.max()), 1),
                                    pad_locals_to)

        # Padded slabs are flattened and indexed with int32 downstream (the
        # phase-3 segment reduce, the kernels' id maps) — overflow here would
        # wrap silently at runtime, so it is always a hard error.
        int32_max = np.iinfo(np.int32).max
        for what, size in (("edge", num_blocks * edge_budget),
                           ("partial", num_blocks * local_budget)):
            if size > int32_max:
                raise GraphValidationError(
                    "budget_overflow",
                    f"flat {what} slab has {size} entries "
                    f"(num_blocks={num_blocks}), exceeding int32 addressing")

        with span("partition.slab_fill", device=dev):
            # --- fill padded slabs ---
            shape_e = (num_blocks, edge_budget)
            slot = torch.arange(m, device=dev, **i64) - \
                torch.repeat_interleave(first_edge, edge_counts,
                                        output_size=m)
            flat = blk * edge_budget + slot
            del slot
            window_idx = torch.zeros(shape_e, dtype=torch.int32, device=dev)
            window_idx.view(-1)[flat] = (
                window_g - blk * block_size).to(torch.int32)
            del window_g
            compact_idx = torch.zeros(shape_e, dtype=torch.int32, device=dev)
            compact_idx.view(-1)[flat] = local_id.to(torch.int32)
            edge_mask = torch.zeros(shape_e, dtype=torch.bool, device=dev)
            edge_mask.view(-1)[flat] = True
            edge_perm = torch.full(shape_e, m, dtype=torch.int32, device=dev)
            # the original edge index
            edge_perm.view(-1)[flat] = order.to(torch.int32)
            edge_vals = None
            if g.vals is not None:
                vals = torch.from_numpy(
                    np.ascontiguousarray(g.vals, np.float32))
                edge_vals = torch.zeros(shape_e, dtype=torch.float32,
                                        device=dev)
                edge_vals.view(-1)[flat] = vals.to(dev)[order]
                del vals
            del flat, order
            id_map = torch.full((num_blocks, local_budget), n,
                                dtype=torch.int32, device=dev)
            id_map.view(-1)[blk[new_run] * local_budget
                            + local_id[new_run]] = \
                compact_g[new_run].to(torch.int32)
            del blk, local_id, compact_g, new_run

        with span("partition.schedule", device=dev):
            schedule = None
            if classify:
                from .balance import make_schedule

                counts_h = _as_numpy(edge_counts)
                n_local_h = _as_numpy(n_local)
                rows = (n_local_h if direction == "pull"
                        else _as_numpy(n_window))
                schedule = make_schedule(counts_h, rows,
                                         thresholds=bin_thresholds,
                                         n_compact_rows=n_local_h)
        with span("partition.fingerprint"):
            fingerprint = graph_fingerprint(g)

    return BlockedGraph(
        n=n,
        m=m,
        direction=direction,
        block_size=int(block_size),
        num_blocks=int(num_blocks),
        edge_budget=int(edge_budget),
        local_budget=int(local_budget),
        window_idx=window_idx,
        compact_idx=compact_idx,
        edge_mask=edge_mask,
        id_map=id_map,
        n_local=n_local.to(torch.int32),
        n_edges=edge_counts.to(torch.int32),
        edge_perm=edge_perm,
        edge_vals=edge_vals,
        n_window=n_window,
        schedule=schedule,
        fingerprint=fingerprint,
    )


#: BlockedGraph fields that hold arrays, with their dtypes
_ARRAY_FIELDS = {
    "window_idx": np.int32, "compact_idx": np.int32, "edge_mask": np.bool_,
    "id_map": np.int32, "n_local": np.int32, "n_edges": np.int32,
    "edge_perm": np.int32, "edge_vals": np.float32, "n_window": np.int32,
}

#: BlockedGraph fields that hold plain metadata
_META_FIELDS = ("n", "m", "direction", "block_size", "num_blocks",
                "edge_budget", "local_budget")


def blocked_from_arrays(arrays: dict, meta: dict,
                        device="cuda") -> BlockedGraph:
    """Build a :class:`BlockedGraph` on ``device`` from numpy arrays named
    like its array fields and ``meta`` holding its metadata fields — e.g.
    the fields of a reference ``repro.core.BlockedGraph`` — so both
    packages can run on one identical layout.  ``meta["schedule"]``, when
    present, is a dict of :class:`~repro_torch.core.balance.BlockSchedule`
    fields."""
    from .balance import BlockSchedule

    kw = {k: meta[k] for k in _META_FIELDS}
    for name, dtype in _ARRAY_FIELDS.items():
        a = arrays.get(name)
        kw[name] = None if a is None else torch.from_numpy(
            np.array(a, dtype=dtype)).to(device)
    sched = meta.get("schedule")
    if sched is not None:
        sched = BlockSchedule(**{k: tuple(v) if isinstance(v, (list, tuple))
                                 else v for k, v in sched.items()})
    return BlockedGraph(schedule=sched, fingerprint=meta.get("fingerprint"),
                        **kw)
