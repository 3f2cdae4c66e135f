"""Sparsity-aware load balancing for TOCAB subgraphs (paper
§load-balancing).

Blocked subgraphs are much sparser than the whole graph (paper Table 1),
so one edge mapping for every block wastes the cache wins.  Every block is
classified **once, at build time**, by edges per reduction row, and each
bin runs a strategy matched to it:

==========  =========================  =====================================
bin         edges/row                  strategy (pull)
==========  =========================  =====================================
``sparse``  < ``thresholds[0]``        flattened segment reduce keyed by
                                       block and compact id
``medium``  < ``thresholds[1]``        segmented reduce over the runs of
                                       equal (sorted) compact ids
``dense``   ≥ ``thresholds[1]``        the ``tocab_spmm`` CUDA kernel on
                                       the card (``dense_impl="cuda"``), or
                                       a sum of the real slots into the
                                       bin's slab (``"onehot"``; the
                                       kernel's rung under an explicit
                                       ``allow_fallback=True``)
==========  =========================  =====================================

The classification is carried on
:class:`~repro_torch.core.partition.BlockedGraph` as a static
:class:`BlockSchedule` that :func:`~repro_torch.core.partition.build_blocked`
attaches; each bin's block subset is a Python tuple.  Every engine records
per-bin block/edge counters into ``repro_torch.obs``.

Each strategy is one vectorized pass of torch ops over the bin's blocks.
The reference's forms that exist for XLA and the TPU's matrix unit — the
``lax.scan`` over 256-edge chunks and the one-hot matmuls of width
``row_budget + 1`` or ``block_size + 1`` — are not carried over: at the
H100 main path's shapes one block has ~400 K such chunks, and one push
one-hot is gigabytes.  Each strategy keeps the reference's name and
computes what the reference's computes.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.obs.metrics import registry as _obs
from repro_torch.resilience import chaos, degrade

from .partition import REDUCE_IDENTITY

__all__ = [
    "BIN_NAMES",
    "DEFAULT_THRESHOLDS",
    "BlockSchedule",
    "UNWEIGHTED",
    "ADD_EDGE",
    "make_schedule",
    "require_schedule",
    "fused_block_order",
    "balanced_pull_partials",
    "balanced_pull",
    "balanced_push",
    "balanced_edge_reduce",
    "bin_pull_partials",
    "default_dense_impl",
]

BIN_SPARSE, BIN_MEDIUM, BIN_DENSE = 0, 1, 2
BIN_NAMES = ("sparse", "medium", "dense")

#: edges-per-row cutoffs (sparse < t0 ≤ medium < t1 ≤ dense), the
#: reference's defaults.
DEFAULT_THRESHOLDS = (4.0, 32.0)


def UNWEIGHTED(msgs, edge_vals):
    """Sentinel ``combine`` that ignores edge values (PageRank on weighted
    graphs).  Engines recognize it by identity: the CUDA kernels then read
    no edge-value stream at all, and the dense bin stays on its kernel
    (a generic callable forces the scan strategy)."""
    return msgs


def ADD_EDGE(msgs, edge_vals):
    """Sentinel ``combine`` that adds the edge value to each message, or 1
    where the layout has none: traversal's relaxation ``d + w`` under
    ``min`` (SSSP), hop counts on an unweighted graph.  An ordinary
    callable for the torch engines; the CUDA fused kernels recognize it by
    identity and form the message in the kernel.  The dense bin treats it
    as any other callable."""
    return msgs + (edge_vals if edge_vals is not None else 1.0)


@dataclasses.dataclass(frozen=True)
class BlockSchedule:
    """Static sparsity classification of TOCAB blocks (hashable).

    ``bins[b]`` is the bin id (0=sparse, 1=medium, 2=dense) of block ``b``;
    the per-bin aggregates are precomputed host-side.
    """

    thresholds: Tuple[float, float]
    bins: Tuple[int, ...]
    blocks_per_bin: Tuple[int, int, int]
    edges_per_bin: Tuple[int, int, int]
    rows_per_bin: Tuple[int, int, int]
    # max reduction rows of any single block in the bin (8-aligned)
    row_budget_per_bin: Tuple[int, int, int] = (0, 0, 0)
    # max *compact-side* rows (n_local) of any block in the bin, 8-aligned
    # (bounds compact_idx; differs from row_budget_per_bin for push)
    compact_budget_per_bin: Tuple[int, int, int] = (0, 0, 0)

    @property
    def num_blocks(self) -> int:
        return len(self.bins)

    def blocks_in(self, bin_id: int) -> Tuple[int, ...]:
        return tuple(b for b, v in enumerate(self.bins) if v == bin_id)

    def summary(self) -> dict:
        return {
            name: {
                "blocks": self.blocks_per_bin[i],
                "edges": self.edges_per_bin[i],
                "rows": self.rows_per_bin[i],
            }
            for i, name in enumerate(BIN_NAMES)
        }


def make_schedule(
    n_edges: Sequence[int],
    n_rows: Sequence[int],
    thresholds: Union[Tuple[float, float], str] = DEFAULT_THRESHOLDS,
    n_compact_rows: Optional[Sequence[int]] = None,
) -> BlockSchedule:
    """Classify blocks by edges-per-row (host-side, build time).

    ``n_rows`` is the reduction-side row count of each block: compacted
    locals for pull, window vertices for push.  ``n_compact_rows`` is the
    compact-side count (``n_local``) when it differs from ``n_rows``.
    ``thresholds='auto'`` picks per-graph terciles of the observed
    edges-per-row distribution.
    """
    e = np.asarray(n_edges, dtype=np.float64)
    r = np.maximum(np.asarray(n_rows, dtype=np.float64), 1.0)
    epr = e / r
    if isinstance(thresholds, str):
        if thresholds != "auto":
            raise ValueError(f"unknown thresholds mode {thresholds!r}")
        live = epr[e > 0]
        if live.size == 0:
            lo, hi = DEFAULT_THRESHOLDS
        else:
            lo = float(np.quantile(live, 1 / 3))
            hi = max(float(np.quantile(live, 2 / 3)), lo + 1e-9)
    else:
        lo, hi = float(thresholds[0]), float(thresholds[1])
        if not lo <= hi:
            raise ValueError(f"thresholds must be ascending, got {(lo, hi)}")
    bins = np.where(epr < lo, BIN_SPARSE,
                    np.where(epr < hi, BIN_MEDIUM, BIN_DENSE))
    bins[e == 0] = BIN_SPARSE  # empty blocks ride the cheapest path
    rows = np.asarray(n_rows, dtype=np.int64)
    compact = (
        rows if n_compact_rows is None
        else np.asarray(n_compact_rows, dtype=np.int64)
    )

    def per_bin(arr):
        return tuple(int(arr[bins == b].sum()) for b in range(3))

    def budget(arr, b):
        sel = arr[bins == b]
        top = int(sel.max()) if sel.size else 0
        return max(8, -(-top // 8) * 8)

    return BlockSchedule(
        thresholds=(lo, hi),
        bins=tuple(int(b) for b in bins),
        blocks_per_bin=tuple(int((bins == b).sum()) for b in range(3)),
        edges_per_bin=per_bin(e),
        rows_per_bin=per_bin(rows),
        row_budget_per_bin=tuple(budget(rows, b) for b in range(3)),
        compact_budget_per_bin=tuple(budget(compact, b) for b in range(3)),
    )


def require_schedule(bg) -> BlockSchedule:
    if bg.schedule is None:
        raise ValueError(
            "BlockedGraph carries no BlockSchedule — rebuild with "
            "build_blocked(..., classify=True) (the default) or attach one "
            "via dataclasses.replace(bg, schedule=make_schedule(...))."
        )
    return bg.schedule


def fused_block_order(bg) -> Tuple[int, ...]:
    """Bin-major visit order for the fused engines: dense → medium → sparse
    (the reference streams heavy blocks first through its sequential
    grid).  Only valid where block order cannot change results: push
    (disjoint destination windows) always; pull only for order-insensitive
    semirings (min/max)."""
    sched = require_schedule(bg)
    return (sched.blocks_in(BIN_DENSE) + sched.blocks_in(BIN_MEDIUM)
            + sched.blocks_in(BIN_SPARSE))


#: the balanced dense bin's implementations (the reference's ``"pallas"``
#: is ``"cuda"`` here)
DENSE_IMPLS = ("cuda", "onehot")


def default_dense_impl(values: torch.Tensor) -> str:
    """The ``tocab_spmm`` CUDA kernel for a tensor on the card; the one-hot
    strategy's torch ops otherwise (the reference picks its Pallas kernel
    on the TPU and the one-hot matmul elsewhere)."""
    return "cuda" if values.is_cuda else "onehot"


def _resolve_dense_impl(dense_impl: Optional[str],
                        values: torch.Tensor) -> str:
    if dense_impl is None:
        return default_dense_impl(values)
    if dense_impl == "pallas":
        raise ValueError(
            "dense_impl='pallas' is the TPU kernel; the port's dense-bin "
            "kernel is dense_impl='cuda'")
    if dense_impl not in DENSE_IMPLS:
        raise ValueError(f"unknown dense_impl {dense_impl!r}; expected one "
                         f"of {DENSE_IMPLS}")
    if dense_impl == "cuda" and not values.is_cuda:
        raise ValueError("dense_impl='cuda' needs tensors on the card")
    return dense_impl


def _compact_budget(sched: BlockSchedule, bin_id: int,
                    local_budget: int) -> int:
    """Static slab width for reductions over ``compact_idx`` — the bin's
    compact-side budget, falling back to the classification-row budget
    (identical for pull) and then the global ``local_budget`` for
    hand-built schedules that carry neither."""
    rb = (sched.compact_budget_per_bin[bin_id]
          or sched.row_budget_per_bin[bin_id])
    return min(rb or local_budget, local_budget)


def _record_bins(bg, direction: str, engine: str):
    """Per-call telemetry of static per-bin facts (the reference records
    the same series once per trace)."""
    sched = bg.schedule
    if sched is None:
        return
    for i, name in enumerate(BIN_NAMES):
        _obs.counter(
            "tocab.balance.bin_traces", "balanced-engine traces by bin"
        ).inc(bin=name, direction=direction, engine=engine)
        _obs.gauge("tocab.balance.bin_blocks", "blocks per sparsity bin").set(
            sched.blocks_per_bin[i], bin=name, direction=direction)
        _obs.gauge("tocab.balance.bin_edges", "edges per sparsity bin").set(
            sched.edges_per_bin[i], bin=name, direction=direction)


# ====================================================================== #
# Shared subset helpers
# ====================================================================== #
def _rows(bg, ids: Tuple[int, ...]):
    """Index of the blocks ``ids`` (ascending) along dim 0, for reading
    and for writing: a slice when they are one contiguous run (reading it
    gives a view, no copy), else an index tensor."""
    lo, hi = ids[0], ids[-1] + 1
    if hi - lo == len(ids):
        return slice(lo, hi)
    return torch.tensor(ids, dtype=torch.long, device=bg.device)


def _take_blocks(bg, ids: Tuple[int, ...]):
    """The slabs of blocks ``ids``: ``(widx, cidx, mask, edge_vals, ids)``,
    ``ids`` as an int32 tensor."""
    rows = _rows(bg, ids)
    ev = None if bg.edge_vals is None else bg.edge_vals[rows]
    return (bg.window_idx[rows], bg.compact_idx[rows], bg.edge_mask[rows],
            ev, torch.tensor(ids, dtype=torch.int32, device=bg.device))


def _block_offsets(k: int, width: int, device) -> torch.Tensor:
    """``(k, 1)`` int64 start of each block's rows in a flat slab."""
    return (torch.arange(k, dtype=torch.long, device=device)
            * width)[:, None]


# ====================================================================== #
# Pull-layout reduction strategies (reduce blocked messages over compact_idx)
# ====================================================================== #
def _reduce_msgs_sparse(row_budget, cidx, mask, msgs, reduce):
    """Flattened segment reduce: padding goes to a drop row past each
    block's ``row_budget`` rows, and one reduction keyed by block and
    compact id fills every block's slab."""
    from .tocab import segment_reduce

    k = cidx.shape[0]
    lb1 = row_budget + 1
    flat = (torch.where(mask, cidx, row_budget).long()
            + _block_offsets(k, lb1, cidx.device))
    tail = msgs.shape[2:]
    partials = segment_reduce(msgs.reshape((-1,) + tail), flat.reshape(-1),
                              k * lb1, reduce, sorted_ids=True)
    return partials.view((k, lb1) + tail)[:, :row_budget]


def _reduce_msgs_scan(row_budget, cidx, mask, msgs, reduce):
    """Mid-density rows: a segmented reduce over runs.  Compact ids are
    sorted within each block (``build_blocked`` sorts a block's edges by
    compact id) and padding trails with the drop id ``row_budget``, so the
    flattened ids are sorted; each run of equal ids is reduced by
    ``torch.segment_reduce`` and written to its row once.  This is what the
    reference's chunked segmented scan (``lax.scan`` with a running-segment
    carry) computes, in one pass."""
    k = cidx.shape[0]
    lb1 = row_budget + 1
    tail = msgs.shape[2:]
    flat = (torch.where(mask, cidx, row_budget).long()
            + _block_offsets(k, lb1, cidx.device)).reshape(-1)
    keys, counts = torch.unique_consecutive(flat, return_counts=True)
    runs = torch.segment_reduce(msgs.reshape((-1,) + tail), reduce,
                                lengths=counts)
    slab = torch.full((k * lb1,) + tail, REDUCE_IDENTITY[reduce],
                      dtype=msgs.dtype, device=msgs.device)
    slab[keys] = runs
    return slab.view((k, lb1) + tail)[:, :row_budget]


def _reduce_msgs_onehot(row_budget, cidx, mask, msgs):
    """Dense-bin torch strategy, sum semiring: the real slots summed into
    the bin's ``(k, row_budget)`` slab.  The reference writes this sum as
    chunked one-hot matmuls for the TPU's matrix unit; the function is the
    same.  Slots with ``cidx ≥ row_budget`` drop, as they match no one-hot
    column there."""
    k = cidx.shape[0]
    tail = msgs.shape[2:]
    keep = mask & (cidx < row_budget)
    rows = (cidx.long() + _block_offsets(k, row_budget, cidx.device))[keep]
    slab = torch.zeros((k * row_budget,) + tail, dtype=msgs.dtype,
                       device=msgs.device)
    return slab.index_add_(0, rows, msgs[keep]).view((k, row_budget) + tail)


def _pull_msgs(bg, ids, values, reduce, combine):
    from .tocab import _edge_messages

    widx, cidx, mask, ev, idx = _take_blocks(bg, ids)
    src_global = widx + (idx * bg.block_size)[:, None]
    if combine is UNWEIGHTED:
        ev, combine = None, None
    msgs = _edge_messages(values, src_global, ev, mask, reduce, combine)
    return cidx, mask, msgs


def _dense_eligible(reduce: str, combine) -> bool:
    return reduce == "sum" and (combine is None or combine is UNWEIGHTED)


def bin_pull_partials(
    bg,
    bin_id: int,
    values: torch.Tensor,
    reduce: str = "sum",
    combine: Optional[Callable] = None,
    dense_impl: Optional[str] = None,
    allow_fallback: bool = False,
):
    """Phase-2 partials of one sparsity bin (its blocks only, in schedule
    order), at the bin's static compact-row budget: shape
    ``(k, budget, …)``, or None for an empty bin.  Exposed so benchmarks
    can time bins individually.  On the dense bin (sum semiring, no combine
    or ``UNWEIGHTED``) ``dense_impl='cuda'``, the default for tensors on
    the card, launches the ``tocab_spmm`` kernel and raises for tensors
    elsewhere; ``'onehot'``, the default elsewhere, sums with torch ops.
    ``allow_fallback=True`` (only an engine call that carried it passes
    it) arms the cuda → onehot rung for values on the CPU (where the
    kernel's plain version runs): an injected ``kernel.tocab_spmm`` fault
    hands the bin to the one-hot strategy.  On the card, and without the
    opt-in, the failure raises."""
    sched = require_schedule(bg)
    ids = sched.blocks_in(bin_id)
    if not ids:
        return None
    rb = _compact_budget(sched, bin_id, bg.local_budget)
    if bin_id == BIN_DENSE and _dense_eligible(reduce, combine):

        def _onehot():
            cidx, mask, msgs = _pull_msgs(bg, ids, values, reduce, combine)
            return _reduce_msgs_onehot(rb, cidx, mask, msgs)

        if _resolve_dense_impl(dense_impl, values) != "cuda":
            return _onehot()

        def _cuda():
            chaos.maybe_raise("kernel.tocab_spmm")
            from repro_torch.kernels.tocab_spmm.ops import tocab_spmm_partials

            return tocab_spmm_partials(
                bg, values, block_ids=ids, local_budget=rb,
                unweighted=combine is UNWEIGHTED)

        if not degrade.fallback_allowed(allow_fallback, values.device):
            return _cuda()
        return degrade.dispatch("tocab_spmm", bg.fingerprint,
                                [("cuda", _cuda), ("onehot", _onehot)])
    cidx, mask, msgs = _pull_msgs(bg, ids, values, reduce, combine)
    if bin_id == BIN_SPARSE:
        return _reduce_msgs_sparse(rb, cidx, mask, msgs, reduce)
    return _reduce_msgs_scan(rb, cidx, mask, msgs, reduce)


def balanced_pull_partials(
    bg,
    values: torch.Tensor,
    reduce: str = "sum",
    combine: Optional[Callable] = None,
    dense_impl: Optional[str] = None,
    allow_fallback: bool = False,
):
    """Sparsity-aware phase 2: every bin runs its matched strategy; results
    land in the same ``(num_blocks, local_budget, …)`` slab as the uniform
    path, so phase 3 (:func:`repro_torch.core.tocab.reduce_partials`) is
    unchanged.  ``allow_fallback`` as in :func:`bin_pull_partials`."""
    from .tocab import _check_reduce, _require_direction

    _require_direction(bg, "pull")
    _check_reduce(reduce)
    sched = require_schedule(bg)
    partials = torch.full((bg.num_blocks, bg.local_budget) + values.shape[1:],
                          REDUCE_IDENTITY[reduce], dtype=values.dtype,
                          device=values.device)
    for bin_id in range(len(BIN_NAMES)):
        sub = bin_pull_partials(bg, bin_id, values, reduce, combine,
                                dense_impl, allow_fallback)
        if sub is None:
            continue
        # bin partials are budget-wide; rows beyond stay at the identity
        rows = _rows(bg, sched.blocks_in(bin_id))
        partials[rows, : sub.shape[1]] = sub.to(values.dtype)
    return partials


def balanced_pull(
    bg,
    values: torch.Tensor,
    reduce: str = "sum",
    combine: Optional[Callable] = None,
    dense_impl: Optional[str] = None,
    allow_fallback: bool = False,
):
    """Sparsity-aware TOCAB pull — equal to ``tocab_pull`` up to float
    reassociation (each bin reduces the same edge sets).
    ``allow_fallback`` as in :func:`bin_pull_partials`."""
    from .tocab import reduce_partials

    _record_bins(bg, "pull", "balanced_pull")
    partials = balanced_pull_partials(bg, values, reduce, combine,
                                      dense_impl, allow_fallback)
    return reduce_partials(bg, partials, reduce)


# ====================================================================== #
# Push direction: per-bin strategies over disjoint destination windows
# ====================================================================== #
def _push_msgs(bg, ids, values, reduce, combine):
    """Per-edge messages for a subset of push blocks (gather each distinct
    source once via ``id_map``, fan out per edge) — as ``tocab_push``."""
    from .tocab import _push_messages

    widx, cidx, mask, ev, _ = _take_blocks(bg, ids)
    if combine is UNWEIGHTED:
        ev, combine = None, None
    msgs = _push_messages(values, bg.id_map[_rows(bg, ids)], cidx, ev, mask,
                          reduce, combine)
    return widx, mask, msgs


def _push_window_sparse(bg, widx, mask, msgs, reduce):
    """Flattened segment reduce into the blocks' windows, padding to one
    drop segment past them."""
    from .tocab import segment_reduce

    k = widx.shape[0]
    tail = msgs.shape[2:]
    local_dst = torch.where(
        mask, widx.long() + _block_offsets(k, bg.block_size, widx.device),
        k * bg.block_size)
    acc = segment_reduce(msgs.reshape((-1,) + tail), local_dst.reshape(-1),
                         k * bg.block_size + 1, reduce)[:-1]
    return acc.view((k, bg.block_size) + tail)


def _push_window_chunked(bg, widx, mask, msgs, reduce):
    """Mid-density push: the real slots alone reduced into the blocks'
    dense window accumulators (the windows are disjoint, so the write-back
    is a reshape).  The reference folds fixed edge chunks in under
    ``lax.scan``; the function is the same."""
    from .tocab import segment_reduce

    k = widx.shape[0]
    tail = msgs.shape[2:]
    dst = (widx.long() + _block_offsets(k, bg.block_size, widx.device))[mask]
    acc = segment_reduce(msgs[mask], dst, k * bg.block_size, reduce)
    return acc.view((k, bg.block_size) + tail)


def _push_window_onehot(bg, widx, mask, msgs):
    """Dense-bin push, sum semiring: the reference's one-hot matmul onto
    the window, computed as the real slots' sum into it."""
    return _push_window_chunked(bg, widx, mask, msgs, "sum")


def balanced_push(
    bg,
    values: torch.Tensor,
    reduce: str = "sum",
    combine: Optional[Callable] = None,
):
    """Sparsity-aware TOCAB push.  Every bin accumulates into its blocks'
    dense destination windows; windows are disjoint and contiguous, so the
    global result is a reshape and a slice (no cross-bin conflicts)."""
    from .tocab import _check_reduce, _require_direction

    _require_direction(bg, "push")
    _check_reduce(reduce)
    sched = require_schedule(bg)
    _record_bins(bg, "push", "balanced_push")
    tail = values.shape[1:]
    full = torch.full((bg.num_blocks, bg.block_size) + tail,
                      REDUCE_IDENTITY[reduce], dtype=values.dtype,
                      device=values.device)
    for bin_id in range(len(BIN_NAMES)):
        ids = sched.blocks_in(bin_id)
        if not ids:
            continue
        widx, mask, msgs = _push_msgs(bg, ids, values, reduce, combine)
        if bin_id == BIN_DENSE and _dense_eligible(reduce, combine):
            slab = _push_window_onehot(bg, widx, mask, msgs)
        elif bin_id in (BIN_MEDIUM, BIN_DENSE):
            slab = _push_window_chunked(bg, widx, mask, msgs, reduce)
        else:
            slab = _push_window_sparse(bg, widx, mask, msgs, reduce)
        full[_rows(bg, ids)] = slab.to(full.dtype)
        del widx, mask, msgs, slab  # free this bin's before the next bin's
    return full.view((bg.num_blocks * bg.block_size,) + tail)[: bg.n]


# ====================================================================== #
# Edge-value reduce (GNN primitive) through the same bins
# ====================================================================== #
def balanced_edge_reduce(
    bg,
    flat_edge_vals: torch.Tensor,
    reduce: str = "sum",
):
    """Sparsity-aware twin of :func:`repro_torch.core.tocab.tocab_edge_reduce`:
    per-edge values (original order) reduced to the compacted side, with
    each bin on its matched strategy.  The dense bin takes the one-hot
    strategy: the messages have no separate values / edge-values factors,
    so the ``tocab_spmm`` kernel does not apply."""
    from .tocab import (_bcast, _check_reduce, blocked_edge_values,
                        reduce_partials)

    _check_reduce(reduce)
    sched = require_schedule(bg)
    _record_bins(bg, bg.direction, "balanced_edge_reduce")
    vals = blocked_edge_values(bg, flat_edge_vals)
    vals = torch.where(_bcast(bg.edge_mask, vals.ndim), vals,
                       REDUCE_IDENTITY[reduce])
    tail = vals.shape[2:]
    partials = torch.full((bg.num_blocks, bg.local_budget) + tail,
                          REDUCE_IDENTITY[reduce], dtype=vals.dtype,
                          device=vals.device)
    for bin_id in range(len(BIN_NAMES)):
        ids = sched.blocks_in(bin_id)
        if not ids:
            continue
        # compact_idx is bounded by n_local, so the slab width comes from
        # the compact budget — row_budget_per_bin is the *window* side on
        # push layouts and would under-size the scatter
        rb = _compact_budget(sched, bin_id, bg.local_budget)
        rows = _rows(bg, ids)
        cidx, mask, msgs = bg.compact_idx[rows], bg.edge_mask[rows], vals[rows]
        if bin_id == BIN_DENSE and reduce == "sum":
            sub = _reduce_msgs_onehot(rb, cidx, mask, msgs)
        elif bin_id == BIN_SPARSE:
            sub = _reduce_msgs_sparse(rb, cidx, mask, msgs, reduce)
        else:
            sub = _reduce_msgs_scan(rb, cidx, mask, msgs, reduce)
        partials[rows, : sub.shape[1]] = sub.to(partials.dtype)
    return reduce_partials(bg, partials, reduce)
