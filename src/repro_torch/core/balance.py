"""Sparsity classification of TOCAB subgraphs (paper §load-balancing), the
host half: the build-time :class:`BlockSchedule` that
:func:`~repro_torch.core.partition.build_blocked` attaches, the
``UNWEIGHTED`` combine sentinel, and the fused engines' block visit order.

Blocks are binned once, at build time, by edges per reduction row:

==========  =========================
bin         edges/row
==========  =========================
``sparse``  < ``thresholds[0]``
``medium``  < ``thresholds[1]``
``dense``   ≥ ``thresholds[1]``
==========  =========================

The per-bin execution strategies of the reference (``balanced_pull`` and
friends, ``schedule="balanced"``) are not ported yet.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple, Union

import numpy as np

__all__ = [
    "BIN_NAMES",
    "DEFAULT_THRESHOLDS",
    "BlockSchedule",
    "UNWEIGHTED",
    "make_schedule",
    "require_schedule",
    "fused_block_order",
]

BIN_SPARSE, BIN_MEDIUM, BIN_DENSE = 0, 1, 2
BIN_NAMES = ("sparse", "medium", "dense")

#: edges-per-row cutoffs (sparse < t0 ≤ medium < t1 ≤ dense), the
#: reference's defaults.
DEFAULT_THRESHOLDS = (4.0, 32.0)


def UNWEIGHTED(msgs, edge_vals):
    """Sentinel ``combine`` that ignores edge values (PageRank on weighted
    graphs).  Engines recognize it by identity: the CUDA kernels then read
    no edge-value stream at all."""
    return msgs


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
