"""Plain PyTorch versions of the fused TOCAB kernels.

The fused pipeline never materializes the ``(num_blocks, local_budget)``
partial slab: each block's messages go straight into the output.  These
versions compute the same function with whole-layout torch ops — one gather
of the per-edge messages, one scatter-reduce keyed by each edge's global
output row — so they run on any device.  ``fused_pull`` / ``fused_push``
use them for tensors on the CPU; the tests and ``chip_smoke.py`` hold the
CUDA kernels against them on the card.  ``fused_edge_reduce_ref`` is the
port of ``fused_edge_reduce`` itself (the reference has no Pallas kernel
for it).

The sum semiring adds in another order than the reference's
scan-over-blocks (``repro/kernels/tocab_fused/ref.py``): equal up to
summation order.  min/max are exact.
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import torch

from repro_torch.core.partition import REDUCE_IDENTITY, BlockedGraph
from repro_torch.core.tocab import (
    _bcast, _edge_messages, _push_windows, _reduce_to_compact_side,
    _require_direction, blocked_edge_values,
)

__all__ = ["fused_pull_ref", "fused_push_ref", "fused_edge_reduce_ref",
           "check_block_order"]


def _apply_epilogue(out, epilogue):
    if epilogue is None:
        return out
    mul, add = epilogue
    return out * mul + add


def check_block_order(bg: BlockedGraph, order: Optional[Sequence[int]]):
    """Validate a block visit order: ``None`` or a permutation of the
    blocks.  The result of these versions and of the CUDA kernels does not
    depend on it (whole-layout reductions; CTAs run in no order)."""
    if order is None:
        return None
    order = tuple(int(b) for b in order)
    if sorted(order) != list(range(bg.num_blocks)):
        raise ValueError(
            f"block_order must be a permutation of range({bg.num_blocks})")
    return order


def fused_pull_ref(
    bg: BlockedGraph,
    values: torch.Tensor,
    reduce: str = "sum",
    combine: Optional[Callable] = None,
    epilogue: Optional[Tuple] = None,
    block_order: Optional[Sequence[int]] = None,
):
    """out[dst] = ⊕ values[src] (⊗ edge_val), then ``out*mul + add``."""
    _require_direction(bg, "pull")
    check_block_order(bg, block_order)
    src_global = bg.window_idx + bg.window_lo()[:, None]
    msgs = _edge_messages(values, src_global, bg.edge_vals, bg.edge_mask,
                          reduce, combine)
    return _apply_epilogue(_reduce_to_compact_side(bg, msgs, reduce),
                           epilogue)


def fused_push_ref(
    bg: BlockedGraph,
    values: torch.Tensor,
    reduce: str = "sum",
    combine: Optional[Callable] = None,
    epilogue: Optional[Tuple] = None,
    block_order: Optional[Sequence[int]] = None,
):
    """Push: every block reduces into its own disjoint destination window,
    then ``out*mul + add``."""
    check_block_order(bg, block_order)
    return _apply_epilogue(_push_windows(bg, values, reduce, combine),
                           epilogue)


def fused_edge_reduce_ref(
    bg: BlockedGraph,
    flat_edge_vals: torch.Tensor,
    reduce: str = "sum",
    epilogue: Optional[Tuple] = None,
):
    """Edge values → compacted-side aggregate without the partial slab.
    The ``(num_blocks, edge_budget)`` blocked edge-value slab is the input
    layout; what is left out is the ``(num_blocks, local_budget)`` partial
    intermediate."""
    vals = blocked_edge_values(bg, flat_edge_vals)
    vals = torch.where(_bcast(bg.edge_mask, vals.ndim), vals,
                       REDUCE_IDENTITY[reduce])
    return _apply_epilogue(_reduce_to_compact_side(bg, vals, reduce),
                           epilogue)
