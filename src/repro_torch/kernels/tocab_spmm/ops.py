"""Public TOCAB blocked SpMM: :class:`BlockedGraph` → phase-2 partial slabs
(:func:`tocab_spmm_partials`) or the global result (:func:`tocab_spmm`).

Two backends, picked by where the values lie:

* ``"cuda"`` — the hand-written kernel in :mod:`.kernel`, for tensors on
  the card.  A CUDA tensor reaches the kernel or the call raises; nothing
  falls back.
* ``"torch"`` — the plain version in :mod:`.ref`, for tensors on the CPU
  (and wherever ``use_ref=True`` asks for it).

``block_ids`` selects a subset of blocks, e.g. the dense bin of a
:class:`~repro_torch.core.balance.BlockSchedule`: the sparsity-aware
scheduler runs the kernel on dense subgraphs while the other bins take
cheaper paths.  Unlike the reference, nothing is padded or copied: the
kernel reads the unpadded values in place at each selected block's window,
at the features' own width.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch

from repro_torch.core.partition import BlockedGraph
from repro_torch.core.tocab import _require_direction, reduce_partials
from repro_torch.resilience import chaos as _chaos

from .kernel import tocab_spmm_cuda
from .ref import tocab_spmm_ref

__all__ = ["tocab_spmm", "tocab_spmm_partials", "MODES"]

#: the reference kernel's accumulation modes (one-hot matmul, VMEM
#: scatter); both compute one function, and the port has one kernel for it
MODES = ("onehot", "scatter")


def _block_id_tensor(bg: BlockedGraph, block_ids: Optional[Sequence[int]]
                     ) -> torch.Tensor:
    ids = range(bg.num_blocks) if block_ids is None else block_ids
    ids = [int(b) for b in ids]
    if any(not 0 <= b < bg.num_blocks for b in ids):
        raise ValueError(f"block_ids must lie in [0, {bg.num_blocks}), "
                         f"got {ids}")
    return torch.tensor(ids, dtype=torch.int32, device=bg.device)


def tocab_spmm_partials(
    bg: BlockedGraph,
    x: torch.Tensor,  # f32[n] or f32[n, d]
    mode: str = "onehot",
    use_ref: bool = False,
    block_ids: Optional[Sequence[int]] = None,
    unweighted: bool = False,
    local_budget: Optional[int] = None,
) -> torch.Tensor:
    """Phase-2 partial slabs of the blocked SpMM, sum semiring.

    Returns ``(k, local_budget)`` for a vector ``x`` or
    ``(k, local_budget, d)``, where ``k = len(block_ids)`` (every block
    when ``block_ids`` is None).  ``unweighted=True`` (or a layout without
    edge values) multiplies by nothing: the mask is the weight.
    ``local_budget`` overrides the layout's partial-slab width — the
    balanced scheduler passes the dense bin's compact budget.  ``mode`` is
    checked and changes nothing.  ``use_ref=True`` runs the plain version on
    any device."""
    _chaos.maybe_raise("kernel.tocab_spmm.op")  # opt-in fault-injection site
    _require_direction(bg, "pull")
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}; expected one of {MODES}")
    squeeze = x.ndim == 1
    tail = x.shape[1:]
    values = x.reshape(x.shape[0], -1).to(torch.float32).contiguous()
    ids = _block_id_tensor(bg, block_ids)
    edge_vals = None if unweighted else bg.edge_vals
    fn = tocab_spmm_ref if use_ref or not values.is_cuda else tocab_spmm_cuda
    partials = fn(values, bg.window_idx, bg.compact_idx, bg.edge_mask,
                  edge_vals, ids, block_size=bg.block_size,
                  local_budget=local_budget or bg.local_budget)
    if squeeze:
        return partials[:, :, 0]
    return partials.view(partials.shape[:2] + tail)


def tocab_spmm(
    bg: BlockedGraph,
    x: torch.Tensor,  # f32[n] or f32[n, d]
    mode: str = "onehot",
    use_ref: bool = False,
) -> torch.Tensor:
    """y = Aᵀ-gather-reduce of ``x`` through the TOCAB blocked layout:
    every block's partials, then the phase-3 reduction.  ``x`` may be
    ``(n,)`` (SpMV) or ``(n, d)`` (SpMM, GNN aggregation); the result has
    its rank."""
    partials = tocab_spmm_partials(bg, x, mode=mode, use_ref=use_ref)
    return reduce_partials(bg, partials, reduce="sum")
