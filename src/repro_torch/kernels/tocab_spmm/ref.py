"""Plain PyTorch version of the TOCAB blocked SpMM kernel.

It takes what the CUDA kernel takes — the unpadded ``(n, d)`` values, read
in place, and the stored slabs of the whole layout with the ids of the
blocks to reduce — and computes the same function with whole-subset torch
ops, so it runs on any device.  ``tocab_spmm_partials`` uses it for tensors
on the CPU; the tests and ``chip_smoke.py`` hold the kernel against it on
the card.
"""
from __future__ import annotations

from typing import Optional

import torch

__all__ = ["tocab_spmm_ref"]


def tocab_spmm_ref(
    values: torch.Tensor,  # f32[n, d]
    window_idx: torch.Tensor,  # i32[num_blocks, edge_budget]
    compact_idx: torch.Tensor,  # i32[num_blocks, edge_budget]
    edge_mask: torch.Tensor,  # bool[num_blocks, edge_budget]
    edge_vals: Optional[torch.Tensor],  # f32[num_blocks, edge_budget] | None
    block_ids: torch.Tensor,  # i32[k]
    *,
    block_size: int,
    local_budget: int,
) -> torch.Tensor:
    """partials[j, l, :] = Σ_{e: cidx[b,e]==l, mask[b,e]} ev[b,e] ·
    values[b·B + widx[b,e], :] with ``b = block_ids[j]`` (``ev`` = 1 when
    ``edge_vals`` is None).  Masked slots are left out, not weighted by 0;
    slots with ``cidx ≥ local_budget`` are dropped, as the kernel drops
    them.  Returns f32 ``(k, local_budget, d)``."""
    k, d = block_ids.shape[0], values.shape[1]
    ids = block_ids.long()
    widx = window_idx.index_select(0, ids)
    cidx = compact_idx.index_select(0, ids).long()
    keep = edge_mask.index_select(0, ids) & (cidx < local_budget)
    src = widx.long() + (ids * block_size)[:, None]
    msgs = values[src[keep]]
    if edge_vals is not None:
        msgs = msgs * edge_vals.index_select(0, ids)[keep][:, None]
    rows = (cidx + torch.arange(k, device=cidx.device)[:, None]
            * local_budget)[keep]
    out = torch.zeros((k * local_budget, d), dtype=torch.float32,
                      device=values.device)
    return out.index_add_(0, rows, msgs.float()).view(k, local_budget, d)
