"""Plain PyTorch version of EmbeddingBag (the reference's
``embedding_bag_ref``): gather, weight, sum over the bag.

It computes what the CUDA kernel computes, on any device, with whole-tensor
torch ops: :func:`~repro_torch.kernels.embedding_bag.ops.embedding_bag`
uses it for tensors on the CPU; the tests and ``chip_smoke.py`` hold the
kernel against it on the card.  Two choices follow the Pallas kernel and
the CUDA one, not the reference's XLA path:

* an id outside ``[0, V)`` contributes nothing (``jnp.take`` wraps -1 to
  the last row and fills ids ≥ V with NaN);
* the result has the table's dtype, summed in fp32 (XLA promotes a bf16
  table times fp32 weights to fp32).
"""
from __future__ import annotations

from typing import Optional

import torch

__all__ = ["embedding_bag_ref", "MODES"]

MODES = ("sum", "mean")


def embedding_bag_ref(table: torch.Tensor,  # (V, d)
                      indices: torch.Tensor,  # int (B, L)
                      weights: Optional[torch.Tensor] = None,  # (B, L)
                      mode: str = "sum") -> torch.Tensor:
    """``out[b] = Σ_l w[b, l] · table[indices[b, l]]`` over the ids in
    ``[0, V)``; ``weights=None`` is all ones.  ``mode="mean"`` divides by
    ``max(Σ_l w[b, l], 1e-9)``, the weights of out-of-range ids included
    (the reference normalises the weights before its kernel masks them).
    Returns ``(B, d)`` in ``table.dtype``."""
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}; expected one of {MODES}")
    idx = indices.long()
    valid = (idx >= 0) & (idx < table.shape[0])
    w = (torch.ones(idx.shape, device=table.device) if weights is None
         else weights.float())
    terms = table[torch.where(valid, idx, 0)].float()  # (B, L, d), a copy
    terms.mul_(w[..., None]).masked_fill_(~valid[..., None], 0.0)
    out = terms.sum(dim=1)
    if mode == "mean":
        out = out / w.sum(dim=1, keepdim=True).clamp_min(1e-9)
    return out.to(table.dtype)
