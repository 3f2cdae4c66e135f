"""Public EmbeddingBag: :func:`embedding_bag` picks the backend.

* ``"cuda"`` — the hand-written kernel in :mod:`.kernel`, the default for
  tensors on the card.  A CUDA tensor reaches the kernel or the call
  raises; nothing falls back.
* ``"torch"`` — the plain version in :mod:`.ref`, the default for tensors
  on the CPU, and what ``backend="torch"`` asks for on any device.

The reference's ``"pallas"`` (the TPU kernel) is refused with a message
naming ``"cuda"``.  Its TPU knobs (``rows_per_block``, ``bag_tile``,
``interpret``) have no counterpart, and nothing is padded: the kernel reads
the table, ids and weights in place.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.cuda_build import pick_backend

from .kernel import embedding_bag_cuda
from .ref import MODES, embedding_bag_ref

__all__ = ["embedding_bag"]



def embedding_bag(table: torch.Tensor,  # (V, d) fp32 or bf16
                  indices: torch.Tensor,  # int32 or int64 (B, L)
                  weights: Optional[torch.Tensor] = None,  # (B, L), 0 = pad
                  mode: str = "sum",
                  backend: Optional[str] = None) -> torch.Tensor:
    """``out[b] = Σ_l w[b, l] · table[indices[b, l]]``, ids outside
    ``[0, V)`` contributing nothing; ``weights=None`` is all ones.  In
    ``mode="mean"`` the weights are divided by ``max(Σ_l w[b, l], 1e-9)``
    first, as the reference does before its kernel.  Returns ``(B, d)`` in
    ``table.dtype``."""
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}; expected one of {MODES}")
    if pick_backend(table, backend) == "torch":
        return embedding_bag_ref(table, indices, weights, mode=mode)
    table, indices = table.contiguous(), indices.contiguous()
    if weights is None:
        L = indices.shape[1]
        return embedding_bag_cuda(
            table, indices, weight=1.0 / L if mode == "mean" and L else 1.0)
    w = weights.to(torch.float32)
    if mode == "mean":
        w = w / w.sum(dim=1, keepdim=True).clamp_min(1e-9)
    return embedding_bag_cuda(table, indices, w.contiguous())
