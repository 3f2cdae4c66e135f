"""Public flash attention: :func:`attention` picks the backend.

* ``"cuda"`` — the hand-written kernel in :mod:`.kernel`, the default for
  tensors on the card.  A CUDA tensor reaches the kernel or the call
  raises; nothing falls back.
* ``"torch"`` — the plain version in :mod:`.ref`, the default for tensors
  on the CPU, and what ``backend="torch"`` asks for on any device.

The reference's ``"pallas"`` (the TPU kernel) is refused with a message
naming ``"cuda"``.
"""
from __future__ import annotations

from typing import Optional

import torch

from .kernel import flash_attention_cuda
from .ref import attention_ref

__all__ = ["attention", "pick_backend", "BACKENDS"]

BACKENDS = ("cuda", "torch")


def pick_backend(t: torch.Tensor, backend: Optional[str]) -> str:
    """``backend``, or by device when it is None: ``"cuda"`` for a tensor on
    the card, ``"torch"`` otherwise.  Raises for ``"cuda"`` on a CPU tensor
    and for any name but those two."""
    if backend == "pallas":
        raise ValueError("backend='pallas' is the TPU kernel; the port's "
                         "hand-written kernel is backend='cuda'")
    if backend is None:
        backend = "cuda" if t.is_cuda else "torch"
    if backend not in BACKENDS:
        raise ValueError(f"unknown attention backend {backend!r}; expected "
                         f"one of {BACKENDS}")
    if backend == "cuda" and not t.is_cuda:
        raise ValueError("backend='cuda' needs tensors on the card")
    return backend


def attention(
    q: torch.Tensor,  # (B, Hq, Sq, D)
    k: torch.Tensor,  # (B, Hkv, Skv, D)
    v: torch.Tensor,
    *,
    scale: Optional[float] = None,
    causal: bool = True,
    window: int = 0,
    softcap: float = 0.0,
    backend: Optional[str] = None,
) -> torch.Tensor:
    """Softmax attention with GQA, causal or bidirectional masking, a
    sliding ``window`` (0: none) and ``softcap`` (0: none); output in
    ``q.dtype``."""
    if pick_backend(q, backend) == "torch":
        return attention_ref(q, k, v, scale=scale, causal=causal,
                             window=window, softcap=softcap)
    return flash_attention_cuda(
        q.contiguous(), k.contiguous(), v.contiguous(), scale=scale,
        causal=causal, window=window, softcap=softcap)
