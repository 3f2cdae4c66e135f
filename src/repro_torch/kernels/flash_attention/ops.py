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

from repro_torch.kernels.cuda_build import BACKENDS, pick_backend

from .kernel import flash_attention_cuda
from .ref import attention_ref

__all__ = ["attention", "pick_backend", "BACKENDS"]



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
