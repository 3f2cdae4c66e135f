"""Public flash attention: :func:`attention` picks the backend.

* ``"cuda"`` — the hand-written kernels in :mod:`.kernel`, the default for
  tensors on the card: bf16 at head dims 64, 128 and 256 on the tensor
  cores, which take strided (B, H, S, D) views as they are; the rest on the
  FMA kernel, which takes contiguous operands.  A CUDA tensor reaches its
  kernel or the call raises; nothing falls back.
* ``"torch"`` — the plain version in :mod:`.ref`, the default for tensors
  on the CPU, and what ``backend="torch"`` asks for on any device.

The reference's ``"pallas"`` (the TPU kernel) is refused with a message
naming ``"cuda"``.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.cuda_build import BACKENDS, pick_backend

from .kernel import attention_route, flash_attention_cuda, strided_ok
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
    if attention_route(q.dtype, q.shape[-1]) == "wgmma":
        q, k, v = (t if strided_ok(t) else t.contiguous() for t in (q, k, v))
    else:
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    return flash_attention_cuda(q, k, v, scale=scale, causal=causal,
                                window=window, softcap=softcap)
