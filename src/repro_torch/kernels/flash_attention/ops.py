"""Public flash attention: :func:`attention` picks the backend.

* ``"cuda"`` — the hand-written kernels in :mod:`.kernel`, the default for
  tensors on the card: bf16 at head dims 64, 128 and 256 on the tensor
  cores, which take strided (B, H, S, D) views as they are; the rest on the
  FMA kernel, which takes contiguous operands.  A CUDA tensor reaches its
  kernel or the call raises; nothing falls back.
* ``"torch"`` — the plain version in :mod:`.ref`, the default for tensors
  on the CPU, and what ``backend="torch"`` asks for on any device.

Gradients.  On the card, when grad mode is on and q, k or v requires grad,
the call goes through :class:`FlashAttention`, a
``torch.autograd.Function`` whose forward is the same kernel route and
whose backward is the hand-written ``flash_attention_bwd`` kernel (it
recomputes each row's logsumexp, so the forward kernels keep their one
output).  Otherwise the forward kernel launches exactly as without
autograd.  On the CPU the gradient is torch autograd of the plain version.

The reference's ``"pallas"`` (the TPU kernel) is refused with a message
naming ``"cuda"``.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.cuda_build import BACKENDS, pick_backend

from .kernel import (attention_route, flash_attention_bwd_cuda,
                     flash_attention_cuda, strided_ok)
from .ref import attention_ref

__all__ = ["attention", "FlashAttention", "pick_backend", "BACKENDS"]


def _forward_cuda(q, k, v, scale, causal, window, softcap):
    """The forward kernel on the operands as the route takes them."""
    if attention_route(q.dtype, q.shape[-1]) == "wgmma":
        q, k, v = (t if strided_ok(t) else t.contiguous() for t in (q, k, v))
    else:
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    return flash_attention_cuda(q, k, v, scale=scale, causal=causal,
                                window=window, softcap=softcap)


class FlashAttention(torch.autograd.Function):
    """Attention on the card with a gradient: the forward kernel, then the
    ``flash_attention_bwd`` kernel for (dq, dk, dv).  Saves q, k, v and the
    output (the backward reads them contiguous)."""

    @staticmethod
    def forward(ctx, q, k, v, scale, causal, window, softcap):
        out = _forward_cuda(q, k, v, scale, causal, window, softcap)
        ctx.save_for_backward(q, k, v, out)
        ctx.args = dict(scale=scale, causal=causal, window=window,
                        softcap=softcap)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out = (t.contiguous() for t in ctx.saved_tensors)
        dq, dk, dv = flash_attention_bwd_cuda(q, k, v, out,
                                              dout.contiguous(), **ctx.args)
        return dq, dk, dv, None, None, None, None


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
        # contiguous operands: the einsums' rounding must not follow strides
        return attention_ref(q.contiguous(), k.contiguous(), v.contiguous(),
                             scale=scale, causal=causal, window=window,
                             softcap=softcap)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return FlashAttention.apply(q, k, v, scale, causal, window, softcap)
    return _forward_cuda(q, k, v, scale, causal, window, softcap)
