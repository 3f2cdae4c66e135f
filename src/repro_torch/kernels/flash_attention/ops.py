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
whose backward is a hand-written kernel, picked by
:func:`.kernel.attention_bwd_route`: bf16 at head dims 64 and 128 on the
tensor cores (``flash_attention_bwd_wgmma``, which reads the rows'
logsumexp that the forward then stores, and takes the strided views as
they are), the rest on the FP32 FMA kernel (``flash_attention_bwd``, which
recomputes the logsumexp from contiguous operands).  Otherwise the forward
kernel launches exactly as without autograd, and stores no logsumexp.  On
the CPU the gradient is torch autograd of the plain version.

The reference's ``"pallas"`` (the TPU kernel) is refused with a message
naming ``"cuda"``.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.cuda_build import BACKENDS, pick_backend

from .kernel import (attention_bwd_route, attention_route,
                     flash_attention_bwd_cuda, flash_attention_bwd_wgmma_cuda,
                     flash_attention_cuda, flash_attention_wgmma_cuda,
                     strided_ok)
from .ref import attention_ref

__all__ = ["attention", "FlashAttention", "pick_backend", "BACKENDS"]


def _strided(t):
    """``t`` as the tensor-core kernels take it: itself, or a contiguous
    copy when :func:`.kernel.strided_ok` refuses its strides."""
    return t if strided_ok(t) else t.contiguous()


def _forward_cuda(q, k, v, scale, causal, window, softcap):
    """The forward kernel on the operands as the route takes them."""
    if attention_route(q.dtype, q.shape[-1]) == "wgmma":
        q, k, v = _strided(q), _strided(k), _strided(v)
    else:
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    return flash_attention_cuda(q, k, v, scale=scale, causal=causal,
                                window=window, softcap=softcap)


class FlashAttention(torch.autograd.Function):
    """Attention on the card with a gradient: the forward kernel, then the
    backward kernel :func:`.kernel.attention_bwd_route` picks for (dq, dk,
    dv).  On the ``"wgmma"`` route the forward also stores the rows'
    logsumexp; it saves q, k, v, the output and that lse as they are.  On
    the ``"fma"`` route it saves q, k, v and the output, which the backward
    reads contiguous."""

    @staticmethod
    def forward(ctx, q, k, v, scale, causal, window, softcap):
        ctx.route = attention_bwd_route(q.dtype, q.shape[-1])
        ctx.args = dict(scale=scale, causal=causal, window=window,
                        softcap=softcap)
        if ctx.route == "wgmma":
            q, k, v = _strided(q), _strided(k), _strided(v)
            out, lse = flash_attention_wgmma_cuda(q, k, v, return_lse=True,
                                                  **ctx.args)
            ctx.save_for_backward(q, k, v, out, lse)
        else:
            out = _forward_cuda(q, k, v, scale, causal, window, softcap)
            ctx.save_for_backward(q, k, v, out)
        return out

    @staticmethod
    def backward(ctx, dout):
        if ctx.route == "wgmma":
            q, k, v, out, lse = ctx.saved_tensors
            dq, dk, dv = flash_attention_bwd_wgmma_cuda(
                q, k, v, out, _strided(dout), lse, **ctx.args)
        else:
            q, k, v, out = (t.contiguous() for t in ctx.saved_tensors)
            dq, dk, dv = flash_attention_bwd_cuda(
                q, k, v, out, dout.contiguous(), **ctx.args)
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
