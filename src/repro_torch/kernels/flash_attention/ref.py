"""Plain PyTorch version of flash attention: dense masked softmax in fp32.

The same function as the CUDA kernels in ``csrc/``, computed with
whole-tensor torch ops on any device.  :func:`.ops.attention` uses
:func:`attention_ref` for tensors on the CPU (or ``backend="torch"``); the
tests and ``chip_smoke.py`` hold the kernels against it on the card.
:func:`attention_lse_ref` adds the rows' logsumexp that the tensor-core
forward stores, and :func:`attention_bwd_ref` is the backward kernels'
arithmetic written out (the formulas both of them compute, from the
forward's output and logsumexp); nothing on the path calls these two.
"""
from __future__ import annotations

from typing import Optional

import torch

__all__ = ["attention_ref", "attention_lse_ref", "attention_bwd_ref"]

#: logsumexp of a row whose keys are all masked (the kernels' convention):
#: exp(s - lse) is then 0 for every key
NO_ROW_LSE = 1e30


def attention_ref(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    scale: Optional[float] = None,
    causal: bool = True,
    window: int = 0,
    softcap: float = 0.0,
) -> torch.Tensor:
    """(B, Hq, Sq, D) x (B, Hkv, Skv, D)² → (B, Hq, Sq, D); GQA by repeat,
    fp32 math, output in ``q.dtype``.  Positions count from 0 in both q and
    k; a row whose keys are all masked comes out NaN."""
    group = q.shape[1] // k.shape[1]
    _, s, _, mask = _scores(q, k, scale, causal, window, softcap)
    s = s.masked_fill(~mask, float("-inf"))
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = p / p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bhqk,bhkd->bhqd", p,
                       v.repeat_interleave(group, dim=1).float())
    return out.to(q.dtype)


def _scores(q, k, scale, causal, window, softcap):
    """``(scale, s, t, mask)``: the scale (D^-1/2 when None), the fp32
    scores s (B, Hq, Sq, Skv) before the mask, capped when ``softcap`` >
    0, t = tanh(x / softcap) of the uncapped x (None without a cap), and
    the mask (Sq, Skv); k repeated over the GQA group."""
    Sq, D = q.shape[2], q.shape[3]
    Skv = k.shape[2]
    group = q.shape[1] // k.shape[1]
    if scale is None:
        scale = D ** -0.5
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(),
                     k.repeat_interleave(group, dim=1).float()) * scale
    t = None
    if softcap > 0.0:
        t = torch.tanh(s / softcap)
        s = softcap * t
    q_pos = torch.arange(Sq, device=q.device)[:, None]
    kv_pos = torch.arange(Skv, device=q.device)[None, :]
    mask = torch.ones((Sq, Skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= q_pos >= kv_pos
    if window > 0:
        mask &= (q_pos - kv_pos) < window
    return scale, s, t, mask


def attention_lse_ref(q, k, v, *, scale: Optional[float] = None,
                      causal: bool = True, window: int = 0,
                      softcap: float = 0.0):
    """``(out, lse)``: :func:`attention_ref`'s output and each row's
    logsumexp of its scaled (capped) visible scores, fp32 (B, Hq, Sq).  A
    row whose keys are all masked gets lse :data:`NO_ROW_LSE` and output 0
    (the kernels' convention; :func:`attention_ref` gives NaN there)."""
    group = q.shape[1] // k.shape[1]
    _, s, _, mask = _scores(q, k, scale, causal, window, softcap)
    s = s.masked_fill(~mask, float("-inf"))
    lse = torch.logsumexp(s, dim=-1)
    lse = torch.where(torch.isfinite(lse), lse,
                      torch.full_like(lse, NO_ROW_LSE))
    p = torch.exp(s - lse[..., None])
    out = torch.einsum("bhqk,bhkd->bhqd", p,
                       v.repeat_interleave(group, dim=1).float())
    return out.to(q.dtype), lse


def attention_bwd_ref(q, k, v, out, dout, lse, *,
                      scale: Optional[float] = None, causal: bool = True,
                      window: int = 0, softcap: float = 0.0):
    """(dq, dk, dv) in fp32 from the formulas both backward kernels
    compute, given the forward's ``out`` and ``lse``:
    p = exp(s - lse) (0 where masked), dp = dout · vᵀ,
    delta = rowsum(dout ∘ out), ds = p (dp - delta) (1 - tanh²) (the
    factor only with a softcap), dq = scale · ds k, dk = scale · dsᵀ q and
    dv = pᵀ dout, dk and dv summed over each KV head's query group."""
    B, Hq, _, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    group = Hq // Hkv
    scale, s, t, mask = _scores(q, k, scale, causal, window, softcap)
    p = torch.exp(s.masked_fill(~mask, float("-inf"))
                  - lse.float()[..., None])
    dout = dout.float()
    kk = k.repeat_interleave(group, dim=1).float()
    vv = v.repeat_interleave(group, dim=1).float()
    dp = torch.einsum("bhqd,bhkd->bhqk", dout, vv)
    delta = (dout * out.float()).sum(-1, keepdim=True)
    ds = p * (dp - delta)
    if t is not None:
        ds = ds * (1.0 - t * t)
    dq = scale * torch.einsum("bhqk,bhkd->bhqd", ds, kk)
    dk = scale * torch.einsum("bhqk,bhqd->bhkd", ds, q.float())
    dv = torch.einsum("bhqk,bhqd->bhkd", p, dout)
    return (dq, dk.reshape(B, Hkv, group, Skv, D).sum(2),
            dv.reshape(B, Hkv, group, Skv, D).sum(2))
