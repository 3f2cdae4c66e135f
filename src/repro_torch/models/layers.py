"""Shared neural-net layers of the port (plain dicts of tensors, no
``nn.Module`` state): RMSNorm, RoPE, GQA attention with sliding-window /
logit-softcap / local-global patterns, SwiGLU / GeGLU / GELU MLPs.

Mirrors the reference's ``models/layers.py``: same names, same parameter
trees and layouts (``wq`` is ``(d, H, hd)``, ``wo`` is ``(H, hd, d)``), the
same dtype rules (weights cast to the activations' dtype at use; RMSNorm
and RoPE in fp32).  Attention goes through the port's kernels: the
prefill/forward path through :func:`~repro_torch.kernels.flash_attention.
attention` (the ``flash_attention`` kernel on the card) and the decode step
through :func:`~repro_torch.kernels.flash_attention.flash_decode`.  The
reference's ``shard(...)`` annotations are not made yet: data-parallel
training keeps every parameter whole on each rank (``train.trainer``), and
tensor parallelism is ROADMAP A12b.  :func:`cross_entropy_loss` is the
training loss; every function here is differentiable (on the card the
attention's gradient is the ``flash_attention_bwd`` kernel).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels.flash_attention import attention as attn_op
from repro_torch.kernels.flash_attention import flash_decode

__all__ = [
    "rms_norm", "rope", "init_dense", "dense", "cross_entropy_loss",
    "AttnCfg", "init_attention",
    "attention_block", "decode_attention_block", "init_mlp", "mlp_block",
]

Tensor = torch.Tensor


def _normal(shape, generator: torch.Generator, device) -> Tensor:
    return torch.randn(shape, generator=generator, device=generator.device,
                       dtype=torch.float32).to(device)


# --------------------------------------------------------------------- #
# basics
# --------------------------------------------------------------------- #
def rms_norm(x: Tensor, gamma: Tensor, eps: float = 1e-6,
             plus_one: bool = False) -> Tensor:
    xf = x.float()
    y = xf * torch.rsqrt(xf.square().mean(dim=-1, keepdim=True) + eps)
    g = (1.0 + gamma) if plus_one else gamma  # gemma uses (1+w)
    return (y * g).to(x.dtype)


def rope(x: Tensor, positions: Tensor, theta: float = 10000.0) -> Tensor:
    """Rotary embedding.  x: (..., S, H, D); positions: (..., S)."""
    half = x.shape[-1] // 2
    freq = theta ** (-torch.arange(half, dtype=torch.float32,
                                   device=x.device) / half)
    angles = positions[..., None].float() * freq  # (..., S, half)
    angles = angles[..., None, :]  # broadcast over heads
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def init_dense(generator: torch.Generator, d_in: int, d_out: int,
               scale: Optional[float] = None, device=None) -> Tensor:
    scale = scale if scale is not None else d_in ** -0.5
    return _normal((d_in, d_out), generator, device) * scale


def dense(x: Tensor, w: Tensor) -> Tensor:
    return x @ w.to(x.dtype)


def cross_entropy_loss(logits: Tensor, labels: Tensor,
                       mask: Optional[Tensor] = None,
                       softcap: float = 0.0) -> Tensor:
    """Mean next-token CE.  logits (..., V) fp32; labels int (...,)."""
    logits = logits.float()
    if softcap > 0.0:
        logits = softcap * torch.tanh(logits / softcap)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    nll = logz - gold
    if mask is not None:
        mask = mask.float()
        return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
    return nll.mean()


# --------------------------------------------------------------------- #
# attention (GQA + RoPE + sliding window + softcap)
# --------------------------------------------------------------------- #
@dataclasses.dataclass(frozen=True)
class AttnCfg:
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    rope_theta: float = 10000.0
    window: int = 0  # 0 = global
    softcap: float = 0.0
    causal: bool = True
    scale: Optional[float] = None  # None → head_dim**-0.5


def init_attention(generator: torch.Generator, cfg: AttnCfg,
                   device=None) -> dict:
    d, H, Hk, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    return {
        "wq": _normal((d, H, hd), generator, device) * d ** -0.5,
        "wk": _normal((d, Hk, hd), generator, device) * d ** -0.5,
        "wv": _normal((d, Hk, hd), generator, device) * d ** -0.5,
        "wo": _normal((H, hd, d), generator, device) * (H * hd) ** -0.5,
    }


def _proj(x: Tensor, w: Tensor) -> Tensor:
    """(B, S, d) × (d, H, hd) → (B, S, H, hd)."""
    d, H, hd = w.shape
    return (x @ w.reshape(d, H * hd).to(x.dtype)).unflatten(-1, (H, hd))


def _qkv(params: dict, x: Tensor, positions: Tensor, cfg: AttnCfg):
    q = rope(_proj(x, params["wq"]), positions, cfg.rope_theta)
    k = rope(_proj(x, params["wk"]), positions, cfg.rope_theta)
    v = _proj(x, params["wv"])
    return q, k, v


def _out_proj(params: dict, o: Tensor, dtype) -> Tensor:
    """(B, H, S, hd) → (B, S, d) through ``wo``."""
    H, hd, d = params["wo"].shape
    o = o.transpose(1, 2).reshape(o.shape[0], o.shape[2], H * hd)
    return o @ params["wo"].reshape(H * hd, d).to(dtype)


def attention_block(
    params: dict,
    x: Tensor,  # (B, S, d)
    positions: Tensor,  # (B, S)
    cfg: AttnCfg,
    backend: Optional[str] = None,
) -> Tensor:
    q, k, v = _qkv(params, x, positions, cfg)
    o = attn_op(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),  # (B,H,S,hd)
        scale=cfg.scale, causal=cfg.causal, window=cfg.window,
        softcap=cfg.softcap, backend=backend,
    )
    return _out_proj(params, o, x.dtype)


def decode_attention_block(
    params: dict,
    x: Tensor,  # (B, 1, d) — one new token
    pos: int,  # current position
    k_cache: Tensor,  # (B, Hkv, S_max, hd)
    v_cache: Tensor,
    cfg: AttnCfg,
) -> tuple:
    """One decode step against a KV cache (the serving hot path).

    The new K/V are written **in place** into slot ``pos % S_max`` of the
    caches (the reference returns updated copies); the caches are returned
    too.  Sliding-window layers keep a ring buffer of ``S_max =
    min(window, horizon)`` slots whose write index wraps.

    The attention is :func:`flash_decode` over the first ``kv_len =
    min(pos + 1, S_max)`` slots, which is exactly the reference's
    ring-aware mask (slot ``i`` valid iff its absolute position lies in
    ``[0, pos]`` and, for a window, within ``window`` of ``pos``):

    * before the ring wraps (``pos < S_max``) slot ``i`` holds position
      ``i``, so the valid slots are ``i ≤ pos`` — a prefix of ``pos + 1``;
      a window cannot cut it, since ``pos - i < S_max ≤ window``;
    * a ring wraps only when ``S_max`` is the window; after that every
      slot holds one of the last ``S_max`` positions, all inside the
      window, so all ``S_max`` slots are valid (in ring order, which the
      softmax does not see: RoPE was applied before the write);
    * a global cache (``window = 0``) holds the whole horizon.

    A windowed cache longer than the window (whose valid slots would not be
    a prefix) is refused."""
    S_max = k_cache.shape[2]
    if cfg.window > 0 and S_max > cfg.window:
        raise ValueError(
            f"a windowed cache must hold at most window={cfg.window} slots, "
            f"got {S_max}: its valid slots would not be a prefix")
    B = x.shape[0]
    positions = torch.full((B, 1), pos, dtype=torch.int64, device=x.device)
    q, k_new, v_new = _qkv(params, x, positions, cfg)  # (B, 1, H, hd)
    slot = pos % S_max
    k_cache[:, :, slot].copy_(k_new[:, 0])
    v_cache[:, :, slot].copy_(v_new[:, 0])
    o = flash_decode(q.transpose(1, 2), k_cache, v_cache, scale=cfg.scale,
                     kv_len=min(pos + 1, S_max),
                     softcap=cfg.softcap)  # (B, H, 1, hd) in x.dtype
    return _out_proj(params, o, x.dtype), k_cache, v_cache


# --------------------------------------------------------------------- #
# MLP (SwiGLU / GeGLU / plain GELU)
# --------------------------------------------------------------------- #
def init_mlp(generator: torch.Generator, d_model: int, d_ff: int,
             kind: str = "swiglu", device=None) -> dict:
    p = {
        "w_up": init_dense(generator, d_model, d_ff, device=device),
        "w_down": init_dense(generator, d_ff, d_model, device=device),
    }
    if kind in ("swiglu", "geglu"):
        p["w_gate"] = init_dense(generator, d_model, d_ff, device=device)
    return p


def mlp_block(params: dict, x: Tensor, kind: str = "swiglu") -> Tensor:
    up = dense(x, params["w_up"])
    if kind == "swiglu":
        h = F.silu(dense(x, params["w_gate"])) * up
    elif kind == "geglu":
        h = F.gelu(dense(x, params["w_gate"]), approximate="tanh") * up
    elif kind == "gelu":
        h = F.gelu(up, approximate="tanh")
    else:
        raise ValueError(f"unknown mlp kind {kind!r}")
    return dense(h, params["w_down"])
