"""Plain PyTorch version of flash attention: dense masked softmax in fp32.

The same function as the CUDA kernel in ``csrc/flash_attention.cu``,
computed with whole-tensor torch ops on any device.  :func:`.ops.attention`
uses it for tensors on the CPU (or ``backend="torch"``); the tests and
``chip_smoke.py`` hold the kernel against it on the card.
"""
from __future__ import annotations

from typing import Optional

import torch

__all__ = ["attention_ref"]


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
    B, Hq, Sq, D = q.shape
    _, Hkv, Skv, _ = k.shape
    group = Hq // Hkv
    if scale is None:
        scale = D ** -0.5
    k = k.repeat_interleave(group, dim=1)
    v = v.repeat_interleave(group, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    if softcap > 0.0:
        s = softcap * torch.tanh(s / softcap)
    q_pos = torch.arange(Sq, device=q.device)[:, None]
    kv_pos = torch.arange(Skv, device=q.device)[None, :]
    mask = torch.ones((Sq, Skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= q_pos >= kv_pos
    if window > 0:
        mask &= (q_pos - kv_pos) < window
    s = s.masked_fill(~mask, float("-inf"))
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = p / p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bhqk,bhkd->bhqd", p, v.float())
    return out.to(q.dtype)
