"""Split-KV decode attention (q_len 1 against a KV cache): the launcher of
the hand-written CUDA kernel (``csrc/flash_decode.cu``) and its plain
PyTorch version.

Decode attention has no parallelism along the query axis, so the cache is
cut into splits: the kernel's grid covers (split, KV head, request), each
CTA reduces its split to partial ``(m, l, acc)`` in fp32, and the last CTA
of each KV head to finish merges them with the exact log-sum-exp combine
(the reference leaves that merge to XLA, outside the Pallas kernel).  A
call is one launch: q is read in its own dtype by the kernel, which may
differ from the cache's (an fp32 query beside a bf16 cache, as a serving
path with ``compute_dtype="float32"`` has it), and the splits are planned
from the live ``kv_len``, not the allocated horizon.
``kv_len`` is a runtime argument of the kernel: a new decode position
launches the same build.

:func:`flash_decode` picks the backend as :func:`.ops.attention` does: a
CUDA tensor reaches the kernel or the call raises; a CPU tensor takes the
plain version, the dense :func:`flash_decode_ref`.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from repro_torch.kernels import cuda_build

from .kernel import DTYPES, HEAD_DIMS, check_operand
from .ops import pick_backend

__all__ = ["flash_decode", "flash_decode_ref", "flash_decode_cuda",
           "flash_decode_partials_cuda", "split_length", "live_splits",
           "MAX_GROUP", "NEG_INF"]

NEG_INF = -1e30
#: query rows per KV head the kernel takes
MAX_GROUP = 32
#: cache slots a CTA streams per round (its 4 warps' steps); auto split
#: lengths are multiples
TILE = 64
#: CTAs per SM the automatic split count aims for
_CTAS_PER_SM = 4

_P, _I32, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    "flash_decode": ([_P, _P, _P, _P, _P, _P, _I32, _I32, _I32, _I32, _I32,
                      _I32, _I32, _I32, _I32, _I32, _F, _F, _P], _I32),
    "flash_decode_error": ([_I32], ctypes.c_char_p),
}


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    if device.type == "cuda":
        return torch.cuda.get_device_properties(device).multi_processor_count
    return 132  # an H100's, so that a CPU run splits as the card would


def split_length(batch: int, kv_heads: int, S: int,
                 kv_splits: Optional[int], device: torch.device,
                 kv_len: Optional[int] = None) -> int:
    """Cache slots per split.  ``kv_splits`` given: ``ceil(S / kv_splits)``
    (so there are at most ``kv_splits`` splits).  None: enough splits of the
    live prefix ``kv_len`` (None: ``S``) that ``batch * kv_heads * splits``
    is about 4 CTAs per SM, each a multiple of :data:`TILE` slots — the
    reference's default of 8 splits leaves most of 132 SMs idle at 8
    requests × 4 KV heads.  The kernel is launched for the splits that hold
    live slots, ``ceil(kv_len / split)``, so a short live prefix early in a
    serve run is spread over the card rather than over the horizon."""
    if kv_splits is not None:
        if kv_splits < 1:
            raise ValueError(f"kv_splits must be ≥ 1, got {kv_splits}")
        return -(-S // kv_splits)
    live = S if kv_len is None else int(kv_len)
    want = -(-_CTAS_PER_SM * _sm_count(device) // (batch * kv_heads))
    splits = max(1, min(want, -(-live // TILE)))
    per_split = -(-live // splits)
    return -(-per_split // TILE) * TILE  # whole tiles


def live_splits(kv_len: int, split: int) -> int:
    """Splits of ``split`` slots that hold live slots: what the merging
    kernel is launched for (none lies wholly at or past ``kv_len``)."""
    return -(-kv_len // split)


def _check_decode(q, k, v, kv_len):
    if q.ndim != 4 or q.shape[2] != 1:
        raise ValueError(f"q must be (B, Hq, 1, D), got {tuple(q.shape)}")
    B, Hq, _, D = q.shape
    if k.ndim != 4 or k.shape[0] != B or k.shape[3] != D \
            or v.shape != k.shape:
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} do not "
                         f"match q {tuple(q.shape)}")
    Hkv, S = k.shape[1], k.shape[2]
    if Hq % Hkv:
        raise ValueError(f"Hq={Hq} is not a multiple of Hkv={Hkv}")
    kv_len = S if kv_len is None else int(kv_len)
    if not 1 <= kv_len <= S:
        raise ValueError(f"kv_len must lie in [1, {S}], got {kv_len}")
    return B, Hq, Hkv, S, D, kv_len


#: per device, the kernel's merge tickets: zeros that each launch leaves
#: at zero.  Calls on one device share them, so they must not run at once
#: on two streams (everything in this package runs on the current stream).
_TICKETS: dict = {}


def _tickets(device: torch.device, n: int) -> torch.Tensor:
    t = _TICKETS.get(device)
    if t is None or t.numel() < n:
        t = torch.zeros(max(n, 1024), dtype=torch.int32, device=device)
        _TICKETS[device] = t
    return t


def _launch(q, k, v, *, scale, kv_len, split, softcap, merge: bool):
    if not q.is_cuda:
        raise ValueError("flash_decode: q must be a CUDA tensor")
    B, Hq, Hkv, S, D, kv_len = _check_decode(q, k, v, kv_len)
    for t, what in ((k, "cache"), (q, "q")):
        if t.dtype not in DTYPES:
            raise TypeError(f"flash_decode takes a {sorted(map(str, DTYPES))}"
                            f" {what}, got {t.dtype}")
    for t, what in ((k, "k"), (v, "v")):
        check_operand(t, what, k.dtype, q.device)
    cuda_build.refuse_grad(
        "flash_decode", (q, k, v),
        "decode attention serves only; a training step's attention goes "
        "through flash_attention.attention, whose backward is the "
        "flash_attention_bwd kernel")
    q = q.contiguous()  # (B, Hq, 1, D) from (B, 1, Hq, D): already is
    G = Hq // Hkv
    if D not in HEAD_DIMS or G > MAX_GROUP:
        raise ValueError(f"head dim {D} / group {G} not supported; the "
                         f"kernel takes D in {HEAD_DIMS}, G ≤ {MAX_GROUP}")
    if split < 1 or max(B, Hkv) > 65535:
        raise ValueError(f"unsupported split {split} or shape "
                         f"{tuple(k.shape)}")
    # merged: only the splits that hold live slots; partials: all of them
    splits = live_splits(kv_len if merge else S, split)
    dev = q.device
    rows = B * Hkv * splits * G
    ws = torch.empty(rows * (2 + D), dtype=torch.float32, device=dev)
    out = torch.empty((B, Hq, 1, D), dtype=q.dtype, device=dev) \
        if merge else None
    tickets = _tickets(dev, B * Hkv * 4) if merge else None
    lib = cuda_build.load("flash_decode", _SIGNATURES)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.flash_decode(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), ws.data_ptr(),
            None if out is None else out.data_ptr(),
            None if tickets is None else tickets.data_ptr(),
            DTYPES[k.dtype], DTYPES[q.dtype], B, Hkv, G, S, D, kv_len,
            splits, split,
            float(scale), float(softcap), stream)
    cuda_build.check_launch(lib, "flash_decode", rc)
    cuda_build.count_launch("flash_decode")
    if merge:
        return out
    m = ws[:rows].view(B, Hkv, splits, G)
    l = ws[rows:2 * rows].view(B, Hkv, splits, G)
    return m, l, ws[2 * rows:].view(B, Hkv, splits, G, D)


def flash_decode_cuda(q, k, v, *, scale: float, kv_len: int, split: int,
                      softcap: float) -> torch.Tensor:
    """Launch the kernel, which merges its splits itself (one launch):
    ``q`` (B, Hq, 1, D) and ``k``/``v`` (B, Hkv, S, D) on the card, the
    cache fp32 or bf16 and q either (an fp32 q beside a bf16 cache is held
    to 2⁻¹⁶ on the tensor cores, split into two bf16 halves); splits of
    ``split`` slots over the first ``kv_len``.
    Returns (B, Hq, 1, D) in ``q.dtype``, as :func:`flash_decode_ref`, the
    same bits on every call."""
    return _launch(q, k, v, scale=scale, kv_len=kv_len, split=split,
                   softcap=softcap, merge=True)


def flash_decode_partials_cuda(q, k, v, *, scale: float, kv_len: int,
                               split: int, softcap: float
                               ) -> Tuple[torch.Tensor, ...]:
    """Launch the kernel without its merge: for each split of ``split``
    slots of the whole cache, fp32
    ``m`` = max score and ``l`` = Σ exp(s − m), (B, Hkv, splits, G), and
    ``o`` = Σ exp(s − m)·v, (B, Hkv, splits, G, D), over the slots below
    ``kv_len``.  A split with no such slot gives ``m = -1e30, l = 0,
    o = 0``."""
    return _launch(q, k, v, scale=scale, kv_len=kv_len, split=split,
                   softcap=softcap, merge=False)


def flash_decode(
    q: torch.Tensor,  # (B, Hq, 1, D) — one new token
    k: torch.Tensor,  # (B, Hkv, S, D)
    v: torch.Tensor,
    *,
    scale: Optional[float] = None,
    kv_len: Optional[int] = None,  # live cache length (≤ S); None → S
    kv_splits: Optional[int] = None,  # None → fill the card (split_length)
    softcap: float = 0.0,
    backend: Optional[str] = None,
) -> torch.Tensor:
    """Attention of one query token per request over the first ``kv_len``
    cache slots; output (B, Hq, 1, D) in ``q.dtype``.  On the card the
    result does not depend on ``kv_splits`` beyond fp32 rounding; the plain
    version has no splits."""
    B, Hq, Hkv, S, D, kv_len = _check_decode(q, k, v, kv_len)
    if scale is None:
        scale = D ** -0.5
    # checks kv_splits
    split = split_length(B, Hkv, S, kv_splits, q.device, kv_len=kv_len)
    if pick_backend(q, backend) == "cuda":
        return flash_decode_cuda(q, k, v, scale=scale, kv_len=kv_len,
                                 split=split, softcap=softcap)
    return flash_decode_ref(q, k, v, scale=scale, kv_len=kv_len,
                            softcap=softcap)


def flash_decode_ref(q, k, v, *, scale=None, kv_len=None, softcap=0.0):
    """Dense oracle: plain masked softmax attention at q_len 1."""
    B, Hq, Hkv, S, D, kv_len = _check_decode(q, k, v, kv_len)
    group = Hq // Hkv
    if scale is None:
        scale = D ** -0.5
    kk = k.repeat_interleave(group, dim=1).float()
    vv = v.repeat_interleave(group, dim=1).float()
    s = torch.einsum("bhqd,bhsd->bhqs", q.float() * scale, kk)
    if softcap > 0.0:
        s = softcap * torch.tanh(s / softcap)
    mask = torch.arange(S, device=q.device) < kv_len
    s = s.masked_fill(~mask, float("-inf"))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqs,bhsd->bhqd", p, vv).to(q.dtype)
