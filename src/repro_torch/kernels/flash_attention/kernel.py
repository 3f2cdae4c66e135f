"""Launch the hand-written CUDA flash-attention kernels.

Two forward sources, one function:

* ``csrc/flash_attention_wgmma.cu`` — bf16 on the Hopper tensor cores
  (``wgmma``, TMA), head dims 64, 128 and 256: the LM's bf16 prefill;
* ``csrc/flash_attention.cu`` — fp32 FMA, every dtype and head dim the
  package takes: the fp32 forward and the small head dims of the smoke
  configs.

:func:`attention_route` picks one from ``(dtype, D)`` alone, never from a
failure.  The backward, ``csrc/flash_attention_bwd.cu`` (fp32 FMA, both
dtypes, every head dim), is :func:`flash_attention_bwd_cuda`, counted in
``launches["flash_attention_bwd"]``; :func:`.ops.attention` calls it from
its autograd path.  Both are built and loaded by :mod:`repro_torch.kernels.cuda_build`
(``nvcc`` for ``sm_90a`` on first use, ``ctypes``).  The launchers take
tensors on the card, check them, allocate the output, launch on
``torch.cuda.current_stream()`` and count the launch in
``cuda_build.launches["flash_attention"]`` (either route) and, for the
tensor-core route, also in ``launches["flash_attention_wgmma"]``.  A launch
the CUDA runtime refuses raises: there is no fallback.  Nothing here runs
at import time.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import cuda_build

__all__ = ["flash_attention_cuda", "flash_attention_fma_cuda",
           "flash_attention_wgmma_cuda", "flash_attention_bwd_cuda",
           "attention_route", "strided_ok",
           "HEAD_DIMS", "WGMMA_HEAD_DIMS", "DTYPES"]

#: head dims the FMA kernel is instantiated for
HEAD_DIMS = (8, 16, 32, 64, 128, 256)
#: head dims of the tensor-core kernel (bf16 only)
WGMMA_HEAD_DIMS = (64, 128, 256)
#: element types the kernels take (q, k, v and out alike) → dtype code
DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_P, _I32, _I64, _F = (ctypes.c_void_p, ctypes.c_int, ctypes.c_int64,
                      ctypes.c_float)
_SIGNATURES = {
    "flash_attention": ([_P, _P, _P, _P, _I32, _I32, _I32, _I32, _I32, _I32,
                         _I32, _F, _I32, _I32, _F, _P], _I32),
    "flash_attention_error": ([_I32], ctypes.c_char_p),
}
_WGMMA_SIGNATURES = {
    "flash_attention_wgmma": ([_P] * 4 + [_I64] * 12
                              + [_I32] * 6 + [_F, _I32, _I32, _F, _P], _I32),
    "flash_attention_wgmma_error": ([_I32], ctypes.c_char_p),
}
_BWD_SIGNATURES = {
    "flash_attention_bwd": ([_P] * 10 + [_I32] * 7 + [_F, _I32, _I32, _F,
                                                      _P], _I32),
    "flash_attention_bwd_error": ([_I32], ctypes.c_char_p),
}


def attention_route(dtype: torch.dtype, D: int) -> str:
    """Which kernel serves ``(dtype, D)``: ``"wgmma"`` (bf16 on the tensor
    cores, ``D`` in :data:`WGMMA_HEAD_DIMS`) or ``"fma"`` (the rest of
    :data:`DTYPES` × :data:`HEAD_DIMS`).  Raises for anything else."""
    if dtype not in DTYPES:
        raise TypeError(f"flash_attention takes {sorted(map(str, DTYPES))}, "
                        f"got {dtype}")
    if D not in HEAD_DIMS:
        raise ValueError(f"head dim {D} not supported; the kernels are "
                         f"built for {HEAD_DIMS}")
    return "wgmma" if dtype == torch.bfloat16 and D in WGMMA_HEAD_DIMS \
        else "fma"


def check_operand(t: torch.Tensor, what: str, dtype, device):
    """Raise unless ``t`` is a contiguous 4-D ``dtype`` tensor on
    ``device`` whose base is 16-byte aligned (the kernel loads 16 bytes at
    a time)."""
    _check_kind(t, what, dtype, device)
    if not t.is_contiguous():
        raise ValueError(f"{what} must be contiguous")


def _check_kind(t: torch.Tensor, what: str, dtype, device):
    if t.device != device:
        raise ValueError(f"{what} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{what} has dtype {t.dtype}, expected {dtype}")
    if t.ndim != 4:
        raise ValueError(f"{what} must be (B, H, S, D), got "
                         f"{tuple(t.shape)}")
    if t.data_ptr() % 16:
        raise ValueError(f"{what} must start on a 16-byte boundary")


def _strides(t: torch.Tensor):
    """(batch, head, row) strides in elements; a dim of size 1 gets the
    stride a contiguous tensor would have (it is never stepped)."""
    dense = t.shape[1] * t.shape[2] * t.shape[3], t.shape[2] * t.shape[3], \
        t.shape[3]
    return tuple(d if n == 1 else s
                 for s, d, n in zip(t.stride()[:3], dense, t.shape[:3]))


def strided_ok(t: torch.Tensor) -> bool:
    """Whether the tensor-core kernel takes ``t`` as it is: last dim
    contiguous, the other strides multiples of 8 elements (16 bytes, what
    TMA wants), the base 16-byte aligned."""
    return t.ndim == 4 and t.stride(3) == 1 and t.data_ptr() % 16 == 0 \
        and all(s > 0 and s % 8 == 0 for s in _strides(t))


def _check_shapes(q, k, v, D_set):
    B, Hq, Sq, D = q.shape
    _, Hkv, Skv, _ = k.shape
    if k.shape[0] != B or k.shape[3] != D or v.shape != k.shape:
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} do not "
                         f"match q {tuple(q.shape)}")
    if Hq % Hkv:
        raise ValueError(f"Hq={Hq} is not a multiple of Hkv={Hkv}")
    if D not in D_set:
        raise ValueError(f"head dim {D} not supported; the kernel is built "
                         f"for {D_set}")
    if min(Sq, Skv) < 1 or max(B, Hq) > 65535:
        raise ValueError(f"unsupported shape q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}")
    return B, Hq, Hkv, Sq, Skv, D


def flash_attention_cuda(
    q: torch.Tensor,  # (B, Hq, Sq, D)
    k: torch.Tensor,  # (B, Hkv, Skv, D)
    v: torch.Tensor,  # (B, Hkv, Skv, D)
    *,
    scale: Optional[float] = None,
    causal: bool = True,
    window: int = 0,
    softcap: float = 0.0,
) -> torch.Tensor:
    """Launch the kernel :func:`attention_route` picks; arguments and result
    as :func:`.ref.attention_ref` (fp32 or bf16, all three alike; ``Hq`` a
    multiple of ``Hkv``; ``D`` in :data:`HEAD_DIMS`).  A fully masked row
    comes out 0, not NaN."""
    if not q.is_cuda:
        raise ValueError("flash_attention: q must be a CUDA tensor")
    cuda_build.refuse_grad(
        "flash_attention", (q, k, v),
        "call flash_attention.attention, whose autograd path launches the "
        "flash_attention_bwd kernel")
    launch = flash_attention_wgmma_cuda \
        if attention_route(q.dtype, q.shape[-1]) == "wgmma" \
        else flash_attention_fma_cuda
    return launch(q, k, v, scale=scale, causal=causal, window=window,
                  softcap=softcap)


def flash_attention_fma_cuda(q, k, v, *, scale=None, causal=True, window=0,
                             softcap=0.0) -> torch.Tensor:
    """The FMA kernel (``csrc/flash_attention.cu``) on contiguous fp32 or
    bf16 operands, any ``D`` in :data:`HEAD_DIMS`."""
    if not q.is_cuda:
        raise ValueError("flash_attention: q must be a CUDA tensor")
    if q.dtype not in DTYPES:
        raise TypeError(f"flash_attention takes {sorted(map(str, DTYPES))}, "
                        f"got {q.dtype}")
    dev = q.device
    for t, what in ((q, "q"), (k, "k"), (v, "v")):
        check_operand(t, what, q.dtype, dev)
    B, Hq, Hkv, Sq, Skv, D = _check_shapes(q, k, v, HEAD_DIMS)
    if scale is None:
        scale = D ** -0.5
    lib = cuda_build.load("flash_attention", _SIGNATURES)
    out = torch.empty_like(q)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            DTYPES[q.dtype], B, Hq, Hkv, Sq, Skv, D, float(scale),
            int(bool(causal)), int(window), float(softcap), stream)
    cuda_build.check_launch(lib, "flash_attention", rc)
    cuda_build.launches["flash_attention"] += 1
    return out


def flash_attention_wgmma_cuda(q, k, v, *, scale=None, causal=True,
                               window=0, softcap=0.0) -> torch.Tensor:
    """The tensor-core kernel (``csrc/flash_attention_wgmma.cu``) on bf16
    (B, H, S, D) views that :func:`strided_ok` accepts, ``D`` in
    :data:`WGMMA_HEAD_DIMS`.  The output has q's memory layout (a (B, S, H,
    D) buffer seen as (B, H, S, D) when q is one)."""
    if not q.is_cuda:
        raise ValueError("flash_attention: q must be a CUDA tensor")
    dev = q.device
    for t, what in ((q, "q"), (k, "k"), (v, "v")):
        _check_kind(t, what, torch.bfloat16, dev)
        if not strided_ok(t):
            raise ValueError(f"{what}: the tensor-core kernel needs a "
                             "contiguous last dim and strides that are "
                             f"multiples of 8 elements, got {t.stride()}")
    B, Hq, Hkv, Sq, Skv, D = _check_shapes(q, k, v, WGMMA_HEAD_DIMS)
    if scale is None:
        scale = D ** -0.5
    lib = cuda_build.load("flash_attention_wgmma", _WGMMA_SIGNATURES)
    out = torch.empty_like(q)  # preserves a dense q's strides
    if not strided_ok(out):
        out = torch.empty(q.shape, dtype=q.dtype, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.flash_attention_wgmma(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            *_strides(q), *_strides(k), *_strides(v), *_strides(out),
            B, Hq, Hkv, Sq, Skv, D, float(scale), int(bool(causal)),
            int(window), float(softcap), stream)
    cuda_build.check_launch(lib, "flash_attention_wgmma", rc)
    cuda_build.launches["flash_attention"] += 1
    cuda_build.launches["flash_attention_wgmma"] += 1
    return out


def flash_attention_bwd_cuda(q, k, v, out, dout, *, scale=None, causal=True,
                             window=0, softcap=0.0):
    """Launch the backward kernel (``csrc/flash_attention_bwd.cu``): the
    gradients (dq, dk, dv) of :func:`.ref.attention_ref`'s output ``out``
    against ``dout``, for contiguous fp32 or bf16 operands (all alike), any
    ``D`` in :data:`HEAD_DIMS`.  ``dk`` and ``dv`` sum each KV head's query
    group; everything is accumulated in fp32, each element by one thread in
    a fixed order (no atomics: a repeat gives the same bits).  One call is
    two kernels (dq with the rows' logsumexp, then dk and dv), counted once
    in ``launches["flash_attention_bwd"]``."""
    if not q.is_cuda:
        raise ValueError("flash_attention_bwd: q must be a CUDA tensor")
    if q.dtype not in DTYPES:
        raise TypeError(f"flash_attention_bwd takes "
                        f"{sorted(map(str, DTYPES))}, got {q.dtype}")
    dev = q.device
    for t, what in ((q, "q"), (k, "k"), (v, "v"), (out, "out"),
                    (dout, "dout")):
        check_operand(t, what, q.dtype, dev)
    B, Hq, Hkv, Sq, Skv, D = _check_shapes(q, k, v, HEAD_DIMS)
    if out.shape != q.shape or dout.shape != q.shape:
        raise ValueError(f"out {tuple(out.shape)} and dout "
                         f"{tuple(dout.shape)} must match q "
                         f"{tuple(q.shape)}")
    if scale is None:
        scale = D ** -0.5
    lib = cuda_build.load("flash_attention_bwd", _BWD_SIGNATURES)
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    lse, delta = torch.empty((2, B * Hq * Sq), dtype=torch.float32,
                             device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.flash_attention_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            dout.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), DTYPES[q.dtype], B, Hq, Hkv,
            Sq, Skv, D, float(scale), int(bool(causal)), int(window),
            float(softcap), stream)
    cuda_build.check_launch(lib, "flash_attention_bwd", rc)
    cuda_build.launches["flash_attention_bwd"] += 1
    return dq, dk, dv
