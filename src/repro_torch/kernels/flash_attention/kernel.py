"""Launch the hand-written CUDA flash-attention kernel
(``csrc/flash_attention.cu``).

The source is built and loaded by :mod:`repro_torch.kernels.cuda_build`
(``nvcc`` for ``sm_90a`` on first use, ``ctypes``).  The launcher takes
tensors on the card, checks them, allocates the output, launches on
``torch.cuda.current_stream()`` and counts the launch in
``cuda_build.launches["flash_attention"]``.  A launch the CUDA runtime
refuses raises: there is no fallback.  Nothing here runs at import time.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import cuda_build

__all__ = ["flash_attention_cuda", "HEAD_DIMS", "DTYPES"]

#: head dims the kernel is instantiated for
HEAD_DIMS = (8, 16, 32, 64, 128, 256)
#: element types it takes (q, k, v and out alike) → its dtype code
DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_P, _I32, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    "flash_attention": ([_P, _P, _P, _P, _I32, _I32, _I32, _I32, _I32, _I32,
                         _I32, _F, _I32, _I32, _F, _P], _I32),
    "flash_attention_error": ([_I32], ctypes.c_char_p),
}


def check_operand(t: torch.Tensor, what: str, dtype, device):
    """Raise unless ``t`` is a contiguous 4-D ``dtype`` tensor on
    ``device`` whose base is 16-byte aligned (the kernel loads 16 bytes at
    a time)."""
    if t.device != device:
        raise ValueError(f"{what} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{what} has dtype {t.dtype}, expected {dtype}")
    if t.ndim != 4:
        raise ValueError(f"{what} must be (B, H, S, D), got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{what} must be contiguous")
    if t.data_ptr() % 16:
        raise ValueError(f"{what} must start on a 16-byte boundary")


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
    """Launch the kernel; arguments and result as :func:`.ref.attention_ref`
    (fp32 or bf16, all three alike; ``Hq`` a multiple of ``Hkv``; ``D`` in
    :data:`HEAD_DIMS`).  A fully masked row comes out 0, not NaN."""
    if not q.is_cuda:
        raise ValueError("flash_attention: q must be a CUDA tensor")
    if q.dtype not in DTYPES:
        raise TypeError(f"flash_attention takes {sorted(map(str, DTYPES))}, "
                        f"got {q.dtype}")
    dev = q.device
    for t, what in ((q, "q"), (k, "k"), (v, "v")):
        check_operand(t, what, q.dtype, dev)
    B, Hq, Sq, D = q.shape
    _, Hkv, Skv, _ = k.shape
    if k.shape[0] != B or k.shape[3] != D or v.shape != k.shape:
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} do not "
                         f"match q {tuple(q.shape)}")
    if Hq % Hkv:
        raise ValueError(f"Hq={Hq} is not a multiple of Hkv={Hkv}")
    if D not in HEAD_DIMS:
        raise ValueError(f"head dim {D} not supported; the kernel is built "
                         f"for {HEAD_DIMS}")
    if min(Sq, Skv) < 1 or max(B, Hq) > 65535:
        raise ValueError(f"unsupported shape q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}")
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
