"""Launch the hand-written CUDA kernels of the fused TOCAB pipeline
(``csrc/fused_pull.cu``, ``csrc/fused_push.cu``).

The sources are built and loaded by :mod:`repro_torch.kernels.cuda_build`
(``nvcc`` for ``sm_90a`` on first use, ``ctypes``).  The launchers take
tensors on the card, check them, allocate the output, launch on
``torch.cuda.current_stream()`` and count the launch in
``cuda_build.launches``.  A launch the CUDA runtime refuses raises: there
is no fallback.  Nothing here runs at import time.

Both kernels form each edge's message in one of four modes (``MODES``),
which is how the engines' ``combine`` reaches the card:

* ``"mul"`` — ``v * ev`` (``combine=None`` on a weighted layout);
* ``"none"`` — ``v`` (``UNWEIGHTED``, or no edge values);
* ``"add_ev"`` — ``v + ev`` (``ADD_EDGE`` on a weighted layout);
* ``"add_one"`` — ``v + 1`` (``ADD_EDGE`` on a layout without edge values).
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.core.partition import REDUCE_IDENTITY
from repro_torch.kernels import cuda_build
from repro_torch.kernels.cuda_build import check_tensor as _check

__all__ = ["fused_pull_cuda", "fused_push_cuda", "MODES", "signatures"]

_REDUCE_CODE = {"sum": 0, "min": 1, "max": 2}
#: message mode → the C interface's ``mode`` code
_MODE_CODE = {"mul": 0, "none": 1, "add_ev": 2, "add_one": 3}
MODES = tuple(_MODE_CODE)
#: the modes that read an edge value
_EDGE_MODES = ("mul", "add_ev")

_P, _I64, _I32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int


def signatures(name: str) -> dict:
    """The ctypes signatures of kernel ``name``'s library (``fused_pull``
    or ``fused_push``)."""
    entry = f"tocab_{name}"
    sigs = {
        entry: ([_P, _P, _P, _P, _P, _P, _P, _P, _I64, _I64, _I64, _I64,
                 _I64, _I32, _I32, _I32, _I32, _P], _I32),
        f"{entry}_error": ([_I32], ctypes.c_char_p),
    }
    if name == "fused_push":
        sigs["tocab_fused_push_window_shared"] = ([_I64, _I32], _I32)
    return sigs


def _lib(name: str) -> ctypes.CDLL:
    return cuda_build.load(name, signatures(name))


def _epilogue_tensor(epilogue, device) -> Optional[torch.Tensor]:
    if epilogue is None:
        return None
    mul, add = epilogue
    return torch.stack([
        torch.as_tensor(v, dtype=torch.float32, device=device).reshape(())
        for v in (mul, add)])


def _launch(name: str, values: torch.Tensor, window_idx, compact_idx,
            edge_vals, edge_mask, id_map, *, block_size: int, reduce: str,
            epilogue, mode: Optional[str]) -> torch.Tensor:
    if reduce not in _REDUCE_CODE:
        raise ValueError(f"unknown reduce {reduce!r}")
    if mode is None:
        mode = "mul" if edge_vals is not None else "none"
    if mode not in _MODE_CODE:
        raise ValueError(f"unknown message mode {mode!r}; expected one of "
                         f"{MODES}")
    if (mode in _EDGE_MODES) != (edge_vals is not None):
        raise ValueError(f"message mode {mode!r} "
                         + ("needs" if mode in _EDGE_MODES else "takes no")
                         + " edge values")
    if epilogue is not None and reduce != "sum":
        raise ValueError(
            f"epilogue fusion is affine (out*mul+add) — only the sum "
            f"semiring supports it, got reduce={reduce!r}")
    if not values.is_cuda:
        raise ValueError(f"{name}: values must be a CUDA tensor")
    if values.ndim != 2:
        raise ValueError(f"{name}: values must be (n, d), got "
                         f"{tuple(values.shape)}")
    cuda_build.refuse_grad(
        name, (values, edge_vals),
        "run impl='slab', which autograd differentiates (a backward for "
        "the fused engines is ROADMAP B8)")
    dev = values.device
    n, d = values.shape
    nb, eb = window_idx.shape
    lb = id_map.shape[1]
    if nb * block_size < n:
        raise ValueError(f"{nb} blocks of {block_size} do not cover n={n}")
    _check(values, "values", torch.float32, (n, d), dev)
    _check(window_idx, "window_idx", torch.int32, (nb, eb), dev)
    _check(compact_idx, "compact_idx", torch.int32, (nb, eb), dev)
    _check(edge_mask, "edge_mask", torch.bool, (nb, eb), dev)
    _check(id_map, "id_map", torch.int32, (nb, lb), dev)
    if edge_vals is not None:
        _check(edge_vals, "edge_vals", torch.float32, (nb, eb), dev)
    lib = _lib(name)
    eps = _epilogue_tensor(epilogue, dev)
    if name == "fused_push" and lib.tocab_fused_push_window_shared(
            block_size, d):
        out = torch.empty((n, d), dtype=torch.float32, device=dev)
    else:
        out = torch.full((n, d), REDUCE_IDENTITY[reduce],
                         dtype=torch.float32, device=dev)

    def ptr(t):
        return None if t is None else t.data_ptr()

    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = getattr(lib, f"tocab_{name}")(
            ptr(values), ptr(window_idx), ptr(compact_idx), ptr(edge_vals),
            ptr(edge_mask), ptr(id_map), ptr(eps), ptr(out), n, nb, eb, lb,
            block_size, d, _REDUCE_CODE[reduce], _MODE_CODE[mode],
            int(eps is not None), stream)
    cuda_build.check_launch(lib, f"tocab_{name}", rc)
    cuda_build.launches[name] += 1
    return out


def fused_pull_cuda(values: torch.Tensor, window_idx, compact_idx, edge_vals,
                    edge_mask, id_map, *, block_size: int, reduce: str = "sum",
                    epilogue: Optional[Tuple] = None,
                    mode: Optional[str] = None) -> torch.Tensor:
    """Launch the fused pull kernel: ``values`` f32 ``(n, d)`` on the card,
    the blocked slabs as stored (int32 indices, bool mask, f32 edge values
    or ``None`` for unweighted).  ``mode`` is one of ``MODES``; by default
    ``"mul"`` with edge values and ``"none"`` without.  Returns f32
    ``(n, d)``."""
    return _launch("fused_pull", values, window_idx, compact_idx, edge_vals,
                   edge_mask, id_map, block_size=block_size, reduce=reduce,
                   epilogue=epilogue, mode=mode)


def fused_push_cuda(values: torch.Tensor, window_idx, compact_idx, edge_vals,
                    edge_mask, id_map, *, block_size: int, reduce: str = "sum",
                    epilogue: Optional[Tuple] = None,
                    mode: Optional[str] = None) -> torch.Tensor:
    """Launch the fused push kernel (arguments as :func:`fused_pull_cuda`,
    on a push layout).  Returns f32 ``(n, d)``."""
    return _launch("fused_push", values, window_idx, compact_idx, edge_vals,
                   edge_mask, id_map, block_size=block_size, reduce=reduce,
                   epilogue=epilogue, mode=mode)
