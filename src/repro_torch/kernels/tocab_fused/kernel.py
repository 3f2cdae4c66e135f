"""Build, load and launch the hand-written CUDA kernels of the fused TOCAB
pipeline (``csrc/fused_pull.cu``, ``csrc/fused_push.cu``).

Each source is compiled by ``nvcc`` for ``sm_90a`` into a shared library
with a plain C interface, loaded with ``ctypes`` — no PyTorch headers, so a
build takes seconds.  The libraries go to ``_build/`` beside this file on
first use (all sources compiled at once, one ``nvcc`` each); a source newer
than its library is rebuilt.  A failed build raises, and so does a launch
the CUDA runtime refuses: there is no fallback.

The launchers take tensors on the card, check them, allocate the output,
launch on ``torch.cuda.current_stream()`` and count the launch in
:data:`launches`.  Nothing here runs at import time.
"""
from __future__ import annotations

import collections
import ctypes
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional, Tuple

import torch

from repro_torch.core.partition import REDUCE_IDENTITY

__all__ = ["build", "launches", "reset_launches", "fused_pull_cuda",
           "fused_push_cuda", "SOURCES"]

_HERE = Path(__file__).resolve().parent
_CSRC = _HERE / "csrc"
_BUILD = _HERE / "_build"

#: kernel name → source file under csrc/
SOURCES = {"fused_pull": "fused_pull.cu", "fused_push": "fused_push.cu"}

_NVCC_FLAGS = ["-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
               "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v"]

_REDUCE_CODE = {"sum": 0, "min": 1, "max": 2}

#: launches per kernel name, counted by the launchers below and nowhere else
launches: collections.Counter = collections.Counter()

_LIBS: dict = {}
_LOCK = threading.Lock()


def reset_launches():
    launches.clear()


def _nvcc() -> str:
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin/nvcc"
    found = str(cand) if cand.exists() else shutil.which("nvcc")
    if not found:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin "
            "and PATH): the fused TOCAB kernels cannot be built")
    return found


def _lib_path(name: str) -> Path:
    return _BUILD / f"lib{name}.so"


def build(names=None) -> dict:
    """Compile the kernels' sources that have no up-to-date library, all at
    once (one ``nvcc`` process per source).  Returns ``{name: compiler
    output}`` for what was compiled (``-Xptxas=-v`` lists each kernel's
    registers and shared memory); raises ``RuntimeError`` if any build
    fails."""
    names = list(SOURCES) if names is None else list(names)
    todo = [nm for nm in names
            if not _lib_path(nm).exists()
            or _lib_path(nm).stat().st_mtime
            < (_CSRC / SOURCES[nm]).stat().st_mtime]
    if not todo:
        return {}
    _BUILD.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for nm in todo:
        tmp = _BUILD / f"lib{nm}.{os.getpid()}.tmp.so"
        procs[nm] = (tmp, subprocess.Popen(
            [nvcc, *_NVCC_FLAGS, "-o", str(tmp), str(_CSRC / SOURCES[nm])],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    logs, failed = {}, []
    for nm, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        logs[nm] = out
        if proc.returncode != 0:
            failed.append(nm)
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, _lib_path(nm))  # atomic: readers see whole files
    if failed:
        raise RuntimeError("nvcc failed for " + ", ".join(failed) + ":\n"
                           + "\n".join(logs[nm] for nm in failed))
    return logs


def _lib(name: str) -> ctypes.CDLL:
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(_lib_path(name)))
            fn = getattr(lib, f"tocab_{name}")
            p, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
            fn.argtypes = [p, p, p, p, p, p, p, p, i64, i64, i64, i64, i64,
                           i32, i32, i32, p]
            fn.restype = i32
            err = getattr(lib, f"tocab_{name}_error")
            err.argtypes, err.restype = [i32], ctypes.c_char_p
            if name == "fused_push":
                lib.tocab_fused_push_window_shared.argtypes = [i64, i32]
                lib.tocab_fused_push_window_shared.restype = i32
            _LIBS[name] = lib
        return lib


def _check(t: torch.Tensor, what: str, dtype, shape, device):
    if t.device != device:
        raise ValueError(f"{what} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{what} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{what} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{what} must be contiguous")


def _epilogue_tensor(epilogue, device) -> Optional[torch.Tensor]:
    if epilogue is None:
        return None
    mul, add = epilogue
    return torch.stack([
        torch.as_tensor(v, dtype=torch.float32, device=device).reshape(())
        for v in (mul, add)])


def _launch(name: str, values: torch.Tensor, window_idx, compact_idx,
            edge_vals, edge_mask, id_map, *, block_size: int, reduce: str,
            epilogue) -> torch.Tensor:
    if reduce not in _REDUCE_CODE:
        raise ValueError(f"unknown reduce {reduce!r}")
    if epilogue is not None and reduce != "sum":
        raise ValueError(
            f"epilogue fusion is affine (out*mul+add) — only the sum "
            f"semiring supports it, got reduce={reduce!r}")
    if not values.is_cuda:
        raise ValueError(f"{name}: values must be a CUDA tensor")
    if values.ndim != 2:
        raise ValueError(f"{name}: values must be (n, d), got "
                         f"{tuple(values.shape)}")
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
            block_size, d, _REDUCE_CODE[reduce], int(eps is not None),
            stream)
    if rc != 0:
        msg = getattr(lib, f"tocab_{name}_error")(rc).decode()
        raise RuntimeError(f"{name} launch failed: CUDA error {rc} ({msg})")
    launches[name] += 1
    return out


def fused_pull_cuda(values: torch.Tensor, window_idx, compact_idx, edge_vals,
                    edge_mask, id_map, *, block_size: int, reduce: str = "sum",
                    epilogue: Optional[Tuple] = None) -> torch.Tensor:
    """Launch the fused pull kernel: ``values`` f32 ``(n, d)`` on the card,
    the blocked slabs as stored (int32 indices, bool mask, f32 edge values
    or ``None`` for unweighted).  Returns f32 ``(n, d)``."""
    return _launch("fused_pull", values, window_idx, compact_idx, edge_vals,
                   edge_mask, id_map, block_size=block_size, reduce=reduce,
                   epilogue=epilogue)


def fused_push_cuda(values: torch.Tensor, window_idx, compact_idx, edge_vals,
                    edge_mask, id_map, *, block_size: int, reduce: str = "sum",
                    epilogue: Optional[Tuple] = None) -> torch.Tensor:
    """Launch the fused push kernel (arguments as :func:`fused_pull_cuda`,
    on a push layout).  Returns f32 ``(n, d)``."""
    return _launch("fused_push", values, window_idx, compact_idx, edge_vals,
                   edge_mask, id_map, block_size=block_size, reduce=reduce,
                   epilogue=epilogue)
