"""Build, load and check the port's hand-written CUDA kernels, for every
kernel directory.

Each source (``<family>/csrc/<name>.cu``) is compiled by ``nvcc`` for
``sm_90a`` into a shared library with a plain C interface and loaded with
``ctypes`` — no PyTorch headers, so a build takes seconds.  Libraries go to
``<family>/_build/`` on first use; a source newer than its library is
rebuilt.  :func:`build` compiles every stale source at once, one ``nvcc``
process each.  A failed build raises, and so does a launch the CUDA runtime
refuses (:func:`check_launch`): there is no fallback.

:data:`launches` counts launches per kernel name; each launcher adds one
where it launches its kernel and nowhere else.  Nothing here runs at import
time.
"""
from __future__ import annotations

import collections
import ctypes
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable, Optional, Sequence, Tuple

import torch

__all__ = ["SOURCES", "BACKENDS", "build", "load", "check_launch",
           "check_tensor", "pick_backend", "refuse_grad", "launches",
           "reset_launches"]

_KERNELS = Path(__file__).resolve().parent

#: kernel name → source file, relative to this package
SOURCES = {
    "fused_pull": "tocab_fused/csrc/fused_pull.cu",
    "fused_push": "tocab_fused/csrc/fused_push.cu",
    "tocab_spmm": "tocab_spmm/csrc/tocab_spmm.cu",
    "flash_attention": "flash_attention/csrc/flash_attention.cu",
    "flash_attention_wgmma": "flash_attention/csrc/flash_attention_wgmma.cu",
    "flash_attention_bwd": "flash_attention/csrc/flash_attention_bwd.cu",
    "flash_decode": "flash_attention/csrc/flash_decode.cu",
    "embedding_bag": "embedding_bag/csrc/embedding_bag.cu",
}

#: what a kernel family's ``backend=`` takes: the hand-written kernel, or
#: its plain PyTorch version
BACKENDS = ("cuda", "torch")

_NVCC_FLAGS = ["-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
               "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v"]

#: launches per kernel name, counted by the launchers and nowhere else
launches: collections.Counter = collections.Counter()

_LIBS: dict = {}
_LOCK = threading.Lock()


def reset_launches():
    launches.clear()


def _source(name: str) -> Path:
    return _KERNELS / SOURCES[name]


def _lib_path(name: str) -> Path:
    return _source(name).parent.parent / "_build" / f"lib{name}.so"


def _nvcc() -> str:
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin/nvcc"
    found = str(cand) if cand.exists() else shutil.which("nvcc")
    if not found:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin "
            "and PATH): the CUDA kernels cannot be built")
    return found


def build(names: Optional[Iterable[str]] = None) -> Dict[str, str]:
    """Compile the named kernels' sources (default: all) that have no
    up-to-date library, all at once.  Returns ``{name: compiler output}``
    for what was compiled (``-Xptxas=-v`` lists each kernel's registers and
    shared memory); raises ``RuntimeError`` if any build fails."""
    names = list(SOURCES) if names is None else list(names)
    todo = [nm for nm in names
            if not _lib_path(nm).exists()
            or _lib_path(nm).stat().st_mtime < _source(nm).stat().st_mtime]
    if not todo:
        return {}
    nvcc = _nvcc()
    procs = {}
    for nm in todo:
        _lib_path(nm).parent.mkdir(parents=True, exist_ok=True)
        tmp = _lib_path(nm).with_suffix(f".{os.getpid()}.tmp.so")
        procs[nm] = (tmp, subprocess.Popen(
            [nvcc, *_NVCC_FLAGS, "-o", str(tmp), str(_source(nm))],
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


def load(name: str, signatures: Dict[str, Tuple[Sequence, object]]
         ) -> ctypes.CDLL:
    """Kernel ``name``'s library, built if stale and loaded once.  On first
    load each ``{function: (argtypes, restype)}`` of ``signatures`` is
    declared (pass every pointer as ``c_void_p``: an undeclared argument
    goes as a 32-bit int and cuts it)."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(_lib_path(name)))
            for fn, (argtypes, restype) in signatures.items():
                getattr(lib, fn).argtypes = list(argtypes)
                getattr(lib, fn).restype = restype
            _LIBS[name] = lib
        return lib


def check_launch(lib: ctypes.CDLL, entry: str, rc: int):
    """Raise if C entry ``entry`` returned a CUDA error (its library
    exports ``<entry>_error`` to name the code)."""
    if rc != 0:
        msg = getattr(lib, f"{entry}_error")(rc).decode()
        raise RuntimeError(f"{entry} launch failed: CUDA error {rc} ({msg})")


def check_tensor(t: torch.Tensor, what: str, dtype, shape, device):
    """Raise unless ``t`` is a contiguous ``dtype`` tensor of ``shape`` on
    ``device`` — what a raw pointer into it assumes."""
    if t.device != device:
        raise ValueError(f"{what} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{what} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{what} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{what} must be contiguous")


def refuse_grad(name: str, tensors: Iterable[Optional[torch.Tensor]],
                instead: str):
    """Raise if autograd would record a launch of kernel ``name`` on
    ``tensors``: grad mode is on and one of them requires grad.  A ctypes
    launch returns a tensor with no ``grad_fn``, so a loss built on it
    would backpropagate without error and give its inputs no gradient.
    ``instead`` names the differentiable path."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name}: the CUDA kernel has no backward, and an input "
            f"requires grad (its gradient would be dropped); {instead}")


def pick_backend(t: torch.Tensor, backend: Optional[str]) -> str:
    """``backend``, or by device when it is None: ``"cuda"`` for a tensor on
    the card, ``"torch"`` otherwise.  Raises for ``"cuda"`` on a CPU tensor,
    for the reference's ``"pallas"`` (naming ``"cuda"``) and for any name
    but those two."""
    if backend == "pallas":
        raise ValueError("backend='pallas' is the TPU kernel; the port's "
                         "hand-written kernel is backend='cuda'")
    if backend is None:
        backend = "cuda" if t.is_cuda else "torch"
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; expected one of "
                         f"{BACKENDS}")
    if backend == "cuda" and not t.is_cuda:
        raise ValueError("backend='cuda' needs tensors on the card")
    return backend
