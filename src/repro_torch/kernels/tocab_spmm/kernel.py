"""Launch the hand-written CUDA kernel of the TOCAB blocked SpMM
(``csrc/tocab_spmm.cu``).

The source is built and loaded by :mod:`repro_torch.kernels.cuda_build`
(``nvcc`` for ``sm_90a`` on first use, ``ctypes``).  The launcher takes
tensors on the card, checks them, allocates the zero-filled slab, launches
on ``torch.cuda.current_stream()`` and counts the launch in
``cuda_build.launches["tocab_spmm"]``.  A launch the CUDA runtime refuses
raises: there is no fallback.  Nothing here runs at import time.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import cuda_build
from repro_torch.kernels.cuda_build import check_tensor

__all__ = ["tocab_spmm_cuda"]

_P, _I64, _I32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
_SIGNATURES = {
    "tocab_spmm": ([_P, _P, _P, _P, _P, _P, _P, _I64, _I64, _I64, _I64,
                    _I64, _I32, _P], _I32),
    "tocab_spmm_error": ([_I32], ctypes.c_char_p),
}


def tocab_spmm_cuda(values: torch.Tensor, window_idx: torch.Tensor,
                    compact_idx: torch.Tensor, edge_mask: torch.Tensor,
                    edge_vals: Optional[torch.Tensor],
                    block_ids: torch.Tensor, *, block_size: int,
                    local_budget: int) -> torch.Tensor:
    """Launch the kernel: ``values`` f32 ``(n, d)`` on the card, the
    layout's slabs as stored (int32 indices, bool mask, f32 edge values or
    ``None`` for unweighted), ``block_ids`` int32 ``(k,)`` on the card with
    every id in ``[0, num_blocks)`` (ids outside are skipped).  Returns f32
    ``(k, local_budget, d)``; arguments as :func:`.ref.tocab_spmm_ref`."""
    if not values.is_cuda:
        raise ValueError("tocab_spmm: values must be a CUDA tensor")
    if values.ndim != 2:
        raise ValueError(f"tocab_spmm: values must be (n, d), got "
                         f"{tuple(values.shape)}")
    if local_budget < 0:
        raise ValueError(f"local_budget must be ≥ 0, got {local_budget}")
    cuda_build.refuse_grad(
        "tocab_spmm", (values, edge_vals),
        "run schedule='uniform' (the slab engine) or dense_impl='onehot', "
        "which autograd differentiates")
    dev = values.device
    n, d = values.shape
    nb, eb = window_idx.shape
    k = block_ids.shape[0] if block_ids.ndim == 1 else -1
    if nb * block_size < n:
        raise ValueError(f"{nb} blocks of {block_size} do not cover n={n}")
    check_tensor(values, "values", torch.float32, (n, d), dev)
    check_tensor(window_idx, "window_idx", torch.int32, (nb, eb), dev)
    check_tensor(compact_idx, "compact_idx", torch.int32, (nb, eb), dev)
    check_tensor(edge_mask, "edge_mask", torch.bool, (nb, eb), dev)
    check_tensor(block_ids, "block_ids", torch.int32, (k,), dev)
    if edge_vals is not None:
        check_tensor(edge_vals, "edge_vals", torch.float32, (nb, eb), dev)
    lib = cuda_build.load("tocab_spmm", _SIGNATURES)
    out = torch.zeros((k, local_budget, d), dtype=torch.float32, device=dev)
    if out.numel() == 0 or eb == 0:
        return out  # nothing to launch

    def ptr(t):
        return None if t is None else t.data_ptr()

    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.tocab_spmm(
            ptr(values), ptr(window_idx), ptr(compact_idx), ptr(edge_vals),
            ptr(edge_mask), ptr(block_ids), ptr(out), k, nb, eb, block_size,
            local_budget, d, stream)
    cuda_build.check_launch(lib, "tocab_spmm", rc)
    cuda_build.launches["tocab_spmm"] += 1
    return out
