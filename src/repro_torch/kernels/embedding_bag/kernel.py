"""Launch the hand-written CUDA EmbeddingBag kernel
(``csrc/embedding_bag.cu``).

The source is built and loaded by :mod:`repro_torch.kernels.cuda_build`
(``nvcc`` for ``sm_90a`` on first use, ``ctypes``).  The launcher takes
tensors on the card, checks them, allocates the output, launches on
``torch.cuda.current_stream()`` and counts the launch in
``cuda_build.launches["embedding_bag"]``, and the route the source chose
for it (:data:`ROUTES`: it picks one from ``B``, ``d`` and the card's SM
count) in :data:`routes`.  A launch the CUDA runtime refuses
raises: there is no fallback.  Nothing here runs at import time.
"""
from __future__ import annotations

import collections
import ctypes
from typing import Optional

import torch

from repro_torch.kernels import cuda_build
from repro_torch.kernels.cuda_build import check_tensor

__all__ = ["embedding_bag_cuda", "DTYPES", "ID_DTYPES", "ROUTES", "routes"]

#: table (and output) types the kernel takes → its dtype code
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: id types it reads in place → its idx64 flag
ID_DTYPES = {torch.int32: 0, torch.int64: 1}
#: the source's designs, by the code its ``embedding_bag_route`` returns:
#: one bag a lane group (``groups``, many bags), a bag's ids split over a
#: CTA's groups (``split``, few bags), one element a load (``scalar``: a
#: row that is no whole number of 16-byte chunks)
ROUTES = ("groups", "split", "scalar")

#: launches per route, counted where :func:`embedding_bag_cuda` launches
routes: collections.Counter = collections.Counter()

_P, _I64, _I32, _F = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, \
    ctypes.c_float
_SIGNATURES = {
    "embedding_bag": ([_P, _P, _P, _F, _P, _I64, _I64, _I64, _I32, _I32,
                       _I32, _P], _I32),
    "embedding_bag_route": ([_P, _P, _I64, _I64, _I32, _I32], _I32),
    "embedding_bag_error": ([_I32], ctypes.c_char_p),
}


def embedding_bag_cuda(table: torch.Tensor, indices: torch.Tensor,
                       weights: Optional[torch.Tensor] = None, *,
                       weight: float = 1.0) -> torch.Tensor:
    """Launch the kernel: ``out[b] = Σ_l w[b, l] · table[indices[b, l]]``
    over the ids in ``[0, V)`` (an id outside is never read), with ``w``
    the fp32 ``weights`` or, when they are None, ``weight`` everywhere.
    ``table`` fp32 or bf16 ``(V, d)``, ``indices`` int32 or int64
    ``(B, L)``, all contiguous on one card.  Returns ``(B, d)`` in
    ``table.dtype``, summed in fp32 in a fixed order (``l = 0..L-1``; on
    the ``split`` route per contiguous part of the bag, then the parts in
    order), so a repeat is bit-identical."""
    if not table.is_cuda:
        raise ValueError("embedding_bag: table must be a CUDA tensor")
    if table.dtype not in DTYPES:
        raise TypeError(f"embedding_bag: table dtype {table.dtype} is not "
                        f"one of {list(DTYPES)}")
    if indices.dtype not in ID_DTYPES:
        raise TypeError(f"embedding_bag: ids dtype {indices.dtype} is not "
                        f"one of {list(ID_DTYPES)}")
    if table.ndim != 2 or indices.ndim != 2:
        raise ValueError(f"embedding_bag: table must be (V, d) and ids "
                         f"(B, L), got {tuple(table.shape)} and "
                         f"{tuple(indices.shape)}")
    cuda_build.refuse_grad(
        "embedding_bag", (table, weights),
        "use backend='torch' (gathers, which autograd differentiates), as "
        "BERT4Rec's training loss does")
    dev = table.device
    (V, d), (B, L) = table.shape, indices.shape
    check_tensor(table, "table", table.dtype, (V, d), dev)
    check_tensor(indices, "indices", indices.dtype, (B, L), dev)
    if weights is not None:
        check_tensor(weights, "weights", torch.float32, (B, L), dev)
    out = torch.empty((B, d), dtype=table.dtype, device=dev)
    if out.numel() == 0:
        return out  # nothing to launch
    lib = cuda_build.load("embedding_bag", _SIGNATURES)
    with torch.cuda.device(dev):
        route = lib.embedding_bag_route(table.data_ptr(), out.data_ptr(), B,
                                        L, d, DTYPES[table.dtype])
        if route < 0:
            cuda_build.check_launch(lib, "embedding_bag", -1 - route)
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.embedding_bag(
            table.data_ptr(), indices.data_ptr(),
            None if weights is None else weights.data_ptr(), weight,
            out.data_ptr(), B, L, V, d, DTYPES[table.dtype],
            ID_DTYPES[indices.dtype], stream)
    cuda_build.check_launch(lib, "embedding_bag", rc)
    cuda_build.count_launch("embedding_bag")
    routes[ROUTES[route]] += 1
    return out
