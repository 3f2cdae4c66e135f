"""Public fused-TOCAB entry points: backend pick, checks, telemetry.

``fused_pull`` / ``fused_push`` / ``fused_edge_reduce`` are what
``repro_torch.core.tocab``'s ``impl="fused"`` dispatches to.  Two backends:

* ``"cuda"`` — the hand-written kernels in :mod:`.kernel`, the default for
  tensors on the card.  A CUDA tensor reaches the kernel or the call
  raises; nothing falls back.  The kernels take ``combine=None``,
  ``UNWEIGHTED`` and ``ADD_EDGE`` (:func:`_kernel_mode`).
* ``"torch"`` — the plain versions in :mod:`.ref`, the default for tensors
  on the CPU.

Each call records what fusion removes: ``tocab.fused_blocks`` counts blocks
run through the fused path and ``tocab.partial_hbm_bytes_saved`` the
partial / ``block_contrib`` slab bytes that are never materialized.
"""
from __future__ import annotations

import math
from typing import Callable, Optional, Sequence, Tuple

import torch

from repro_torch.core.balance import ADD_EDGE, UNWEIGHTED
from repro_torch.core.partition import BlockedGraph
from repro_torch.core.tocab import _require_direction
from repro_torch.obs.metrics import registry as _obs

from .kernel import fused_pull_cuda, fused_push_cuda
from .ref import (check_block_order, fused_edge_reduce_ref, fused_pull_ref,
                  fused_push_ref)

__all__ = ["fused_pull", "fused_push", "fused_edge_reduce",
           "default_backend"]


def default_backend(t: torch.Tensor) -> str:
    """``"cuda"`` for a tensor on the card, ``"torch"`` otherwise."""
    return "cuda" if t.is_cuda else "torch"


def _record_fused(bg: BlockedGraph, engine: str, tail: Tuple[int, ...],
                  itemsize: int):
    _obs.counter(
        "tocab.fused_blocks", "cache blocks run through the fused path"
    ).inc(bg.num_blocks, engine=engine, direction=bg.direction)
    saved = bg.num_blocks * bg.local_budget * itemsize
    saved *= math.prod(tail) if tail else 1
    _obs.counter(
        "tocab.partial_hbm_bytes_saved",
        "partial/contrib slab bytes the fused path never materializes",
    ).inc(saved, engine=engine, direction=bg.direction)


def _check_epilogue(reduce: str, epilogue):
    if epilogue is not None and reduce != "sum":
        raise ValueError(
            f"epilogue fusion is affine (out*mul+add) — only the sum "
            f"semiring supports it, got reduce={reduce!r}")


def _backend(values: torch.Tensor, backend: Optional[str]) -> str:
    backend = backend or default_backend(values)
    if backend not in ("cuda", "torch"):
        raise ValueError(f"unknown fused backend {backend!r}")
    if backend == "cuda" and not values.is_cuda:
        raise ValueError("backend='cuda' needs tensors on the card")
    return backend


def _kernel_mode(bg: BlockedGraph, combine):
    """``(edge values or None, message mode)`` for the CUDA kernels:
    ``combine=None`` multiplies by the stored edge values (``"mul"``, or
    ``"none"`` on an unweighted layout), ``UNWEIGHTED`` ignores them
    (``"none"``), ``ADD_EDGE`` adds them (``"add_ev"``, or ``"add_one"``:
    ``v + 1`` on an unweighted layout, as the slab engines compute it).
    Other combines have no kernel."""
    ev = bg.edge_vals
    if combine is UNWEIGHTED:
        return None, "none"
    if combine is ADD_EDGE:
        return (ev, "add_ev") if ev is not None else (None, "add_one")
    if combine is not None:
        raise NotImplementedError(
            "the CUDA fused kernels take combine=None (multiply by the edge "
            "value), UNWEIGHTED or ADD_EDGE (add the edge value, 1 without "
            "one); run other combines on CPU tensors")
    return (ev, "mul") if ev is not None else (None, "none")


def _run_kernel(launch, bg: BlockedGraph, values, reduce, combine,
                epilogue):
    if values.ndim not in (1, 2):
        raise NotImplementedError(
            "the CUDA fused kernels take (n,) or (n, d) values")
    x = values[:, None] if values.ndim == 1 else values
    ev, mode = _kernel_mode(bg, combine)
    out = launch(x, bg.window_idx, bg.compact_idx, ev, bg.edge_mask,
                 bg.id_map, block_size=bg.block_size, reduce=reduce,
                 epilogue=epilogue, mode=mode)
    return out[:, 0] if values.ndim == 1 else out


def fused_pull(
    bg: BlockedGraph,
    values: torch.Tensor,
    reduce: str = "sum",
    combine: Optional[Callable] = None,
    epilogue: Optional[Tuple] = None,
    backend: Optional[str] = None,
    block_order: Optional[Sequence[int]] = None,
):
    """out[dst] = ⊕ values[src] (⊗ edge_val) with no partial slab; optional
    affine epilogue ``out*mul + add``.  ``block_order`` is validated and
    changes nothing: the kernel's CTAs run in no order, and the plain
    version reduces the whole layout at once."""
    _require_direction(bg, "pull")
    _check_epilogue(reduce, epilogue)
    check_block_order(bg, block_order)
    backend = _backend(values, backend)
    _record_fused(bg, "fused_pull", tuple(values.shape[1:]),
                  values.element_size())
    if backend == "torch":
        return fused_pull_ref(bg, values, reduce, combine, epilogue)
    return _run_kernel(fused_pull_cuda, bg, values, reduce, combine,
                       epilogue)


def fused_push(
    bg: BlockedGraph,
    values: torch.Tensor,
    reduce: str = "sum",
    combine: Optional[Callable] = None,
    epilogue: Optional[Tuple] = None,
    backend: Optional[str] = None,
    block_order: Optional[Sequence[int]] = None,
):
    """Push with no ``block_contrib`` slab.  Blocks own disjoint destination
    windows, so ``block_order`` (for example the balance module's bin-major
    ``fused_block_order``) cannot change the result; a given order is
    validated and otherwise unused."""
    _require_direction(bg, "push")
    _check_epilogue(reduce, epilogue)
    check_block_order(bg, block_order)
    backend = _backend(values, backend)
    _record_fused(bg, "fused_push", tuple(values.shape[1:]),
                  values.element_size())
    if backend == "torch":
        return fused_push_ref(bg, values, reduce, combine, epilogue)
    return _run_kernel(fused_push_cuda, bg, values, reduce, combine,
                       epilogue)


def fused_edge_reduce(
    bg: BlockedGraph,
    flat_edge_vals: torch.Tensor,
    reduce: str = "sum",
    epilogue: Optional[Tuple] = None,
    backend: Optional[str] = None,
):
    """Edge-value → compacted-side aggregate, no partial slab.  The
    reference has no TPU kernel for it (messages come from the blocked
    edge-value slab, not a value window), so the plain version is the
    implementation on every device; ``backend`` is accepted for symmetry."""
    _check_epilogue(reduce, epilogue)
    _backend(flat_edge_vals, backend)
    _record_fused(bg, "fused_edge_reduce", tuple(flat_edge_vals.shape[1:]),
                  flat_edge_vals.element_size())
    return fused_edge_reduce_ref(bg, flat_edge_vals, reduce, epilogue)
