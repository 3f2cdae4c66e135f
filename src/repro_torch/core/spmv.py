"""SpMV (paper Fig. 7): y = A·x over the graph's weighted adjacency.

Most vertex programs are generalized SpMV (paper cites GraphMat).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.resilience import degrade
from .graph import DeviceGraph
from .partition import BlockedGraph
from . import tocab

__all__ = ["spmv", "SPMV_VARIANTS"]

SPMV_VARIANTS = ("base", "push", "cb", "gc-pull", "gc-push")


def spmv(
    dg: DeviceGraph,
    bg: Optional[BlockedGraph],
    x: torch.Tensor,
    variant: str = "gc-pull",
    schedule: str = "uniform",
    dense_impl: Optional[str] = None,
    impl: str = "slab",
    scale=None,
    allow_fallback=None,
):
    """y[dst] = Σ_{(src,dst)} A[src,dst]·x[src].

    ``x`` may be a vector (n,) — SpMV — or a matrix (n, d) — SpMM, the GNN
    aggregation primitive; it lives on the graph's device.  ``impl='fused'``
    routes the gc variants through the fused pipeline (the CUDA kernels on
    the card).  ``scale`` fuses ``y*scale`` into the engine epilogue (gc
    variants) or scales afterwards (the others).  ``schedule`` /
    ``dense_impl`` / ``allow_fallback`` as in
    :func:`repro_torch.core.tocab.tocab_pull`; ``"auto"`` resolves from the
    tuning DB (workload ``spmv``)."""
    schedule, impl = tocab._resolve(bg if bg is not None else dg, schedule,
                                    impl, "spmv")
    allow_fallback = degrade.fallback_allowed(allow_fallback, x.device)
    if allow_fallback and bg is not None and variant in ("gc-pull",
                                                          "gc-push"):
        site = "tocab_pull" if variant == "gc-pull" else "tocab_push"
        impl = degrade.apply_verdict(bg.fingerprint, site, impl)
    epilogue = None if scale is None else (scale, 0.0)
    if variant == "base":
        y = tocab.baseline_pull(dg, x, reduce="sum")
    elif variant == "push":
        y = tocab.baseline_push(dg, x, reduce="sum")
    elif variant == "cb":
        y = tocab.cb_pull(bg, x, reduce="sum")
    elif variant == "gc-pull":
        return tocab.tocab_pull(bg, x, reduce="sum", schedule=schedule,
                                dense_impl=dense_impl, impl=impl,
                                epilogue=epilogue,
                                allow_fallback=allow_fallback)
    elif variant == "gc-push":
        return tocab.tocab_push(bg, x, reduce="sum", schedule=schedule,
                                impl=impl, epilogue=epilogue,
                                allow_fallback=allow_fallback)
    else:
        raise ValueError(f"unknown SpMV variant {variant!r}")
    return y if scale is None else y * scale
