"""PageRank in all of the paper's configurations (Fig. 6).

Variants (names follow the paper's evaluation bars):

* ``base``      — flat pull, no optimization (Alg. 1)
* ``push``      — flat push (Alg. 2)
* ``cb``        — conventional cache blocking (blocked, no compaction)
* ``gc-pull``   — GraphCage TOCAB pull (Alg. 4 + reduction phase)
* ``gc-push``   — GraphCage TOCAB push (Alg. 5)

The iteration runs on the device that holds the graph; the loop and its L1
stop test run on the host (one scalar read per iteration).  Traced
(:mod:`repro_torch.obs.trace`), a solve is a ``pagerank.solve`` span and
each iteration a ``pagerank.iteration`` span holding the engine's span and
then ``pagerank.stop_test``, the read of the L1 change alone: its entry
marker falls on the card when the iteration's work is done, so from there
to the next iteration's entry marker the card waits on the host.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.obs.trace import span
from repro_torch.resilience import degrade
from .balance import UNWEIGHTED as _unweighted
from .graph import DeviceGraph
from .partition import BlockedGraph
from . import tocab

__all__ = ["pagerank", "pagerank_iteration", "PR_VARIANTS"]

PR_VARIANTS = ("base", "push", "cb", "gc-pull", "gc-push")


def _gather_sums(variant: str, dg, bg, contributions, schedule="uniform",
                 impl="slab", epilogue=None, allow_fallback=None):
    # PageRank is unweighted: the UNWEIGHTED sentinel combine ignores any
    # edge values the graph carries.
    kw = dict(reduce="sum", combine=_unweighted)
    if variant == "base":
        return tocab.baseline_pull(dg, contributions, **kw)
    if variant == "push":
        return tocab.baseline_push(dg, contributions, **kw)
    if variant == "cb":
        return tocab.cb_pull(bg, contributions, **kw)
    if variant == "gc-pull":
        return tocab.tocab_pull(bg, contributions, schedule=schedule,
                                impl=impl, epilogue=epilogue,
                                allow_fallback=allow_fallback, **kw)
    if variant == "gc-push":
        return tocab.tocab_push(bg, contributions, schedule=schedule,
                                impl=impl, epilogue=epilogue,
                                allow_fallback=allow_fallback, **kw)
    raise ValueError(f"unknown PageRank variant {variant!r}")


def pagerank_iteration(
    variant: str,
    dg: DeviceGraph,
    bg: Optional[BlockedGraph],
    rank: torch.Tensor,
    out_degree: torch.Tensor,
    damping: float = 0.85,
    handle_dangling: bool = True,
    schedule: str = "uniform",
    impl: str = "slab",
    allow_fallback=None,
):
    """One PageRank iteration: contributions → gather/scatter → apply.

    GraphCage variants hand the apply step to the engine as an affine
    epilogue ``sums*damping + add`` — the fused kernels apply it after the
    reduction, the slab impl as a trailing pass.  Dangling mass is known
    before the gather (it only reads ``rank``), which is what lets the apply
    collapse into one affine form; ``add`` stays a tensor on the device, so
    the iteration never waits for the card."""
    n = rank.shape[0]
    has_out = out_degree > 0
    safe_deg = torch.clamp(out_degree, min=1).to(rank.dtype)
    contributions = torch.where(has_out, rank / safe_deg, 0.0)
    dangling = (torch.where(has_out, 0.0, rank).sum() if handle_dangling
                else 0.0)
    if variant in ("gc-pull", "gc-push"):
        add = (1.0 - damping) / n + damping * (dangling / n)
        return _gather_sums(variant, dg, bg, contributions, schedule,
                            impl, epilogue=(damping, add),
                            allow_fallback=allow_fallback)
    sums = _gather_sums(variant, dg, bg, contributions, schedule)
    return (1.0 - damping) / n + damping * (sums + dangling / n)


def pagerank(
    dg: DeviceGraph,
    bg: Optional[BlockedGraph] = None,
    variant: str = "gc-pull",
    damping: float = 0.85,
    tol: float = 1e-6,
    max_iters: int = 200,
    handle_dangling: bool = True,
    schedule: str = "uniform",
    impl: str = "slab",
    allow_fallback=None,
):
    """Iterate PageRank until the L1 delta falls below ``tol`` (or for
    ``max_iters``).

    Returns ``(rank, iterations)``, with ``iterations`` a Python int.  The
    ranks live on ``dg``'s device.  ``schedule`` / ``impl`` /
    ``allow_fallback`` as in :func:`repro_torch.core.tocab.tocab_pull`:
    ``"auto"`` is resolved here, once, from the tuning DB (workload
    ``pagerank``), and with ``allow_fallback=True`` on the CPU the memoized
    verdict of a past fallback on this graph starts the loop at the
    working rung."""
    if variant not in PR_VARIANTS:
        raise ValueError(f"unknown PageRank variant {variant!r}")
    if variant in ("gc-pull", "gc-push", "cb") and bg is None:
        raise ValueError(f"variant {variant!r} needs a BlockedGraph")
    schedule, impl = tocab._resolve(bg if bg is not None else dg, schedule,
                                    impl, "pagerank")
    allow = degrade.fallback_allowed(allow_fallback, dg.device)
    if allow and variant in ("gc-pull", "gc-push"):
        site = "tocab_pull" if variant == "gc-pull" else "tocab_push"
        impl = degrade.apply_verdict(bg.fingerprint, site, impl)
    n, dev = dg.n, dg.device
    with span("pagerank.solve", variant=variant, schedule=schedule,
              impl=impl, n=n, m=dg.m) as solve:
        rank = torch.full((n,), 1.0 / n, dtype=torch.float32, device=dev)
        delta, it = math.inf, 0
        while delta > tol and it < max_iters:
            with span("pagerank.iteration", device=dev, it=it):
                new_rank = pagerank_iteration(
                    variant, dg, bg, rank, dg.out_degree, damping,
                    handle_dangling, schedule, impl, allow)
                l1 = (new_rank - rank).abs().sum()
                with span("pagerank.stop_test", device=dev) as st:
                    delta = st.wait(float, l1)
            rank, it = new_rank, it + 1
        solve.set(iterations=it)
    return rank, it
