"""Plan resolution: map a graph (host, device, or blocked) to its tuned
configuration.

This is the read side of the tuning DB, and the only part of
``repro_torch.tune`` the hot engines touch: ``schedule="auto"`` /
``impl="auto"`` on ``pagerank`` / ``spmv`` / ``tocab_pull`` /
``tocab_push`` / the traversals call :func:`resolve_schedule` /
:func:`resolve_impl`, which consult the in-process plan cache, then the
persistent DB, then fall back to the hard-coded defaults.  Resolution reads
only static graph metadata (the build-time fingerprint) and the device the
graph lives on, which keys the entry (:func:`repro_torch.tune.db.
device_key`): a layout on the card reads the card's plans, one on the CPU
the ``cpu`` ones.  It runs once per engine call, before any work is issued.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Optional

from repro_torch.obs.metrics import registry as _obs

from . import db
from .space import WORKLOADS, Candidate

__all__ = ["TunedPlan", "resolve_plan", "resolve_schedule", "resolve_impl",
           "resolve_alpha", "blocked_for", "clear_cache"]

DEFAULT_ALPHA = 15.0

# (fingerprint, device, dtype, workload) -> Optional[TunedPlan]
# Negative results are cached too: an untuned run must not stat() the DB
# file once per engine call.
_PLANS: dict = {}


@dataclasses.dataclass(frozen=True)
class TunedPlan:
    """A resolved DB entry, ready to apply."""

    candidate: Candidate
    workload: str
    graph_fp: str
    source: str  # exact-workload match or borrowed from a sibling workload

    @property
    def schedule(self) -> str:
        return self.candidate.schedule

    @property
    def alpha(self) -> float:
        return self.candidate.alpha

    @property
    def impl(self) -> str:
        return self.candidate.impl


def _fingerprint_of(obj) -> Optional[str]:
    fp = getattr(obj, "fingerprint", None)
    if isinstance(fp, str):
        return fp
    from repro_torch.core.graph import DeviceGraph, Graph, graph_fingerprint

    if isinstance(obj, (Graph, DeviceGraph)):
        return graph_fingerprint(obj)
    return None  # hand-built BlockedGraph without fingerprint: no plan


def resolve_plan(obj, workload: str = "pagerank", dtype: str = "float32",
                 db_dir: Optional[str] = None,
                 device=None) -> Optional[TunedPlan]:
    """Tuned plan for ``obj`` (Graph / DeviceGraph / BlockedGraph) or None.

    Prefers an exact-workload entry; otherwise borrows a sibling workload's
    plan for the same graph (a blocked layout tuned for SpMV is a better
    guess for PageRank than the hard-coded default).  The entry is the one
    of the device ``obj`` lives on (``device`` overrides; a host
    :class:`~repro_torch.core.graph.Graph` reads the card's)."""
    fp = _fingerprint_of(obj)
    if fp is None:
        return None
    if device is None:
        device = getattr(obj, "device", None)
    device = db.device_key(device)
    # keying on (path, mtime) makes the memo self-invalidating: re-tuning
    # rewrites the file, env-var redirects change the path
    path = os.path.abspath(db.db_path(db_dir))
    try:
        mtime = os.stat(path).st_mtime_ns
    except OSError:
        mtime = 0
    memo_key = (fp, device, dtype, workload, path, mtime)
    if memo_key in _PLANS:
        plan = _PLANS[memo_key]
        _obs.counter("tune.plan_lookups", "schedule=auto resolutions").inc(
            result="memory" if plan else "miss", workload=workload)
        return plan
    entries = db.load(path).get("entries", {})
    plan = None
    for wl in (workload, *[w for w in WORKLOADS if w != workload]):
        entry = entries.get(db.entry_key(fp, device, dtype, wl))
        if entry is not None:
            plan = TunedPlan(
                candidate=Candidate.from_json(entry["chosen"]),
                workload=workload, graph_fp=fp,
                source="db" if wl == workload else f"db:{wl}")
            break
    _PLANS[memo_key] = plan
    _obs.counter("tune.plan_lookups", "schedule=auto resolutions").inc(
        result=plan.source if plan else "miss", workload=workload)
    return plan


def resolve_schedule(obj, workload: str = "pagerank",
                     dtype: str = "float32",
                     db_dir: Optional[str] = None) -> str:
    """Concrete ``schedule`` for ``schedule="auto"``: the plan's choice when
    its engine family is blocked, else ``uniform``.  A plan whose winner is
    a *flat* engine pins ``uniform`` — the caller already committed to a
    blocked engine, and the balanced dispatch only pays when tuning said
    so."""
    plan = resolve_plan(obj, workload=workload, dtype=dtype, db_dir=db_dir)
    if plan is None or not plan.candidate.blocked:
        return "uniform"
    return plan.candidate.schedule


def resolve_impl(obj, workload: str = "pagerank", dtype: str = "float32",
                 db_dir: Optional[str] = None) -> str:
    """Concrete ``impl`` for ``impl="auto"``: the plan's slab/fused pick for
    a blocked winner, else ``slab``.  Entries written before the impl axis
    existed deserialize with the ``slab`` default, so old DBs stay valid."""
    plan = resolve_plan(obj, workload=workload, dtype=dtype, db_dir=db_dir)
    if plan is None or not plan.candidate.blocked:
        return "slab"
    return plan.candidate.impl


def resolve_alpha(obj, workload: str = "bfs", dtype: str = "float32",
                  db_dir: Optional[str] = None,
                  default: float = DEFAULT_ALPHA) -> float:
    """Tuned Beamer α for traversal, falling back to the paper's 15."""
    plan = resolve_plan(obj, workload=workload, dtype=dtype, db_dir=db_dir)
    return default if plan is None else plan.alpha


def blocked_for(g, workload: str = "pagerank", dtype: str = "float32",
                db_dir: Optional[str] = None, direction: Optional[str] = None,
                device="cuda"):
    """Build a :class:`~repro_torch.core.partition.BlockedGraph` on
    ``device`` per the tuned plan of that device (block size + bin
    thresholds), defaulting to the stock ``build_blocked`` when untuned —
    the `apply` path for callers that can rebuild their layout."""
    from repro_torch.core.partition import build_blocked

    plan = resolve_plan(g, workload=workload, dtype=dtype, db_dir=db_dir,
                        device=device)
    if plan is None or not plan.candidate.blocked:
        return build_blocked(g, direction=direction or "pull", device=device)
    c = plan.candidate
    return build_blocked(
        g, block_size=c.block_size, direction=direction or c.direction,
        bin_thresholds=c.bin_thresholds, device=device)


def clear_cache():
    """Drop memoized plans (tests, or after re-tuning in-process)."""
    _PLANS.clear()
    db.clear_cache()
