"""Empirical trial runner: time surviving candidates, record everything,
pick the winner.

All timing flows through ``repro_torch.obs`` spans (``tune.trial`` spans
whose ``Span.block`` waits for the card), so trials land in the same
registry and trace stream as every other hot path.  The engines run
eagerly: no ``torch.compile``, the same calls a user makes.  Graphs and
blocked layouts are built once per (graph, device[, direction, block
size, thresholds]) on the trial's ``device`` — the card unless the caller
names another — and shared across candidates.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from repro_torch.core import traversal as _traversal
from repro_torch.core.graph import DeviceGraph, Graph, graph_fingerprint
from repro_torch.core.pagerank import pagerank_iteration
from repro_torch.core.partition import build_blocked
from repro_torch.core.spmv import spmv as _spmv_fn
from repro_torch.obs import trace as obs_trace
from repro_torch.obs.metrics import registry as _obs
from repro_torch.resilience import chaos as _chaos
from repro_torch.resilience.retry import call_with_timeout

from .space import Candidate, TrialBudget

__all__ = ["Trial", "run_trial", "time_fn", "build_for", "clear_cache"]

# (graph_fp, device, direction, block_size, thresholds) -> BlockedGraph
_BG_MEMO: dict = {}
# (graph_fp, device) -> DeviceGraph
_DG_MEMO: dict = {}


@dataclasses.dataclass(frozen=True)
class Trial:
    """One timed candidate (JSON round-trippable via ``to_json``)."""

    candidate: Candidate
    us: float  # median wall-clock per call, microseconds
    reps: int
    warmup: int
    workload: str
    edges_per_s: float

    def to_json(self) -> dict:
        d = dataclasses.asdict(self)
        d["candidate"] = self.candidate.to_json()
        return d

    @classmethod
    def from_json(cls, d: dict) -> "Trial":
        d = dict(d)
        d["candidate"] = Candidate.from_json(d["candidate"])
        return cls(**{k: v for k, v in d.items()
                      if k in {f.name for f in dataclasses.fields(cls)}})


def clear_cache():
    _BG_MEMO.clear()
    _DG_MEMO.clear()


def build_for(g: Graph, candidate: Candidate, device="cuda"):
    """(DeviceGraph, BlockedGraph-or-None) for one candidate on
    ``device``, memoized."""
    fp = graph_fingerprint(g)
    dev = str(torch.device(device))
    dg = _DG_MEMO.get((fp, dev))
    if dg is None:
        dg = _DG_MEMO[(fp, dev)] = DeviceGraph.from_host(g, device=device)
    if not candidate.blocked:
        return dg, None
    key = (fp, dev, candidate.direction, candidate.block_size,
           candidate.bin_thresholds)
    bg = _BG_MEMO.get(key)
    if bg is None:
        bg = _BG_MEMO[key] = build_blocked(
            g, block_size=candidate.block_size,
            direction=candidate.direction,
            bin_thresholds=candidate.bin_thresholds, device=device)
    return dg, bg


def _pr_variant(candidate: Candidate) -> str:
    if candidate.engine == "base":
        return "base" if candidate.direction == "pull" else "push"
    if candidate.engine == "cb":
        return "cb"
    return "gc-pull" if candidate.direction == "pull" else "gc-push"


def _workload_fn(workload: str, g: Graph, dg, bg, candidate: Candidate,
                 dtype: str = "float32"):
    """Callable + args for one (workload, candidate, dtype) pairing.

    ``dtype`` is the value dtype the trial times (the DB entry's key
    dtype).  The engines run with the candidate's concrete schedule and
    impl, and never with the degradation ladder: a trial times the engine
    it names or fails."""
    vdtype = getattr(torch, dtype)
    if workload == "pagerank":
        rank = torch.full((g.n,), 1.0 / g.n, dtype=vdtype, device=dg.device)
        variant = _pr_variant(candidate)
        return (lambda r: pagerank_iteration(
            variant, dg, bg, r, dg.out_degree,
            schedule=candidate.schedule, impl=candidate.impl)), (rank,)
    if workload == "spmv":
        x = torch.ones((g.n,), dtype=vdtype, device=dg.device)
        variant = _pr_variant(candidate)
        return (lambda xx: _spmv_fn(
            dg, bg, xx, variant=variant, schedule=candidate.schedule,
            dense_impl=candidate.dense_impl, impl=candidate.impl)), (x,)
    if workload == "bfs":
        return (lambda s: _traversal.bfs(
            dg, bg, s, alpha=candidate.alpha, schedule=candidate.schedule,
            impl=candidate.impl)), (0,)
    raise ValueError(f"unknown workload {workload!r}")


def time_fn(fn, args: Tuple, warmup: int, reps: int, **span_attrs) -> float:
    """Median wall-clock (µs) over ``reps`` measured calls, each one a
    ``tune.trial`` obs span that waits for the card inside it."""
    for _ in range(max(warmup, 0)):
        obs_trace.synchronize(fn(*args))
    durs = []
    for rep in range(max(reps, 1)):
        with obs_trace.span("tune.trial", rep=rep, **span_attrs) as sp:
            sp.block(fn(*args))
        durs.append(sp.dur_s)
    durs.sort()
    return durs[len(durs) // 2] * 1e6


def check_timeout(timeout: Optional[float], device):
    """Refuse a trial timeout anywhere but on the CPU: a timed-out trial's
    thread is abandoned, not stopped, and on the card it would go on
    launching kernels into the next trial's timed region."""
    if timeout and torch.device(device).type != "cpu":
        raise ValueError(
            f"a trial timeout bounds CPU trials only, not trials on "
            f"{device!r}")


def run_trial(g: Graph, candidate: Candidate, workload: str = "pagerank",
              budget: Optional[TrialBudget] = None,
              graph_name: Optional[str] = None,
              warmup: int = 1, reps: int = 3,
              dtype: str = "float32",
              timeout: Optional[float] = None,
              device="cuda") -> Trial:
    """Build, time, and record one candidate on ``device``.

    Engines with unusable combinations surface as exceptions — the sweep
    in :mod:`repro_torch.tune.tuner` decides which of them poison the
    candidate.  ``timeout`` (seconds, CPU trials only:
    :func:`check_timeout`) bounds the whole build + measurement of this
    candidate.  ``tune.trial`` is an opt-in chaos site."""
    check_timeout(timeout, device)
    _chaos.maybe_raise("tune.trial")
    if budget is not None:
        warmup, reps = budget.warmup, budget.reps

    def _measure():
        dg, bg = build_for(g, candidate, device)
        fn, args = _workload_fn(workload, g, dg, bg, candidate, dtype)
        return time_fn(fn, args, warmup, reps,
                       workload=workload, candidate=candidate.key(),
                       graph=graph_name or graph_fingerprint(g))

    us = call_with_timeout(_measure, timeout)
    eps = g.m / max(us * 1e-6, 1e-12)
    labels = dict(workload=workload, candidate=candidate.key())
    if graph_name:
        labels["graph"] = graph_name
    _obs.counter("tune.trials", "empirical tuner trials run").inc(
        workload=workload, **({"graph": graph_name} if graph_name else {}))
    _obs.histogram("tune.trial_us", "tuner trial medians").observe(
        us, **labels)
    _obs.gauge("tune.trial_edges_per_s", "tuner trial throughput").set(
        eps, **labels)
    return Trial(candidate=candidate, us=us, reps=reps, warmup=warmup,
                 workload=workload, edges_per_s=eps)
