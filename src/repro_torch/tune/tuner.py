"""Tuner orchestration: search space → analytic prune → trials → DB entry.

``tune_graph`` is the unit of work (one graph × one workload); ``tune``
sweeps a suite and returns a summary whose ``new_trials`` count lets CI
(and the acceptance test) assert that a second run is served entirely from
the persistent DB.  Trials run on ``device`` (the card unless the caller
names another), and the entries are keyed by it.
"""
from __future__ import annotations

import sys
from typing import Dict, Optional

import torch

from repro_torch.core.graph import Graph, graph_fingerprint
from repro_torch.obs.metrics import registry as _obs

from . import analytic, db, runner
from .space import BUDGETS, Candidate, SearchSpace, TrialBudget, default_candidate

__all__ = ["tune_graph", "tune", "choose"]


def choose(trials: list) -> Optional[runner.Trial]:
    """Winner = lowest median; deterministic tie-break on the candidate key
    so re-runs of an identical sweep pick the identical config."""
    if not trials:
        return None
    return min(trials, key=lambda t: (t.us, t.candidate.key()))


def _launches_kernel(c: Candidate) -> bool:
    """Whether a candidate's trial launches a hand-written kernel on the
    card: the fused pipeline, or the balanced schedule's dense bin
    (``tocab_spmm``) unless the candidate names the one-hot strategy."""
    return c.blocked and (c.impl == "fused" or (
        c.schedule == "balanced" and c.dense_impl != "onehot"))


def _poisons(err: Exception, c: Candidate, device) -> bool:
    """Whether a failed trial marks its candidate poisoned.  On the CPU
    every failure does, as in the reference.  On the card only an argument
    refusal (``ValueError``, ``NotImplementedError``) of a candidate that
    launches no kernel does; any other failure stops the sweep — a kernel
    that fails to build or launch, a CUDA error (it leaves the context
    broken for every later trial), an injected fault — so that ``"auto"``
    never lands on torch ops because a kernel failed."""
    if torch.device(device).type == "cpu":
        return True
    return (isinstance(err, (ValueError, NotImplementedError))
            and not _launches_kernel(c))


def _record_chosen(entry: dict, graph_name: str):
    """Tuner decision → obs registry (`repro_torch.obs.report` can
    show trials run / pruned counts / the chosen config as a labeled
    gauge)."""
    c = entry["chosen"]
    _obs.gauge(
        "tune.chosen", "chosen tuner config (value = median µs)",
    ).set(entry["best_us"], graph=graph_name, workload=entry["workload"],
          engine=c["engine"], direction=c["direction"],
          schedule=c["schedule"], impl=c.get("impl", "slab"),
          block_size=c["block_size"])
    _obs.gauge("tune.chosen_block_size", "tuned TOCAB block size").set(
        c["block_size"], graph=graph_name, workload=entry["workload"])
    _obs.gauge("tune.non_default", "1 when tuning beat the hard-coded "
               "default config").set(
        float(entry["non_default"]), graph=graph_name,
        workload=entry["workload"])


def tune_graph(
    g: Graph,
    graph_name: str,
    workload: str = "pagerank",
    space: Optional[SearchSpace] = None,
    budget: TrialBudget = BUDGETS["small"],
    db_dir: Optional[str] = None,
    dtype: str = "float32",
    force: bool = False,
    default: Optional[Candidate] = None,
    verbose: bool = False,
    trial_timeout: Optional[float] = None,
    device="cuda",
) -> dict:
    """Tune one (graph, workload) on ``device``; returns the DB entry
    (existing one on a DB hit).  The entry records every trial, the analytic prune, and the
    chosen candidate.

    A candidate that fails (:func:`_poisons`: on the card only an unusable
    argument combination) or exceeds ``trial_timeout`` seconds (CPU trials
    only) is marked *poisoned* in the DB — later sweeps (force or not)
    skip it upfront instead of re-running a known failure.  Any other
    failure on the card propagates and ends the sweep."""
    runner.check_timeout(trial_timeout, device)
    path = db.db_path(db_dir)
    fp = graph_fingerprint(g)
    device_kind = db.device_key(device)
    key = db.entry_key(fp, device_kind, dtype=dtype, workload=workload)
    if not force:
        hit = db.get_entry(key, path)
        if hit is not None:
            _obs.counter("tune.db_hits", "tune requests served from the "
                         "persistent DB").inc(workload=workload)
            return dict(hit, db_hit=True)

    space = space or SearchSpace()
    cands = space.candidates(workload)
    kept, pruned = analytic.prune(
        g, cands, prune_ratio=budget.prune_ratio,
        graph_name=graph_name, workload=workload)
    kept = kept[: budget.max_trials]
    poisoned = db.poisoned_for(key, path)
    poisoned_skipped = [c.key() for c in kept if c.key() in poisoned]
    if poisoned_skipped:
        kept = [c for c in kept if c.key() not in poisoned]
        _obs.counter(
            "tune.poisoned_skipped",
            "poisoned candidates skipped before trials",
        ).inc(len(poisoned_skipped), workload=workload)
    trials, skipped = [], []
    for c in kept:
        try:
            trials.append(runner.run_trial(
                g, c, workload=workload, budget=budget,
                graph_name=graph_name, dtype=dtype,
                timeout=trial_timeout, device=device))
            if verbose:
                print(f"#   trial {graph_name}/{workload} {c.key()}: "
                      f"{trials[-1].us:.0f}us", file=sys.stderr)
        except Exception as e:  # unusable combo, crash, or timeout
            if not _poisons(e, c, device):
                raise
            skipped.append({"candidate": c.to_json(), "error": repr(e)})
            _obs.counter("tune.trials_skipped",
                         "candidates that failed to run").inc(
                workload=workload)
            db.mark_poisoned(key, c.key(), repr(e), path)
    best = choose(trials)
    if best is None:
        raise RuntimeError(
            f"no runnable candidate for {graph_name}/{workload} "
            f"({len(pruned)} pruned, {len(skipped)} failed)")
    default = default or default_candidate()
    entry = {
        "schema": db.DB_SCHEMA,
        "graph": graph_name,
        "graph_fp": fp,
        "device_kind": device_kind,
        "dtype": dtype,
        "workload": workload,
        "budget": budget.name,
        "chosen": best.candidate.to_json(),
        "best_us": best.us,
        "non_default": best.candidate != default,
        "candidates": len(cands),
        "pruned_analytic": len(pruned),
        "trials": [t.to_json() for t in trials],
        "skipped": skipped,
        "poisoned_skipped": poisoned_skipped,
    }
    db.put_entry(key, entry, path)
    _record_chosen(entry, graph_name)
    return dict(entry, db_hit=False)


def tune(
    graphs: Dict[str, Graph],
    workloads=("pagerank", "spmv"),
    budget: str = "small",
    space: Optional[SearchSpace] = None,
    db_dir: Optional[str] = None,
    cfg=None,
    force: bool = False,
    verbose: bool = False,
    dtype: str = "float32",
    trial_timeout: Optional[float] = None,
    device="cuda",
) -> dict:
    """Sweep a graph suite on ``device``; returns a summary dict:

    ``{"entries": [...], "new_trials": N, "pruned": N, "db_hits": N}``.
    ``dtype`` keys the DB entries *and* the value arrays the trials time."""
    tb = BUDGETS[budget] if isinstance(budget, str) else budget
    space = space or SearchSpace.for_budget(tb.name, cfg)
    default = default_candidate(getattr(cfg, "block_size", 2048))
    entries, new_trials, pruned, db_hits = [], 0, 0, 0
    for gname, g in graphs.items():
        for wl in workloads:
            entry = tune_graph(
                g, gname, workload=wl, space=space, budget=tb,
                db_dir=db_dir, force=force, default=default,
                verbose=verbose, dtype=dtype, trial_timeout=trial_timeout,
                device=device)
            entries.append(entry)
            if entry.get("db_hit"):
                db_hits += 1
            else:
                new_trials += len(entry["trials"])
                pruned += entry["pruned_analytic"]
    return {"entries": entries, "new_trials": new_trials,
            "pruned": pruned, "db_hits": db_hits,
            "db_path": db.db_path(db_dir)}
