"""Analytic pre-pass: prune the search space with the cache model before
any timing.

The paper's whole argument is that DRAM transactions per edge (Fig. 10)
predict wall clock; ``repro_torch.core.cache_model`` replays the exact
access stream of each engine family (a Python loop over every access:
seconds a graph at the reference's suite, minutes and gigabytes of host
memory at Graph500 scale 24).  Candidates only differ in their *stream* by
(engine, block_size) — schedule/dense-impl/α reshuffle the same accesses —
so we score each (engine, block_size) group once, keep groups whose
predicted DRAM-per-edge is within ``prune_ratio`` of the best, and hand
only the survivors to the empirical trial runner.
"""
from __future__ import annotations

from typing import Iterable, Optional, Tuple

from repro_torch.core.cache_model import CacheConfig, simulate_pagerank_variant
from repro_torch.core.graph import Graph, graph_fingerprint
from repro_torch.obs.metrics import registry as _obs

from .space import Candidate

__all__ = ["MODEL_CFG", "predicted_cost", "prune", "clear_cache"]

#: scaled LLC for the CPU-scale suite — same |V|·4B / capacity ratio the
#: fig9/fig10 benchmarks use for the paper's LiveJournal / 2.75 MB pairing
MODEL_CFG = CacheConfig(capacity_bytes=64 * 1024, line_bytes=128, ways=16)

# cache-model variant per engine family (push shares base's stream shape;
# tocab-push shares tocab's blocked one)
_MODEL_VARIANT = {"base": "base", "cb": "cb", "tocab": "tocab"}


def _variant_of(candidate: Candidate) -> str:
    """tocab × impl='fused' replays the no-partial-slab stream; everything
    else keys on engine alone."""
    if candidate.engine == "tocab" and candidate.impl == "fused":
        return "fused"
    return _MODEL_VARIANT[candidate.engine]


def _group_of(candidate: Candidate) -> tuple:
    """Stream-equivalence group: schedule/dense-impl/α don't change the
    access stream, but the fused impl does."""
    if not candidate.blocked:
        return (candidate.engine, "slab", 0)
    impl = candidate.impl if candidate.engine == "tocab" else "slab"
    return (candidate.engine, impl, candidate.block_size)

# (graph_fp, variant, block_size, cfg) -> replay result dict.  The LRU
# replay is a host-side Python loop over every edge — worth memoizing hard.
_MEMO: dict = {}


def predicted_cost(g: Graph, candidate: Candidate,
                   cfg: CacheConfig = MODEL_CFG) -> dict:
    """Cache-model replay for ``candidate``'s stream group (memoized)."""
    variant = _variant_of(candidate)
    block = candidate.block_size if candidate.blocked else 0
    key = (graph_fingerprint(g), variant, block, cfg)
    if key not in _MEMO:
        _MEMO[key] = simulate_pagerank_variant(
            g, variant, cfg, block_size=block or None)
        _obs.counter("tune.analytic_replays",
                     "cache-model replays run by the tuner").inc(
            variant=variant)
    return _MEMO[key]


def prune(g: Graph, candidates: Iterable[Candidate],
          prune_ratio: float = 2.0,
          cfg: CacheConfig = MODEL_CFG,
          graph_name: Optional[str] = None,
          workload: str = "pagerank") -> Tuple[list, list]:
    """Split candidates into (kept, pruned) by predicted DRAM-per-edge.

    Returns candidates in their original order; every candidate gains no
    state — the caller reads per-group scores from the obs registry
    (``tune.analytic_dram_per_edge``) or via :func:`predicted_cost`."""
    candidates = list(candidates)
    if not candidates:
        return [], []
    scores = {}
    for c in candidates:
        group = _group_of(c)
        if group not in scores:
            scores[group] = predicted_cost(g, c, cfg)["dram_per_edge"]
    best = min(scores.values())
    cut = best * max(prune_ratio, 1.0)
    kept, pruned = [], []
    for c in candidates:
        (kept if scores[_group_of(c)] <= cut else pruned).append(c)
    labels = dict(workload=workload)
    if graph_name:
        labels["graph"] = graph_name
    for (engine, impl, block), s in sorted(scores.items()):
        _obs.gauge(
            "tune.analytic_dram_per_edge",
            "cache-model prediction per candidate stream group",
        ).set(s, engine=engine, impl=impl, block_size=block, **labels)
    _obs.counter("tune.candidates_pruned",
                 "candidates dropped by the analytic pre-pass").inc(
        len(pruned), **labels)
    _obs.counter("tune.candidates_kept",
                 "candidates surviving the analytic pre-pass").inc(
        len(kept), **labels)
    return kept, pruned


def clear_cache():
    _MEMO.clear()
