"""Declarative search space over TOCAB execution parameters.

A :class:`Candidate` is one fully-specified engine configuration — the
product of the axes the paper identifies as performance-critical:

* ``engine``      — ``base`` (flat), ``cb`` (blocked, no compaction) or
  ``tocab`` (blocked + compacted), × ``direction`` pull/push;
* ``block_size``  — the Fig. 11 subgraph size (the fast-memory window);
* ``schedule``    — uniform vs sparsity-aware balanced dispatch, and for
  balanced runs the ``dense_impl`` (the ``tocab_spmm`` CUDA kernel,
  ``"cuda"``, or the one-hot strategy's torch ops, ``"onehot"``; ``None``
  is the device's default) and the edges-per-row ``bin_thresholds``;
* ``alpha``       — the Beamer direction-switch constant (traversal only).

:class:`SearchSpace` enumerates only *valid* combinations per workload
(``cb`` has no push or balanced variant, traversal's blocked phase is pull
only, ...), so the analytic pre-pass and trial runner never waste time on
configurations the engines would reject.  The candidates and their keys
are the reference's (``repro.tune.space``), with the reference's dense-bin
name ``"pallas"`` spelled ``"cuda"``; an entry that says ``"pallas"`` reads
as ``None``, the device's default (:meth:`Candidate.from_json`).
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Optional, Tuple, Union

from repro_torch.core.partition import DEFAULT_BIN_THRESHOLDS

__all__ = [
    "Candidate",
    "SearchSpace",
    "TrialBudget",
    "BUDGETS",
    "WORKLOADS",
    "default_candidate",
]

#: workloads the trial runner knows how to time
WORKLOADS = ("pagerank", "spmv", "bfs")

Thresholds = Union[Tuple[float, float], str]


@dataclasses.dataclass(frozen=True)
class Candidate:
    """One point of the search space (hashable, JSON round-trippable)."""

    engine: str = "tocab"  # base | cb | tocab
    direction: str = "pull"  # pull | push
    schedule: str = "uniform"  # uniform | balanced
    dense_impl: Optional[str] = None  # cuda | onehot | None (device's pick)
    impl: str = "slab"  # slab | fused (tocab engines only)
    block_size: int = 2048
    bin_thresholds: Thresholds = DEFAULT_BIN_THRESHOLDS
    alpha: float = 15.0  # Beamer direction-switch constant (traversal)

    @property
    def blocked(self) -> bool:
        return self.engine in ("cb", "tocab")

    def key(self) -> str:
        """Short canonical label (benchmark record / obs series name)."""
        parts = [self.engine]
        if self.blocked:
            parts += [self.direction, f"b{self.block_size}", self.schedule]
            if self.impl != "slab":
                parts.append(self.impl)
            if self.schedule == "balanced":
                parts.append(self.dense_impl or "autoimpl")
                th = self.bin_thresholds
                parts.append(th if isinstance(th, str)
                             else f"t{th[0]:g}-{th[1]:g}")
        if self.alpha != 15.0:
            parts.append(f"a{self.alpha:g}")
        return "/".join(parts)

    def to_json(self) -> dict:
        d = dataclasses.asdict(self)
        if isinstance(d["bin_thresholds"], tuple):
            d["bin_thresholds"] = list(d["bin_thresholds"])
        return d

    @classmethod
    def from_json(cls, d: dict) -> "Candidate":
        """Inverse of :meth:`to_json`; the reference's TPU kernel name
        ``dense_impl="pallas"`` becomes ``None``, the device's default."""
        d = dict(d)
        th = d.get("bin_thresholds")
        if isinstance(th, list):
            d["bin_thresholds"] = tuple(th)
        if d.get("dense_impl") == "pallas":
            d["dense_impl"] = None
        return cls(**{k: v for k, v in d.items()
                      if k in {f.name for f in dataclasses.fields(cls)}})


def default_candidate(block_size: int = 2048) -> Candidate:
    """The configuration the stack hard-codes today — the tuner's baseline
    for the "picked a non-default config" signal."""
    return Candidate(engine="tocab", direction="pull", schedule="uniform",
                     block_size=block_size)


@dataclasses.dataclass(frozen=True)
class TrialBudget:
    """Empirical-measurement budget for one ``tune`` invocation."""

    name: str
    warmup: int
    reps: int
    #: analytic pre-pass keeps (engine, block) groups whose predicted
    #: DRAM-per-edge is within this factor of the best prediction
    prune_ratio: float
    #: hard cap on empirical trials per (graph, workload)
    max_trials: int


BUDGETS = {
    "smoke": TrialBudget("smoke", warmup=1, reps=1, prune_ratio=1.25,
                         max_trials=6),
    "small": TrialBudget("small", warmup=1, reps=3, prune_ratio=2.0,
                         max_trials=24),
    "full": TrialBudget("full", warmup=2, reps=5, prune_ratio=4.0,
                        max_trials=96),
}


@dataclasses.dataclass(frozen=True)
class SearchSpace:
    """Axis lists; :meth:`candidates` takes their valid product."""

    engines: Tuple[str, ...] = ("base", "cb", "tocab")
    directions: Tuple[str, ...] = ("pull", "push")
    schedules: Tuple[str, ...] = ("uniform", "balanced")
    dense_impls: Tuple[Optional[str], ...] = (None,)
    impls: Tuple[str, ...] = ("slab", "fused")
    block_sizes: Tuple[int, ...] = (1024, 2048, 8192)
    bin_thresholds: Tuple[Thresholds, ...] = (DEFAULT_BIN_THRESHOLDS,)
    alphas: Tuple[float, ...] = (15.0,)

    def candidates(self, workload: str = "pagerank") -> list:
        """Valid candidates for ``workload``, deterministic order.

        Traversal (``bfs``) explores α and restricts the blocked phase to
        pull (the sparse phase is always flat push); ``cb`` exists only as
        the paper's pull strawman; ``balanced``/``dense_impl``/thresholds
        only apply to TOCAB engines."""
        if workload not in WORKLOADS:
            raise ValueError(f"unknown workload {workload!r}; "
                             f"expected one of {WORKLOADS}")
        alphas = self.alphas if workload == "bfs" else (15.0,)
        out = []
        for engine, alpha in itertools.product(self.engines, alphas):
            if engine == "base":
                dirs = self.directions if workload != "bfs" else ("pull",)
                for d in dirs:
                    out.append(Candidate(engine="base", direction=d,
                                         alpha=alpha))
                continue
            if engine == "cb" and workload == "bfs":
                continue  # traversal's blocked phase is TOCAB-or-flat
            dirs = ("pull",) if (engine == "cb" or workload == "bfs") \
                else self.directions
            for direction, bs in itertools.product(dirs, self.block_sizes):
                scheds = ("uniform",) if engine == "cb" else self.schedules
                for sched in scheds:
                    if sched != "balanced":
                        # fused is a TOCAB-only uniform-schedule variant
                        impls = self.impls if engine == "tocab" \
                            else ("slab",)
                        for impl in impls:
                            out.append(Candidate(
                                engine=engine, direction=direction,
                                schedule=sched, impl=impl, block_size=bs,
                                alpha=alpha))
                        continue
                    for impl, th in itertools.product(
                            self.dense_impls, self.bin_thresholds):
                        out.append(Candidate(
                            engine=engine, direction=direction,
                            schedule="balanced", dense_impl=impl,
                            block_size=bs, bin_thresholds=th, alpha=alpha))
        # dedup while preserving order (axes may coincide, e.g. base×alpha)
        seen, uniq = set(), []
        for c in out:
            if c not in seen:
                seen.add(c)
                uniq.append(c)
        return uniq

    @classmethod
    def for_budget(cls, budget: str, cfg=None) -> "SearchSpace":
        """Budget presets, seeded from :class:`~repro_torch.configs.
        graphcage.GraphCageCfg` when given (its block/α defaults stay in
        the space so the tuner can *confirm* the hard-coded choice, not
        just replace it)."""
        block = getattr(cfg, "block_size", 8192)
        alpha = getattr(cfg, "bfs_alpha", 15.0)
        blocks = set(getattr(cfg, "tune_block_sizes",
                             (1024, 2048, 4096, 8192, 16384))) | {block}
        alphas = set(getattr(cfg, "tune_alphas", (4.0, 64.0))) | {alpha}
        impls = tuple(getattr(cfg, "tune_impls", ("slab", "fused")))
        if budget == "smoke":
            return cls(engines=("base", "tocab"), directions=("pull",),
                       block_sizes=(2048,), impls=impls, alphas=(alpha,))
        if budget == "small":
            return cls(block_sizes=tuple(sorted({1024, 2048, block})),
                       impls=impls, alphas=tuple(sorted(alphas)))
        if budget == "full":
            return cls(
                block_sizes=tuple(sorted(blocks | {512})),
                dense_impls=(None, "onehot", "cuda"),
                impls=impls,
                bin_thresholds=(DEFAULT_BIN_THRESHOLDS, "auto"),
                alphas=tuple(sorted(alphas | {2.0})))
        raise ValueError(
            f"unknown budget {budget!r}; expected one of {sorted(BUDGETS)}")
