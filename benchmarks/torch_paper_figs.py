#!/usr/bin/env python3
"""The port's paper figures and tables (``benchmarks/paper_figs.py``'s
``ALL``, in its order): the accumulation split (Fig. 5), PageRank per
iteration (Fig. 6), SpMV (Fig. 7), betweenness centrality (Fig. 8),
uniform against sparsity-balanced scheduling (``fig8_balance``), the cache
model's miss rate and DRAM traffic (Figs. 9–10), the block-size sweep
(Fig. 11), Tables 3–4 and the §3.1 blocking ablation, each written as
``BENCH_<fig>.json`` (``repro.obs.bench/v1``; by default under
``experiments/bench/torch/``) through :mod:`repro_torch.obs.export`.

    python3 benchmarks/torch_paper_figs.py --suite card   # on the card
    python3 benchmarks/torch_paper_figs.py --suite cpu --device cpu \\
        --only fig8_bc --graphs rmat14 --out /tmp/bench
    python -m repro_torch.obs.report \\
        experiments/bench/torch/BENCH_fig8_bc.json \\
        [--baseline old/BENCH_fig8_bc.json]

Prints ``name,us_per_call,derived`` CSV rows as ``benchmarks/run.py``
does.  ``--suite cpu`` is the reference's suite
(``benchmarks/common.py``'s ``SUITE``: ``rmat14``–``rmat16`` and a
weighted ``grid256``, at block size 2048) with the reference's record
names (``fig6/pr/<graph>/<variant>``, ``ablation/blocking/<graph>/<engine>``
and so on), so a port file and a reference file diff row by row.  A figure
that the reference runs on named graphs (Fig. 5 on ``rmat14``, Figs. 9–10
on ``rmat14`` and ``rmat16``, Fig. 11 on ``rmat15``, the ablation on
``rmat14`` and ``rmat15``) runs on those of them that ``--graphs`` keeps;
``fig8_balance`` also runs the reference's ``balmix`` graph
(:func:`balance_mix_graph`), whatever ``--graphs`` says.  Those graphs'
values fit in the H100's 50 MB L2, so on the card only ``--suite card``'s
``g500-24`` says anything about TOCAB: the Graph500 scale-24 graph of
``chip_smoke.py`` (``rmat_graph(24, 16, seed=1, weights=True)``, 67 MB of
fp32 per vertex array), laid out at the port's window budget
(``choose_block_size``: the tuner's cache-model replay is too slow to tune
that graph).  ``g500-24`` rows come in Figs. 5–8, ``fig8_balance`` (its
own layout with ``bin_thresholds="auto"``, which makes block 0 dense so
that ``tocab_spmm`` runs), Tables 3–4 and the ablation (its 2D layout at
the window block, 3 × 3 tiles, freed after the rows).  On the card the
figures add rows for the fused kernels (``.../fused``), which the
reference's rows (its default ``impl="slab"``) do not run.

Times are the median of 3 calls after one warm-up, each call ending in a
device synchronisation (Fig. 11: the tuner's trial runner, the same
count).  BC starts at vertex 0 on the reference's graphs, as the reference
does, and on ``g500-24`` at the first Graph500 search key drawn from
``SEED`` (:func:`search_keys`): vertex 0 may have no out-edge there.
fig6's rows carry the cache model's counters (``miss_rate``,
``cache_misses``, ``dram_per_edge``; the reference's ``_cache_counters``)
and Figs. 5, 9 and 10 its predictions, all with the reference's scaled LLC
(``MODEL_CFG``, block ``MODEL_BLOCK``).  No ``g500-24`` row carries a
cache-model field: the replay is a Python loop over every access, ~10 GB
and minutes at 263 M edges (ROADMAP A8·b).
"""
from __future__ import annotations

import argparse
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

#: the CPU suite's TOCAB block (``benchmarks/common.py``'s ``BLOCK_SIZE``)
BLOCK_SIZE = 2048

#: seed of the scale-24 graph and of its search keys (``chip_smoke.py``'s)
SEED = 1

CPU_SUITE = ("rmat14", "rmat15", "rmat16", "grid256")
CARD_SUITE = CPU_SUITE + ("g500-24",)
SUITES = {"cpu": CPU_SUITE, "card": CARD_SUITE}

PR_VARIANTS = ("base", "push", "cb", "gc-pull", "gc-push")
SPMV_VARIANTS = ("base", "cb", "gc-pull", "gc-push")
#: fig8's graphs from each suite (the reference's are rmat14 and rmat15)
BC_GRAPHS = ("rmat14", "rmat15", "g500-24")
#: fig5's graphs (the reference's is its fig6-smoke graph, rmat14)
ACCUM_GRAPHS = ("rmat14", "g500-24")
#: fig8_balance's graphs: the reference's three at its finer block (real
#: spread between bins), and g500-24 at the window block
BALANCE_GRAPHS = ("rmat14", "grid256", "balmix", "g500-24")
BALANCE_BLOCK = 512
#: Figs. 9-10's graphs, and Fig. 11's graph and block sizes (the
#: reference's)
MODEL_GRAPHS = ("rmat14", "rmat16")
SWEEP_GRAPH = "rmat15"
SWEEP_BLOCKS = (256, 1024, 4096, 16384)
#: the ablation's graphs, and propagation blocking's bins (the reference's)
ABLATION_GRAPHS = ("rmat14", "rmat15", "g500-24")
ABLATION_BINS = 16

#: the cache model's block on the reference's suite (its LLC is
#: ``repro_torch.tune.analytic.MODEL_CFG``: 64 KiB, 128 B lines, 16 ways,
#: the |V|·4B / capacity ratio of the paper's LiveJournal on 2.75 MB)
MODEL_BLOCK = 4096
#: the replay stream of each runtime variant (push variants share base's
#: sparse-global-write stream shape; the fused kernels write no partials)
CACHE_VARIANT = {"base": "base", "push": "base", "cb": "cb",
                 "gc-pull": "tocab", "gc-push": "tocab",
                 "gc-pull/fused": "fused", "gc-push/fused": "fused"}


def _graph(name: str):
    from repro_torch.core import rmat_graph
    from repro_torch.tune.suite import SUITE

    if name == "g500-24":
        return rmat_graph(24, 16, seed=SEED, weights=True)
    return SUITE[name]()


def balance_mix_graph(n: int = 16384, deg: int = 24, seed: int = 0):
    """Mixed-density graph for the load-balancing figure (fig8_balance),
    the reference's (``benchmarks/common.py``) from the same numpy stream.

    Destination concentration varies by source range, so TOCAB blocks (source
    ranges in pull) land in genuinely different sparsity bins: the first
    quarter of sources targets 64 hub destinations (dense blocks — high
    edges-per-row after compaction), the next quarter a 1k pool (medium),
    and the rest target uniformly random destinations (sparse)."""
    import numpy as np

    from repro_torch.core import from_edges

    rng = np.random.default_rng(seed)
    q = n // 4
    srcs, dsts = [], []
    for lo, hi, pool in ((0, q, 64), (q, 2 * q, 1024), (2 * q, n, n)):
        src = np.repeat(np.arange(lo, hi), deg)
        dst = rng.integers(0, pool, src.shape[0])
        srcs.append(src)
        dsts.append(dst)
    src = np.concatenate(srcs)
    dst = np.concatenate(dsts)
    keep = src != dst
    vals = rng.random(int(keep.sum()), dtype=np.float32)
    return from_edges(n, src[keep], dst[keep], vals=vals, dedup=True)


def search_keys(out_degree, count: int, seed: int) -> list:
    """``count`` distinct vertices of out-degree ≥ 1 drawn from ``seed``
    (Graph500's BFS search keys: it draws 64)."""
    import torch

    candidates = torch.nonzero(out_degree > 0).flatten().cpu()
    gen = torch.Generator().manual_seed(seed)
    pick = torch.randperm(candidates.numel(), generator=gen)[:count]
    return candidates[pick].tolist()


class Bench:
    """One run's graphs, device and records (``emit`` appends to them)."""

    def __init__(self, device: str, graphs):
        self.device = device
        self.graphs = tuple(graphs)
        self.records: list = []
        self._hosts: dict = {}
        self._cache: dict = {}
        self._replays: dict = {}

    def host_graph(self, name: str):
        """The host :class:`Graph` of ``name``, generated once."""
        if name not in self._hosts:
            self._hosts[name] = _graph(name)
        return self._hosts[name]

    def get_graph(self, name: str):
        """(host graph, DeviceGraph, pull layout, push layout), built once."""
        from repro_torch.core import DeviceGraph, build_blocked
        from repro_torch.obs.metrics import registry

        if name not in self._cache:
            g = self.host_graph(name)
            # the reference's block on its own suite; the port's window
            # budget (half the L2) on the graph that exceeds the L2
            block_size = None if name == "g500-24" else BLOCK_SIZE
            layouts = [build_blocked(g, block_size=block_size, direction=d,
                                     device=self.device)
                       for d in ("pull", "push")]
            registry.gauge("bench.block_size", "TOCAB block size the "
                           "figure sweeps build with").set(
                layouts[0].block_size, graph=name,
                source="default" if block_size else "window_budget")
            self._cache[name] = (g, DeviceGraph.from_host(g, self.device),
                                 *layouts)
        return self._cache[name]

    def replay(self, name: str, variant: str) -> dict:
        """The cache model's replay of one PageRank iteration of
        ``variant`` on graph ``name`` (the reference's scaled LLC, block
        ``MODEL_BLOCK``), run once."""
        from repro_torch.core.cache_model import simulate_pagerank_variant
        from repro_torch.tune.analytic import MODEL_CFG

        key = (name, variant)
        if key not in self._replays:
            self._replays[key] = simulate_pagerank_variant(
                self.host_graph(name), variant, MODEL_CFG,
                block_size=MODEL_BLOCK)
        return self._replays[key]

    def timeit(self, fn, reps: int = 3, warmup: int = 1) -> float:
        """Median wall time (µs) of ``fn()``, each call synchronised."""
        from repro_torch.obs.trace import synchronize

        for _ in range(warmup):
            synchronize(fn())
        ts = []
        for _ in range(reps):
            t0 = time.perf_counter()
            synchronize(fn())
            ts.append(time.perf_counter() - t0)
        ts.sort()
        return ts[len(ts) // 2] * 1e6

    def emit(self, name: str, us: float, **fields):
        """Print the ``name,us_per_call,derived`` CSV row, append the
        record, and mirror its numbers into the metric registry
        (``bench.us_per_call``, ``bench.<field>``), as the reference's
        ``emit`` does."""
        from repro_torch.obs.metrics import registry

        derived = ",".join(
            f"{k}={v:.3g}" if isinstance(v, float) else f"{k}={v}"
            for k, v in fields.items())
        print(f"{name},{us:.1f},{derived}", flush=True)
        self.records.append({"name": name, "us_per_call": us, **fields})
        if us:
            registry.histogram("bench.us_per_call",
                               "benchmark record runtimes").observe(
                us, name=name)
        for k, v in fields.items():
            if isinstance(v, (int, float)) and not isinstance(v, bool):
                registry.gauge(f"bench.{k}", "benchmark derived field").set(
                    v, name=name)

    @property
    def on_card(self) -> bool:
        return self.device == "cuda"


def _pr_runs(b: Bench, variants) -> list:
    """(label, variant, impl) of a PageRank figure: ``variants`` on the
    slab engines, on the card also gc-pull / gc-push on the fused
    kernels."""
    runs = [(v, v, "slab") for v in variants]
    if b.on_card:
        runs += [(f"{v}/fused", v, "fused") for v in ("gc-pull", "gc-push")]
    return runs


def _pr_iter_time(b: Bench, gname: str, variant: str, impl: str) -> float:
    """µs of one PageRank iteration of ``variant`` on ``gname``."""
    import torch

    from repro_torch.core import pagerank_iteration

    g, dg, bg, bgp = b.get_graph(gname)
    bgv = bgp if variant == "gc-push" else bg
    rank = torch.full((g.n,), 1.0 / g.n, dtype=torch.float32,
                      device=dg.device)
    return b.timeit(lambda: pagerank_iteration(
        variant, dg, bgv, rank, dg.out_degree, impl=impl))


def _cache_counters(b: Bench, gname: str, label: str) -> dict:
    """The cache model's counters of one (graph, runtime variant) row (the
    reference's ``_cache_counters``); none on ``g500-24`` (ROADMAP A8·b)."""
    if gname not in CPU_SUITE:
        return {}
    r = b.replay(gname, CACHE_VARIANT[label])
    return dict(miss_rate=r["miss_rate"], cache_misses=r["cache_misses"],
                dram_per_edge=r["dram_per_edge"])


def fig5_accum(b: Bench):
    """Fig. 5 (accumulation): slab vs fused TOCAB accumulation.

    The slab path materialises a ``(num_blocks, local_budget)`` partial
    slab (phase 2) and reduces it back (phase 3); the fused kernels keep
    the accumulator resident and never write partials.  Reports the slab
    phase split, slab-vs-fused edges/s for pull and push, and (on the
    reference's graph) the cache model's DRAM traffic for both."""
    import torch

    from repro_torch.core import tocab

    for gname in (gn for gn in ACCUM_GRAPHS if gn in b.graphs):
        g, dg, bg, bgp = b.get_graph(gname)
        x = torch.ones(g.n, dtype=torch.float32, device=dg.device)
        # slab phase split (pull): phase-2 partials vs the phase-3 reduce
        partials = tocab.tocab_pull_partials(bg, x, "sum", None)
        slab_mb = partials.numel() * partials.element_size() / 2**20
        b.emit(f"fig5_accum/{gname}/pull/slab/phase2",
               b.timeit(lambda: tocab.tocab_pull_partials(bg, x, "sum",
                                                          None)),
               partial_slab_mb=slab_mb, blocks=bg.num_blocks)
        b.emit(f"fig5_accum/{gname}/pull/slab/phase3",
               b.timeit(lambda: tocab.reduce_partials(bg, partials)))
        del partials
        for direction, bgv, fn in (("pull", bg, tocab.tocab_pull),
                                   ("push", bgp, tocab.tocab_push)):
            times = {impl: b.timeit(lambda: fn(bgv, x, impl=impl))
                     for impl in ("slab", "fused")}
            for impl, us in times.items():
                b.emit(f"fig5_accum/{gname}/{direction}/{impl}", us,
                       speedup=times["slab"] / us,
                       edges_per_s=g.m / (us * 1e-6))
        if gname not in CPU_SUITE:
            continue
        model = {v: b.replay(gname, v) for v in ("tocab", "fused")}
        for v, r in model.items():
            b.emit(f"fig5_accum/{gname}/model/{v}", 0.0,
                   dram_per_edge=r["dram_per_edge"],
                   vs_slab=r["dram_per_edge"]
                   / model["tocab"]["dram_per_edge"])


def fig6_pagerank(b: Bench):
    """Fig. 6: PageRank per-iteration speedup over Base, per graph ×
    variant (on the card also gc-pull / gc-push through the fused
    kernels), with the cache model's counters on the reference's
    graphs."""
    for gname in b.graphs:
        g = b.get_graph(gname)[0]
        times = {label: _pr_iter_time(b, gname, v, impl)
                 for label, v, impl in _pr_runs(b, PR_VARIANTS)}
        for label, us in times.items():
            b.emit(f"fig6/pr/{gname}/{label}", us,
                   speedup=times["base"] / us,
                   edges_per_s=g.m / (us * 1e-6),
                   **_cache_counters(b, gname, label))


def fig7_spmv(b: Bench):
    """Fig. 7: SpMV speedup over Base (on the card also the fused gc
    variants)."""
    import torch

    from repro_torch.core import spmv

    for gname in b.graphs:
        g, dg, bg, bgp = b.get_graph(gname)
        x = torch.ones(g.n, dtype=torch.float32, device=dg.device)
        times = {}
        for label, v, impl in _pr_runs(b, SPMV_VARIANTS):
            bgv = bgp if v == "gc-push" else bg
            times[label] = b.timeit(
                lambda: spmv(dg, bgv, x, variant=v, impl=impl))
        for label, us in times.items():
            b.emit(f"fig7/spmv/{gname}/{label}", us,
                   speedup=times["base"] / us,
                   edges_per_s=g.m / (us * 1e-6))


def fig8_bc(b: Bench):
    """Fig. 8: BC (forward + backward) flat vs TOCAB pull (on the card also
    the TOCAB pull through the fused kernel)."""
    from repro_torch.core import INF_DEPTH, bc

    for gname in (gn for gn in BC_GRAPHS if gn in b.graphs):
        g, dg, bg, _ = b.get_graph(gname)
        source = 0 if gname in CPU_SUITE else search_keys(
            dg.out_degree, 1, SEED)[0]
        runs = {"flat": (None, "slab"), "graphcage": (bg, "slab")}
        if b.on_card:
            runs["graphcage/fused"] = (bg, "fused")
        times = {label: b.timeit(lambda: bc(dg, layout, source, impl=impl))
                 for label, (layout, impl) in runs.items()}
        depth = bc(dg, None, source)[1]
        max_depth = int(depth[depth < INF_DEPTH].max())
        for label, us in times.items():
            b.emit(f"fig8/bc/{gname}/{label}", us,
                   speedup=times["flat"] / us, source=source,
                   max_depth=max_depth)


def fig8_balance(b: Bench):
    """Fig. 8 (extended, load balancing): uniform vs sparsity-aware TOCAB
    scheduling, whole-engine and per bin (phase-2 partials of each bin's
    blocks on its matched strategy), with the reference's
    ``tocab.balance.bin_seconds`` / ``bin_edges_per_s`` series.  The
    reference's graphs at block ``BALANCE_BLOCK`` and its default bins;
    ``g500-24`` at the window block with ``bin_thresholds="auto"``, whose
    dense block runs ``tocab_spmm`` on the card.  On the card also the
    fused engines."""
    import torch

    from repro_torch.core import balance as bal
    from repro_torch.core import build_blocked, tocab
    from repro_torch.obs.metrics import registry

    for gname in (gn for gn in BALANCE_GRAPHS
                  if gn in b.graphs or gn == "balmix"):
        if gname == "balmix":
            g, kw = balance_mix_graph(), dict(block_size=BALANCE_BLOCK)
        elif gname in CPU_SUITE:
            g, kw = b.host_graph(gname), dict(block_size=BALANCE_BLOCK)
        else:
            g, kw = b.host_graph(gname), dict(bin_thresholds="auto")
        bgb = build_blocked(g, direction="pull", device=b.device, **kw)
        bgpb = build_blocked(g, direction="push", device=b.device, **kw)
        x = torch.ones(g.n, dtype=torch.float32, device=b.device)
        runs = {
            "pull/uniform": lambda: tocab.tocab_pull(bgb, x),
            "pull/balanced": lambda: tocab.tocab_pull(
                bgb, x, schedule="balanced"),
            "push/uniform": lambda: tocab.tocab_push(bgpb, x),
            "push/balanced": lambda: tocab.tocab_push(
                bgpb, x, schedule="balanced"),
        }
        if b.on_card:
            runs["pull/fused"] = lambda: tocab.tocab_pull(bgb, x,
                                                          impl="fused")
            runs["push/fused"] = lambda: tocab.tocab_push(bgpb, x,
                                                          impl="fused")
        times = {name: b.timeit(fn) for name, fn in runs.items()}
        for name, us in times.items():
            direction = name.split("/")[0]
            b.emit(f"fig8_balance/{gname}/{name}", us,
                   speedup=times[f"{direction}/uniform"] / us,
                   edges_per_s=g.m / (us * 1e-6))
        summary = bgb.schedule.summary()
        for bin_id, bname in enumerate(bal.BIN_NAMES):
            info = summary[bname]
            if not info["blocks"]:
                continue
            us = b.timeit(lambda: bal.bin_pull_partials(bgb, bin_id, x))
            eps = info["edges"] / max(us * 1e-6, 1e-12)
            registry.histogram(
                "tocab.balance.bin_seconds", "per-bin phase-2 wall time"
            ).observe(us * 1e-6, bin=bname, graph=gname)
            registry.gauge(
                "tocab.balance.bin_edges_per_s", "per-bin phase-2 throughput"
            ).set(eps, bin=bname, graph=gname)
            b.emit(f"fig8_balance/{gname}/bin/{bname}", us,
                   blocks=info["blocks"], edges=info["edges"],
                   rows=info["rows"], edges_per_s=eps)
        del bgb, bgpb, runs


def fig9_cache_missrate(b: Bench):
    """Fig. 9: L2 miss rate per variant (the cache model's LRU replay, LLC
    scaled to the |V|·4B / capacity ratio of the paper's LiveJournal /
    2.75 MB)."""
    for gname in (gn for gn in MODEL_GRAPHS if gn in b.graphs):
        for v in ("base", "cb", "tocab"):
            r = b.replay(gname, v)
            b.emit(f"fig9/missrate/{gname}/{v}", 0.0,
                   miss_rate=r["miss_rate"], cache_misses=r["cache_misses"],
                   cache_accesses=r["cache_accesses"])


def fig10_dram_per_edge(b: Bench):
    """Fig. 10: DRAM transactions per edge (GAIL metric), from the same
    replays as Fig. 9."""
    for gname in (gn for gn in MODEL_GRAPHS if gn in b.graphs):
        base = b.replay(gname, "base")
        for v in ("base", "cb", "tocab"):
            r = b.replay(gname, v)
            b.emit(f"fig10/dram_per_edge/{gname}/{v}", 0.0,
                   dram_per_edge=r["dram_per_edge"],
                   dram_transactions=r["dram_transactions"],
                   vs_base=r["dram_per_edge"] / base["dram_per_edge"])


def fig11_blocksize(b: Bench):
    """Fig. 11: block size against time, measured through the tuner's
    trial runner (its warm-up and median-of-3 ``tune.trial`` spans) beside
    the cache model's prediction for each block size; ``chosen=1`` marks
    the block the tuner would pick."""
    from repro_torch.tune import Candidate, run_trial
    from repro_torch.tune.analytic import predicted_cost

    if SWEEP_GRAPH not in b.graphs:
        return
    g = b.host_graph(SWEEP_GRAPH)
    trials = [(bs, run_trial(g, Candidate(engine="tocab", direction="pull",
                                          block_size=bs),
                             workload="pagerank", graph_name=SWEEP_GRAPH,
                             device=b.device))
              for bs in SWEEP_BLOCKS]
    best_us = min(t.us for _, t in trials)
    for bs, t in trials:
        r = predicted_cost(g, t.candidate)
        b.emit(f"fig11/blocksize/{bs}", t.us,
               blocks=r["num_blocks"], miss_rate=r["miss_rate"],
               dram_per_edge=r["dram_per_edge"],
               edges_per_s=t.edges_per_s, chosen=int(t.us == best_us))


def table3_framework_comparison(b: Bench):
    """Table 3: PageRank ms per iteration per graph × {GC-pull, GC-push,
    Base (≈ Gunrock-style flat)}, on the card also the fused GC
    engines."""
    for gname in b.graphs:
        for label, v, impl in _pr_runs(b, ("gc-pull", "gc-push", "base")):
            us = _pr_iter_time(b, gname, v, impl)
            b.emit(f"table3/pr_iter_ms/{gname}/{label}", us, ms=us / 1e3)


def table4_partition_counts(b: Bench):
    """Table 4: GraphCage's cache-sized subgraphs vs CuSha-style
    scratchpad-sized shards (48 KB / 8 B a vertex entry)."""
    cusha_shard_vertices = 48 * 1024 // 8
    for gname in b.graphs:
        g, _, bg, _ = b.get_graph(gname)
        # CuSha's CW format ≈ 2.5× CSR memory (paper §5)
        csr_bytes = 4 * (g.n + 1 + g.m * 2)
        b.emit(f"table4/partitions/{gname}", 0.0,
               graphcage_subgraphs=bg.num_blocks,
               cusha_shards=-(-g.n // cusha_shard_vertices),
               csr_mb=csr_bytes / 2**20,
               cusha_cw_mb=2.5 * csr_bytes / 2**20)


def ablation_blocking(b: Bench):
    """§3.1 design-choice ablation: 1D static TOCAB vs 2D blocking vs
    dynamic propagation blocking (the two alternatives the paper rejects),
    SpMV-shaped pull time and block counts; the 2D layout at the graph's
    TOCAB block, freed after its rows.  On the card also TOCAB through
    the fused kernel: the ablation engines are torch ops like the slab
    engine's, so against them the fused row measures the kernel as well
    as the blocking."""
    import torch

    from repro_torch.core import baseline_pull, tocab_pull
    from repro_torch.core.ablations import (build_blocked_2d,
                                            propagation_blocking_pull,
                                            tocab_pull_2d)

    for gname in (gn for gn in ABLATION_GRAPHS if gn in b.graphs):
        g, dg, bg, _ = b.get_graph(gname)
        x = torch.ones(g.n, dtype=torch.float32, device=dg.device)
        b2 = build_blocked_2d(g, block_size=bg.block_size, device=b.device)
        runs = {
            "base": (lambda: baseline_pull(dg, x), 1),
            "tocab_1d": (lambda: tocab_pull(bg, x), bg.num_blocks),
            "blocked_2d": (lambda: tocab_pull_2d(b2, x), b2.num_tiles),
            "prop_blocking": (lambda: propagation_blocking_pull(
                dg, x, num_bins=ABLATION_BINS), ABLATION_BINS),
        }
        if b.on_card:
            runs["tocab_1d/fused"] = (
                lambda: tocab_pull(bg, x, impl="fused"), bg.num_blocks)
        for name, (fn, blocks) in runs.items():
            b.emit(f"ablation/blocking/{gname}/{name}", b.timeit(fn),
                   blocks=blocks)
        del b2, runs
        if b.on_card:
            torch.cuda.empty_cache()


#: ``benchmarks/paper_figs.py``'s ``ALL``, in its order
FIGURES = (fig5_accum, fig6_pagerank, fig7_spmv, fig8_bc, fig8_balance,
           fig9_cache_missrate, fig10_dram_per_edge, fig11_blocksize,
           table3_framework_comparison, table4_partition_counts,
           ablation_blocking)


def run_one(fn, b: Bench, out_dir: Path) -> dict:
    """Run one figure, write its ``BENCH_<name>.json`` and print how many
    times it launched each kernel (none on the CPU)."""
    from repro_torch.kernels import cuda_build
    from repro_torch.obs import export, trace
    from repro_torch.obs.metrics import registry

    b.records = []
    cuda_build.reset_launches()
    with trace.span(f"bench.{fn.__name__}"):
        fn(b)
    launches = dict(cuda_build.launches)
    payload = export.bench_payload(fn.__name__, b.records,
                                   metrics=registry.snapshot())
    path = out_dir / f"BENCH_{fn.__name__}.json"
    export.write_json(str(path), payload)
    print(f"# wrote {path} ({len(b.records)} records; kernel launches "
          f"{launches})", file=sys.stderr)
    return payload


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--suite", choices=sorted(SUITES), default="card")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="the card unless the CPU is asked for")
    ap.add_argument("--graphs", default=None,
                    help="comma-separated subset of the suite's graphs")
    ap.add_argument("--only", default=None,
                    help="substring filter on figure names")
    ap.add_argument("--out", type=Path,
                    default=ROOT / "experiments" / "bench" / "torch",
                    help="directory for BENCH_<fig>.json")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT / "src"))
    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        print("torch_paper_figs: no CUDA device (pass --device cpu)",
              file=sys.stderr)
        return 3
    graphs = SUITES[args.suite]
    if args.graphs:
        picked = tuple(args.graphs.split(","))
        unknown = sorted(set(picked) - set(graphs))
        if unknown:
            ap.error(f"not in suite {args.suite!r}: {unknown}")
        graphs = tuple(gn for gn in graphs if gn in picked)
    if args.device == "cuda":
        from repro_torch.obs.export import power_limit_w

        print(f"# {torch.cuda.get_device_name(0)}, power limit "
              f"{power_limit_w()} W", file=sys.stderr)
    os.makedirs(args.out, exist_ok=True)
    bench = Bench(args.device, graphs)
    for fn in FIGURES:
        if args.only is None or args.only in fn.__name__:
            run_one(fn, bench, args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
