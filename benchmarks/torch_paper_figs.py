#!/usr/bin/env python3
"""The port's paper figures 6–8: PageRank per iteration (Fig. 6), SpMV
(Fig. 7) and betweenness centrality (Fig. 8), flat against TOCAB, each
written as ``BENCH_<fig>.json`` (``repro.obs.bench/v1``; by default under
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
names (``fig6/pr/<graph>/<variant>``, ``fig7/spmv/<graph>/<variant>``,
``fig8/bc/<graph>/flat|graphcage``), so a port file and a reference file
diff row by row.  Those graphs' values fit in the H100's 50 MB L2, so on
the card only ``--suite card``'s ``g500-24`` says anything about TOCAB: the
Graph500 scale-24 graph of ``chip_smoke.py`` (``rmat_graph(24, 16,
seed=1, weights=True)``, 67 MB of fp32 per vertex array), laid out at the
port's window budget (``choose_block_size``: the tuner's cache-model
replay is too slow to tune that graph).  On the card each figure adds rows for the fused kernels
(``.../fused``), which the reference's rows (its default ``impl="slab"``)
do not run.

Times are the median of 3 calls after one warm-up, each call ending in a
device synchronisation.  BC starts at vertex 0 on the reference's graphs,
as the reference does, and on ``g500-24`` at the first Graph500 search key
drawn from ``SEED`` (:func:`search_keys`): vertex 0 may have no out-edge
there.  fig6 rows carry no cache-model counters (``miss_rate``,
``cache_misses``, ``dram_per_edge``) until ROADMAP A9 ports
``core/cache_model.py``.
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


def _graph(name: str):
    from repro_torch.core import rmat_graph
    from repro_torch.tune.suite import SUITE

    if name == "g500-24":
        return rmat_graph(24, 16, seed=SEED, weights=True)
    return SUITE[name]()


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
        self._cache: dict = {}

    def get_graph(self, name: str):
        """(host graph, DeviceGraph, pull layout, push layout), built once."""
        from repro_torch.core import DeviceGraph, build_blocked
        from repro_torch.obs.metrics import registry

        if name not in self._cache:
            g = _graph(name)
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


def fig6_pagerank(b: Bench):
    """Fig. 6: PageRank per-iteration speedup over Base, per graph ×
    variant (on the card also gc-pull / gc-push through the fused
    kernels)."""
    import torch

    from repro_torch.core import pagerank_iteration

    for gname in b.graphs:
        g, dg, bg, bgp = b.get_graph(gname)
        rank = torch.full((g.n,), 1.0 / g.n, dtype=torch.float32,
                          device=dg.device)
        runs = [(v, v, "slab") for v in PR_VARIANTS]
        if b.on_card:
            runs += [(f"{v}/fused", v, "fused") for v in ("gc-pull",
                                                          "gc-push")]
        times = {}
        for label, v, impl in runs:
            bgv = bgp if v == "gc-push" else bg
            times[label] = b.timeit(lambda: pagerank_iteration(
                v, dg, bgv, rank, dg.out_degree, impl=impl))
        for label, us in times.items():
            b.emit(f"fig6/pr/{gname}/{label}", us,
                   speedup=times["base"] / us,
                   edges_per_s=g.m / (us * 1e-6))


def fig7_spmv(b: Bench):
    """Fig. 7: SpMV speedup over Base (on the card also the fused gc
    variants)."""
    import torch

    from repro_torch.core import spmv

    for gname in b.graphs:
        g, dg, bg, bgp = b.get_graph(gname)
        x = torch.ones(g.n, dtype=torch.float32, device=dg.device)
        runs = [(v, v, "slab") for v in SPMV_VARIANTS]
        if b.on_card:
            runs += [(f"{v}/fused", v, "fused") for v in ("gc-pull",
                                                          "gc-push")]
        times = {}
        for label, v, impl in runs:
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


FIGURES = (fig6_pagerank, fig7_spmv, fig8_bc)


def run_one(fn, b: Bench, out_dir: Path) -> dict:
    """Run one figure and write its ``BENCH_<name>.json``."""
    from repro_torch.obs import export, trace
    from repro_torch.obs.metrics import registry

    b.records = []
    with trace.span(f"bench.{fn.__name__}"):
        fn(b)
    payload = export.bench_payload(fn.__name__, b.records,
                                   metrics=registry.snapshot())
    path = out_dir / f"BENCH_{fn.__name__}.json"
    export.write_json(str(path), payload)
    print(f"# wrote {path} ({len(b.records)} records)", file=sys.stderr)
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
