"""Quickstart: GraphCage/TOCAB on a scale-free graph, on the PyTorch port
(``repro_torch``).

Runs PageRank in every paper configuration (Base → GC-push), BFS/BC/SSSP
with direction optimization, and shows the cache-model numbers behind
Figs. 9/10.

    PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]

On the card by default.  The engines are the slab engines (torch ops, the
reference's default ``impl``), so no hand-written kernel launches here;
the cache model replays on the host.  ``main`` returns what it printed,
as numbers.
"""
import argparse
import time

import numpy as np
import torch

from repro_torch.core import (DeviceGraph, bc, bfs, build_blocked, pagerank,
                              rmat_graph, spmv, sssp)
from repro_torch.core.cache_model import (CacheConfig,
                                          simulate_pagerank_variant)
from repro_torch.core.traversal import INF_DEPTH


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    out = {}

    print("=== GraphCage quickstart ===")
    g = rmat_graph(scale=14, edge_factor=8, seed=7, weights=True)
    print(f"graph: |V|={g.n} |E|={g.m} avg_deg={g.average_degree():.1f}")
    print(f"degree dist (paper Table 1): {g.degree_histogram()}")

    dg = DeviceGraph.from_host(g, device=dev)
    t0 = time.time()
    bg = build_blocked(g, block_size=2048, direction="pull", device=dev)
    bgp = build_blocked(g, block_size=2048, direction="push", device=dev)
    print(f"TOCAB preprocessing: {bg.num_blocks} subgraphs "
          f"(edge budget {bg.edge_budget}, local budget {bg.local_budget}) "
          f"in {time.time()-t0:.2f}s")

    # --- PageRank, every paper variant ---
    out["pagerank"] = {}
    for variant in ("base", "push", "cb", "gc-pull", "gc-push"):
        bgv = bgp if variant == "gc-push" else bg
        t0 = time.time()
        rank, iters = pagerank(dg, bgv, variant=variant, tol=1e-8)
        total = float(rank.sum())
        out["pagerank"][variant] = {"rank": rank, "iters": int(iters),
                                    "sum": total}
        print(f"PR {variant:8s}: {int(iters)} iters, Σrank={total:.6f}, "
              f"{time.time()-t0:.2f}s")

    # --- SpMV ---
    x = torch.ones((g.n,), dtype=torch.float32, device=dev)
    y = spmv(dg, bg, x, variant="gc-pull")
    out["spmv_l1"] = float(y.abs().sum())
    print(f"SpMV gc-pull: |y|₁={out['spmv_l1']:.1f}")

    # --- traversal suite ---
    depth, levels, n_push, n_pull = bfs(dg, bg, 0)
    reached = int((depth < INF_DEPTH).sum())
    out["bfs"] = {"depth": depth, "levels": int(levels),
                  "push": int(n_push), "pull": int(n_pull),
                  "reached": reached}
    print(f"BFS: {int(levels)} levels ({int(n_push)} push, {int(n_pull)} "
          f"pull direction-optimized), reached {reached}/{g.n}")
    scores, _, _ = bc(dg, bg, 0)
    out["bc_max"] = float(scores.max())
    print(f"BC from source 0: max score={out['bc_max']:.1f}")
    dist, it = sssp(dg, bg, 0)
    d = dist.cpu().numpy()
    finite = d[np.isfinite(d)]
    out["sssp"] = {"rounds": int(it), "mean": float(finite.mean())}
    print(f"SSSP: {int(it)} rounds, mean dist={finite.mean():.3f}")

    # --- the paper's point: cache behaviour (Figs. 9/10) ---
    cfg = CacheConfig(capacity_bytes=16 * 1024)  # thrash regime
    print("\ncache model (LRU, scaled LLC):")
    out["cache"] = {}
    for v in ("base", "cb", "tocab"):
        r = simulate_pagerank_variant(g, v, cfg, block_size=2048)
        out["cache"][v] = {"miss_rate": r["miss_rate"],
                           "dram_per_edge": r["dram_per_edge"]}
        print(f"  {v:6s}: miss_rate={r['miss_rate']:.3f} "
              f"dram/edge={r['dram_per_edge']:.3f}")
    return out


if __name__ == "__main__":
    main()
