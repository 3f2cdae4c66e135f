"""Each plain reference against the port's slab path at a small scale."""
import json

import pytest
import torch

from gbench_testlib import GBENCH, load
from repro_torch.core.graph import DeviceGraph, Graph
from repro_torch.core.pagerank import pagerank
from repro_torch.core.partition import build_blocked
from repro_torch.core.traversal import INF_DEPTH, bfs

GRAPH = load("drivers/_graph.py")
PR = load("reference/pagerank.py")
BFS = load("reference/bfs.py")


def graph(name: str, seed: int, scale: int = 11):
    cfg = json.loads((GBENCH / "configs" / f"{name}.json").read_text())
    cfg["scale"] = scale
    gen = torch.Generator().manual_seed(seed)
    rowptr, colidx = GRAPH.csr(
        *load(f"gen/{cfg['generator']}.py").edges(cfg, gen, "cpu"))
    g = Graph(n=rowptr.numel() - 1, rowptr=rowptr.numpy(),
              colidx=colidx.numpy())
    # a small block, so that the layout has several blocks
    bg = build_blocked(g, block_size=512, direction="pull", device="cpu")
    return rowptr, colidx.long(), DeviceGraph.from_host(g, device="cpu"), bg


@pytest.mark.parametrize("name", ["kron24", "urand24"])
def test_pagerank_reference_matches_slab(name):
    rowptr, colidx, dg, bg = graph(name, 4)
    rank, iters = pagerank(dg, bg, variant="gc-pull", impl="slab",
                           tol=1e-4, max_iters=20)
    out = PR.pagerank(rowptr, colidx, damping=0.85, tol=1e-4, max_iters=20,
                      keep={iters})
    assert out["iters"] == iters
    l1 = float((rank.double() - out["kept"][iters]).abs().sum())
    assert l1 < 1e-6


@pytest.mark.parametrize("name", ["kron24", "urand24"])
def test_bfs_reference_matches_slab(name):
    rowptr, colidx, dg, bg = graph(name, 6)
    deg = rowptr[1:] - rowptr[:-1]
    roots = torch.nonzero(deg > 0).squeeze(1)[:5].tolist()
    for root in roots:
        got = bfs(dg, bg, root, impl="slab", alpha=15.0)
        ref = BFS.bfs(rowptr, colidx, root, alpha=15.0, unreached=INF_DEPTH)
        assert torch.equal(got[0], ref[0])
        assert tuple(got[1:]) == tuple(ref[1:])
