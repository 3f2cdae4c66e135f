"""The tuner's graph suite: the reference benchmarks' ``SUITE``
(``benchmarks/common.py``) built with the port's generators — the same
graphs, generators and seeds: scale-free R-MAT graphs with permuted ids
(poor locality) and one good-locality control, a weighted 256 × 256 grid.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.graph import Graph, grid_graph, rmat_graph

__all__ = ["SUITE", "SMOKE_GRAPH", "weighted_grid"]


def weighted_grid(side: int) -> Graph:
    """``grid_graph(side, side)`` with uniform weights from seed 0."""
    g = grid_graph(side, side)
    rng = np.random.default_rng(0)
    return Graph(g.n, g.rowptr, g.colidx, rng.random(g.m, dtype=np.float32))


SUITE = {
    "rmat14": lambda: rmat_graph(14, 8, seed=1, weights=True),
    "rmat15": lambda: rmat_graph(15, 8, seed=2, weights=True),
    "rmat16": lambda: rmat_graph(16, 8, seed=3, weights=True),
    "grid256": lambda: weighted_grid(256),
}

#: the graph the smoke budget tunes: the suite's smallest scale-free member
SMOKE_GRAPH = "rmat14"
