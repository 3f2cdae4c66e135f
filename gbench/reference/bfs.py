"""Plain BFS: level-synchronous over the benchmark's own CSR, in torch.

Each level marks every out-neighbour of the frontier; those not yet
reached get the next depth and form the next frontier.  Beside the depths
it states the direction optimisation's decision at each level (Beamer:
pull when the frontier's out-edges exceed ``m / alpha``, counted exactly),
so that the levels and the directions of a traversal can be compared too.
Nothing here comes from the program under test.
"""
from __future__ import annotations

import torch


def bfs(rowptr: torch.Tensor, colidx: torch.Tensor, root: int, *,
        alpha: float, unreached: int, src: torch.Tensor = None,
        tail_cut: float = 0.0) -> tuple:
    """``(depth int32[n], levels, push_levels, pull_levels)``; unreached
    vertices hold ``unreached``.  ``levels`` counts the frontiers expanded,
    the last of which reaches nothing new.

    ``tail_cut > 0`` breaks the traversal's guarantee on purpose: it stops
    once the frontier, past its largest, holds fewer than ``tail_cut``
    times that many vertices (the control of the benchmark's check)."""
    n, m = rowptr.numel() - 1, colidx.numel()
    deg = rowptr[1:] - rowptr[:-1]
    if src is None:
        src = torch.repeat_interleave(
            torch.arange(n, device=rowptr.device), deg, output_size=m)
    depth = torch.full((n,), unreached, dtype=torch.int32,
                       device=rowptr.device)
    depth[root] = 0
    frontier = torch.zeros(n, dtype=torch.bool, device=rowptr.device)
    frontier[root] = True
    levels = push = pull = 0
    largest = 0
    while True:
        size = int(frontier.sum())
        if size == 0:
            break
        largest = max(largest, size)
        if tail_cut and size < tail_cut * largest:
            break
        if int((deg * frontier).sum()) > m / alpha:
            pull += 1
        else:
            push += 1
        reached = torch.zeros(n, dtype=torch.bool, device=rowptr.device)
        reached[colidx[frontier.index_select(0, src)]] = True
        frontier = reached & (depth == unreached)
        levels += 1
        depth[frontier] = levels
    return depth, levels, push, pull
