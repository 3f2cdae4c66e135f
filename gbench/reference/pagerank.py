"""Plain PageRank: a flat pull over the benchmark's own CSR, in torch.

One iteration: each vertex with out-edges hands ``rank / out_degree`` to
its out-neighbours; the mass of vertices without out-edges (dangling) is
spread over all vertices; ``rank' = (1 - d) / n + d * (sums + dangling /
n)``.  The loop starts from ``1 / n`` and stops after the first iteration
whose L1 change is at most ``tol``, or after ``max_iters``.  Nothing here
comes from the program under test.
"""
from __future__ import annotations

import torch


def pagerank(rowptr: torch.Tensor, colidx: torch.Tensor, *, damping: float,
             tol: float, max_iters: int, dtype=torch.float64,
             min_iters: int = 0, keep=()) -> dict:
    """Iterate on the device of ``rowptr`` (int64 CSR) in ``dtype``.

    Runs until the stop test holds and at least ``min_iters`` iterations
    are done (never past ``max_iters``).  Returns ``rank`` (the last),
    ``iters`` (where the stop test first held, else ``max_iters``),
    ``deltas`` (the L1 change of iterations 1, 2, ... as floats) and
    ``kept`` (iteration -> rank, for each iteration in ``keep``)."""
    n = rowptr.numel() - 1
    deg = rowptr[1:] - rowptr[:-1]
    src = torch.repeat_interleave(
        torch.arange(n, device=rowptr.device), deg, output_size=colidx.numel())
    has_out = deg > 0
    inv_deg = torch.where(has_out, 1.0 / deg.clamp(min=1).to(dtype), 0.0)
    rank = torch.full((n,), 1.0 / n, dtype=dtype, device=rowptr.device)
    deltas, kept, stop = [], {}, None
    for it in range(1, max_iters + 1):
        contrib = rank * inv_deg
        dangling = torch.where(has_out, 0.0, rank).sum()
        sums = torch.zeros_like(rank).index_add_(
            0, colidx, contrib.index_select(0, src))
        new = (1.0 - damping) / n + damping * (sums + dangling / n)
        delta = float((new - rank).abs().sum())
        rank = new
        deltas.append(delta)
        if it in keep:
            kept[it] = rank
        if stop is None and delta <= tol:
            stop = it
        if stop is not None and it >= min_iters:
            break
    return {"rank": rank, "iters": stop or max_iters, "deltas": deltas,
            "kept": kept}
