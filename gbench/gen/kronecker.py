"""Graph500 Kronecker (R-MAT) edges, drawn on the device from a seed.

Each of the ``scale`` levels draws one uniform number an edge and picks
one of the four quadrants with probabilities ``a, b, c, 1 - a - b - c``:
``b`` sets the destination's bit of that level, ``c`` the source's, the
last quadrant both.  Vertex ids are then relabelled by a random
permutation, as the Graph500 generator does, so that the skew carries no
locality.  Self-loops and duplicates are dropped by the caller
(``drivers/_graph.py``).
"""
from __future__ import annotations

import torch


def edges(cfg: dict, gen: torch.Generator, device) -> tuple:
    """``(n, src, dst)``: int32 endpoints of ``edge_factor * 2**scale``
    directed edges on ``device``."""
    scale, a, b, c = int(cfg["scale"]), cfg["a"], cfg["b"], cfg["c"]
    n = 1 << scale
    m = int(cfg["edge_factor"]) * n
    src = torch.zeros(m, dtype=torch.int32, device=device)
    dst = torch.zeros(m, dtype=torch.int32, device=device)
    r = torch.empty(m, dtype=torch.float32, device=device)
    for level in range(scale):
        r.uniform_(generator=gen)
        src_bit = r >= a + b
        dst_bit = ((r >= a) & (r < a + b)) | (r >= a + b + c)
        src.add_(src_bit.to(torch.int32), alpha=1 << level)
        dst.add_(dst_bit.to(torch.int32), alpha=1 << level)
    del r
    perm = torch.randperm(n, generator=gen, device=device, dtype=torch.int32)
    return n, perm.index_select(0, src), perm.index_select(0, dst)
