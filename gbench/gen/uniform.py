"""Erdős–Rényi uniform random edges, drawn on the device from a seed.

Both endpoints of each of ``edge_factor * 2**scale`` directed edges are
uniform over the vertices.  Self-loops and duplicates are dropped by the
caller (``drivers/_graph.py``).
"""
from __future__ import annotations

import torch


def edges(cfg: dict, gen: torch.Generator, device) -> tuple:
    """``(n, src, dst)``: int32 endpoints on ``device``."""
    n = 1 << int(cfg["scale"])
    m = int(cfg["edge_factor"]) * n
    src = torch.randint(0, n, (m,), generator=gen, device=device,
                        dtype=torch.int32)
    dst = torch.randint(0, n, (m,), generator=gen, device=device,
                        dtype=torch.int32)
    return n, src, dst
