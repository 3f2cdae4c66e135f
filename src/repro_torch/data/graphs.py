"""Synthetic graph datasets for the GNN shape regimes (the reference's
``data/graphs.py``).

The numbers come from the same numpy ``Generator`` calls in the same order
(and the port's graph generators equal the reference's), so a batch equals
the reference's element for element; its tensors go on ``device`` (the
card by default).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.graph import Graph, rmat_graph, uniform_random_graph
from repro_torch.models.gnn import GraphBatch, build_triplets

__all__ = ["cora_like", "reddit_like", "products_like", "molecule_batch",
           "graph_to_batch"]


def _device(device):
    return torch.device("cuda") if device is None else torch.device(device)


def _t(a: np.ndarray, device, dtype=None) -> torch.Tensor:
    t = torch.from_numpy(np.ascontiguousarray(a))
    return t.to(device=device, dtype=dtype or t.dtype)


def graph_to_batch(g: Graph, d_feat: int, n_classes: int, seed: int = 0,
                   with_positions: bool = False, triplet_cap: int = 8,
                   device=None) -> GraphBatch:
    device = _device(device)
    rng = np.random.default_rng(seed)
    src, dst = g.edges()
    feat = rng.standard_normal((g.n, d_feat), dtype=np.float32) * 0.5
    labels = rng.integers(0, n_classes, g.n).astype(np.int32)
    # plant signal: label-dependent feature shift so GNNs can learn
    feat[np.arange(g.n), labels % d_feat] += 2.0
    kwargs = {}
    if with_positions:
        pos = rng.standard_normal((g.n, 3)).astype(np.float32) * 2.0
        kj, ji, tmask = build_triplets(src, dst, g.n, cap_per_edge=triplet_cap)
        kwargs = dict(positions=_t(pos, device), t_kj=_t(kj, device),
                      t_ji=_t(ji, device), t_mask=_t(tmask, device))
    return GraphBatch(
        node_feat=_t(feat, device),
        edge_src=_t(src, device, torch.int32),
        edge_dst=_t(dst, device, torch.int32),
        edge_mask=torch.ones(g.m, dtype=torch.bool, device=device),
        labels=_t(labels, device),
        node_mask=torch.ones(g.n, dtype=torch.bool, device=device),
        **kwargs,
    )


def cora_like(n=2708, m=10556, d_feat=1433, n_classes=7, seed=0,
              device=None):
    g = uniform_random_graph(n, m + m // 4, seed=seed)
    return g, graph_to_batch(g, d_feat, n_classes, seed, device=device)


def reddit_like(scale=14, edge_factor=16, d_feat=602, n_classes=41, seed=0,
                device=None):
    g = rmat_graph(scale, edge_factor, seed=seed)
    return g, graph_to_batch(g, d_feat, n_classes, seed, device=device)


def products_like(scale=15, edge_factor=12, d_feat=100, n_classes=47, seed=0,
                  device=None):
    g = rmat_graph(scale, edge_factor, seed=seed)
    return g, graph_to_batch(g, d_feat, n_classes, seed, device=device)


def molecule_batch(n_graphs=128, nodes_per=30, d_feat=16, seed=0,
                   cutoff=2.0, triplet_cap=8, device=None):
    """Batched small radius-graphs (the DimeNet regime)."""
    device = _device(device)
    rng = np.random.default_rng(seed)
    N = n_graphs * nodes_per
    pos = rng.random((N, 3)).astype(np.float32) * 3.0
    srcs, dsts = [], []
    for gid in range(n_graphs):
        lo = gid * nodes_per
        p = pos[lo: lo + nodes_per]
        d2 = ((p[:, None] - p[None, :]) ** 2).sum(-1)
        a, b = np.nonzero((d2 < cutoff ** 2) & (d2 > 0))
        srcs.append(a + lo)
        dsts.append(b + lo)
    src = np.concatenate(srcs).astype(np.int32)
    dst = np.concatenate(dsts).astype(np.int32)
    kj, ji, tmask = build_triplets(src, dst, N, cap_per_edge=triplet_cap)
    feat = rng.standard_normal((N, d_feat), dtype=np.float32)
    # graph-level regression target correlated with mean pairwise distance
    targets = np.array([
        pos[g * nodes_per:(g + 1) * nodes_per].std() for g in range(n_graphs)
    ], np.float32)
    return GraphBatch(
        node_feat=_t(feat, device),
        edge_src=_t(src, device), edge_dst=_t(dst, device),
        edge_mask=torch.ones(len(src), dtype=torch.bool, device=device),
        labels=_t(targets, device),
        node_mask=torch.ones(N, dtype=torch.bool, device=device),
        positions=_t(pos, device),
        graph_ids=_t(np.repeat(np.arange(n_graphs), nodes_per), device,
                     torch.int32),
        t_kj=_t(kj, device), t_ji=_t(ji, device), t_mask=_t(tmask, device),
    )
