"""Uniform-fanout neighbour sampler (the GraphSAGE ``minibatch_lg``
regime; the reference's ``data/sampler.py``).

Layered k-hop uniform sampling from the CSR in-neighbour lists, producing a
static-shape layered subgraph batch, host-side numpy with a deterministic
seed stream: the same ``Generator`` calls in the same order as the
reference, so a batch equals its batch element for element.  Its tensors go
on ``device`` (the card by default).

Layout of the sampled batch (for ``sample_sizes = (f1, f2)``, 2 layers):
layer-0 seeds: ``batch_nodes``; layer-1 frontier: batch·f1; layer-2
frontier: batch·f1·f2.  Edges connect consecutive layers.  All node ids
are *local* to the batch (gathered features), so the model's shapes never
depend on |V|.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.graph import Graph
from repro_torch.models.gnn import GraphBatch

__all__ = ["NeighborSampler"]


class NeighborSampler:
    def __init__(self, g: Graph, feats: np.ndarray, labels: np.ndarray,
                 sample_sizes=(25, 10), seed: int = 0, device=None):
        # in-neighbour CSR (pull direction: aggregate FROM in-neighbours)
        gt = g.transpose()
        self.rowptr = gt.rowptr
        self.colidx = gt.colidx
        self.n = g.n
        self.feats = feats
        self.labels = labels
        self.sizes = tuple(sample_sizes)
        self.rng = np.random.default_rng(seed)
        self.device = torch.device("cuda") if device is None \
            else torch.device(device)

    def _sample_neighbors(self, nodes: np.ndarray, fanout: int):
        """For each node, draw ``fanout`` uniform in-neighbours (with
        replacement; isolated nodes self-loop)."""
        lo = self.rowptr[nodes]
        deg = self.rowptr[nodes + 1] - lo
        r = self.rng.integers(0, 2 ** 31, (len(nodes), fanout))
        safe_deg = np.maximum(deg, 1)
        pick = lo[:, None] + (r % safe_deg[:, None])
        nbrs = self.colidx[np.minimum(pick, len(self.colidx) - 1)]
        nbrs = np.where(deg[:, None] > 0, nbrs, nodes[:, None])  # self-loop
        return nbrs.astype(np.int64)

    def sample(self, batch_nodes: int) -> GraphBatch:
        seeds = self.rng.integers(0, self.n, batch_nodes)
        layers = [seeds]
        for f in self.sizes:
            layers.append(self._sample_neighbors(layers[-1], f).reshape(-1))
        # local id space: concatenate all layers (duplicates allowed — the
        # standard layered-SAGE formulation; features gathered per slot)
        all_nodes = np.concatenate(layers)
        offsets = np.cumsum([0] + [len(l) for l in layers])
        srcs, dsts = [], []
        for li, f in enumerate(self.sizes):
            # edges: layer li+1 slot j*f+k  →  layer li slot j
            n_dst = len(layers[li])
            srcs.append(offsets[li + 1] + np.arange(n_dst * f))
            dsts.append(offsets[li] + np.repeat(np.arange(n_dst), f))
        src = np.concatenate(srcs).astype(np.int32)
        dst = np.concatenate(dsts).astype(np.int32)
        feats = self.feats[all_nodes]
        labels = self.labels[all_nodes].astype(np.int32)
        node_mask = np.zeros(len(all_nodes), bool)
        node_mask[: batch_nodes] = True  # loss only on seed nodes
        dev = self.device
        return GraphBatch(
            node_feat=torch.from_numpy(feats).to(dev),
            edge_src=torch.from_numpy(src).to(dev),
            edge_dst=torch.from_numpy(dst).to(dev),
            edge_mask=torch.ones(len(src), dtype=torch.bool, device=dev),
            labels=torch.from_numpy(labels).to(dev),
            node_mask=torch.from_numpy(node_mask).to(dev),
        )

    @staticmethod
    def batch_shapes(batch_nodes: int, sizes, d_feat: int):
        """Static shapes of a sampled batch."""
        counts = [batch_nodes]
        for f in sizes:
            counts.append(counts[-1] * f)
        n_nodes = sum(counts)
        n_edges = sum(c * f for c, f in zip(counts[:-1], sizes))
        return n_nodes, n_edges
