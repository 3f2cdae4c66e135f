"""Config schema of the port: every architecture is an ``ArchSpec`` with its
literature config, a reduced smoke config, and its shape set (a copy of
the reference's ``configs/base.py``)."""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

__all__ = ["ShapeCell", "ArchSpec", "LM_SHAPES", "GNN_SHAPES",
           "RECSYS_SHAPES"]


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    name: str
    kind: str  # train | prefill | decode | gnn_full | gnn_minibatch |
    #            gnn_molecule | recsys_train | recsys_serve | recsys_retrieval
    # LM fields
    seq_len: int = 0
    global_batch: int = 0
    # GNN fields
    n_nodes: int = 0
    n_edges: int = 0
    d_feat: int = 0
    batch_nodes: int = 0
    fanout: tuple = ()
    n_graphs: int = 0
    nodes_per_graph: int = 0
    edges_per_graph: int = 0
    # recsys fields
    batch: int = 0
    n_candidates: int = 0


@dataclasses.dataclass(frozen=True)
class ArchSpec:
    arch_id: str
    family: str  # lm | gnn | recsys
    make_model_cfg: Callable[[], Any]
    make_smoke_cfg: Callable[[], Any]
    shapes: tuple
    source: str = ""
    notes: str = ""
    # archs whose attention is purely global skip long_500k
    skip_shapes: tuple = ()


LM_SHAPES = (
    ShapeCell("train_4k", "train", seq_len=4096, global_batch=256),
    ShapeCell("prefill_32k", "prefill", seq_len=32768, global_batch=32),
    ShapeCell("decode_32k", "decode", seq_len=32768, global_batch=128),
    ShapeCell("long_500k", "decode", seq_len=524288, global_batch=1),
)

GNN_SHAPES = (
    ShapeCell("full_graph_sm", "gnn_full", n_nodes=2708, n_edges=10556,
              d_feat=1433),
    ShapeCell("minibatch_lg", "gnn_minibatch", n_nodes=232965,
              n_edges=114615892, d_feat=602, batch_nodes=1024,
              fanout=(15, 10)),
    ShapeCell("ogb_products", "gnn_full", n_nodes=2449029, n_edges=61859140,
              d_feat=100),
    ShapeCell("molecule", "gnn_molecule", n_graphs=128, nodes_per_graph=30,
              edges_per_graph=64, d_feat=16),
)

RECSYS_SHAPES = (
    ShapeCell("train_batch", "recsys_train", batch=65536),
    ShapeCell("serve_p99", "recsys_serve", batch=512),
    ShapeCell("serve_bulk", "recsys_serve", batch=262144),
    ShapeCell("retrieval_cand", "recsys_retrieval", batch=1,
              n_candidates=1_000_000),
)
