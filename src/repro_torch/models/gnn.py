"""GNN zoo of the port on the TOCAB message-passing engine (the
reference's ``models/gnn.py``).

The four architectures — GAT (SDDMM + edge softmax + SpMM), GIN (sum
aggregation + MLP), GraphSAGE (sampled mean aggregation), DimeNet (radial
and angular bases + triplet gather) — route their edge → node reductions
through the flat :func:`~repro_torch.core.tocab.segment_reduce`
(``bg=None``) or through the TOCAB blocked engine (``bg`` a
:class:`~repro_torch.core.partition.BlockedGraph`):
:func:`~repro_torch.core.tocab.tocab_edge_reduce` and
:func:`~repro_torch.core.tocab.tocab_pull` at the reference's defaults,
``impl="slab"`` and ``schedule="uniform"``.  Those are torch ops
(``index_add_``, ``scatter_reduce_``, gathers), so autograd differentiates
them; a max reduce splits its gradient evenly among tied entries, as
JAX's ``segment_max`` does.

Parameters are nested dicts and lists of fp32 tensors shaped as the
reference's trees; :func:`params_from_numpy` carries the reference's
parameters across.  ``binned_edges`` / ``binned_triplets`` take
:func:`_binned_segment_sum`: under ``use_mesh_rules`` on a mesh whose
``data`` axis is > 1 the edge → node sum is stripe-local (rank ``r`` sums
the values whose destinations lie in its stripe of nodes, with no
collective); off a mesh, or where the shapes do not divide, it is the flat
reduce, as in the reference.

On a mesh the forwards take a batch of DTensors (:func:`place_batch`: node
arrays split by ``nodes``, edge and triplet arrays by ``edges``, both over
``data``) and replicated parameters, and the reference's ``shard`` calls
place the node states and edge messages.  Three ops have no DTensor rule
and run on local shards: a gather of rows by an index array
(:func:`_take`: the rows are gathered whole on every rank, then each rank
picks those its block of indices names), a flat segment sum (each rank
sums its block of values into every row: a summand over ``data``), and a
segment max (values gathered whole, reduced on every rank).
:func:`bin_edges_by_stripe` lays a batch's edges out in the stripe order
that ``binned_edges`` assumes.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch.core import tocab
from repro_torch.core.partition import BlockedGraph
from repro_torch.dist.sharding import (current_mesh, mesh_axis_sizes,
                                       on_local_shards, place_tree, shard)

from .layers import _normal, init_dense, row_placements
from .layers import take_rows as _take

Tensor = torch.Tensor

__all__ = [
    "GraphBatch", "GNNConfig", "build_triplets", "params_from_numpy",
    "init_gat", "gat_forward", "init_gin", "gin_forward",
    "init_sage", "sage_forward", "init_dimenet", "dimenet_forward",
    "gnn_loss_fn", "loss_denominator", "init_gnn", "gnn_forward",
    "place_batch", "bin_edges_by_stripe",
]


# --------------------------------------------------------------------- #
# data containers
# --------------------------------------------------------------------- #
@dataclasses.dataclass(frozen=True)
class GraphBatch:
    """Static-shape (possibly padded) graph batch.

    For batched small graphs (``molecule``), ``graph_ids`` maps nodes to
    graphs.  For DimeNet, ``positions`` and the triplet edge-pair indices
    are present.  Padded edges point at node index n (dropped)."""

    node_feat: Tensor  # (N, F) float
    edge_src: Tensor  # (E,) int32
    edge_dst: Tensor  # (E,) int32
    edge_mask: Tensor  # (E,) bool
    labels: Tensor  # (N,) int32 node labels | (G,) graph labels/targets
    node_mask: Optional[Tensor] = None  # (N,) bool
    positions: Optional[Tensor] = None  # (N, 3)
    graph_ids: Optional[Tensor] = None  # (N,) int32 for graph-level readout
    t_kj: Optional[Tensor] = None  # (T,) int32 — triplet edge k→j
    t_ji: Optional[Tensor] = None  # (T,) int32 — triplet edge j→i
    t_mask: Optional[Tensor] = None  # (T,) bool

    @property
    def n(self) -> int:
        return self.node_feat.shape[0]


@dataclasses.dataclass(frozen=True)
class GNNConfig:
    """The reference's config, field for field."""
    arch: str  # gat | gin | sage | dimenet
    n_layers: int
    d_in: int
    d_hidden: int
    n_classes: int
    n_heads: int = 1  # gat
    agg: str = "segment"  # segment | tocab
    graph_level: bool = False  # graph-level readout (molecule)
    # dimenet extras
    n_blocks: int = 6
    n_bilinear: int = 8
    n_spherical: int = 7
    n_radial: int = 6
    cutoff: float = 5.0
    # bf16 messages/bases; geometry and final reductions stay fp32
    compute_dtype: str = "float32"
    # triplets / edges binned by destination stripe: on a mesh the reduce
    # is shard-local; on one device it is the flat reduce
    binned_triplets: bool = False
    binned_edges: bool = False
    # sage
    sample_sizes: tuple = (25, 10)


def _agg(vals_e: Tensor, dst: Tensor, n: int, bg: Optional[BlockedGraph],
         reduce: str = "sum", binned: bool = False) -> Tensor:
    """Edge values → node aggregate, via TOCAB or flat segment reduce.
    ``binned`` engages the stripe-local reduce (sum only) under the
    sorted-by-destination-stripe layout contract."""
    if bg is not None:
        return tocab.tocab_edge_reduce(bg, vals_e, reduce=reduce)
    if binned and reduce == "sum" and vals_e.ndim == 2:
        return _binned_segment_sum(vals_e, dst, n)
    return _flat_reduce(vals_e, dst, n, reduce)


def _flat_reduce(vals: Tensor, seg: Tensor, n: int, reduce: str) -> Tensor:
    """``segment_reduce`` into ``n`` rows; an id outside ``[0, n)`` (a padded
    edge's ``n``) is dropped, as ``jax.ops.segment_*`` drop it.  On
    DTensors a sum is each rank's block summed into every row (a summand
    over the axes that split the values); any other reduce gathers the
    values whole and reduces them on every rank."""
    if isinstance(vals, DTensor) or isinstance(seg, DTensor):
        return _reduce_on_mesh(vals, seg, n, reduce)
    seg = seg.long()
    seg = torch.where((seg >= 0) & (seg < n), seg, n)
    return tocab.segment_reduce(vals, seg, n + 1, reduce)[:n]


def _reduce_on_mesh(vals, seg, n: int, reduce: str):
    mesh, rows = row_placements(vals, seg)
    if reduce != "sum":
        rows = [Replicate()] * mesh.ndim
    out = [Partial() if pl == Shard(0) else Replicate() for pl in rows]
    return on_local_shards(
        lambda v, s: _flat_reduce(v, s, n, reduce), mesh,
        out_placements=out, in_placements=(rows, rows))(vals, seg)


def _binned_segment_sum(vals, seg, n_out: int):
    """Stripe-local segment sum under the binned-by-stripe contract
    (§Perf H4): on a mesh with ``data`` = S > 1, the values of block ``r``
    (of S equal blocks along dim 0) have their destinations in stripe ``r``
    of the ``n_out`` rows, so block ``r`` sums at ``seg - r·n_out/S`` into
    its stripe with no collective, and a value outside its stripe is
    dropped, as the reference's ``shard_map`` drops it.  A DTensor sharded
    on dim 0 over ``data`` sums its local block and returns the rank's
    stripe (a DTensor placed as ``vals``); a plain tensor is the whole
    array, its blocks summed in one program.  Off a mesh, or when the
    shapes do not divide, the flat reduce."""
    mesh = current_mesh()
    if isinstance(vals, DTensor):
        mesh = vals.device_mesh
        names = list(mesh.mesh_dim_names)
        d = names.index("data") if "data" in names else None
        if d is not None and vals.placements[d].is_shard(0) \
                and n_out % mesh.size(d) == 0 \
                and vals.shape[0] % mesh.size(d) == 0:
            n_loc = n_out // mesh.size(d)
            lo = mesh.get_local_rank(d) * n_loc
            local_seg = seg.to_local() if isinstance(seg, DTensor) else seg
            out = _flat_reduce(vals.to_local(), local_seg.long() - lo,
                               n_loc, "sum")
            return DTensor.from_local(out, mesh, vals.placements,
                                      run_check=False)
        vals = vals.full_tensor()
        seg = seg.full_tensor() if isinstance(seg, DTensor) else seg
        mesh = None
    shards = mesh_axis_sizes(mesh).get("data", 1) if mesh is not None else 1
    if shards <= 1 or vals.shape[0] % shards or n_out % shards:
        return _flat_reduce(vals, seg, n_out, "sum")
    n_loc = n_out // shards
    lo = torch.arange(vals.shape[0], device=vals.device) \
        // (vals.shape[0] // shards) * n_loc
    seg = seg.long()
    keep = (seg >= lo) & (seg < lo + n_loc)
    return _flat_reduce(vals, torch.where(keep, seg, -1), n_out, "sum")


def _ends(batch: GraphBatch) -> tuple:
    """(src, dst) as gather indices: int64, a padded edge's ``n`` clamped
    to ``n - 1`` as JAX's gathers clamp (its messages are masked)."""
    hi = batch.n - 1
    return (batch.edge_src.long().clamp(0, hi),
            batch.edge_dst.long().clamp(0, hi))


def _masked_edges(batch: GraphBatch, vals_e: Tensor, fill=0.0) -> Tensor:
    m = batch.edge_mask
    while m.ndim < vals_e.ndim:
        m = m[..., None]
    return torch.where(m, vals_e, fill)


def _graph_readout(x: Tensor, batch: GraphBatch) -> Tensor:
    """Sum-pool node states per graph (batched-small-graphs regime)."""
    num_graphs = int(batch.labels.shape[0])
    if batch.node_mask is not None:
        x = x * batch.node_mask.to(x.dtype)[:, None]
    return _flat_reduce(x, batch.graph_ids, num_graphs, "sum")


def _device(device):
    return torch.device("cuda") if device is None else torch.device(device)


# --------------------------------------------------------------------- #
# GAT  [arXiv:1710.10903]
# --------------------------------------------------------------------- #
def init_gat(generator: torch.Generator, cfg: GNNConfig, device=None) -> dict:
    device = _device(device)
    layers = []
    d_in = cfg.d_in
    for i in range(cfg.n_layers):
        last = i == cfg.n_layers - 1
        heads = 1 if last else cfg.n_heads
        d_out = cfg.n_classes if last else cfg.d_hidden
        layers.append({
            "w": init_dense(generator, d_in, heads * d_out, device=device),
            "a_src": _normal((heads, d_out), generator, device) * 0.1,
            "a_dst": _normal((heads, d_out), generator, device) * 0.1,
        })
        d_in = heads * d_out
    return {"layers": layers}


def _edge_softmax(scores_e: Tensor, dst: Tensor, n: int, edge_mask: Tensor,
                  bg: Optional[BlockedGraph]) -> Tensor:
    """Numerically-stable softmax over incoming edges per destination.
    scores_e: (E, H).  SDDMM → segment-max → exp → segment-sum."""
    s = torch.where(edge_mask[:, None], scores_e, -1e30)
    smax = _agg(s, dst, n, bg, reduce="max")  # (N, H)
    smax = torch.where(torch.isfinite(smax), smax, 0.0)
    at = dst.long().clamp(0, n - 1)
    ex = shard(torch.exp(s - _take(smax, at)) * edge_mask[:, None], "edges",
               None)
    denom = _agg(ex, dst, n, bg, reduce="sum")
    return ex / torch.clamp(_take(denom, at), min=1e-16)


def gat_forward(params: dict, batch: GraphBatch, cfg: GNNConfig,
                bg: Optional[BlockedGraph] = None) -> Tensor:
    x = batch.node_feat
    n = batch.n
    src, dst = _ends(batch)
    for i, p in enumerate(params["layers"]):
        last = i == len(params["layers"]) - 1
        heads = 1 if last else cfg.n_heads
        d_out = p["w"].shape[1] // heads
        h = shard((x @ p["w"]).reshape(n, heads, d_out), "nodes", None, None)
        # SDDMM: per-edge attention logits
        s_src = torch.einsum("nhd,hd->nh", h, p["a_src"])
        s_dst = torch.einsum("nhd,hd->nh", h, p["a_dst"])
        scores = F.leaky_relu(_take(s_src, src) + _take(s_dst, dst),
                              0.2)  # (E, H)
        scores = shard(scores, "edges", None)
        alpha = _edge_softmax(scores, batch.edge_dst, n, batch.edge_mask, bg)
        msgs = _masked_edges(batch, _take(h, src) * alpha[..., None])
        msgs = shard(msgs, "edges", None, None)  # (E, H, D)
        out = _agg(msgs.reshape(msgs.shape[0], -1), batch.edge_dst, n,
                   bg, binned=cfg.binned_edges).reshape(n, heads, d_out)
        x = out.reshape(n, heads * d_out)
        if not last:
            x = F.elu(x)
    if cfg.graph_level:
        x = _graph_readout(x, batch)
    return x  # logits (N or G, n_classes)


# --------------------------------------------------------------------- #
# GIN  [arXiv:1810.00826]
# --------------------------------------------------------------------- #
def init_gin(generator: torch.Generator, cfg: GNNConfig, device=None) -> dict:
    device = _device(device)
    layers = []
    d_in = cfg.d_in
    h = cfg.d_hidden
    for _ in range(cfg.n_layers):
        layers.append({
            "eps": torch.zeros((), device=device),
            "w1": init_dense(generator, d_in, h, device=device),
            "b1": torch.zeros((h,), device=device),
            "w2": init_dense(generator, h, h, device=device),
            "b2": torch.zeros((h,), device=device),
        })
        d_in = h
    return {"layers": layers,
            "head": init_dense(generator, h, cfg.n_classes, device=device)}


def _neighbour_sum(x: Tensor, batch: GraphBatch, bg: Optional[BlockedGraph],
                   cfg: GNNConfig) -> Tensor:
    """Σ of x over each node's in-edges: a blocked pull, or masked edge
    messages through the flat (or binned) reduce."""
    if bg is not None:
        return tocab.tocab_pull(bg, x, reduce="sum")
    msgs = shard(_masked_edges(batch, _take(x, _ends(batch)[0])), "edges",
                 None)
    return _agg(msgs, batch.edge_dst, batch.n, None,
                binned=cfg.binned_edges)


def gin_forward(params: dict, batch: GraphBatch, cfg: GNNConfig,
                bg: Optional[BlockedGraph] = None) -> Tensor:
    x = batch.node_feat
    for p in params["layers"]:
        agg = _neighbour_sum(x, batch, bg, cfg)
        h = (1.0 + p["eps"]) * x + agg
        h = torch.relu(h @ p["w1"] + p["b1"])
        x = shard(torch.relu(h @ p["w2"] + p["b2"]), "nodes", None)
    if cfg.graph_level:
        num_graphs = int(batch.labels.shape[0])
        gmask = batch.node_mask.to(x.dtype)[:, None] \
            if batch.node_mask is not None else 1.0
        x = _flat_reduce(x * gmask, batch.graph_ids, num_graphs, "sum")
    return x @ params["head"]


# --------------------------------------------------------------------- #
# GraphSAGE  [arXiv:1706.02216]
# --------------------------------------------------------------------- #
def init_sage(generator: torch.Generator, cfg: GNNConfig,
              device=None) -> dict:
    device = _device(device)
    layers = []
    d_in = cfg.d_in
    for i in range(cfg.n_layers):
        last = i == cfg.n_layers - 1
        d_out = cfg.n_classes if last else cfg.d_hidden
        layers.append({
            "w_self": init_dense(generator, d_in, d_out, device=device),
            "w_neigh": init_dense(generator, d_in, d_out, device=device),
        })
        d_in = d_out
    return {"layers": layers}


def sage_forward(params: dict, batch: GraphBatch, cfg: GNNConfig,
                 bg: Optional[BlockedGraph] = None) -> Tensor:
    x = batch.node_feat
    ones = batch.edge_mask.to(x.dtype)
    deg = _agg(ones, batch.edge_dst, batch.n, bg)  # in-degree
    for i, p in enumerate(params["layers"]):
        last = i == len(params["layers"]) - 1
        s = _neighbour_sum(x, batch, bg, cfg)
        mean = s / torch.clamp(deg[:, None], min=1.0)
        x = shard(x @ p["w_self"] + mean @ p["w_neigh"], "nodes", None)
        if not last:
            x = torch.relu(x)
            x = x / torch.clamp(torch.linalg.vector_norm(
                x, dim=-1, keepdim=True), min=1e-12)
    if cfg.graph_level:
        x = _graph_readout(x, batch)
    return x


# --------------------------------------------------------------------- #
# DimeNet  [arXiv:2003.03123] — directional message passing
# --------------------------------------------------------------------- #
# The reference's simplifications: radial basis = the paper's sin(nπd/c)/d
# Bessel form; angular basis = Fourier cos(lθ) instead of spherical Bessel
# × spherical harmonics (same tensor shapes and gather structure).
def init_dimenet(generator: torch.Generator, cfg: GNNConfig,
                 device=None) -> dict:
    device = _device(device)
    d = cfg.d_hidden
    nr, ns, nb = cfg.n_radial, cfg.n_spherical, cfg.n_bilinear

    def dense(d_in, d_out):
        return init_dense(generator, d_in, d_out, device=device)

    return {
        "embed": dense(cfg.d_in, d),
        "rbf_proj": dense(nr, d),
        "blocks": [
            {"w_msg": dense(d, d), "w_down": dense(d, nb),
             "w_sbf": dense(nr * ns, nb), "w_up": dense(nb, d),
             "w_rbf": dense(nr, d)}
            for _ in range(cfg.n_blocks)
        ],
        "out_rbf": dense(nr, d),
        "head": dense(d, cfg.n_classes),
    }


def _rowwise(fn, x: Tensor) -> Tensor:
    """``fn(x)`` for a function that maps each row on its own (and builds
    plain constant tensors): on a DTensor, run on each rank's rows."""
    if not isinstance(x, DTensor):
        return fn(x)
    rows = list(x.placements)
    return on_local_shards(fn, x.device_mesh, out_placements=rows,
                           in_placements=(rows,))(x)


def _bessel_rbf(dist: Tensor, n_radial: int, cutoff: float) -> Tensor:
    return _rowwise(lambda d: _bessel_rbf_rows(d, n_radial, cutoff), dist)


def _bessel_rbf_rows(dist: Tensor, n_radial: int, cutoff: float) -> Tensor:
    """DimeNet radial basis: sin(nπ d/c) / d, n = 1..n_radial."""
    d = torch.clamp(dist, min=1e-6)[:, None]
    n = torch.arange(1, n_radial + 1, dtype=torch.float32,
                     device=dist.device)[None, :]
    env = (2.0 / cutoff) ** 0.5
    return env * torch.sin(n * math.pi * d / cutoff) / d


def _angular_basis(cos_angle: Tensor, n_spherical: int) -> Tensor:
    return _rowwise(lambda c: _angular_rows(c, n_spherical), cos_angle)


def _angular_rows(cos_angle: Tensor, n_spherical: int) -> Tensor:
    """Fourier angular basis cos(lθ), l = 0..n_spherical-1."""
    theta = torch.arccos(torch.clamp(cos_angle, -1.0 + 1e-6, 1.0 - 1e-6))
    l = torch.arange(n_spherical, dtype=torch.float32,
                     device=cos_angle.device)[None, :]
    return torch.cos(l * theta[:, None])


def dimenet_forward(params: dict, batch: GraphBatch, cfg: GNNConfig,
                    bg: Optional[BlockedGraph] = None) -> Tensor:
    if batch.positions is None or batch.t_kj is None:
        raise ValueError("dimenet needs a batch with positions and triplets "
                         "(t_kj, t_ji, t_mask): molecule_batch() or "
                         "graph_to_batch(..., with_positions=True)")
    n = batch.n
    src, dst = _ends(batch)
    t_kj, t_ji = batch.t_kj.long(), batch.t_ji
    pos = batch.positions
    vec = shard(_take(pos, src) - _take(pos, dst), "edges",
                None)  # edge j→i (src=j)
    dist = torch.linalg.vector_norm(vec + 1e-12, dim=-1)
    rbf = _bessel_rbf(dist, cfg.n_radial, cfg.cutoff)  # (E, nr)
    rbf = shard(rbf * batch.edge_mask[:, None], "edges", None)

    # triplet geometry: angle between edge (k→j) and (j→i)
    v1 = _take(vec, t_ji.long())
    v2 = -_take(vec, t_kj)
    cos_a = (v1 * v2).sum(-1) / torch.clamp(
        torch.linalg.vector_norm(v1, dim=-1)
        * torch.linalg.vector_norm(v2, dim=-1), min=1e-12)
    ang = _angular_basis(cos_a, cfg.n_spherical)  # (T, ns)
    sbf = (_take(rbf, t_kj)[:, :, None] * ang[:, None, :]).reshape(
        ang.shape[0], cfg.n_radial * cfg.n_spherical)
    sbf = shard(sbf * batch.t_mask[:, None], "edges", None)

    # edge message embedding
    dt = getattr(torch, cfg.compute_dtype)
    rbf = rbf.to(dt)
    sbf = sbf.to(dt)
    x_node = (batch.node_feat @ params["embed"]).to(dt)

    def wt(w):
        return w.to(dt)

    m = F.silu(_take(x_node, src) + _take(x_node, dst)
               + rbf @ wt(params["rbf_proj"]))
    m = shard(m, "edges", None)
    E = src.shape[0]
    tmask = batch.t_mask.to(dt)[:, None]
    emask = batch.edge_mask.to(dt)[:, None]
    for blk in params["blocks"]:
        # directional (triplet) interaction: m_ji ← Σ_k up[(down m_kj) ⊙ (sbf W)]
        m_down = shard(_take(m @ wt(blk["w_down"]), t_kj), "edges", None)
        t_msg = shard(m_down * (sbf @ wt(blk["w_sbf"])), "edges",
                      None)  # (T, nb)
        if cfg.binned_triplets:
            t_agg = _binned_segment_sum(t_msg * tmask, t_ji, E)
        else:
            t_agg = _flat_reduce(t_msg * tmask, t_ji, E, "sum")
        t_agg = shard(t_agg, "edges", None)
        m = F.silu(m @ wt(blk["w_msg"]) + t_agg @ wt(blk["w_up"])
                   + rbf @ wt(blk["w_rbf"]))
        m = shard(m * emask, "edges", None)
    # output: edge → node
    node_out = _agg(m * (rbf @ wt(params["out_rbf"])), batch.edge_dst, n, bg,
                    binned=cfg.binned_edges)
    node_out = node_out.float()
    if cfg.graph_level:
        num_graphs = int(batch.labels.shape[0])
        node_out = _flat_reduce(node_out, batch.graph_ids, num_graphs,
                                "sum")
    return node_out @ params["head"]


# --------------------------------------------------------------------- #
# unified entry + loss
# --------------------------------------------------------------------- #
_INIT = {"gat": init_gat, "gin": init_gin, "sage": init_sage,
         "dimenet": init_dimenet}
_FWD = {"gat": gat_forward, "gin": gin_forward, "sage": sage_forward,
        "dimenet": dimenet_forward}


def init_gnn(generator: torch.Generator, cfg: GNNConfig, device=None) -> dict:
    """Random fp32 parameters drawn from ``generator`` (on its own device,
    then moved to ``device``, the card by default), scaled as the
    reference's ``init_gnn``; :func:`params_from_numpy` carries the
    reference's numbers over."""
    return _INIT[cfg.arch](generator, cfg, device)


def params_from_numpy(tree, device=None):
    """The reference's parameter tree (nested dicts and lists of numpy
    arrays) as fp32 tensors on ``device`` (the card by default)."""
    device = _device(device)
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [params_from_numpy(v, device) for v in tree]
    return torch.from_numpy(np.array(tree, dtype=np.float32)).to(device)


def gnn_forward(params, batch, cfg: GNNConfig, bg=None) -> Tensor:
    return _FWD[cfg.arch](params, batch, cfg, bg)


def _summed(x):
    """``x`` with the summands of a DTensor's ``Partial`` placements summed
    (made ``Replicate``; its shards kept).  The loss sums them anyway
    (``logsumexp`` is not linear); done first, the gather of the gold logit
    never meets DTensor's masked-partial reduce, which takes 2-D tensors
    only."""
    if isinstance(x, DTensor) and any(p.is_partial() for p in x.placements):
        x = x.redistribute(x.device_mesh, [
            Replicate() if p.is_partial() else p for p in x.placements])
    return x


def gnn_loss_fn(params, batch: GraphBatch, cfg: GNNConfig, bg=None):
    """→ (loss, metrics): MSE for DimeNet's regression head
    (``n_classes == 1``), else the (node-masked) mean CE with accuracy."""
    out = _summed(gnn_forward(params, batch, cfg, bg))
    if cfg.arch == "dimenet" and cfg.n_classes == 1:
        # regression (molecular property)
        target = batch.labels.float()
        loss = (out[..., 0] - target).square().mean()
        return loss, {"mse": loss}
    logits = out.float()
    labels = batch.labels.long()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None])[..., 0]
    nll = logz - gold
    if not cfg.graph_level and batch.node_mask is not None:
        w = batch.node_mask.float()
        loss = (nll * w).sum() / torch.clamp(w.sum(), min=1.0)
    else:
        loss = nll.mean()
    acc = (logits.argmax(-1) == labels).float().mean()
    return loss, {"acc": acc}


def loss_denominator(batch: GraphBatch, cfg: GNNConfig) -> Tensor:
    """The count :func:`gnn_loss_fn`'s mean divides by: the node mask's sum
    for a masked node-level loss, else the number of labels (a
    data-parallel step weighs the ranks' losses by it)."""
    if (cfg.arch != "dimenet" or cfg.n_classes != 1) \
            and not cfg.graph_level and batch.node_mask is not None:
        return batch.node_mask.float().sum()
    return torch.tensor(float(batch.labels.numel()))


def build_triplets(src: np.ndarray, dst: np.ndarray, n: int,
                   cap_per_edge: int = 0, seed: int = 0):
    """Host-side triplet index construction for DimeNet (numpy, the
    reference's code and random draws).

    For every edge (j→i), pair it with incoming edges (k→j), k≠i.
    ``cap_per_edge>0`` truncates to that many k-neighbours per edge.
    Returns (t_kj, t_ji, t_mask) padded to a multiple of 128."""
    E = len(src)
    in_edges = {}  # node → list of edge ids entering it
    for e, d in enumerate(dst):
        in_edges.setdefault(int(d), []).append(e)
    rng = np.random.default_rng(seed)
    t_kj, t_ji = [], []
    for e in range(E):
        j, i = int(src[e]), int(dst[e])
        cands = [ke for ke in in_edges.get(j, []) if int(src[ke]) != i]
        if cap_per_edge and len(cands) > cap_per_edge:
            cands = list(rng.choice(cands, cap_per_edge, replace=False))
        for ke in cands:
            t_kj.append(ke)
            t_ji.append(e)
    T = max(len(t_kj), 1)
    pad = -(-T // 128) * 128
    kj = np.zeros(pad, np.int32)
    ji = np.zeros(pad, np.int32)
    mask = np.zeros(pad, bool)
    kj[:len(t_kj)] = t_kj
    ji[:len(t_ji)] = t_ji
    mask[:len(t_kj)] = True
    return kj, ji, mask


# --------------------------------------------------------------------- #
# batches on a mesh
# --------------------------------------------------------------------- #
_NODE_FIELDS = ("node_feat", "node_mask", "positions", "graph_ids")
_EDGE_FIELDS = ("edge_src", "edge_dst", "edge_mask", "t_kj", "t_ji",
                "t_mask")


def place_batch(batch: GraphBatch, mesh, graph_level: bool = False):
    """``batch`` as DTensors on ``mesh`` by the reference's names: node
    arrays (and node labels) split by ``nodes``, edge and triplet arrays by
    ``edges`` (each over ``data`` where it divides), graph labels whole.
    The batch itself off a mesh."""
    if mesh is None:
        return batch
    fields = {}
    for f in dataclasses.fields(batch):
        x = getattr(batch, f.name)
        if x is None:
            continue
        if f.name in _NODE_FIELDS or (f.name == "labels" and not graph_level):
            name = "nodes"
        elif f.name in _EDGE_FIELDS:
            name = "edges"
        else:
            name = None
        fields[f.name] = place_tree(x, (name,) + (None,) * (x.ndim - 1),
                                    mesh)
    return dataclasses.replace(batch, **fields)


def bin_edges_by_stripe(batch: GraphBatch, shards: int) -> GraphBatch:
    """The batch with its edges in the layout ``binned_edges`` assumes on
    a mesh of ``shards`` data ranks: ``shards`` equal blocks, block ``r``
    holding the real edges whose destinations lie in stripe ``r`` of the
    ``n`` nodes (in their original order), padded with masked edges into
    node ``n``.  The node count must divide by ``shards``; triplets, which
    name edges by position, are not carried over."""
    n = batch.n
    if n % shards:
        raise ValueError(f"{n} nodes do not split into {shards} stripes")
    if batch.t_kj is not None:
        raise ValueError("a batch with triplets: their edge ids would "
                         "change with the edges' order")
    src = batch.edge_src.cpu().numpy()
    dst = batch.edge_dst.cpu().numpy()
    real = batch.edge_mask.cpu().numpy() & (dst >= 0) & (dst < n)
    owner = np.where(real, dst // (n // shards), shards)
    blocks = [np.flatnonzero(owner == r) for r in range(shards)]
    width = max(len(b) for b in blocks)
    out_src = np.zeros((shards, width), np.int32)
    out_dst = np.full((shards, width), n, np.int32)
    out_mask = np.zeros((shards, width), bool)
    for r, b in enumerate(blocks):
        out_src[r, :len(b)] = src[b]
        out_dst[r, :len(b)] = dst[b]
        out_mask[r, :len(b)] = True
    dev = batch.edge_src.device
    return dataclasses.replace(
        batch, edge_src=torch.from_numpy(out_src.reshape(-1)).to(dev),
        edge_dst=torch.from_numpy(out_dst.reshape(-1)).to(dev),
        edge_mask=torch.from_numpy(out_mask.reshape(-1)).to(dev))
