"""Dry-run cell builders of the port: (arch × shape) → (step fn, args,
model FLOPs), the reference's ``launch/cells.py``.

Everything is built on meta tensors: no device memory and no random draw,
so Mixtral-8x22B's 141 B parameters cost nothing.  :func:`shapes_only`
runs a model's own ``init_*`` with every tensor on the meta device and
its random draws skipped, which gives the init's shapes and dtypes, leaf
for leaf.  Each argument is then a DTensor on the given ``DeviceMesh``
(a fake process group serves for a mesh of hundreds of ranks), placed by
the reference's logical axes: parameters by ``param_logical_axes``,
optimizer state at its parameter's placement, the decode cache by
``("layers", "batch", "kv_heads", "seq", None)``, GNN parameters
replicated and BERT4Rec's ``item_emb`` by ``("rows", None)``.

``fn`` is the port's own entry point: ``make_train_step(...,
mesh=mesh)`` with the cell's loss (the batch passed as DTensors already
placed), ``serve_prefill``, ``serve_decode`` (with the cache full: an int
``pos`` of ``S - 1``), ``bert4rec_score`` and ``bert4rec_retrieve``.
``model_flops``, ``tokens_or_items`` and ``description`` are the
reference's formulas.
"""
from __future__ import annotations

import dataclasses
from functools import partial
from typing import Callable, Optional

import torch
from torch.distributed.tensor import DTensor, Shard
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.configs import ArchSpec, ShapeCell, get_arch
from repro_torch.dist.sharding import placements_for
from repro_torch.models import bert4rec as b4r
from repro_torch.models import transformer as tfm
from repro_torch.models.gnn import GNNConfig, GraphBatch, gnn_loss_fn, \
    init_gnn
from repro_torch.train.optim import adamw, constant_schedule
from repro_torch.train.trainer import make_train_step
from repro_torch.train.tree import tree_leaves, tree_map, tree_unflatten

__all__ = ["Cell", "build_cell", "arg_bytes_per_device", "shapes_only"]

META = torch.device("meta")


@dataclasses.dataclass
class Cell:
    arch_id: str
    shape_name: str
    kind: str
    fn: Callable  # called as fn(*args) under a counting mode
    args: tuple  # meta DTensors (and a Python int for decode's pos)
    model_flops: float
    tokens_or_items: float = 0.0
    description: str = ""


class _MetaInit(TorchDispatchMode):
    """Every op on the meta device, with no generator: a random draw makes
    an uninitialised meta tensor of the same shape and dtype."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = dict(kwargs or {})
        if "generator" in kwargs:
            kwargs["generator"] = None
        if "device" in kwargs:
            kwargs["device"] = META
        return func(*args, **kwargs)


def shapes_only(init: Callable, *args, **kwargs):
    """``init(*args, **kwargs)`` with every tensor it makes on the meta
    device and no random number drawn: the shapes and dtypes of its tree,
    at no memory."""
    with _MetaInit():
        return init(*args, **kwargs)


def _contiguous_stride(shape) -> tuple:
    stride, acc = [], 1
    for n in reversed(shape):
        stride.append(acc)
        acc *= n
    return tuple(reversed(stride))


def _place(shape, dtype, logical, mesh) -> DTensor:
    """A meta DTensor of global ``shape`` placed by ``logical`` axes (the
    rules' divisibility fallback keeps every split even)."""
    shape = tuple(int(n) for n in shape)
    pl = placements_for(logical if logical else (None,) * len(shape),
                        shape, mesh)
    local = list(shape)
    for i, p in enumerate(pl):
        if isinstance(p, Shard):
            local[p.dim] //= mesh.size(i)
    return DTensor.from_local(
        torch.empty(local, dtype=dtype, device=META), mesh, pl,
        run_check=False, shape=torch.Size(shape),
        stride=_contiguous_stride(shape))


def _is_axes(node) -> bool:
    return isinstance(node, tuple) and all(a is None or isinstance(a, str)
                                           for a in node)


def _place_tree(tree, axes, mesh):
    """Each meta leaf of ``tree`` as a DTensor placed by the matching
    leaf of ``axes`` (None: every leaf replicated)."""
    leaves = tree_leaves(tree)
    specs = [None] * len(leaves) if axes is None else \
        tree_leaves(axes, is_leaf=_is_axes)
    return tree_unflatten(tree, [_place(x.shape, x.dtype, s, mesh)
                                 for x, s in zip(leaves, specs)])


def _optimizer():
    return adamw(constant_schedule(1e-4), weight_decay=0.0)


# --------------------------------------------------------------------- #
# LM cells
# --------------------------------------------------------------------- #
def _lm_params(cfg, mesh):
    shapes = shapes_only(tfm.init_params, cfg, torch.Generator(), device=META)
    return _place_tree(shapes, tfm.param_logical_axes(cfg), mesh)


def _lm_train_cell(spec: ArchSpec, cell: ShapeCell, mesh) -> Cell:
    cfg = spec.make_model_cfg()
    params = _lm_params(cfg, mesh)
    opt = _optimizer()
    state = opt.init(params)  # moments at their params' placements
    B, S = cell.global_batch, cell.seq_len
    batch = {"tokens": _place((B, S + 1), torch.int32, ("batch", None),
                              mesh)}
    step = make_train_step(lambda p, b: tfm.loss_fn(p, b, cfg), opt,
                           mesh=mesh)
    tokens = B * S
    flops = 6.0 * cfg.active_param_count() * tokens
    return Cell(spec.arch_id, cell.name, "train", step,
                (params, state, batch), flops, tokens,
                f"train_step {cfg.name} B={B} S={S}")


def _lm_prefill_cell(spec: ArchSpec, cell: ShapeCell, mesh) -> Cell:
    cfg = spec.make_model_cfg()
    params = _lm_params(cfg, mesh)
    B, S = cell.global_batch, cell.seq_len
    tokens = _place((B, S), torch.int32, ("batch", None), mesh)
    fn = partial(tfm.serve_prefill, cfg=cfg)
    flops = 2.0 * cfg.active_param_count() * B * S
    return Cell(spec.arch_id, cell.name, "prefill", fn,
                (params, tokens), flops, B * S,
                f"serve_prefill {cfg.name} B={B} S={S}")


def _lm_decode_cell(spec: ArchSpec, cell: ShapeCell, mesh) -> Cell:
    cfg = spec.make_model_cfg()
    params = _lm_params(cfg, mesh)
    B, S = cell.global_batch, cell.seq_len
    shapes = tfm.init_cache(cfg, B, horizon=S, device=META)
    cache = dataclasses.replace(shapes, **{
        f.name: _place(getattr(shapes, f.name).shape,
                       getattr(shapes, f.name).dtype,
                       ("layers", "batch", "kv_heads", "seq", None), mesh)
        for f in dataclasses.fields(shapes)
        if getattr(shapes, f.name) is not None})
    token = _place((B, 1), torch.int32, ("batch", None), mesh)
    fn = partial(tfm.serve_decode, cfg=cfg)
    # per-step flops: params matmuls + attention against live KV
    if cfg.layer_pattern == "window":
        s_eff = min(cfg.window, S) * cfg.n_layers
    elif cfg.layer_pattern == "alternating":
        s_eff = (min(cfg.window, S) + S) * cfg.n_layers // 2
    else:
        s_eff = S * cfg.n_layers
    attn_flops = 4.0 * B * cfg.n_heads * cfg.head_dim * s_eff
    flops = 2.0 * cfg.active_param_count() * B + attn_flops
    return Cell(spec.arch_id, cell.name, "decode", fn,
                (params, token, S - 1, cache), flops, B,
                f"serve_decode {cfg.name} B={B} KV={S}")


# --------------------------------------------------------------------- #
# GNN cells
# --------------------------------------------------------------------- #
def _gnn_batch(cfg: GNNConfig, cell: ShapeCell, mesh,
               triplet_cap: int = 8):
    if cell.kind == "gnn_minibatch":
        counts = [cell.batch_nodes]
        for f in cell.fanout:
            counts.append(counts[-1] * f)
        N = sum(counts)
        E = sum(c * f for c, f in zip(counts[:-1], cell.fanout))
        graph_level = False
        G = 0
    elif cell.kind == "gnn_molecule":
        N = cell.n_graphs * cell.nodes_per_graph
        E = cell.n_graphs * cell.edges_per_graph
        graph_level = True
        G = cell.n_graphs
    else:  # gnn_full
        N, E = cell.n_nodes, cell.n_edges
        graph_level = False
        G = 0
    # the reference pads node/edge counts to a multiple of 512 so that the
    # edge arrays split over the mesh (padded slots are masked)
    N = -(-N // 512) * 512
    E = -(-E // 512) * 512
    d = cell.d_feat
    need_geo = cfg.arch == "dimenet"
    T = -(-(E * triplet_cap) // 128) * 128 if need_geo else 0
    f32, i32, b8 = torch.float32, torch.int32, torch.bool

    def mk(shape, dt, ax):
        return _place(shape, dt, ax, mesh)

    kwargs = {}
    if need_geo:
        kwargs.update(
            positions=mk((N, 3), f32, ("nodes", None)),
            t_kj=mk((T,), i32, ("edges",)),
            t_ji=mk((T,), i32, ("edges",)),
            t_mask=mk((T,), b8, ("edges",)),
        )
    if graph_level or need_geo:
        kwargs.setdefault("graph_ids", mk((N,), i32, ("nodes",)))
    labels = (mk((G,), f32, (None,)) if (graph_level and need_geo)
              else mk((G,), i32, (None,)) if graph_level
              else mk((N,), i32, ("nodes",)))
    return GraphBatch(
        node_feat=mk((N, d), f32, ("nodes", None)),
        edge_src=mk((E,), i32, ("edges",)),
        edge_dst=mk((E,), i32, ("edges",)),
        edge_mask=mk((E,), b8, ("edges",)),
        labels=labels,
        node_mask=mk((N,), b8, ("nodes",)),
        **kwargs,
    ), N, E, (T if need_geo else 0)


def _gnn_flops(cfg: GNNConfig, N, E, T, d_in) -> float:
    d = cfg.d_hidden
    if cfg.arch == "gat":
        per_layer = 2 * N * d_in * cfg.n_heads * d + 2 * E * cfg.n_heads * d * 2
        return float(cfg.n_layers * per_layer) * 3  # fwd+bwd
    if cfg.arch == "gin":
        per_layer = 2 * N * (d_in * d + d * d) + E * d
        return float(cfg.n_layers * per_layer) * 3
    if cfg.arch == "sage":
        per_layer = 2 * N * d_in * d * 2 + E * d
        return float(cfg.n_layers * per_layer) * 3
    # dimenet: triplet bilinear dominates
    per_block = 2 * E * d * d + 2 * T * cfg.n_bilinear + 2 * E * cfg.n_bilinear * d
    return float(cfg.n_blocks * per_block + 2 * N * d_in * d) * 3


def _gnn_train_cell(spec: ArchSpec, cell: ShapeCell, mesh) -> Cell:
    base = spec.make_model_cfg()
    graph_level = cell.kind == "gnn_molecule"
    cfg = dataclasses.replace(
        base, d_in=cell.d_feat, graph_level=graph_level,
        n_classes=(1 if (base.arch == "dimenet" and graph_level)
                   else base.n_classes))
    batch, N, E, T = _gnn_batch(cfg, cell, mesh)
    # GNN params are small → replicate
    params = _place_tree(shapes_only(init_gnn, torch.Generator(), cfg, META),
                         None, mesh)
    opt = _optimizer()
    state = opt.init(params)  # moments at their params' placements
    step = make_train_step(lambda p, b: gnn_loss_fn(p, b, cfg), opt,
                           mesh=mesh)
    flops = _gnn_flops(cfg, N, E, T, cell.d_feat)
    return Cell(spec.arch_id, cell.name, "gnn_train", step,
                (params, state, batch), flops, E,
                f"gnn train {cfg.arch} N={N} E={E} T={T}")


# --------------------------------------------------------------------- #
# RecSys cells
# --------------------------------------------------------------------- #
def _recsys_cell(spec: ArchSpec, cell: ShapeCell, mesh) -> Cell:
    cfg = spec.make_model_cfg()
    shapes = shapes_only(b4r.init_bert4rec, cfg, torch.Generator(), META)
    logical = tree_map(lambda s: (None,) * s.ndim, shapes)
    logical["item_emb"] = ("rows", None)  # shard the huge table
    params = _place_tree(shapes, logical, mesh)
    L = cfg.max_len
    d = cfg.d_model
    backbone = cfg.n_blocks * (4 * d * d + 2 * d * cfg.d_ff_mult * d)
    i32, f32 = torch.int32, torch.float32
    if cell.kind == "recsys_train":
        B, M, K = cell.batch, cfg.max_masked, cfg.num_negatives
        batch = {
            "items": _place((B, L), i32, ("batch", None), mesh),
            "mask_pos": _place((B, M), i32, ("batch", None), mesh),
            "pos_labels": _place((B, M), i32, ("batch", None), mesh),
            "pos_weight": _place((B, M), f32, ("batch", None), mesh),
            "negatives": _place((K,), i32, (None,), mesh),
        }
        opt = _optimizer()
        state = opt.init(params)  # moments at their params' placements
        step = make_train_step(
            lambda p, b: b4r.bert4rec_loss_fn(p, b, cfg), opt, mesh=mesh)
        flops = 6.0 * backbone * B * L + 6.0 * B * M * (K + 1) * d
        return Cell(spec.arch_id, cell.name, "recsys_train", step,
                    (params, state, batch), flops, B,
                    f"bert4rec train B={B} L={L} sampled_softmax")
    if cell.kind == "recsys_serve":
        B = cell.batch
        items = _place((B, L), i32, ("batch", None), mesh)
        fn = partial(b4r.bert4rec_score, cfg=cfg)
        flops = 2.0 * backbone * B * L + 2.0 * B * cfg.vocab * d
        return Cell(spec.arch_id, cell.name, "recsys_serve", fn,
                    (params, items), flops, B,
                    f"bert4rec score B={B} V={cfg.vocab}")
    # retrieval
    B, C = cell.batch, cell.n_candidates
    items = _place((B, L), i32, (None, None), mesh)
    cands = _place((C,), i32, ("candidates",), mesh)
    fn = partial(b4r.bert4rec_retrieve, cfg=cfg)
    flops = 2.0 * backbone * B * L + 2.0 * C * d
    return Cell(spec.arch_id, cell.name, "recsys_retrieval", fn,
                (params, items, cands), flops, C,
                f"bert4rec retrieve C={C}")


# --------------------------------------------------------------------- #
def build_cell(arch_id: str, shape_name: str, mesh,
               overrides: Optional[dict] = None) -> Cell:
    """``overrides`` are dataclasses.replace'd into the model config (the
    roofline's depth sweeps, variants of a cell)."""
    spec = get_arch(arch_id)
    if overrides:
        base_make = spec.make_model_cfg
        spec = dataclasses.replace(
            spec, make_model_cfg=lambda: dataclasses.replace(
                base_make(), **overrides))
    cell = next(c for c in spec.shapes if c.name == shape_name)
    if spec.family == "lm":
        if cell.kind == "train":
            return _lm_train_cell(spec, cell, mesh)
        if cell.kind == "prefill":
            return _lm_prefill_cell(spec, cell, mesh)
        return _lm_decode_cell(spec, cell, mesh)
    if spec.family == "gnn":
        return _gnn_train_cell(spec, cell, mesh)
    return _recsys_cell(spec, cell, mesh)


def arg_bytes_per_device(args, num_devices: int) -> float:
    """Resident argument bytes per device implied by the args' placements:
    a DTensor's global bytes over the sizes of the mesh dimensions that
    shard it, a plain tensor whole, a Python int as an int32 scalar (the
    reference's traced ``pos``).  ``num_devices`` is accepted as the
    reference's signature has it; the placements say everything."""
    total = 0.0
    for leaf in tree_leaves(args):
        if isinstance(leaf, DTensor):
            nbytes = float(leaf.numel()) * leaf.element_size()
            denom = 1
            for i, p in enumerate(leaf.placements):
                if isinstance(p, Shard):
                    denom *= leaf.device_mesh.size(i)
            total += nbytes / denom
        elif isinstance(leaf, torch.Tensor):
            total += float(leaf.numel()) * leaf.element_size()
        elif isinstance(leaf, int) and not isinstance(leaf, bool):
            total += 4.0
    return total
