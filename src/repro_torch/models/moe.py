"""Mixture-of-Experts layer of the port, with TOCAB-style sorted (binned)
dispatch: the reference's ``models/moe.py``.

The token→expert dispatch is a push-mode scatter: many tokens accumulate
into few expert bins.  It runs like the paper's push TOCAB (§3.1): *bin*
the (token, expert) pairs by destination expert with one stable sort, give
every expert a dense capacity slab of compacted slots, run dense
per-expert GEMMs (``torch.bmm`` over the expert axis), then un-permute and
combine — the reduction phase.  No (tokens × experts × capacity) one-hot
tensor is made.

The reference's two dispatch modes: ``global`` (one sort over all
tokens) and ``sharded`` (each data shard bins its own tokens into its own
capacity slabs, capacity ``_capacity(n / shards)``; the reference's
``vmap``).  Off a mesh both are one bin pass.  The shards are those of
``("pod", "data")`` (``_num_token_shards``) and the block runs in one of
three forms:

* DTensor tokens: each rank bins its data shard's tokens
  (``capacity`` over the batch axes) and runs the expert ``bmm`` s on its
  local experts (``experts`` over ``model``); its combine is a summand over
  ``model`` (:func:`_moe_on_mesh`).  ``global`` gathers the tokens first.
* a plain tensor under a ``DeviceMesh`` (the data-parallel step, where
  each rank holds its block of the batch): the rank's block is its shard,
  binned alone.
* a plain tensor under a mesh given as sizes (``{"data": 2}``): the whole
  batch, its shards binned one after the other in one program.

The Switch aux loss is E · Σ_e frac(e) · mean_prob(e), two means over
the *global* batch's tokens: on a mesh each rank's counts of top-1 choices
and sums of router probabilities (and its token count) are summed over the
batch axes before the product (``all_reduce_sum``, whose gradient sums the
ranks' gradients, so a data-parallel step that averages the ranks'
gradients counts each token once).

Where the port is careful to keep the reference's function:

* the binning sort is stable (``jnp.argsort`` is), so within an expert's
  bin the pairs keep flat (token, k-slot) order and the first ``C`` of
  them are kept;
* the router's top-k breaks ties toward the lower expert id, as
  ``jax.lax.top_k`` does (``torch.topk`` does not): a stable descending
  sort of the probabilities and its first ``k`` columns;
* the router runs in fp32 and the expert weights are cast to the
  activations' dtype at use.

One difference: the reference's combine is a ``segment_sum`` over token
ids, which on the card would be float atomics in no fixed order.  Every
token has exactly ``k`` pairs, so :func:`_combine` puts each pair back at
its flat (token, slot) place with the sort's permutation (no two pairs
share a place) and sums over ``k``: the same function with no atomics,
so a repeated step gives bit-equal outputs.
"""
from __future__ import annotations

import dataclasses

import math

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor

from repro_torch.dist.collectives import all_reduce_sum, stable_topk
from repro_torch.dist.sharding import (current_mesh, logical_to_spec,
                                       mesh_axis_sizes, on_local_shards,
                                       placements_for, shard)

from .layers import _normal, block_offset, init_dense, spec_axes

__all__ = ["MoECfg", "init_moe", "moe_block", "route"]

Tensor = torch.Tensor

#: the reference's dispatch modes; off a mesh both are one bin pass
DISPATCH_MODES = ("global", "sharded")
#: the mesh axes whose shards bin their own tokens (the reference's order)
TOKEN_AXES = ("pod", "data")


@dataclasses.dataclass(frozen=True)
class MoECfg:
    d_model: int
    d_ff: int  # per-expert hidden
    num_experts: int
    top_k: int
    capacity_factor: float = 1.25
    kind: str = "swiglu"  # expert MLP kind
    router_softcap: float = 0.0
    dispatch: str = "sharded"  # global | sharded: one bin pass off a mesh


def init_moe(generator: torch.Generator, cfg: MoECfg, device=None) -> dict:
    """Random fp32 expert parameters from ``generator``, scaled as the
    reference's ``init_moe`` (another generator, so other numbers)."""
    E, d, f = cfg.num_experts, cfg.d_model, cfg.d_ff
    p = {
        "router": init_dense(generator, d, E, device=device),
        "w_up": _normal((E, d, f), generator, device) * d ** -0.5,
        "w_down": _normal((E, f, d), generator, device) * f ** -0.5,
    }
    if cfg.kind in ("swiglu", "geglu"):
        p["w_gate"] = _normal((E, d, f), generator, device) * d ** -0.5
    return p


def _capacity(n_tokens: int, cfg: MoECfg) -> int:
    c = int(n_tokens * cfg.top_k * cfg.capacity_factor / cfg.num_experts)
    return max(8, -(-c // 8) * 8)


def route(params: dict, xt: Tensor, cfg: MoECfg) -> tuple:
    """xt (n, d) → (probs (n, E) fp32, gate_vals (n, k) renormalised over
    the top-k, expert_ids (n, k) int64), ties to the lower expert id."""
    logits = xt.float() @ params["router"].float()
    if cfg.router_softcap > 0.0:
        logits = cfg.router_softcap * torch.tanh(logits / cfg.router_softcap)
    probs = torch.softmax(logits, dim=-1)
    gate_vals, expert_ids = stable_topk(probs, cfg.top_k)
    gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True).clamp_min(1e-9)
    return probs, gate_vals, expert_ids


def _bin_and_dispatch(xt: Tensor, gate_vals: Tensor, expert_ids: Tensor,
                      E: int, C: int) -> tuple:
    """TOCAB binning: stable sort by expert, dense capacity slabs with
    compacted slots.  Returns the reference's ``(dispatched (E, C, d),
    slab_idx, sorted_token, sorted_gate, keep)`` and the sort's ``order``
    (sorted position → flat pair ``token * k + slot``), which the combine
    un-permutes with."""
    n, d = xt.shape
    k = expert_ids.shape[1]
    flat_expert = expert_ids.reshape(-1)
    se, order = torch.sort(flat_expert, stable=True)  # the binning pass
    st = torch.div(order, k, rounding_mode="floor")
    sg = gate_vals.reshape(-1)[order]
    pos = torch.arange(n * k, device=xt.device)
    bin_start = torch.searchsorted(
        se, torch.arange(E, dtype=se.dtype, device=xt.device))
    slot = pos - bin_start[se]
    keep = slot < C  # capacity drop (overflow falls back to the residual)
    slab_idx = torch.where(keep, se * C + slot,
                           torch.full_like(se, E * C))  # pad bucket
    dispatched = xt.new_zeros((E * C + 1, d))
    dispatched[slab_idx] = xt[st]
    return dispatched[:E * C].view(E, C, d), slab_idx, st, sg, keep, order


def _combine(expert_out: Tensor, slab_idx: Tensor, order: Tensor,
             sg: Tensor, keep: Tensor, n: int) -> Tensor:
    """Reduction phase: gate-weighted pair outputs put back at their flat
    (token, slot) place and summed over the ``k`` slots — in a fixed
    order, with no atomics."""
    E, C, d = expert_out.shape
    flat_out = expert_out.reshape(E * C, d)
    gathered = flat_out[slab_idx.clamp(0, E * C - 1)]
    gathered = torch.where(keep[:, None], gathered, 0.0)
    contrib = gathered * sg[:, None].to(gathered.dtype)
    per_pair = torch.empty_like(contrib).index_copy_(0, order, contrib)
    return per_pair.view(n, -1, d).sum(dim=1)


def _experts(params: dict, dispatched: Tensor, kind: str) -> Tensor:
    """Dense per-expert GEMMs over the (E, C, d) slab (the "subgraph
    processing" phase), weights cast to the slab's dtype."""
    dt = dispatched.dtype
    h_up = torch.bmm(dispatched, params["w_up"].to(dt))
    if kind in ("swiglu", "geglu"):
        g = torch.bmm(dispatched, params["w_gate"].to(dt))
        act = F.silu(g) if kind == "swiglu" else F.gelu(g,
                                                        approximate="tanh")
        h = act * h_up
    elif kind == "gelu":
        h = F.gelu(h_up, approximate="tanh")
    else:
        raise ValueError(f"unknown expert kind {kind!r}")
    return torch.bmm(h, params["w_down"].to(dt))


def _num_token_shards(n: int, mesh) -> int:
    """The reference's shard count for ``n`` tokens: the product of the
    mesh's ``("pod", "data")`` sizes when it divides ``n``, else 1 (and 1
    off a mesh)."""
    if mesh is None:
        return 1
    sizes = mesh_axis_sizes(mesh)
    s = math.prod(sizes.get(a, 1) for a in TOKEN_AXES)
    return s if (s > 1 and n % s == 0) else 1


def _moe_tokens(params: dict, xt: Tensor, cfg: MoECfg, shards: int,
                experts: tuple) -> tuple:
    """The block on ``xt`` (n, d), its tokens cut into ``shards`` equal
    shards binned one after the other, the expert GEMMs on experts
    ``experts = (first, count)`` of ``params``' (local) weights → (out
    (n, d) summed over those experts, top-1 counts (E,) fp32, router
    probability sums (E,) fp32)."""
    n, d = xt.shape
    E = cfg.num_experts
    probs, gate_vals, expert_ids = route(params, xt, cfg)
    counts = F.one_hot(expert_ids[:, 0], E).float().sum(dim=0)
    probsum = probs.sum(dim=0)
    n_l = n // shards
    C = _capacity(n_l, cfg)
    e_lo, e_n = experts
    outs = []
    for s in range(shards):
        rows = slice(s * n_l, (s + 1) * n_l)
        dispatched, slab, _, sg, keep, order = _bin_and_dispatch(
            xt[rows], gate_vals[rows], expert_ids[rows], E, C)
        if e_n < E:  # this rank's experts' slabs and pairs
            dispatched = dispatched[e_lo:e_lo + e_n]
            slab = slab - e_lo * C
            keep = keep & (slab >= 0) & (slab < e_n * C)
        expert_out = _experts(params, dispatched, cfg.kind)
        outs.append(_combine(expert_out, slab, order, sg, keep, n_l))
    out = outs[0] if shards == 1 else torch.cat(outs)
    return out, counts, probsum


def _switch_aux(counts, probsum, n_tokens: int, E: int):
    """E · Σ_e (counts(e) / n) · (probsum(e) / n)."""
    return E * torch.sum((counts / n_tokens) * (probsum / n_tokens))


def moe_block(params: dict, x: Tensor, cfg: MoECfg) -> tuple:
    """x (B, S, d) → (out (B, S, d) in x's dtype, Switch aux loss fp32)."""
    if cfg.dispatch not in DISPATCH_MODES:
        raise ValueError(f"dispatch must be one of {DISPATCH_MODES}, got "
                         f"{cfg.dispatch!r}")
    if isinstance(x, DTensor):
        return _moe_on_mesh(params, x, cfg)
    B, S, d = x.shape
    n = B * S
    E = cfg.num_experts
    mesh = current_mesh()
    blocks = mesh is not None and hasattr(mesh, "get_group")
    if blocks and cfg.dispatch == "global" \
            and _num_token_shards(n, mesh) > 1:
        raise ValueError(
            "dispatch='global' on a rank's block of the batch: the global "
            "sort needs every rank's tokens; run the model on DTensors "
            "(their tokens are gathered) or dispatch='sharded'")
    shards = 1 if blocks or cfg.dispatch == "global" else \
        _num_token_shards(n, mesh)
    out, counts, probsum = _moe_tokens(params, x.reshape(n, d), cfg, shards,
                                       (0, E))
    if blocks:  # the global batch's two means: Σ over the data ranks
        packed = all_reduce_sum(torch.cat([
            counts, probsum, torch.full((1,), float(n), device=x.device)]),
            mesh, TOKEN_AXES)
        counts, probsum, n = packed[:E], packed[E:2 * E], packed[2 * E]
    return out.reshape(B, S, d).to(x.dtype), _switch_aux(counts, probsum,
                                                         n, E)


def _moe_on_mesh(params: dict, x, cfg: MoECfg) -> tuple:
    """:func:`moe_block` on DTensors (the reference's ``capacity`` /
    ``experts`` placements): the tokens split over the batch axes (gathered
    for ``global``), whole over ``model``; each rank routes its tokens,
    bins its shard(s) and runs the GEMMs of its experts (``experts`` over
    ``model``, or its ``mlp`` block of every expert where the experts do
    not divide).  Its combine is then a summand over ``model``, and so is
    its router probability sum, which only ``model`` rank 0 contributes
    (the router's gradient through the combine is split over the ranks'
    experts, through the aux loss it is counted once)."""
    mesh = x.device_mesh
    B, S, d = x.shape
    n = B * S
    E = cfg.num_experts
    sharded = cfg.dispatch == "sharded"
    x_spec = ("batch", None, None) if sharded else (None, None, None)
    token_axes = spec_axes(x_spec, x.shape, mesh)
    split_tokens = math.prod(mesh_axis_sizes(mesh)[a] for a in token_axes)
    shards = (_num_token_shards(n, mesh) if sharded else 1) // split_tokens
    w_spec = {"w_up": ("experts", None, "mlp"),
              "w_gate": ("experts", None, "mlp"),
              "w_down": ("experts", "mlp", None), "router": (None, None)}
    up = logical_to_spec(w_spec["w_up"], params["w_up"].shape, mesh)
    tp = "model" in up
    e_n = E // mesh.size(mesh.mesh_dim_names.index("model")) \
        if up[0] == "model" else E
    e_lo = block_offset(mesh, "model", e_n) if up[0] == "model" else 0
    contributes = not tp or mesh.get_local_rank("model") == 0
    model = ("model",) if tp else ()
    names = sorted(params)

    def local(xl, *ws):
        out, counts, probsum = _moe_tokens(dict(zip(names, ws)),
                                           xl.reshape(-1, d), cfg, shards,
                                           (e_lo, e_n))
        if not contributes:
            probsum = probsum * 0.0
        return out.reshape(xl.shape).to(xl.dtype), counts, probsum

    def pl(spec, shape, partial=()):
        return placements_for(spec, shape, mesh, partial)

    vec = ((None,), (E,))
    out, counts, probsum = on_local_shards(
        local, mesh,
        out_placements=(pl(x_spec, x.shape, model),
                        pl(*vec, token_axes), pl(*vec, token_axes + model)),
        in_placements=[pl(x_spec, x.shape)] + [
            pl(w_spec[k], params[k].shape) for k in names],
        in_grad_placements=[pl(x_spec, x.shape, model)] + [
            pl(w_spec[k], params[k].shape,
               token_axes + (model if k == "router" else ()))
            for k in names])(x, *[params[k] for k in names])
    return shard(out, "batch", "seq", None), _switch_aux(counts, probsum,
                                                         n, E)
