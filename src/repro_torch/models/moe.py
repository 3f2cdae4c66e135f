"""Mixture-of-Experts layer of the port, with TOCAB-style sorted (binned)
dispatch: the reference's ``models/moe.py``.

The token→expert dispatch is a push-mode scatter: many tokens accumulate
into few expert bins.  It runs like the paper's push TOCAB (§3.1): *bin*
the (token, expert) pairs by destination expert with one stable sort, give
every expert a dense capacity slab of compacted slots, run dense
per-expert GEMMs (``torch.bmm`` over the expert axis), then un-permute and
combine — the reduction phase.  No (tokens × experts × capacity) one-hot
tensor is made.

The reference's two dispatch modes (``global``: one sort over all tokens;
``sharded``: one per data shard of a mesh) coincide on one card: off a
mesh the reference's ``sharded`` mode is one shard.  Both are accepted
here and both take the single bin pass; dispatch across ranks (token and
expert sharding) is ROADMAP A12b, and data-parallel training refuses a
mixture of experts (``transformer.loss_denominator``).

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

import torch
import torch.nn.functional as F

from repro_torch.dist.collectives import stable_topk

from .layers import _normal, init_dense

__all__ = ["MoECfg", "init_moe", "moe_block", "route"]

Tensor = torch.Tensor

#: the reference's dispatch modes; one card runs both as one bin pass
DISPATCH_MODES = ("global", "sharded")


@dataclasses.dataclass(frozen=True)
class MoECfg:
    d_model: int
    d_ff: int  # per-expert hidden
    num_experts: int
    top_k: int
    capacity_factor: float = 1.25
    kind: str = "swiglu"  # expert MLP kind
    router_softcap: float = 0.0
    dispatch: str = "sharded"  # global | sharded: one bin pass on one card


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
    gathered = flat_out[slab_idx.clamp(max=E * C - 1)]
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


def moe_block(params: dict, x: Tensor, cfg: MoECfg) -> tuple:
    """x (B, S, d) → (out (B, S, d) in x's dtype, Switch aux loss fp32)."""
    if cfg.dispatch not in DISPATCH_MODES:
        raise ValueError(f"dispatch must be one of {DISPATCH_MODES}, got "
                         f"{cfg.dispatch!r}")
    B, S, d = x.shape
    n = B * S
    E = cfg.num_experts
    xt = x.reshape(n, d)
    probs, gate_vals, expert_ids = route(params, xt, cfg)

    # Switch aux loss: E · Σ_e fraction_tokens(e) · mean_prob(e)
    frac = F.one_hot(expert_ids[:, 0], E).float().mean(dim=0)
    aux = E * torch.sum(frac * probs.mean(dim=0))

    C = _capacity(n, cfg)
    dispatched, slab, _, sg, keep, order = _bin_and_dispatch(
        xt, gate_vals, expert_ids, E, C)
    expert_out = _experts(params, dispatched, cfg.kind)
    combined = _combine(expert_out, slab, order, sg, keep, n)
    return combined.reshape(B, S, d).to(x.dtype), aux
