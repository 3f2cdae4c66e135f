"""Shared neural-net layers of the port (plain dicts of tensors, no
``nn.Module`` state): RMSNorm, RoPE, GQA attention with sliding-window /
logit-softcap / local-global patterns, SwiGLU / GeGLU / GELU MLPs.

Mirrors the reference's ``models/layers.py``: same names, same parameter
trees and layouts (``wq`` is ``(d, H, hd)``, ``wo`` is ``(H, hd, d)``), the
same dtype rules (weights cast to the activations' dtype at use; RMSNorm
and RoPE in fp32).  Attention goes through the port's kernels: the
prefill/forward path through :func:`~repro_torch.kernels.flash_attention.
attention` (the ``flash_attention`` kernel on the card) and the decode step
through :func:`~repro_torch.kernels.flash_attention.flash_decode`.
:func:`cross_entropy_loss` is the training loss; every function here is
differentiable (on the card the attention's gradient is the
``flash_attention_bwd`` kernel).

On a mesh the activations are DTensors and the reference's ``shard``
annotations are the placements each block runs at: the attention and MLP
blocks run on each rank's local shards (:func:`~repro_torch.dist.sharding.
on_local_shards`), entered with the tokens split over the batch axes and
replicated over ``model``, with ``wq`` / ``wk`` / ``wv`` / ``wo`` split by
``heads`` / ``kv_heads`` and the MLP's hidden units by ``mlp``, so that each
rank's q, k, v and ``h`` are its local heads and units, and the kernels see
local shapes.  The row-parallel products (``wo``, ``w_down``) leave each rank
a summand (``Partial`` over ``model``).  When ``kv_heads`` does not divide
by ``model`` the KV heads stay whole on every rank and each rank's q heads
read the global KV heads they map to.  :func:`rms_norm` runs as DTensor
ops; :func:`cross_entropy_loss` takes logits split over ``vocab`` or whole.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch.dist.sharding import (logical_to_spec, on_local_shards,
                                       placements_for)
from repro_torch.kernels.flash_attention import attention as attn_op
from repro_torch.kernels.flash_attention import flash_decode

__all__ = [
    "rms_norm", "rope", "init_dense", "dense", "cross_entropy_loss",
    "AttnCfg", "init_attention",
    "attention_block", "decode_attention_block", "init_mlp", "mlp_block",
    "kv_for_heads", "CACHE_AXES", "take_rows", "row_placements",
]

Tensor = torch.Tensor


def _normal(shape, generator: torch.Generator, device) -> Tensor:
    return torch.randn(shape, generator=generator, device=generator.device,
                       dtype=torch.float32).to(device)


# --------------------------------------------------------------------- #
# placements on a mesh
# --------------------------------------------------------------------- #
def mesh_of(x):
    """The ``DeviceMesh`` of a DTensor, None for a plain tensor."""
    return x.device_mesh if isinstance(x, DTensor) else None


def spec_axes(logical, shape, mesh) -> tuple:
    """The mesh axes that the rules give the first dimension named in
    ``logical`` (of ``shape``): ``()`` where it is replicated."""
    for name, entry in zip(logical, logical_to_spec(logical, shape, mesh)):
        if name is not None:
            if entry is None:
                return ()
            return (entry,) if isinstance(entry, str) else tuple(entry)
    return ()


def split_on(logical, shape, mesh, axis: str = "model") -> bool:
    """Whether a tensor of ``shape`` named ``logical`` is split over
    ``axis`` by the rules."""
    return any(axis == e or (isinstance(e, tuple) and axis in e)
               for e in logical_to_spec(logical, shape, mesh))


def block_offset(mesh, axis: str, size: int) -> int:
    """This rank's first index along a dimension of local ``size`` split
    over ``axis``."""
    return mesh.get_local_rank(axis) * size


def row_placements(*xs) -> tuple:
    """(mesh, placements) of the first DTensor among ``xs``: dim 0 split
    as it splits it, every other mesh axis replicated."""
    first = next(x for x in xs if isinstance(x, DTensor))
    return first.device_mesh, [Shard(0) if pl == Shard(0) else Replicate()
                               for pl in first.placements]


def take_rows(x: Tensor, idx: Tensor) -> Tensor:
    """``x[idx]``, rows of ``x`` picked by an index array.  On DTensors
    ``x`` is gathered whole on every rank and each rank picks the rows its
    block of ``idx`` names (the output is split as ``idx``, on dim 0); the
    gradient of ``x`` is then a summand over the axes that split ``idx``."""
    if not isinstance(x, DTensor) and not isinstance(idx, DTensor):
        return x[idx]
    mesh, rows = row_placements(idx, x)
    whole = [Replicate()] * mesh.ndim
    if not isinstance(idx, DTensor):
        rows = whole
    return on_local_shards(
        lambda xl, il: xl[il], mesh, out_placements=rows,
        in_placements=(whole, rows),
        in_grad_placements=([Partial() if pl == Shard(0) else Replicate()
                             for pl in rows], rows))(x, idx)


def like(y, x):
    """``y`` placed as ``x`` (a DTensor redistributed; else ``y``)."""
    if isinstance(y, DTensor) and isinstance(x, DTensor) \
            and y.placements != x.placements:
        return y.redistribute(x.device_mesh, x.placements)
    return y


# --------------------------------------------------------------------- #
# basics
# --------------------------------------------------------------------- #
def rms_norm(x: Tensor, gamma: Tensor, eps: float = 1e-6,
             plus_one: bool = False) -> Tensor:
    xf = x.float()
    y = xf * torch.rsqrt(xf.square().mean(dim=-1, keepdim=True) + eps)
    g = (1.0 + gamma) if plus_one else gamma  # gemma uses (1+w)
    return (y * g).to(x.dtype)


def rope(x: Tensor, positions: Tensor, theta: float = 10000.0) -> Tensor:
    """Rotary embedding.  x: (..., S, H, D); positions: (..., S)."""
    half = x.shape[-1] // 2
    freq = theta ** (-torch.arange(half, dtype=torch.float32,
                                   device=x.device) / half)
    angles = positions[..., None].float() * freq  # (..., S, half)
    angles = angles[..., None, :]  # broadcast over heads
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def init_dense(generator: torch.Generator, d_in: int, d_out: int,
               scale: Optional[float] = None, device=None) -> Tensor:
    scale = scale if scale is not None else d_in ** -0.5
    return _normal((d_in, d_out), generator, device) * scale


def dense(x: Tensor, w: Tensor) -> Tensor:
    return x @ w.to(x.dtype)


def cross_entropy_loss(logits: Tensor, labels: Tensor,
                       mask: Optional[Tensor] = None,
                       softcap: float = 0.0) -> Tensor:
    """Mean next-token CE.  logits (..., V) fp32; labels int (...,).
    DTensor logits (split over ``vocab`` or whole) take
    :func:`_cross_entropy_dtensor`."""
    if isinstance(logits, DTensor):
        return _cross_entropy_dtensor(logits, labels, mask, softcap)
    logits = logits.float()
    if softcap > 0.0:
        logits = softcap * torch.tanh(logits / softcap)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    nll = logz - gold
    if mask is not None:
        mask = mask.float()
        return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
    return nll.mean()


def _cross_entropy_dtensor(logits, labels, mask, softcap: float):
    """:func:`cross_entropy_loss` on a DTensor: the log-partition from the
    row max (no gradient through it, as ``logsumexp``) and Σ exp, which
    DTensor reduces over a split ``vocab``; the gold logit picked on the
    rank whose block holds the label (a summand over ``model``)."""
    mesh = logits.device_mesh
    logits = logits.float()
    if softcap > 0.0:
        logits = softcap * torch.tanh(logits / softcap)
    m = logits.detach().amax(dim=-1, keepdim=True)
    logz = (logits - m).exp().sum(dim=-1).log() + m[..., 0]
    nd = logits.ndim
    lg_spec = ("batch",) + (None,) * (nd - 2) + ("vocab",)
    lab_spec = ("batch",) + (None,) * (nd - 2)
    split = split_on(lg_spec, logits.shape, mesh)
    lg_pl = placements_for(lg_spec, logits.shape, mesh)

    def gold(lg, lab):
        v_loc = lg.shape[-1]
        lo = block_offset(mesh, "model", v_loc) if split else 0
        at = lab.long() - lo
        own = (at >= 0) & (at < v_loc)
        g = torch.gather(lg, -1, at.clamp(0, v_loc - 1)[..., None])[..., 0]
        return torch.where(own, g, 0.0)

    gold_logit = on_local_shards(
        gold, mesh,
        out_placements=placements_for(lab_spec, labels.shape, mesh,
                                      ("model",) if split else ()),
        in_placements=(lg_pl, placements_for(lab_spec, labels.shape, mesh)),
        in_grad_placements=(lg_pl, None))(logits, labels)
    nll = logz - gold_logit
    if mask is not None:
        mask = mask.float()
        return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
    return nll.mean()


# --------------------------------------------------------------------- #
# attention (GQA + RoPE + sliding window + softcap)
# --------------------------------------------------------------------- #
@dataclasses.dataclass(frozen=True)
class AttnCfg:
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    rope_theta: float = 10000.0
    window: int = 0  # 0 = global
    softcap: float = 0.0
    causal: bool = True
    scale: Optional[float] = None  # None → head_dim**-0.5


def init_attention(generator: torch.Generator, cfg: AttnCfg,
                   device=None) -> dict:
    d, H, Hk, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    return {
        "wq": _normal((d, H, hd), generator, device) * d ** -0.5,
        "wk": _normal((d, Hk, hd), generator, device) * d ** -0.5,
        "wv": _normal((d, Hk, hd), generator, device) * d ** -0.5,
        "wo": _normal((H, hd, d), generator, device) * (H * hd) ** -0.5,
    }


def _proj(x: Tensor, w: Tensor) -> Tensor:
    """(B, S, d) × (d, H, hd) → (B, S, H, hd)."""
    d, H, hd = w.shape
    return (x @ w.reshape(d, H * hd).to(x.dtype)).unflatten(-1, (H, hd))


def _qkv(params: dict, x: Tensor, positions: Tensor, cfg: AttnCfg):
    q = rope(_proj(x, params["wq"]), positions, cfg.rope_theta)
    k = rope(_proj(x, params["wk"]), positions, cfg.rope_theta)
    v = _proj(x, params["wv"])
    return q, k, v


def _out_proj(params: dict, o: Tensor, dtype) -> Tensor:
    """(B, H, S, hd) → (B, S, d) through ``wo``."""
    H, hd, d = params["wo"].shape
    o = o.transpose(1, 2).reshape(o.shape[0], o.shape[2], H * hd)
    return o @ params["wo"].reshape(H * hd, d).to(dtype)


def attention_block(
    params: dict,
    x: Tensor,  # (B, S, d)
    positions: Tensor,  # (B, S)
    cfg: AttnCfg,
    backend: Optional[str] = None,
) -> Tensor:
    if isinstance(x, DTensor):
        return _attention_on_mesh(params, x, positions, cfg, backend)
    q, k, v = _qkv(params, x, positions, cfg)
    o = attn_op(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),  # (B,H,S,hd)
        scale=cfg.scale, causal=cfg.causal, window=cfg.window,
        softcap=cfg.softcap, backend=backend,
    )
    return _out_proj(params, o, x.dtype)


def kv_for_heads(k: Tensor, v: Tensor, h0: int, n_q: int, group: int):
    """The KV heads that q heads ``h0 … h0 + n_q - 1`` read, (B, *, S, D)
    each: ``k``/``v`` themselves when they are those heads' own block (a
    local ``kv_heads`` shard, or every head), else the global heads
    ``h // group`` picked from whole ``k``/``v``: a slice when the picked
    heads serve equal runs of q heads (GQA at a smaller group), else one KV
    head per q head."""
    if k.shape[1] * group == n_q:
        return k, v
    idx = [(h0 + j) // group for j in range(n_q)]
    lo, hi = idx[0], idx[-1] + 1
    run = n_q // (hi - lo)
    if n_q % (hi - lo) == 0 and idx == [lo + j // run
                                         for j in range(n_q)]:
        return k[:, lo:hi], v[:, lo:hi]
    at = torch.tensor(idx, device=k.device)
    return k.index_select(1, at), v.index_select(1, at)


def _attn_placements(params: dict, x, mesh) -> dict:
    """What the attention block runs at on ``mesh``: x split over the batch
    axes and whole over ``model``; ``wq``/``wo`` by ``heads``, ``wk``/``wv``
    by ``kv_heads`` (their ``fsdp`` dimension gathered); the local
    gradients: a weight's a summand over the batch axes, x's a summand
    over ``model`` when the heads are split."""
    xs = ("batch",) + (None,) * (x.ndim - 1)
    batch = spec_axes(xs, x.shape, mesh)
    heads = split_on((None, "heads", None), params["wq"].shape, mesh)
    kv = split_on((None, "kv_heads", None), params["wk"].shape, mesh)

    def w(spec, shape, grad_partial=()):
        return (placements_for(spec, shape, mesh),
                placements_for(spec, shape, mesh, batch + grad_partial))

    wq = w((None, "heads", None), params["wq"].shape)
    wkv = w((None, "kv_heads", None), params["wk"].shape,
            ("model",) if heads and not kv else ())
    wo = w(("heads", None, None), params["wo"].shape)
    model = ("model",) if heads else ()
    return {"x": (placements_for(xs, x.shape, mesh),
                  placements_for(xs, x.shape, mesh, model)),
            "wq": wq, "wk": wkv, "wv": wkv, "wo": wo, "heads": heads,
            "out": placements_for(xs, x.shape, mesh, model)}


def _local_heads(mesh, heads: bool, H: int) -> tuple:
    """(first q head, q heads) of this rank."""
    if not heads:
        return 0, H
    n = H // mesh.size(mesh.mesh_dim_names.index("model"))
    return block_offset(mesh, "model", n), n


def _attention_on_mesh(params: dict, x, positions, cfg: AttnCfg, backend):
    """:func:`attention_block` on DTensors: q/k/v, the attention kernel
    and the ``wo`` product on this rank's local heads and batch block;
    the output a summand over ``model`` when the heads are split."""
    mesh = x.device_mesh
    pl = _attn_placements(params, x, mesh)
    h0, n_q = _local_heads(mesh, pl["heads"], cfg.n_heads)
    group = cfg.n_heads // cfg.n_kv_heads
    names = ("x", "wq", "wk", "wv", "wo")

    def local(xl, wq, wk, wv, wo):
        q, k, v = _qkv({"wq": wq, "wk": wk, "wv": wv}, xl, positions, cfg)
        k, v = kv_for_heads(k.transpose(1, 2), v.transpose(1, 2), h0, n_q,
                            group)
        o = attn_op(q.transpose(1, 2), k, v, scale=cfg.scale,
                    causal=cfg.causal, window=cfg.window,
                    softcap=cfg.softcap, backend=backend)
        return _out_proj({"wo": wo}, o, xl.dtype)

    return on_local_shards(
        local, mesh, out_placements=pl["out"],
        in_placements=[pl[n][0] for n in names],
        in_grad_placements=[pl[n][1] for n in names])(
        x, params["wq"], params["wk"], params["wv"], params["wo"])


def decode_attention_block(
    params: dict,
    x: Tensor,  # (B, 1, d) — one new token
    pos: int,  # current position
    k_cache: Tensor,  # (B, Hkv, S_max, hd)
    v_cache: Tensor,
    cfg: AttnCfg,
) -> tuple:
    """One decode step against a KV cache (the serving hot path).

    The new K/V are written **in place** into slot ``pos % S_max`` of the
    caches (the reference returns updated copies); the caches are returned
    too.  Sliding-window layers keep a ring buffer of ``S_max =
    min(window, horizon)`` slots whose write index wraps.

    The attention is :func:`flash_decode` over the first ``kv_len =
    min(pos + 1, S_max)`` slots, which is exactly the reference's
    ring-aware mask (slot ``i`` valid iff its absolute position lies in
    ``[0, pos]`` and, for a window, within ``window`` of ``pos``):

    * before the ring wraps (``pos < S_max``) slot ``i`` holds position
      ``i``, so the valid slots are ``i ≤ pos`` — a prefix of ``pos + 1``;
      a window cannot cut it, since ``pos - i < S_max ≤ window``;
    * a ring wraps only when ``S_max`` is the window; after that every
      slot holds one of the last ``S_max`` positions, all inside the
      window, so all ``S_max`` slots are valid (in ring order, which the
      softmax does not see: RoPE was applied before the write);
    * a global cache (``window = 0``) holds the whole horizon.

    A windowed cache longer than the window (whose valid slots would not be
    a prefix) is refused."""
    S_max = k_cache.shape[2]
    if cfg.window > 0 and S_max > cfg.window:
        raise ValueError(
            f"a windowed cache must hold at most window={cfg.window} slots, "
            f"got {S_max}: its valid slots would not be a prefix")
    if isinstance(x, DTensor):
        return _decode_attention_on_mesh(params, x, pos, k_cache, v_cache,
                                         cfg)
    B = x.shape[0]
    positions = torch.full((B, 1), pos, dtype=torch.int64, device=x.device)
    q, k_new, v_new = _qkv(params, x, positions, cfg)  # (B, 1, H, hd)
    slot = pos % S_max
    k_cache[:, :, slot].copy_(k_new[:, 0])
    v_cache[:, :, slot].copy_(v_new[:, 0])
    o = flash_decode(q.transpose(1, 2), k_cache, v_cache, scale=cfg.scale,
                     kv_len=min(pos + 1, S_max),
                     softcap=cfg.softcap)  # (B, H, 1, hd) in x.dtype
    return _out_proj(params, o, x.dtype), k_cache, v_cache


CACHE_AXES = ("batch", "kv_heads", None, None)


def _decode_attention_on_mesh(params: dict, x, pos: int, k_cache, v_cache,
                              cfg: AttnCfg) -> tuple:
    """:func:`decode_attention_block` on DTensors: each rank writes its
    local KV heads' new K/V into its block of the caches (DTensors placed
    by :data:`CACHE_AXES`, written in place) and runs ``flash_decode`` on
    its local q heads over the KV heads they read."""
    mesh = x.device_mesh
    cache_pl = placements_for(CACHE_AXES, k_cache.shape, mesh)
    for c in (k_cache, v_cache):
        if not isinstance(c, DTensor) or list(c.placements) != cache_pl:
            raise ValueError(f"a decode step on a mesh wants the KV caches "
                             f"as DTensors placed {cache_pl} (CACHE_AXES), "
                             f"got {getattr(c, 'placements', type(c))}")
    pl = _attn_placements(params, x, mesh)
    h0, n_q = _local_heads(mesh, pl["heads"], cfg.n_heads)
    group = cfg.n_heads // cfg.n_kv_heads

    def local(xl, wq, wk, wv, wo, kc, vc):
        S_max = kc.shape[2]
        positions = torch.full((xl.shape[0], 1), pos, dtype=torch.int64,
                               device=xl.device)
        q, k_new, v_new = _qkv({"wq": wq, "wk": wk, "wv": wv}, xl,
                               positions, cfg)
        kc[:, :, pos % S_max].copy_(k_new[:, 0])
        vc[:, :, pos % S_max].copy_(v_new[:, 0])
        k, v = kv_for_heads(kc, vc, h0, n_q, group)
        o = flash_decode(q.transpose(1, 2), k.contiguous(), v.contiguous(),
                         scale=cfg.scale, kv_len=min(pos + 1, S_max),
                         softcap=cfg.softcap)
        return _out_proj({"wo": wo}, o, xl.dtype)

    names = ("x", "wq", "wk", "wv", "wo")
    out = on_local_shards(
        local, mesh, out_placements=pl["out"],
        in_placements=[pl[n][0] for n in names] + [cache_pl, cache_pl])(
        x, params["wq"], params["wk"], params["wv"], params["wo"],
        k_cache, v_cache)
    return out, k_cache, v_cache


# --------------------------------------------------------------------- #
# MLP (SwiGLU / GeGLU / plain GELU)
# --------------------------------------------------------------------- #
def init_mlp(generator: torch.Generator, d_model: int, d_ff: int,
             kind: str = "swiglu", device=None) -> dict:
    p = {
        "w_up": init_dense(generator, d_model, d_ff, device=device),
        "w_down": init_dense(generator, d_ff, d_model, device=device),
    }
    if kind in ("swiglu", "geglu"):
        p["w_gate"] = init_dense(generator, d_model, d_ff, device=device)
    return p


def mlp_block(params: dict, x: Tensor, kind: str = "swiglu") -> Tensor:
    """The MLP; on DTensors each rank runs its block of the hidden units
    (``mlp``, the reference's ``shard(h, "batch", "seq", "mlp")``) and its
    ``w_down`` product is a summand over ``model``."""
    if isinstance(x, DTensor):
        return _mlp_on_mesh(params, x, kind)
    return _mlp_local(params, x, kind)


def _mlp_on_mesh(params: dict, x, kind: str):
    mesh = x.device_mesh
    xs = ("batch",) + (None,) * (x.ndim - 1)
    batch = spec_axes(xs, x.shape, mesh)
    split = split_on((None, "mlp"), params["w_up"].shape, mesh)
    model = ("model",) if split else ()
    names = sorted(params)
    specs = {"w_up": (None, "mlp"), "w_gate": (None, "mlp"),
             "w_down": ("mlp", None)}

    def local(xl, *ws):
        return _mlp_local(dict(zip(names, ws)), xl, kind)

    return on_local_shards(
        local, mesh, out_placements=placements_for(xs, x.shape, mesh, model),
        in_placements=[placements_for(xs, x.shape, mesh)] + [
            placements_for(specs[n], params[n].shape, mesh) for n in names],
        in_grad_placements=[placements_for(xs, x.shape, mesh, model)] + [
            placements_for(specs[n], params[n].shape, mesh, batch)
            for n in names])(x, *[params[n] for n in names])


def _mlp_local(params: dict, x: Tensor, kind: str) -> Tensor:
    up = dense(x, params["w_up"])
    if kind == "swiglu":
        h = F.silu(dense(x, params["w_gate"])) * up
    elif kind == "geglu":
        h = F.gelu(dense(x, params["w_gate"]), approximate="tanh") * up
    elif kind == "gelu":
        h = F.gelu(up, approximate="tanh")
    else:
        raise ValueError(f"unknown mlp kind {kind!r}")
    return dense(h, params["w_down"])
