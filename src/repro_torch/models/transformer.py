"""Decoder-only LM of the port: the reference's ``models/transformer.py``
(GQA, RoPE, SwiGLU/GeGLU, RMSNorm with the gemma ``1+γ`` form,
sliding-window layers, alternating local/global layers, attention and
final logit soft-capping, tied embeddings, MoE layers with TOCAB-binned
dispatch for Granite and Mixtral).

Entry points: :func:`init_params`, :func:`forward`, :func:`loss_fn` (the
training loss), :func:`serve_prefill`, :func:`init_cache`,
:func:`serve_decode`.  Parameters are a dict of
tensors shaped as the reference's tree, except that the layers are a list
of per-layer dicts instead of arrays stacked on a leading axis (the
reference stacks them for ``lax.scan``; here the layers run in a Python
loop).  :func:`params_from_numpy` turns the reference's stacked tree into
this form, so both packages compute the same function in the tests.

Dtypes follow the reference: fp32 master weights, cast to
``compute_dtype`` at use; fp32 RMSNorm, RoPE and unembed; a bf16 cache by
default.  :func:`cast_params` makes a ``compute_dtype`` copy of the
matmul weights once at load (the same values as a cast at every use); the
serving loop runs on it.  The MoE router stays fp32, as the reference runs
it.

A mixture-of-experts layer (``num_experts > 0``) holds a ``"moe"`` subtree
(:mod:`.moe`) in place of ``"mlp"``; :func:`forward` returns the sum of its
layers' Switch aux losses, and :func:`serve_decode` dispatches globally, as
the reference's decode does.

On a mesh the entry points take DTensors: parameters placed by
:func:`param_logical_axes` (``place_tree``), tokens split over the batch
axes, KV caches from ``init_cache(..., mesh=)``.  The reference's ``shard``
calls are the placements between blocks: tokens by ``batch``, the
embedding's output by ``embed`` (the residual stream split over ``model`` on
its hidden dimension), the logits by ``vocab``.  The embedding and the
unembedding run on each rank's block of the table (``vocab`` over
``model``; a vocabulary that does not divide stays whole on every rank).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.dist.sharding import (on_local_shards, place_tree,
                                       placements_for, shard)

from .layers import (CACHE_AXES, AttnCfg, _normal, attention_block,
                     block_offset, cross_entropy_loss,
                     decode_attention_block, init_attention, init_mlp, like,
                     mesh_of, mlp_block, rms_norm, spec_axes, split_on)
from .moe import MoECfg, init_moe, moe_block

__all__ = ["TransformerCfg", "KVCache", "init_params", "cast_params",
           "params_from_numpy", "param_logical_axes", "forward", "loss_fn",
           "loss_denominator",
           "serve_prefill",
           "serve_decode",
           "cache_len", "init_cache", "param_count", "default_device"]

Tensor = torch.Tensor

#: matmul weights, the ones :func:`cast_params` keeps in compute_dtype
_MATMUL_WEIGHTS = ("wq", "wk", "wv", "wo", "w_up", "w_gate", "w_down")


def default_device() -> torch.device:
    """The card: entry points put data there unless the caller asks for
    another device."""
    return torch.device("cuda")


@dataclasses.dataclass(frozen=True)
class TransformerCfg:
    """The reference's config, field for field.  ``remat``,
    ``remat_policy`` and ``use_scan`` are accepted and change nothing:
    they steer JAX's rematerialisation and ``lax.scan`` over layers, and
    the port runs eagerly, one layer after the other, keeping every
    layer's activations for the backward pass (no recomputation; PERF.md
    gives the peak memory of the full-width step).  ``moe_aux_coef``
    weighs the MoE aux loss in :func:`loss_fn`."""
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab: int
    mlp_kind: str = "swiglu"
    rope_theta: float = 10000.0
    # attention pattern: "global" | "window" | "alternating" (local, global, …)
    layer_pattern: str = "global"
    window: int = 0
    attn_softcap: float = 0.0
    final_softcap: float = 0.0
    attn_scale: Optional[float] = None
    norm_plus_one: bool = False  # gemma-style (1+γ) RMSNorm
    embed_scale: bool = False  # gemma multiplies embeddings by sqrt(d)
    tie_embeddings: bool = True
    num_experts: int = 0
    top_k: int = 0
    moe_aux_coef: float = 0.01
    capacity_factor: float = 1.25
    moe_dispatch: str = "sharded"
    remat: bool = True
    remat_policy: str = "full"
    compute_dtype: str = "bfloat16"
    use_scan: bool = True

    @property
    def is_moe(self) -> bool:
        return self.num_experts > 0

    @property
    def pair_scan(self) -> bool:
        return self.layer_pattern == "alternating"

    @property
    def dtype(self) -> torch.dtype:
        return getattr(torch, self.compute_dtype)

    def attn_cfg(self, local: bool) -> AttnCfg:
        if self.layer_pattern == "global":
            window = 0
        elif self.layer_pattern == "window":
            window = self.window
        else:  # alternating
            window = self.window if local else 0
        return AttnCfg(
            d_model=self.d_model, n_heads=self.n_heads,
            n_kv_heads=self.n_kv_heads, head_dim=self.head_dim,
            rope_theta=self.rope_theta, window=window,
            softcap=self.attn_softcap, causal=True, scale=self.attn_scale,
        )

    def layer_is_local(self, i: int) -> bool:
        """Layer ``i``'s attention: the even layers of an ``alternating``
        model are local (windowed), the odd ones global."""
        return not (self.pair_scan and i % 2)

    def moe_cfg(self) -> MoECfg:
        return MoECfg(
            d_model=self.d_model, d_ff=self.d_ff,
            num_experts=self.num_experts, top_k=self.top_k,
            capacity_factor=self.capacity_factor, kind=self.mlp_kind,
            dispatch=self.moe_dispatch,
        )

    def param_count(self) -> int:
        d, f, V, L = self.d_model, self.d_ff, self.vocab, self.n_layers
        attn = d * self.head_dim * (self.n_heads * 2 + self.n_kv_heads * 2)
        gates = 3 if self.mlp_kind in ("swiglu", "geglu") else 2
        ffn = gates * d * f * (self.num_experts if self.is_moe else 1)
        ffn += d * self.num_experts if self.is_moe else 0
        return L * (attn + ffn + 2 * d) + V * d + d

    def active_param_count(self) -> int:
        """Parameters a token meets: ``top_k`` experts of each MoE layer
        (and its router), the rest as :meth:`param_count`."""
        if not self.is_moe:
            return self.param_count()
        d, f, L = self.d_model, self.d_ff, self.n_layers
        gates = 3 if self.mlp_kind in ("swiglu", "geglu") else 2
        attn = d * self.head_dim * (self.n_heads * 2 + self.n_kv_heads * 2)
        ffn = gates * d * f * self.top_k + d * self.num_experts
        return L * (attn + ffn + 2 * d) + self.vocab * d + d


def _check_layers(cfg: TransformerCfg):
    if cfg.pair_scan and cfg.n_layers % 2:
        raise ValueError("an alternating model needs an even layer count")


# --------------------------------------------------------------------- #
# params
# --------------------------------------------------------------------- #
def _norm_weight(cfg: TransformerCfg, device) -> Tensor:
    fill = torch.zeros if cfg.norm_plus_one else torch.ones
    return fill(cfg.d_model, dtype=torch.float32, device=device)


def _init_ffn(generator: torch.Generator, cfg: TransformerCfg,
              device) -> dict:
    if cfg.is_moe:
        return {"moe": init_moe(generator, cfg.moe_cfg(), device)}
    return {"mlp": init_mlp(generator, cfg.d_model, cfg.d_ff, cfg.mlp_kind,
                            device)}


def init_params(cfg: TransformerCfg, generator: torch.Generator,
                device=None) -> dict:
    """Random fp32 parameters drawn from ``generator`` (on its own device,
    then moved to ``device``, the card by default), scaled as the
    reference's ``init_params``.  The numbers differ from the reference's
    (another generator); :func:`params_from_numpy` carries those over."""
    _check_layers(cfg)
    device = default_device() if device is None else torch.device(device)
    layers = []
    for _ in range(cfg.n_layers):
        layers.append({
            "ln_attn": _norm_weight(cfg, device),
            "ln_mlp": _norm_weight(cfg, device),
            "attn": init_attention(generator, cfg.attn_cfg(local=True),
                                   device),
            **_init_ffn(generator, cfg, device),
        })
    params = {
        "embed": _normal((cfg.vocab, cfg.d_model), generator, device)
        * cfg.d_model ** -0.5,
        "ln_final": _norm_weight(cfg, device),
        "layers": layers,
    }
    if not cfg.tie_embeddings:
        params["unembed"] = _normal((cfg.vocab, cfg.d_model), generator,
                                    device) * cfg.d_model ** -0.5
    return params


def params_from_numpy(tree: dict, cfg: TransformerCfg, device=None) -> dict:
    """The reference's ``init_params`` tree, as numpy arrays (layers stacked
    on a leading axis; ``alternating`` layers restacked ``(L/2, 2, …)``),
    as the port's parameters on ``device`` (the card by default)."""
    _check_layers(cfg)
    device = default_device() if device is None else torch.device(device)

    def tensor(a):
        return torch.from_numpy(np.array(a, dtype=np.float32)).to(device)

    def layer(i):
        def pick(a):
            a = np.asarray(a)
            return a[i // 2, i % 2] if cfg.pair_scan else a[i]
        lay = tree["layers"]
        ffn = "moe" if cfg.is_moe else "mlp"
        return {
            "ln_attn": tensor(pick(lay["ln_attn"])),
            "ln_mlp": tensor(pick(lay["ln_mlp"])),
            "attn": {n: tensor(pick(w)) for n, w in lay["attn"].items()},
            ffn: {n: tensor(pick(w)) for n, w in lay[ffn].items()},
        }

    params = {"embed": tensor(tree["embed"]),
              "ln_final": tensor(tree["ln_final"]),
              "layers": [layer(i) for i in range(cfg.n_layers)]}
    if "unembed" in tree:
        params["unembed"] = tensor(tree["unembed"])
    return params


def param_logical_axes(cfg: TransformerCfg) -> dict:
    """Logical sharding axes of each parameter, shaped as the port's tree:
    the reference's ``param_logical_axes`` with its leading ``layers`` (or
    ``("layers", None)``) entry dropped, one dict a layer.  ``fsdp`` is the
    data axis (``AXIS_RULES``)."""
    layer = {"ln_attn": (None,), "ln_mlp": (None,),
             "attn": {"wq": ("fsdp", "heads", None),
                      "wk": ("fsdp", "kv_heads", None),
                      "wv": ("fsdp", "kv_heads", None),
                      "wo": ("heads", None, "fsdp")}}
    gated = cfg.mlp_kind in ("swiglu", "geglu")
    if cfg.is_moe:
        moe = {"router": ("fsdp", None),
               "w_up": ("experts", "fsdp", "mlp"),
               "w_down": ("experts", "mlp", "fsdp")}
        if gated:
            moe["w_gate"] = ("experts", "fsdp", "mlp")
        layer["moe"] = moe
    else:
        mlp = {"w_up": ("fsdp", "mlp"), "w_down": ("mlp", "fsdp")}
        if gated:
            mlp["w_gate"] = ("fsdp", "mlp")
        layer["mlp"] = mlp
    tree = {"embed": ("vocab", "fsdp"), "ln_final": (None,),
            "layers": [dict(layer) for _ in range(cfg.n_layers)]}
    if not cfg.tie_embeddings:
        tree["unembed"] = ("vocab", "fsdp")
    return tree


def cast_params(params: dict, cfg: TransformerCfg) -> dict:
    """A copy of ``params`` whose matmul weights are in ``compute_dtype``,
    made once at load; norms and the (un)embedding tables stay fp32, as the
    reference uses them.  Forward and decode give the same results on it as
    on ``params``: they would cast the same weights at every use."""
    def cast(tree):
        return {n: (cast(w) if isinstance(w, dict)
                    else w.to(cfg.dtype) if n in _MATMUL_WEIGHTS else w)
                for n, w in tree.items()}
    out = {n: w for n, w in params.items() if n != "layers"}
    out["layers"] = [cast(p) for p in params["layers"]]
    return out


def param_count(params: dict) -> int:
    """Number of parameters in ``params`` (equals ``cfg.param_count()``)."""
    def count(tree):
        if isinstance(tree, dict):
            return sum(count(v) for v in tree.values())
        if isinstance(tree, list):
            return sum(count(v) for v in tree)
        return tree.numel()
    return count(params)


# --------------------------------------------------------------------- #
# forward (prefill)
# --------------------------------------------------------------------- #
def _ffn(p, h, cfg: TransformerCfg, dispatch: Optional[str] = None):
    """The layer's MLP or MoE block on ``h`` → (out, aux); ``dispatch``
    overrides the config's MoE dispatch mode."""
    if cfg.is_moe:
        mcfg = cfg.moe_cfg()
        if dispatch is not None:
            mcfg = dataclasses.replace(mcfg, dispatch=dispatch)
        return moe_block(p["moe"], h, mcfg)
    return mlp_block(p["mlp"], h, cfg.mlp_kind), None


def _layer_apply(p, x, positions, cfg: TransformerCfg, local: bool):
    """One layer → (x, the layer's aux loss or None for a dense layer).
    On a mesh each block's summands are added into the residual stream at
    its placement."""
    acfg = cfg.attn_cfg(local)
    h = rms_norm(x, p["ln_attn"], plus_one=cfg.norm_plus_one)
    x = x + like(attention_block(p["attn"], h, positions, acfg), x)
    h = rms_norm(x, p["ln_mlp"], plus_one=cfg.norm_plus_one)
    y, aux = _ffn(p, h, cfg)
    return x + like(y, x), aux


def _table_placements(table, x_spec, x_shape, mesh) -> tuple:
    """(table in, table grad, whether ``vocab`` is split) for a block that
    reads the (un)embedding table on ``mesh``: rows by ``vocab``, its
    ``fsdp`` dimension gathered, its gradient a summand over the batch
    axes that split ``x``."""
    spec = ("vocab", None)
    batch = spec_axes(x_spec, x_shape, mesh)
    return (placements_for(spec, table.shape, mesh),
            placements_for(spec, table.shape, mesh, batch),
            split_on(spec, table.shape, mesh))


def _embed(params, tokens, cfg: TransformerCfg):
    mesh = mesh_of(tokens)
    if mesh is None:
        return _embed_rows(params["embed"], tokens, cfg)
    table = params["embed"]
    t_spec = ("batch",) + (None,) * (tokens.ndim - 1)
    t_in, t_grad, split = _table_placements(table, t_spec, tokens.shape,
                                            mesh)

    def local(tab, tok):
        if not split:
            return _embed_rows(tab, tok, cfg)
        lo = block_offset(mesh, "model", tab.shape[0])
        at = tok.long() - lo
        own = (at >= 0) & (at < tab.shape[0])
        x = _embed_rows(tab, at.clamp(0, tab.shape[0] - 1), cfg)
        return torch.where(own[..., None], x, torch.zeros((), dtype=x.dtype,
                                                          device=x.device))

    x_spec = t_spec + (None,)
    x_shape = tuple(tokens.shape) + (cfg.d_model,)
    return on_local_shards(
        local, mesh,
        out_placements=placements_for(x_spec, x_shape, mesh,
                                      ("model",) if split else ()),
        in_placements=(t_in, placements_for(t_spec, tokens.shape, mesh)),
        in_grad_placements=(t_grad, None))(table, tokens)


def _embed_rows(table, tokens, cfg: TransformerCfg):
    x = table[tokens]
    if cfg.embed_scale:
        x = x * cfg.d_model ** 0.5
    return x.to(cfg.dtype)


def _unembed(params, x, cfg: TransformerCfg):
    table = params["embed"] if cfg.tie_embeddings else params["unembed"]
    mesh = mesh_of(x)
    if mesh is None:
        return _logits(x, table, cfg)
    x_spec = ("batch",) + (None,) * (x.ndim - 1)
    t_in, t_grad, split = _table_placements(table, x_spec, x.shape, mesh)
    out_spec = x_spec[:-1] + ("vocab",)
    out_shape = tuple(x.shape[:-1]) + (table.shape[0],)
    model = ("model",) if split else ()
    return on_local_shards(
        lambda xl, tab: _logits(xl, tab, cfg), mesh,
        out_placements=placements_for(out_spec, out_shape, mesh),
        in_placements=(placements_for(x_spec, x.shape, mesh), t_in),
        in_grad_placements=(placements_for(x_spec, x.shape, mesh, model),
                            t_grad))(x, table)


def _logits(x, table, cfg: TransformerCfg):
    logits = x.float() @ table.float().T
    if cfg.final_softcap > 0.0:
        logits = cfg.final_softcap * torch.tanh(logits / cfg.final_softcap)
    return logits


def _hidden(params, tokens, cfg: TransformerCfg):
    """→ (final normed hidden states, summed aux loss fp32).  On a mesh
    (DTensor tokens) the positions are one row, broadcast over each rank's
    batch block."""
    _check_layers(cfg)
    B, S = tokens.shape
    tokens = shard(tokens, "batch", None)
    positions = torch.arange(S, device=tokens.device)[None]
    if mesh_of(tokens) is None:
        positions = positions.expand(B, S)
    x = shard(_embed(params, tokens, cfg), "batch", None, "embed")
    aux = None
    for i, p in enumerate(params["layers"]):
        x, a = _layer_apply(p, x, positions, cfg, cfg.layer_is_local(i))
        if a is not None:
            aux = a if aux is None else aux + a
    if aux is None:
        aux = torch.zeros((), device=tokens.device)
    return rms_norm(x, params["ln_final"], plus_one=cfg.norm_plus_one), aux


def forward(params: dict, tokens: Tensor, cfg: TransformerCfg) -> tuple:
    """tokens (B, S) → (logits (B, S, V) fp32, the layers' summed MoE aux
    loss, 0.0 for a dense model).  The attention of every layer goes
    through the ``flash_attention`` kernel on the card, through its plain
    version on the CPU."""
    x, aux = _hidden(params, tokens, cfg)
    return shard(_unembed(params, x, cfg), "batch", None, "vocab"), aux


def loss_fn(params: dict, batch: dict, cfg: TransformerCfg) -> tuple:
    """batch = {tokens (B, S+1), loss_mask optional} → (loss, metrics):
    next-token CE plus ``moe_aux_coef`` × the MoE aux loss."""
    tokens = batch["tokens"]
    logits, aux = forward(params, tokens[:, :-1], cfg)
    labels = tokens[:, 1:]
    mask = batch.get("loss_mask")
    mask = mask[:, 1:] if mask is not None else None
    ce = cross_entropy_loss(logits, labels, mask)
    loss = ce + cfg.moe_aux_coef * aux
    return loss, {"ce": ce, "moe_aux": aux}


def loss_denominator(batch: dict, cfg: TransformerCfg) -> Tensor:
    """The count :func:`loss_fn`'s mean divides by on ``batch``: its target
    tokens, or the ``loss_mask``'s sum over them (a data-parallel step
    weighs the ranks' losses by it).  A mixture of experts' load-balancing
    loss is the global batch's on every rank already (:mod:`.moe`
    all-reduces its two means' numerators and counts), so the count weighs
    its cross-entropy alone."""
    mask = batch.get("loss_mask")
    if mask is None:
        return torch.tensor(float(batch["tokens"][:, 1:].numel()))
    return mask[:, 1:].float().sum()


def serve_prefill(params: dict, tokens: Tensor, cfg: TransformerCfg
                  ) -> Tensor:
    """Prefill: the full forward, returning last-position logits (B, V).
    Only the last position is unembedded (the same values as the
    reference's ``forward(...)[:, -1]``)."""
    x, _ = _hidden(params, tokens, cfg)
    return _unembed(params, x[:, -1, :], cfg)


# --------------------------------------------------------------------- #
# serving: decode with ring-buffer KV caches
# --------------------------------------------------------------------- #
@dataclasses.dataclass
class KVCache:
    """Stacked caches, ``(n, B, Hkv, S, hd)``.  For ``alternating`` the
    local half (``k``, ``v``) is a ring of ``min(window, horizon)`` slots
    and the global half (``k2``, ``v2``) holds the full horizon; layer
    ``2j`` uses ``k[j]``, layer ``2j+1`` uses ``k2[j]``."""
    k: Tensor
    v: Tensor
    k2: Optional[Tensor] = None
    v2: Optional[Tensor] = None

    def layer(self, i: int, cfg: TransformerCfg) -> tuple:
        """Layer ``i``'s (k, v) caches, views into the stacked tensors."""
        if cfg.pair_scan:
            j = i // 2
            return (self.k[j], self.v[j]) if i % 2 == 0 else \
                (self.k2[j], self.v2[j])
        return self.k[i], self.v[i]


def cache_len(cfg: TransformerCfg, horizon: int) -> int:
    if cfg.layer_pattern == "window":
        return min(cfg.window, horizon)
    return horizon


def init_cache(cfg: TransformerCfg, batch: int, horizon: int,
               dtype=torch.bfloat16, device=None, mesh=None) -> KVCache:
    """Zeroed caches; on ``mesh`` DTensors split by ``batch`` and
    ``kv_heads`` (:data:`~.layers.CACHE_AXES`), which a decode step writes
    rank by rank."""
    device = default_device() if device is None else torch.device(device)
    hk, hd = cfg.n_kv_heads, cfg.head_dim

    def zeros(n, s):
        z = torch.zeros((n, batch, hk, s, hd), dtype=dtype, device=device)
        return place_tree(z, (None,) + CACHE_AXES, mesh)

    if cfg.pair_scan:
        n = cfg.n_layers // 2
        local_len = min(cfg.window, horizon) if cfg.window else horizon
        return KVCache(k=zeros(n, local_len), v=zeros(n, local_len),
                       k2=zeros(n, horizon), v2=zeros(n, horizon))
    s = cache_len(cfg, horizon)
    return KVCache(k=zeros(cfg.n_layers, s), v=zeros(cfg.n_layers, s))


def serve_decode(params: dict, token: Tensor, pos: int, cache: KVCache,
                 cfg: TransformerCfg) -> tuple:
    """One decode step.  token (B, 1) int; ``pos`` a Python int (the host
    loop's position).  Writes the step's K/V into ``cache`` in place and
    returns (logits (B, V) fp32, cache).  Every layer's attention goes
    through the ``flash_decode`` kernel on the card.  MoE layers dispatch
    globally, as the reference's decode does."""
    _check_layers(cfg)
    pos = int(pos)
    x = shard(_embed(params, token, cfg), "batch", None, "embed")
    for i, p in enumerate(params["layers"]):
        acfg = cfg.attn_cfg(cfg.layer_is_local(i))
        kc, vc = cache.layer(i, cfg)
        h = rms_norm(x, p["ln_attn"], plus_one=cfg.norm_plus_one)
        o, _, _ = decode_attention_block(p["attn"], h, pos, kc, vc, acfg)
        x = x + like(o, x)
        h = rms_norm(x, p["ln_mlp"], plus_one=cfg.norm_plus_one)
        x = x + like(_ffn(p, h, cfg, dispatch="global")[0], x)
    x = rms_norm(x, params["ln_final"], plus_one=cfg.norm_plus_one)
    return _unembed(params, x[:, 0, :], cfg), cache
