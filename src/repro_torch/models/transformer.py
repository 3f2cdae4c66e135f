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
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from .layers import (AttnCfg, _normal, attention_block,
                     cross_entropy_loss, decode_attention_block,
                     init_attention, init_mlp, mlp_block, rms_norm)
from .moe import MoECfg, init_moe, moe_block

__all__ = ["TransformerCfg", "KVCache", "init_params", "cast_params",
           "params_from_numpy", "forward", "loss_fn", "loss_denominator",
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
def _ffn(p, h, cfg: TransformerCfg):
    """The layer's MLP or MoE block on ``h`` → (out, aux)."""
    if cfg.is_moe:
        return moe_block(p["moe"], h, cfg.moe_cfg())
    return mlp_block(p["mlp"], h, cfg.mlp_kind), None


def _layer_apply(p, x, positions, cfg: TransformerCfg, local: bool):
    """One layer → (x, the layer's aux loss or None for a dense layer)."""
    acfg = cfg.attn_cfg(local)
    h = rms_norm(x, p["ln_attn"], plus_one=cfg.norm_plus_one)
    x = x + attention_block(p["attn"], h, positions, acfg)
    h = rms_norm(x, p["ln_mlp"], plus_one=cfg.norm_plus_one)
    y, aux = _ffn(p, h, cfg)
    return x + y, aux


def _embed(params, tokens, cfg: TransformerCfg):
    x = params["embed"][tokens]
    if cfg.embed_scale:
        x = x * cfg.d_model ** 0.5
    return x.to(cfg.dtype)


def _unembed(params, x, cfg: TransformerCfg):
    table = params["embed"] if cfg.tie_embeddings else params["unembed"]
    logits = x.float() @ table.float().T
    if cfg.final_softcap > 0.0:
        logits = cfg.final_softcap * torch.tanh(logits / cfg.final_softcap)
    return logits


def _hidden(params, tokens, cfg: TransformerCfg):
    """→ (final normed hidden states, summed aux loss fp32)."""
    _check_layers(cfg)
    B, S = tokens.shape
    positions = torch.arange(S, device=tokens.device)[None].expand(B, S)
    x = _embed(params, tokens, cfg)
    aux = torch.zeros((), device=x.device)
    for i, p in enumerate(params["layers"]):
        x, a = _layer_apply(p, x, positions, cfg, cfg.layer_is_local(i))
        if a is not None:
            aux = aux + a
    return rms_norm(x, params["ln_final"], plus_one=cfg.norm_plus_one), aux


def forward(params: dict, tokens: Tensor, cfg: TransformerCfg) -> tuple:
    """tokens (B, S) → (logits (B, S, V) fp32, the layers' summed MoE aux
    loss, 0.0 for a dense model).  The attention of every layer goes
    through the ``flash_attention`` kernel on the card, through its plain
    version on the CPU."""
    x, aux = _hidden(params, tokens, cfg)
    return _unembed(params, x, cfg), aux


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
    weighs the ranks' losses by it).  A mixture of experts has none: its
    load-balancing loss multiplies two means over the batch's tokens, so
    no weighing of the ranks' losses gives the global batch's."""
    if cfg.is_moe:
        raise NotImplementedError(
            "data-parallel training of a mixture of experts: its aux loss "
            "(fraction routed × mean router probability, per expert) has no "
            "denominator that weighs the ranks' losses into the global "
            "batch's; token and expert sharding are ROADMAP A12b")
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
               dtype=torch.bfloat16, device=None) -> KVCache:
    device = default_device() if device is None else torch.device(device)
    hk, hd = cfg.n_kv_heads, cfg.head_dim

    def zeros(n, s):
        return torch.zeros((n, batch, hk, s, hd), dtype=dtype, device=device)

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
    through the ``flash_decode`` kernel on the card.  The reference's
    decode dispatches MoE layers globally; on one card both dispatch modes
    are the same single bin pass, so the config's mode is used as is."""
    _check_layers(cfg)
    pos = int(pos)
    x = _embed(params, token, cfg)
    for i, p in enumerate(params["layers"]):
        acfg = cfg.attn_cfg(cfg.layer_is_local(i))
        kc, vc = cache.layer(i, cfg)
        h = rms_norm(x, p["ln_attn"], plus_one=cfg.norm_plus_one)
        o, _, _ = decode_attention_block(p["attn"], h, pos, kc, vc, acfg)
        x = x + o
        h = rms_norm(x, p["ln_mlp"], plus_one=cfg.norm_plus_one)
        x = x + _ffn(p, h, cfg)[0]
    x = rms_norm(x, params["ln_final"], plus_one=cfg.norm_plus_one)
    return _unembed(params, x[:, 0, :], cfg), cache
