"""BERT4Rec [arXiv:1904.06690] of the port, serving half: a bidirectional
transformer over item sequences (the reference's ``models/bert4rec.py``).

Entry points: :func:`init_bert4rec`, :func:`params_from_numpy`,
:func:`bert4rec_encode`, :func:`bert4rec_score` (hidden state at the last
position against the whole item table, then top-k: the ``serve_p99`` /
``serve_bulk`` cells) and :func:`bert4rec_retrieve` (one user against
``n_candidates`` item ids: the ``retrieval_cand`` cell).  Parameters are a
dict shaped as the reference's tree (``item_emb``, ``pos_emb``, a
``blocks`` list, ``ln_out``, ``b_ln_out``).

Scores, top-k and gathers are torch ops, as they are XLA ops in the
reference: no TPU kernel runs on this path.  Without a device mesh the
reference's ``shard`` calls do nothing, and the port has none.  Training
(``bert4rec_loss_fn``, ``binned_embedding_grad``) is not ported yet
(ROADMAP A11).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from .layers import _normal, init_dense

__all__ = ["Bert4RecCfg", "init_bert4rec", "params_from_numpy",
           "cast_params", "param_count", "bert4rec_encode", "bert4rec_score",
           "bert4rec_retrieve"]

Tensor = torch.Tensor

_BLOCK_WEIGHTS = ("wq", "wk", "wv", "wo", "w1", "w2")
_BLOCK_NORMS = ("ln1", "b_ln1", "ln2", "b_ln2")


@dataclasses.dataclass(frozen=True)
class Bert4RecCfg:
    """The reference's config, field for field.  ``dropout``,
    ``max_masked`` and ``num_negatives`` steer training, which is not
    ported yet."""
    name: str
    vocab: int  # num items (+1 mask +1 pad handled inside)
    max_len: int
    d_model: int
    n_blocks: int
    n_heads: int
    d_ff_mult: int = 4
    dropout: float = 0.0
    max_masked: int = 20
    num_negatives: int = 1024

    @property
    def sampled_softmax(self) -> bool:
        return self.vocab > 50_000

    @property
    def mask_id(self) -> int:
        return self.vocab

    @property
    def pad_id(self) -> int:
        return self.vocab + 1

    @property
    def table_size(self) -> int:
        return self.vocab + 2

    def param_count(self) -> int:
        d = self.d_model
        block = 4 * d * d + 2 * self.d_ff_mult * d * d + 4 * d
        return (self.table_size + self.max_len) * d + self.n_blocks * block \
            + 2 * d


def init_bert4rec(cfg: Bert4RecCfg, generator: torch.Generator,
                  device=None) -> dict:
    """Random fp32 parameters drawn from ``generator`` (on its own device,
    then moved to ``device``, the card by default), scaled as the
    reference's ``init_bert4rec``: embeddings 0.02, dense ``d_in^-0.5``.
    The numbers differ from the reference's (another generator);
    :func:`params_from_numpy` carries those over."""
    device = torch.device("cuda") if device is None else torch.device(device)
    d = cfg.d_model
    item_emb = _normal((cfg.table_size, d), generator, device) * 0.02
    pos_emb = _normal((cfg.max_len, d), generator, device) * 0.02
    blocks = []
    for _ in range(cfg.n_blocks):
        blk = {n: init_dense(generator, d, d, device=device)
               for n in ("wq", "wk", "wv", "wo")}
        blk["w1"] = init_dense(generator, d, cfg.d_ff_mult * d, device=device)
        blk["w2"] = init_dense(generator, cfg.d_ff_mult * d, d, device=device)
        for n in _BLOCK_NORMS:
            fill = torch.ones if n.startswith("ln") else torch.zeros
            blk[n] = fill(d, device=device)
        blocks.append(blk)
    return {"item_emb": item_emb, "pos_emb": pos_emb, "blocks": blocks,
            "ln_out": torch.ones(d, device=device),
            "b_ln_out": torch.zeros(d, device=device)}


def params_from_numpy(tree: dict, device=None) -> dict:
    """The reference's ``init_bert4rec`` tree, as numpy arrays, as the
    port's parameters on ``device`` (the card by default)."""
    device = torch.device("cuda") if device is None else torch.device(device)

    def tensor(a):
        return torch.from_numpy(np.array(a, dtype=np.float32)).to(device)

    return {
        "item_emb": tensor(tree["item_emb"]),
        "pos_emb": tensor(tree["pos_emb"]),
        "blocks": [{n: tensor(b[n]) for n in _BLOCK_WEIGHTS + _BLOCK_NORMS}
                   for b in tree["blocks"]],
        "ln_out": tensor(tree["ln_out"]),
        "b_ln_out": tensor(tree["b_ln_out"]),
    }


def cast_params(params: dict, dtype) -> dict:
    """``params`` with every fp32 tensor in ``dtype`` (the LayerNorm gains
    too), as the reference's ``bert4rec_encode`` casts them; a tree already
    in ``dtype`` comes back with the same tensors."""
    def cast(t):
        return t.to(dtype) if t.dtype == torch.float32 else t
    out = {n: cast(t) for n, t in params.items() if n != "blocks"}
    out["blocks"] = [{n: cast(t) for n, t in b.items()}
                     for b in params["blocks"]]
    return out


def param_count(params: dict) -> int:
    """Number of parameters in ``params`` (equals ``cfg.param_count()``)."""
    n = sum(t.numel() for k, t in params.items() if k != "blocks")
    return n + sum(t.numel() for b in params["blocks"] for t in b.values())


def _ln(x: Tensor, g: Tensor, b: Tensor, eps: float = 1e-6) -> Tensor:
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * g + b


def bert4rec_encode(params: dict, items: Tensor, cfg: Bert4RecCfg,
                    dtype=torch.float32) -> Tensor:
    """items (B, L) int → hidden (B, L, d) in ``dtype``.  Bidirectional
    attention with a padding mask.  ``dtype=torch.bfloat16`` is the serving
    path: every step stays in bf16, the mask bias included."""
    B, L = items.shape
    p = cast_params(params, dtype)
    items = items.long()
    x = p["item_emb"][items] + p["pos_emb"][None, :L]
    pad = (items == cfg.pad_id)[:, None, None, :]  # (B, 1, 1, L)
    bias = torch.zeros(pad.shape, dtype=dtype, device=x.device
                       ).masked_fill_(pad, -1e30)
    H = cfg.n_heads
    hd = cfg.d_model // H
    for blk in p["blocks"]:
        h = _ln(x, blk["ln1"], blk["b_ln1"])
        q, k, v = ((h @ blk[w]).view(B, L, H, hd).transpose(1, 2)
                   for w in ("wq", "wk", "wv"))
        s = (q @ k.transpose(-1, -2)) * hd ** -0.5 + bias
        a = torch.softmax(s, dim=-1)
        o = (a @ v).transpose(1, 2).reshape(B, L, -1)
        x = x + o @ blk["wo"]
        h = _ln(x, blk["ln2"], blk["b_ln2"])
        x = x + F.gelu(h @ blk["w1"], approximate="tanh") @ blk["w2"]
    return _ln(x, p["ln_out"], p["b_ln_out"])


def bert4rec_score(params: dict, items: Tensor, cfg: Bert4RecCfg,
                   top_k: int = 100) -> tuple:
    """Online/offline scoring: the bf16 hidden state at the last position
    (it holds MASK) against every item → the top ``top_k`` fp32 scores and
    their item ids, (B, top_k) each.  Ties come in no promised order."""
    p = cast_params(params, torch.bfloat16)
    user = bert4rec_encode(p, items, cfg, dtype=torch.bfloat16)[:, -1, :]
    scores = (user @ p["item_emb"][: cfg.vocab].T).float()  # (B, V)
    return torch.topk(scores, top_k, dim=-1)


def bert4rec_retrieve(params: dict, items: Tensor, candidates: Tensor,
                      cfg: Bert4RecCfg, top_k: int = 100) -> tuple:
    """The ``retrieval_cand`` cell: one user (``items`` (1, L)) against the
    item ids ``candidates`` (C,), in fp32: one gather and one matrix-vector
    product; returns (top scores, top ids)."""
    user = bert4rec_encode(params, items, cfg)[0, -1, :]  # (d,)
    cand_emb = params["item_emb"][candidates.long()]  # (C, d)
    scores = (cand_emb @ user).float()
    vals, idx = torch.topk(scores, top_k)
    return vals, candidates[idx]
