"""The recsys config (BERT4Rec), as the reference's
``configs/gnn_archs.py`` gives it."""
from __future__ import annotations

from repro_torch.models.bert4rec import Bert4RecCfg

from .base import RECSYS_SHAPES, ArchSpec

__all__ = ["RECSYS_ARCHS"]


def _bert4rec():
    # [arXiv:1904.06690] d=64, 2 blocks, 2 heads, L=200; 1M-item table per
    # the recsys huge-table regime
    return Bert4RecCfg(name="bert4rec", vocab=1_000_000, max_len=200,
                       d_model=64, n_blocks=2, n_heads=2)


def _bert4rec_smoke():
    return Bert4RecCfg(name="bert4rec-smoke", vocab=1000, max_len=32,
                       d_model=32, n_blocks=2, n_heads=2)


RECSYS_ARCHS = {
    "bert4rec": ArchSpec("bert4rec", "recsys", _bert4rec, _bert4rec_smoke,
                         RECSYS_SHAPES, source="arXiv:1904.06690"),
}
