"""Architecture registry of the port: ``get_arch(id)``.

The five LM architectures (granite-moe-3b-a800m, mixtral-8x22b,
tinyllama-1.1b, gemma-7b, gemma2-27b) and the recsys one (bert4rec) are
here.  The GNN architectures of the reference come with their slice:
asking for one raises ``NotImplementedError`` naming it.
"""
from .base import LM_SHAPES, RECSYS_SHAPES, ArchSpec, ShapeCell
from .lm_archs import LM_ARCHS
from .recsys_archs import RECSYS_ARCHS

__all__ = ["ARCHS", "ArchSpec", "ShapeCell", "LM_SHAPES", "RECSYS_SHAPES",
           "get_arch"]

ARCHS: dict = {**LM_ARCHS, **RECSYS_ARCHS}

#: the reference's other architectures → the ROADMAP slice that ports them
_LATER = {
    "gat-cora": "A10 (GNN training)",
    "gin-tu": "A10 (GNN training)",
    "dimenet": "A10 (GNN training)",
    "graphsage-reddit": "A10 (GNN training)",
}


def get_arch(arch_id: str) -> ArchSpec:
    if arch_id in _LATER:
        raise NotImplementedError(
            f"{arch_id!r} is not ported yet: it comes with ROADMAP "
            f"{_LATER[arch_id]}")
    if arch_id not in ARCHS:
        raise KeyError(f"unknown arch {arch_id!r}; available: {sorted(ARCHS)}")
    return ARCHS[arch_id]
