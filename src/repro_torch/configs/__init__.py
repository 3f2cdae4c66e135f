"""Architecture registry of the port: ``get_arch(id)``.

The reference's ten architectures (``--arch <id>``):
  LM:     granite-moe-3b-a800m, mixtral-8x22b, tinyllama-1.1b,
          gemma-7b, gemma2-27b
  GNN:    gat-cora, gin-tu, dimenet, graphsage-reddit
  RecSys: bert4rec
"""
from .base import (GNN_SHAPES, LM_SHAPES, RECSYS_SHAPES, ArchSpec,
                   ShapeCell)
from .gnn_archs import GNN_ARCHS
from .lm_archs import LM_ARCHS
from .recsys_archs import RECSYS_ARCHS

__all__ = ["ARCHS", "ArchSpec", "ShapeCell", "LM_SHAPES", "GNN_SHAPES",
           "RECSYS_SHAPES", "get_arch", "all_cells"]

ARCHS: dict = {**LM_ARCHS, **GNN_ARCHS, **RECSYS_ARCHS}


def get_arch(arch_id: str) -> ArchSpec:
    if arch_id not in ARCHS:
        raise KeyError(f"unknown arch {arch_id!r}; available: {sorted(ARCHS)}")
    return ARCHS[arch_id]


def all_cells(include_skipped: bool = False):
    """Every (arch × shape) cell; skipped cells flagged."""
    for arch_id, spec in ARCHS.items():
        for cell in spec.shapes:
            skipped = cell.name in spec.skip_shapes
            if skipped and not include_skipped:
                continue
            yield arch_id, cell, skipped
