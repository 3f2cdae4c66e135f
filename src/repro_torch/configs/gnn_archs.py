"""The four GNN configs, as the reference's ``configs/gnn_archs.py`` gives
them (its recsys config is in :mod:`.recsys_archs`)."""
from __future__ import annotations

from repro_torch.models.gnn import GNNConfig

from .base import GNN_SHAPES, ArchSpec

__all__ = ["GNN_ARCHS"]


def _gat():
    # [arXiv:1710.10903] 2 layers, 8 hidden per head, 8 heads, attn agg
    return GNNConfig(arch="gat", n_layers=2, d_in=1433, d_hidden=8,
                     n_classes=7, n_heads=8, agg="tocab")


def _gat_smoke():
    return GNNConfig(arch="gat", n_layers=2, d_in=16, d_hidden=4,
                     n_classes=4, n_heads=2)


def _gin():
    # [arXiv:1810.00826] 5 layers, 64 hidden, sum agg, learnable eps
    return GNNConfig(arch="gin", n_layers=5, d_in=1433, d_hidden=64,
                     n_classes=7, agg="tocab")


def _gin_smoke():
    return GNNConfig(arch="gin", n_layers=2, d_in=16, d_hidden=8, n_classes=4)


def _dimenet():
    # [arXiv:2003.03123] 6 blocks, 128 hidden, 8 bilinear, 7 spherical, 6 radial
    return GNNConfig(arch="dimenet", n_layers=0, d_in=16, d_hidden=128,
                     n_classes=1, n_blocks=6, n_bilinear=8, n_spherical=7,
                     n_radial=6, graph_level=True)


def _dimenet_smoke():
    return GNNConfig(arch="dimenet", n_layers=0, d_in=4, d_hidden=16,
                     n_classes=1, n_blocks=2, n_bilinear=4, n_spherical=3,
                     n_radial=4, graph_level=True)


def _sage():
    # [arXiv:1706.02216] 2 layers, 128 hidden, mean agg, fanout 25-10
    return GNNConfig(arch="sage", n_layers=2, d_in=602, d_hidden=128,
                     n_classes=41, sample_sizes=(25, 10), agg="tocab")


def _sage_smoke():
    return GNNConfig(arch="sage", n_layers=2, d_in=8, d_hidden=16,
                     n_classes=4, sample_sizes=(3, 2))


GNN_ARCHS = {
    "gat-cora": ArchSpec("gat-cora", "gnn", _gat, _gat_smoke, GNN_SHAPES,
                         source="arXiv:1710.10903"),
    "gin-tu": ArchSpec("gin-tu", "gnn", _gin, _gin_smoke, GNN_SHAPES,
                       source="arXiv:1810.00826"),
    "dimenet": ArchSpec(
        "dimenet", "gnn", _dimenet, _dimenet_smoke, GNN_SHAPES,
        source="arXiv:2003.03123",
        notes="triplets capped at 8/edge for the two huge shapes "
              "(DESIGN.md §Arch-applicability)"),
    "graphsage-reddit": ArchSpec(
        "graphsage-reddit", "gnn", _sage, _sage_smoke, GNN_SHAPES,
        source="arXiv:1706.02216"),
}
