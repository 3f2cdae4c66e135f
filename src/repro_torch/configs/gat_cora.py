"""Config for ``--arch gat-cora`` (see gnn_archs.py for the spec)."""
from . import get_arch

ARCH_ID = "gat-cora"
SPEC = get_arch(ARCH_ID)
make_model_cfg = SPEC.make_model_cfg
make_smoke_cfg = SPEC.make_smoke_cfg
SHAPES = SPEC.shapes
