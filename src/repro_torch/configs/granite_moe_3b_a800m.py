"""Config for ``--arch granite-moe-3b-a800m`` (see lm_archs.py for the spec)."""
from . import get_arch

ARCH_ID = "granite-moe-3b-a800m"
SPEC = get_arch(ARCH_ID)
make_model_cfg = SPEC.make_model_cfg
make_smoke_cfg = SPEC.make_smoke_cfg
SHAPES = SPEC.shapes
