"""The port's per-arch config modules (``repro_torch.configs.<arch>``)
give the reference's configs field for field; the GNN archs, which come
with the training slice, still raise."""
import dataclasses
import importlib

import pytest

from repro_torch.configs import get_arch

MODULES = {
    "tinyllama_1_1b": "tinyllama-1.1b",
    "gemma_7b": "gemma-7b",
    "gemma2_27b": "gemma2-27b",
    "granite_moe_3b_a800m": "granite-moe-3b-a800m",
    "mixtral_8x22b": "mixtral-8x22b",
    "bert4rec": "bert4rec",
}


@pytest.mark.parametrize("module", sorted(MODULES))
def test_arch_module_matches_reference(module):
    mine = importlib.import_module(f"repro_torch.configs.{module}")
    ref = importlib.import_module(f"repro.configs.{module}")
    assert mine.ARCH_ID == ref.ARCH_ID == MODULES[module]
    assert mine.SPEC is get_arch(MODULES[module])
    for make in ("make_model_cfg", "make_smoke_cfg"):
        a, b = getattr(mine, make)(), getattr(ref, make)()
        assert type(a).__name__ == type(b).__name__
        assert dataclasses.asdict(a) == dataclasses.asdict(b), make
    # the port's ShapeCell holds the LM and recsys fields (the GNN ones come
    # with the GNN slice): each equals the reference's
    assert len(mine.SHAPES) == len(ref.SHAPES)
    for a, b in zip(mine.SHAPES, ref.SHAPES):
        assert dataclasses.asdict(a) == {
            f: getattr(b, f) for f in dataclasses.asdict(a)}


@pytest.mark.parametrize("arch", ["gat-cora", "gin-tu", "dimenet",
                                  "graphsage-reddit"])
def test_gnn_archs_still_raise(arch):
    with pytest.raises(NotImplementedError, match="A10"):
        get_arch(arch)
