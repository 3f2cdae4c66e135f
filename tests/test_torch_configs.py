"""The port's per-arch config modules (``repro_torch.configs.<arch>``)
give the reference's configs field for field, the four GNN archs
included."""
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
    "gat_cora": "gat-cora",
    "gin_tu": "gin-tu",
    "dimenet": "dimenet",
    "graphsage_reddit": "graphsage-reddit",
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
    # the port's ShapeCell holds every field of the reference's
    assert len(mine.SHAPES) == len(ref.SHAPES)
    for a, b in zip(mine.SHAPES, ref.SHAPES):
        assert dataclasses.asdict(a) == dataclasses.asdict(b)


@pytest.mark.parametrize("arch", ["gat-cora", "gin-tu", "dimenet",
                                  "graphsage-reddit"])
def test_gnn_archs_still_raise(arch):
    """The GNN archs were refused until the training slice; now
    ``get_arch`` returns them (family ``gnn``, the reference's source),
    and only a name it does not know raises."""
    from repro.configs import get_arch as ref_get_arch

    spec, ref = get_arch(arch), ref_get_arch(arch)
    assert (spec.family, spec.source, spec.notes) == (
        "gnn", ref.source, ref.notes)
    with pytest.raises(KeyError, match="unknown arch"):
        get_arch(arch + "-x")
