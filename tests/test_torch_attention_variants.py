"""The attention variants benchmark (``benchmarks/torch_attention_variants.py``)
on the CPU: it imports without CUDA, every forward and backward variant's
edits apply to the committed kernel sources (each changes its source, and
only ``as_is`` and ``bwd_wgmma`` are the sources themselves), and an edit
whose anchor is gone raises.  Timing the variants needs the card."""
import importlib
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
CSRC = ROOT / "src/repro_torch/kernels/flash_attention/csrc"

#: the variants the module docstring lists
FORWARD = ("as_is", "p_rounded", "p_cvt_split", "one_cta_per_sm",
           "softmax_pinned", "warpgroup_turns", "phases")
BACKWARD = ("bwd_wgmma", "bwd_wgmma_split", "bwd_dq_2cta", "bwd_dkdv_3cta")


@pytest.fixture(scope="module")
def bench():
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    return importlib.import_module("benchmarks.torch_attention_variants")


def test_imports_without_cuda(bench):
    assert callable(bench.main)
    assert "torch" not in vars(bench)  # torch is imported inside main()


@pytest.mark.parametrize("name", FORWARD)
def test_forward_variant_edits_apply(bench, name):
    src = (CSRC / "flash_attention_wgmma.cu").read_text()
    out = bench.variants(src)
    assert tuple(out) == FORWARD
    assert (out[name] == src) == (name == "as_is")
    assert name in bench.__doc__


@pytest.mark.parametrize("name", BACKWARD)
def test_backward_variant_edits_apply(bench, name):
    src = (CSRC / "flash_attention_bwd_wgmma.cu").read_text()
    out = bench.bwd_variants(src)
    assert tuple(out) == BACKWARD
    assert (out[name] == src) == (name == "bwd_wgmma")
    assert name in bench.__doc__
    assert "bwd_fma" in bench.__doc__ and "bwd_sdpa" in bench.__doc__


@pytest.mark.parametrize("which", ["variants", "bwd_variants"])
def test_a_missing_anchor_raises(bench, which):
    with pytest.raises(SystemExit, match="no longer has"):
        getattr(bench, which)("// not the kernel source\n")
