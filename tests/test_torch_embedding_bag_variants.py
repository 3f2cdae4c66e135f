"""The embedding_bag variants benchmark
(``benchmarks/torch_embedding_bag_variants.py``) on the CPU: it imports
without CUDA, every variant's edits apply to the committed kernel source
(each changes it, and only ``as_is`` is the source itself), an edit whose
anchor is gone raises, and its copy of the earlier kernel keeps that
kernel's C interface.  Timing the variants needs the card."""
import importlib
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
SOURCE = ROOT / "src/repro_torch/kernels/embedding_bag/csrc/embedding_bag.cu"

#: the variants the module docstring lists
VARIANTS = ("as_is", "streams_l1", "streams_normal", "table_normal",
            "table_no_l1", "l1_default", "split_l1", "no_split",
            "split_all", "split_lanes8", "rows4", "rows16", "keys64")


@pytest.fixture(scope="module")
def bench():
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    return importlib.import_module("benchmarks.torch_embedding_bag_variants")


def test_imports_without_cuda(bench):
    assert callable(bench.main)
    assert "torch" not in vars(bench)  # torch is imported inside main()


@pytest.mark.parametrize("name", VARIANTS)
def test_variant_edits_apply_to_the_source(bench, name):
    src = SOURCE.read_text()
    out = bench.variants(src)
    assert tuple(out) == VARIANTS
    assert (out[name] == src) == (name == "as_is")
    assert name in bench.__doc__


def test_a_missing_anchor_raises(bench):
    with pytest.raises(SystemExit, match="no longer has"):
        bench.variants("// not the kernel source\n")


def test_previous_keeps_the_kernel_interface(bench):
    prev = bench.PREVIOUS_SRC
    assert 'extern "C" int embedding_bag(const void* table' in prev
    assert 'extern "C" const char* embedding_bag_error(int code)' in prev
    # the earlier design: one kernel, no routes, no shared memory
    assert "embedding_bag_route" not in prev
    assert "__shared__" not in prev
    assert "embedding_bag_kernel" in prev
    assert 'extern "C" int probe_gathers' in bench.PROBE_SRC
    assert 'extern "C" int probe_streams' in bench.PROBE_SRC
