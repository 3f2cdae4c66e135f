"""The port's roofline counter (``repro_torch.launch.hlo_analysis``), the
dry-run (``repro_torch.launch.dryrun``) and the roofline and report
benchmarks (``benchmarks/torch_roofline.py``, ``torch_report.py``).

* One matmul's per-rank FLOPs under every placement pair of the two
  operands that needs no redistribution (``Shard``, ``Replicate``,
  ``Partial`` on each axis of a fake ``(4, 2)`` mesh) against its hand
  formula; the naive global count (``FlopCounterMode``) fails it wherever
  the work is split.
* A smoke TinyLlama training step's FLOPs, bytes and collective wire bytes
  on that mesh are linear in depth (L = 2, 4 and the published 22): the
  property the reference's two-point fit relied on, which lets the port
  measure every cell at full depth.
* The ring wire formulas against the reference's ``parse_collectives`` fed
  one synthetic HLO line per kind at group sizes 2, 8 and 32;
  ``roofline_terms`` against the reference's with its TPU constants
  patched in; the plain attention's FLOPs counted under its scope, the
  backward's included.
* ``run_cell("gat-cora", "full_graph_sm")`` on the 256- and 512-rank fake
  groups through the CLI: an ``ok`` record, as
  ``tests/test_system.py::test_dryrun_machinery_small_mesh`` asserts of
  the reference, written under the given directory and never under
  ``experiments/dryrun/``; ``torch_report`` renders it.
"""
import dataclasses
import importlib.util
import itertools
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.testing._internal.distributed.fake_pg import FakeStore
from torch.utils.flop_counter import FlopCounterMode

from repro.launch import hlo_analysis as ref_hlo
from repro_torch.configs import get_arch
from repro_torch.dist.sharding import use_mesh_rules
from repro_torch.launch import hlo_analysis as hlo
from repro_torch.launch.cells import META, _place, _place_tree, shapes_only
from repro_torch.launch.dryrun import OUT_DIR
from repro_torch.models import transformer as tfm
from repro_torch.train.optim import adamw, constant_schedule
from repro_torch.train.trainer import make_train_step

ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "src"


def _load(name: str):
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "benchmarks" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def mesh():
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=8)
    try:
        yield init_device_mesh("cuda", (4, 2),
                               mesh_dim_names=("data", "model"))
    finally:
        dist.destroy_process_group()


# a pair of operand placements on one mesh axis that mm takes as they are,
# and whether it splits the product's work over that axis
_PAIRS = {
    "RR": (Replicate(), Replicate(), False),
    "S0R": (Shard(0), Replicate(), True),  # rows of a
    "RS1": (Replicate(), Shard(1), True),  # columns of b
    "S1S0": (Shard(1), Shard(0), True),  # the contraction → Partial
    "PR": (Partial(), Replicate(), False),  # a summand times b
    "RP": (Replicate(), Partial(), False),
}


def _dt(shape, placements, mesh):
    local = list(shape)
    for i, p in enumerate(placements):
        if isinstance(p, Shard):
            local[p.dim] //= mesh.size(i)
    return DTensor.from_local(torch.empty(local, device=META), mesh,
                              list(placements), run_check=False,
                              shape=torch.Size(shape),
                              stride=(shape[1], 1))


@pytest.mark.parametrize("on_data,on_model",
                         list(itertools.product(_PAIRS, _PAIRS)))
def test_matmul_count_is_one_ranks(mesh, on_data, on_model):
    M, K, N = 512, 256, 128
    (a_data, b_data, split_data), (a_model, b_model, split_model) = \
        _PAIRS[on_data], _PAIRS[on_model]
    a = _dt((M, K), (a_data, a_model), mesh)
    b = _dt((K, N), (b_data, b_model), mesh)
    with hlo.CountingMode(mesh) as c:
        a @ b
    div = (mesh.size(0) if split_data else 1) * \
        (mesh.size(1) if split_model else 1)
    assert c.records == []  # nothing redistributed
    assert c.flops == 2 * M * K * N // div
    with FlopCounterMode(display=False) as naive:
        a @ b
    assert (naive.get_total_flops() == c.flops) == (div == 1)


def _smoke_step_count(mesh, n_layers: int):
    cfg = dataclasses.replace(get_arch("tinyllama-1.1b").make_smoke_cfg(),
                              n_layers=n_layers)
    params = _place_tree(
        shapes_only(tfm.init_params, cfg, torch.Generator(), device=META),
        tfm.param_logical_axes(cfg), mesh)
    opt = adamw(constant_schedule(1e-4), weight_decay=0.0)
    state = opt.init(params)
    batch = {"tokens": _place((8, 65), torch.int32, ("batch", None), mesh)}
    step = make_train_step(lambda p, b: tfm.loss_fn(p, b, cfg), opt,
                           mesh=mesh)
    with use_mesh_rules(mesh):
        c = hlo.run_counted(step, (params, state, batch), mesh)
    coll = c.collectives()
    return [c.flops, c.bytes, coll.wire_bytes, sum(coll.counts.values())]


def test_count_is_linear_in_depth(mesh):
    full = get_arch("tinyllama-1.1b").make_model_cfg().n_layers
    c2, c4, cf = (_smoke_step_count(mesh, n) for n in (2, 4, full))
    assert c2[0] > 0 and c2[2] > 0
    for q2, q4, qf in zip(c2, c4, cf):
        slope = (q4 - q2) / 2
        assert slope > 0
        assert qf == pytest.approx(q2 + slope * (full - 2), rel=1e-12)


@pytest.mark.parametrize("kind", ["all-reduce", "all-gather",
                                  "reduce-scatter", "all-to-all",
                                  "collective-permute"])
@pytest.mark.parametrize("g", [2, 8, 32])
def test_ring_wire_bytes_match_the_reference(kind, g):
    n = 4096  # f32 elements of the op's result
    line = (f"  %x.1 = f32[{n}]{{0}} {kind}(f32[{n}]{{0}} %p.1), "
            f"replica_groups=[{64 // g},{g}]<=[64]")
    ref = ref_hlo.parse_collectives(line, 64)
    assert ref.counts[kind] == 1
    assert hlo.ring_wire_bytes(kind, 4.0 * n, g) == ref.wire_bytes


def test_roofline_terms_match_the_reference(monkeypatch):
    for name, v in (("PEAK_FLOPS", ref_hlo.PEAK_FLOPS),
                    ("HBM_BW", ref_hlo.HBM_BW),
                    ("NVLINK_BW", ref_hlo.ICI_BW),
                    ("FABRIC_BW", ref_hlo.ICI_BW)):
        monkeypatch.setattr(hlo, name, v)
    counts = {"all-reduce": 3, "all-gather": 2, "reduce-scatter": 1,
              "all-to-all": 0, "collective-permute": 0}
    by_kind = {"all-reduce": 3e6, "all-gather": 2e6, "reduce-scatter": 1e6,
               "all-to-all": 0.0, "collective-permute": 0.0}
    ours = hlo.CollectiveStats(counts, by_kind, 9e6,
                               {"model": 4e6, "data": 5e6})
    ref = ref_hlo.CollectiveStats(counts, by_kind, 9e6)
    for args in [(3e15, 2e12, 256, 1e15), (1e12, 5e13, 8, 2e11),
                 (1e9, 1e9, 512, None)]:
        fl, by, n, mf = args
        got = hlo.roofline_terms(fl, by, ours, n, model_flops=mf)
        want = ref_hlo.roofline_terms(fl, by, ref, n, model_flops=mf)
        for k, v in want.items():
            assert got[k] == pytest.approx(v, rel=1e-12) if isinstance(
                v, float) else got[k] == v, k
        assert set(got) - set(want) == {"t_collective_by_axis",
                                        "wire_bytes_by_axis"}


def test_axis_bandwidths_are_the_h100_pods():
    assert hlo.HW == {"peak_flops": 989e12, "hbm_bw": 3.35e12,
                      "nvlink_bw": 450e9, "fabric_bw": 50e9}
    assert hlo.axis_bandwidth("model") == 450e9
    assert hlo.axis_bandwidth("data") == hlo.axis_bandwidth("pod+data") \
        == 50e9


def test_plain_attention_is_counted_under_its_scope():
    """The plain attention's einsums, forward and backward, land in the
    ``attention`` scope: 2 · 2·B·H·S²·D forward, twice that backward."""
    from repro_torch.kernels.flash_attention.ops import attention
    B, H, S, D = 2, 4, 64, 16
    q, k, v = (torch.randn(B, H, S, D, requires_grad=True)
               for _ in range(3))
    with hlo.CountingMode() as c:
        (attention(q * 1, k * 1, v * 1) ** 2).sum().backward()
    fwd = 2 * 2 * B * H * S * S * D
    assert c.flops_by_scope == {"attention": 3 * fwd}
    assert c.flops == 3 * fwd


def _dryrun(tmp_path, *extra):
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = tmp_path / "experiments" / "dryrun_torch"
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "gat-cora", "--shape", "full_graph_sm", "--out", str(out), *extra],
        env=env, capture_output=True, text=True, timeout=240)
    assert r.returncode == 0, r.stderr[-3000:]
    return out


@pytest.mark.parametrize("multi_pod", [False, True])
def test_dryrun_writes_an_ok_record(tmp_path, multi_pod):
    before = (ROOT / "experiments" / "dryrun").exists()
    out = _dryrun(tmp_path, *(["--multi-pod"] if multi_pod else []))
    name = "h100x2x32x8" if multi_pod else "h100x32x8"
    rec = json.loads((out / f"gat-cora__full_graph_sm__{name}.json")
                     .read_text())
    assert rec["ok"], rec.get("traceback")
    assert rec["num_devices"] == (512 if multi_pod else 256)
    assert rec["flops_per_device"] > 0
    assert rec["dominant"] in ("compute", "memory", "collective")
    assert rec["collective_counts"]["all-reduce"] >= 1  # gradient sums
    assert rec["peak_bytes_per_device"] >= rec["arg_bytes_per_device"] > 0
    assert (ROOT / "experiments" / "dryrun").exists() == before
    assert Path(OUT_DIR).resolve() == ROOT / "experiments" / "dryrun_torch"
    if not multi_pod:
        report = _load("torch_report")
        table = report.dryrun_table(root=str(tmp_path))
        assert table.splitlines()[0] == "| arch | shape: h100x32x8 |"
        assert table.splitlines()[2].startswith(
            "| gat-cora | **full_graph_sm** ")


def test_roofline_analyse_and_report(mesh, tmp_path):
    roof = _load("torch_roofline")
    assert Path(roof.OUT_DIR).resolve() == \
        ROOT / "experiments" / "roofline_torch"
    rec = roof.analyse("gat-cora", "full_graph_sm", mesh)
    assert rec["num_devices"] == 8 and rec["flops_total"] > 0
    assert rec["dominant"] in ("compute", "memory", "collective")
    d = tmp_path / "experiments" / "roofline_torch"
    d.mkdir(parents=True)
    (d / "gat-cora__full_graph_sm.json").write_text(json.dumps(rec))
    text = _load("torch_report").roofline_table(root=str(tmp_path))
    assert "| gat-cora | full_graph_sm |" in text
    assert f"**{rec['dominant']}**" in text


def test_live_bytes_count_each_storage_once():
    """The peak counts a storage once, from the op that makes it until it
    dies: views and detached aliases of an argument add nothing."""
    x = torch.zeros(1000)
    with hlo.CountingMode(args=(x,)) as c:
        x.view(10, 100).detach()
        w = x * 2  # a new 4000 bytes
        del w
        v = x + 1  # another, after w died
        assert c.live_bytes == 8000
    assert c.arg_bytes == 4000 and c.peak_bytes == 8000
    del v
    assert c.live_bytes == 4000
