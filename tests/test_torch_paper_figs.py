"""The port's paper figures (``benchmarks/torch_paper_figs.py``) against
the reference's (``benchmarks/paper_figs.py``) on the CPU suite.

Each figure of the reference's ``ALL`` runs in both packages: the port's
through its runner (``run_one``: a ``BENCH_<fig>.json``, rendered by the
port's report) with ``Bench.timeit`` replaced by one untimed call, the
reference's with its ``get_graph`` building the suite at the port's block
(2048, no tuning DB) and its timers replaced by constants.  Record names
must be equal, and so must every field of the reference's that no clock
sets: the cache model's counters (Figs. 5, 6, 9, 10, 11), the partition
counts (Table 4), block counts, bins and BC depths.  Both packages replay
rmat16 too: the replays take well under a second here.
"""
import contextlib
import importlib
import io
import os
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest

import repro.core as R
from repro_torch.obs import export, report

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

common = importlib.import_module("benchmarks.common")
ref_figs = importlib.import_module("benchmarks.paper_figs")
figs = importlib.import_module("benchmarks.torch_paper_figs")

#: fields a clock sets (the rest must equal the reference's)
TIMED = {"us_per_call", "speedup", "edges_per_s", "ms", "chosen"}
NAMES = [fn.__name__ for fn in ref_figs.ALL]


def _ref_get_graph():
    cache = {}

    def get_graph(name):
        if name not in cache:
            g = common.SUITE[name]()
            cache[name] = (
                g, R.DeviceGraph.from_host(g),
                R.build_blocked(g, block_size=figs.BLOCK_SIZE,
                                direction="pull"),
                R.build_blocked(g, block_size=figs.BLOCK_SIZE,
                                direction="push"))
        return cache[name]

    return get_graph


def _fake_trial(g, candidate, workload, graph_name):
    return types.SimpleNamespace(candidate=candidate,
                                 us=float(candidate.block_size),
                                 edges_per_s=1.0)


@pytest.fixture(scope="module")
def reference_records():
    """Every figure of the reference's ``ALL``, run once with its timers
    stubbed: {figure name: records}."""
    import repro.tune

    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ref_figs, "get_graph", _ref_get_graph())
        mp.setattr(common, "get_graph", ref_figs.get_graph)
        mp.setattr(ref_figs, "timeit", lambda *a, **k: 1.0)
        mp.setattr(ref_figs, "_pr_iter_time", lambda *a, **k: 1.0)
        mp.setattr(repro.tune, "run_trial", _fake_trial)
        common.drain_records()
        for fn in ref_figs.ALL:
            with contextlib.redirect_stdout(io.StringIO()):
                fn()
            out[fn.__name__] = common.drain_records()
    return out


@pytest.fixture(scope="module")
def port_run(tmp_path_factory):
    """Every port figure on the CPU suite, one untimed call per row:
    {figure name: (payload, path)}."""
    out_dir = tmp_path_factory.mktemp("bench")
    bench = figs.Bench("cpu", figs.CPU_SUITE)
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(figs.Bench, "timeit",
                   lambda self, fn, **k: (fn(), 1.0)[1])
        with contextlib.redirect_stdout(io.StringIO()):
            for fn in figs.FIGURES:
                payload = figs.run_one(fn, bench, out_dir)
                out[fn.__name__] = (
                    payload, out_dir / f"BENCH_{fn.__name__}.json")
    return out


def test_figures_are_the_references_in_its_order():
    assert [fn.__name__ for fn in figs.FIGURES] == NAMES


@pytest.mark.parametrize("name", NAMES)
def test_figure_matches_reference(name, reference_records, port_run):
    payload, path = port_run[name]
    ref = reference_records[name]
    assert [r["name"] for r in payload["records"]] == \
        [r["name"] for r in ref]
    for port_rec, ref_rec in zip(payload["records"], ref):
        assert ref_rec.keys() <= port_rec.keys(), port_rec["name"]
        exact = [k for k in ref_rec if k not in TIMED]
        assert {k: port_rec[k] for k in exact} == \
            {k: ref_rec[k] for k in exact}, port_rec["name"]
    text = report.render(report.read_json(str(path)))
    assert name in text and payload["records"][0]["name"] in text
    assert export.read_json(str(path))["fingerprint"]["backend"] == "cpu"


def test_model_fields_are_present(port_run):
    """fig6 carries the cache model's counters on every row, and fig11
    the prediction beside each block."""
    for rec in port_run["fig6_pagerank"][0]["records"]:
        assert {"miss_rate", "cache_misses", "dram_per_edge"} <= rec.keys()
    rows = port_run["fig11_blocksize"][0]["records"]
    assert [r["blocks"] for r in rows] == [
        -(-R.rmat_graph(15, 8, seed=2).n // bs) for bs in figs.SWEEP_BLOCKS]
    assert sum(r["chosen"] for r in rows) >= 1


def test_balance_mix_graph_is_the_references():
    ref = common.balance_mix_graph()
    port = figs.balance_mix_graph()
    assert port.n == ref.n
    for f in ("rowptr", "colidx", "vals"):
        np.testing.assert_array_equal(getattr(port, f), getattr(ref, f))


def test_cli_times_the_ablation(tmp_path, reference_records):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, str(ROOT / "benchmarks" / "torch_paper_figs.py"),
         "--suite", "cpu", "--device", "cpu", "--only", "ablation",
         "--graphs", "rmat14", "--out", str(tmp_path)],
        env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    payload = export.read_json(str(tmp_path / "BENCH_ablation_blocking.json"))
    names = [r["name"] for r in payload["records"]]
    assert names == [r["name"] for r in reference_records["ablation_blocking"]
                     if "/rmat14/" in r["name"]]
    assert all(r["us_per_call"] > 0 for r in payload["records"])
    assert [r["blocks"] for r in payload["records"]] == [1, 8, 64, 16]
