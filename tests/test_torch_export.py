"""The port's BENCH writer (``repro_torch.obs.export``), its report
(``repro_torch.obs.report``) and its figure runner
(``benchmarks/torch_paper_figs.py``) on the CPU.

A port artifact keeps the reference's ``repro.obs.bench/v1`` layout, so
both packages' reports render and diff it; ``--suite cpu`` gives the
reference's record names, so the two packages' files diff row by row.
"""
import contextlib
import importlib
import io
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from repro.obs import report as ref_report
from repro_torch.obs import export, report
from repro_torch.obs.metrics import registry

ROOT = Path(__file__).resolve().parents[1]


def _payload(name, us):
    return export.bench_payload(
        name, [{"name": "fig8/bc/rmat14/flat", "us_per_call": us,
                "speedup": 1.0},
               {"name": "fig8/bc/rmat14/graphcage", "us_per_call": us / 2,
                "speedup": 2.0}],
        metrics=registry.snapshot())


def test_write_json_is_atomic_and_tagged(tmp_path, monkeypatch):
    path = tmp_path / "out" / "BENCH_fig8_bc.json"
    export.write_json(str(path), _payload("fig8_bc", 10.0))
    first = export.read_json(str(path))
    assert first["schema"] == export.BENCH_SCHEMA == "repro.obs.bench/v1"
    assert first["name"] == "fig8_bc"
    fp = first["fingerprint"]
    for key in ("torch_version", "cuda_version", "backend", "device_count",
                "device_kind", "power_limit_w", "python", "platform",
                "git_sha"):
        assert key in fp
    assert fp["backend"] in ("cuda", "cpu")
    assert [r["name"] for r in first["records"]] == [
        "fig8/bc/rmat14/flat", "fig8/bc/rmat14/graphcage"]
    assert not os.path.exists(str(path) + ".tmp")

    def torn_dump(obj, f, **kw):
        f.write('{"schema": "torn')
        raise OSError("disk full")

    monkeypatch.setattr(export.json, "dump", torn_dump)
    with pytest.raises(OSError):
        export.write_json(str(path), _payload("fig8_bc", 99.0))
    monkeypatch.undo()
    assert export.read_json(str(path)) == first  # readers see the old file

    rows = tmp_path / "rows.jsonl"
    export.write_jsonl(str(rows), [{"a": 1}, {"b": 2.5}])
    assert [json.loads(line) for line in rows.read_text().splitlines()] == [
        {"a": 1}, {"b": 2.5}]


@pytest.mark.parametrize("module", [report, ref_report],
                         ids=["port", "reference"])
def test_port_artifact_renders_and_diffs(tmp_path, module):
    new, old = tmp_path / "new.json", tmp_path / "old.json"
    export.write_json(str(new), _payload("fig8_bc", 30.0))
    export.write_json(str(old), _payload("fig8_bc", 20.0))
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = module.main([str(new), "--baseline", str(old), "--fail-above",
                          "60"])
    text = buf.getvalue()
    assert rc == 0
    assert "fig8_bc" in text and "fig8/bc/rmat14/graphcage" in text
    if module is report:
        assert "torch=" in text and "cuda=" in text and "device=" in text
    rows = module.diff(export.read_json(str(new)), export.read_json(str(old)))
    us = {r["name"]: r["pct"] for r in rows if r["metric"] == "us_per_call"}
    assert us == {"fig8/bc/rmat14/flat": pytest.approx(50.0),
                  "fig8/bc/rmat14/graphcage": pytest.approx(50.0)}
    with contextlib.redirect_stdout(io.StringIO()):
        assert module.main([str(new), "--baseline", str(old),
                            "--fail-above", "40"]) == 1


def test_port_report_renders_a_reference_artifact(tmp_path):
    from repro.obs import export as ref_export

    path = tmp_path / "ref.json"
    ref_export.write_json(str(path), ref_export.bench_payload(
        "fig8_bc", [{"name": "fig8/bc/rmat14/flat", "us_per_call": 5.0}]))
    text = report.render(report.read_json(str(path)))
    assert "jax=" in text and "fig8/bc/rmat14/flat" in text


def _reference_fig8_names(monkeypatch):
    """The names the reference's ``fig8_bc`` emits, without timing it: its
    graphs swapped for a tiny one, its timer for a constant."""
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    common = importlib.import_module("benchmarks.common")
    figs = importlib.import_module("benchmarks.paper_figs")
    import repro.core as R

    g = R.rmat_graph(5, 4, seed=0, weights=True)
    tiny = (g, R.DeviceGraph.from_host(g), R.build_blocked(g, block_size=16),
            None)
    monkeypatch.setattr(figs, "get_graph", lambda name: tiny)
    monkeypatch.setattr(figs, "timeit", lambda *a, **k: 1.0)
    common.drain_records()
    with contextlib.redirect_stdout(io.StringIO()):
        figs.fig8_bc()
    return [r["name"] for r in common.drain_records()]


def test_cpu_suite_writes_reference_record_names(tmp_path, monkeypatch):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, str(ROOT / "benchmarks" / "torch_paper_figs.py"),
         "--suite", "cpu", "--device", "cpu", "--only", "fig8_bc",
         "--graphs", "rmat14", "--out", str(tmp_path)],
        env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    payload = export.read_json(str(tmp_path / "BENCH_fig8_bc.json"))
    assert payload["schema"] == "repro.obs.bench/v1"
    assert payload["name"] == "fig8_bc"
    assert payload["fingerprint"]["backend"] == "cpu"
    names = [r["name"] for r in payload["records"]]
    ref_names = [n for n in _reference_fig8_names(monkeypatch)
                 if "/rmat14/" in n]
    assert names == ref_names == ["fig8/bc/rmat14/flat",
                                  "fig8/bc/rmat14/graphcage"]
    assert all(r["us_per_call"] > 0 for r in payload["records"])
    assert os.listdir(tmp_path) == ["BENCH_fig8_bc.json"]


def test_figure_runner_refuses_graphs_outside_the_suite(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, str(ROOT / "benchmarks" / "torch_paper_figs.py"),
         "--suite", "cpu", "--device", "cpu", "--graphs", "g500-24",
         "--out", str(tmp_path)],
        env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and "g500-24" in out.stderr
    assert os.listdir(tmp_path) == []
