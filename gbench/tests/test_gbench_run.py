"""Whole runs of the harness on the CPU at a small scale (its look for a
card skipped), and its refusal without a card."""
import json
import subprocess
import sys

import pytest
import torch

from gbench_testlib import GBENCH, REPO, load, run_cell, tiny_layout

CELLS = [w["name"] for w in json.loads(
    (REPO / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.parametrize("cell", CELLS)
def test_result_keys(tmp_path, cell):
    out = run_cell(tiny_layout(tmp_path), cell, seed=2**31 + 5)
    assert list(out) == ["correct", "attempted", "failed", "metrics",
                         "device", "checks"]
    assert out["correct"] is True and out["failed"] == 0
    assert out["attempted"] >= 1
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    want = {m["name"] for m in bench["end_to_end"]
            if cell in m.get("workloads", [cell])}
    assert set(out["metrics"]) == want
    for m in out["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0
    for c in out["checks"].values():
        assert set(c) == {"value", "limit"}


def test_sample_keeps_the_last_and_k_others():
    import random

    s = load("run.py").Sample(3, random.Random(1))
    for i in range(100):
        s.offer(i, i)
    items = s.items()
    assert len(items) == 4 and items[-1] == (99, 99)
    assert [i for i, _ in items] == sorted(i for i, _ in items)


def test_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    proc = subprocess.run(
        [sys.executable, str(GBENCH / "run.py"), "--workload", CELLS[0],
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=120)
    assert proc.returncode == 2
    assert proc.stdout == ""
    assert "CUDA" in proc.stderr


@pytest.mark.cuda
def test_tiny_cell_on_the_card(tmp_path):
    """A small copy of each cell, run as the driver runs one, on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    root = tiny_layout(tmp_path, scale=12)
    (root / "src").symlink_to(REPO / "src")
    for cell in CELLS:
        for trace in ("0", "1"):
            proc = subprocess.run(
                [sys.executable, "gbench/run.py", "--workload", cell,
                 "--seed", "3", "--seconds", "1", "--trace", trace],
                cwd=root, capture_output=True, text=True, timeout=600)
            assert proc.returncode == 0, proc.stderr[-2000:]
            out = json.loads(proc.stdout.strip().splitlines()[-1])
            assert out["correct"] is True, out["checks"]
            assert out["device"]["platform"] == "gpu"
