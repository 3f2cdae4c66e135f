"""Helpers of the benchmark's CPU tests: load the harness's files by path,
and lay out a copy of the benchmark whose graphs are small enough for a
test run."""
from __future__ import annotations

import importlib.util
import json
import shutil
from pathlib import Path

GBENCH = Path(__file__).resolve().parent.parent
REPO = GBENCH.parent


def load(rel: str):
    """Import ``gbench/<rel>`` as a module of its own."""
    path = GBENCH / rel
    name = "gbench_test_" + rel.replace("/", "_").replace(".", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def tiny_layout(tmp: Path, scale: int = 10) -> Path:
    """A copy of ``BENCHMARK.json`` and ``gbench/`` under ``tmp``, every
    configuration cut to ``2**scale`` vertices.  Returns the copy's root."""
    shutil.copytree(GBENCH, tmp / "gbench",
                    ignore=shutil.ignore_patterns("__pycache__", "_cache",
                                                  "tests"))
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    for c in bench["configs"]:
        path = tmp / c["file"]
        cfg = json.loads(path.read_text())
        cfg["scale"] = scale
        path.write_text(json.dumps(cfg))
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench))
    return tmp


def run_cell(root: Path, workload: str, seed: int = 1, seconds: float = 1.0,
             **kw) -> dict:
    """One run of ``workload`` on the CPU (the harness's look for a card
    skipped)."""
    return load("run.py").run_cell(root, workload, seed, seconds, False,
                                   device="cpu", log=lambda *a: None, **kw)
