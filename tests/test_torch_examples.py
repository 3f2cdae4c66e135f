"""The port's last three examples on the CPU: ``examples/torch_quickstart.py``,
``torch_train_lm.py`` and ``torch_serve_recsys.py`` (the ports of
``examples/quickstart.py``, ``train_lm.py`` and ``serve_recsys.py``).

* The quickstart against the reference's functions on the same
  ``rmat_graph(14, 8, seed=7, weights=True)``: BFS levels, push and pull
  levels and the reached count, SSSP's rounds and the cache model's miss
  rate and DRAM per edge exactly; PageRank's ranks, Σrank, SpMV, BC and
  SSSP's mean at fp32 ``assert_close``.  PageRank's iterations at the
  example's ``tol=1e-8`` are held within 3: there the L1 step is within a
  factor 2 of fp32 rounding (16,384 ranks of ~6e-5 each, one ulp 7e-12),
  so summation order moves the stop, and the reference's own variants
  stop at 19-21.
* ``torch_train_lm`` at 5 steps of a 2-layer, d 128 model: finite losses,
  a checkpoint, and a second run that resumes from it.
* ``torch_serve_recsys``: cross-entropy falls over its 120 steps, served
  ids lie in the catalogue, retrieval returns candidates.
"""
import importlib.util
import math
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
EXAMPLES = ROOT / "examples"


def _example(name: str):
    spec = importlib.util.spec_from_file_location(name,
                                                  EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Two intra-op threads for this module: the examples' small ops slow
    down many times over when each test worker starts one thread a core."""
    was = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(was)


@pytest.fixture(scope="module")
def quickstart():
    return _example("torch_quickstart").main(["--device", "cpu"])


@pytest.fixture(scope="module")
def reference():
    import jax.numpy as jnp

    from repro.core import (CacheConfig, DeviceGraph, bc, bfs, build_blocked,
                            pagerank, rmat_graph, simulate_pagerank_variant,
                            spmv, sssp)
    g = rmat_graph(scale=14, edge_factor=8, seed=7, weights=True)
    dg = DeviceGraph.from_host(g)
    bg = build_blocked(g, block_size=2048, direction="pull")
    bgp = build_blocked(g, block_size=2048, direction="push")
    out = {"pagerank": {}}
    for variant in ("base", "push", "cb", "gc-pull", "gc-push"):
        rank, iters = pagerank(dg, bgp if variant == "gc-push" else bg,
                               variant=variant, tol=1e-8)
        out["pagerank"][variant] = {"rank": np.asarray(rank),
                                    "iters": int(iters),
                                    "sum": float(rank.sum())}
    out["spmv_l1"] = float(jnp.abs(spmv(dg, bg, jnp.ones((g.n,)),
                                        variant="gc-pull")).sum())
    depth, levels, n_push, n_pull = bfs(dg, bg, jnp.int32(0))
    out["bfs"] = {"depth": np.asarray(depth), "levels": int(levels),
                  "push": int(n_push), "pull": int(n_pull),
                  "reached": int((np.asarray(depth) < 10**9).sum())}
    scores, _, _ = bc(dg, bg, jnp.int32(0))
    out["bc_max"] = float(scores.max())
    dist, it = sssp(dg, bg, jnp.int32(0))
    d = np.asarray(dist)
    out["sssp"] = {"rounds": int(it), "mean": float(d[np.isfinite(d)]
                                                    .mean())}
    cfg = CacheConfig(capacity_bytes=16 * 1024)
    out["cache"] = {v: {k: r[k] for k in ("miss_rate", "dram_per_edge")}
                    for v in ("base", "cb", "tocab")
                    for r in [simulate_pagerank_variant(g, v, cfg,
                                                        block_size=2048)]}
    return out


def _close(a, b):
    torch.testing.assert_close(torch.as_tensor(a, dtype=torch.float32),
                               torch.as_tensor(b, dtype=torch.float32))


def test_quickstart_pagerank(quickstart, reference):
    for variant, want in reference["pagerank"].items():
        got = quickstart["pagerank"][variant]
        assert abs(got["iters"] - want["iters"]) <= 3, variant
        _close(got["rank"], want["rank"])
        _close(got["sum"], want["sum"])
    _close(quickstart["spmv_l1"], reference["spmv_l1"])


def test_quickstart_traversal(quickstart, reference):
    got, want = quickstart["bfs"], reference["bfs"]
    assert {k: got[k] for k in ("levels", "push", "pull", "reached")} == \
        {k: want[k] for k in ("levels", "push", "pull", "reached")}
    assert np.array_equal(got["depth"].numpy(), want["depth"])
    _close(quickstart["bc_max"], reference["bc_max"])
    assert quickstart["sssp"]["rounds"] == reference["sssp"]["rounds"]
    _close(quickstart["sssp"]["mean"], reference["sssp"]["mean"])


def test_quickstart_cache_model(quickstart, reference):
    assert quickstart["cache"] == reference["cache"]


def test_train_lm_runs_and_resumes(tmp_path):
    mod = _example("torch_train_lm")
    argv = ["--device", "cpu", "--dim", "128", "--layers", "2",
            "--ckpt-dir", str(tmp_path)]
    first = mod.main(argv + ["--steps", "5"])
    losses = [h["loss"] for h in first["history"]]
    assert first["start"] == 0 and [h["step"] for h in
                                    first["history"]] == [0, 4]
    assert all(math.isfinite(x) for x in losses)
    again = mod.main(argv + ["--steps", "7"])
    assert again["start"] == 5
    assert [h["step"] for h in again["history"]] == [6]
    assert math.isfinite(again["history"][0]["loss"])


def test_serve_recsys_learns_and_serves():
    out = _example("torch_serve_recsys").main(["--device", "cpu"])
    losses = out["losses"]
    assert len(losses) == 120 and all(math.isfinite(x) for x in losses)
    assert np.mean(losses[-10:]) < np.mean(losses[:10]) - 0.3
    ids = out["top_ids"]
    assert ids.shape == (32, 10)
    assert int(ids.min()) >= 0 and int(ids.max()) < out["vocab"]
    vals, rids = out["retrieval"]
    assert vals.shape == rids.shape == (5,)
    assert set(rids.tolist()) <= set(out["candidates"].tolist())
