"""Each metric reader on a synthetic record, and the reduction of a
profiler trace on synthetic events."""
import json
import random
import time
from types import SimpleNamespace

import pytest
from torch.autograd import DeviceType

from gbench_testlib import GBENCH, REPO, load

PEAK = {"hbm_bytes_per_s": 1e12}
N, M = 1000, 16000


def pr_record(**kw):
    rec = {"algo": "pagerank", "setup_s": 12.5, "setup": {"layout_s": 3.0},
           "graph": {"n": N, "m": M}, "window_s": 1.0, "peak": PEAK,
           "requests": [{"ms": 100.0 + i, "iters": 10 + i % 2}
                        for i in range(20)],
           "profile": {"busy_s": 0.15, "window_s": 0.2,
                       "kernels": {"void fused_pull_stream<4>(int*)":
                                   {"count": 4, "seconds": 4e-6},
                                   "elementwise": {"count": 9,
                                                   "seconds": 1e-5}},
                       "counters": {}}}
    rec.update(kw)
    return rec


def bfs_record(**kw):
    rec = pr_record(algo="bfs", requests=[
        {"ms": 50.0 + i, "edges": 1000 * (i + 1), "reached": 10 * (i + 1),
         "levels": 7, "push_levels": 5, "pull_levels": 2}
        for i in range(20)])
    rec["profile"]["counters"] = {"push_levels": 10, "pull_levels": 4}
    rec.update(kw)
    return rec


def read(name, rec):
    return load(f"metrics/{name}.py").read(rec)


def test_every_metric_has_a_reader():
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert (GBENCH / "metrics" / f"{m['name']}.py").is_file(), m["name"]


def test_end_to_end_readers():
    pr, bfs = pr_record(), bfs_record()
    assert read("setup_s", pr) == 12.5
    assert read("pr_solve_ms", pr) == pytest.approx(1000.0 / 20)
    # inclusive quantiles: 95th of 100..119 lies between 118 and 119
    assert read("pr_solve_p95_ms", pr) == pytest.approx(118.05)
    assert read("bfs_gteps", bfs) == pytest.approx(210000 / 1e9)
    assert read("bfs_p95_ms", bfs) == pytest.approx(68.05)
    # each reads nothing in the other algorithm's cells
    for name in ("pr_solve_ms", "pr_solve_p95_ms"):
        assert read(name, bfs) is None
    for name in ("bfs_gteps", "bfs_p95_ms"):
        assert read(name, pr) is None


def test_per_layer_readers():
    pr, bfs = pr_record(), bfs_record()
    assert read("layout_s", pr) == 3.0
    assert read("pr_iters", pr) == pytest.approx(10.5)
    least = (4 * M + 20 * N + 4) / 1e12
    iter_s = sum(r["ms"] for r in pr["requests"]) / 1e3 / 210
    assert read("pr_iter_roofline", pr) == pytest.approx(
        100 * least / iter_s)
    bound = (9 * M + 8 * N) / 1e12
    assert read("fused_pull_roofline", pr) == pytest.approx(
        100 * bound / 1e-6)
    assert read("device_idle_frac.pr", pr) == pytest.approx(0.25)
    assert read("device_idle_frac.pr", bfs) is None
    assert read("device_idle_frac.bfs", bfs) == pytest.approx(0.25)
    assert read("bfs_push_level_ms", bfs) == pytest.approx(
        1e3 * (0.15 - 4e-6) / 10)
    nbytes = sum(4 * r["edges"] + 8 * r["reached"] for r in bfs["requests"])
    wall = sum(r["ms"] for r in bfs["requests"]) / 1e3
    assert read("bfs_traversal_roofline", bfs) == pytest.approx(
        100 * nbytes / 1e12 / wall)


@pytest.mark.parametrize("name", ["pr_iter_roofline", "fused_pull_roofline",
                                  "bfs_traversal_roofline",
                                  "bfs_push_level_ms", "device_idle_frac.pr",
                                  "device_idle_frac.bfs"])
def test_device_readers_read_nothing_without_the_card(name):
    """A CPU run has no trace and no peak: no device number is made up."""
    for rec in (pr_record(profile=None, peak=None),
                bfs_record(profile=None, peak=None)):
        assert read(name, rec) is None


def test_fused_pull_reader_finds_nothing_without_its_kernel():
    rec = pr_record()
    rec["profile"]["kernels"] = {"elementwise": {"count": 3, "seconds": 1.0}}
    assert read("fused_pull_roofline", rec) is None


def ev(name, start, end, device):
    return SimpleNamespace(name=name, device_type=device,
                           time_range=SimpleNamespace(start=start, end=end))


def test_reduce_trace():
    cpu, cuda = DeviceType.CPU, DeviceType.CUDA
    events = [
        ev("aten::add", 0, 10, cpu),
        ev("kernel_a", 5, 30, cuda),
        ev("kernel_b", 20, 40, cuda),  # overlaps kernel_a
        ev("aten::item", 40, 70, cpu),  # the host reads: device idle
        ev("aten::_local_scalar_dense", 41, 69, cpu),
        ev("kernel_a", 70, 80, cuda),
        ev("cudaLaunchKernel", 85, 100, cpu),  # no aten op: "python"
    ]
    out = load("run.py").reduce_trace(events)
    assert out["busy_s"] == pytest.approx(45e-6)
    assert out["kernels"]["kernel_a"] == {"count": 2,
                                          "seconds": pytest.approx(35e-6)}
    assert out["device_ops"][0][0] == "kernel_a"
    gaps = dict(out["idle_gaps"])
    assert gaps["aten::item"] == pytest.approx(30e-6)
    assert gaps["aten::add"] == pytest.approx(5e-6)
    assert gaps["python"] == pytest.approx(20e-6)


def scan_reduce_trace(events: list, top: int = 10) -> dict:
    """The plain reference: each idle gap scans every host op."""
    dev = [e for e in events if e.device_type == DeviceType.CUDA]
    host = [e for e in events if e.device_type == DeviceType.CPU
            and e.name.startswith("aten::")]
    kernels: dict = {}
    for e in dev:
        k = kernels.setdefault(e.name, {"count": 0, "seconds": 0.0})
        k["count"] += 1
        k["seconds"] += (e.time_range.end - e.time_range.start) / 1e6
    busy = load("run.py")._union([(e.time_range.start, e.time_range.end)
                                  for e in dev])
    if not busy:
        return {"busy_s": 0.0, "kernels": kernels, "device_ops": [],
                "idle_gaps": []}
    lo = min(e.time_range.start for e in events)
    hi = max(e.time_range.end for e in events)
    edges = [lo] + [x for span in busy for x in span] + [hi]
    gaps: dict = {}
    for a, b in zip(edges[0::2], edges[1::2]):
        if b <= a:
            continue
        mid = (a + b) / 2
        cover = [e for e in host
                 if e.time_range.start <= mid <= e.time_range.end]
        name = (min(cover, key=lambda e: e.time_range.start).name
                if cover else "python")
        gaps[name] = gaps.get(name, 0.0) + (b - a) / 1e6
    by_time = sorted(kernels.items(), key=lambda kv: -kv[1]["seconds"])
    return {
        "busy_s": sum(b - a for a, b in busy) / 1e6,
        "kernels": kernels,
        "device_ops": [[n[:160], v["seconds"]] for n, v in by_time[:top]],
        "idle_gaps": sorted(([n, s] for n, s in gaps.items()),
                            key=lambda t: -t[1])[:top],
    }


def random_trace(rng: random.Random, span: int) -> list:
    """Nested host ops (children may share a parent's start or end) and
    overlapping kernels, on a coarse integer clock so that gap middles
    fall on op boundaries; in no particular order."""
    cpu, cuda = DeviceType.CPU, DeviceType.CUDA
    events = []

    def host(a, b, depth):
        events.append(ev(rng.choice(["aten::item", "aten::to", "aten::full",
                                     "aten::take", "cudaLaunchKernel"]),
                         a, b, cpu))
        t = a
        while depth < 3 and t < b and rng.random() < 0.7:
            c0 = rng.randint(t, b)
            c1 = rng.randint(c0, b)
            host(c0, c1, depth + 1)
            t = c1 + rng.randint(0, 2)

    t = 0
    while t < span:
        b = t + rng.randint(0, 40)
        host(t, b, 0)
        t = b + rng.randint(-5, 10)
    for _ in range(rng.randint(0, span // 10)):
        a = rng.randint(0, span)
        events.append(ev(f"kernel_{rng.randint(0, 12)}", a,
                         a + rng.randint(0, 30), cuda))
    rng.shuffle(events)
    return events


@pytest.mark.parametrize("seed", range(6))
def test_reduce_trace_matches_the_scan(seed):
    rng = random.Random(seed)
    fast = load("run.py").reduce_trace
    for span in (0, 50, 400, 3000):
        events = random_trace(rng, span)
        if not events:
            continue
        assert fast(list(events)) == scan_reduce_trace(list(events))


def test_reduce_trace_is_a_sweep():
    """20 k idle gaps against 80 k host ops, as a deep traversal's slice
    has: well within a traced run's time."""
    cpu, cuda = DeviceType.CPU, DeviceType.CUDA
    events = []
    for i in range(20_000):
        t = 100 * i
        events.append(ev("kernel", t, t + 40, cuda))
        events.append(ev("aten::nonzero_static", t + 45, t + 95, cpu))
        events.append(ev("aten::sum", t + 45, t + 70, cpu))
        events.append(ev("aten::to", t + 50, t + 60, cpu))
        events.append(ev("aten::item", t + 42, t + 44, cpu))
    t0 = time.perf_counter()
    out = load("run.py").reduce_trace(events)
    assert time.perf_counter() - t0 < 5.0
    # 60 us after each kernel; the last ends with the last host op
    assert dict(out["idle_gaps"]) == {
        "aten::nonzero_static": pytest.approx(19_999 * 60e-6 + 55e-6)}
