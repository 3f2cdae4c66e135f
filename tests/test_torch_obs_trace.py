"""The port's tracing (``repro_torch.obs.trace``): off by default and
near-free, on under ``enable()``, a recording profiler or
``REPRO_TORCH_TRACE=1``; ids, parents and roots; the bounded buffer; the
spans and counters on the graph path; device markers on the card."""
import collections
import importlib
import os
import subprocess
import sys
import time
import warnings
from pathlib import Path

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import repro_torch.core as T
from repro_torch.obs import trace
from repro_torch.obs.metrics import registry

# the module itself: ``repro_torch.core`` re-exports its functions
traversal = importlib.import_module("repro_torch.core.traversal")

SRC = Path(__file__).resolve().parent.parent / "src"


@pytest.fixture(autouse=True)
def empty_buffer():
    trace.clear()
    yield
    trace.clear()


@pytest.fixture(scope="module")
def graph():
    g = T.rmat_graph(10, 8, seed=4)
    dg = T.DeviceGraph.from_host(g, device="cpu")
    bg = T.build_blocked(g, block_size=256, device="cpu")
    return dg, bg


def test_off_records_nothing_but_times(monkeypatch):
    """Off, a span opens no profiler range, records no event and no device
    marker, and still sets ``dur_s``; ``block`` still waits."""
    opened = []
    monkeypatch.setattr(trace, "_Range", lambda name: opened.append(name))
    monkeypatch.setattr(trace, "_marker",
                        lambda dev: opened.append(dev))
    assert not trace.enabled()
    with trace.span("outer", device="cpu", k=1) as sp:
        with trace.span("inner") as inner:
            x = torch.ones(2)
            assert inner.block(x) is x
            assert inner.wait(float, x.sum()) == 2.0
        sp.set(more=2)
    assert opened == [] and trace.events() == []
    assert sp.dur_s > 0 and inner.dur_s > 0 and sp.dur_s >= inner.dur_s
    assert sp.attrs == {"k": 1} and inner.blocked_s == 0.0


def test_enable_nests_and_is_a_context_manager():
    assert not trace.enabled()
    trace.enable()
    with trace.enable():
        assert trace.enabled()
    assert trace.enabled()
    trace.disable()
    assert not trace.enabled()
    trace.disable()  # an extra disable does not turn tracing on
    assert not trace.enabled()


def test_environment_switch():
    env = dict(os.environ, PYTHONPATH=str(SRC), REPRO_TORCH_TRACE="1")
    code = ("from repro_torch.obs import trace\n"
            "with trace.span('a'):\n    pass\n"
            "print(trace.enabled(), [e['name'] for e in trace.events()])")
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split("\n")[0] == "True ['a']"


def test_profiler_turns_spans_on():
    """Under a CPU profiler, spans are ranges of its trace and events of
    the buffer with ids; after it exits they record nothing again."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with trace.span("solve", n=3):
            for it in range(2):
                with trace.span("step", it=it) as sp:
                    sp.wait(float, torch.ones(4).sum())
    names = collections.Counter(e.name for e in prof.events())
    assert names["solve"] == 1 and names["step"] == 2
    # host ranges only: no user annotation, which a CUDA profiler would
    # mirror as a device event
    assert not any(e.is_user_annotation for e in prof.events()
                   if e.name in ("solve", "step"))
    evs = trace.events()
    assert [e["name"] for e in evs] == ["step", "step", "solve"]
    solve = evs[-1]
    assert solve["parent"] is None and solve["root"] == solve["id"]
    for e in evs[:2]:
        assert e["parent"] == solve["id"] and e["root"] == solve["id"]
        assert e["depth"] == 1 and e["blocked_s"] > 0
        assert solve["t0_ns"] <= e["t0_ns"] < e["t1_ns"] <= solve["t1_ns"]
    assert len({e["id"] for e in evs}) == 3
    assert "device" not in solve  # no device: no markers
    with trace.span("after"):
        pass
    assert [e["name"] for e in trace.events()] == ["step", "step", "solve"]


def test_buffer_drops_oldest_first(monkeypatch):
    monkeypatch.setattr(trace, "_EVENTS", collections.deque(maxlen=4))
    with trace.enable():
        for i in range(7):
            with trace.span("s", i=i):
                pass
    assert [e["attrs"]["i"] for e in trace.events()] == [3, 4, 5, 6]


def test_pagerank_spans(graph):
    """Traced, a solve is one ``pagerank.solve`` span and one
    ``pagerank.iteration`` an iteration, each holding the engine's
    ``tocab.pull`` and then the ``pagerank.stop_test``; the ranks are
    bit-identical to an untraced solve."""
    dg, bg = graph
    rank0, it0 = T.pagerank(dg, bg, tol=1e-6)
    with trace.enable():
        rank1, it1 = T.pagerank(dg, bg, tol=1e-6)
    assert it1 == it0 > 1 and torch.equal(rank0, rank1)
    evs = trace.events()
    (solve,) = [e for e in evs if e["name"] == "pagerank.solve"]
    assert solve["attrs"] == {"variant": "gc-pull", "schedule": "uniform",
                              "impl": "slab", "n": dg.n, "m": dg.m,
                              "iterations": it0}
    iters = [e for e in evs if e["name"] == "pagerank.iteration"]
    assert [e["attrs"]["it"] for e in iters] == list(range(it0))
    for it in iters:
        assert it["parent"] == solve["id"] == it["root"]
        kids = [e for e in evs if e["parent"] == it["id"]]
        assert [e["name"] for e in kids] == ["tocab.pull",
                                            "pagerank.stop_test"]
        pull, stop = kids
        assert pull["t1_ns"] <= stop["t0_ns"]
        assert 0 < stop["blocked_s"] <= stop["dur_s"]
        assert pull["attrs"]["blocks"] == bg.num_blocks


def test_bfs_level_spans_and_counters(graph):
    """``traversal.level`` directions match the returned push and pull
    counts (the last read, of an empty frontier, has none), each holds a
    ``traversal.frontier_read``; ``traversal.frontier_edges_total`` grows
    by each level's m_f, and ``tocab.edges_scanned`` of ``frontier_push`` by
    the push levels' m_f alone: a push level reads the frontier's arcs, not
    all m, and the flat ``baseline_push`` runs no more."""
    dg, bg = graph
    src = int(torch.argmax(dg.out_degree))
    scanned = registry.counter("tocab.edges_scanned")
    useful = registry.counter("traversal.frontier_edges_total")
    s0 = {e: scanned.value(engine=e, direction="push")
          for e in ("frontier_push", "baseline_push")}
    u0 = {d: useful.value(algo="bfs", direction=d) for d in ("push", "pull")}
    with trace.enable():
        depth, levels, push, pull = T.bfs(dg, bg, src, alpha=15.0)
    assert push >= 1 and pull >= 1
    evs = trace.events()
    (root,) = [e for e in evs if e["name"] == "traversal.bfs"]
    assert root["attrs"] == {"root": src}
    lv = [e for e in evs if e["name"] == "traversal.level"]
    dirs = [e["attrs"]["direction"] for e in lv]
    assert dirs.count("push") == push and dirs.count("pull") == pull
    assert dirs[-1] is None and len(lv) == levels + 1
    assert [e["attrs"]["level"] for e in lv] == list(range(levels + 1))
    for e in lv:
        assert e["parent"] == root["id"] == e["root"]
        reads = [k for k in evs if k["parent"] == e["id"]
                 and k["name"] == "traversal.frontier_read"]
        assert len(reads) == 1 and reads[0]["blocked_s"] > 0
    m_f = {d: sum(e["attrs"]["frontier_edges"] for e in lv
                  if e["attrs"]["direction"] == d) for d in ("push", "pull")}
    for d in ("push", "pull"):
        assert useful.value(algo="bfs", direction=d) == u0[d] + m_f[d]
    assert 0 < m_f["push"] < push * dg.m
    assert scanned.value(engine="frontier_push",
                         direction="push") == s0["frontier_push"] + m_f["push"]
    assert scanned.value(engine="baseline_push",
                         direction="push") == s0["baseline_push"]


@pytest.mark.cuda
@pytest.mark.parametrize("weights", [False, True],
                         ids=["unweighted", "weighted"])
def test_push_level_synchronises_only_at_its_read(monkeypatch, weights):
    """On the card, a push level waits for the device once, in its
    frontier read: each synchronising call (``set_sync_debug_mode``) is
    stamped on the spans' host clock and found in its level.  Its depths
    and counts equal those of push levels that scan every arc
    (``tocab.baseline_push``)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    g = T.rmat_graph(14, 16, seed=2, undirected=True, weights=weights)
    dg = T.DeviceGraph.from_host(g, device="cuda")
    src = int(torch.argmax(dg.out_degree))
    T.bfs(dg, None, src)  # the first call's allocations
    stamps = []
    mode = torch.cuda.get_sync_debug_mode()
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = lambda *a, **k: stamps.append(
            time.perf_counter_ns())
        torch.cuda.set_sync_debug_mode("warn")
        try:
            with trace.enable():
                out = T.bfs(dg, None, src)
        finally:
            torch.cuda.set_sync_debug_mode(mode)
    evs = trace.events()
    pushes = [e for e in evs if e["name"] == "traversal.level"
              and e["attrs"]["direction"] == "push"]
    assert len(pushes) == out[2] >= 2
    for lv in pushes:
        (rd,) = [e for e in evs if e["parent"] == lv["id"]]
        assert rd["name"] == "traversal.frontier_read"
        inside = [t for t in stamps if lv["t0_ns"] <= t <= lv["t1_ns"]]
        assert len(inside) == 1 and rd["t0_ns"] <= inside[0] <= rd["t1_ns"]
    monkeypatch.setattr(
        traversal, "_frontier_push",
        lambda dg, frontier, size, edges: T.baseline_push(
            dg, frontier.float(), reduce="max") > 0)
    scan = T.bfs(dg, None, src)
    assert torch.equal(out[0], scan[0]) and out[1:] == scan[1:]


@pytest.mark.parametrize("algo", ["bc", "sssp", "cc"])
def test_other_traversals_trace_levels(graph, algo):
    dg, bg = graph
    src = int(torch.argmax(dg.out_degree))
    with trace.enable():
        if algo == "bc":
            T.bc(dg, bg, src)
        elif algo == "sssp":
            _, n_iter = T.sssp(dg, bg, src)
        else:
            _, n_iter = T.connected_components(dg, dg, bg)
    evs = trace.events()
    (root,) = [e for e in evs if e["name"] == f"traversal.{algo}"]
    lv = [e for e in evs if e["name"] == "traversal.level"]
    assert lv and all(e["root"] == root["id"] for e in lv)
    if algo != "bc":
        assert len(lv) == n_iter
        assert {e["attrs"]["direction"] for e in lv} == {"pull"}


def test_layout_spans(graph):
    """``build_blocked`` and ``DeviceGraph.from_host`` are spans; the
    layout's build phases come in their order."""
    dg, _ = graph
    g = T.rmat_graph(8, 4, seed=1)
    with trace.enable():
        T.DeviceGraph.from_host(g, device="cpu")
        T.build_blocked(g, block_size=64, device="cpu")
    evs = trace.events()
    assert evs[0]["name"] == "graph.from_host"
    (root,) = [e for e in evs if e["name"] == "partition.build_blocked"]
    assert root["attrs"] == {"direction": "pull", "n": g.n, "m": g.m}
    kids = [e["name"] for e in evs if e["parent"] == root["id"]]
    assert kids == ["partition." + k for k in (
        "upload", "sort", "compaction", "slab_fill", "schedule",
        "fingerprint")]


@pytest.mark.cuda
def test_device_markers_resolve():
    """On the card, a span given the device has positive device-clock
    intervals, resolved when the events are read, on one clock per
    root."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    x = torch.ones(1 << 24, device="cuda")
    with trace.enable():
        with trace.span("outer", device=x.device):
            for _ in range(2):
                with trace.span("inner", device="cuda"):
                    y = (x * 2).sum()
            float(y)
    evs = trace.events()
    inner, inner2, outer = evs
    for e in evs:
        assert e["device"] == "cuda:0" and e["device_ms"] > 0
        assert e["device_ms"] == pytest.approx(e["dev_t1_ms"]
                                               - e["dev_t0_ms"])
    assert outer["dev_t0_ms"] == 0.0  # the root's first marker
    assert outer["dev_t0_ms"] <= inner["dev_t0_ms"] < inner["dev_t1_ms"] \
        <= inner2["dev_t0_ms"] < inner2["dev_t1_ms"] <= outer["dev_t1_ms"]
