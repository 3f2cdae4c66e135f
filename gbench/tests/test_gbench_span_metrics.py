"""The readers of the program's spans and counters, on a synthetic span
buffer and registry: each gives its definition's value, and None where
the buffer holds nothing of its own (no card, no trace, or a program that
records no such spans)."""
import pytest

from gbench_testlib import load
from repro_torch.obs import trace

NAMES = ("pr_read_gap_ms", "pr_host_ms_per_iter", "bfs_push_level_device_ms")
ALGO = {"pr_read_gap_ms": "pagerank", "pr_host_ms_per_iter": "pagerank",
        "bfs_push_level_device_ms": "bfs"}


def read(name, algo, events, monkeypatch):
    monkeypatch.setattr(trace, "events", lambda: events)
    return load(f"metrics/{name}.py").read({"algo": algo})


def ev(name, id, parent, dur_s=0.0, dev=None, **attrs):
    e = {"name": name, "id": id, "parent": parent, "root": 1,
         "dur_s": dur_s, "blocked_s": 0.0, "attrs": attrs}
    if dev is not None:
        e.update(dev_t0_ms=dev[0], dev_t1_ms=dev[1],
                 device_ms=dev[1] - dev[0])
    return e


def solve(root: int, t: float) -> list:
    """Two iterations of one solve: the engine, the stop test's entry at
    +4 ms, the next iteration's entry at +4.5 ms (a 0.5 ms gap)."""
    return [
        ev("tocab.pull", root + 2, root + 1, 3e-4, (t, t + 4)),
        ev("pagerank.stop_test", root + 3, root + 1, 4e-3, (t + 4, t + 4.1)),
        ev("pagerank.iteration", root + 1, root, 5e-3, (t, t + 4.1), it=0),
        ev("tocab.pull", root + 5, root + 4, 3e-4, (t + 4.5, t + 8)),
        ev("pagerank.stop_test", root + 6, root + 4, 2e-3, (t + 8, t + 8.3)),
        ev("pagerank.iteration", root + 4, root, 3e-3, (t + 4.5, t + 8.3),
           it=1),
        ev("pagerank.solve", root, None, 1e-2, iterations=2),
    ]


def test_pagerank_readers(monkeypatch):
    events = solve(10, 0.0) + solve(20, 100.0)
    # one gap a solve (the last iteration has no next): 0.5 ms each
    assert read("pr_read_gap_ms", "pagerank", events, monkeypatch) == \
        pytest.approx(0.5)
    # host ms less the stop test: 1 and 1 in each solve
    assert read("pr_host_ms_per_iter", "pagerank", events, monkeypatch) \
        == pytest.approx(1.0)


def test_bfs_readers(monkeypatch):
    events = [
        ev("traversal.level", 2, 1, dev=(0.0, 30.0), level=0,
           direction="push", frontier_size=1, frontier_edges=10),
        ev("traversal.level", 3, 1, dev=(30.0, 34.0), level=1,
           direction="pull", frontier_size=9, frontier_edges=900),
        ev("traversal.level", 4, 1, dev=(34.0, 70.0), level=2,
           direction="push", frontier_size=2, frontier_edges=20),
        ev("traversal.level", 5, 1, dev=(70.0, 70.1), level=3,
           direction=None),
        ev("traversal.bfs", 1, None, root=0),
    ]
    assert read("bfs_push_level_device_ms", "bfs", events, monkeypatch) \
        == pytest.approx(33.0)


@pytest.mark.parametrize("name", NAMES)
def test_nothing_to_read(name, monkeypatch):
    """No spans (a run with no card or no trace), spans with no device
    markers (the CPU), the other algorithm's cell, and the events of a
    program whose spans have no ids (names for parents): None, no error."""
    assert read(name, ALGO[name], [], monkeypatch) is None
    other = "bfs" if ALGO[name] == "pagerank" else "pagerank"
    assert read(name, other, solve(10, 0.0), monkeypatch) is None
    old = [{"name": "tune.trial", "ts": 1.0, "dur_s": 0.1, "blocked_s": 0.0,
            "depth": 0, "parent": None, "attrs": {"rep": 0}},
           {"name": "inner", "ts": 1.0, "dur_s": 0.1, "blocked_s": 0.0,
            "depth": 1, "parent": "tune.trial", "attrs": {}}]
    assert read(name, ALGO[name], old, monkeypatch) is None
    if name in ("pr_read_gap_ms", "bfs_push_level_device_ms"):
        no_markers = [{k: v for k, v in e.items()
                       if not k.startswith(("dev_", "device"))}
                      for e in solve(10, 0.0)]
        assert read(name, ALGO[name], no_markers, monkeypatch) is None
