"""Port parity of the engines (mirrors tests/test_tocab.py).

Both packages run on one identical layout: the reference's BlockedGraph and
DeviceGraph, handed to the port through ``blocked_from_arrays`` /
``device_graph_from_arrays``.  min/max and integer outputs must match
exactly.  ``sum`` passes ``torch.testing.assert_close`` at fp32 defaults:
the two packages add the same terms in another order (the reference's
scatter/segment order, ``repro/kernels/tocab_fused/ref.py:73-75``, against
torch's ``index_add_``), and that is the only difference.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as R
from repro.core.balance import UNWEIGHTED as R_UNWEIGHTED
from repro.core.tocab import (blocked_edge_values as r_blocked_edge_values,
                              tocab_edge_reduce as r_tocab_edge_reduce,
                              tocab_gather_src as r_tocab_gather_src)
import repro_torch.core as T
from repro_torch.obs.metrics import registry as port_registry

ARRAY_FIELDS = ("window_idx", "compact_idx", "edge_mask", "id_map",
                "n_local", "n_edges", "edge_perm", "edge_vals", "n_window")
META_FIELDS = ("n", "m", "direction", "block_size", "num_blocks",
               "edge_budget", "local_budget", "fingerprint")
DG_FIELDS = ("src", "dst", "rowptr", "out_degree", "in_degree", "vals")


def port_blocked(bg):
    arrays = {f: None if getattr(bg, f) is None else np.asarray(getattr(bg, f))
              for f in ARRAY_FIELDS}
    meta = {f: getattr(bg, f) for f in META_FIELDS}
    meta["schedule"] = dataclasses.asdict(bg.schedule)
    return T.blocked_from_arrays(arrays, meta, device="cpu")


def port_device_graph(dg):
    arrays = {f: None if getattr(dg, f) is None else np.asarray(getattr(dg, f))
              for f in DG_FIELDS}
    return T.device_graph_from_arrays(
        arrays, {"n": dg.n, "fingerprint": dg.fingerprint}, device="cpu")


class Pair:
    """One graph in both packages: (reference, port) flat and blocked."""

    def __init__(self, g):
        self.g = g
        self.rdg = R.DeviceGraph.from_host(g)
        self.rpull = R.build_blocked(g, block_size=128, direction="pull")
        self.rpush = R.build_blocked(g, block_size=128, direction="push")
        self.dg = port_device_graph(self.rdg)
        self.pull = port_blocked(self.rpull)
        self.push = port_blocked(self.rpush)


@pytest.fixture(scope="module")
def pairs():
    g = R.rmat_graph(scale=9, edge_factor=8, seed=7, weights=True)
    return {"weighted": Pair(g),
            "unweighted": Pair(R.Graph(g.n, g.rowptr, g.colidx))}


def _vals(n, d=None, seed=0, signed=False):
    rng = np.random.default_rng(seed)
    shape = (n,) if d is None else (n, d)
    x = (rng.standard_normal(shape) if signed
         else rng.random(shape)).astype(np.float32)
    return jnp.asarray(x), torch.from_numpy(x.copy())


def assert_match(port_out, ref_out, reduce):
    ref = torch.from_numpy(np.array(ref_out))
    assert port_out.dtype == ref.dtype and port_out.shape == ref.shape
    if reduce == "sum":
        torch.testing.assert_close(port_out, ref)
    else:
        assert torch.equal(port_out, ref), (port_out - ref).abs().max()


ENGINES = {
    # name: (reference fn, port fn, which graph object)
    "baseline_pull": (R.baseline_pull, T.baseline_pull, "dg"),
    "baseline_push": (R.baseline_push, T.baseline_push, "dg"),
    "cb_pull": (R.cb_pull, T.cb_pull, "pull"),
    "tocab_pull": (R.tocab_pull, T.tocab_pull, "pull"),
    "tocab_push": (R.tocab_push, T.tocab_push, "push"),
}
_REF_OBJ = {"dg": "rdg", "pull": "rpull", "push": "rpush"}


@pytest.mark.parametrize("weights", ["weighted", "unweighted", "UNWEIGHTED"])
@pytest.mark.parametrize("reduce", ["sum", "min", "max"])
@pytest.mark.parametrize("engine", sorted(ENGINES))
def test_engines_match_reference(pairs, engine, reduce, weights):
    p = pairs["unweighted" if weights == "unweighted" else "weighted"]
    rfn, pfn, obj = ENGINES[engine]
    kw_r, kw_p = {}, {}
    if weights == "UNWEIGHTED":
        kw_r, kw_p = dict(combine=R_UNWEIGHTED), dict(combine=T.UNWEIGHTED)
    # (n, d) values once, on the weighted graph: each case costs a JAX
    # compile, and the value width is independent of the weighting
    for d in (None, 4) if weights == "weighted" else (None,):
        xj, xt = _vals(p.g.n, d, seed=1, signed=reduce != "sum")
        ref = rfn(getattr(p, _REF_OBJ[obj]), xj, reduce=reduce, **kw_r)
        assert_match(pfn(getattr(p, obj), xt, reduce=reduce, **kw_p), ref,
                     reduce)


def test_combine_minplus(pairs):
    """min-plus semiring (SSSP relaxation step): one callable, both
    packages."""
    p = pairs["weighted"]
    xj, xt = _vals(p.g.n, seed=2)
    plus = lambda d, w: d + w  # noqa: E731
    for rfn, pfn, obj in ENGINES.values():
        ref = rfn(getattr(p, _REF_OBJ[obj]), xj, reduce="min", combine=plus)
        assert_match(pfn(getattr(p, obj), xt, reduce="min", combine=plus),
                     ref, "min")


@pytest.mark.parametrize("reduce", ["sum", "min", "max"])
def test_tocab_pull_partials_and_reduce(pairs, reduce):
    from repro.core.tocab import reduce_partials, tocab_pull_partials

    p = pairs["weighted"]
    xj, xt = _vals(p.g.n, 3, seed=3, signed=reduce != "sum")
    ref = tocab_pull_partials(p.rpull, xj, reduce)
    got = T.tocab_pull_partials(p.pull, xt, reduce)
    assert_match(got, ref, reduce)
    assert_match(T.reduce_partials(p.pull, got, reduce),
                 reduce_partials(p.rpull, ref, reduce), reduce)


@pytest.mark.parametrize("reduce", ["sum", "min", "max"])
@pytest.mark.parametrize("direction", ["pull", "push"])
def test_edge_reduce_matches_reference(pairs, direction, reduce):
    p = pairs["weighted"]
    for d in (None, 3):
        ej, et = _vals(p.g.m, d, seed=4, signed=reduce != "sum")
        ref = r_tocab_edge_reduce(getattr(p, "r" + direction), ej,
                                  reduce=reduce)
        assert_match(T.tocab_edge_reduce(getattr(p, direction), et,
                                         reduce=reduce), ref, reduce)


def test_blocked_edge_values_and_gather_src(pairs):
    p = pairs["weighted"]
    ej, et = _vals(p.g.m, seed=5)
    for direction in ("pull", "push"):
        ref = r_blocked_edge_values(getattr(p, "r" + direction), ej)
        assert_match(T.blocked_edge_values(getattr(p, direction), et), ref,
                     "max")  # a pure permutation: exact
    xj, xt = _vals(p.g.n, 4, seed=6)
    assert_match(T.tocab_gather_src(p.pull, xt),
                 r_tocab_gather_src(p.rpull, xj), "max")
    src, _ = p.g.edges()
    assert torch.equal(T.tocab_gather_src(p.pull, xt), xt[src])


def test_segment_reduce_matches_jax():
    rng = np.random.default_rng(7)
    vals = rng.standard_normal((50, 3)).astype(np.float32)
    ids = rng.integers(0, 12, 50).astype(np.int32)  # segments 12.. empty
    for reduce, fn in (("sum", jax.ops.segment_sum),
                       ("min", jax.ops.segment_min),
                       ("max", jax.ops.segment_max)):
        ref = fn(jnp.asarray(vals), jnp.asarray(ids), num_segments=16)
        got = T.segment_reduce(torch.from_numpy(vals), torch.from_numpy(ids),
                               16, reduce)
        assert_match(got, ref, reduce)
    with pytest.raises(ValueError, match="reduce"):
        T.segment_reduce(torch.from_numpy(vals), torch.from_numpy(ids), 16,
                         "prod")


def test_untouched_vertices_identity():
    """Vertices with no in-edges: 0 for sum, ±inf for min/max."""
    g = T.from_edges(8, np.array([0, 1]), np.array([2, 2]))
    bg = T.build_blocked(g, block_size=4, device="cpu")
    x = torch.arange(8, dtype=torch.float32)
    s = T.tocab_pull(bg, x)
    assert s[2] == pytest.approx(1.0) and (s[[0, 1, 3, 4, 5, 6, 7]] == 0).all()
    mn = T.tocab_pull(bg, x, reduce="min")
    assert torch.isinf(mn[[0, 1, 3]]).all() and mn[2] == 0.0
    mx = T.tocab_pull(bg, x, reduce="max")
    assert (mx[[0, 1, 3]] == float("-inf")).all() and mx[2] == 1.0


@pytest.mark.parametrize("engine", ["tocab_pull", "tocab_push"])
def test_slab_epilogue_matches_reference(pairs, engine):
    p = pairs["weighted"]
    rfn, pfn, obj = ENGINES[engine]
    xj, xt = _vals(p.g.n, seed=8)
    eps = (0.85, 0.15 / p.g.n)
    ref = rfn(getattr(p, _REF_OBJ[obj]), xj, epilogue=eps)
    assert_match(pfn(getattr(p, obj), xt, epilogue=eps), ref, "sum")
    with pytest.raises(ValueError, match="sum"):
        pfn(getattr(p, obj), xt, reduce="max", epilogue=eps)


def test_direction_mismatch_raises(pairs):
    p = pairs["weighted"]
    x = torch.zeros(p.g.n)
    for fn, bg in ((T.cb_pull, p.push), (T.tocab_pull, p.push),
                   (T.tocab_push, p.pull), (T.tocab_gather_src, p.push)):
        with pytest.raises(ValueError, match="layout"):
            fn(bg, x)


def test_engine_telemetry_and_timed(pairs):
    """An engine call's counters (``tocab.engine_traces``, ``tocab.blocks``,
    ``tocab.edges_scanned``) and, traced, its ``tocab.pull`` span."""
    from repro_torch.obs import trace

    p = pairs["weighted"]
    traces = port_registry.counter("tocab.engine_traces")
    scanned = port_registry.counter("tocab.edges_scanned")
    before = traces.value(engine="tocab_pull", direction="pull")
    edges = scanned.value(engine="tocab_pull", direction="pull")
    _, xt = _vals(p.g.n, seed=9)
    trace.clear()
    with trace.enable():
        out = T.tocab_pull(p.pull, xt)
    assert traces.value(engine="tocab_pull", direction="pull") == before + 1
    assert scanned.value(engine="tocab_pull", direction="pull") == \
        edges + p.pull.m
    assert port_registry.gauge("tocab.blocks").value(
        engine="tocab_pull") == p.pull.num_blocks
    (ev,) = trace.events()
    assert ev["name"] == "tocab.pull" and ev["dur_s"] > 0
    assert ev["attrs"] == {"engine": "tocab_pull", "impl": "slab",
                           "schedule": "uniform",
                           "blocks": p.pull.num_blocks}
    torch.testing.assert_close(out, T.tocab_pull(p.pull, xt))


def test_span_blocks_and_records(tmp_path):
    """``obs.span``: nested events with ids, ``block`` passes host tensors
    through (a CUDA value would be synchronised), the JSONL sink written
    when the events are read."""
    import json

    from repro_torch import obs

    sink = tmp_path / "trace.jsonl"
    obs.trace.set_sink(str(sink))
    obs.trace.clear()
    try:
        with obs.trace.enable():
            with obs.span("outer", graph="rmat9") as outer:
                with obs.span("inner") as inner:
                    x = torch.ones(3)
                    assert inner.block((x, {"k": [x]}, 7))[0] is x
                outer.set(done=True)
        assert not sink.exists()  # nothing written per event
        read = obs.trace.events()
    finally:
        obs.trace.set_sink(None)
    events = [json.loads(line) for line in sink.read_text().splitlines()]
    assert [e["name"] for e in events] == ["inner", "outer"]
    assert events == json.loads(json.dumps(read))
    inner_ev, outer_ev = events
    assert inner_ev["parent"] == outer_ev["id"] and inner_ev["depth"] == 1
    assert inner_ev["root"] == outer_ev["root"] == outer_ev["id"]
    assert outer_ev["parent"] is None
    assert events[1]["attrs"] == {"graph": "rmat9", "done": True}
    assert outer_ev["t0_ns"] <= inner_ev["t0_ns"] < inner_ev["t1_ns"] \
        <= outer_ev["t1_ns"]
    assert inner_ev["dur_s"] == pytest.approx(
        (inner_ev["t1_ns"] - inner_ev["t0_ns"]) / 1e9, abs=1e-5)
    assert "obs.span_seconds" not in obs.registry.names()
