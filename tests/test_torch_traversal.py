"""Port parity of the traversals (``repro_torch.core.traversal`` against
``repro.core.traversal``).

Both packages run on one identical graph: the reference's DeviceGraph and
BlockedGraph, handed to the port through ``device_graph_from_arrays`` /
``blocked_from_arrays``.  Depths, levels, direction counts, SSSP distances
and CC labels must match exactly; BC scores and σ pass
``torch.testing.assert_close`` at fp32 defaults (sums in another order).

The reference's ``impl="fused"`` runs its plain scan-over-blocks backend on
the CPU; the ``pallas`` cases run its Pallas kernels in interpret mode on a
scale-6 graph.  The reference's Pallas kernels skip ``combine`` on an
unweighted layout (ROADMAP C), so SSSP on the unweighted graph is held
against the reference's slab engine.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as R
from repro.obs.metrics import registry as ref_registry
import repro_torch.core as T
from repro_torch.obs.metrics import registry as port_registry

ARRAY_FIELDS = ("window_idx", "compact_idx", "edge_mask", "id_map",
                "n_local", "n_edges", "edge_perm", "edge_vals", "n_window")
META_FIELDS = ("n", "m", "direction", "block_size", "num_blocks",
               "edge_budget", "local_budget", "fingerprint")
DG_FIELDS = ("src", "dst", "rowptr", "out_degree", "in_degree", "vals")


def port_blocked(bg, device="cpu"):
    arrays = {f: None if getattr(bg, f) is None else np.asarray(getattr(bg, f))
              for f in ARRAY_FIELDS}
    meta = {f: getattr(bg, f) for f in META_FIELDS}
    meta["schedule"] = dataclasses.asdict(bg.schedule)
    return T.blocked_from_arrays(arrays, meta, device=device)


def port_device_graph(dg, device="cpu"):
    arrays = {f: None if getattr(dg, f) is None else np.asarray(getattr(dg, f))
              for f in DG_FIELDS}
    return T.device_graph_from_arrays(
        arrays, {"n": dg.n, "fingerprint": dg.fingerprint}, device=device)


class Pair:
    """One graph in both packages: flat, transposed flat and pull-blocked."""

    def __init__(self, g, block_size):
        self.g = g
        self.rdg = R.DeviceGraph.from_host(g)
        self.rdgt = R.DeviceGraph.from_host(g.transpose())
        self.rbg = R.build_blocked(g, block_size=block_size, direction="pull")
        self.dg = port_device_graph(self.rdg)
        self.dgt = port_device_graph(self.rdgt)
        self.bg = port_blocked(self.rbg)

    def layouts(self, engine):
        """(reference layout, port layout, engine keywords)."""
        blocked, kw = ENGINES[engine]
        if not blocked:
            return None, None, kw
        return self.rbg, self.bg, kw


#: engine name → (uses the blocked layout, keywords for the pull phase)
ENGINES = {
    "flat": (False, {}),
    "slab": (True, {"impl": "slab"}),
    "fused": (True, {"impl": "fused"}),
    "balanced": (True, {"schedule": "balanced"}),
}


def _unweighted(g):
    return R.Graph(g.n, g.rowptr, g.colidx)


@pytest.fixture(scope="module")
def pairs():
    g = R.rmat_graph(scale=8, edge_factor=6, seed=11, weights=True)
    return {True: Pair(g, 64), False: Pair(_unweighted(g), 64)}


def to_torch(x):
    return torch.from_numpy(np.array(x))


def assert_equal(port, ref):
    ref = to_torch(ref)
    assert port.dtype == ref.dtype and port.shape == ref.shape
    assert torch.equal(port, ref), int((port != ref).sum())


weighted_ids = pytest.mark.parametrize("weighted", [True, False],
                                       ids=["weighted", "unweighted"])
engine_ids = pytest.mark.parametrize("engine", list(ENGINES))


@weighted_ids
@engine_ids
def test_bfs_matches_reference(pairs, engine, weighted):
    p = pairs[weighted]
    rb, pb, kw = p.layouts(engine)
    for source in (5, 0, 200):
        depth, levels, n_push, n_pull = R.bfs(p.rdg, rb, jnp.int32(source),
                                              **kw)
        out = T.bfs(p.dg, pb, source, **kw)
        assert_equal(out[0], depth)
        assert out[1:] == (int(levels), int(n_push), int(n_pull))


@weighted_ids
@engine_ids
def test_bc_matches_reference(pairs, engine, weighted):
    p = pairs[weighted]
    rb, pb, kw = p.layouts(engine)
    scores, depth, sigma = R.bc(p.rdg, rb, jnp.int32(3), **kw)
    out = T.bc(p.dg, pb, 3, **kw)
    torch.testing.assert_close(out[0], to_torch(scores))
    assert_equal(out[1], depth)
    torch.testing.assert_close(out[2], to_torch(sigma))
    assert float(out[0].sum()) > 0


@weighted_ids
@engine_ids
def test_sssp_matches_reference(pairs, engine, weighted):
    p = pairs[weighted]
    rb, pb, kw = p.layouts(engine)
    # unweighted fused: the reference's slab engine (see the module doc)
    ref_kw = {"impl": "slab"} if engine == "fused" and not weighted else kw
    dist, iters = R.sssp(p.rdg, rb, jnp.int32(5), **ref_kw)
    out, port_iters = T.sssp(p.dg, pb, 5, **kw)
    assert_equal(out, dist)
    assert port_iters == int(iters)
    assert int(torch.isfinite(out).sum()) > 1


@weighted_ids
@engine_ids
def test_cc_matches_reference(pairs, engine, weighted):
    p = pairs[weighted]
    rb, pb, kw = p.layouts(engine)
    labels, iters = R.connected_components(p.rdg, p.rdgt, rb, **kw)
    out, port_iters = T.connected_components(p.dg, p.dgt, pb, **kw)
    assert_equal(out, labels)
    assert port_iters == int(iters)


@pytest.mark.parametrize("alpha,direction", [(1e-9, "push"), (1e9, "pull")])
@pytest.mark.parametrize("algo", ["bfs", "bc"])
def test_alpha_extremes_give_reference_counts(pairs, algo, alpha, direction):
    """Pull when m_f > m/α: α = 1e-9 never pulls, α = 1e9 pulls at every
    level whose frontier has an out-edge; the port's exact m_f takes the
    reference's decision at every level."""
    p = pairs[True]
    other = "pull" if direction == "push" else "push"

    def count(d):
        return port_registry.counter("traversal.iterations").value(
            algo=algo, direction=d)

    before = count(direction), count(other)
    if algo == "bfs":
        depth, levels, n_push, n_pull = R.bfs(p.rdg, p.rbg, jnp.int32(5),
                                              alpha=alpha, impl="fused")
        out = T.bfs(p.dg, p.bg, 5, alpha=alpha, impl="fused")
        assert_equal(out[0], depth)
        assert out[1:] == (int(levels), int(n_push), int(n_pull))
        taken = {"push": out[2], "pull": out[3]}[direction]
        assert taken == out[1] if direction == "push" else taken >= out[1] - 1
        assert taken > 0
    else:
        scores, depth, _ = R.bc(p.rdg, p.rbg, jnp.int32(3), alpha=alpha)
        out = T.bc(p.dg, p.bg, 3, alpha=alpha)
        torch.testing.assert_close(out[0], to_torch(scores))
        assert_equal(out[1], depth)
    moved = count(direction) - before[0], count(other) - before[1]
    if algo == "bfs":
        assert moved == (taken, out[1] - taken)
    assert moved[0] > 0 and moved[1] <= (0 if direction == "push" else 1)


def test_default_alpha_takes_both_directions(pairs):
    p = pairs[True]
    _, levels, n_push, n_pull = T.bfs(p.dg, p.bg, 5)
    assert n_push >= 1 and n_pull >= 1 and n_push + n_pull == levels
    assert T.DEFAULT_ALPHA == 15.0


def test_source_may_be_a_tensor(pairs):
    p = pairs[True]
    by_int = T.bfs(p.dg, p.bg, 5, impl="fused")
    by_tensor = T.bfs(p.dg, p.bg, torch.tensor(5), impl="fused")
    assert torch.equal(by_int[0], by_tensor[0])
    assert by_int[1:] == by_tensor[1:]
    with pytest.raises(ValueError, match="not a vertex"):
        T.sssp(p.dg, None, p.dg.n)


def _call(algo, p, **kw):
    if algo == "bfs":
        return T.bfs(p.dg, p.bg, 5, **kw)
    if algo == "bc":
        return T.bc(p.dg, p.bg, 5, **kw)
    if algo == "sssp":
        return T.sssp(p.dg, p.bg, 5, **kw)
    return T.connected_components(p.dg, p.dgt, p.bg, **kw)


def _same(a, b):
    """Traversal results (tuples of tensors and ints) equal exactly."""
    if isinstance(a, torch.Tensor):
        return torch.equal(a, b)
    if isinstance(a, tuple):
        return all(_same(x, y) for x, y in zip(a, b, strict=True))
    return a == b


@pytest.mark.parametrize("algo", ["bfs", "bc", "sssp", "cc"])
def test_refusals(pairs, algo, tmp_path, monkeypatch):
    """``"auto"`` resolves through the tuner: with an empty tuning DB it
    runs what an untuned graph runs (uniform slab, α 15), and under
    ``schedule="auto"`` the fused impl stays fused; fused × balanced given
    explicitly is still an error, as in ``tocab_pull``."""
    from repro_torch.tune import plan as tune_plan

    monkeypatch.setenv("REPRO_TUNE_DIR", str(tmp_path))
    tune_plan.clear_cache()
    p = pairs[True]
    slab = _call(algo, p)
    for kw in ({"schedule": "auto"}, {"impl": "auto"},
               {"schedule": "auto", "impl": "auto"}):
        assert _same(_call(algo, p, **kw), slab)
    assert _same(_call(algo, p, schedule="auto", impl="fused"),
                 _call(algo, p, impl="fused"))
    if algo in ("bfs", "bc"):
        assert _same(_call(algo, p, schedule="auto", alpha=None), slab)
    with pytest.raises(ValueError, match="incompatible"):
        _call(algo, p, impl="fused", schedule="balanced")
    tune_plan.clear_cache()


def _series(registry, name):
    snap = registry.snapshot().get(name, {"series": []})
    return {tuple(sorted(s["labels"].items())): s["value"]
            for s in snap["series"]}


def _delta(after, before, key):
    a, b = after.get(key), before.get(key)
    if isinstance(a, dict):
        b = b or {"count": 0, "sum": 0.0}
        return a["count"] - b["count"], a["sum"] - b["sum"]
    return (a or 0.0) - (b or 0.0)


@pytest.mark.parametrize("engine", ["slab", "fused"])
def test_telemetry_matches_reference(pairs, engine):
    """After the same runs, both registries moved
    ``traversal.iterations{algo,direction}`` and the frontier histograms
    by the same amounts."""
    p = pairs[True]
    kw = ENGINES[engine][1]
    names = ("traversal.iterations", "traversal.frontier_size",
             "traversal.frontier_edges")
    before = {n: (_series(ref_registry, n), _series(port_registry, n))
              for n in names}
    jax.block_until_ready(R.bfs(p.rdg, p.rbg, jnp.int32(5), **kw))
    jax.block_until_ready(R.bc(p.rdg, p.rbg, jnp.int32(3), **kw))
    jax.block_until_ready(R.sssp(p.rdg, p.rbg, jnp.int32(5), **kw))
    jax.block_until_ready(R.connected_components(p.rdg, p.rdgt, p.rbg,
                                                 **kw))
    jax.effects_barrier()
    T.bfs(p.dg, p.bg, 5, **kw)
    T.bc(p.dg, p.bg, 3, **kw)
    T.sssp(p.dg, p.bg, 5, **kw)
    T.connected_components(p.dg, p.dgt, p.bg, **kw)
    seen = set()
    for n in names:
        ref_after, port_after = (_series(ref_registry, n),
                                 _series(port_registry, n))
        ref_before, port_before = before[n]
        keys = set(ref_after) | set(port_after)
        for key in keys:
            ref_d = _delta(ref_after, ref_before, key)
            if ref_d in (0.0, (0, 0.0)):
                continue
            assert _delta(port_after, port_before, key) == ref_d, (n, key)
            seen.add((n, key))
    algos = {dict(k)["algo"] for n, k in seen}
    assert algos == {"bfs", "bc", "sssp", "cc"}
    directions = {dict(k).get("direction") for n, k in seen
                  if n == "traversal.iterations" and dict(k)["algo"] == "bfs"}
    assert directions == {"push", "pull"}


def test_zero_weight_edge_does_not_carry():
    """Reference semantics: BFS multiplies the frontier by the edge value,
    so an edge of weight 0 is no edge to BFS on a weighted layout."""
    n = 6
    src = np.array([0, 1, 0, 2, 3], np.int32)
    dst = np.array([1, 2, 3, 4, 5], np.int32)
    vals = np.array([1.0, 0.0, 0.5, 1.0, 0.0], np.float32)
    g = R.from_edges(n, src, dst, vals=vals)
    p = Pair(g, 8)
    for rb, pb in ((None, None), (p.rbg, p.bg)):
        depth, *_ = R.bfs(p.rdg, rb, jnp.int32(0))
        out = T.bfs(p.dg, pb, 0)
        assert_equal(out[0], depth)
        assert out[0].tolist()[:4] == [0, 1, T.INF_DEPTH, 1]
        assert out[0][5] == T.INF_DEPTH


@pytest.fixture(scope="module")
def pallas_pair():
    g = R.rmat_graph(scale=6, edge_factor=4, seed=3, weights=True)
    return Pair(g, 16)


@pytest.fixture
def pallas_backend(monkeypatch):
    """The reference's ``impl="fused"`` on its Pallas kernels (interpret
    mode off the TPU).  Traces are cleared on both sides, so no jitted body
    traced with the other backend is reused."""
    from repro.kernels.tocab_fused import ops as ref_fused_ops

    jax.clear_caches()
    monkeypatch.setattr(ref_fused_ops, "default_backend", lambda: "pallas")
    yield
    monkeypatch.undo()
    jax.clear_caches()


@pytest.mark.parametrize("algo", ["bfs", "bc", "sssp", "cc"])
def test_fused_matches_pallas_interpret(pallas_pair, pallas_backend, algo):
    p = pallas_pair
    kw = {"impl": "fused"}
    if algo == "bfs":
        depth, levels, n_push, n_pull = R.bfs(p.rdg, p.rbg, jnp.int32(1),
                                              **kw)
        out = T.bfs(p.dg, p.bg, 1, **kw)
        assert_equal(out[0], depth)
        assert out[1:] == (int(levels), int(n_push), int(n_pull))
    elif algo == "bc":
        scores, depth, sigma = R.bc(p.rdg, p.rbg, jnp.int32(1), **kw)
        out = T.bc(p.dg, p.bg, 1, **kw)
        torch.testing.assert_close(out[0], to_torch(scores))
        assert_equal(out[1], depth)
        torch.testing.assert_close(out[2], to_torch(sigma))
    elif algo == "sssp":
        dist, iters = R.sssp(p.rdg, p.rbg, jnp.int32(1), **kw)
        out, port_iters = T.sssp(p.dg, p.bg, 1, **kw)
        assert_equal(out, dist)
        assert port_iters == int(iters)
    else:
        labels, iters = R.connected_components(p.rdg, p.rdgt, p.rbg, **kw)
        out, port_iters = T.connected_components(p.dg, p.dgt, p.bg, **kw)
        assert_equal(out, labels)
        assert port_iters == int(iters)


@pytest.mark.cuda
def test_fused_on_card_matches_flat():
    """On the card: every traversal through the ``fused_pull`` kernel (and
    BC's σ through ``tocab_spmm`` under ``schedule="balanced"``) against
    the flat path, at scale 16."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from repro_torch.kernels import cuda_build

    g = T.rmat_graph(16, 16, seed=2, weights=True)
    gu = T.Graph(g.n, g.rowptr, g.colidx)
    dg, dgu = T.DeviceGraph.from_host(g), T.DeviceGraph.from_host(gu)
    dgt = T.DeviceGraph.from_host(g.transpose())
    bg = T.build_blocked(g, block_size=8192, bin_thresholds="auto")
    bgu = T.build_blocked(gu, block_size=8192, bin_thresholds="auto")
    source = int(torch.argmax(dgu.out_degree))
    cuda_build.reset_launches()
    fused = T.bfs(dgu, bgu, source, impl="fused")
    flat = T.bfs(dgu, None, source)
    assert torch.equal(fused[0], flat[0]) and fused[1:] == flat[1:]
    assert fused[3] >= 1 and cuda_build.launches["fused_pull"] >= fused[3]
    for kw in ({"impl": "fused"}, {"schedule": "balanced"}):
        out = T.bc(dgu, bgu, source, **kw)
        ref = T.bc(dgu, None, source)
        torch.testing.assert_close(out[0], ref[0])
        assert torch.equal(out[1], ref[1])
        torch.testing.assert_close(out[2], ref[2])
    assert cuda_build.launches["tocab_spmm"] >= 1
    out, ref = T.sssp(dg, bg, source, impl="fused"), T.sssp(dg, None, source)
    assert torch.equal(out[0], ref[0]) and out[1] == ref[1]
    out = T.connected_components(dg, dgt, bg, impl="fused")
    ref = T.connected_components(dg, dgt, None)
    assert torch.equal(out[0], ref[0]) and out[1] == ref[1]
