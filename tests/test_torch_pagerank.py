"""Port parity of the slice as a whole: PageRank (all five variants, Fig. 6)
and SpMV (all five, with ``scale=``, Fig. 7), ``impl="slab"`` and
``"fused"``, on two graphs shaped like the benchmark suite's
(``benchmarks/common.py``: the scale-free ``rmat14`` and the good-locality
weighted grid, cut to side 48).

Both packages run on one identical graph and layout.  Ranks and SpMV
outputs pass ``assert_close``; the only difference is fp32 summation order.
PageRank ranks are ~1/n, below the fp32 default ``atol`` of 1e-5, so they
are held to ``rtol=1e-5, atol=1e-9`` instead.  Iteration counts are equal:
on these graphs no stop test lands within summation noise of ``tol``.
"""
import dataclasses

import numpy as np
import pytest
import torch

import repro.core as R
import repro_torch.core as T

ARRAY_FIELDS = ("window_idx", "compact_idx", "edge_mask", "id_map",
                "n_local", "n_edges", "edge_perm", "edge_vals", "n_window")
META_FIELDS = ("n", "m", "direction", "block_size", "num_blocks",
               "edge_budget", "local_budget", "fingerprint")
DG_FIELDS = ("src", "dst", "rowptr", "out_degree", "in_degree", "vals")


def _port(obj, fields, meta):
    arrays = {f: None if getattr(obj, f) is None else np.asarray(getattr(obj, f))
              for f in fields}
    return arrays, {k: getattr(obj, k) for k in meta}


def _weighted_grid(side):
    g = R.grid_graph(side, side)
    rng = np.random.default_rng(0)
    return R.Graph(g.n, g.rowptr, g.colidx, rng.random(g.m, dtype=np.float32))


SUITE = {
    "rmat14": (lambda: R.rmat_graph(14, 8, seed=1, weights=True), 2048),
    "grid48": (lambda: _weighted_grid(48), 512),
}


@pytest.fixture(scope="module", params=sorted(SUITE))
def suite(request):
    build, block_size = SUITE[request.param]
    g = build()
    rdg = R.DeviceGraph.from_host(g)
    ref = {"dg": rdg}
    port = {"dg": T.device_graph_from_arrays(
        *_port(rdg, DG_FIELDS, ("n", "fingerprint")), device="cpu")}
    for direction in ("pull", "push"):
        rb = R.build_blocked(g, block_size=block_size, direction=direction)
        arrays, meta = _port(rb, ARRAY_FIELDS, META_FIELDS)
        meta["schedule"] = dataclasses.asdict(rb.schedule)
        ref[direction] = rb
        port[direction] = T.blocked_from_arrays(arrays, meta, device="cpu")
    return g, ref, port


def _layout(variant):
    return "push" if variant == "gc-push" else "pull"


CASES = [("base", "slab"), ("push", "slab"), ("cb", "slab"),
         ("gc-pull", "slab"), ("gc-pull", "fused"),
         ("gc-push", "slab"), ("gc-push", "fused")]


@pytest.mark.parametrize("variant,impl", CASES)
def test_pagerank_matches_reference(suite, variant, impl):
    g, ref, port = suite
    r_rank, r_iters = R.pagerank(ref["dg"], ref[_layout(variant)],
                                 variant=variant, impl=impl)
    p_rank, p_iters = T.pagerank(port["dg"], port[_layout(variant)],
                                 variant=variant, impl=impl)
    assert isinstance(p_iters, int) and p_iters == int(r_iters)
    torch.testing.assert_close(p_rank, torch.from_numpy(np.array(r_rank)),
                               rtol=1e-5, atol=1e-9)


@pytest.mark.parametrize("variant,impl", [("gc-pull", "fused"),
                                          ("gc-push", "fused"),
                                          ("base", "slab")])
def test_pagerank_iteration_matches_reference(suite, variant, impl):
    import jax.numpy as jnp

    g, ref, port = suite
    rank = np.random.default_rng(3).random(g.n, dtype=np.float32)
    rank /= rank.sum()
    want = R.pagerank_iteration(variant, ref["dg"], ref[_layout(variant)],
                                jnp.asarray(rank), ref["dg"].out_degree,
                                impl=impl)
    got = T.pagerank_iteration(variant, port["dg"], port[_layout(variant)],
                               torch.from_numpy(rank), port["dg"].out_degree,
                               impl=impl)
    torch.testing.assert_close(got, torch.from_numpy(np.array(want)),
                               rtol=1e-5, atol=1e-9)


@pytest.mark.parametrize("variant,impl", CASES)
def test_spmv_matches_reference(suite, variant, impl):
    import jax.numpy as jnp

    g, ref, port = suite
    x = np.random.default_rng(5).random(g.n, dtype=np.float32)
    # scale=None once, on the fused engine (each case is a JAX compile)
    scales = (None, 2.5) if (variant, impl) == ("gc-pull", "fused") else (2.5,)
    for scale in scales:
        want = R.spmv(ref["dg"], ref[_layout(variant)], jnp.asarray(x),
                      variant=variant, impl=impl, scale=scale)
        got = T.spmv(port["dg"], port[_layout(variant)], torch.from_numpy(x),
                     variant=variant, impl=impl, scale=scale)
        torch.testing.assert_close(got, torch.from_numpy(np.array(want)))


def test_spmm_values_match_reference(suite):
    """(n, d) values: SpMM, the GNN aggregation primitive."""
    import jax.numpy as jnp

    g, ref, port = suite
    x = np.random.default_rng(6).random((g.n, 3), dtype=np.float32)
    for variant in ("base", "gc-pull"):
        want = R.spmv(ref["dg"], ref["pull"], jnp.asarray(x), variant=variant,
                      impl="fused" if variant == "gc-pull" else "slab")
        got = T.spmv(port["dg"], port["pull"], torch.from_numpy(x),
                     variant=variant,
                     impl="fused" if variant == "gc-pull" else "slab")
        torch.testing.assert_close(got, torch.from_numpy(np.array(want)))


_LATER_SLICES = [
    (dict(schedule="auto"), "A8"),
    (dict(impl="auto"), "A8"),
    (dict(allow_fallback=True), "A6"),
    (dict(impl="reference"), "A6"),
]


@pytest.mark.parametrize("kw,item", _LATER_SLICES,
                         ids=["schedule-auto", "impl-auto",
                              "allow_fallback", "impl-reference"])
def test_unported_options_raise(kw, item, tmp_path, monkeypatch):
    """The options the port once refused (the tuner's ``"auto"``, ROADMAP
    A8; the ladder's opt-in and its ``"reference"`` rung, A6) now run:
    with an empty tuning DB and no fault each gives exactly what the
    explicit uniform slab call gives, on every entry point."""
    from repro_torch.tune import plan as tune_plan

    del item
    monkeypatch.setenv("REPRO_TUNE_DIR", str(tmp_path))
    tune_plan.clear_cache()
    g = T.rmat_graph(7, 4, seed=2, weights=True)
    dg = T.DeviceGraph.from_host(g, device="cpu")
    pull = T.build_blocked(g, block_size=64, device="cpu")
    push = T.build_blocked(g, block_size=64, direction="push", device="cpu")
    x = torch.ones(g.n)
    calls = [
        lambda **o: T.pagerank(dg, pull, variant="gc-pull", **o)[0],
        lambda **o: T.pagerank(dg, None, variant="base", **o)[0],
        lambda **o: T.spmv(dg, push, x, variant="gc-push", **o),
        lambda **o: T.tocab_pull(pull, x, **o),
        lambda **o: T.tocab_push(push, x, **o),
        lambda **o: T.tocab_edge_reduce(pull, torch.ones(g.m), **o),
    ]
    for call in calls:
        assert torch.equal(call(**kw), call())
    tune_plan.clear_cache()


def test_pagerank_argument_errors():
    g = T.rmat_graph(7, 4, seed=2)
    dg = T.DeviceGraph.from_host(g, device="cpu")
    with pytest.raises(ValueError, match="variant"):
        T.pagerank(dg, None, variant="gc-sideways")
    with pytest.raises(ValueError, match="BlockedGraph"):
        T.pagerank(dg, None, variant="gc-pull")
    with pytest.raises(ValueError, match="variant"):
        T.spmv(dg, None, torch.ones(g.n), variant="dense")
    rank, iters = T.pagerank(dg, None, variant="base", max_iters=3, tol=0.0)
    assert iters == 3 and rank.device.type == "cpu"
    assert rank.dtype == torch.float32 and rank.shape == (g.n,)
