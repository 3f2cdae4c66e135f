"""Port parity of the sparsity-balanced engines (mirrors
tests/test_balance.py): ``bin_pull_partials``, ``balanced_pull``,
``balanced_push``, ``balanced_edge_reduce`` and ``schedule="balanced"``
through ``tocab_*``, ``pagerank`` and ``spmv``.

Both packages run on one identical layout (the reference's BlockedGraph,
schedule included, handed to the port through ``blocked_from_arrays``) and
on the same numpy inputs.  On the CPU the reference's dense bin takes its
one-hot matmul and the port's its one-hot strategy (``dense_impl`` default
off the TPU / off the card); one case runs the reference's Pallas kernel in
interpret mode.  min/max match exactly; ``sum`` passes
``torch.testing.assert_close`` at fp32 defaults (summation order is the
only difference); PageRank ranks (~1/n, under the fp32 default atol) are
held to ``rtol=1e-5, atol=1e-9`` with iteration counts ±1 (per-bin
reassociation may move a stop test that lands near ``tol``).
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as R
from repro.core import balance as RB
import repro_torch.core as T
from repro_torch.core import balance as TB
from repro_torch.kernels.tocab_spmm import tocab_spmm
from repro_torch.obs.metrics import registry as port_registry

ARRAY_FIELDS = ("window_idx", "compact_idx", "edge_mask", "id_map",
                "n_local", "n_edges", "edge_perm", "edge_vals", "n_window")
META_FIELDS = ("n", "m", "direction", "block_size", "num_blocks",
               "edge_budget", "local_budget", "fingerprint")
DG_FIELDS = ("src", "dst", "rowptr", "out_degree", "in_degree", "vals")
INF = float("inf")


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
    """One graph in both packages, laid out with per-graph ("auto") bin
    thresholds: (reference, port) flat and blocked."""

    def __init__(self, g, block_size=128, bin_thresholds="auto"):
        self.g = g
        self.rdg = R.DeviceGraph.from_host(g)
        self.dg = port_device_graph(self.rdg)
        self.ref, self.port = {}, {}
        for direction in ("pull", "push"):
            rb = R.build_blocked(g, block_size=block_size,
                                 direction=direction,
                                 bin_thresholds=bin_thresholds)
            self.ref[direction], self.port[direction] = rb, port_blocked(rb)


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


# --------------------------------------------------------------------- #
# the schedule the engines dispatch on
# --------------------------------------------------------------------- #
def test_auto_schedule_has_every_bin_and_matches_reference(pairs):
    """The port's own build attaches the reference's schedule; "auto"
    terciles put blocks in all three bins on this graph."""
    pair = pairs["weighted"]
    g = T.rmat_graph(9, 8, seed=7, weights=True)
    for direction in ("pull", "push"):
        own = T.build_blocked(g, block_size=128, direction=direction,
                              bin_thresholds="auto", device="cpu")
        ref = pair.ref[direction].schedule
        assert dataclasses.asdict(own.schedule) == dataclasses.asdict(ref)
        assert all(own.schedule.blocks_per_bin), own.schedule.summary()


# --------------------------------------------------------------------- #
# pull: per bin, then whole
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("reduce", ["sum", "min", "max"])
@pytest.mark.parametrize("bin_id", [0, 1, 2], ids=list(TB.BIN_NAMES))
def test_bin_pull_partials_match_reference(pairs, bin_id, reduce):
    pair = pairs["weighted"]
    rb_, pb = pair.ref["pull"], pair.port["pull"]
    xr, xp = _vals(pb.n, seed=1, signed=reduce != "sum")
    ref = RB.bin_pull_partials(rb_, bin_id, xr, reduce)
    out = TB.bin_pull_partials(pb, bin_id, xp, reduce)
    k = len(pb.schedule.blocks_in(bin_id))
    rb = min(pb.schedule.row_budget_per_bin[bin_id], pb.local_budget)
    assert out.shape == (k, rb)
    assert_match(out, ref, reduce)


@pytest.mark.parametrize("weighting", ["weighted", "unweighted",
                                       "UNWEIGHTED"])
@pytest.mark.parametrize("d", [None, 3])
@pytest.mark.parametrize("reduce", ["sum", "min", "max"])
def test_balanced_pull_matches_reference(pairs, reduce, d, weighting):
    pair = pairs["unweighted" if weighting == "unweighted" else "weighted"]
    rc, pc = ((RB.UNWEIGHTED, T.UNWEIGHTED) if weighting == "UNWEIGHTED"
              else (None, None))
    xr, xp = _vals(pair.g.n, d, seed=2, signed=reduce != "sum")
    ref = R.tocab_pull(pair.ref["pull"], xr, reduce=reduce, combine=rc,
                       schedule="balanced")
    out = T.tocab_pull(pair.port["pull"], xp, reduce=reduce, combine=pc,
                       schedule="balanced")
    assert_match(out, ref, reduce)
    # balanced_pull itself, and the uniform engine: same edge sets
    assert_match(TB.balanced_pull(pair.port["pull"], xp, reduce, pc), ref,
                 reduce)
    assert_match(T.tocab_pull(pair.port["pull"], xp, reduce=reduce,
                              combine=pc), ref, reduce)


def test_balanced_pull_generic_combine(pairs):
    """A generic combine leaves the dense bin on the scan strategy."""
    pair = pairs["weighted"]
    xr, xp = _vals(pair.g.n, seed=3)
    ref = R.tocab_pull(pair.ref["pull"], xr, reduce="min",
                       combine=lambda v, ev: v + ev, schedule="balanced")
    out = T.tocab_pull(pair.port["pull"], xp, reduce="min",
                       combine=lambda v, ev: v + ev, schedule="balanced")
    assert_match(out, ref, "min")


def test_dense_bin_against_pallas_interpret(pairs):
    """All blocks dense (thresholds (0, 0)) at block size 64: the
    reference's Pallas kernel, run in interpret mode, against the port's
    dense-bin strategy (and the port's ``tocab_spmm`` plain version)."""
    pair = Pair(pairs["weighted"].g, block_size=64, bin_thresholds=(0.0, 0.0))
    pb = pair.port["pull"]
    assert pb.schedule.blocks_per_bin[TB.BIN_DENSE] == pb.num_blocks
    xr, xp = _vals(pb.n, seed=4)
    ref = RB.balanced_pull(pair.ref["pull"], xr, dense_impl="pallas",
                           interpret=True)
    assert_match(TB.balanced_pull(pb, xp), ref, "sum")
    assert_match(tocab_spmm(pb, xp), ref, "sum")


@pytest.mark.parametrize("thresholds", [(INF, INF), (0.0, 0.0), (0.0, INF)],
                         ids=["all-sparse", "all-dense", "all-medium"])
def test_single_bin_boundaries(pairs, thresholds):
    """Degenerate thresholds force every block into one bin, and the
    result must not change."""
    pair = Pair(pairs["weighted"].g, bin_thresholds=thresholds)
    pb = pair.port["pull"]
    assert pb.num_blocks in pb.schedule.blocks_per_bin
    xr, xp = _vals(pb.n, seed=5)
    ref = R.baseline_pull(pair.rdg, xr)
    assert_match(T.tocab_pull(pb, xp, schedule="balanced"), ref, "sum")
    assert_match(T.tocab_push(pair.port["push"], xp, schedule="balanced"),
                 ref, "sum")


# --------------------------------------------------------------------- #
# push and edge reduce
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("d", [None, 5])
@pytest.mark.parametrize("reduce", ["sum", "min", "max"])
def test_balanced_push_matches_reference(pairs, reduce, d):
    pair = pairs["weighted"]
    xr, xp = _vals(pair.g.n, d, seed=6, signed=reduce != "sum")
    ref = R.tocab_push(pair.ref["push"], xr, reduce=reduce,
                       schedule="balanced")
    assert_match(T.tocab_push(pair.port["push"], xp, reduce=reduce,
                              schedule="balanced"), ref, reduce)
    assert_match(TB.balanced_push(pair.port["push"], xp, reduce), ref,
                 reduce)


def test_balanced_push_unweighted_combine(pairs):
    pair = pairs["weighted"]
    xr, xp = _vals(pair.g.n, seed=7)
    ref = R.tocab_push(pair.ref["push"], xr, combine=RB.UNWEIGHTED,
                       schedule="balanced")
    assert_match(T.tocab_push(pair.port["push"], xp, combine=T.UNWEIGHTED,
                              schedule="balanced"), ref, "sum")


@pytest.mark.parametrize("reduce", ["sum", "min", "max"])
@pytest.mark.parametrize("direction", ["pull", "push"])
def test_balanced_edge_reduce_matches_reference(pairs, direction, reduce):
    pair = pairs["weighted"]
    rng = np.random.default_rng(8)
    for d in (None, 2):
        shape = (pair.g.m,) if d is None else (pair.g.m, d)
        e = rng.standard_normal(shape).astype(np.float32)
        ref = R.tocab_edge_reduce(pair.ref[direction], jnp.asarray(e),
                                  reduce=reduce, schedule="balanced")
        out = T.tocab_edge_reduce(pair.port[direction], torch.from_numpy(e),
                                  reduce=reduce, schedule="balanced")
        assert_match(out, ref, reduce)
        assert_match(TB.balanced_edge_reduce(pair.port[direction],
                                             torch.from_numpy(e), reduce),
                     ref, reduce)


def test_balanced_edge_reduce_push_hub():
    """Hub-destination push graph: few window rows (dst) but many compact
    rows (src) per block — the edge-reduce slab must be sized by the
    compact budget, not the window budget."""
    n = 128
    src = np.concatenate([np.arange(1, n), np.arange(n)])
    dst = np.concatenate([np.zeros(n - 1, np.int64), (np.arange(n) + 1) % n])
    keep = src != dst
    g = R.from_edges(n, src[keep], dst[keep], dedup=True)
    rbp = R.build_blocked(g, block_size=32, direction="push")
    pbp = port_blocked(rbp)
    sched = pbp.schedule
    assert sched.compact_budget_per_bin != sched.row_budget_per_bin
    e = np.random.default_rng(5).random(g.m, dtype=np.float32)
    ref = R.tocab_edge_reduce(rbp, jnp.asarray(e), schedule="balanced")
    out = T.tocab_edge_reduce(pbp, torch.from_numpy(e), schedule="balanced")
    assert_match(out, ref, "sum")
    assert_match(out, R.tocab_edge_reduce(rbp, jnp.asarray(e)), "sum")


# --------------------------------------------------------------------- #
# the algorithms on the balanced schedule
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("variant", ["gc-pull", "gc-push"])
def test_pagerank_balanced_matches_reference(pairs, variant):
    pair = pairs["weighted"]
    layout = "push" if variant == "gc-push" else "pull"
    # the default tol=1e-6: at 1e-8 the L1 deltas reach their fp32 noise
    # floor (~1e-8 on this graph) and the stop test is a coin toss
    r_rank, r_iters = R.pagerank(pair.rdg, pair.ref[layout], variant=variant,
                                 schedule="balanced")
    p_rank, p_iters = T.pagerank(pair.dg, pair.port[layout], variant=variant,
                                 schedule="balanced")
    assert isinstance(p_iters, int) and abs(p_iters - int(r_iters)) <= 1
    torch.testing.assert_close(p_rank, torch.from_numpy(np.array(r_rank)),
                               rtol=1e-5, atol=1e-9)


@pytest.mark.parametrize("scale", [None, 2.5])
@pytest.mark.parametrize("variant", ["gc-pull", "gc-push"])
def test_spmv_balanced_matches_reference(pairs, variant, scale):
    pair = pairs["weighted"]
    layout = "push" if variant == "gc-push" else "pull"
    xr, xp = _vals(pair.g.n, seed=9)
    ref = R.spmv(pair.rdg, pair.ref[layout], xr, variant=variant,
                 schedule="balanced", scale=scale)
    out = T.spmv(pair.dg, pair.port[layout], xp, variant=variant,
                 schedule="balanced", scale=scale)
    assert_match(out, ref, "sum")


# --------------------------------------------------------------------- #
# the port's own contracts (no JAX)
# --------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def port_pull():
    g = T.rmat_graph(9, 8, seed=7, weights=True)
    return g, T.build_blocked(g, block_size=128, bin_thresholds="auto",
                              device="cpu")


def test_missing_schedule_raises(port_pull):
    g, _ = port_pull
    bg = T.build_blocked(g, block_size=128, classify=False, device="cpu")
    assert bg.schedule is None
    x = torch.ones(g.n)
    with pytest.raises(ValueError, match="BlockSchedule"):
        T.tocab_pull(bg, x, schedule="balanced")
    push = T.build_blocked(g, block_size=128, direction="push",
                           classify=False, device="cpu")
    with pytest.raises(ValueError, match="BlockSchedule"):
        T.tocab_push(push, x, schedule="balanced")


def test_dense_impl_choices(port_pull):
    """The default picks by device (CPU: the one-hot strategy); the TPU's
    name and the kernel on CPU tensors raise — nothing falls back."""
    g, bg = port_pull
    x = torch.rand(g.n)
    assert TB.default_dense_impl(x) == "onehot"
    torch.testing.assert_close(TB.balanced_pull(bg, x, dense_impl="onehot"),
                               TB.balanced_pull(bg, x))
    with pytest.raises(ValueError, match="cuda"):
        T.tocab_pull(bg, x, schedule="balanced", dense_impl="pallas")
    with pytest.raises(ValueError, match="card"):
        T.tocab_pull(bg, x, schedule="balanced", dense_impl="cuda")
    with pytest.raises(ValueError, match="dense_impl"):
        T.spmv(None, bg, x, schedule="balanced", dense_impl="triton")
    with pytest.raises(ValueError, match="layout"):
        TB.balanced_push(bg, x)


def test_bin_counters(port_pull):
    g, bg = port_pull
    traces = port_registry.counter("tocab.balance.bin_traces")
    labels = dict(bin="dense", direction="pull", engine="balanced_pull")
    before = traces.value(**labels)
    T.tocab_pull(bg, torch.rand(g.n), schedule="balanced")
    assert traces.value(**labels) == before + 1
    for i, name in enumerate(TB.BIN_NAMES):
        assert port_registry.gauge("tocab.balance.bin_blocks").value(
            bin=name, direction="pull") == bg.schedule.blocks_per_bin[i]
        assert port_registry.gauge("tocab.balance.bin_edges").value(
            bin=name, direction="pull") == bg.schedule.edges_per_bin[i]
