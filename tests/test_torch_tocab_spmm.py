"""Port parity of the TOCAB blocked SpMM (``repro_torch.kernels.tocab_spmm``,
mirrors the tocab_spmm cases of tests/test_kernels.py and
tests/test_balance.py).

On the CPU the port's ``tocab_spmm_partials`` / ``tocab_spmm`` run the
plain PyTorch version; they are held against the reference run as its own
tests run it: the Pallas kernel in interpret mode, in both modes, and its
plain oracle (``use_ref=True``).  Both packages run on one identical layout
and the same numpy inputs; sums pass ``torch.testing.assert_close`` at fp32
defaults (summation order is the only difference).

The tests marked ``cuda`` launch the hand-written kernel and hold it
against the plain version on the card (the atomics reorder the adds:
``rtol=1e-4``, as chip_smoke.py's ``SUM_RTOL``); they skip without one.
They import nothing of JAX, so ``pytest -m cuda
tests/test_torch_tocab_spmm.py`` runs on a machine that has none.
"""
import dataclasses

import numpy as np
import pytest
import torch

import repro_torch.core as T
from repro_torch.core import balance as TB
from repro_torch.kernels import cuda_build
from repro_torch.kernels.tocab_spmm import tocab_spmm, tocab_spmm_partials

ARRAY_FIELDS = ("window_idx", "compact_idx", "edge_mask", "id_map",
                "n_local", "n_edges", "edge_perm", "edge_vals", "n_window")
META_FIELDS = ("n", "m", "direction", "block_size", "num_blocks",
               "edge_budget", "local_budget", "fingerprint")


def port_blocked(bg):
    arrays = {f: None if getattr(bg, f) is None else np.asarray(getattr(bg, f))
              for f in ARRAY_FIELDS}
    meta = {f: getattr(bg, f) for f in META_FIELDS}
    meta["schedule"] = dataclasses.asdict(bg.schedule)
    return T.blocked_from_arrays(arrays, meta, device="cpu")


def _np_vals(n, d=None, seed=0):
    shape = (n,) if d is None else (n, d)
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def assert_match(port_out, ref_out):
    ref = torch.from_numpy(np.array(ref_out)).to(port_out.device)
    assert port_out.dtype == ref.dtype and port_out.shape == ref.shape
    torch.testing.assert_close(port_out, ref)


@pytest.fixture(scope="module")
def layouts():
    """``{weighting: (reference layout, port layout)}`` of one graph, pull,
    block size 128, "auto" bins.  JAX is imported here only, so the cuda
    tests below run where JAX is absent."""
    import repro.core as R

    g = R.rmat_graph(scale=9, edge_factor=8, seed=7, weights=True)
    out = {}
    for name, gg in (("weighted", g),
                     ("unweighted", R.Graph(g.n, g.rowptr, g.colidx))):
        rb = R.build_blocked(gg, block_size=128, bin_thresholds="auto")
        out[name] = (rb, port_blocked(rb))
    return out


# --------------------------------------------------------------------- #
# plain version (CPU) against the reference
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("d", [None, 4])
@pytest.mark.parametrize("mode", ["onehot", "scatter"])
def test_partials_match_pallas_interpret(layouts, mode, d):
    import jax.numpy as jnp
    from repro.kernels.tocab_spmm.ops import tocab_spmm_partials as r_partials

    rb, pb = layouts["weighted"]
    x = _np_vals(pb.n, d, seed=1)
    ref = r_partials(rb, jnp.asarray(x), mode=mode, interpret=True)
    assert_match(tocab_spmm_partials(pb, torch.from_numpy(x), mode=mode), ref)


@pytest.mark.parametrize("unweighted", [False, True])
@pytest.mark.parametrize("weighting", ["weighted", "unweighted"])
def test_partials_block_ids_and_budget(layouts, weighting, unweighted):
    """The bin-aware form the balanced scheduler calls: the dense bin's
    blocks at the bin's compact budget, weighted or not."""
    import jax.numpy as jnp
    from repro.kernels.tocab_spmm.ops import tocab_spmm_partials as r_partials

    rb, pb = layouts[weighting]
    sched = pb.schedule
    ids = sched.blocks_in(TB.BIN_DENSE)
    assert 0 < len(ids) < pb.num_blocks
    budget = TB._compact_budget(sched, TB.BIN_DENSE, pb.local_budget)
    assert budget < pb.local_budget
    x = _np_vals(pb.n, 3, seed=2)
    out = tocab_spmm_partials(pb, torch.from_numpy(x), block_ids=ids,
                              unweighted=unweighted, local_budget=budget)
    assert out.shape == (len(ids), budget, 3)
    for kw in (dict(use_ref=True), dict(interpret=True)):
        ref = r_partials(rb, jnp.asarray(x), block_ids=ids,
                         unweighted=unweighted, local_budget=budget, **kw)
        assert_match(out, ref)


@pytest.mark.parametrize("d", [None, 8])
def test_tocab_spmm_matches_reference(layouts, d):
    import jax.numpy as jnp
    from repro.kernels.tocab_spmm.ops import tocab_spmm as r_spmm

    rb, pb = layouts["weighted"]
    x = _np_vals(pb.n, d, seed=3)
    ref = r_spmm(rb, jnp.asarray(x), interpret=True)
    out = tocab_spmm(pb, torch.from_numpy(x))
    assert_match(out, ref)
    assert_match(tocab_spmm(pb, torch.from_numpy(x), use_ref=True), ref)
    assert_match(out, r_spmm(rb, jnp.asarray(x), use_ref=True))


@pytest.mark.parametrize("scale,block,d", [(7, 32, 1), (8, 64, 8),
                                           (8, 256, 16)])
def test_tocab_spmm_sweep(scale, block, d):
    """Against the flat baseline of the reference, as its sweep runs."""
    import jax.numpy as jnp
    import repro.core as R

    g = R.rmat_graph(scale=scale, edge_factor=8, seed=scale, weights=True)
    pb = port_blocked(R.build_blocked(g, block_size=block))
    x = _np_vals(g.n, d if d > 1 else None, seed=scale)
    ref = R.baseline_pull(R.DeviceGraph.from_host(g), jnp.asarray(x))
    assert_match(tocab_spmm(pb, torch.from_numpy(x)), ref)


def nan_padding_case(device):
    """A graph whose vertices ``b·B`` (what padding slots read: window
    offset 0 of every block) have no out-edges, and values that are NaN
    there.  Returns ``(layout, values, the same values with 0 there)``."""
    n, block = 256, 64
    rng = np.random.default_rng(11)
    src = rng.integers(0, n, 2048)
    dst = rng.integers(0, n, 2048)
    keep = (src % block != 0) & (src != dst)
    g = T.from_edges(n, src[keep], dst[keep],
                     vals=rng.random(int(keep.sum()), dtype=np.float32),
                     dedup=True)
    bg = T.build_blocked(g, block_size=block, bin_thresholds=(0.0, 0.0),
                         device=device)
    assert bool((~bg.edge_mask).any()), "the layout needs padding slots"
    clean = torch.from_numpy(_np_vals(n, 2, seed=12)).to(device)
    dirty = clean.clone()
    dirty[::block] = float("nan")
    clean[::block] = 0.0
    return bg, dirty, clean


def test_nan_read_only_by_padding_stays_out():
    """Masked slots are skipped, not multiplied by 0: a NaN that only
    padding reads leaves the result finite."""
    bg, dirty, clean = nan_padding_case("cpu")
    for unweighted in (False, True):
        out = tocab_spmm_partials(bg, dirty, unweighted=unweighted)
        assert bool(out.isfinite().all())
        assert torch.equal(out, tocab_spmm_partials(bg, clean,
                                                    unweighted=unweighted))
    assert bool(T.tocab_pull(bg, dirty, schedule="balanced").isfinite().all())


def test_argument_errors(layouts):
    _, pb = layouts["weighted"]
    x = torch.ones(pb.n)
    with pytest.raises(ValueError, match="mode"):
        tocab_spmm_partials(pb, x, mode="mxu")
    with pytest.raises(ValueError, match="block_ids"):
        tocab_spmm_partials(pb, x, block_ids=(pb.num_blocks,))
    g = T.rmat_graph(7, 4, seed=2)
    push = T.build_blocked(g, block_size=64, direction="push", device="cpu")
    with pytest.raises(ValueError, match="layout"):
        tocab_spmm(push, torch.ones(g.n))


# --------------------------------------------------------------------- #
# the hand-written CUDA kernel (on the card only)
# --------------------------------------------------------------------- #
@pytest.fixture
def cuda_graph():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    return T.rmat_graph(scale=12, edge_factor=8, seed=11, weights=True)


@pytest.mark.cuda
@pytest.mark.parametrize("thresholds", [(0.0, 0.0), "auto"],
                         ids=["all-dense", "auto"])
@pytest.mark.parametrize("block_size", [256, 1024])
def test_cuda_kernel_matches_plain(cuda_graph, block_size, thresholds):
    """16 and 4 blocks: "auto" puts a strict subset in the dense bin."""
    g = cuda_graph
    bg = T.build_blocked(g, block_size=block_size, bin_thresholds=thresholds)
    ids = bg.schedule.blocks_in(TB.BIN_DENSE)
    assert ids
    budget = TB._compact_budget(bg.schedule, TB.BIN_DENSE, bg.local_budget)
    for d in (None, 8):
        x = torch.from_numpy(_np_vals(g.n, d, seed=13)).cuda()
        for unweighted in (False, True):
            kw = dict(block_ids=ids, local_budget=budget,
                      unweighted=unweighted)
            before = cuda_build.launches["tocab_spmm"]
            out = tocab_spmm_partials(bg, x, **kw)
            ref = tocab_spmm_partials(bg, x, use_ref=True, **kw)
            torch.cuda.synchronize()
            assert cuda_build.launches["tocab_spmm"] == before + 1
            torch.testing.assert_close(out, ref, rtol=1e-4, atol=1e-5)


@pytest.mark.cuda
def test_cuda_nan_read_only_by_padding_stays_out(cuda_graph):
    bg, dirty, clean = nan_padding_case("cuda")
    for unweighted in (False, True):
        out = tocab_spmm_partials(bg, dirty, unweighted=unweighted)
        ref = tocab_spmm_partials(bg, clean, unweighted=unweighted,
                                  use_ref=True)
        torch.cuda.synchronize()
        assert bool(out.isfinite().all())
        torch.testing.assert_close(out, ref, rtol=1e-4, atol=1e-5)


@pytest.mark.cuda
def test_cuda_balanced_pull_reaches_kernel(cuda_graph):
    """On the card the balanced dense bin launches the kernel; an explicit
    ``dense_impl='onehot'`` runs torch ops and gives the same result."""
    g = cuda_graph
    bg = T.build_blocked(g, block_size=256, bin_thresholds="auto")
    x = torch.from_numpy(_np_vals(g.n, seed=14)).cuda()
    before = cuda_build.launches["tocab_spmm"]
    out = T.tocab_pull(bg, x, schedule="balanced")
    assert cuda_build.launches["tocab_spmm"] == before + 1
    ref = T.tocab_pull(bg, x, schedule="balanced", dense_impl="onehot")
    assert cuda_build.launches["tocab_spmm"] == before + 1
    torch.testing.assert_close(out, ref, rtol=1e-4, atol=1e-5)


@pytest.mark.cuda
def test_cuda_kernel_refuses_what_it_cannot_run(cuda_graph):
    from repro_torch.kernels.tocab_spmm.kernel import tocab_spmm_cuda

    g = cuda_graph
    bg = T.build_blocked(g, block_size=256)
    x = torch.rand(g.n, 1, device="cuda")
    ids = torch.arange(bg.num_blocks, dtype=torch.int64, device="cuda")
    with pytest.raises(TypeError, match="dtype"):
        tocab_spmm_cuda(x, bg.window_idx, bg.compact_idx, bg.edge_mask,
                        None, ids, block_size=bg.block_size,
                        local_budget=bg.local_budget)
    with pytest.raises(ValueError, match="CUDA"):
        tocab_spmm_cuda(x.cpu(), bg.window_idx, bg.compact_idx, bg.edge_mask,
                        None, ids.int(), block_size=bg.block_size,
                        local_budget=bg.local_budget)


def _edge_case_graph(seed=1, block=65536):
    """Three blocks of ``block`` rows, the middle one with no edge;
    destination 7 pulls from 6000 sources (a run of one compact id longer
    than the kernel's 2048-slot warp chunk), over 200,000 random edges
    among the outer blocks (as chip_smoke.py's edge-case graph)."""
    rng = np.random.default_rng(seed)
    n = 3 * block
    outer = np.concatenate([np.arange(block), np.arange(2 * block, n)])
    src = np.concatenate([rng.choice(outer, 200_000), np.full(6000, 5),
                          rng.choice(outer, 6000)])
    dst = np.concatenate([rng.choice(outer, 200_000), rng.choice(outer, 6000),
                          np.full(6000, 7)])
    keep = src != dst
    return T.from_edges(n, src[keep], dst[keep],
                        vals=rng.random(int(keep.sum()), dtype=np.float32),
                        dedup=True)


@pytest.mark.cuda
def test_cuda_kernel_edge_cases(cuda_graph):
    """Every block of the edge-case graph, the empty one included, with a
    run longer than a warp chunk and a slab padded to no multiple of a
    chunk or a 32-slot step; d 1 and 8, weighted and unweighted."""
    from repro_torch.kernels.tocab_spmm.kernel import tocab_spmm_cuda
    from repro_torch.kernels.tocab_spmm.ref import tocab_spmm_ref

    g = _edge_case_graph()
    bg = T.build_blocked(g, block_size=65536, pad_edges_to=1)
    assert int(bg.n_edges[1]) == 0 and bg.edge_budget % 256
    ids = torch.arange(bg.num_blocks, dtype=torch.int32, device="cuda")
    for d in (1, 8):
        x = torch.from_numpy(_np_vals(g.n, d, seed=15)).cuda()
        for ev in (bg.edge_vals, None):
            args = (x, bg.window_idx, bg.compact_idx, bg.edge_mask, ev, ids)
            kw = dict(block_size=bg.block_size, local_budget=bg.local_budget)
            before = cuda_build.launches["tocab_spmm"]
            out = tocab_spmm_cuda(*args, **kw)
            ref = tocab_spmm_ref(*args, **kw)
            torch.cuda.synchronize()
            assert cuda_build.launches["tocab_spmm"] == before + 1
            assert not bool(out[1].any())
            torch.testing.assert_close(out, ref, rtol=1e-4, atol=1e-5)


@pytest.mark.cuda
def test_cuda_kernel_more_chunks_than_resident_warps(cuda_graph):
    """Scale 22 (67 M edges), every block dense: more warp chunks of 2048
    slots than the persistent grid has warps (132 SMs x 8 CTAs x 8 warps
    at most), so every warp walks several.  Held against the function in
    float64 (the fp32 plain version adds a hub row's ~150,000 messages one
    atomic at a time, and its own rounding can exceed rtol 1e-4): positive
    values within rtol 1e-4 of each entry; standard-normal values within
    1e-4 of the entry's sum of magnitudes, since a hub row's signed terms
    can cancel to a small sum that no fp32 summation order holds to 1e-4
    of itself."""
    g = T.rmat_graph(scale=22, edge_factor=16, seed=5, weights=True)
    bg = T.build_blocked(g, block_size=1 << 21, bin_thresholds=(0.0, 0.0))
    assert bg.num_blocks * bg.edge_budget > 132 * 64 * 2048
    k, B, lb = bg.num_blocks, bg.block_size, bg.local_budget
    offs = torch.arange(k, device="cuda")[:, None]
    keep = bg.edge_mask
    rows = (bg.compact_idx.long() + offs * lb)[keep]
    cols = (bg.window_idx.long() + offs * B)[keep]

    def f64_sum(msgs):
        out = torch.zeros(k * lb, dtype=torch.float64, device="cuda")
        return out.index_add_(0, rows, msgs).view(k, lb)

    for signed in (False, True):
        rng = np.random.default_rng(16)
        xs = rng.standard_normal(g.n) if signed else rng.random(g.n)
        x = torch.from_numpy(xs.astype(np.float32)).cuda()
        for unweighted in (False, True):
            out = tocab_spmm_partials(bg, x, unweighted=unweighted).double()
            msgs = x.double()[cols]
            if not unweighted:
                msgs = msgs * bg.edge_vals[keep].double()
            ref = f64_sum(msgs)
            scale = f64_sum(msgs.abs()) if signed else ref.abs()
            err = (out - ref).abs()
            assert bool((err <= 1e-5 + 1e-4 * scale).all()), \
                float((err / (1e-5 + 1e-4 * scale)).max())
