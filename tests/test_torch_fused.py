"""Port parity of the fused TOCAB pipeline (``repro_torch.kernels.tocab_fused``).

On the CPU the port's ``fused_pull`` / ``fused_push`` / ``fused_edge_reduce``
run their plain PyTorch versions; they are held against the reference's
fused path (``backend="jax"``, and on one tiny graph the Pallas kernels in
interpret mode, as tests/test_fused.py runs them).  min/max match exactly;
sum passes ``assert_close`` at fp32 defaults (summation order only).

The tests marked ``cuda`` launch the hand-written kernels and hold them
against the plain versions on the card; they skip without one.  They import
nothing of JAX, so ``pytest -m cuda tests/test_torch_fused.py`` runs on a
machine that has none.
"""
import dataclasses

import numpy as np
import pytest
import torch

import repro_torch.core as T
from repro_torch.kernels.tocab_fused import (fused_edge_reduce, fused_pull,
                                             fused_push)
from repro_torch.kernels import cuda_build
from repro_torch.kernels.tocab_fused.ref import fused_pull_ref, fused_push_ref
from repro_torch.obs.metrics import registry as port_registry

ARRAY_FIELDS = ("window_idx", "compact_idx", "edge_mask", "id_map",
                "n_local", "n_edges", "edge_perm", "edge_vals", "n_window")
META_FIELDS = ("n", "m", "direction", "block_size", "num_blocks",
               "edge_budget", "local_budget", "fingerprint")


def port_blocked(bg, device="cpu"):
    arrays = {f: None if getattr(bg, f) is None else np.asarray(getattr(bg, f))
              for f in ARRAY_FIELDS}
    meta = {f: getattr(bg, f) for f in META_FIELDS}
    meta["schedule"] = dataclasses.asdict(bg.schedule)
    return T.blocked_from_arrays(arrays, meta, device=device)


def _np_vals(n, d=None, seed=0, signed=False):
    rng = np.random.default_rng(seed)
    shape = (n,) if d is None else (n, d)
    return (rng.standard_normal(shape) if signed
            else rng.random(shape)).astype(np.float32)


def assert_match(port_out, ref_out, reduce):
    ref = torch.from_numpy(np.array(ref_out)).to(port_out.device)
    assert port_out.dtype == ref.dtype and port_out.shape == ref.shape
    if reduce == "sum":
        torch.testing.assert_close(port_out, ref)
    else:
        assert torch.equal(port_out, ref), (port_out - ref).abs().max()


@pytest.fixture(scope="module")
def ref_layouts():
    """The reference's graph and layouts, each with the port's copy of it:
    ``(g, {direction: (reference layout, port layout)})``.  JAX is imported
    here only, so the cuda tests below run where JAX is absent."""
    import repro.core as R

    g = R.rmat_graph(scale=9, edge_factor=8, seed=7, weights=True)
    layouts = {}
    for direction in ("pull", "push"):
        rb = R.build_blocked(g, block_size=128, direction=direction)
        layouts[direction] = (rb, port_blocked(rb))
    return g, layouts


@pytest.fixture(scope="module")
def port_layouts():
    g = T.rmat_graph(scale=9, edge_factor=8, seed=7, weights=True)
    return (g, T.build_blocked(g, block_size=128, direction="pull",
                               device="cpu"),
            T.build_blocked(g, block_size=128, direction="push",
                            device="cpu"))


# --------------------------------------------------------------------- #
# plain versions (CPU) against the reference's fused path
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("reduce,eps", [
    ("sum", None), ("sum", (0.85, 0.003)), ("min", None), ("max", None),
], ids=["sum", "sum-epilogue", "min", "max"])
@pytest.mark.parametrize("direction", ["pull", "push"])
def test_fused_matches_reference(ref_layouts, direction, reduce, eps):
    import jax.numpy as jnp
    from repro.core.balance import UNWEIGHTED as R_UNWEIGHTED
    from repro.kernels.tocab_fused import fused_pull as r_pull, \
        fused_push as r_push

    g, layouts = ref_layouts
    rb, pb = layouts[direction]
    rfn, pfn = (r_pull, fused_pull) if direction == "pull" \
        else (r_push, fused_push)
    for d in (None, 4):
        x = _np_vals(g.n, d, seed=1, signed=reduce != "sum")
        combines = [(None, None)]
        if d is None:  # each case is a JAX compile; width is independent
            combines.append((R_UNWEIGHTED, T.UNWEIGHTED))
        for rc, pc in combines:
            ref = rfn(rb, jnp.asarray(x), reduce, rc, eps, backend="jax")
            assert_match(pfn(pb, torch.from_numpy(x), reduce, pc, eps), ref,
                         reduce)


@pytest.mark.parametrize("direction", ["pull", "push"])
def test_fused_matches_pallas_interpret(direction):
    """On one tiny graph, the reference's Pallas kernels themselves (in
    interpret mode) — scalar and (n, d) values, with the epilogue."""
    import jax.numpy as jnp
    import repro.core as R
    from repro.kernels.tocab_fused import fused_pull as r_pull, \
        fused_push as r_push

    g = R.rmat_graph(scale=6, edge_factor=4, seed=3, weights=True)
    rb = R.build_blocked(g, block_size=32, direction=direction)
    pb = port_blocked(rb)
    rfn, pfn = (r_pull, fused_pull) if direction == "pull" \
        else (r_push, fused_push)
    for d, eps in ((None, None), (2, (0.5, 0.25))):
        x = _np_vals(g.n, d, seed=7)
        ref = rfn(rb, jnp.asarray(x), "sum", None, eps, backend="pallas",
                  interpret=True)
        assert_match(pfn(pb, torch.from_numpy(x), "sum", None, eps), ref,
                     "sum")


@pytest.mark.parametrize("reduce", ["sum", "min", "max"])
@pytest.mark.parametrize("direction", ["pull", "push"])
def test_fused_edge_reduce_matches_reference(ref_layouts, direction, reduce):
    import jax.numpy as jnp
    from repro.kernels.tocab_fused import fused_edge_reduce as r_edge

    g, layouts = ref_layouts
    rb, pb = layouts[direction]
    eps = (2.0, 1.0) if reduce == "sum" else None
    for d in (None, 3):
        e = _np_vals(g.m, d, seed=2, signed=reduce != "sum")
        ref = r_edge(rb, jnp.asarray(e), reduce, eps)
        assert_match(fused_edge_reduce(pb, torch.from_numpy(e), reduce, eps),
                     ref, reduce)


def test_fused_combine_semiring(ref_layouts):
    """A generic combine runs on CPU tensors (plain version)."""
    import jax.numpy as jnp
    from repro.kernels.tocab_fused import fused_pull as r_pull, \
        fused_push as r_push

    g, layouts = ref_layouts
    x = _np_vals(g.n, seed=3)
    plus = lambda v, ev: v + ev  # noqa: E731
    for rfn, pfn, direction in ((r_pull, fused_pull, "pull"),
                                (r_push, fused_push, "push")):
        rb, pb = layouts[direction]
        ref = rfn(rb, jnp.asarray(x), "min", plus, backend="jax")
        assert_match(pfn(pb, torch.from_numpy(x), "min", plus), ref, "min")


# --------------------------------------------------------------------- #
# the port's own invariants (no JAX)
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("reduce", ["sum", "min", "max"])
def test_fused_equals_slab(port_layouts, reduce):
    g, pull, push = port_layouts
    for d in (None, 3):
        x = torch.from_numpy(_np_vals(g.n, d, seed=4, signed=reduce != "sum"))
        for fn, bg in ((T.tocab_pull, pull), (T.tocab_push, push)):
            fused = fn(bg, x, reduce=reduce, impl="fused")
            slab = fn(bg, x, reduce=reduce)
            if reduce == "sum":
                torch.testing.assert_close(fused, slab)
            else:
                assert torch.equal(fused, slab)
    e = torch.from_numpy(_np_vals(g.m, seed=5))
    for bg in (pull, push):
        torch.testing.assert_close(
            T.tocab_edge_reduce(bg, e, impl="fused"), T.tocab_edge_reduce(bg, e))


def test_fused_epilogue_requires_sum(port_layouts):
    g, pull, push = port_layouts
    x = torch.from_numpy(_np_vals(g.n))
    for fn, bg in ((T.tocab_pull, pull), (T.tocab_push, push)):
        with pytest.raises(ValueError, match="sum"):
            fn(bg, x, reduce="min", epilogue=(1.0, 0.0), impl="fused")
    with pytest.raises(ValueError, match="sum"):
        fused_edge_reduce(pull, torch.zeros(g.m), "max", (1.0, 0.0))


def test_fused_epilogue_folds_affine_apply(port_layouts):
    g, pull, push = port_layouts
    x = torch.from_numpy(_np_vals(g.n, seed=6))
    eps = (0.85, torch.tensor(0.15 / g.n))  # add may live on the device
    for fn, bg in ((T.tocab_pull, pull), (T.tocab_push, push)):
        torch.testing.assert_close(fn(bg, x, epilogue=eps, impl="fused"),
                                   fn(bg, x) * 0.85 + 0.15 / g.n)


def test_block_order_is_validated_and_moot(port_layouts):
    g, pull, push = port_layouts
    x = torch.from_numpy(_np_vals(g.n, seed=8))
    order = T.fused_block_order(push)
    assert sorted(order) == list(range(push.num_blocks))
    ref = fused_push(push, x, block_order=None)
    assert torch.equal(fused_push(push, x, block_order=order), ref)
    assert torch.equal(fused_push(dataclasses.replace(push, schedule=None), x),
                       ref)
    rev = tuple(reversed(range(pull.num_blocks)))
    torch.testing.assert_close(fused_pull(pull, x, block_order=rev),
                               fused_pull(pull, x))
    with pytest.raises(ValueError, match="permutation"):
        fused_pull(pull, x, block_order=(0, 0))


def test_fused_dispatch_errors(port_layouts):
    g, pull, push = port_layouts
    x = torch.from_numpy(_np_vals(g.n))
    with pytest.raises(ValueError, match="backend"):
        fused_pull(pull, x, backend="pallas")
    with pytest.raises(ValueError, match="card"):
        fused_pull(pull, x, backend="cuda")  # a CPU tensor never launches
    with pytest.raises(ValueError, match="layout"):
        fused_pull(push, x)
    with pytest.raises(ValueError, match="balanced"):
        T.tocab_pull(pull, x, schedule="balanced", impl="fused")
    with pytest.raises(ValueError, match="impl"):
        T.tocab_pull(pull, x, impl="warp")


def test_fused_obs_counters(port_layouts):
    g, pull, _ = port_layouts
    blocks = port_registry.counter("tocab.fused_blocks")
    saved = port_registry.counter("tocab.partial_hbm_bytes_saved")
    labels = dict(engine="fused_pull", direction="pull")
    b0, s0 = blocks.value(**labels), saved.value(**labels)
    T.tocab_pull(pull, torch.from_numpy(_np_vals(g.n)), impl="fused")
    assert blocks.value(**labels) == b0 + pull.num_blocks
    assert saved.value(**labels) == s0 + pull.num_blocks * pull.local_budget * 4


def test_cuda_kernel_loader_is_lazy():
    """Importing the ops builds nothing and launches nothing; the sources
    the shared loader compiles, one per kernel of every family, are in the
    checkout, each with its library beside it under ``_build/``."""
    import repro_torch.kernels.tocab_spmm.ops  # noqa: F401

    assert set(cuda_build.SOURCES) == {"fused_pull", "fused_push",
                                       "tocab_spmm", "flash_attention",
                                       "flash_attention_wgmma",
                                       "flash_attention_bwd",
                                       "flash_attention_bwd_wgmma",
                                       "flash_decode", "embedding_bag"}
    for name in cuda_build.SOURCES:
        src = cuda_build._source(name)
        assert src.is_file()
        assert cuda_build._lib_path(name).parent == \
            src.parent.parent / "_build"
    assert not cuda_build._LIBS


# --------------------------------------------------------------------- #
# the hand-written CUDA kernels (on the card only)
# --------------------------------------------------------------------- #
@pytest.fixture
def cuda_layouts():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    g = T.rmat_graph(scale=12, edge_factor=8, seed=11, weights=True)
    return g, {(direction, bs): T.build_blocked(g, block_size=bs,
                                                direction=direction)
               for direction in ("pull", "push") for bs in (256, 65536)}


@pytest.mark.cuda
@pytest.mark.parametrize("reduce", ["sum", "min", "max"])
@pytest.mark.parametrize("direction", ["pull", "push"])
def test_cuda_kernel_matches_plain(cuda_layouts, direction, reduce):
    """Block size 256 takes push's shared-memory window path, 65536 its
    global one.  sum: atomics reorder the adds (rtol 1e-4, see
    chip_smoke.py); min/max: exact."""
    g, layouts = cuda_layouts
    fused, plain = ((fused_pull, fused_pull_ref) if direction == "pull"
                    else (fused_push, fused_push_ref))
    for bs in (256, 65536):
        bg = layouts[(direction, bs)]
        for d in (None, 8):
            x = torch.from_numpy(
                _np_vals(g.n, d, seed=9, signed=reduce != "sum")).cuda()
            for combine in (None, T.UNWEIGHTED):
                eps_opts = (None, (0.85, 0.01)) if reduce == "sum" else (None,)
                for eps in eps_opts:
                    before = cuda_build.launches[f"fused_{direction}"]
                    out = fused(bg, x, reduce, combine, eps)
                    ref = plain(bg, x, reduce, combine, eps)
                    torch.cuda.synchronize()
                    assert cuda_build.launches[f"fused_{direction}"] == \
                        before + 1
                    if reduce == "sum":
                        torch.testing.assert_close(out, ref, rtol=1e-4,
                                                   atol=1e-6)
                    else:
                        assert torch.equal(out, ref)


@pytest.mark.cuda
def test_cuda_kernel_refuses_what_it_cannot_run(cuda_layouts):
    g, layouts = cuda_layouts
    bg = layouts[("pull", 256)]
    x = torch.rand(g.n, device="cuda")
    with pytest.raises(NotImplementedError, match="combine"):
        fused_pull(bg, x, "min", lambda v, ev: v + ev)
    with pytest.raises(TypeError, match="dtype"):
        fused_pull(bg, x.double())
    with pytest.raises(NotImplementedError):
        fused_pull(bg, x.view(-1, 1, 1).expand(-1, 2, 2).contiguous())


def _edge_case_graph(seed=1, block=65536):
    """Three blocks of ``block`` rows, the middle one with no edge in either
    direction; source 5 pushes to 6000 destinations and destination 7
    pulls from 6000 sources (runs of one compact id longer than the d > 1
    push kernel's 4096-slot chunk), over 200,000 random edges among the
    outer blocks (as chip_smoke.py's edge-case graph)."""
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


def _check_kernel(bg, n, reduce):
    """The layout's kernel against the plain version over d None and 8,
    weighted, unweighted and additive (``ADD_EDGE``), with and without the
    epilogue."""
    fused, plain = ((fused_pull, fused_pull_ref) if bg.direction == "pull"
                    else (fused_push, fused_push_ref))
    for d in (None, 8):
        x = torch.from_numpy(
            _np_vals(n, d, seed=19, signed=reduce != "sum")).cuda()
        for combine in (None, T.UNWEIGHTED, T.ADD_EDGE):
            for eps in ((None, (0.85, 0.01)) if reduce == "sum" else (None,)):
                out = fused(bg, x, reduce, combine, eps)
                ref = plain(bg, x, reduce, combine, eps)
                torch.cuda.synchronize()
                if reduce == "sum":
                    torch.testing.assert_close(out, ref, rtol=1e-4, atol=1e-6)
                else:
                    assert torch.equal(out, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("reduce", ["sum", "min", "max"])
def test_cuda_push_edge_cases(reduce):
    """The global-window push on the edge-case graph: an empty block, a run
    longer than the d > 1 kernel's 4096-slot chunk, padded id_map entries,
    and a slab padded to no multiple of a chunk or of a warp's 4 batched
    32-slot steps (pad_edges_to=1)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    g = _edge_case_graph()
    bg = T.build_blocked(g, block_size=65536, direction="push",
                         pad_edges_to=1)
    assert int(bg.n_edges[1]) == 0 and bg.edge_budget % 128
    assert int(bg.n_local.min()) < bg.local_budget  # padded id_map entries
    before = cuda_build.launches["fused_push"]
    _check_kernel(bg, g.n, reduce)
    assert cuda_build.launches["fused_push"] > before


@pytest.mark.cuda
@pytest.mark.parametrize("reduce", ["sum", "min", "max"])
def test_cuda_pull_edge_cases(reduce):
    """The pull kernels (streaming at d = 1, one CTA per chunk at d = 8) on
    the edge-case graph: destination 7's 6000 sources make one run of a
    compact id longer than a 512-slot warp chunk (and the d = 8 kernel's
    4096-slot chunk), carried across steps and added once a chunk; an
    empty block; padded id_map entries; a slab padded to no
    multiple of a chunk or of a warp's 4 batched 32-slot steps
    (pad_edges_to=1)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    g = _edge_case_graph()
    bg = T.build_blocked(g, block_size=65536, direction="pull",
                         pad_edges_to=1)
    assert int(bg.n_edges[1]) == 0 and bg.edge_budget % 128
    assert int(bg.n_local.min()) < bg.local_budget  # padded id_map entries
    before = cuda_build.launches["fused_pull"]
    _check_kernel(bg, g.n, reduce)
    assert cuda_build.launches["fused_pull"] == before + 2 * (
        3 * (2 if reduce == "sum" else 1))


@pytest.mark.cuda
def test_cuda_pull_more_chunks_than_resident_warps():
    """Scale 22 (67 M edges): more 512-slot warp chunks than the card holds
    warps at once (at most 64 an SM), so the streaming kernel's CTAs run
    in many waves, across both blocks.  The sum is held against the plain
    version run in float64 (a hub row's ~150,000 fp32 terms drift in the
    plain version's own sequential atomics)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    g = T.rmat_graph(scale=22, edge_factor=16, seed=5, weights=True)
    bg = T.build_blocked(g, block_size=1 << 21, direction="pull")
    assert bg.num_blocks * -(-bg.edge_budget // 512) > 132 * 64
    x = torch.from_numpy(_np_vals(g.n, seed=21)).cuda()
    for combine in (T.UNWEIGHTED, T.ADD_EDGE):
        for reduce in ("sum", "min"):
            out = fused_pull(bg, x, reduce, combine)
            if reduce == "sum":
                ref = fused_pull_ref(bg, x.double(), reduce, combine)
                torch.testing.assert_close(out.double(), ref, rtol=1e-4,
                                           atol=1e-6)
            else:
                assert torch.equal(out, fused_pull_ref(bg, x, reduce,
                                                       combine))


@pytest.mark.cuda
def test_cuda_push_more_chunks_than_resident_warps():
    """Scale 22 (67 M edges): more CTA chunks of 65,536 slots (the d = 1
    combining kernel) than its persistent grid has CTAs (one a SM; two
    allowed for), so every CTA walks several and flushes its table between
    blocks.  The sum is
    held against the plain version run in float64: in fp32 it adds the
    ~150,000 messages of a hub row one atomic at a time, and its own
    rounding can then exceed rtol 1e-4 on a few rows."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    g = T.rmat_graph(scale=22, edge_factor=16, seed=5)
    bg = T.build_blocked(g, block_size=1 << 21, direction="push")
    assert bg.num_blocks * bg.edge_budget > 132 * 2 * 65536
    x = torch.from_numpy(_np_vals(g.n, seed=20)).cuda()
    for reduce in ("sum", "max"):
        out = fused_push(bg, x, reduce, T.UNWEIGHTED)
        if reduce == "sum":
            ref = fused_push_ref(bg, x.double(), reduce, T.UNWEIGHTED)
            torch.testing.assert_close(out.double(), ref, rtol=1e-4,
                                       atol=1e-6)
        else:
            assert torch.equal(out, fused_push_ref(bg, x, reduce,
                                                   T.UNWEIGHTED))
