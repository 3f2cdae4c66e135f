"""The additive message mode of the fused TOCAB kernels (``ADD_EDGE``).

``ADD_EDGE`` is the port's name for traversal's ``plus`` combine,
``d + (w if w is not None else 1.0)``: SSSP relaxes ``d + w`` under
``min``.  On the CPU the port's ``fused_pull`` / ``fused_push`` run their
plain versions with it; they are held against the reference's Pallas
kernels in interpret mode on a weighted graph, and against the reference's
slab engines on an unweighted one.  The reference's Pallas kernels skip
``combine`` on an unweighted layout (``weighted=False``) while its slab
engines call ``combine(msgs, None)``; the port follows the slab engines,
so ``ADD_EDGE`` on an unweighted layout adds 1.  min/max match exactly;
sum passes ``assert_close`` at fp32 defaults (summation order only).

The tests marked ``cuda`` launch the kernels with ``ADD_EDGE`` on every
push path and both pull routes and hold them against the plain versions;
they skip without a card.
"""
import dataclasses

import numpy as np
import pytest
import torch

import repro_torch.core as T
from repro_torch.kernels import cuda_build
from repro_torch.kernels.tocab_fused import fused_pull, fused_push
from repro_torch.kernels.tocab_fused.kernel import (MODES, fused_pull_cuda,
                                                    fused_push_cuda)
from repro_torch.kernels.tocab_fused.ops import _kernel_mode
from repro_torch.kernels.tocab_fused.ref import fused_pull_ref, fused_push_ref

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


def plus(d, w):
    """traversal's SSSP combine (``src/repro/core/traversal.py``)."""
    return d + (w if w is not None else 1.0)


PORT_FN = {"pull": fused_pull, "push": fused_push}


@pytest.fixture(scope="module")
def tiny():
    """The reference's ``rmat_graph(6, 4, seed=3)``, weighted and not, laid
    out at block size 32 in both directions, with the port's copies:
    ``{(weighted, direction): (reference layout, port layout)}``."""
    import repro.core as R

    out = {}
    for weighted in (True, False):
        g = R.rmat_graph(scale=6, edge_factor=4, seed=3, weights=weighted)
        for direction in ("pull", "push"):
            rb = R.build_blocked(g, block_size=32, direction=direction)
            out[(weighted, direction)] = (rb, port_blocked(rb))
    return g.n, out


@pytest.mark.parametrize("d", [None, 2], ids=["n", "n-by-2"])
@pytest.mark.parametrize("reduce", ["sum", "min", "max"])
@pytest.mark.parametrize("direction", ["pull", "push"])
def test_add_edge_matches_pallas_interpret(tiny, direction, reduce, d):
    """Weighted: the message is ``v + ev``, as the reference's Pallas
    kernels form it with ``plus``."""
    import jax.numpy as jnp
    from repro.kernels.tocab_fused import fused_pull as r_pull, \
        fused_push as r_push

    n, layouts = tiny
    rb, pb = layouts[(True, direction)]
    assert pb.edge_vals is not None
    rfn = r_pull if direction == "pull" else r_push
    x = _np_vals(n, d, seed=11, signed=reduce != "sum")
    ref = rfn(rb, jnp.asarray(x), reduce, plus, backend="pallas",
              interpret=True)
    assert_match(PORT_FN[direction](pb, torch.from_numpy(x), reduce,
                                    T.ADD_EDGE), ref, reduce)


@pytest.mark.parametrize("d", [None, 2], ids=["n", "n-by-2"])
@pytest.mark.parametrize("reduce", ["sum", "min", "max"])
@pytest.mark.parametrize("direction", ["pull", "push"])
def test_add_edge_unweighted_matches_slab(tiny, direction, reduce, d):
    """Unweighted: the message is ``v + 1``, as the reference's slab
    engines compute ``plus(msgs, None)``."""
    import jax.numpy as jnp
    from repro.core import tocab_pull, tocab_push

    n, layouts = tiny
    rb, pb = layouts[(False, direction)]
    assert pb.edge_vals is None
    rfn = tocab_pull if direction == "pull" else tocab_push
    x = _np_vals(n, d, seed=12, signed=reduce != "sum")
    ref = rfn(rb, jnp.asarray(x), reduce=reduce, combine=plus)
    xt = torch.from_numpy(x)
    assert_match(PORT_FN[direction](pb, xt, reduce, T.ADD_EDGE), ref, reduce)
    # the port's own engines agree: slab and balanced with ADD_EDGE
    port_engine = T.tocab_pull if direction == "pull" else T.tocab_push
    for schedule in ("uniform", "balanced"):
        assert_match(port_engine(pb, xt, reduce=reduce, combine=T.ADD_EDGE,
                                 schedule=schedule), ref, reduce)


def test_unweighted_follows_slab_not_pallas(tiny):
    """The reference's Pallas kernels skip ``combine`` on an unweighted
    layout and give ``min(d)``; its slab engines and the port give
    ``min(d + 1)``: every reached row reads 1 more than Pallas."""
    import jax.numpy as jnp
    from repro.core import tocab_pull
    from repro.kernels.tocab_fused import fused_pull as r_pull

    n, layouts = tiny
    rb, pb = layouts[(False, "pull")]
    x = _np_vals(n, seed=3)
    pallas = np.asarray(r_pull(rb, jnp.asarray(x), "min", plus,
                               backend="pallas", interpret=True))
    slab = np.asarray(tocab_pull(rb, jnp.asarray(x), reduce="min",
                                 combine=plus))
    port = fused_pull(pb, torch.from_numpy(x), "min", T.ADD_EDGE).numpy()
    reached = np.isfinite(slab)
    assert reached.sum() > n // 2
    np.testing.assert_array_equal(port, slab)
    # fp32 rounding is monotone, so min(d + 1) is min(d) + 1 exactly
    np.testing.assert_array_equal(slab[reached],
                                  pallas[reached] + np.float32(1.0))


def test_kernel_mode_mapping(tiny):
    """``(layout, combine) → (edge values, mode)``, no card needed; a
    generic callable has no kernel and the refusal names ``ADD_EDGE``."""
    _, layouts = tiny
    weighted, unweighted = layouts[(True, "pull")][1], layouts[(False,
                                                                "pull")][1]
    ev = weighted.edge_vals
    want = {
        (True, None): (ev, "mul"), (True, T.UNWEIGHTED): (None, "none"),
        (True, T.ADD_EDGE): (ev, "add_ev"),
        (False, None): (None, "none"), (False, T.UNWEIGHTED): (None, "none"),
        (False, T.ADD_EDGE): (None, "add_one"),
    }
    for (w, combine), (want_ev, want_mode) in want.items():
        got_ev, got_mode = _kernel_mode(weighted if w else unweighted,
                                        combine)
        assert got_mode == want_mode and got_mode in MODES
        assert got_ev is want_ev
    for bg in (weighted, unweighted):
        with pytest.raises(NotImplementedError, match="ADD_EDGE"):
            _kernel_mode(bg, plus)
    # ADD_EDGE is the reference's plus on both layouts
    msgs = torch.arange(4.0)
    assert torch.equal(T.ADD_EDGE(msgs, None), msgs + 1)
    assert torch.equal(T.ADD_EDGE(msgs, msgs), 2 * msgs)


def test_launcher_checks_mode_before_launching(tiny):
    """The launchers refuse an unknown mode and a mode that does not fit
    the edge values given, before they touch the card."""
    _, layouts = tiny
    bg = layouts[(True, "pull")][1]
    x = torch.zeros(bg.n, 1)
    args = (bg.window_idx, bg.compact_idx)
    tail = (bg.edge_mask, bg.id_map)
    for launch in (fused_pull_cuda, fused_push_cuda):
        with pytest.raises(ValueError, match="unknown message mode"):
            launch(x, *args, bg.edge_vals, *tail, block_size=bg.block_size,
                   mode="sub")
        with pytest.raises(ValueError, match="needs edge values"):
            launch(x, *args, None, *tail, block_size=bg.block_size,
                   mode="add_ev")
        with pytest.raises(ValueError, match="takes no edge values"):
            launch(x, *args, bg.edge_vals, *tail, block_size=bg.block_size,
                   mode="add_one")
        with pytest.raises(ValueError, match="CUDA tensor"):
            launch(x, *args, bg.edge_vals, *tail, block_size=bg.block_size,
                   mode="add_ev")


# --------------------------------------------------------------------- #
# the hand-written CUDA kernels (on the card only)
# --------------------------------------------------------------------- #
@pytest.mark.cuda
@pytest.mark.parametrize("reduce", ["sum", "min", "max"])
@pytest.mark.parametrize("direction", ["pull", "push"])
def test_cuda_add_edge_matches_plain(direction, reduce):
    """``ADD_EDGE`` on every path: push's shared-memory window (block 256),
    its combining kernel (65536, d = 1) and its global one (65536, d = 8);
    pull's streaming kernel (d = 1) and its row kernel (d = 8).  Weighted
    (add-ev) and the same layout without edge values (add-one); one launch
    a call, and signed values past the identity (an ``inf`` plus a weight
    stays ``inf``)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    g = T.rmat_graph(scale=12, edge_factor=8, seed=11, weights=True)
    fused, plain = ((fused_pull, fused_pull_ref) if direction == "pull"
                    else (fused_push, fused_push_ref))
    name = f"fused_{direction}"
    for bs in (256, 65536):
        weighted = T.build_blocked(g, block_size=bs, direction=direction)
        for bg in (weighted, dataclasses.replace(weighted, edge_vals=None)):
            for d in (None, 8):
                x = torch.from_numpy(
                    _np_vals(g.n, d, seed=13, signed=reduce != "sum")).cuda()
                if reduce == "min":
                    x[::7] = float("inf")  # unreached vertices of SSSP
                eps_opts = (None, (0.85, 0.01)) if reduce == "sum" else (None,)
                for eps in eps_opts:
                    before = cuda_build.launches[name]
                    out = fused(bg, x, reduce, T.ADD_EDGE, eps)
                    ref = plain(bg, x, reduce, T.ADD_EDGE, eps)
                    torch.cuda.synchronize()
                    assert cuda_build.launches[name] == before + 1
                    if reduce == "sum":
                        torch.testing.assert_close(out, ref, rtol=1e-4,
                                                   atol=1e-6)
                    else:
                        assert torch.equal(out, ref)
