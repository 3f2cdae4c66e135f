"""Port parity of the §3.1 ablations (``repro_torch.core.ablations``
against ``repro.core.ablations``): the 2D-blocked layout must equal the
reference's array for array; both engines must give the reference's and
their own package's flat ``baseline_pull`` result, ``min`` / ``max``
exactly and ``sum`` under ``torch.testing.assert_close`` at fp32 defaults
(the packages add the same terms in another order).

Both packages' graphs are built from the same numpy CSR arrays.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as R
from repro.core import ablations as RA
import repro_torch.core as T
from repro_torch.core import ablations as TA

LAYOUT_ARRAYS = ("src_rel", "dst_rel", "edge_mask", "edge_vals")
LAYOUT_META = ("n", "m", "block_size", "tiles_per_side", "edge_budget")


def _ragged_graph():
    """n = 2500 at block 1000: a last block of 500 rows, and tile (1, 2)
    (sources in [1000, 2000), destinations in [2000, 2500)) holds no
    edge."""
    rng = np.random.default_rng(11)
    n = 2500
    src = rng.integers(0, n, 12_000)
    dst = rng.integers(0, n, 12_000)
    keep = (src != dst) & ~(((src // 1000) == 1) & ((dst // 1000) == 2))
    return R.from_edges(n, src[keep], dst[keep],
                        vals=rng.random(int(keep.sum()), dtype=np.float32),
                        dedup=True)


GRAPHS = {
    "rmat10": lambda: R.rmat_graph(10, 8, seed=3, weights=True),
    "rmat11": lambda: R.rmat_graph(11, 8, seed=4, weights=True),
    "rmat12": lambda: R.rmat_graph(12, 8, seed=5, weights=True),
    "ragged": _ragged_graph,
}
CASES = [("rmat10", 32), ("rmat11", 128), ("rmat12", 1000),
         ("ragged", 1000)]
_MEMO: dict = {}


def _pair(name: str, weighted: bool):
    """(reference Graph, port Graph) over the same numpy arrays."""
    key = (name, weighted)
    if key not in _MEMO:
        g = GRAPHS[name]()
        vals = g.vals if weighted else None
        _MEMO[key] = (R.Graph(g.n, g.rowptr, g.colidx, vals),
                      T.Graph(g.n, g.rowptr, g.colidx, vals))
    return _MEMO[key]


def _values(n, d=None, seed=0):
    x = np.random.default_rng(seed).random(
        (n,) if d is None else (n, d)).astype(np.float32)
    return jnp.asarray(x), torch.from_numpy(x.copy())


def _assert_match(out, ref, reduce):
    ref = torch.from_numpy(np.array(ref)) if not torch.is_tensor(ref) \
        else ref
    assert out.shape == ref.shape and out.dtype == ref.dtype
    if reduce == "sum":
        torch.testing.assert_close(out, ref)
    else:
        assert torch.equal(out, ref)


def _assert_layout_equal(port, ref):
    for f in LAYOUT_META:
        assert getattr(port, f) == getattr(ref, f), f
    for f in LAYOUT_ARRAYS:
        a, b = getattr(port, f), getattr(ref, f)
        if b is None:
            assert a is None, f
            continue
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=f)


@pytest.mark.parametrize("weighted", [True, False],
                         ids=["weighted", "unweighted"])
@pytest.mark.parametrize("name,block", CASES)
def test_blocked_2d_equals_reference(name, block, weighted):
    rg, tg = _pair(name, weighted)
    ref = RA.build_blocked_2d(rg, block_size=block)
    port = TA.build_blocked_2d(tg, block_size=block, device="cpu")
    _assert_layout_equal(port, ref)
    assert port.num_tiles == ref.tiles_per_side ** 2
    # the DeviceGraph's edge lists hold the same CSR order
    via_dg = TA.build_blocked_2d(T.DeviceGraph.from_host(tg, device="cpu"),
                                 block_size=block, device="cpu")
    _assert_layout_equal(via_dg, ref)


def test_ragged_graph_has_an_empty_tile():
    rg, tg = _pair("ragged", True)
    port = TA.build_blocked_2d(tg, block_size=1000, device="cpu")
    per_tile = port.edge_mask.sum(1)
    assert port.tiles_per_side == 3 and tg.n % 1000
    assert int(per_tile[1 * 3 + 2]) == 0
    assert int((per_tile == 0).sum()) == 1 and int(per_tile.sum()) == tg.m


def test_blocked_2d_pad_edges_to():
    rg, tg = _pair("rmat10", True)
    ref = RA.build_blocked_2d(rg, block_size=256, pad_edges_to=8)
    port = TA.build_blocked_2d(tg, block_size=256, pad_edges_to=8,
                               device="cpu")
    _assert_layout_equal(port, ref)
    assert port.edge_budget % 8 == 0


@pytest.mark.parametrize("reduce", ["sum", "min", "max"])
@pytest.mark.parametrize("weighted", [True, False],
                         ids=["weighted", "unweighted"])
@pytest.mark.parametrize("name,block", CASES)
def test_pull_2d_matches_reference_and_base(name, block, weighted, reduce):
    rg, tg = _pair(name, weighted)
    xj, xt = _values(tg.n, seed=block)
    ref = RA.tocab_pull_2d(RA.build_blocked_2d(rg, block_size=block), xj,
                           reduce=reduce)
    out = TA.tocab_pull_2d(
        TA.build_blocked_2d(tg, block_size=block, device="cpu"), xt,
        reduce=reduce)
    _assert_match(out, ref, reduce)
    _assert_match(out, T.baseline_pull(
        T.DeviceGraph.from_host(tg, device="cpu"), xt, reduce), reduce)
    _assert_match(torch.from_numpy(np.array(ref)), R.baseline_pull(
        R.DeviceGraph.from_host(rg), xj, reduce), reduce)


def test_pull_2d_refuses_2d_values():
    _, tg = _pair("rmat10", True)
    bg = TA.build_blocked_2d(tg, block_size=128, device="cpu")
    with pytest.raises(ValueError, match=r"\(n,\) values"):
        TA.tocab_pull_2d(bg, torch.ones(tg.n, 4))
    with pytest.raises(ValueError, match="unknown reduce"):
        TA.tocab_pull_2d(bg, torch.ones(tg.n), reduce="prod")


@pytest.mark.parametrize("reduce", ["sum", "min", "max"])
@pytest.mark.parametrize("num_bins", [4, 32])
@pytest.mark.parametrize("weighted", [True, False],
                         ids=["weighted", "unweighted"])
@pytest.mark.parametrize("name", ["rmat11", "ragged"])
def test_prop_blocking_matches_reference_and_base(name, weighted, num_bins,
                                                  reduce):
    rg, tg = _pair(name, weighted)
    rdg = R.DeviceGraph.from_host(rg)
    tdg = T.DeviceGraph.from_host(tg, device="cpu")
    xj, xt = _values(tg.n, seed=num_bins)
    ref = RA.propagation_blocking_pull(rdg, xj, num_bins=num_bins,
                                       reduce=reduce)
    out = TA.propagation_blocking_pull(tdg, xt, num_bins=num_bins,
                                       reduce=reduce)
    _assert_match(out, ref, reduce)
    _assert_match(out, T.baseline_pull(tdg, xt, reduce), reduce)
    _assert_match(torch.from_numpy(np.array(ref)),
                  R.baseline_pull(rdg, xj, reduce), reduce)


@pytest.mark.parametrize("reduce", ["sum", "min", "max"])
@pytest.mark.parametrize("num_bins", [4, 32])
def test_prop_blocking_feature_rows(num_bins, reduce):
    """(n, 4) values on the unweighted graph, as the reference takes them."""
    rg, tg = _pair("rmat12", False)
    rdg = R.DeviceGraph.from_host(rg)
    tdg = T.DeviceGraph.from_host(tg, device="cpu")
    xj, xt = _values(tg.n, d=4, seed=7)
    ref = RA.propagation_blocking_pull(rdg, xj, num_bins=num_bins,
                                       reduce=reduce)
    out = TA.propagation_blocking_pull(tdg, xt, num_bins=num_bins,
                                       reduce=reduce)
    assert out.shape == (tg.n, 4)
    _assert_match(out, ref, reduce)
    _assert_match(out, T.baseline_pull(tdg, xt, reduce), reduce)
