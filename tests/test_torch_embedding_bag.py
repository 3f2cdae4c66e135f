"""Port parity of EmbeddingBag (``repro_torch.kernels.embedding_bag``)
against the reference package.

On the CPU the port runs its plain version (``ref.py``); it is held against
the reference's XLA path (``backend="xla"``) and its Pallas kernel in
interpret mode (``backend="pallas"``, as ``tests/test_kernels.py`` runs it)
on the same numpy inputs, at the reference's own kernel tolerance
``rtol = atol = 2e-5`` (fp32 sums in another order).  The parity sweeps use
in-range ids only: for ids outside ``[0, V)`` the reference's two backends
disagree, and the port follows its Pallas kernel (pinned below).

The tests marked ``cuda`` launch the hand-written kernel and hold it against
the plain version on the card; they skip without one.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import cuda_build
from repro_torch.kernels.embedding_bag import embedding_bag, embedding_bag_ref
from repro_torch.kernels.embedding_bag.kernel import embedding_bag_cuda

TOL = dict(rtol=2e-5, atol=2e-5)
#: bf16 results: both sides sum in fp32 and round once, so they differ by at
#: most one bf16 ulp (2⁻⁷ relative) where a rounding boundary falls between
#: their fp32 sums; the atol covers the fp32 sums' own difference (~1e-7
#: per term here) at results near 0
BF16_TOL = dict(rtol=2.0 ** -7, atol=1e-5)

#: the reference kernel test's sweep: (V, d, B, L, rows_per_block, bag_tile)
SWEEP = [(1000, 32, 64, 8, 256, 32), (5000, 64, 37, 5, 1024, 16),
         (128, 16, 128, 3, 64, 64)]


def _inputs(V, d, B, L, seed):
    rng = np.random.default_rng(seed)
    tbl = rng.standard_normal((V, d)).astype(np.float32)
    idx = rng.integers(0, V, (B, L)).astype(np.int32)
    w = rng.random((B, L)).astype(np.float32)
    return tbl, idx, w


def _ref(tbl, idx, w, mode, backend, **kw):
    import jax.numpy as jnp
    from repro.kernels.embedding_bag.ops import embedding_bag as r_bag

    out = r_bag(jnp.asarray(tbl), jnp.asarray(idx),
                None if w is None else jnp.asarray(w), mode=mode,
                backend=backend, **kw)
    return np.asarray(out.astype(jnp.float32))


def _port(tbl, idx, w, mode, id_dtype=torch.int32, table_dtype=None):
    t = torch.from_numpy(tbl)
    out = embedding_bag(t if table_dtype is None else t.to(table_dtype),
                        torch.from_numpy(idx).to(id_dtype),
                        None if w is None else torch.from_numpy(w), mode=mode)
    return out


@pytest.mark.parametrize("V,d,B,L,rows,btile", SWEEP)
@pytest.mark.parametrize("mode", ["sum", "mean"])
def test_embedding_bag_sweep_matches_reference(V, d, B, L, rows, btile, mode):
    tbl, idx, w = _inputs(V, d, B, L, seed=V + d)
    out = _port(tbl, idx, w, mode)
    assert out.dtype == torch.float32 and out.shape == (B, d)
    np.testing.assert_allclose(out.numpy(), _ref(tbl, idx, w, mode, "xla"),
                               **TOL)
    np.testing.assert_allclose(
        out.numpy(), _ref(tbl, idx, w, mode, "pallas", rows_per_block=rows,
                          bag_tile=btile), **TOL)


@pytest.mark.parametrize("mode", ["sum", "mean"])
@pytest.mark.parametrize("id_dtype", [torch.int32, torch.int64])
def test_embedding_bag_unit_weights_and_id_types(mode, id_dtype):
    """``weights=None`` is all ones in both modes; int32 and int64 ids give
    the same result."""
    tbl, idx, _ = _inputs(777, 24, 16, 4, seed=1)
    out = _port(tbl, idx, None, mode, id_dtype=id_dtype)
    np.testing.assert_allclose(out.numpy(), _ref(tbl, idx, None, mode, "xla"),
                               **TOL)
    np.testing.assert_allclose(
        out.numpy(), _ref(tbl, idx, None, mode, "pallas",
                          rows_per_block=128, bag_tile=8), **TOL)


def test_embedding_bag_out_of_range_ids_follow_the_pallas_kernel():
    """An id < 0 or ≥ V contributes nothing, as in the reference's Pallas
    kernel (its XLA path wraps -1 to the last row and gives NaN for
    ids ≥ V); the weight still counts in ``mean``'s denominator."""
    tbl = np.arange(20, dtype=np.float32).reshape(10, 2)
    idx = np.array([[0, 9, -1], [10, 3, 12]], np.int32)
    want = np.array([[18.0, 20.0], [6.0, 7.0]], np.float32)
    for id_dtype in (torch.int32, torch.int64):
        out = _port(tbl, idx, None, "sum", id_dtype=id_dtype)
        np.testing.assert_array_equal(out.numpy(), want)
    np.testing.assert_array_equal(
        _ref(tbl, idx, None, "sum", "pallas", rows_per_block=8, bag_tile=8),
        want)
    np.testing.assert_allclose(
        _port(tbl, idx, None, "mean").numpy(), want / 3, **TOL)
    np.testing.assert_allclose(
        _port(tbl, idx, None, "mean").numpy(),
        _ref(tbl, idx, None, "mean", "pallas", rows_per_block=8, bag_tile=8),
        **TOL)
    # the row an out-of-range id would alias is never added: a NaN there
    # stays out of every bag that does not name it
    tbl[0] = np.nan
    out = _port(tbl, np.array([[-1, 5], [10, 1]], np.int32), None, "sum")
    np.testing.assert_array_equal(out.numpy(), [[10.0, 11.0], [2.0, 3.0]])


def test_embedding_bag_mean_of_a_zero_weight_bag_is_zero():
    tbl, idx, w = _inputs(100, 16, 6, 5, seed=2)
    w[2] = 0.0
    out = _port(tbl, idx, w, "mean")
    np.testing.assert_array_equal(out[2].numpy(), np.zeros(16, np.float32))
    np.testing.assert_allclose(out.numpy(), _ref(tbl, idx, w, "mean", "xla"),
                               **TOL)
    np.testing.assert_allclose(
        out.numpy(), _ref(tbl, idx, w, "mean", "pallas", rows_per_block=64,
                          bag_tile=8), **TOL)


def test_embedding_bag_bf16_table_returns_bf16():
    """The result has the table's dtype, as the Pallas kernel's (the XLA
    path returns fp32): the fp32 sum of the bf16 rows, rounded once."""
    tbl, idx, w = _inputs(300, 16, 24, 7, seed=3)
    t16 = torch.from_numpy(tbl).bfloat16()
    out = _port(tbl, idx, w, "sum", table_dtype=torch.bfloat16)
    assert out.dtype == torch.bfloat16 and out.shape == (24, 16)
    exact = (t16.double()[torch.from_numpy(idx).long()]
             * torch.from_numpy(w).double()[..., None]).sum(dim=1)
    torch.testing.assert_close(out.float(), exact.float(), **BF16_TOL)
    import jax.numpy as jnp
    from repro.kernels.embedding_bag.ops import embedding_bag as r_bag

    ref = r_bag(jnp.asarray(t16.float().numpy()).astype(jnp.bfloat16),
                jnp.asarray(idx), jnp.asarray(w), backend="pallas",
                rows_per_block=304, bag_tile=8)
    assert ref.dtype == jnp.bfloat16
    torch.testing.assert_close(
        out.float(), torch.from_numpy(np.array(ref.astype(jnp.float32))),
        **BF16_TOL)


def test_embedding_bag_refusals():
    tbl, idx, w = _inputs(50, 8, 4, 3, seed=4)
    t, i = torch.from_numpy(tbl), torch.from_numpy(idx)
    with pytest.raises(ValueError, match="'cuda'"):
        embedding_bag(t, i, backend="pallas")
    with pytest.raises(ValueError, match="card"):
        embedding_bag(t, i, backend="cuda")
    with pytest.raises(ValueError, match="backend"):
        embedding_bag(t, i, backend="xla")
    with pytest.raises(ValueError, match="mode"):
        embedding_bag(t, i, mode="max")
    with pytest.raises(ValueError, match="mode"):
        embedding_bag_ref(t, i, mode="max")
    with pytest.raises(ValueError, match="CUDA"):
        embedding_bag_cuda(t, i)
    torch.testing.assert_close(embedding_bag(t, i, backend="torch"),
                               embedding_bag_ref(t, i))


# --------------------------------------------------------------------- #
# the hand-written CUDA kernel (on the card only)
# --------------------------------------------------------------------- #
@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("table_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [16, 24, 33, 64, 300])
def test_cuda_embedding_bag_matches_plain(card, table_dtype, d):
    """Vector (d a multiple of 16 bytes) and scalar paths, several column
    tiles (d = 300), int32 and int64 ids, out-of-range ids, both modes; each
    call launches once, and a second launch is bit-identical."""
    tol = TOL if table_dtype == torch.float32 else BF16_TOL
    tbl, idx, w = _inputs(1000, d, 77, 9, seed=d)
    idx[0, :3] = [-1, 1000, 5000]
    t = torch.from_numpy(tbl).to(card, table_dtype)
    wt = torch.from_numpy(w).to(card)
    for id_dtype in (torch.int32, torch.int64):
        i = torch.from_numpy(idx).to(card, id_dtype)
        for mode in ("sum", "mean"):
            for weights in (wt, None):
                before = cuda_build.launches["embedding_bag"]
                out = embedding_bag(t, i, weights, mode=mode)
                assert cuda_build.launches["embedding_bag"] == before + 1
                assert out.dtype == table_dtype
                torch.testing.assert_close(
                    out.float(),
                    embedding_bag_ref(t, i, weights, mode=mode).float(), **tol)
                assert torch.equal(out, embedding_bag(t, i, weights,
                                                      mode=mode))
