"""EmbeddingBag on cloze bags, and the CUDA kernel's designs.

On the CPU the port's plain version (``repro_torch.kernels.embedding_bag``)
is held against the reference's XLA path and its Pallas kernel in
interpret mode on BERT4Rec-style cloze bags (``make_cloze_batch``: Zipf
starts, ±50 random walks, the same numpy stream in both packages), vocab
cut to 5,000, 64 bags of 200, at the reference's kernel tolerance
``rtol = atol = 2e-5`` (fp32 sums in another order).

The tests marked ``cuda`` launch the hand-written kernel and hold each of
its designs (``kernel.ROUTES``: ``split`` for few bags, ``groups`` for
many, ``scalar`` for rows that are no whole number of 16-byte chunks) against the plain version on edge shapes; every call
launches once, and a second launch is bit-identical.  They skip without a
card.
"""
import numpy as np
import pytest
import torch

from repro_torch.data.recsys import make_cloze_batch
from repro_torch.kernels import cuda_build
from repro_torch.kernels.embedding_bag import embedding_bag, embedding_bag_ref
from repro_torch.kernels.embedding_bag import kernel as ek

TOL = dict(rtol=2e-5, atol=2e-5)
#: bf16 results: both sides sum in fp32 and round once, so they differ by
#: at most one bf16 ulp (2⁻⁷ relative) where a rounding boundary falls
#: between their fp32 sums (as tests/test_torch_embedding_bag.py)
BF16_TOL = dict(rtol=2.0 ** -7, atol=1e-5)


def _cloze(vocab, B, L, seed):
    rng = np.random.default_rng(seed)
    labels = make_cloze_batch(rng, B, L, vocab, vocab + 1,
                              device="cpu")["labels"].numpy()
    tbl = rng.standard_normal((vocab, 64)).astype(np.float32)
    w = rng.random((B, L)).astype(np.float32)
    return tbl, labels, w


@pytest.mark.parametrize("mode", ["sum", "mean"])
@pytest.mark.parametrize("weighted", [True, False])
def test_cloze_bags_match_the_reference(mode, weighted):
    import jax.numpy as jnp
    from repro.kernels.embedding_bag.ops import embedding_bag as r_bag

    tbl, ids, w = _cloze(5000, 64, 200, seed=1)
    assert 0 <= ids.min() and ids.max() < 5000
    w = w if weighted else None
    out = embedding_bag(torch.from_numpy(tbl), torch.from_numpy(ids),
                        None if w is None else torch.from_numpy(w), mode=mode)
    assert out.dtype == torch.float32 and out.shape == (64, 64)
    args = (jnp.asarray(tbl), jnp.asarray(ids),
            None if w is None else jnp.asarray(w))
    np.testing.assert_allclose(
        out.numpy(), np.asarray(r_bag(*args, mode=mode, backend="xla")),
        **TOL)
    np.testing.assert_allclose(
        out.numpy(),
        np.asarray(r_bag(*args, mode=mode, backend="pallas",
                         rows_per_block=1024, bag_tile=32)), **TOL)


def test_routes_name_the_source_codes():
    """The route names follow the C source's route codes (0 groups, 1
    split, 2 scalar); the plain version counts no route."""
    assert ek.ROUTES == ("groups", "split", "scalar")
    assert "embedding_bag_route" in ek._SIGNATURES
    before = dict(ek.routes)
    embedding_bag(torch.zeros(4, 2), torch.zeros(1, 1, dtype=torch.int32))
    assert dict(ek.routes) == before  # the plain version counts nothing


# --------------------------------------------------------------------- #
# the hand-written CUDA kernel (on the card only)
# --------------------------------------------------------------------- #
@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def _run(table, ids, weights, mode):
    """One call, checked to launch once and to repeat bit for bit; returns
    the output and the route it took."""
    launches = cuda_build.launches["embedding_bag"]
    before = dict(ek.routes)
    out = embedding_bag(table, ids, weights, mode=mode)
    assert cuda_build.launches["embedding_bag"] == launches + 1
    took = [r for r in ek.ROUTES if ek.routes[r] != before.get(r, 0)]
    assert len(took) == 1
    assert torch.equal(out, embedding_bag(table, ids, weights, mode=mode))
    return out, took[0]


def _check(card, V, d, B, L, dtype=torch.float32, id_dtype=torch.int32,
           seed=0, zero_bag=None):
    rng = np.random.default_rng(seed)
    guarded = torch.full((V + 2, d), float("nan"), device=card, dtype=dtype)
    guarded[1:V + 1] = torch.from_numpy(
        rng.standard_normal((V, d), dtype=np.float32)).to(card, dtype)
    table = guarded[1:V + 1]  # rows -1 and V are NaN: reading one shows
    ids = rng.integers(0, V, (B, L))
    if B and L:
        ids[0, 0] = -1
        ids[-1, -1] = V
    w = rng.random((B, L), dtype=np.float32)
    if zero_bag is not None:
        w[zero_bag] = 0.0
    it = torch.from_numpy(ids).to(card, id_dtype)
    wt = torch.from_numpy(w).to(card)
    tol = TOL if dtype == torch.float32 else BF16_TOL
    routes = set()
    for mode in ("sum", "mean"):
        for weights in (wt, None):
            out, route = _run(table, it, weights, mode)
            routes.add(route)
            assert out.dtype == dtype and out.shape == (B, d)
            assert bool(out.isfinite().all())
            torch.testing.assert_close(
                out.float(),
                embedding_bag_ref(table, it, weights, mode=mode).float(),
                **tol)
            if zero_bag is not None and weights is not None:
                assert not bool(out[zero_bag].any())
    assert len(routes) == 1
    return routes.pop()


#: (B, L) edge shapes on the split route: one bag, serve_p99's 512, a B of
#: no whole tile, L 1, L 0, an L no split count divides
SPLIT_SHAPES = [(1, 200), (512, 200), (77, 13), (300, 1), (40, 0),
                (129, 37)]


@pytest.mark.cuda
@pytest.mark.parametrize("B,L", SPLIT_SHAPES)
@pytest.mark.parametrize("d", [16, 24, 64, 128])
@pytest.mark.parametrize("dtype,id_dtype", [(torch.float32, torch.int32),
                                            (torch.bfloat16, torch.int64)])
def test_cuda_split_route_matches_plain(card, B, L, d, dtype, id_dtype):
    assert _check(card, 1000, d, B, L, dtype=dtype, id_dtype=id_dtype,
                  seed=B + L + d, zero_bag=0 if B > 1 else None) == "split"


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("id_dtype", [torch.int32, torch.int64])
def test_cuda_groups_route_matches_plain(card, dtype, id_dtype):
    """Many bags: 20,001 fill no whole CTA, 101 ids no whole batch of
    id loads."""
    assert _check(card, 3000, 64, 20001, 101, dtype=dtype,
                  id_dtype=id_dtype, seed=5, zero_bag=7) == "groups"


@pytest.mark.cuda
@pytest.mark.parametrize("d", [16, 24, 128, 300])
def test_cuda_groups_route_widths(card, d):
    """Rows of one chunk a lane (16, 24: a group wider than the row; 128)
    and of several loads a lane (300)."""
    assert _check(card, 1000, d, 20000, 9, seed=d, zero_bag=3) == "groups"


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 512, 9000])
def test_cuda_scalar_route_matches_plain(card, B):
    assert _check(card, 1000, 33, B, 21, seed=B, zero_bag=0) == "scalar"


@pytest.mark.cuda
@pytest.mark.parametrize("B,L", [(512, 200), (20001, 101)])
def test_cuda_all_ids_out_of_range_give_zero(card, B, L):
    ids = np.where(np.arange(B * L).reshape(B, L) % 2, -3, 1000)
    for id_dtype in (torch.int32, torch.int64):
        rng = np.random.default_rng(1)
        table = torch.from_numpy(
            rng.standard_normal((1000, 64), dtype=np.float32)).to(card)
        it = torch.from_numpy(ids).to(card, id_dtype)
        out, _ = _run(table, it, None, "sum")
        assert not bool(out.any())


@pytest.mark.cuda
def test_cuda_main_shapes_take_the_documented_routes(card):
    """BERT4Rec's table width: serve_p99 (512 bags) on the split route,
    train_batch (65,536 × 200) on the groups route; both against the plain
    version on cloze bags."""
    rng = np.random.default_rng(1)
    V = 1_000_002
    table = torch.randn((V, 64), device=card,
                        generator=torch.Generator(card).manual_seed(1))
    want = {512: "split", 65536: "groups"}
    for B, route in want.items():
        ids = make_cloze_batch(rng, B, 200, V - 2, V - 1,
                               device=card)["labels"]
        w = torch.from_numpy(rng.random((B, 200), dtype=np.float32)).to(card)
        out, took = _run(table, ids, w, "sum")
        assert took == route
        torch.testing.assert_close(out, embedding_bag_ref(table, ids, w),
                                   **TOL)
