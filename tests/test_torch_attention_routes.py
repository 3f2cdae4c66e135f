"""Routes and plans of the port's attention kernels
(``repro_torch.kernels.flash_attention``): which source serves a
``(dtype, head dim)``, which strided operands the tensor-core kernel takes
as they are, how the decode kernel's splits follow the live cache length,
and decode with a bf16 query through the public call.

The CPU tests need no card: the route, the stride check and the split plan
are plain Python, and on the CPU ``flash_decode`` runs its plain version
(held against the reference's oracle and its Pallas kernel in interpret
mode, bf16 at the reference's bf16 tolerance ``2e-2``).  The tests marked
``cuda`` launch the kernels on the card and skip without one: the
tensor-core route over masks, groups and ragged shapes at the
``chip_smoke.py`` bf16 tolerance (rtol 2⁻⁷, atol 2⁻⁶ of the mean |entry|),
a fully masked row, refused operands; the one-launch decode kernel's
launch count, repeats, empty splits and live lengths.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import cuda_build
from repro_torch.kernels.flash_attention import (attention, attention_ref,
                                                 flash_decode,
                                                 flash_decode_ref)
from repro_torch.kernels.flash_attention.decode_kernel import (
    NEG_INF, TILE, flash_decode_partials_cuda, live_splits, split_length)
from repro_torch.kernels.flash_attention.kernel import (
    HEAD_DIMS, WGMMA_HEAD_DIMS, attention_route, flash_attention_cuda,
    strided_ok)

BF16_REF_TOL = dict(rtol=2e-2, atol=2e-2)
#: the kernels' bf16 tolerance on the card (chip_smoke.py's BF16_RTOL,
#: BF16_ATOL_OF_MEAN): one bf16 ulp relative, two of the mean |entry|
BF16_RTOL, BF16_ATOL_OF_MEAN = 2.0 ** -7, 2.0 ** -6
SMS = 132  # an H100's SMs, what split_length assumes off the card


def _np(*shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


# --------------------------------------------------------------------- #
# routes (CPU)
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("D", HEAD_DIMS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_route(dtype, D):
    want = "wgmma" if dtype == torch.bfloat16 and D in WGMMA_HEAD_DIMS \
        else "fma"
    assert attention_route(dtype, D) == want


@pytest.mark.parametrize("dtype,D,err", [
    (torch.float16, 64, TypeError), (torch.float64, 64, TypeError),
    (torch.bfloat16, 48, ValueError), (torch.float32, 512, ValueError),
    (torch.bfloat16, 4, ValueError),
])
def test_attention_route_refuses(dtype, D, err):
    with pytest.raises(err):
        attention_route(dtype, D)


def test_strided_ok():
    """The tensor-core kernel takes (B, H, S, D) views of a (B, S, H, D)
    buffer as they are; the last dim must be contiguous and the other
    strides multiples of 8 elements."""
    bshd = torch.zeros(2, 5, 4, 64, dtype=torch.bfloat16)
    assert strided_ok(bshd.transpose(1, 2))
    assert strided_ok(bshd.permute(0, 2, 1, 3).contiguous())
    assert not strided_ok(bshd.transpose(2, 3))  # last dim strided
    odd = torch.zeros(2, 5, 4, 12, dtype=torch.bfloat16)  # rows of 24 B
    assert not strided_ok(odd.transpose(1, 2))
    assert strided_ok(torch.zeros(1, 1, 1, 64, dtype=torch.bfloat16))


def test_cpu_attention_takes_strided_views():
    """The public call on (B, S, H, D) projections seen as (B, H, S, D):
    the plain version on the CPU, equal to the contiguous call."""
    q = torch.from_numpy(_np(2, 40, 4, 16, seed=1)).transpose(1, 2)
    k = torch.from_numpy(_np(2, 40, 2, 16, seed=2)).transpose(1, 2)
    v = torch.from_numpy(_np(2, 40, 2, 16, seed=3)).transpose(1, 2)
    out = attention(q, k, v, causal=True)
    torch.testing.assert_close(
        out, attention(q.contiguous(), k.contiguous(), v.contiguous(),
                       causal=True), rtol=0, atol=0)


# --------------------------------------------------------------------- #
# decode splits from the live length (CPU)
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("B,Hkv,S,kv_len", [
    (8, 4, 576, 576), (8, 4, 576, 100), (8, 4, 576, 1), (8, 4, 32768, 32768),
    (8, 4, 32768, 5000), (1, 1, 100, 37), (2, 8, 4096, 4096),
    (8, 4, 32768, 64), (8, 4, 32768, 65),
])
def test_split_length_follows_kv_len(B, Hkv, S, kv_len):
    cpu = torch.device("cpu")
    split = split_length(B, Hkv, S, None, cpu, kv_len=kv_len)
    assert split % TILE == 0  # whole tiles
    n = live_splits(kv_len, split)
    assert (n - 1) * split < kv_len <= n * split  # every live slot, no more
    # about 4 CTAs per SM, as far as whole tiles of the live prefix allow:
    # at most the plan, at least 3/4 of it (rounding a split up to whole
    # tiles can drop the last one)
    plan = min(-(-4 * SMS // (B * Hkv)), -(-kv_len // TILE))
    assert 4 * n >= 3 * plan and n <= plan


def test_split_length_kv_len_defaults_to_horizon():
    cpu = torch.device("cpu")
    for shape in ((8, 4, 576), (8, 4, 32768), (1, 1, 100)):
        assert split_length(*shape, None, cpu) == \
            split_length(*shape, None, cpu, kv_len=shape[2])
    # kv_splits given keeps its meaning: ceil(S / kv_splits), whatever kv_len
    assert split_length(2, 2, 256, 8, cpu, kv_len=10) == 32
    assert live_splits(10, 32) == 1


# --------------------------------------------------------------------- #
# decode with a bf16 query through the public call (CPU)
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("B,Hq,Hkv,S,D,kv_len,cap", [
    (2, 8, 2, 256, 64, 256, 0.0), (1, 4, 4, 512, 64, 300, 0.0),
    (2, 4, 1, 128, 128, 100, 30.0),
])
def test_flash_decode_bf16_query(B, Hq, Hkv, S, D, kv_len, cap):
    import jax.numpy as jnp
    from repro.kernels.flash_attention.decode_kernel import (
        flash_decode_pallas, flash_decode_ref as r_ref)

    seed = B + Hq + S + D
    q, k, v = _np(B, Hq, 1, D, seed=seed), _np(B, Hkv, S, D, seed=seed + 1), \
        _np(B, Hkv, S, D, seed=seed + 2)
    tq, tk, tv = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v))
    out = flash_decode(tq, tk, tv, kv_len=kv_len, softcap=cap)
    assert out.dtype == torch.bfloat16 and out.shape == (B, Hq, 1, D)
    torch.testing.assert_close(
        out, flash_decode_ref(tq, tk, tv, kv_len=kv_len, softcap=cap),
        rtol=0, atol=0)
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    want = torch.from_numpy(np.asarray(r_ref(jq, jk, jv, kv_len=kv_len,
                                             softcap=cap), np.float32))
    pallas = torch.from_numpy(np.asarray(flash_decode_pallas(
        jq, jk, jv, kv_splits=4, kv_len=kv_len, softcap=cap, interpret=True),
        np.float32))
    torch.testing.assert_close(out.float(), want, **BF16_REF_TOL)
    torch.testing.assert_close(out.float(), pallas, **BF16_REF_TOL)


# --------------------------------------------------------------------- #
# the kernels on the card
# --------------------------------------------------------------------- #
@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def _bf16_close(out, ref):
    ref = ref.float()
    atol = BF16_ATOL_OF_MEAN * float(ref.abs().mean())
    torch.testing.assert_close(out.float(), ref, rtol=BF16_RTOL, atol=atol)


def _rand(card, *shape, seed):
    return torch.from_numpy(_np(*shape, seed=seed)).to(card, torch.bfloat16)


_TC_SHAPES = [  # (B, Hq, Hkv, Sq, Skv, D): groups 1, 4, 8; ragged; Sq ≠ Skv
    (1, 4, 4, 128, 128, 64), (2, 8, 2, 200, 200, 64), (2, 32, 4, 77, 77, 64),
    (1, 8, 1, 130, 130, 128), (2, 4, 4, 64, 96, 128), (1, 4, 1, 200, 200, 128),
]
_TC_MODES = [(True, 0, 0.0), (True, 64, 0.0), (False, 0, 0.0),
             (True, 0, 30.0), (False, 64, 0.0)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape,mode", [
    (shape, mode) for shape in _TC_SHAPES for mode in _TC_MODES
    # causal masks count positions from 0 in both, so they want Sq = Skv
    if not (mode[0] and shape[3] != shape[4])])
def test_cuda_wgmma_route_matches_plain(card, shape, mode):
    B, Hq, Hkv, Sq, Skv, D = shape
    causal, window, cap = mode
    q = _rand(card, B, Hq, Sq, D, seed=30)
    k, v = _rand(card, B, Hkv, Skv, D, seed=31), \
        _rand(card, B, Hkv, Skv, D, seed=32)
    kw = dict(causal=causal, window=window, softcap=cap)
    before = dict(cuda_build.launches)
    out = attention(q, k, v, **kw)
    assert cuda_build.launches["flash_attention_wgmma"] == \
        before.get("flash_attention_wgmma", 0) + 1
    _bf16_close(out, attention_ref(q, k, v, **kw))


@pytest.mark.cuda
def test_cuda_wgmma_strided_projections(card):
    """(B, S, H, D) projections seen as (B, H, S, D) go in as they are and
    the output comes back in that layout."""
    qb, kb, vb = _rand(card, 2, 150, 8, 64, seed=33), \
        _rand(card, 2, 150, 2, 64, seed=34), _rand(card, 2, 150, 2, 64, seed=35)
    q, k, v = (t.transpose(1, 2) for t in (qb, kb, vb))
    out = attention(q, k, v, causal=True)
    assert out.transpose(1, 2).is_contiguous()
    _bf16_close(out, attention_ref(q, k, v, causal=True))


@pytest.mark.cuda
def test_cuda_wgmma_fully_masked_row_is_zero(card):
    """Bidirectional with a window and Sq > Skv: rows past Skv + window - 1
    see no key and come out 0 (the plain version gives NaN there)."""
    q = _rand(card, 1, 4, 200, 64, seed=36)
    k, v = _rand(card, 1, 2, 64, 64, seed=37), _rand(card, 1, 2, 64, 64, seed=38)
    out = flash_attention_cuda(q, k, v, causal=False, window=32)
    ref = attention_ref(q, k, v, causal=False, window=32)
    dead = torch.arange(200, device=card) >= 64 + 32 - 1
    assert bool((out[:, :, dead] == 0).all())
    _bf16_close(out[:, :, ~dead], ref[:, :, ~dead])


@pytest.mark.cuda
def test_cuda_wgmma_refuses_bad_operands(card):
    q = _rand(card, 1, 2, 64, 64, seed=39)
    with pytest.raises(ValueError, match="last dim"):
        flash_attention_cuda(q.transpose(2, 3), q, q)
    flat = _rand(card, 1 * 2 * 64 * 64 + 1, seed=40)
    misaligned = flat[1:].view(1, 2, 64, 64)
    with pytest.raises(ValueError, match="16-byte"):
        flash_attention_cuda(misaligned, q, q)
    with pytest.raises(TypeError):
        flash_attention_cuda(q, q.float(), q)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_flash_decode_one_launch_repeats(card, dtype):
    gen = torch.Generator(device=card).manual_seed(41)
    q = torch.randn(8, 32, 1, 64, generator=gen, device=card).to(dtype)
    k, v = (torch.randn(8, 4, 576, 64, generator=gen, device=card).to(dtype)
            for _ in range(2))
    split = split_length(8, 4, 576, None, card)
    for kv_len in (1, split, split + 1, 576):
        before = cuda_build.launches["flash_decode"]
        outs = [flash_decode(q, k, v, kv_len=kv_len) for _ in range(3)]
        assert cuda_build.launches["flash_decode"] == before + 3
        assert all(torch.equal(outs[0], o) for o in outs[1:])
        ref = flash_decode_ref(q, k, v, kv_len=kv_len)
        if dtype == torch.float32:
            torch.testing.assert_close(outs[0], ref, rtol=2e-5, atol=2e-5)
        else:
            _bf16_close(outs[0], ref)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_flash_decode_empty_splits(card, dtype):
    gen = torch.Generator(device=card).manual_seed(42)
    q = torch.randn(1, 8, 1, 64, generator=gen, device=card).to(dtype)
    k, v = (torch.randn(1, 2, 1024, 64, generator=gen, device=card).to(dtype)
            for _ in range(2))
    m, l, o = flash_decode_partials_cuda(q, k, v, scale=0.125, kv_len=100,
                                         split=64, softcap=0.0)
    assert m.shape == (1, 2, 16, 4) and o.shape == (1, 2, 16, 4, 64)
    assert bool((m[:, :, 2:] == NEG_INF).all())
    assert bool((l[:, :, 2:] == 0).all()) and bool((o[:, :, 2:] == 0).all())
    assert bool((l[:, :, :2] > 0).all())
