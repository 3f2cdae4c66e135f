"""Port parity of flash attention and split-KV decode attention
(``repro_torch.kernels.flash_attention``; mirrors the flash-attention and
flash-decoding cases of tests/test_kernels.py).

On the CPU the port's ``attention`` and ``flash_decode`` run their plain
PyTorch versions.  They are held against the reference as its own tests
run it: the dense oracles (``attention_ref``, ``flash_decode_ref``) and the
Pallas kernels in interpret mode, on the same numpy inputs, in fp32 at
``rtol = atol = 2e-5`` (the reference's own kernel tolerance: the only
difference is the order of fp32 sums).  bf16 cases use ``2e-2``, as the
reference's bf16 test does.

The tests marked ``cuda`` launch the hand-written kernels and hold them
against the plain versions on the card; they skip without one.  JAX is
imported inside the tests that use it, so ``pytest -m cuda
tests/test_torch_flash_attention.py`` runs on a machine that has none.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import cuda_build
from repro_torch.kernels.flash_attention import (attention, attention_ref,
                                                 flash_decode,
                                                 flash_decode_ref)
from repro_torch.kernels.flash_attention.decode_kernel import (
    flash_decode_partials_cuda, split_length)
from repro_torch.kernels.flash_attention.kernel import flash_attention_cuda

TOL = dict(rtol=2e-5, atol=2e-5)
BF16_TOL = dict(rtol=2e-2, atol=2e-2)


def _np(*shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _close(out: torch.Tensor, ref, **tol):
    ref = torch.from_numpy(np.array(ref, dtype=np.float32))
    torch.testing.assert_close(out.float().cpu(), ref, **(tol or TOL))


# --------------------------------------------------------------------- #
# attention: plain version (CPU) against the reference
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("B,Hq,Hkv,S,D", [
    (1, 4, 4, 128, 64), (2, 8, 2, 256, 64), (1, 4, 1, 256, 128),
])
@pytest.mark.parametrize("causal,window,softcap", [
    (True, 0, 0.0), (True, 64, 0.0), (False, 0, 0.0), (True, 0, 30.0),
    (True, 64, 50.0),
])
def test_attention_matches_reference(B, Hq, Hkv, S, D, causal, window,
                                     softcap):
    import jax.numpy as jnp
    from repro.kernels.flash_attention.kernel import flash_attention_pallas
    from repro.kernels.flash_attention.ref import attention_ref as r_ref

    seed = B * 1000 + Hq * 100 + S + D
    q, k, v = _np(B, Hq, S, D, seed=seed), _np(B, Hkv, S, D, seed=seed + 1), \
        _np(B, Hkv, S, D, seed=seed + 2)
    kw = dict(causal=causal, window=window, softcap=softcap)
    out = attention(torch.from_numpy(q), torch.from_numpy(k),
                    torch.from_numpy(v), **kw)
    assert out.dtype == torch.float32 and out.shape == (B, Hq, S, D)
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    _close(out, r_ref(jq, jk, jv, **kw))
    _close(out, flash_attention_pallas(jq, jk, jv, q_tile=64, kv_tile=64,
                                       interpret=True, **kw))


def test_attention_bf16_matches_reference():
    import jax.numpy as jnp
    from repro.kernels.flash_attention.ref import attention_ref as r_ref

    q, k, v = (_np(1, 2, 128, 64, seed=s) for s in (5, 6, 7))
    tq, tk, tv = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v))
    out = attention(tq, tk, tv, causal=True)
    assert out.dtype == torch.bfloat16
    ref = r_ref(*(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)),
                causal=True)
    _close(out, np.asarray(ref, np.float32), **BF16_TOL)


@pytest.mark.parametrize("Sq,Skv,causal,window", [
    (100, 100, True, 0), (77, 77, True, 30), (64, 96, False, 0),
    (50, 130, False, 40),
])
def test_attention_ragged_and_cross_lengths(Sq, Skv, causal, window):
    """Lengths that do not divide into tiles, and Sq ≠ Skv (bidirectional):
    the Pallas wrapper asserts divisibility, so these hold the port against
    the reference's oracle only."""
    import jax.numpy as jnp
    from repro.kernels.flash_attention.ref import attention_ref as r_ref

    q, k, v = _np(2, 4, Sq, 32, seed=8), _np(2, 2, Skv, 32, seed=9), \
        _np(2, 2, Skv, 32, seed=10)
    kw = dict(causal=causal, window=window, softcap=0.0)
    out = attention(*map(torch.from_numpy, (q, k, v)), **kw)
    _close(out, r_ref(*map(jnp.asarray, (q, k, v)), **kw))


def test_attention_backends():
    q = torch.from_numpy(_np(1, 2, 16, 8, seed=11))
    ref = attention_ref(q, q, q)
    torch.testing.assert_close(attention(q, q, q, backend="torch"), ref)
    with pytest.raises(ValueError, match="'cuda'"):
        attention(q, q, q, backend="pallas")
    with pytest.raises(ValueError, match="card"):
        attention(q, q, q, backend="cuda")
    with pytest.raises(ValueError, match="unknown"):
        attention(q, q, q, backend="xla")
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention_cuda(q, q, q)


# --------------------------------------------------------------------- #
# decode: plain version (CPU) against the reference
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("B,Hq,Hkv,S,d,splits,kvlen,cap", [
    (2, 8, 2, 256, 64, 8, 256, 0.0),
    (1, 4, 4, 512, 64, 4, 300, 0.0),   # partial (ring) cache
    (2, 4, 1, 128, 128, 8, 128, 30.0),  # MQA + softcap
    (1, 2, 2, 128, 64, 1, 77, 0.0),    # single split degenerates cleanly
])
def test_flash_decode_matches_reference(B, Hq, Hkv, S, d, splits, kvlen,
                                        cap):
    import jax.numpy as jnp
    from repro.kernels.flash_attention.decode_kernel import (
        flash_decode_pallas, flash_decode_ref as r_ref)

    seed = B + Hq + S + d
    q, k, v = _np(B, Hq, 1, d, seed=seed), _np(B, Hkv, S, d, seed=seed + 1), \
        _np(B, Hkv, S, d, seed=seed + 2)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    ref = r_ref(jq, jk, jv, kv_len=kvlen, softcap=cap)
    pallas = flash_decode_pallas(jq, jk, jv, kv_splits=splits, kv_len=kvlen,
                                 softcap=cap, interpret=True)
    out = flash_decode(tq, tk, tv, kv_splits=splits, kv_len=kvlen,
                       softcap=cap)
    assert out.dtype == torch.float32 and out.shape == (B, Hq, 1, d)
    _close(out, ref)
    _close(out, pallas)


def test_split_length_fills_the_card():
    """Auto splits: B·Hkv·splits ≈ 4 CTAs per SM of an H100, whole tiles,
    of the live cache prefix."""
    cpu = torch.device("cpu")
    assert split_length(8, 4, 576, None, cpu) == 64  # 9 splits
    assert split_length(8, 4, 32768, None, cpu) == 1984  # 17 splits
    assert split_length(1, 1, 100, None, cpu) == 64
    assert split_length(2, 2, 256, 8, cpu) == 32
    assert split_length(1, 2, 77, 2, cpu) == 39
    with pytest.raises(ValueError):
        split_length(1, 1, 64, 0, cpu)
    # the live prefix kv_len, not the horizon S, is what gets split
    assert split_length(8, 4, 32768, None, cpu, kv_len=32768) == 1984
    assert split_length(8, 4, 32768, None, cpu, kv_len=5000) == 320  # 16
    assert split_length(8, 4, 576, None, cpu, kv_len=100) == 64  # 2 splits
    assert split_length(2, 2, 256, 8, cpu, kv_len=100) == 32  # as given


def test_flash_decode_refusals():
    q = torch.from_numpy(_np(1, 4, 1, 16, seed=18))
    k = torch.from_numpy(_np(1, 2, 32, 16, seed=19))
    with pytest.raises(ValueError, match="'cuda'"):
        flash_decode(q, k, k, backend="pallas")
    with pytest.raises(ValueError, match="card"):
        flash_decode(q, k, k, backend="cuda")
    for bad in (0, 33):
        with pytest.raises(ValueError, match="kv_len"):
            flash_decode(q, k, k, kv_len=bad)
    with pytest.raises(ValueError, match="q must be"):
        flash_decode(q[:, :, :0], k, k)
    with pytest.raises(ValueError, match="CUDA"):
        flash_decode_partials_cuda(q, k, k, scale=1.0, kv_len=4, split=8,
                                   softcap=0.0)


# --------------------------------------------------------------------- #
# the hand-written CUDA kernels (on the card only)
# --------------------------------------------------------------------- #
@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_attention_matches_plain(card, dtype):
    tol = TOL if dtype == torch.float32 else BF16_TOL
    for (B, Hq, Hkv, Sq, Skv, D), causal, window, cap in (
            ((2, 8, 2, 200, 200, 64), True, 0, 0.0),
            ((1, 8, 1, 130, 130, 128), True, 64, 50.0),
            ((2, 4, 4, 64, 96, 32), False, 0, 30.0)):
        q = torch.from_numpy(_np(B, Hq, Sq, D, seed=20)).to(card, dtype)
        k = torch.from_numpy(_np(B, Hkv, Skv, D, seed=21)).to(card, dtype)
        v = torch.from_numpy(_np(B, Hkv, Skv, D, seed=22)).to(card, dtype)
        kw = dict(causal=causal, window=window, softcap=cap)
        before = cuda_build.launches["flash_attention"]
        out = attention(q, k, v, **kw)
        assert cuda_build.launches["flash_attention"] == before + 1
        torch.testing.assert_close(out.float(),
                                   attention_ref(q, k, v, **kw).float(),
                                   **tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_flash_decode_matches_plain(card, dtype):
    tol = TOL if dtype == torch.float32 else BF16_TOL
    q = torch.from_numpy(_np(8, 32, 1, 64, seed=23)).to(card, dtype)
    k = torch.from_numpy(_np(8, 4, 576, 64, seed=24)).to(card, dtype)
    v = torch.from_numpy(_np(8, 4, 576, 64, seed=25)).to(card, dtype)
    for kv_len in (1, 64, 100, 576):
        for kv_splits in (None, 1, 7):
            before = cuda_build.launches["flash_decode"]
            out = flash_decode(q, k, v, kv_len=kv_len, kv_splits=kv_splits)
            assert cuda_build.launches["flash_decode"] == before + 1
            torch.testing.assert_close(
                out.float(), flash_decode_ref(q, k, v, kv_len=kv_len).float(),
                **tol)
