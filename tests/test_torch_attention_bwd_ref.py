"""The attention backward's plain versions
(``repro_torch.kernels.flash_attention.ref``) and its route, on the CPU.

``attention_lse_ref`` (the output and each row's logsumexp, which the
tensor-core forward stores) and ``attention_bwd_ref`` (dq, dk, dv from the
explicit formulas both backward kernels compute, given the forward's output
and logsumexp) are held against the reference on the same numpy inputs
from a seed, in fp32 at ``rtol = atol = 1e-5`` (the same function; only the
order of fp32 sums differs): the gradients against ``jax.vjp`` of
``repro.kernels.flash_attention.ref.attention_ref``, the logsumexp against
``jax.nn.logsumexp`` of its masked scores.  The cases are those of
``tests/test_torch_attention_grad.py`` plus one at head dim 64 and one at
128, the tensor-core backward's.  A row whose keys are all masked gets
lse +1e30, output 0 and no gradient.  ``attention_bwd_route`` sends bf16
at D 64 and 128 to the tensor cores and everything else to the FMA kernel.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.flash_attention.kernel import (
    HEAD_DIMS, WGMMA_BWD_HEAD_DIMS, attention_bwd_route)
from repro_torch.kernels.flash_attention.ref import (NO_ROW_LSE,
                                                     attention_bwd_ref,
                                                     attention_lse_ref,
                                                     attention_ref)

TOL = dict(rtol=1e-5, atol=1e-5)

CASES = [  # (B, Hq, Hkv, Sq, Skv, D), causal, window, softcap
    ((1, 4, 4, 40, 40, 16), True, 0, 0.0),
    ((2, 8, 2, 33, 33, 8), True, 12, 0.0),  # GQA 4, window, ragged
    ((1, 6, 2, 24, 40, 16), False, 0, 5.0),  # bidirectional, Sq ≠ Skv
    ((1, 4, 1, 48, 48, 32), True, 16, 3.0),  # MQA, window and softcap
    ((1, 4, 2, 70, 70, 64), True, 0, 0.0),  # the tensor-core head dims
    ((1, 2, 1, 37, 37, 128), True, 20, 30.0),
]


def _np(*shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _inputs(shape, seed):
    B, Hq, Hkv, Sq, Skv, D = shape
    return (_np(B, Hq, Sq, D, seed=seed), _np(B, Hkv, Skv, D, seed=seed + 1),
            _np(B, Hkv, Skv, D, seed=seed + 2), _np(B, Hq, Sq, D,
                                                    seed=seed + 3))


def _jax_lse(q, k, *, causal, window, softcap):
    """The reference's masked scores (as its attention_ref forms them)
    through jax.nn.logsumexp."""
    import jax
    import jax.numpy as jnp

    B, Hq, Sq, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    kk = jnp.repeat(jnp.asarray(k), Hq // Hkv, axis=1)
    s = jnp.einsum("bhqd,bhkd->bhqk", jnp.asarray(q), kk) * D ** -0.5
    if softcap > 0.0:
        s = softcap * jnp.tanh(s / softcap)
    qp, kp = jnp.arange(Sq)[:, None], jnp.arange(Skv)[None, :]
    mask = jnp.ones((Sq, Skv), bool)
    if causal:
        mask &= qp >= kp
    if window > 0:
        mask &= (qp - kp) < window
    return np.array(jax.nn.logsumexp(jnp.where(mask, s, -jnp.inf), axis=-1))


@pytest.mark.parametrize("shape,causal,window,softcap", CASES)
def test_lse_matches_jax_logsumexp(shape, causal, window, softcap):
    q, k, v, _ = _inputs(shape, seed=sum(shape))
    kw = dict(causal=causal, window=window, softcap=softcap)
    out, lse = attention_lse_ref(*map(torch.from_numpy, (q, k, v)), **kw)
    assert lse.dtype == torch.float32 and lse.shape == shape[:2] + shape[3:4]
    torch.testing.assert_close(lse, torch.from_numpy(_jax_lse(q, k, **kw)),
                               **TOL)
    torch.testing.assert_close(
        out, attention_ref(*map(torch.from_numpy, (q, k, v)), **kw), **TOL)


@pytest.mark.parametrize("shape,causal,window,softcap", CASES)
def test_bwd_ref_matches_jax_vjp(shape, causal, window, softcap):
    import jax
    import jax.numpy as jnp
    from repro.kernels.flash_attention.ref import attention_ref as r_ref

    q, k, v, g = _inputs(shape, seed=sum(shape))
    kw = dict(causal=causal, window=window, softcap=softcap)
    tq, tk, tv, tg = map(torch.from_numpy, (q, k, v, g))
    out, lse = attention_lse_ref(tq, tk, tv, **kw)
    grads = attention_bwd_ref(tq, tk, tv, out, tg, lse, **kw)
    _, vjp = jax.vjp(lambda a, b, c: r_ref(a, b, c, **kw),
                     *map(jnp.asarray, (q, k, v)))
    for name, got, want in zip(("dq", "dk", "dv"), grads, vjp(jnp.asarray(g))):
        assert got.dtype == torch.float32, name
        torch.testing.assert_close(got, torch.from_numpy(np.array(want)),
                                   **TOL, msg=name)


def test_fully_masked_rows():
    """Bidirectional with a window and Sq > Skv + window: rows past the
    keys see none.  Their lse is +1e30 and their output 0; they add
    nothing to dk and dv, which equal the gradients of the rows that do
    see keys alone."""
    shape = (1, 2, 1, 40, 8, 16)
    q, k, v, g = map(torch.from_numpy, _inputs(shape, seed=5))
    kw = dict(causal=False, window=4)
    out, lse = attention_lse_ref(q, k, v, **kw)
    empty = torch.arange(40) >= 8 + 4 - 1  # row i sees keys > i - 4
    assert bool((lse[..., empty] == NO_ROW_LSE).all())
    assert bool(torch.isfinite(lse[..., ~empty]).all())
    assert bool((out[:, :, empty] == 0).all())
    dq, dk, dv = attention_bwd_ref(q, k, v, out, g, lse, **kw)
    assert all(bool(torch.isfinite(t).all()) for t in (dq, dk, dv))
    assert bool((dq[:, :, empty] == 0).all())
    seen = torch.nonzero(~empty).flatten()
    _, dk_s, dv_s = attention_bwd_ref(q[:, :, seen], k, v, out[:, :, seen],
                                      g[:, :, seen], lse[:, :, seen], **kw)
    torch.testing.assert_close(dk, dk_s, **TOL)
    torch.testing.assert_close(dv, dv_s, **TOL)


@pytest.mark.parametrize("D", HEAD_DIMS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_bwd_route(dtype, D):
    want = "wgmma" if dtype == torch.bfloat16 and D in WGMMA_BWD_HEAD_DIMS \
        else "fma"
    assert attention_bwd_route(dtype, D) == want


@pytest.mark.parametrize("dtype,D,err", [
    (torch.float16, 64, TypeError), (torch.bfloat16, 48, ValueError),
    (torch.float32, 512, ValueError),
])
def test_attention_bwd_route_refuses(dtype, D, err):
    with pytest.raises(err):
        attention_bwd_route(dtype, D)
