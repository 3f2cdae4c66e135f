"""The attention gradient of the port (``repro_torch.kernels.flash_attention``).

On the CPU, :func:`attention` runs its plain version and its gradient is
torch autograd of it; it is held against ``jax.vjp`` of the reference's
``attention_ref`` on the same numpy inputs and cotangent, fp32, at
``rtol = atol = 1e-5`` (the same function; only the order of fp32 sums
differs).

The tests marked ``cuda`` launch the ``flash_attention_bwd`` kernel through
the autograd path of :func:`attention` and hold (dq, dk, dv) against torch
autograd of the plain version in fp32 on the same inputs: the largest error
of each gradient over its largest magnitude must stay under 1e-4 for fp32
inputs and 2⁻⁷ (one bf16 ulp at 1.0) for bf16 ones.  They skip without a
card.  JAX is imported inside the tests that use it.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import cuda_build
from repro_torch.kernels.flash_attention import attention, attention_ref
from repro_torch.kernels.flash_attention.kernel import (
    flash_attention_bwd_cuda, flash_attention_cuda)

#: kernel gradient vs the fp32 oracle: max |err| over max |oracle|
REL_OF_MAX = {torch.float32: 1e-4, torch.bfloat16: 2.0 ** -7}

CASES = [  # (B, Hq, Hkv, Sq, Skv, D), causal, window, softcap
    ((1, 4, 4, 40, 40, 16), True, 0, 0.0),
    ((2, 8, 2, 33, 33, 8), True, 12, 0.0),  # GQA 4, window, ragged
    ((1, 6, 2, 24, 40, 16), False, 0, 5.0),  # bidirectional, Sq ≠ Skv
    ((1, 4, 1, 48, 48, 32), True, 16, 3.0),  # MQA, window and softcap
]


def _np(*shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _inputs(shape, seed):
    B, Hq, Hkv, Sq, Skv, D = shape
    return (_np(B, Hq, Sq, D, seed=seed), _np(B, Hkv, Skv, D, seed=seed + 1),
            _np(B, Hkv, Skv, D, seed=seed + 2), _np(B, Hq, Sq, D,
                                                    seed=seed + 3))


@pytest.mark.parametrize("shape,causal,window,softcap", CASES)
def test_cpu_gradient_matches_jax_vjp(shape, causal, window, softcap):
    import jax
    import jax.numpy as jnp
    from repro.kernels.flash_attention.ref import attention_ref as r_ref

    q, k, v, g = _inputs(shape, seed=sum(shape))
    kw = dict(causal=causal, window=window, softcap=softcap)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = attention(tq, tk, tv, **kw)
    out.backward(torch.from_numpy(g))
    ref_out, vjp = jax.vjp(lambda a, b, c: r_ref(a, b, c, **kw),
                           *map(jnp.asarray, (q, k, v)))
    torch.testing.assert_close(out.detach(),
                               torch.from_numpy(np.array(ref_out)),
                               rtol=1e-5, atol=1e-5)
    for t, r in zip((tq, tk, tv), vjp(jnp.asarray(g))):
        torch.testing.assert_close(t.grad, torch.from_numpy(np.array(r)),
                                   rtol=1e-5, atol=1e-5)


def test_cpu_route_has_a_gradient_for_every_operand():
    q, k, v, g = _inputs((1, 4, 2, 16, 16, 8), seed=3)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    attention(tq, tk, tv).backward(torch.from_numpy(g))
    for t in (tq, tk, tv):
        assert t.grad is not None and bool(t.grad.abs().sum() > 0)


def test_backward_launcher_needs_the_card():
    q = torch.zeros(1, 1, 8, 8)
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention_bwd_cuda(q, q, q, q, q)


# --------------------------------------------------------------------- #
# the hand-written CUDA kernel (on the card only)
# --------------------------------------------------------------------- #
@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def _oracle(q, k, v, dout, **kw):
    """(dq, dk, dv) of the plain version in fp32 on the same values."""
    fq, fk, fv = (t.detach().float().requires_grad_() for t in (q, k, v))
    attention_ref(fq, fk, fv, **kw).backward(dout.float())
    return fq.grad, fk.grad, fv.grad


def _rel_of_max(out, ref):
    return float((out.float() - ref).abs().max()) / max(
        float(ref.abs().max()), 1e-30)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [8, 16, 32, 64, 128, 256])
def test_cuda_backward_matches_plain(card, dtype, D):
    for (B, Hq, Hkv, Sq, Skv, _), causal, window, cap in (
            ((2, 8, 2, 200, 200, D), True, 0, 0.0),
            ((1, 4, 1, 130, 130, D), True, 64, 30.0),
            ((1, 4, 2, 70, 100, D), False, 0, 0.0),
            ((1, 2, 2, 97, 97, D), False, 40, 20.0)):
        q, k, v, g = (torch.from_numpy(a).to(card, dtype) for a in _inputs(
            (B, Hq, Hkv, Sq, Skv, D), seed=D))
        kw = dict(causal=causal, window=window, softcap=cap)
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        n0 = cuda_build.launches["flash_attention_bwd"]
        attention(*leaves, **kw).backward(g)
        assert cuda_build.launches["flash_attention_bwd"] == n0 + 1
        for t, r in zip(leaves, _oracle(q, k, v, g, **kw)):
            assert t.grad.dtype == dtype
            assert _rel_of_max(t.grad, r) <= REL_OF_MAX[dtype], kw


@pytest.mark.cuda
def test_cuda_backward_is_bit_reproducible(card):
    q, k, v, g = (torch.from_numpy(a).to(card, torch.bfloat16)
                  for a in _inputs((2, 8, 2, 256, 256, 64), seed=7))
    out = flash_attention_cuda(q, k, v, causal=True)
    first = flash_attention_bwd_cuda(q, k, v, out, g, causal=True)
    again = flash_attention_bwd_cuda(q, k, v, out, g, causal=True)
    assert all(torch.equal(a, b) for a, b in zip(first, again))


@pytest.mark.cuda
def test_cuda_launchers_refuse_a_dropped_gradient(card):
    q = torch.zeros(1, 2, 16, 16, device=card, requires_grad=True)
    with pytest.raises(RuntimeError, match="flash_attention_bwd"):
        flash_attention_cuda(q, q, q)
    with torch.no_grad():
        flash_attention_cuda(q, q, q)  # no graph recorded: allowed
    n0 = cuda_build.launches["flash_attention_bwd"]
    with torch.no_grad():
        attention(q, q, q)
    attention(q.detach(), q.detach(), q.detach())
    assert cuda_build.launches["flash_attention_bwd"] == n0
