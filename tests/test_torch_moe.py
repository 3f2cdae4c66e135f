"""Port parity of the MoE layer (``repro_torch.models.moe``) against the
reference's ``repro.models.moe``, on the CPU.

Both packages run on the same parameters (the reference's ``init_moe``
tree as numpy arrays) and the same numpy inputs.  The binning is held
exactly: the router's expert ids (also when every probability ties),
the kept mask, the slab ids and the sorted token ids.  Gates and fp32
outputs pass
at ``rtol=1e-5, atol=1e-6`` (the same products, summed in another order:
XLA's ``segment_sum`` against the port's sum over the ``k`` slots), the
aux loss at ``rtol=1e-6``.  bf16 outputs pass at two bf16 ulps relative
(``2**-7`` each) plus two of the largest |entry|: both frameworks round
the GEMMs' outputs, the activation and the gate products to bf16, each
at its own point.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import moe as r_moe
from repro_torch.models import moe

FP32_TOL = dict(rtol=1e-5, atol=1e-6)
BF16_RTOL = 2 * 2.0 ** -7


def _cfgs(**kw):
    base = dict(d_model=32, d_ff=48, num_experts=8, top_k=2,
                capacity_factor=1.25, kind="swiglu", dispatch="global")
    base.update(kw)
    return r_moe.MoECfg(**base), moe.MoECfg(**base)


def _params(rc, seed=0, router_scale=1.0):
    """(reference params, port params) with equal values."""
    rp = r_moe.init_moe(jax.random.PRNGKey(seed), rc)
    rp = {n: np.asarray(w) for n, w in rp.items()}
    rp["router"] = rp["router"] * np.float32(router_scale)
    pp = {n: torch.from_numpy(w.copy()) for n, w in rp.items()}
    return {n: jnp.asarray(w) for n, w in rp.items()}, pp


def _x(B, S, d, seed=1, shift=0.0):
    """Normal activations; ``shift`` adds one offset to every token, which
    sends them to the same experts (skewed bins that overflow)."""
    x = np.random.default_rng(seed).standard_normal((B, S, d)) + shift
    return x.astype(np.float32)


def _ref_route(rp, xt, cfg):
    """The reference's routing, as ``moe_block`` computes it."""
    logits = jnp.einsum("nd,de->ne", xt.astype(jnp.float32), rp["router"])
    probs = jax.nn.softmax(logits, axis=-1)
    gate_vals, expert_ids = jax.lax.top_k(probs, cfg.top_k)
    gate_vals = gate_vals / jnp.maximum(gate_vals.sum(-1, keepdims=True),
                                        1e-9)
    return probs, gate_vals, expert_ids


def _binning(rp, pp, x, rc, pc):
    """Both packages' ``_bin_and_dispatch`` outputs and expert ids."""
    n = x.shape[0] * x.shape[1]
    xt = x.reshape(n, -1)
    _, r_gates, r_ids = _ref_route(rp, jnp.asarray(xt), rc)
    _, p_gates, p_ids = moe.route(pp, torch.from_numpy(xt), pc)
    C = moe._capacity(n, pc)
    assert C == r_moe._capacity(n, rc)
    ref = r_moe._bin_and_dispatch(jnp.asarray(xt), r_gates, r_ids,
                                  rc.num_experts, C)
    out = moe._bin_and_dispatch(torch.from_numpy(xt), p_gates, p_ids,
                                pc.num_experts, C)
    return ref, out, np.asarray(r_ids), p_ids.numpy()


CASES = [  # (B, S, capacity_factor, shift, drops expected)
    (2, 24, 1.25, 1.0, True),
    (2, 24, 8.0, 1.0, False),
    (3, 7, 1.25, 0.0, False),
    (1, 1, 1.25, 0.0, False),
]


@pytest.mark.parametrize("kind", ["swiglu", "geglu", "gelu"])
@pytest.mark.parametrize("B,S,cf,shift,drops", CASES,
                         ids=["drops", "cf8", "few", "one"])
def test_moe_block_matches_reference(kind, B, S, cf, shift, drops):
    rc, pc = _cfgs(kind=kind, capacity_factor=cf)
    rp, pp = _params(rc, seed=2)
    x = _x(B, S, rc.d_model, seed=3, shift=shift)

    ref, out, r_ids, p_ids = _binning(rp, pp, x, rc, pc)
    assert np.array_equal(p_ids, r_ids)
    _, r_slab, r_st, r_sg, r_keep = ref
    dispatched, slab, st, sg, keep, order = out
    assert np.array_equal(keep.numpy(), np.asarray(r_keep))
    assert np.array_equal(slab.numpy(), np.asarray(r_slab))
    assert np.array_equal(st.numpy(), np.asarray(r_st))
    # gates: the router's fp32 products summed in another order
    torch.testing.assert_close(sg, torch.from_numpy(np.asarray(r_sg)),
                               **FP32_TOL)
    torch.testing.assert_close(dispatched, torch.from_numpy(np.asarray(
        ref[0])), rtol=0, atol=0)
    assert bool((~keep).any()) == drops

    r_out, r_aux = r_moe.moe_block(rp, jnp.asarray(x), rc)
    p_out, p_aux = moe.moe_block(pp, torch.from_numpy(x), pc)
    assert p_out.shape == x.shape and p_out.dtype == torch.float32
    torch.testing.assert_close(p_out, torch.from_numpy(np.asarray(r_out)),
                               **FP32_TOL)
    torch.testing.assert_close(p_aux, torch.tensor(float(r_aux)), rtol=1e-6,
                               atol=0)


def test_zero_router_ties_resolve_as_lax_top_k():
    """Every probability ties: the ids are lax.top_k's (the lowest expert
    ids, in order), so the bins, the drops and the outputs are the
    reference's too.  ``route`` gets that order from a stable descending
    sort; ``torch.topk`` is free to order ties otherwise."""
    rc, pc = _cfgs(num_experts=40, top_k=8, d_model=16, d_ff=8)
    rp, pp = _params(rc, seed=4, router_scale=0.0)
    x = _x(2, 16, rc.d_model, seed=5)
    xt = torch.from_numpy(x.reshape(32, -1))
    _, gates, ids = moe.route(pp, xt, pc)
    assert np.array_equal(ids.numpy(),
                          np.broadcast_to(np.arange(8), (32, 8)))
    torch.testing.assert_close(gates, torch.full((32, 8), 1 / 8))
    ref, out, r_ids, p_ids = _binning(rp, pp, x, rc, pc)
    assert np.array_equal(p_ids, r_ids)
    assert np.array_equal(out[4].numpy(), np.asarray(ref[4]))
    assert np.array_equal(out[1].numpy(), np.asarray(ref[1]))
    # 32 tokens into the same 8 experts, C = 8: three quarters dropped
    assert int(out[4].sum()) == 8 * 8
    r_out, r_aux = r_moe.moe_block(rp, jnp.asarray(x), rc)
    p_out, p_aux = moe.moe_block(pp, torch.from_numpy(x), pc)
    torch.testing.assert_close(p_out, torch.from_numpy(np.asarray(r_out)),
                               **FP32_TOL)
    torch.testing.assert_close(p_aux, torch.tensor(float(r_aux)), rtol=1e-6,
                               atol=0)


@pytest.mark.parametrize("cf", [1.25, 8.0])
def test_moe_block_bf16_matches_reference(cf):
    """bf16 activations: the router still runs in fp32 (same ids, kept set
    and slab ids), the expert weights are cast to bf16 at use."""
    rc, pc = _cfgs(capacity_factor=cf)
    rp, pp = _params(rc, seed=6)
    x = _x(2, 24, rc.d_model, seed=7, shift=1.0)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    xt = torch.from_numpy(x).to(torch.bfloat16)
    assert np.array_equal(np.asarray(xb.astype(jnp.float32)),
                          xt.float().numpy())
    r_out, r_aux = r_moe.moe_block(rp, xb, rc)
    p_out, p_aux = moe.moe_block(pp, xt, pc)
    assert p_out.dtype == torch.bfloat16
    ref = torch.from_numpy(np.asarray(r_out.astype(jnp.float32)))
    torch.testing.assert_close(p_out.float(), ref, rtol=BF16_RTOL,
                               atol=BF16_RTOL * float(ref.abs().max()))
    torch.testing.assert_close(p_aux, torch.tensor(float(r_aux)), rtol=1e-6,
                               atol=0)


def test_combine_is_a_fixed_order_sum():
    """Two calls give bit-equal outputs, and the combine equals an explicit
    loop over each token's k pairs in slot order."""
    rc, pc = _cfgs(capacity_factor=8.0)
    _, pp = _params(rc, seed=8)
    x = torch.from_numpy(_x(2, 9, rc.d_model, seed=9))
    a, _ = moe.moe_block(pp, x, pc)
    b, _ = moe.moe_block(pp, x, pc)
    assert torch.equal(a, b)
    xt = x.reshape(18, -1)
    _, gates, ids = moe.route(pp, xt, pc)
    want = torch.zeros_like(xt)
    for t in range(18):
        for j in range(pc.top_k):
            e = int(ids[t, j])
            one = {n: w[e:e + 1] for n, w in pp.items() if n != "router"}
            y = moe._experts(one, xt[t][None, None], pc.kind)[0, 0]
            want[t] += gates[t, j] * y
    torch.testing.assert_close(a.reshape(18, -1), want, **FP32_TOL)


def test_dispatch_modes():
    """Both of the reference's modes take the one bin pass on one card;
    anything else is refused."""
    rc, pc = _cfgs()
    _, pp = _params(rc)
    x = torch.from_numpy(_x(2, 5, rc.d_model))
    a, _ = moe.moe_block(pp, x, pc)
    b, _ = moe.moe_block(pp, x, dataclasses.replace(pc, dispatch="sharded"))
    assert torch.equal(a, b)
    with pytest.raises(ValueError, match="dispatch"):
        moe.moe_block(pp, x, dataclasses.replace(pc, dispatch="ring"))


@pytest.mark.parametrize("kind", ["swiglu", "gelu"])
def test_init_moe_shapes(kind):
    _, pc = _cfgs(kind=kind)
    p = moe.init_moe(torch.Generator().manual_seed(0), pc, device="cpu")
    rp = r_moe.init_moe(jax.random.PRNGKey(0), _cfgs(kind=kind)[0])
    assert {n: tuple(w.shape) for n, w in p.items()} == \
        {n: tuple(w.shape) for n, w in rp.items()}
    assert all(w.dtype == torch.float32 for w in p.values())
    assert moe._capacity(48, pc) == r_moe._capacity(48, _cfgs()[0]) == 16
