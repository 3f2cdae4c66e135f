"""Decode attention with a query whose dtype differs from the KV cache's:
the port's ``flash_decode``, ``serve_decode`` and ``serve_loop`` with an
fp32 query (``compute_dtype="float32"``) beside a bf16 cache — the serving
default — and a bf16 query beside an fp32 cache.

The reference takes any mix: it writes the new K/V in the cache's dtype
and computes the attention in fp32 (``src/repro/models/layers.py``), and
its Pallas decode kernel casts q and the cache to fp32.  On the CPU the
port runs its plain version; it is held against the reference on the same
numpy inputs and parameters:

* ``flash_decode`` with an fp32 query: rtol = atol = 2e-5, the reference's
  fp32 kernel tolerance — both compute in fp32 from the same bf16 cache
  values, only the summation order differs.  With a bf16 query the output
  is bf16 in both: one bf16 ulp relative (2⁻⁷) plus two of the mean |entry|
  (2⁻⁶ · mean|ref|), as ``chip_smoke.py`` holds bf16 kernels.
* the model's logits, step by step: the same bf16 tolerance.  Each package
  rounds the step's fp32 K/V to bf16 when it writes the cache; where the two
  frameworks' fp32 projections straddle a rounding boundary the cached
  entries differ by one bf16 ulp, and that difference, not the attention,
  bounds the logits' agreement.

The tests marked ``cuda`` run the same calls on the card, where the
``flash_decode`` kernel reads the fp32 query itself (split into two bf16
halves on the tensor-core route, so q is held to 2⁻¹⁶): one launch a call,
repeats bit-identical; an fp32 query's output within rtol 2⁻¹³ and atol
2⁻¹³ of the mean |entry| of the plain version (three bits above the
halves, four below bf16, so that a q rounded to bf16 fails — checked on
the CPU and on the card), a bf16 one within the bf16 tolerance.  They skip
without a card.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_arch
from repro_torch.kernels import cuda_build
from repro_torch.kernels.flash_attention.decode_kernel import (
    flash_decode, flash_decode_ref)
from repro_torch.launch import serve as serve_mod
from repro_torch.models import transformer as tfm

FP32_TOL = dict(rtol=2e-5, atol=2e-5)
BF16_RTOL, BF16_ATOL_OF_MEAN = 2.0 ** -7, 2.0 ** -6
FP32_Q_RTOL = FP32_Q_ATOL_OF_MEAN = 2.0 ** -13
BF16, F32 = torch.bfloat16, torch.float32


def _np(*shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _bf16_close(out, ref):
    ref = ref.float()
    atol = BF16_ATOL_OF_MEAN * float(ref.abs().mean())
    torch.testing.assert_close(out.float(), ref, rtol=BF16_RTOL, atol=atol)


def _fp32_q_share(out, ref):
    """The worst entry's share of the fp32-query tolerance (≤ 1 passes)."""
    ref = ref.float()
    atol = FP32_Q_ATOL_OF_MEAN * float(ref.abs().mean())
    return float(((out.float() - ref).abs()
                  / (atol + FP32_Q_RTOL * ref.abs())).max())


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _cfgs(arch, **changes):
    """(reference cfg, port cfg) of ``arch``'s smoke config, fp32 compute."""
    from repro.configs import get_arch as r_get_arch

    changes.setdefault("compute_dtype", "float32")
    rc = dataclasses.replace(r_get_arch(arch).make_smoke_cfg(), **changes)
    pc = dataclasses.replace(get_arch(arch).make_smoke_cfg(), **changes)
    assert dataclasses.asdict(rc) == dataclasses.asdict(pc)
    return rc, pc


def _params(rc, pc, seed):
    import jax
    from repro.models import transformer as r_tfm

    rp = r_tfm.init_params(rc, jax.random.PRNGKey(seed))
    return rp, tfm.params_from_numpy(jax.tree.map(np.asarray, rp), pc,
                                     device="cpu")


# --------------------------------------------------------------------- #
# flash_decode, CPU, against the reference
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("q_dtype,cache_dtype", [(F32, BF16), (BF16, F32)],
                         ids=["q_fp32-cache_bf16", "q_bf16-cache_fp32"])
@pytest.mark.parametrize("B,Hq,Hkv,S,D,kv_len,cap", [
    (2, 8, 2, 256, 64, 256, 0.0), (1, 4, 4, 300, 16, 177, 0.0),
    (2, 4, 1, 128, 128, 100, 30.0),
])
def test_flash_decode_mixed_dtypes_match_reference(q_dtype, cache_dtype, B,
                                                   Hq, Hkv, S, D, kv_len,
                                                   cap):
    import jax.numpy as jnp
    from repro.kernels.flash_attention.decode_kernel import (
        flash_decode_pallas, flash_decode_ref as r_ref)

    seed = B + Hq + S + D
    q, k, v = (_np(B, Hq, 1, D, seed=seed), _np(B, Hkv, S, D, seed=seed + 1),
               _np(B, Hkv, S, D, seed=seed + 2))
    tq = torch.from_numpy(q).to(q_dtype)
    tk, tv = (torch.from_numpy(a).to(cache_dtype) for a in (k, v))
    out = flash_decode(tq, tk, tv, kv_len=kv_len, softcap=cap)
    assert out.dtype == q_dtype and out.shape == (B, Hq, 1, D)
    jdt = {F32: jnp.float32, BF16: jnp.bfloat16}
    jq = jnp.asarray(q, jdt[q_dtype])
    jk, jv = (jnp.asarray(a, jdt[cache_dtype]) for a in (k, v))
    want = _t(r_ref(jq, jk, jv, kv_len=kv_len, softcap=cap))
    pallas = _t(flash_decode_pallas(jq, jk, jv, kv_splits=4, kv_len=kv_len,
                                    softcap=cap, interpret=True))
    for ref in (want, pallas):
        if q_dtype == F32:
            torch.testing.assert_close(out, ref, **FP32_TOL)
        else:
            _bf16_close(out, ref)


@pytest.mark.parametrize("B,Hq,Hkv,S,D,kv_len,cap", [
    (8, 32, 4, 576, 64, 576, 0.0), (2, 4, 1, 128, 128, 65, 30.0),
    (1, 8, 1, 300, 16, 151, 0.0),
])
def test_fp32_query_tolerance_rejects_bf16_rounded_query(B, Hq, Hkv, S, D,
                                                         kv_len, cap):
    """The tolerance the card tests hold an fp32 query's decode to: q as
    the tensor-core route reads it (two bf16 halves, 2⁻¹⁶) passes it with
    room, and q rounded to bf16 fails it — so a kernel that dropped q's
    low half could not pass."""
    seed = S + D
    q = torch.from_numpy(_np(B, Hq, 1, D, seed=seed))
    k, v = (torch.from_numpy(_np(B, Hkv, S, D, seed=seed + i)).to(BF16)
            for i in (1, 2))
    hi = q.to(BF16).float()
    halves = hi + (q - hi).to(BF16).float()
    kw = dict(kv_len=kv_len, softcap=cap)
    ref = flash_decode_ref(q, k, v, **kw)
    assert _fp32_q_share(flash_decode_ref(halves, k, v, **kw), ref) < 0.25
    assert _fp32_q_share(flash_decode_ref(hi, k, v, **kw), ref) > 4.0


# --------------------------------------------------------------------- #
# the LM's decode step and serving loop, CPU, against the reference
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("arch,head_dim", [
    ("tinyllama-1.1b", None), ("tinyllama-1.1b", 64), ("gemma2-27b", None)],
    ids=["tinyllama", "tinyllama-d64", "gemma2"])
def test_serve_decode_fp32_compute_bf16_cache_matches_reference(arch,
                                                                head_dim):
    """Step by step over a horizon of 20 (gemma2: its local ring of 16
    wraps): logits and the bf16 caches equal the reference's."""
    import jax
    import jax.numpy as jnp
    from repro.models import transformer as r_tfm

    rc, pc = _cfgs(arch, **({} if head_dim is None else
                            {"head_dim": head_dim}))
    rp, pp = _params(rc, pc, seed=21)
    B, horizon = 2, 20
    rcache = r_tfm.init_cache(rc, B, horizon, dtype=jnp.bfloat16)
    pcache = tfm.init_cache(pc, B, horizon, dtype=BF16, device="cpu")
    step = jax.jit(lambda p, t, pos, c: r_tfm.serve_decode(p, t, pos, c, rc))
    tokens = np.random.default_rng(22).integers(0, rc.vocab, (B, horizon))
    for pos in range(horizon):
        tok = tokens[:, pos:pos + 1]
        rl, rcache = step(rp, jnp.asarray(tok, jnp.int32), jnp.int32(pos),
                          rcache)
        pl, pcache = tfm.serve_decode(pp, torch.from_numpy(tok), pos, pcache,
                                      pc)
        assert pl.dtype == F32
        _bf16_close(pl, _t(rl))
    for name in ("k", "v", "k2", "v2"):
        if getattr(rcache, name) is not None:
            got = getattr(pcache, name)
            assert got.dtype == BF16
            _bf16_close(got, _t(getattr(rcache, name)))


def test_serve_loop_fp32_compute_bf16_cache_matches_reference():
    """``serve_loop`` with its default bf16 cache and an fp32 model emits
    the reference's greedy tokens (the reference's loop over its
    ``serve_decode``, bf16 cache)."""
    import jax
    import jax.numpy as jnp
    from repro.models import transformer as r_tfm

    rc, pc = _cfgs("tinyllama-1.1b")
    rp, pp = _params(rc, pc, seed=23)
    B, P, new = 3, 5, 6
    prompts = np.random.default_rng(24).integers(0, rc.vocab, (B, P))
    res = serve_mod.serve_loop(pp, torch.from_numpy(prompts), pc, new)
    assert res.tokens.shape == (B, new) and res.decode_steps == P - 1 + new

    step = jax.jit(lambda p, t, pos, c: r_tfm.serve_decode(p, t, pos, c, rc))
    cache = r_tfm.init_cache(rc, B, P + new, dtype=jnp.bfloat16)
    jp = jnp.asarray(prompts, jnp.int32)
    for t in range(P - 1):
        _, cache = step(rp, jp[:, t:t + 1], jnp.int32(t), cache)
    tok, ref = jp[:, -1:], []
    for t in range(P - 1, P - 1 + new):
        logits, cache = step(rp, tok, jnp.int32(t), cache)
        tok = jnp.argmax(logits, axis=-1)[:, None].astype(jnp.int32)
        ref.append(np.asarray(tok))
    assert np.array_equal(res.tokens.numpy(), np.concatenate(ref, axis=1))


# --------------------------------------------------------------------- #
# the same calls on the card
# --------------------------------------------------------------------- #
@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("q_dtype,cache_dtype", [(F32, BF16), (BF16, F32)],
                         ids=["q_fp32-cache_bf16", "q_bf16-cache_fp32"])
@pytest.mark.parametrize("D", [16, 64, 128])
def test_cuda_flash_decode_mixed_dtypes(card, q_dtype, cache_dtype, D):
    """D 64 and 128 with a bf16 cache take the tensor-core route, D 16 the
    FMA one; one launch a call, repeats bit-identical, output in q's
    dtype.  An fp32 q within the fp32-query tolerance, which the same q
    rounded to bf16 fails."""
    gen = torch.Generator(device=card).manual_seed(D)
    q = torch.randn(8, 32, 1, D, generator=gen, device=card).to(q_dtype)
    k, v = (torch.randn(8, 4, 576, D, generator=gen, device=card)
            .to(cache_dtype) for _ in range(2))
    for kv_len, cap in ((576, 0.0), (300, 0.0), (1, 0.0), (576, 30.0)):
        before = cuda_build.launches["flash_decode"]
        outs = [flash_decode(q, k, v, kv_len=kv_len, softcap=cap)
                for _ in range(2)]
        assert cuda_build.launches["flash_decode"] == before + 2
        assert outs[0].dtype == q_dtype and outs[0].shape == q.shape
        assert torch.equal(outs[0], outs[1])
        ref = flash_decode_ref(q, k, v, kv_len=kv_len, softcap=cap)
        if q_dtype == F32:
            assert _fp32_q_share(outs[0], ref) <= 1.0
            if kv_len > 1:  # one slot's weight is 1 whatever q is
                rounded = flash_decode_ref(q.to(BF16).float(), k, v,
                                           kv_len=kv_len, softcap=cap)
                assert _fp32_q_share(rounded, ref) > 1.0
        else:
            _bf16_close(outs[0], ref)


@pytest.mark.cuda
@pytest.mark.parametrize("head_dim", [16, 64])
def test_cuda_serve_fp32_compute_bf16_cache(card, head_dim):
    """serve_decode and serve_loop on the card, fp32 model and bf16 cache:
    one flash_decode launch per layer a step, logits as on the CPU."""
    cfg = dataclasses.replace(get_arch("tinyllama-1.1b").make_smoke_cfg(),
                              compute_dtype="float32", head_dim=head_dim)
    params = tfm.init_params(cfg, torch.Generator().manual_seed(25),
                             torch.device("cpu"))
    on_card = _to(params, card)
    B, horizon = 2, 12
    tokens = torch.from_numpy(
        np.random.default_rng(26).integers(0, cfg.vocab, (B, horizon)))
    ccpu = tfm.init_cache(cfg, B, horizon, dtype=BF16, device="cpu")
    ccard = tfm.init_cache(cfg, B, horizon, dtype=BF16, device=card)
    for pos in range(horizon):
        tok = tokens[:, pos:pos + 1]
        before = cuda_build.launches["flash_decode"]
        lg_card, ccard = tfm.serve_decode(on_card, tok.to(card), pos, ccard,
                                          cfg)
        torch.cuda.synchronize()
        assert cuda_build.launches["flash_decode"] == before + cfg.n_layers
        lg_cpu, ccpu = tfm.serve_decode(params, tok, pos, ccpu, cfg)
        _bf16_close(lg_card.cpu(), lg_cpu)
    before = cuda_build.launches["flash_decode"]
    res = serve_mod.serve_loop(on_card, tokens[:, :4].to(card), cfg, 3)
    assert cuda_build.launches["flash_decode"] == \
        before + cfg.n_layers * res.decode_steps
    assert res.tokens.shape == (B, 3)


def _to(tree, device):
    """A copy of a parameter tree (dicts, lists, tensors) on ``device``."""
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, device) for v in tree]
    return tree.to(device)
