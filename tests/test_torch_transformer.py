"""Port parity of the LM serving slices: layers, the transformer (dense
and MoE), its KV-cache decode and the serving loop (``repro_torch.models``,
``repro_torch.launch.serve``), against the reference package.

Both packages run on the same parameters: the reference's ``init_params``
tree, carried across as numpy arrays by ``params_from_numpy``, and the
same numpy inputs.  Everything runs in fp32 on the CPU (the port's plain
attention versions).  Layers and logits pass at ``rtol = atol = 1e-4``
(fp32 summation order differs between the frameworks); prefill against
decode at the reference's own ``rtol = 1e-3, atol = 1e-4``
(``tests/test_models.py``).
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_arch
from repro_torch.launch import serve as serve_mod
from repro_torch.models import layers as L
from repro_torch.models import transformer as tfm

TOL = dict(rtol=1e-4, atol=1e-4)
CPU = torch.device("cpu")


def _np(*shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale
            ).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _close(out, ref, **tol):
    torch.testing.assert_close(out.float(), _t(ref), **(tol or TOL))


def _cfgs(arch, **changes):
    """(reference cfg, port cfg) of ``arch``'s smoke config in fp32."""
    from repro.configs import get_arch as r_get_arch

    changes.setdefault("compute_dtype", "float32")
    rc = dataclasses.replace(r_get_arch(arch).make_smoke_cfg(), **changes)
    pc = dataclasses.replace(get_arch(arch).make_smoke_cfg(), **changes)
    assert dataclasses.asdict(rc) == dataclasses.asdict(pc)
    return rc, pc


def _params(rc, pc, seed=0):
    """(reference params, port params) with equal values."""
    import jax
    from repro.models import transformer as r_tfm

    rp = r_tfm.init_params(rc, jax.random.PRNGKey(seed))
    tree = jax.tree.map(np.asarray, rp)
    return rp, tfm.params_from_numpy(tree, pc, device="cpu")


def _attn_cfgs(**kw):
    from repro.models.layers import AttnCfg as RAttnCfg

    base = dict(d_model=32, n_heads=4, n_kv_heads=2, head_dim=8)
    base.update(kw)
    return RAttnCfg(**base), L.AttnCfg(**base)


# --------------------------------------------------------------------- #
# layers
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("plus_one", [False, True])
def test_rms_norm(plus_one):
    import jax.numpy as jnp
    from repro.models.layers import rms_norm as r_rms_norm

    x, g = _np(2, 5, 32, seed=1), _np(32, seed=2)
    out = L.rms_norm(_t(x), _t(g), plus_one=plus_one)
    _close(out, r_rms_norm(jnp.asarray(x), jnp.asarray(g), plus_one=plus_one))


def test_rope():
    import jax.numpy as jnp
    from repro.models.layers import rope as r_rope

    x = _np(2, 7, 3, 16, seed=3)
    pos = np.arange(14).reshape(2, 7) * 3
    out = L.rope(_t(x), torch.from_numpy(pos), theta=500.0)
    _close(out, r_rope(jnp.asarray(x), jnp.asarray(pos), theta=500.0))


@pytest.mark.parametrize("kind", ["swiglu", "geglu", "gelu"])
def test_mlp_block(kind):
    import jax
    import jax.numpy as jnp
    from repro.models.layers import init_mlp as r_init_mlp
    from repro.models.layers import mlp_block as r_mlp_block

    p = r_init_mlp(jax.random.PRNGKey(4), 32, 48, kind)
    x = _np(2, 5, 32, seed=5)
    out = L.mlp_block({n: _t(w) for n, w in p.items()}, _t(x), kind)
    _close(out, r_mlp_block(p, jnp.asarray(x), kind))


@pytest.mark.parametrize("window,softcap,causal", [
    (0, 0.0, True), (4, 0.0, True), (0, 20.0, True), (0, 0.0, False),
])
def test_attention_block(window, softcap, causal):
    import jax
    import jax.numpy as jnp
    from repro.models.layers import attention_block as r_block
    from repro.models.layers import init_attention as r_init

    rcfg, pcfg = _attn_cfgs(window=window, softcap=softcap, causal=causal)
    p = r_init(jax.random.PRNGKey(6), rcfg)
    x = _np(2, 12, 32, seed=7)
    pos = np.broadcast_to(np.arange(12), (2, 12)).copy()
    out = L.attention_block({n: _t(w) for n, w in p.items()}, _t(x),
                            torch.from_numpy(pos), pcfg)
    _close(out, r_block(p, jnp.asarray(x), jnp.asarray(pos), rcfg))


@pytest.mark.parametrize("window,s_max", [(0, 10), (4, 4)],
                         ids=["global", "ring"])
def test_decode_attention_block(window, s_max):
    """Ten steps, each against the reference's step on the same cache: the
    output and the whole cache (written in place here) agree; the ring
    wraps after step 4 in the windowed case."""
    import jax
    import jax.numpy as jnp
    from repro.models.layers import decode_attention_block as r_block
    from repro.models.layers import init_attention as r_init

    rcfg, pcfg = _attn_cfgs(window=window, softcap=10.0)
    p = r_init(jax.random.PRNGKey(8), rcfg)
    pp = {n: _t(w) for n, w in p.items()}
    rk = rv = jnp.zeros((2, 2, s_max, 8), jnp.float32)
    pk, pv = torch.zeros(2, 2, s_max, 8), torch.zeros(2, 2, s_max, 8)
    for pos in range(10):
        x = _np(2, 1, 32, seed=100 + pos)
        ro, rk, rv = r_block(p, jnp.asarray(x), jnp.int32(pos), rk, rv, rcfg)
        po, k_out, v_out = L.decode_attention_block(pp, _t(x), pos, pk, pv,
                                                    pcfg)
        assert k_out is pk and v_out is pv  # updated in place
        _close(po, ro)
        _close(pk, rk)
        _close(pv, rv)


def test_decode_refuses_window_shorter_than_cache():
    _, pcfg = _attn_cfgs(window=4)
    p = L.init_attention(torch.Generator().manual_seed(0), pcfg, CPU)
    cache = torch.zeros(1, 2, 8, 8)
    with pytest.raises(ValueError, match="prefix"):
        L.decode_attention_block(p, torch.zeros(1, 1, 32), 0, cache,
                                 cache.clone(), pcfg)


# --------------------------------------------------------------------- #
# parameters
# --------------------------------------------------------------------- #
MOE_ARCHS = ["granite-moe-3b-a800m", "mixtral-8x22b"]


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "gemma2-27b", *MOE_ARCHS])
def test_params_from_numpy_round_trip(arch):
    """Every leaf of the reference tree lands, unchanged, in the port's
    per-layer form (alternating layers restacked (L/2, 2, …); MoE layers
    with a ``moe`` subtree in place of ``mlp``)."""
    rc, pc = _cfgs(arch)
    rp, pp = _params(rc, pc)
    for name in ("embed", "ln_final"):
        assert np.array_equal(pp[name].numpy(), np.asarray(rp[name]))
    assert len(pp["layers"]) == pc.n_layers
    ffn = "moe" if pc.is_moe else "mlp"
    for i, layer in enumerate(pp["layers"]):
        assert set(layer) == {"ln_attn", "ln_mlp", "attn", ffn}
        for group in ("attn", ffn):
            for n, w in layer[group].items():
                ref = np.asarray(rp["layers"][group][n])
                ref = ref[i // 2, i % 2] if pc.pair_scan else ref[i]
                assert np.array_equal(w.numpy(), ref), (i, group, n)
        for n in ("ln_attn", "ln_mlp"):
            ref = np.asarray(rp["layers"][n])
            ref = ref[i // 2, i % 2] if pc.pair_scan else ref[i]
            assert np.array_equal(layer[n].numpy(), ref)
    assert tfm.param_count(pp) == pc.param_count() == rc.param_count()


def test_init_params_shapes_and_cast():
    """The port's own init: the reference's shapes and scale, fp32; the
    compute-dtype copy casts the matmul weights only and computes the same
    forward as casting at every use."""
    pc = dataclasses.replace(get_arch("tinyllama-1.1b").make_smoke_cfg(),
                             compute_dtype="bfloat16")
    gen = torch.Generator().manual_seed(0)
    pp = tfm.init_params(pc, gen, device="cpu")
    assert tfm.param_count(pp) == pc.param_count()
    assert pp["layers"][0]["attn"]["wq"].shape == (64, 4, 16)
    assert pp["layers"][0]["attn"]["wo"].shape == (4, 16, 64)
    assert all(w.dtype == torch.float32 for w in pp["layers"][1]["mlp"].values())
    cast = tfm.cast_params(pp, pc)
    assert cast["layers"][0]["mlp"]["w_up"].dtype == torch.bfloat16
    assert cast["layers"][0]["ln_attn"].dtype == torch.float32
    assert cast["embed"] is pp["embed"]
    tokens = torch.from_numpy(np.random.default_rng(1).integers(0, 512, (2, 9)))
    a, _ = tfm.forward(pp, tokens, pc)
    b, _ = tfm.forward(cast, tokens, pc)
    assert torch.equal(a, b)


# --------------------------------------------------------------------- #
# the model
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "gemma-7b", "gemma2-27b",
                                  *MOE_ARCHS])
def test_forward_matches_reference(arch):
    """Logits and the summed MoE aux loss (0 for a dense model); the MoE
    smoke configs at their capacity factor 1.25, drops included."""
    from repro.models import transformer as r_tfm

    rc, pc = _cfgs(arch)
    rp, pp = _params(rc, pc, seed=1)
    tokens = np.random.default_rng(2).integers(0, rc.vocab, (2, 24))
    ref, r_aux = r_tfm.forward(rp, tokens.astype(np.int32), rc)
    out, aux = tfm.forward(pp, torch.from_numpy(tokens), pc)
    assert out.dtype == torch.float32 and out.shape == (2, 24, rc.vocab)
    if pc.is_moe:
        assert float(aux) > 0.0
        _close(aux, r_aux, rtol=1e-5, atol=0)
    else:
        assert float(aux) == float(r_aux) == 0.0
    _close(out, ref)
    last = tfm.serve_prefill(pp, torch.from_numpy(tokens), pc)
    _close(last, np.asarray(ref)[:, -1])


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "gemma2-27b", *MOE_ARCHS])
def test_serve_decode_matches_reference(arch):
    """Step by step: logits and caches equal the reference's on one
    fp32 cache (gemma2: a local ring of 16 and a global half, horizon 20,
    so the local ring wraps; mixtral: a ring of 16 that wraps; the
    reference's decode dispatches its MoE layers globally)."""
    import jax
    import jax.numpy as jnp
    from repro.models import transformer as r_tfm

    rc, pc = _cfgs(arch)
    rp, pp = _params(rc, pc, seed=3)
    B, horizon = 2, 20
    rcache = r_tfm.init_cache(rc, B, horizon, dtype=jnp.float32)
    pcache = tfm.init_cache(pc, B, horizon, dtype=torch.float32, device="cpu")
    step = jax.jit(lambda p, t, pos, c: r_tfm.serve_decode(p, t, pos, c, rc))
    tokens = np.random.default_rng(4).integers(0, rc.vocab, (B, horizon))
    for pos in range(horizon):
        tok = tokens[:, pos:pos + 1]
        rl, rcache = step(rp, jnp.asarray(tok, jnp.int32), jnp.int32(pos),
                          rcache)
        pl, pcache = tfm.serve_decode(pp, torch.from_numpy(tok), pos, pcache,
                                      pc)
        _close(pl, rl)
    for name in ("k", "v", "k2", "v2"):
        if getattr(rcache, name) is not None:
            _close(getattr(pcache, name), getattr(rcache, name))


def test_prefill_matches_decode_on_wrapping_ring():
    """Decoding token by token equals the forward on a windowed model whose
    ring (window 8) wraps twice over a 24-token horizon — the reference's
    test_lm_prefill_matches_decode on the dense form of its config."""
    from repro.models import transformer as r_tfm

    rc, pc = _cfgs("mixtral-8x22b", num_experts=0, top_k=0, window=8)
    rp, pp = _params(rc, pc, seed=5)
    S = 24
    tokens = torch.from_numpy(np.random.default_rng(6).integers(0, 512, (1, S)))
    full, _ = tfm.forward(pp, tokens, pc)
    cache = tfm.init_cache(pc, 1, horizon=S, dtype=torch.float32, device="cpu")
    assert cache.k.shape[3] == 8
    steps = []
    for t in range(S):
        lg, cache = tfm.serve_decode(pp, tokens[:, t:t + 1], t, cache, pc)
        steps.append(lg)
    torch.testing.assert_close(torch.stack(steps, dim=1), full, rtol=1e-3,
                               atol=1e-4)
    ref, _ = r_tfm.forward(rp, tokens.numpy().astype(np.int32), rc)
    _close(full, ref)


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", *MOE_ARCHS])
def test_serve_loop_greedy_tokens_match_reference(arch):
    """The port's serving loop emits the reference's greedy tokens: the
    same loop (prefill by decode steps, then argmax) over the reference's
    serve_decode, fp32 caches."""
    import jax
    import jax.numpy as jnp
    from repro.models import transformer as r_tfm

    rc, pc = _cfgs(arch)
    rp, pp = _params(rc, pc, seed=7)
    B, P, new = 3, 6, 8
    prompts = np.random.default_rng(8).integers(0, rc.vocab, (B, P))
    res = serve_mod.serve_loop(pp, torch.from_numpy(prompts), pc, new,
                               cache_dtype=torch.float32)
    assert res.tokens.shape == (B, new) and res.decode_steps == P - 1 + new
    assert len(res.step_seconds) == new

    step = jax.jit(lambda p, t, pos, c: r_tfm.serve_decode(p, t, pos, c, rc))
    cache = r_tfm.init_cache(rc, B, P + new, dtype=jnp.float32)
    jp = jnp.asarray(prompts, jnp.int32)
    for t in range(P - 1):
        _, cache = step(rp, jp[:, t:t + 1], jnp.int32(t), cache)
    tok, ref = jp[:, -1:], []
    for t in range(P - 1, P - 1 + new):
        logits, cache = step(rp, tok, jnp.int32(t), cache)
        tok = jnp.argmax(logits, axis=-1)[:, None].astype(jnp.int32)
        ref.append(np.asarray(tok))
    assert np.array_equal(res.tokens.numpy(), np.concatenate(ref, axis=1))


def test_serve_cli_records_metrics():
    from repro_torch.obs import trace
    from repro_torch.obs.metrics import registry

    with trace.enable():  # spans record only when tracing is on
        res = serve_mod.main(["--arch", "gemma2-27b", "--device", "cpu",
                              "--requests", "2", "--prompt-len", "5",
                              "--max-new", "3"])
    assert res.tokens.shape == (2, 3)
    names = registry.names()
    for metric in ("serve.prefill_seconds", "serve.decode_seconds",
                   "serve.tokens_per_s", "serve.decode_tokens_per_s"):
        assert metric in names
    spans = {e["name"] for e in trace.events()}
    assert {"serve.prefill", "serve.decode"} <= spans


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_serve_cli_moe_archs(arch):
    """The CLI serves the MoE smoke configs on the CPU, with no new flag."""
    res = serve_mod.main(["--arch", arch, "--device", "cpu", "--requests",
                          "2", "--prompt-len", "4", "--max-new", "3"])
    assert res.tokens.shape == (2, 3) and res.decode_steps == 6


def test_moe_and_later_families_raise():
    """The MoE archs build and run since their layers are ported (their
    own init: the reference's shapes, ``param_count`` equal); the GNN archs,
    refused until the training slice, are GNN configs now; an unknown arch
    raises."""
    for arch in MOE_ARCHS:
        pc = dataclasses.replace(get_arch(arch).make_smoke_cfg(),
                                 compute_dtype="bfloat16")
        pp = tfm.init_params(pc, torch.Generator().manual_seed(0),
                             device="cpu")
        assert tfm.param_count(pp) == pc.param_count()
        moe = pp["layers"][0]["moe"]
        assert moe["router"].shape == (pc.d_model, pc.num_experts)
        assert moe["w_up"].shape == (pc.num_experts, pc.d_model, pc.d_ff)
        cast = tfm.cast_params(pp, pc)
        assert cast["layers"][0]["moe"]["w_gate"].dtype == torch.bfloat16
        assert cast["layers"][0]["moe"]["router"].dtype == torch.float32
        logits, aux = tfm.forward(cast, torch.zeros(1, 3, dtype=torch.long),
                                  pc)
        assert logits.shape == (1, 3, pc.vocab) and bool(
            logits.isfinite().all()) and float(aux) > 0.0
    for arch in ("gat-cora", "gin-tu", "dimenet", "graphsage-reddit"):
        spec = get_arch(arch)
        assert spec.family == "gnn"
        assert type(spec.make_smoke_cfg()).__name__ == "GNNConfig"
    with pytest.raises(KeyError):
        get_arch("no-such-arch")


def test_moe_prefill_matches_decode():
    """The reference's test_lm_prefill_matches_decode setting: Mixtral
    smoke, window 8 (the ring wraps twice over 24 tokens), fp32, capacity
    factor 8 so that the prefill drops no pair; the reference's decode
    dispatches globally.  Then the forward against the reference's."""
    from repro.models import transformer as r_tfm

    rc, pc = _cfgs("mixtral-8x22b", window=8, capacity_factor=8.0)
    rp, pp = _params(rc, pc, seed=9)
    S = 24
    tokens = torch.from_numpy(
        np.random.default_rng(10).integers(0, rc.vocab, (1, S)))
    full, _ = tfm.forward(pp, tokens, pc)
    cache = tfm.init_cache(pc, 1, horizon=S, dtype=torch.float32,
                           device="cpu")
    steps = []
    for t in range(S):
        lg, cache = tfm.serve_decode(pp, tokens[:, t:t + 1], t, cache, pc)
        steps.append(lg)
    torch.testing.assert_close(torch.stack(steps, dim=1), full, rtol=1e-3,
                               atol=1e-4)
    ref, _ = r_tfm.forward(rp, tokens.numpy().astype(np.int32), rc)
    _close(full, ref)


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", *MOE_ARCHS])
@pytest.mark.parametrize("full", [False, True], ids=["smoke", "published"])
def test_active_param_count_matches_reference(arch, full):
    from repro.configs import get_arch as r_get_arch

    spec, r_spec = get_arch(arch), r_get_arch(arch)
    pc = spec.make_model_cfg() if full else spec.make_smoke_cfg()
    rc = r_spec.make_model_cfg() if full else r_spec.make_smoke_cfg()
    assert pc.active_param_count() == rc.active_param_count()
    assert pc.param_count() == rc.param_count()
    assert (pc.active_param_count() < pc.param_count()) == pc.is_moe
    if full and arch == "granite-moe-3b-a800m":
        assert pc.param_count() == 3_298_793_472
