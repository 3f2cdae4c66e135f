"""Port parity of the BERT4Rec serving slice: the cloze data
(``repro_torch.data.recsys``), the model's encoder, scoring and retrieval
(``repro_torch.models.bert4rec``), its config and the recsys serving loop
(``repro_torch.launch.serve``), against the reference package.

Both packages run on the same parameters (the reference's
``init_bert4rec`` tree carried across by ``params_from_numpy``) and the
same numpy inputs, on the CPU.  Tolerances:

* the fp32 encoder and retrieval at ``rtol = atol = 1e-4`` (fp32 sums in
  another order; the readings are ~3e-6);
* the bf16 paths at a looser, stated tolerance: XLA and torch round bf16
  at different points, so the hidden states differ by a few bf16 ulps and
  the scores by one or two;
* top-k ids by a tie-aware check: scores are rounded to bf16 before the
  top-k, so ties are common, and neither ``jax.lax.top_k`` nor
  ``torch.topk`` promises an order among them.  Every id returned must have
  a reference score at least the k-th reference score minus the tolerance.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import RECSYS_SHAPES, get_arch
from repro_torch.data.recsys import make_cloze_batch, synthetic_recsys_batches
from repro_torch.launch import serve as serve_mod
from repro_torch.models import bert4rec as B4

TOL = dict(rtol=1e-4, atol=1e-4)
#: bf16 hidden states, port vs reference: 2⁻⁴ is four bf16 ulps at |h| in
#: [1, 2), the bulk of a LayerNorm output; the readings are up to ~0.05
BF16_HIDDEN_TOL = dict(rtol=2.0 ** -4, atol=2.0 ** -4)
#: bf16 scores, as a share of the batch's largest |reference score|: 2⁻⁵
#: is four to eight bf16 ulps of it; the readings are one or two
SCORE_TOL_OF_MAX = 2.0 ** -5


def _cfgs(**changes):
    """(reference cfg, port cfg) of bert4rec's smoke config."""
    from repro.configs import get_arch as r_get_arch

    rc = dataclasses.replace(r_get_arch("bert4rec").make_smoke_cfg(),
                             **changes)
    pc = dataclasses.replace(get_arch("bert4rec").make_smoke_cfg(), **changes)
    assert dataclasses.asdict(rc) == dataclasses.asdict(pc)
    return rc, pc


def _params(rc, seed=0):
    """(reference params, port params on the CPU) with equal values."""
    import jax
    from repro.models import bert4rec as r_b4

    rp = r_b4.init_bert4rec(rc, jax.random.PRNGKey(seed))
    return rp, B4.params_from_numpy(jax.tree.map(np.asarray, rp),
                                    device="cpu")


def _items(cfg, batch, seed, pad_rows=3):
    """Cloze users from the reference's generator, the first ``pad_rows``
    left-padded with ``pad_id``."""
    from repro.data.recsys import make_cloze_batch as r_make

    b = r_make(np.random.default_rng(seed), batch, cfg.max_len, cfg.vocab,
               cfg.mask_id)
    items = np.array(b["items"])
    items[:pad_rows, :5] = cfg.pad_id
    return items


def _tie_aware(ids, ref_scores, k, tol):
    """Every row of ``ids`` (B, k) holds k distinct ids whose reference
    scores are at least the row's k-th reference score minus ``tol``."""
    ids, ref_scores = np.asarray(ids), np.asarray(ref_scores)
    assert ids.shape == (ref_scores.shape[0], k)
    assert all(len(set(row)) == k for row in ids.tolist())
    kth = np.sort(ref_scores, axis=1)[:, -k]
    got = np.take_along_axis(ref_scores, ids.astype(np.int64), axis=1)
    assert (got >= kth[:, None] - tol).all(), (got - kth[:, None]).min()


# --------------------------------------------------------------------- #
# data
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("batch,seq_len,vocab,mask_prob,step_range", [
    (8, 32, 1000, 0.15, 50), (5, 200, 1_000_000, 0.3, 7)])
def test_make_cloze_batch_matches_reference(batch, seq_len, vocab, mask_prob,
                                            step_range):
    from repro.data.recsys import make_cloze_batch as r_make

    ref = r_make(np.random.default_rng(11), batch, seq_len, vocab, vocab,
                 mask_prob, step_range)
    out = make_cloze_batch(np.random.default_rng(11), batch, seq_len, vocab,
                           vocab, mask_prob, step_range, device="cpu")
    assert out.keys() == ref.keys()
    for key in ref:
        want = np.asarray(ref[key])
        assert out[key].dtype == {"int32": torch.int32,
                                  "float32": torch.float32}[str(want.dtype)]
        np.testing.assert_array_equal(out[key].numpy(), want)


def test_synthetic_recsys_batches_match_reference():
    from repro.data.recsys import synthetic_recsys_batches as r_batches

    ref = r_batches(4, 16, 200, 200, seed=3)
    out = synthetic_recsys_batches(4, 16, 200, 200, seed=3, device="cpu")
    for _ in range(3):
        r, o = next(ref), next(out)
        for key in r:
            np.testing.assert_array_equal(o[key].numpy(), np.asarray(r[key]))


# --------------------------------------------------------------------- #
# config and parameters
# --------------------------------------------------------------------- #
def test_get_arch_bert4rec_matches_reference():
    from repro.configs import get_arch as r_get_arch

    spec, ref = get_arch("bert4rec"), r_get_arch("bert4rec")
    assert (spec.family, spec.source) == (ref.family, ref.source)
    for make in ("make_model_cfg", "make_smoke_cfg"):
        assert dataclasses.asdict(getattr(spec, make)()) == \
            dataclasses.asdict(getattr(ref, make)())
    # the port's cells carry the reference's LM and recsys fields (no GNN)
    assert [dataclasses.asdict(c) for c in spec.shapes] == \
        [{f: getattr(c, f) for f in dataclasses.asdict(p)}
         for c, p in zip(ref.shapes, spec.shapes, strict=True)]
    assert spec.shapes == RECSYS_SHAPES
    full = spec.make_model_cfg()
    assert (full.vocab, full.table_size, full.d_model) == (10 ** 6,
                                                            10 ** 6 + 2, 64)
    assert full.param_count() == 64_111_872


def test_params_from_numpy_and_init_shapes():
    rc, pc = _cfgs()
    rp, pp = _params(rc)
    for key in ("item_emb", "pos_emb", "ln_out", "b_ln_out"):
        np.testing.assert_array_equal(pp[key].numpy(), np.asarray(rp[key]))
    for rb, pb in zip(rp["blocks"], pp["blocks"], strict=True):
        assert rb.keys() == pb.keys()
        for key in rb:
            np.testing.assert_array_equal(pb[key].numpy(),
                                          np.asarray(rb[key]))
    assert B4.param_count(pp) == pc.param_count()
    init = B4.init_bert4rec(pc, torch.Generator().manual_seed(0), "cpu")
    assert B4.param_count(init) == pc.param_count()
    for key in ("item_emb", "pos_emb"):
        assert init[key].shape == pp[key].shape
        assert abs(float(init[key].std()) - 0.02) < 0.002
    w1 = init["blocks"][0]["w1"]
    assert w1.shape == (pc.d_model, pc.d_ff_mult * pc.d_model)
    assert abs(float(w1.std()) - pc.d_model ** -0.5) < 0.02
    assert bool((init["blocks"][1]["ln2"] == 1).all())
    cast = B4.cast_params(pp, torch.bfloat16)
    assert cast["blocks"][0]["ln1"].dtype == torch.bfloat16
    assert B4.cast_params(cast, torch.bfloat16)["item_emb"] is \
        cast["item_emb"]


# --------------------------------------------------------------------- #
# model
# --------------------------------------------------------------------- #
def test_encode_fp32_matches_reference():
    import jax.numpy as jnp
    from repro.models import bert4rec as r_b4

    rc, pc = _cfgs()
    rp, pp = _params(rc)
    items = _items(rc, 16, seed=3)
    ref = r_b4.bert4rec_encode(rp, jnp.asarray(items), rc)
    out = B4.bert4rec_encode(pp, torch.from_numpy(items), pc)
    assert out.dtype == torch.float32 and out.shape == (16, rc.max_len,
                                                         rc.d_model)
    torch.testing.assert_close(out, torch.from_numpy(np.array(ref)), **TOL)


def test_encode_bf16_stays_bf16():
    """The serving path's hidden state is bf16 from end to end in both
    packages (the reference's mask bias is weakly typed)."""
    import jax.numpy as jnp
    from repro.models import bert4rec as r_b4

    rc, pc = _cfgs()
    rp, pp = _params(rc)
    items = _items(rc, 8, seed=4)
    ref = r_b4.bert4rec_encode(rp, jnp.asarray(items), rc, dtype=jnp.bfloat16)
    out = B4.bert4rec_encode(pp, torch.from_numpy(items), pc,
                             dtype=torch.bfloat16)
    assert ref.dtype == jnp.bfloat16 and out.dtype == torch.bfloat16
    torch.testing.assert_close(
        out.float(), torch.from_numpy(np.array(ref.astype(jnp.float32))),
        **BF16_HIDDEN_TOL)


@pytest.mark.parametrize("top_k", [1, 10])
def test_score_matches_reference(top_k):
    import jax.numpy as jnp
    from repro.models import bert4rec as r_b4

    rc, pc = _cfgs()
    rp, pp = _params(rc)
    items = _items(rc, 16, seed=5)
    vals, ids = B4.bert4rec_score(pp, torch.from_numpy(items), pc,
                                  top_k=top_k)
    r_vals, _ = r_b4.bert4rec_score(rp, jnp.asarray(items), rc, top_k=top_k)
    # the reference's full bf16 score matrix, as bert4rec_score builds it
    user = r_b4.bert4rec_encode(rp, jnp.asarray(items), rc,
                                dtype=jnp.bfloat16)[:, -1, :]
    scores = np.asarray(jnp.einsum(
        "bd,vd->bv", user,
        rp["item_emb"][: rc.vocab].astype(jnp.bfloat16)).astype(jnp.float32))
    tol = SCORE_TOL_OF_MAX * float(np.abs(scores).max())
    assert vals.dtype == torch.float32 and ids.dtype == torch.int64
    np.testing.assert_allclose(vals.numpy(), np.asarray(r_vals), rtol=0,
                               atol=tol)
    assert bool((ids >= 0).all()) and bool((ids < rc.vocab).all())
    _tie_aware(ids, scores, top_k, tol)


def test_retrieve_matches_reference():
    import jax.numpy as jnp
    from repro.models import bert4rec as r_b4

    rc, pc = _cfgs()
    rp, pp = _params(rc)
    items = _items(rc, 1, seed=6, pad_rows=1)
    cands = np.random.default_rng(6).permutation(rc.vocab)[:300].astype(
        np.int32)
    vals, ids = B4.bert4rec_retrieve(pp, torch.from_numpy(items),
                                     torch.from_numpy(cands), pc, top_k=7)
    r_vals, _ = r_b4.bert4rec_retrieve(rp, jnp.asarray(items),
                                       jnp.asarray(cands), rc, top_k=7)
    np.testing.assert_allclose(vals.numpy(), np.asarray(r_vals), **TOL)
    h = np.asarray(r_b4.bert4rec_encode(rp, jnp.asarray(items), rc))
    ref_scores = np.full((1, rc.vocab), -np.inf, np.float32)
    ref_scores[0, cands] = np.asarray(rp["item_emb"])[cands] @ h[0, -1]
    _tie_aware(ids[None], ref_scores, 7, TOL["atol"])
    assert set(ids.tolist()) <= set(cands.tolist())


# --------------------------------------------------------------------- #
# serving
# --------------------------------------------------------------------- #
def test_serve_recsys_cli_records_metrics():
    from repro_torch.obs import trace
    from repro_torch.obs.metrics import registry

    trace.clear()
    with trace.enable():  # spans record only when tracing is on
        res = serve_mod.main(["--arch", "bert4rec", "--device", "cpu",
                              "--requests", "4"])
    assert res.scores.shape == (4, 10) and res.ids.shape == (4, 10)
    assert bool((res.ids < 5000).all()) and len(res.rep_seconds) == 20
    assert res.users_per_s > 0
    names = registry.names()
    for metric in ("serve.score_seconds", "serve.users_per_s"):
        assert metric in names
    assert registry.histogram("serve.score_seconds").stats()["count"] >= 20
    assert "serve.score" in {e["name"] for e in trace.events()}


def test_score_loop_returns_bert4rec_score():
    rc, pc = _cfgs(vocab=500)
    _, pp = _params(rc)
    items = torch.from_numpy(_items(rc, 3, seed=7))
    res = serve_mod.score_loop(pp, items, pc, top_k=5, reps=2)
    vals, ids = B4.bert4rec_score(pp, items, pc, top_k=5)
    assert torch.equal(res.scores, vals) and torch.equal(res.ids, ids)
    with pytest.raises(ValueError, match="rep"):
        serve_mod.score_loop(pp, items, pc, reps=0)
