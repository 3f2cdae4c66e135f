"""The port's training launcher (``repro_torch.launch.train``) and the
training losses it reaches that no other test file holds: BERT4Rec's two
loss branches and ``binned_embedding_grad``.

``main`` on the smoke config of one arch of each family for 3 steps
against the reference launcher's setup and step on the same seed: the
LM and recsys setups draw their parameters from another generator, so the
port's step runs on the reference's parameters carried across (and the
same token / cloze batches, which the port's generators give element for
element), loss at ``rtol = atol = 1e-4``; the GNN's step likewise.  The
two setups the reference cannot feed either (``dimenet``; ``bert4rec
--full-config``) raise a ``ValueError`` naming the missing fields.
"""
import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.configs import get_arch
from repro_torch.launch import train as launch
from repro_torch.models import bert4rec as B4
from repro_torch.train.trainer import _value_and_grad
from repro_torch.train.tree import tree_leaves

TOL = dict(rtol=1e-4, atol=1e-4)


def _ref_history(arch, steps=3, seed=0):
    """The reference launcher's setup and trainer, run for ``steps``."""
    from repro.configs import get_arch as r_get_arch
    from repro.launch import train as r_launch
    from repro.train.optim import adamw, cosine_schedule
    from repro.train.trainer import Trainer

    spec = r_get_arch(arch)
    cfg = spec.make_smoke_cfg()
    args = types.SimpleNamespace(seed=seed, batch=8, seq=128, grad_accum=1)
    setup = {"lm": r_launch._lm_setup, "gnn": r_launch._gnn_setup,
             "recsys": r_launch._recsys_setup}[spec.family]
    params, loss_fn, batches = setup(cfg, args)
    tree = jax.tree.map(np.array, params)  # the trainer donates params
    tr = Trainer(loss_fn=loss_fn,
                 optimizer=adamw(cosine_schedule(3e-4, 20, steps)))
    p, s = tr.init_state(params)
    _, _, hist = tr.run(p, s, batches, num_steps=steps, log_every=1,
                        log_fn=lambda *_: None)
    return tree, [h["loss"] for h in hist]


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "gat-cora", "bert4rec"])
def test_main_matches_the_reference_launcher(arch, monkeypatch):
    tree, ref_losses = _ref_history(arch)
    family = get_arch(arch).family
    # carry the reference's initial parameters into the port's setup (the
    # two packages draw them from different generators)
    if family == "lm":
        from repro_torch.models import transformer as tfm
        cfg = get_arch(arch).make_smoke_cfg()
        monkeypatch.setattr(
            tfm, "init_params",
            lambda c, g, device=None: tfm.params_from_numpy(tree, cfg,
                                                            device=device))
    elif family == "gnn":
        from repro_torch.models import gnn
        monkeypatch.setattr(
            gnn, "init_gnn",
            lambda g, c, device=None: gnn.params_from_numpy(tree, device))
    else:
        monkeypatch.setattr(
            B4, "init_bert4rec",
            lambda c, g, device=None: B4.params_from_numpy(tree, device))
    hist = launch.main(["--arch", arch, "--device", "cpu", "--steps", "3",
                        "--log-every", "1"])
    assert [h["step"] for h in hist] == [0, 1, 2]
    losses = [h["loss"] for h in hist]
    assert all(np.isfinite(losses))
    np.testing.assert_allclose(losses, ref_losses, **TOL)


def test_main_runs_without_the_reference_params(tmp_path):
    hist = launch.main(["--arch", "graphsage-reddit", "--device", "cpu",
                        "--steps", "3", "--ckpt-dir", str(tmp_path)])
    assert [h["step"] for h in hist] == [0, 2]
    again = launch.main(["--arch", "graphsage-reddit", "--device", "cpu",
                         "--steps", "4", "--ckpt-dir", str(tmp_path)])
    assert [h["step"] for h in again] == [3]  # resumed from step 3


def test_dimenet_is_refused_naming_its_missing_fields():
    with pytest.raises(ValueError, match="positions.*t_kj"):
        launch.main(["--arch", "dimenet", "--device", "cpu", "--steps", "1"])


def test_bert4rec_full_config_is_refused_naming_its_missing_fields():
    with pytest.raises(ValueError, match="mask_pos.*negatives"):
        launch.main(["--arch", "bert4rec", "--full-config", "--device", "cpu",
                     "--steps", "1"])


# --------------------------------------------------------------------- #
# BERT4Rec's training loss and its binned embedding gradient
# --------------------------------------------------------------------- #
def _b4_cfgs(**changes):
    from repro.configs import get_arch as r_get_arch

    rc = dataclasses.replace(r_get_arch("bert4rec").make_smoke_cfg(),
                             **changes)
    pc = dataclasses.replace(get_arch("bert4rec").make_smoke_cfg(), **changes)
    return rc, pc


def _b4_batch(cfg, sampled: bool, seed=0):
    rng = np.random.default_rng(seed)
    B, L, M, K = 4, cfg.max_len, 4, 32
    items = rng.integers(0, cfg.vocab, (B, L)).astype(np.int32)
    if not sampled:
        mask = rng.random((B, L)) < 0.2
        return {"items": np.where(mask, cfg.mask_id, items).astype(np.int32),
                "labels": items, "label_mask": mask.astype(np.float32)}
    neg = rng.integers(0, cfg.vocab, (K,)).astype(np.int32)
    pos_labels = rng.integers(0, cfg.vocab, (B, M)).astype(np.int32)
    pos_labels[0, 0] = neg[3]  # one accidental hit, excluded by the loss
    return {"items": items,
            "mask_pos": rng.integers(0, L, (B, M)).astype(np.int32),
            "pos_labels": pos_labels,
            "pos_weight": (rng.random((B, M)) < 0.8).astype(np.float32),
            "negatives": neg}


@pytest.mark.parametrize("sampled", [False, True])
def test_bert4rec_loss_and_grads_match_reference(sampled):
    from repro.models import bert4rec as r_b4

    changes = dict(vocab=60_000) if sampled else {}
    rc, pc = _b4_cfgs(**changes)
    assert pc.sampled_softmax == sampled
    rp = r_b4.init_bert4rec(rc, jax.random.PRNGKey(1))
    pp = B4.params_from_numpy(jax.tree.map(np.asarray, rp), device="cpu")
    batch = _b4_batch(pc, sampled)
    (rloss, _), rgrads = jax.value_and_grad(
        lambda p: r_b4.bert4rec_loss_fn(
            p, {k: jnp.asarray(v) for k, v in batch.items()}, rc),
        has_aux=True)(rp)
    ploss, metrics, pgrads = _value_and_grad(
        lambda p, b: B4.bert4rec_loss_fn(p, b, pc), pp,
        {k: torch.from_numpy(v) for k, v in batch.items()})
    torch.testing.assert_close(ploss, torch.tensor(float(rloss)), **TOL)
    assert metrics["ce"] == ploss
    for a, b in zip(tree_leaves(pgrads), jax.tree.leaves(rgrads)):
        torch.testing.assert_close(a, torch.from_numpy(np.array(b)), **TOL)


def test_binned_embedding_grad_matches_reference_and_flat_sum():
    from repro.models.bert4rec import binned_embedding_grad as r_binned

    rng = np.random.default_rng(2)
    ids = rng.integers(0, 500, (6, 40)).astype(np.int32)
    ids[0, :10] = 7  # a hot row
    g = rng.standard_normal((6, 40, 16)).astype(np.float32)
    got = B4.binned_embedding_grad(torch.from_numpy(ids), torch.from_numpy(g),
                                   table_size=502, num_bins=16)
    ref = np.array(r_binned(jnp.asarray(ids), jnp.asarray(g), 502,
                            num_bins=16))
    torch.testing.assert_close(got, torch.from_numpy(ref), rtol=1e-5,
                               atol=1e-5)
    flat = torch.zeros(502, 16).index_add_(
        0, torch.from_numpy(ids).reshape(-1).long(),
        torch.from_numpy(g).reshape(-1, 16))
    torch.testing.assert_close(got, flat, rtol=1e-5, atol=1e-5)
    again = B4.binned_embedding_grad(torch.from_numpy(ids),
                                     torch.from_numpy(g), 502, num_bins=16)
    assert torch.equal(got, again)


def test_torch_gnn_cora_example_runs(capsys):
    """``examples/torch_gnn_cora.py`` (the port of ``examples/gnn_cora.py``)
    trains GAT through the TOCAB slab engines on the CPU."""
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "examples" / \
        "torch_gnn_cora.py"
    spec = importlib.util.spec_from_file_location("torch_gnn_cora", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.main(["--device", "cpu"])
    out = capsys.readouterr().out
    last = [ln for ln in out.splitlines() if ln.startswith("step 100")]
    assert last and float(last[0].split("acc=")[1]) > 0.5
    assert float(out.split("max |Δ| = ")[1].split()[0]) < 1e-3
