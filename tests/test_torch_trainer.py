"""The port's train step and loop (``repro_torch.train.trainer``):
gradient accumulation against the big batch, the straggler watchdog, an
exact (bit-equal) resume from a checkpoint on the CPU, and
``make_train_step`` on the smoke TinyLlama and the smoke Granite-MoE
(fp32 compute) against the reference's step on the same (carried-across)
parameters and batch: loss, every gradient leaf and the updated
parameters at ``rtol = atol = 1e-4`` (the LM parity tolerance of
tests/test_torch_transformer.py: fp32 sums in another order)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.configs import get_arch
from repro_torch.models import transformer as tfm
from repro_torch.obs.metrics import registry
from repro_torch.train import optim
from repro_torch.train.optim import adamw, constant_schedule, sgd
from repro_torch.train.trainer import (StragglerWatchdog, Trainer,
                                       _batch_tokens, _value_and_grad,
                                       make_train_step)
from repro_torch.train.tree import tree_leaves, tree_map

TOL = dict(rtol=1e-4, atol=1e-4)


def _linreg(params, batch):
    pred = batch["x"] @ params["w"] + params["b"]
    loss = ((pred - batch["y"]) ** 2).mean()
    return loss, {"mse": loss}


def _linreg_batch(seed, lead=()):
    rng = np.random.default_rng(seed)
    return {"x": torch.from_numpy(rng.standard_normal(lead + (16, 4)).astype(
                np.float32)),
            "y": torch.from_numpy(rng.standard_normal(lead + (16, 2)).astype(
                np.float32))}


def test_grad_accum_equals_big_batch():
    params = {"w": torch.ones(4, 2) * 0.1, "b": torch.zeros(2)}
    opt = sgd(constant_schedule(0.1), momentum=0.0)
    micro = _linreg_batch(0, lead=(4,))
    big = {k: v.reshape((-1,) + v.shape[2:]) for k, v in micro.items()}
    p1, _, m1 = make_train_step(_linreg, opt)(params, opt.init(params), big)
    p4, _, m4 = make_train_step(_linreg, opt, grad_accum=4)(
        params, opt.init(params), micro)
    for a, b in zip(tree_leaves(p1), tree_leaves(p4)):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(m1["loss"], m4["loss"], rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(m1["mse"], m4["mse"], rtol=1e-5, atol=1e-6)


def test_compress_grads_rounds_through_bf16():
    params = {"w": torch.ones(4, 2) * 0.1, "b": torch.zeros(2)}
    opt = sgd(constant_schedule(1.0), momentum=0.0)
    batch = _linreg_batch(1)
    _, _, grads = _value_and_grad(_linreg, params, batch)
    p, _, _ = make_train_step(_linreg, opt, compress_grads=True)(
        params, opt.init(params), batch)
    want = params["w"] - grads["w"].to(torch.bfloat16).float()
    torch.testing.assert_close(p["w"], want, rtol=0, atol=0)


def test_unused_parameter_gets_a_zero_gradient():
    params = {"w": torch.ones(4, 2), "b": torch.zeros(2),
              "unused": torch.ones(3)}
    _, _, grads = _value_and_grad(_linreg, params, _linreg_batch(2))
    assert torch.equal(grads["unused"], torch.zeros(3))
    assert not params["w"].requires_grad


def test_straggler_watchdog_flags_outlier():
    w = StragglerWatchdog(threshold_sigma=3.0, warmup=3)
    before = registry.counter("train.straggler_events").value()
    flags = [w.observe(i, 0.1) for i in range(10)]
    assert not any(flags)
    assert w.observe(10, 1.0)
    assert w.flagged == [(10, 1.0)]
    assert registry.counter("train.straggler_events").value() == before + 1


def test_batch_tokens_counts_the_largest_integer_leaf():
    batch = {"tokens": torch.zeros(2, 9, dtype=torch.int32),
             "mask": torch.ones(2, 9, dtype=torch.bool),
             "x": torch.zeros(100)}
    assert _batch_tokens(batch) == 18
    assert _batch_tokens({"x": torch.zeros(3)}) == 0


def test_mesh_is_refused():
    """A mesh without process groups is refused, whatever its ``model``
    axis: a ``DeviceMesh`` that shards the model trains
    (tests/test_torch_tp_train.py), and so does a data-parallel one
    (tests/test_torch_dist_train.py)."""
    for sizes in ({"data": 2, "model": 2}, {"data": 1, "model": 2}):
        with pytest.raises(TypeError, match="DeviceMesh"):
            Trainer(loss_fn=_linreg, optimizer=sgd(constant_schedule(0.1)),
                    mesh=sizes, denominator=lambda b: 1.0)
    with pytest.raises(TypeError, match="mesh"):
        Trainer(loss_fn=_linreg, optimizer=sgd(constant_schedule(0.1)),
                mesh=object())


def test_preemption_restart_exact_resume(tmp_path):
    """Kill-and-resume continues bit-exact from the checkpoint: 10 steps,
    a fresh trainer restored from LATEST and 2 more, against 12 in one
    run; the trainer records its metrics and checkpoint span."""
    def loss_fn(params, batch):
        return (params["w"] ** 2).sum() * batch["s"], {}

    params = {"w": torch.ones(3)}
    opt = adamw(constant_schedule(0.01))

    def batches(start=0):
        i = start
        while True:
            yield {"s": torch.tensor(1.0 + (i % 3))}
            i += 1

    d = str(tmp_path)
    steps_before = registry.counter("train.checkpoints").value()
    tr = Trainer(loss_fn=loss_fn, optimizer=opt, ckpt_dir=d, ckpt_every=5)
    p, s = tr.init_state(params)
    p1, s1, _ = tr.run(p, s, batches(), num_steps=10, log_every=100,
                       log_fn=lambda *_: None)
    assert registry.counter("train.checkpoints").value() == steps_before + 2
    tr2 = Trainer(loss_fn=loss_fn, optimizer=opt, ckpt_dir=d, ckpt_every=5)
    p2, s2, step = tr2.maybe_restore(p, s)
    assert step == 10
    p3, s3, _ = tr2.run(p2, s2, batches(step), start_step=step, num_steps=12,
                        log_every=100, log_fn=lambda *_: None)
    p4, s4, _ = tr.run(p1, s1, batches(10), start_step=10, num_steps=12,
                       log_every=100, log_fn=lambda *_: None)
    assert torch.equal(p3["w"], p4["w"])
    for a, b in zip(tree_leaves(s3), tree_leaves(s4)):
        assert torch.equal(a, b)
    assert registry.histogram("train.step_seconds").stats()["count"] >= 14


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "granite-moe-3b-a800m"])
def test_train_step_matches_reference(arch):
    from repro.configs import get_arch as r_get_arch
    from repro.models import transformer as r_tfm
    from repro.train import optim as r_optim
    from repro.train.trainer import make_train_step as r_make_train_step

    rc = dataclasses.replace(r_get_arch(arch).make_smoke_cfg(),
                             compute_dtype="float32")
    pc = dataclasses.replace(get_arch(arch).make_smoke_cfg(),
                             compute_dtype="float32")
    rp = r_tfm.init_params(rc, jax.random.PRNGKey(0))
    tree = jax.tree.map(np.asarray, rp)
    pp = tfm.params_from_numpy(tree, pc, device="cpu")
    toks = np.random.default_rng(3).integers(0, pc.vocab, (2, 17)).astype(
        np.int32)

    # loss and every gradient leaf
    (rloss, _), rgrads = jax.value_and_grad(
        lambda p: r_tfm.loss_fn(p, {"tokens": jnp.asarray(toks)}, rc),
        has_aux=True)(rp)
    ploss, pmetrics, pgrads = _value_and_grad(
        lambda p, b: tfm.loss_fn(p, b, pc), pp,
        {"tokens": torch.from_numpy(toks)})
    torch.testing.assert_close(ploss, torch.tensor(float(rloss)), **TOL)
    rg = tfm.params_from_numpy(jax.tree.map(np.asarray, rgrads), pc,
                               device="cpu")
    assert len(tree_leaves(pgrads)) == len(tree_leaves(rg))
    for a, b in zip(tree_leaves(pgrads), tree_leaves(rg)):
        torch.testing.assert_close(a, b, **TOL)
    if pc.is_moe:
        assert float(pmetrics["moe_aux"]) > 0

    # one step of SGD (momentum 0.9) and one of AdamW: loss, grad norm and
    # every updated parameter.  AdamW's first update is g / (|g| + eps): at
    # |g| near eps (1e-8) it turns a 1e-9 difference of fp32 summation order
    # into a visible one, so there the parameters are held where the
    # reference's |g| > 1e-6 (g / (|g| + eps) within 1 % of sign(g)), and
    # elsewhere to twice the step's size, 2·lr.
    batch_r, batch_p = {"tokens": jnp.asarray(toks)}, \
        {"tokens": torch.from_numpy(toks)}
    for make in (lambda m: m.sgd(m.constant_schedule(1e-2)),
                 lambda m: m.adamw(m.cosine_schedule(1e-2, 0, 10))):
        ropt, popt = make(r_optim), make(optim)
        rstep = r_make_train_step(lambda p, b: r_tfm.loss_fn(p, b, rc), ropt)
        pstep = make_train_step(lambda p, b: tfm.loss_fn(p, b, pc), popt)
        rnew, _, rm = rstep(rp, ropt.init(rp), batch_r)
        pnew, _, pm = pstep(pp, popt.init(pp), batch_p)
        torch.testing.assert_close(pm["loss"],
                                   torch.tensor(float(rm["loss"])), **TOL)
        torch.testing.assert_close(pm["grad_norm"],
                                   torch.tensor(float(rm["grad_norm"])),
                                   **TOL)
        rn = tfm.params_from_numpy(jax.tree.map(np.asarray, rnew), pc,
                                   device="cpu")
        adam = len(tree_leaves(ropt.init(rp))) > 2
        moved = 0
        for a, b, old, g in zip(tree_leaves(pnew), tree_leaves(rn),
                                tree_leaves(pp), tree_leaves(rg)):
            keep = g.abs() > 1e-6 if adam else torch.ones_like(g, dtype=bool)
            torch.testing.assert_close(a[keep], b[keep], **TOL)
            assert float((a - b).abs().max()) <= 2e-2
            moved += int(not torch.equal(a, old))
        assert moved == len(tree_leaves(pp))  # every leaf took a step
        assert tree_map(lambda x: x.dtype, pnew) == \
            tree_map(lambda x: x.dtype, pp)
