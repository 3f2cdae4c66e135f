"""Training on a mesh with a ``model`` axis, and data-parallel training
of a mixture of experts (``repro_torch.train.trainer``,
``repro_torch.models.moe``, ``repro_torch.launch.train``), on 2- and
4-rank gloo groups.

* ``Trainer(mesh=)`` on (1, 2) and (2, 2) meshes (parameters placed by
  ``param_logical_axes``, batches as DTensors) against
  ``Trainer(mesh=None)``: the smoke TinyLlama, fp32, SGD with momentum, 3
  steps, with and without gradient accumulation, at the data-parallel
  tolerances of ``tests/test_torch_dist_train.py`` (losses rtol 1e-5;
  parameters rtol 1e-5, atol 1e-6).
* Data-parallel smoke Granite (fp32) on 2 ranks, each on its block of the
  batch: one step's loss, aux loss and every gradient against the
  reference's ``jax.value_and_grad`` of ``loss_fn`` on the global batch
  under a 2-device Auto mesh (the same two-shard dispatch), at the LM
  parity tolerance (``rtol = atol = 1e-4``).  With the aux loss's two
  means taken per rank (``all_reduce_sum`` made the identity) the same
  comparison misses by more than 10× its tolerance.
* ``launch.train.main`` on 2 ranks with ``--arch granite-moe-3b-a800m``:
  the data-parallel mixture of experts trains, the ranks' losses equal.
* A checkpoint saved from (2, 2) DTensor leaves and restored onto one
  device is bit-equal to their full tensors.
"""
import dataclasses
import logging
import textwrap

import numpy as np
import pytest
import torch

from repro_torch.configs import get_arch
from repro_torch.data.tokens import synthetic_lm_batches
from repro_torch.models import transformer as tfm
from repro_torch.train.optim import Transform, constant_schedule, sgd
from repro_torch.train.trainer import Trainer, make_train_step
from repro_torch.train.tree import tree_leaves, tree_map
from test_torch_sharding import run_ranks, run_reference

LOSS_RTOL = 1e-5
PARAM_TOL = dict(rtol=1e-5, atol=1e-6)
REF_TOL = dict(rtol=1e-4, atol=1e-4)
STEPS = 3
MOE = "granite-moe-3b-a800m"


def _cfg(arch="tinyllama-1.1b"):
    return dataclasses.replace(get_arch(arch).make_smoke_cfg(),
                               compute_dtype="float32")


def _full(x):
    from torch.distributed.tensor import DTensor

    return x.full_tensor() if isinstance(x, DTensor) else x


def _train(mesh, grad_accum: int = 1):
    """(losses, final params as numpy) of 3 SGD steps of the smoke
    TinyLlama."""
    cfg = _cfg()
    params = tfm.init_params(cfg, torch.Generator().manual_seed(3), "cpu")
    batches = synthetic_lm_batches(
        4, 16, cfg.vocab, seed=1, grad_accum=grad_accum if grad_accum > 1
        else 0, device="cpu", mesh=mesh)
    tr = Trainer(loss_fn=lambda p, b: tfm.loss_fn(p, b, cfg),
                 optimizer=sgd(constant_schedule(0.05), momentum=0.9),
                 grad_accum=grad_accum, mesh=mesh,
                 param_axes=tfm.param_logical_axes(cfg))
    p, s = tr.init_state(params)
    p, _, hist = tr.run(p, s, batches, num_steps=STEPS, log_every=1,
                        log_fn=lambda *_: None)
    return [h["loss"] for h in hist], [_full(x).numpy()
                                       for x in tree_leaves(p)]


def _grads_step(mesh, params):
    """One data-parallel step of the smoke Granite on this rank's block:
    (loss, aux, gradients as numpy), the gradients caught on their way
    into the optimizer."""
    cfg = _cfg(MOE)
    caught = []

    def catch(grads, state, params):
        caught.append(grads)
        return tree_map(torch.zeros_like, grads), state

    step = make_train_step(lambda p, b: tfm.loss_fn(p, b, cfg),
                           Transform(lambda p: (), catch), mesh=mesh,
                           denominator=lambda b: tfm.loss_denominator(b,
                                                                      cfg))
    batch = next(synthetic_lm_batches(4, 16, cfg.vocab, seed=1,
                                      device="cpu", mesh=mesh))
    from repro_torch.dist.sharding import use_mesh_rules

    with use_mesh_rules(mesh):
        _, _, metrics = step(params, (), batch)
    return (float(metrics["loss"]), float(metrics["moe_aux"]),
            [g.numpy() for g in tree_leaves(caught[0])])


def _worker2(rank, world, ref_params):
    logging.disable(logging.WARNING)
    from repro_torch.dist.elastic import make_mesh_for
    from repro_torch.launch import train as launch
    from repro_torch.models import moe

    out = {}
    mp = make_mesh_for(model_parallel=2)
    for ga in (1, 2):
        out[("tp", (1, 2), ga)] = _train(mp, ga)
    dp = make_mesh_for()
    params = tfm.params_from_numpy(ref_params, _cfg(MOE), device="cpu")
    out["moe_dp"] = _grads_step(dp, params)
    real = moe.all_reduce_sum
    moe.all_reduce_sum = lambda x, mesh, axes: x  # each rank's own means
    try:
        out["moe_dp_per_rank_aux"] = _grads_step(dp, params)
    finally:
        moe.all_reduce_sum = real
    out["main"] = launch.main(["--arch", MOE, "--device", "cpu", "--steps",
                               "3", "--batch", "4", "--seq", "16",
                               "--log-every", "1"])
    return out


def _worker4(rank, world, ckpt_dir):
    logging.disable(logging.WARNING)
    from repro_torch.dist.sharding import place_tree
    from repro_torch.train import checkpoint as ckpt_lib
    from repro_torch.train.optim import adamw, cosine_schedule

    from torch.distributed.device_mesh import DeviceMesh

    out = {}
    mesh = DeviceMesh("cpu", torch.arange(4).reshape(2, 2),
                      mesh_dim_names=("data", "model"))
    for ga in (1, 2):
        out[("tp", (2, 2), ga)] = _train(mesh, ga)
    # a checkpoint of DTensor leaves (params and AdamW state)
    cfg = _cfg()
    params = place_tree(tfm.init_params(cfg, torch.Generator().manual_seed(7),
                                        "cpu"),
                        tfm.param_logical_axes(cfg), mesh)
    opt = adamw(cosine_schedule(1e-3, 2, 10))
    state = (params, opt.init(params))
    ckpt_lib.save(ckpt_dir, 5, state)
    out["saved"] = [_full(x).numpy() for x in tree_leaves(state)]
    return out


_REFERENCE = textwrap.dedent("""
    import dataclasses, json
    import jax, numpy as np
    from jax.sharding import Mesh
    from repro.configs import get_arch
    from repro.data.tokens import synthetic_lm_batches
    from repro.dist.sharding import use_mesh_rules
    from repro.models import transformer as T
    cfg = dataclasses.replace(get_arch(%r).make_smoke_cfg(),
                              compute_dtype="float32")
    params = T.init_params(cfg, jax.random.PRNGKey(0))
    batch = next(synthetic_lm_batches(4, 16, cfg.vocab, seed=1))
    mesh = Mesh(np.array(jax.devices()[:2]).reshape(2, 1), ("data", "model"))
    fn = jax.jit(jax.value_and_grad(lambda p, b: T.loss_fn(p, b, cfg),
                                    has_aux=True))
    with mesh, use_mesh_rules(mesh):
        (loss, metrics), grads = fn(params, batch)
    print(json.dumps({
        "params": jax.tree.map(lambda a: np.asarray(a).tolist(), params),
        "loss": float(loss), "aux": float(metrics["moe_aux"]),
        "grads": jax.tree.map(lambda a: np.asarray(a).tolist(), grads)}))
""")


@pytest.fixture(scope="module")
def reference():
    return run_reference(_REFERENCE % MOE, 2)


@pytest.fixture(scope="module")
def ranks2(reference, tmp_path_factory):
    params = tree_map_np(reference["params"])
    return run_ranks(_worker2, 2, tmp_path_factory.mktemp("tp_train2"),
                     params)


def tree_map_np(tree):
    if isinstance(tree, dict):
        return {k: tree_map_np(v) for k, v in tree.items()}
    return np.asarray(tree, np.float32)


@pytest.fixture(scope="module")
def ckpt_dir(tmp_path_factory):
    return str(tmp_path_factory.mktemp("ckpt") / "run")


@pytest.fixture(scope="module")
def ranks4(ckpt_dir, tmp_path_factory):
    return run_ranks(_worker4, 4, tmp_path_factory.mktemp("tp_train4"),
                     ckpt_dir)


@pytest.mark.parametrize("grad_accum", [1, 2])
@pytest.mark.parametrize("shape", [(1, 2), (2, 2)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_trainer_on_a_model_axis_matches_one_device(ranks2, ranks4, shape,
                                                    grad_accum):
    got = ranks2 if shape == (1, 2) else ranks4
    losses, params = _train(None, grad_accum)
    first = got[0][("tp", shape, grad_accum)]
    for r in got:
        l_r, p_r = r[("tp", shape, grad_accum)]
        assert l_r == first[0]  # every rank logs the global batch's loss
        assert all(np.array_equal(a, b) for a, b in zip(p_r, first[1]))
    torch.testing.assert_close(torch.tensor(first[0]), torch.tensor(losses),
                               rtol=LOSS_RTOL, atol=0)
    for a, b in zip(first[1], params):
        torch.testing.assert_close(torch.from_numpy(a), torch.from_numpy(b),
                                   **PARAM_TOL)


def _excess(got, reference) -> float:
    """The largest miss of (loss, aux, gradients) over ``REF_TOL`` (≤ 1
    passes); the reference's gradient tree (layers stacked) laid out as
    the port's."""
    loss, aux, grads = got
    want = [x.numpy() for x in tree_leaves(tfm.params_from_numpy(
        tree_map_np(reference["grads"]), _cfg(MOE), device="cpu"))]
    pairs = [(np.float32(loss), np.float32(reference["loss"])),
             (np.float32(aux), np.float32(reference["aux"]))]
    pairs += list(zip(grads, want))
    assert len(grads) == len(want)
    return max(float(np.max(np.abs(a - b) / (REF_TOL["atol"] + REF_TOL[
        "rtol"] * np.abs(b)))) for a, b in pairs)


def test_data_parallel_moe_is_the_reference_global_batch(ranks2, reference):
    for r in ranks2:
        assert r["moe_dp"][:2] == ranks2[0]["moe_dp"][:2]
        assert _excess(r["moe_dp"], reference) <= 1.0


def test_per_rank_aux_means_miss_the_reference(ranks2, reference):
    """The mutation: each rank's aux loss from its own tokens' means."""
    assert _excess(ranks2[0]["moe_dp_per_rank_aux"], reference) > 10.0


def test_launcher_trains_a_mixture_of_experts_on_two_ranks(ranks2):
    h0, h1 = ranks2[0]["main"], ranks2[1]["main"]
    assert [h["step"] for h in h0] == [0, 1, 2]
    assert [h["loss"] for h in h0] == [h["loss"] for h in h1]
    assert all(np.isfinite(h["loss"]) and h["moe_aux"] > 0 for h in h0)


def test_checkpoint_from_dtensor_leaves_restores_on_one_device(ranks4,
                                                               ckpt_dir):
    from repro_torch.train import checkpoint as ckpt_lib
    from repro_torch.train.optim import adamw, cosine_schedule

    cfg = _cfg()
    params = tfm.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    target = (params, adamw(cosine_schedule(1e-3, 2, 10)).init(params))
    restored, step, _ = ckpt_lib.restore(ckpt_dir, target)
    assert step == 5
    got = [x.numpy() for x in tree_leaves(restored)]
    saved = ranks4[0]["saved"]
    assert len(got) == len(saved)
    for r in ranks4[1:]:
        assert all(np.array_equal(a, b) for a, b in zip(r["saved"], saved))
    for a, b in zip(got, saved):
        assert a.dtype == b.dtype and np.array_equal(a, b)
