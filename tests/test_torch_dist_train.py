"""Data-parallel training of the port on a ``torch.distributed`` mesh
(``repro_torch.train.trainer``, ``repro_torch.data.tokens``,
``repro_torch.launch.train``), on 2-rank gloo groups.

* ``synthetic_lm_batches(mesh=)``: the ranks' blocks, put together in rank
  order, equal the reference's batch element for element (with and
  without a microbatch axis).
* ``Trainer(mesh=)`` on a 2-layer TinyLlama-shaped config (fp32 compute),
  each rank on its half of the batch, against ``Trainer(mesh=None)`` on
  the whole batch (the single-device path that
  ``tests/test_torch_trainer.py`` holds against the reference), 3 steps,
  with and without gradient accumulation.  Tolerances: losses rtol 1e-5
  (a mean of two rank means against one mean over all tokens: fp32 sums
  in another order); parameters rtol 1e-5, atol 1e-6 under SGD with
  momentum (the update is linear in the gradient, so the parameters
  differ by lr times the gradients' summation-order difference, ~1e-7
  relative; under Adam a gradient of ~0 could flip the sign of a whole
  lr step).  The parameters are bit-equal across ranks.
* The masked loss: BERT4Rec's cloze loss, whose halves of a batch have
  different label counts, through the same comparison with the loss's
  denominator; the same with equal weights (a mean of the ranks' means)
  misses, so the weighing is what makes it right.
* A ``model`` axis > 1 raises ``NotImplementedError`` naming A12b; a mesh
  without ``denominator`` raises ``ValueError``; a mixture of experts has
  no denominator.
* ``launch.train.main`` on 2 gloo ranks with ``--device cpu`` trains
  (rank 0 logs) and returns the history, equal on both ranks and close to
  the single-process run's.
"""
import dataclasses
import itertools

import numpy as np
import pytest
import torch

from repro.data.tokens import synthetic_lm_batches as r_batches
from repro_torch.configs import get_arch
from repro_torch.data.recsys import synthetic_recsys_batches
from repro_torch.data.tokens import synthetic_lm_batches
from repro_torch.dist.sharding import local_block
from repro_torch.models import bert4rec as B4
from repro_torch.models import transformer as tfm
from repro_torch.train.optim import constant_schedule, sgd
from repro_torch.train.trainer import Trainer, make_train_step
from repro_torch.train.tree import tree_leaves
from test_torch_sharding import run_ranks

LOSS_RTOL = 1e-5
PARAM_TOL = dict(rtol=1e-5, atol=1e-6)
STEPS = 3


def _lm_cfg():
    return dataclasses.replace(get_arch("tinyllama-1.1b").make_smoke_cfg(),
                               compute_dtype="float32")


def _lm_params(cfg):
    return tfm.init_params(cfg, torch.Generator().manual_seed(3), "cpu")


def _b4_cfg():
    return get_arch("bert4rec").make_smoke_cfg()


def _b4_batches(mesh=None):
    cfg = _b4_cfg()
    for b in synthetic_recsys_batches(8, cfg.max_len, cfg.vocab, cfg.mask_id,
                                      seed=2, device="cpu"):
        yield b if mesh is None else {
            k: local_block(v, ("batch", None), mesh) for k, v in b.items()}


def _train(mesh, kind: str, grad_accum: int = 1, weighed: bool = True):
    """(history losses, final params as numpy) of 3 steps of ``kind``."""
    opt = sgd(constant_schedule(0.05), momentum=0.9)
    if kind == "lm":
        cfg = _lm_cfg()
        params = _lm_params(cfg)
        batches = synthetic_lm_batches(
            4, 16, cfg.vocab, seed=1, grad_accum=grad_accum if grad_accum > 1
            else 0, device="cpu", mesh=mesh)
        loss_fn = lambda p, b: tfm.loss_fn(p, b, cfg)  # noqa: E731
        den = lambda b: tfm.loss_denominator(b, cfg)  # noqa: E731
    else:
        cfg = _b4_cfg()
        params = B4.init_bert4rec(cfg, torch.Generator().manual_seed(4),
                                  device="cpu")
        batches = _b4_batches(mesh)
        loss_fn = lambda p, b: B4.bert4rec_loss_fn(p, b, cfg)  # noqa: E731
        den = lambda b: B4.loss_denominator(b, cfg)  # noqa: E731
        if not weighed:
            den = lambda b: torch.tensor(1.0)  # noqa: E731
    tr = Trainer(loss_fn=loss_fn, optimizer=opt, grad_accum=grad_accum,
                 mesh=mesh, denominator=den if mesh is not None else None)
    p, s = tr.init_state(params)
    p, _, hist = tr.run(p, s, batches, num_steps=STEPS, log_every=1,
                        log_fn=lambda *_: None)
    return [h["loss"] for h in hist], [x.numpy() for x in tree_leaves(p)]


def _train_worker(rank, world):
    import torch.distributed as dist

    from repro_torch.dist.elastic import make_mesh_for
    from repro_torch.launch import train as launch

    mesh = make_mesh_for()
    out = {"mesh": tuple(mesh.mesh.shape)}
    # the token stream's blocks
    for ga in (0, 2):
        it = synthetic_lm_batches(4, 9, 512, seed=5, grad_accum=ga,
                                  device="cpu", mesh=mesh)
        out[("tokens", ga)] = [b["tokens"].numpy()
                               for b in itertools.islice(it, 2)]
    for kind, ga, weighed in [("lm", 1, True), ("lm", 2, True),
                              ("b4", 1, True), ("b4", 1, False)]:
        out[(kind, ga, weighed)] = _train(mesh, kind, ga, weighed)
    out["denominators"] = [float(B4.loss_denominator(b, _b4_cfg()))
                           for b in itertools.islice(_b4_batches(mesh), 3)]
    # a model axis > 1
    mp = make_mesh_for(model_parallel=2)
    try:
        Trainer(loss_fn=None, optimizer=None, mesh=mp,
                denominator=lambda b: 1.0)
    except NotImplementedError as e:
        out["mp_error"] = str(e)
    out["main"] = launch.main(["--arch", "tinyllama-1.1b", "--device", "cpu",
                               "--steps", "3", "--batch", "4", "--seq", "16",
                               "--log-every", "1"])
    out["still_initialised"] = dist.is_initialized()
    return out


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return run_ranks(_train_worker, 2, tmp_path_factory.mktemp("train"))


@pytest.mark.parametrize("grad_accum", [0, 2])
def test_token_blocks_put_together_are_the_reference_batch(ranks,
                                                           grad_accum):
    ref = list(itertools.islice(r_batches(4, 9, 512, seed=5,
                                          grad_accum=grad_accum), 2))
    axis = 1 if grad_accum else 0
    for i, theirs in enumerate(ref):
        blocks = [r[("tokens", grad_accum)][i] for r in ranks]
        assert blocks[0].shape[axis] == 2
        assert np.array_equal(np.concatenate(blocks, axis), theirs["tokens"])


def _check_against_single(ranks, key, kind, grad_accum):
    losses, params = _train(None, kind, grad_accum)
    (l0, p0), (l1, p1) = ranks[0][key], ranks[1][key]
    assert l0 == l1
    assert all(np.array_equal(a, b) for a, b in zip(p0, p1))
    torch.testing.assert_close(torch.tensor(l0), torch.tensor(losses),
                               rtol=LOSS_RTOL, atol=0)
    for a, b in zip(p0, params):
        torch.testing.assert_close(torch.from_numpy(a), torch.from_numpy(b),
                                   **PARAM_TOL)
    return losses, params


@pytest.mark.parametrize("grad_accum", [1, 2])
def test_data_parallel_lm_matches_one_device(ranks, grad_accum):
    assert ranks[0]["mesh"] == (2, 1)
    _check_against_single(ranks, ("lm", grad_accum, True), "lm", grad_accum)


def test_masked_loss_weighs_the_ranks_by_its_denominator(ranks):
    d0, d1 = ranks[0]["denominators"], ranks[1]["denominators"]
    assert d0 != d1  # the halves hold different label counts
    losses, params = _check_against_single(ranks, ("b4", 1, True), "b4", 1)
    # a plain mean of the ranks' means trains to other parameters
    _, p_eq = ranks[0][("b4", 1, False)]
    excess = max(float(np.max(np.abs(a - b) / (PARAM_TOL["atol"] + PARAM_TOL[
        "rtol"] * np.abs(b)))) for a, b in zip(p_eq, params))
    assert excess > 10


def test_model_axis_is_refused_naming_a12b(ranks):
    assert "A12b" in ranks[0]["mp_error"]
    with pytest.raises(NotImplementedError, match="A12b"):
        make_train_step(lambda p, b: None, sgd(constant_schedule(0.1)),
                        mesh={"data": 2, "model": 2},
                        denominator=lambda b: 1.0)


def test_a_mesh_needs_the_denominator():
    class Mesh:
        shape = {"data": 2, "model": 1}

        def get_group(self, name):
            raise AssertionError("no group is reached")

    with pytest.raises(ValueError, match="denominator"):
        make_train_step(lambda p, b: None, sgd(constant_schedule(0.1)),
                        mesh=Mesh())


def test_moe_has_no_denominator():
    cfg = get_arch("granite-moe-3b-a800m").make_smoke_cfg()
    with pytest.raises(NotImplementedError, match="A12b"):
        tfm.loss_denominator({"tokens": torch.zeros(2, 5)}, cfg)
    dense = _lm_cfg()
    batch = {"tokens": torch.zeros(2, 5, dtype=torch.int32)}
    assert float(tfm.loss_denominator(batch, dense)) == 8.0
    batch["loss_mask"] = torch.tensor([[1, 1, 0, 1, 0], [0, 0, 0, 1, 1]])
    assert float(tfm.loss_denominator(batch, dense)) == 4.0


def test_launcher_trains_on_two_ranks(ranks):
    h0, h1 = ranks[0]["main"], ranks[1]["main"]
    assert [h["step"] for h in h0] == [0, 1, 2]
    assert [h["loss"] for h in h0] == [h["loss"] for h in h1]
    assert all(np.isfinite(h["loss"]) for h in h0)
    # main leaves alone a process group it did not create
    assert ranks[0]["still_initialised"] and ranks[1]["still_initialised"]
    from repro_torch.launch import train as launch

    one = launch.main(["--arch", "tinyllama-1.1b", "--device", "cpu",
                       "--steps", "3", "--batch", "4", "--seq", "16",
                       "--log-every", "1"])
    # bf16 compute on halves of the batch against the whole: close, not equal
    torch.testing.assert_close(torch.tensor([h["loss"] for h in h0]),
                               torch.tensor([h["loss"] for h in one]),
                               rtol=1e-2, atol=0)

