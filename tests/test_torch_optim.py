"""The port's optimizers (``repro_torch.train.optim``) against the
reference's (``repro.train.optim``): the same numpy tree and gradient
stream through both for 20 steps, held at ``rtol=1e-5, atol=1e-6`` (fp32
elementwise arithmetic in the same order; only reductions — the global
norm, Adafactor's means — sum in another order).  Plus clipping, the three
schedules and the quadratic the reference's own test minimizes."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.train import optim as R
from repro_torch.train import optim as T
from repro_torch.train.tree import tree_leaves, tree_map

TOL = dict(rtol=1e-5, atol=1e-6)


def _tree(seed):
    rng = np.random.default_rng(seed)
    return {"w": rng.standard_normal((6, 5)).astype(np.float32),
            "stack": rng.standard_normal((2, 3, 4)).astype(np.float32),
            "b": rng.standard_normal(5).astype(np.float32),
            "layers": [{"g": rng.standard_normal(4).astype(np.float32)},
                       {"g": rng.standard_normal(4).astype(np.float32)}]}


def _grads(step, scale=1.0):
    return tree_map(lambda a: a * scale, _tree(1000 + step))


def _jax(tree):
    return jax.tree.map(jnp.asarray, tree)


def _torch(tree):
    return tree_map(lambda a: torch.from_numpy(np.array(a)), tree)


def _assert_trees_close(port, ref, **tol):
    a, b = tree_leaves(port), jax.tree.leaves(ref)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        torch.testing.assert_close(x, torch.from_numpy(np.array(y)),
                                   **(tol or TOL))


OPTIMIZERS = {
    "adamw": lambda m: m.adamw(m.cosine_schedule(0.05, 5, 20)),
    "adamw_noclip_wd": lambda m: m.adamw(m.linear_warmup(0.02, 4),
                                         weight_decay=0.1, max_grad_norm=None),
    "sgd": lambda m: m.sgd(m.constant_schedule(0.03), momentum=0.9),
    "adafactor": lambda m: m.adafactor(m.cosine_schedule(0.1, 3, 20)),
    "adafactor_vectors": lambda m: m.adafactor(m.constant_schedule(0.05),
                                               decay=0.6, clip_threshold=0.5),
}


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_optimizer_matches_reference_for_20_steps(name):
    ropt, topt = OPTIMIZERS[name](R), OPTIMIZERS[name](T)
    params = _tree(0)
    if name == "adafactor_vectors":  # every leaf unfactored
        params = {k: v for k, v in params.items() if k in ("b", "layers")}
    rp, tp = _jax(params), _torch(params)
    rs, ts = ropt.init(rp), topt.init(tp)
    _assert_trees_close(ts, rs)
    for step in range(20):
        g = _grads(step, scale=3.0 if step % 4 == 0 else 0.5)
        g = {k: g[k] for k in params}
        ru, rs = ropt.update(_jax(g), rs, rp)
        tu, ts = topt.update(_torch(g), ts, tp)
        _assert_trees_close(tu, ru)
        rp, tp = R.apply_updates(rp, ru), T.apply_updates(tp, tu)
        _assert_trees_close(tp, rp)
    _assert_trees_close(ts, rs)
    assert all(x.dtype in (torch.float32, torch.int32)
               for x in tree_leaves(ts))


def test_clip_and_global_norm_match_reference():
    g = _grads(0, scale=10.0)
    norm_r = R.global_norm(_jax(g))
    norm_t = T.global_norm(_torch(g))
    torch.testing.assert_close(norm_t, torch.tensor(float(norm_r)), **TOL)
    for max_norm in (1.0, 1e6):
        clip_r, clip_t = R.clip_by_global_norm(max_norm), \
            T.clip_by_global_norm(max_norm)
        ru, _ = clip_r.update(_jax(g), clip_r.init(None), None)
        tu, _ = clip_t.update(_torch(g), clip_t.init(None), None)
        _assert_trees_close(tu, ru)
    assert float(T.global_norm(tu)) == pytest.approx(float(norm_r), rel=1e-6)


@pytest.mark.parametrize("make", [
    lambda m: m.cosine_schedule(1.0, 10, 100),
    lambda m: m.cosine_schedule(0.3, 0, 7, final_frac=0.0),
    lambda m: m.linear_warmup(0.5, 8),
    lambda m: m.constant_schedule(0.25),
])
def test_schedules_match_reference(make):
    r, t = make(R), make(T)
    for step in (0, 1, 5, 9, 10, 11, 50, 99, 100, 150):
        got = t(torch.tensor(step, dtype=torch.int32))
        ref = r(jnp.asarray(step, jnp.int32))
        assert got.dtype == torch.float32
        torch.testing.assert_close(got, torch.tensor(float(ref)), **TOL)


@pytest.mark.parametrize("name", ["adamw", "sgd", "adafactor"])
def test_optimizers_minimize_quadratic(name):
    opt = {"adamw": T.adamw(T.constant_schedule(0.1)),
           "sgd": T.sgd(T.constant_schedule(0.05), momentum=0.5),
           "adafactor": T.adafactor(T.constant_schedule(0.5))}[name]
    params = {"a": torch.zeros((4, 4)), "b": torch.ones((3,))}
    state = opt.init(params)
    for _ in range(120):
        grads = tree_map(lambda p: 2 * (p - 3.0), params)
        updates, state = opt.update(grads, state, params)
        params = T.apply_updates(params, updates)
    loss = sum(float(((p - 3.0) ** 2).sum()) for p in tree_leaves(params))
    assert loss < 1e-2


def test_state_lives_on_the_params_device_and_bf16_params_stay_bf16():
    params = {"w": torch.ones((3, 2), dtype=torch.bfloat16)}
    opt = T.adamw(T.constant_schedule(0.1))
    state = opt.init(params)
    assert all(x.device == params["w"].device for x in tree_leaves(state))
    upd, state = opt.update({"w": torch.ones((3, 2), dtype=torch.bfloat16)},
                            state, params)
    new = T.apply_updates(params, upd)
    assert new["w"].dtype == torch.bfloat16
    assert tree_leaves(state)[-1].dtype == torch.int32
