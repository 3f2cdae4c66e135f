"""The port's collectives (``repro_torch.dist.collectives``) against the
reference's ``repro.dist.collectives``.

* ``distributed_topk`` on a plain tensor against the reference's, both
  given the same ``{axis: size}`` mesh: values and ids exactly equal, on
  random scores, forced ties, ``V % S != 0`` and ``k > V / S``; and its
  DTensor form on a 4-rank gloo group (scores sharded over ``model``, and
  over ``data`` × ``model``) equal to the plain one.
* ``ring_all_reduce`` against ``all_reduce``: ``assert_close`` at fp32
  defaults on random values (each rank adds in its own order), exactly on
  integer-valued floats.
* ``make_dp_grad_fn``, compressed and not, against the reference's on the
  same linear-regression loss, parameters, per-shard batches and residuals
  (the reference on 8 JAX host devices in a subprocess, mesh (4, 2) over
  ("pod", "data"), axis "pod"; the port on 4 ranks, rank r holding the
  reference's shard r), two steps carrying the residual: loss and the
  uncompressed gradients at fp32 defaults; the compressed gradients and
  residuals within one bf16 ulp of the corrected gradient (the fp32
  gradients may differ in summation order, which can move a bf16 rounding
  by one ulp).
"""
import json

import numpy as np
import pytest
import torch

from repro.dist.collectives import distributed_topk as r_topk
from repro_torch.dist.collectives import (distributed_topk,
                                          init_error_feedback, stable_topk)
from test_torch_sharding import FakeMesh, run_ranks, run_reference

TOPK_CASES = {
    # name: (B, V, k, S, ties)
    "random": (8, 64, 5, 4, None),
    "ties": (6, 96, 10, 4, 3),  # 3 distinct values: ties everywhere
    "uneven": (4, 70, 7, 4, None),  # V % S != 0: the plain top-k
    "k_over_block": (5, 32, 12, 8, None),  # k > V / S = 4
    "one_shard": (3, 40, 6, 1, None),
    "ties_k_over_block": (4, 48, 20, 8, 2),
}


def _scores(B, V, ties, seed=0):
    rng = np.random.default_rng(seed)
    if ties:
        return rng.integers(0, ties, (B, V)).astype(np.float32)
    return rng.standard_normal((B, V)).astype(np.float32)


@pytest.mark.parametrize("case", sorted(TOPK_CASES))
def test_distributed_topk_equals_reference(case):
    import jax.numpy as jnp

    B, V, k, S, ties = TOPK_CASES[case]
    x = _scores(B, V, ties)
    mesh = FakeMesh(data=2, model=S)
    rv, ri = r_topk(jnp.asarray(x), k, mesh)
    v, i = distributed_topk(torch.from_numpy(x), k, {"data": 2, "model": S})
    assert np.array_equal(v.numpy(), np.asarray(rv))
    assert np.array_equal(i.numpy(), np.asarray(ri))
    # and lax.top_k's order: a stable descending sort of the whole row
    sv, si = stable_topk(torch.from_numpy(x), k)
    assert torch.equal(v, sv) and torch.equal(i, si)


def _collectives_worker(rank, world, cases, dp):
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch.dist.collectives import (distributed_topk,
                                              make_dp_grad_fn,
                                              ring_all_reduce)

    out = {"topk": {}}
    meshes = {"model4": DeviceMesh("cpu", torch.arange(4).reshape(1, 4),
                                   mesh_dim_names=("data", "model")),
              "data2_model2": DeviceMesh("cpu", torch.arange(4).reshape(2, 2),
                                         mesh_dim_names=("data", "model"))}
    for name, (B, V, k, S, ties) in cases.items():
        x = torch.from_numpy(_scores(B, V, ties))
        for mname, mesh in meshes.items():
            rows = Shard(0) if mname == "data2_model2" and B % 2 == 0 \
                else Replicate()
            d = distribute_tensor(x, mesh, [rows, Shard(1)])
            v, i = distributed_topk(d, k, mesh)
            out["topk"][(name, mname)] = (v.full_tensor().numpy(),
                                          i.full_tensor().numpy())
    # ring all-reduce over a 4-rank axis and a 2-rank one
    ring = {}
    for mname, axis in [("model4", "model"), ("data2_model2", "data")]:
        mesh = meshes[mname]
        g = torch.Generator().manual_seed(100 + rank)
        xr = torch.randn(13, 5, generator=g)
        xi = torch.randint(-1000, 1000, (13, 5), generator=g).float()
        for kind, x in [("random", xr), ("integer", xi)]:
            want = x.clone()
            dist.all_reduce(want, group=mesh.get_group(axis))
            ring[(mname, kind)] = (ring_all_reduce(x, mesh, axis).numpy(),
                                   want.numpy())
    out["ring"] = ring
    # data-parallel gradients, rank r = the reference's shard r
    mesh = DeviceMesh("cpu", torch.arange(4).reshape(4, 1),
                      mesh_dim_names=("pod", "data"))

    def loss_fn(params, batch):
        pred = batch["x"] @ params["w"]
        return ((pred - batch["y"]) ** 2).mean(), {}

    params = {"w": torch.tensor(dp["w"])}
    res = {"w": torch.tensor(dp["res"][rank])}
    dps = {}
    for compress in (True, False):
        fn = make_dp_grad_fn(loss_fn, mesh, "pod", compress=compress)
        r = res
        steps = []
        for s in range(2):
            batch = {"x": torch.tensor(dp["x"][s][rank]),
                     "y": torch.tensor(dp["y"][s][rank])}
            g, r, loss = fn(params, batch, r)
            steps.append((g["w"].numpy(), r["w"].numpy(), float(loss)))
        dps[compress] = steps
    out["dp"] = dps
    return out


_REFERENCE_DP = """
import json
import jax, jax.numpy as jnp
import numpy as np
from repro.dist.collectives import make_dp_grad_fn
DP = json.loads(%r)
mesh = jax.make_mesh((4, 2), ("pod", "data"))

def loss_fn(params, batch):
    pred = batch["x"] @ params["w"]
    return jnp.mean((pred - batch["y"]) ** 2), {}

# each shard's own gradient: the corrected value is it plus the residual
local_grad = jax.vmap(jax.grad(lambda p, b: loss_fn(p, b)[0]),
                      in_axes=(None, 0))
params = {"w": jnp.asarray(DP["w"], jnp.float32)}
out = {}
with mesh:
    for compress in (True, False):
        fn = jax.jit(make_dp_grad_fn(loss_fn, mesh, "pod", compress=compress))
        res = {"w": jnp.asarray(DP["res"], jnp.float32)}
        steps = []
        for s in range(2):
            batch = {"x": jnp.asarray(DP["x"][s], jnp.float32),
                     "y": jnp.asarray(DP["y"][s], jnp.float32)}
            corrected = local_grad(params, batch)["w"] + res["w"]
            g, res, loss = fn(params, batch, res)
            steps.append([np.asarray(g["w"]).tolist(),
                          np.asarray(res["w"]).tolist(), float(loss),
                          np.asarray(corrected).tolist()])
        out[str(compress)] = steps
print(json.dumps(out))
"""


def _dp_inputs():
    rng = np.random.default_rng(7)
    return {"w": rng.standard_normal((6, 1)).astype(np.float32),
            "res": (0.1 * rng.standard_normal((4, 6, 1))).astype(np.float32),
            "x": rng.random((2, 4, 8, 6), dtype=np.float32),
            "y": rng.random((2, 4, 8, 1), dtype=np.float32)}


@pytest.fixture(scope="module")
def port_results(tmp_path_factory):
    dp = _dp_inputs()
    return run_ranks(_collectives_worker, 4, tmp_path_factory.mktemp("coll"),
                     TOPK_CASES, dp)


@pytest.fixture(scope="module")
def reference_dp():
    dp = {k: v.tolist() for k, v in _dp_inputs().items()}
    return run_reference(_REFERENCE_DP % json.dumps(dp), 8)


@pytest.mark.parametrize("case", sorted(TOPK_CASES))
def test_distributed_topk_dtensor_equals_plain(port_results, case):
    B, V, k, S, ties = TOPK_CASES[case]
    sv, si = stable_topk(torch.from_numpy(_scores(B, V, ties)), k)
    for out in port_results:
        for mname in ("model4", "data2_model2"):
            v, i = out["topk"][(case, mname)]
            assert np.array_equal(v, sv.numpy()), mname
            assert np.array_equal(i, si.numpy()), mname


def test_ring_all_reduce_matches_all_reduce(port_results):
    for out in port_results:
        for (mname, kind), (ring, want) in out["ring"].items():
            if kind == "integer":
                assert np.array_equal(ring, want), mname
            else:
                torch.testing.assert_close(torch.from_numpy(ring),
                                           torch.from_numpy(want))


def _bf16_ulp(c: np.ndarray) -> np.ndarray:
    """One bf16 ulp at |c| (8 significant bits), plus the fp32 rounding of
    the corrected value itself (a few fp32 ulps)."""
    mag = np.maximum(np.abs(c), np.float32(2.0 ** -126))
    return (np.exp2(np.floor(np.log2(mag)) - 7) + 4 * 2.0 ** -23 * mag
            ).astype(np.float32)


def test_dp_grads_match_reference(port_results, reference_dp):
    for compress in (True, False):
        ref_steps = reference_dp[str(compress)]
        for rank, out in enumerate(port_results):
            for s, (g, r, loss) in enumerate(out["dp"][compress]):
                rg, rres, rloss, corrected = (np.asarray(a, np.float32)
                                              for a in ref_steps[s])
                torch.testing.assert_close(torch.tensor(loss),
                                           torch.tensor(rloss))
                if not compress:
                    torch.testing.assert_close(torch.from_numpy(g),
                                               torch.from_numpy(rg))
                    continue
                # a mean of wires each within an ulp of its shard's
                # corrected gradient; this rank's residual within its own
                ulp = _bf16_ulp(corrected)
                assert np.all(np.abs(g - rg) <= ulp.max(0)), (s, rank)
                assert np.all(np.abs(r - rres[rank]) <= ulp[rank]), (s, rank)
    # error feedback carries a residual (the bf16 error of each step)
    assert all(np.abs(out["dp"][True][1][1]).sum() > 0
               for out in port_results)


def test_init_error_feedback_is_this_ranks_zeros():
    params = {"w": torch.ones(3, 2, dtype=torch.bfloat16),
              "b": [torch.ones(4)]}
    res = init_error_feedback(params, 4)
    assert res["w"].shape == (3, 2) and res["w"].dtype == torch.float32
    assert res["b"][0].shape == (4,) and not res["b"][0].any()
    with pytest.raises(ValueError):
        init_error_feedback(params, 0)
