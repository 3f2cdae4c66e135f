"""Elastic meshes of the port (``repro_torch.dist.elastic``,
``repro_torch.launch.mesh``) and the mesh-aware checkpoint
(``repro_torch.train.checkpoint``).

* ``make_mesh_for``'s shape against the reference's for n = 1..8 ranks ×
  ``model_parallel`` 1..8: both in one subprocess, the reference on 8 JAX
  host devices, the port on a fake process group of 8 ranks.
* ``make_production_mesh`` on a fake process group of 256 and of 512
  ranks: (32, 8) over ("data", "model") and (2, 32, 8) over ("pod",
  "data", "model").
* On a 4-rank gloo group: a checkpoint saved from a (2, 2) mesh (rank 0
  writes, every rank waits) and restored onto a 2-rank mesh equals
  ``arange(32).reshape(8, 4)``, as the reference's
  ``test_elastic_restore_smaller_mesh`` checks, with ``shardings=`` as
  (mesh, placements) pairs and as logical axes under ``use_mesh_rules``;
  the async ``CheckpointManager`` alike; ``reshard`` between the meshes
  and back; one file written however many ranks save.
"""
import textwrap

import numpy as np
import pytest
import torch

from test_torch_sharding import run_ranks, run_reference

_MESHES = textwrap.dedent("""
    import json
    import jax
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    from repro.dist.elastic import make_mesh_for as r_make_mesh_for
    from repro_torch.dist.elastic import make_mesh_for
    from repro_torch.launch.mesh import make_production_mesh

    out = {"ref": {}, "port": {}, "prod": {}}
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=8)
    for n in range(1, 9):
        for mp in range(1, 9):
            r = r_make_mesh_for(n, model_parallel=mp)
            out["ref"][f"{n},{mp}"] = [list(r.devices.shape),
                                       list(r.axis_names)]
            m = make_mesh_for(n, model_parallel=mp)
            out["port"][f"{n},{mp}"] = [list(m.mesh.shape),
                                        list(m.mesh_dim_names)]
    out["default"] = [list(make_mesh_for().mesh.shape),
                      list(r_make_mesh_for().devices.shape)]
    dist.destroy_process_group()
    for world, multi in [(256, False), (512, True)]:
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=world)
        m = make_production_mesh(multi_pod=multi)
        out["prod"][str(world)] = [list(m.mesh.shape),
                                   list(m.mesh_dim_names), m.device_type]
        dist.destroy_process_group()
    print(json.dumps(out))
""")


@pytest.fixture(scope="module")
def meshes():
    return run_reference(_MESHES, 8)


def test_make_mesh_for_shapes_equal_reference(meshes):
    assert len(meshes["ref"]) == 64
    assert meshes["port"] == meshes["ref"]
    assert meshes["default"] == [[8, 1], [8, 1]]


def test_production_mesh_on_a_fake_group(meshes):
    assert meshes["prod"]["256"] == [[32, 8], ["data", "model"], "cpu"]
    assert meshes["prod"]["512"] == [[2, 32, 8], ["pod", "data", "model"],
                                     "cpu"]


def _elastic_worker(rank, world, ckpt_dir):
    import os

    from torch.distributed.tensor import (DTensor, Replicate, Shard,
                                          distribute_tensor)

    from repro_torch.dist.elastic import make_mesh_for, reshard
    from repro_torch.dist.sharding import use_mesh_rules
    from repro_torch.train import checkpoint as ckpt

    want = torch.arange(32.0).reshape(8, 4)
    big = make_mesh_for(4, model_parallel=2)
    small = make_mesh_for(2)
    out = {"big": tuple(big.mesh.shape), "small": tuple(small.mesh.shape),
           "in_small": small.get_coordinate() is not None}
    w = distribute_tensor(want, big, [Shard(0), Shard(1)])
    out["big_local"] = w.to_local().numpy()
    ckpt.save(ckpt_dir, 1, {"w": w, "step": torch.tensor(3)})
    out["files"] = sorted(os.listdir(ckpt_dir))
    target = {"w": w, "step": torch.tensor(0)}
    pair, _, _ = ckpt.restore(ckpt_dir, target, shardings={
        "w": (small, [Shard(0), Shard(1)]), "step": (small, [Replicate(), Replicate()])})
    with use_mesh_rules(small):
        logical, _, _ = ckpt.restore(
            ckpt_dir, target, shardings={"w": ("batch", "vocab"),
                                         "step": ()})
    # the async manager: rank 0 writes on its thread, wait() is collective
    mgr = ckpt.CheckpointManager(os.path.join(ckpt_dir, "mgr"), keep=2)
    mgr.save(5, {"w": w})
    mgr.wait()
    managed, step, _ = mgr.restore({"w": w},
                                   shardings=(small, [Shard(0), Shard(1)]))
    out["mgr_step"] = step
    back = reshard({"w": w, "b": want + 1}, small,
                   {"w": ("batch", None), "b": None})
    again = reshard(back, big, ("batch", "vocab"))
    out["again_local"] = again["w"].to_local().numpy()
    out["again_placements"] = [p.dim if p.is_shard() else None
                               for p in again["w"].placements]
    # the target's own placements when no shardings are given
    same, _, _ = ckpt.restore(ckpt_dir, target)
    out["same_local"] = same["w"].to_local().numpy()
    if out["in_small"]:
        for name, tree in [("pair", pair), ("logical", logical),
                           ("managed", managed), ("reshard", back)]:
            x = tree["w"]
            assert isinstance(x, DTensor) and x.device_mesh == small
            out[name] = x.full_tensor().numpy()
            out[name + "_local"] = x.to_local().numpy()
            out[name + "_ranks"] = int(x.device_mesh.size())
        out["b"] = back["b"].full_tensor().numpy()
        out["step"] = int(pair["step"].full_tensor())
    return out


def test_elastic_restore_onto_a_smaller_mesh(tmp_path):
    results = run_ranks(_elastic_worker, 4, tmp_path, str(tmp_path / "ck"))
    want = np.arange(32.0, dtype=np.float32).reshape(8, 4)
    assert [r["in_small"] for r in results] == [True, True, False, False]
    for rank, out in enumerate(results):
        assert out["big"] == (2, 2) and out["small"] == (2, 1)
        assert out["files"] == ["LATEST", "step_00000001"]
        assert out["mgr_step"] == 5
        i, j = divmod(rank, 2)
        block = want[4 * i:4 * i + 4, 2 * j:2 * j + 2]
        assert np.array_equal(out["big_local"], block)
        assert np.array_equal(out["same_local"], block)
        assert np.array_equal(out["again_local"], block)
        assert out["again_placements"] == [0, 1]
        if not out["in_small"]:
            continue
        for name in ("pair", "logical", "managed", "reshard"):
            assert np.array_equal(out[name], want), name
            assert out[name + "_ranks"] == 2
            assert np.array_equal(out[name + "_local"],
                                  want[4 * rank:4 * rank + 4]), name
        assert np.array_equal(out["b"], want + 1)
        assert out["step"] == 3


def test_restore_with_logical_axes_needs_a_mesh(tmp_path):
    from repro_torch.train import checkpoint as ckpt

    ckpt.save(str(tmp_path), 1, {"w": torch.ones(4)})
    with pytest.raises(ValueError, match="use_mesh_rules"):
        ckpt.restore(str(tmp_path), {"w": torch.zeros(4)},
                     shardings={"w": ("batch",)})


def test_make_mesh_for_needs_a_process_group():
    from repro_torch.dist.elastic import make_mesh_for

    with pytest.raises(RuntimeError, match="init_process_group"):
        make_mesh_for()
