"""Logical-axis sharding of the port (``repro_torch.dist.sharding``) against
the reference's ``repro.dist.sharding``: ``logical_to_spec`` exactly equal
over every rule and several mesh shapes (both packages read only the
axis sizes, so a plain object with a ``shape`` dict stands in for a mesh
of any size); ``placements_for`` on a 4-rank gloo mesh leaves each rank
the block that a ``NamedSharding`` of the reference's spec gives the same
mesh position (the reference on 4 JAX host devices in a subprocess);
``use_mesh_rules`` nests; ``shard`` is the identity off a
mesh.

:func:`run_ranks` (spawned processes, a ``FileStore`` group, no TCP port)
and :func:`run_reference` (the reference on N host devices in a subprocess)
are shared by the port's other distribution tests."""
import datetime
import itertools
import json
import multiprocessing as mp
import os
import subprocess
import sys
import textwrap
import threading
import time
import traceback
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.dist import sharding as r_sharding
from repro_torch.dist import sharding

SRC = Path(__file__).resolve().parents[1] / "src"

#: one group's limit: gloo's own (a rank stuck in a collective) and the
#: parent's wait for all ranks
GROUP_TIMEOUT_S = 90


def _rank_main(fn, rank, world, store_path, args, queue):
    import torch.distributed as dist

    torch.set_num_threads(2)
    try:
        dist.init_process_group(
            "gloo", store=dist.FileStore(store_path, world), rank=rank,
            world_size=world,
            timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S))
        try:
            out = fn(rank, world, *args)
        finally:
            dist.destroy_process_group()
        queue.put((rank, True, out))
    except BaseException:  # reported to the parent, which raises
        queue.put((rank, False, traceback.format_exc()))


def run_ranks(fn, world: int, tmp_path, *args) -> list:
    """``fn(rank, world, *args)`` in ``world`` spawned processes joined in
    one gloo group; their results (numpy or plain Python) in rank order.
    A rank's exception fails the call with its traceback."""
    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    store = str(tmp_path / f"store_{fn.__name__}")
    procs = [ctx.Process(target=_rank_main,
                         args=(fn, r, world, store, args, queue))
             for r in range(world)]
    for p in procs:
        p.start()
    results, errors = {}, []
    try:
        deadline = time.monotonic() + GROUP_TIMEOUT_S + 30
        for _ in procs:
            rank, ok, out = queue.get(
                timeout=max(1.0, deadline - time.monotonic()))
            if ok:
                results[rank] = out
            else:
                errors.append(f"rank {rank}:\n{out}")
                break
    finally:
        for p in procs:
            p.join(timeout=0 if errors else 20)
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
    assert not errors, errors[0]
    assert all(not p.is_alive() for p in procs)
    return [results[r] for r in range(world)]


class FakeMesh:
    """What both packages read of a mesh: its ``shape`` dict."""

    def __init__(self, **sizes):
        self.shape = dict(sizes)


MESHES = [dict(data=4, model=2), dict(pod=2, data=16, model=16),
          dict(data=1, model=8), dict(pod=2, data=4, model=2),
          dict(data=1, model=1)]
#: divisible and non-divisible dimensions (6 and 10 divide by 2 only, 7
#: by nothing, 64 and 512 by every size above)
DIMS = [1, 6, 7, 10, 64, 512]


@pytest.mark.parametrize("sizes", MESHES, ids=lambda m: "x".join(
    f"{k}{v}" for k, v in m.items()))
def test_logical_to_spec_equals_reference(sizes):
    mesh = FakeMesh(**sizes)
    names = list(sharding.AXIS_RULES) + [None, "unknown"]
    assert sharding.AXIS_RULES == r_sharding.AXIS_RULES
    checked = 0
    for a, b in itertools.product(names, names):
        for shape in itertools.product(DIMS, DIMS):
            ours = sharding.logical_to_spec((a, b), shape, mesh)
            ref = tuple(r_sharding.logical_to_spec((a, b), shape, mesh))
            assert ours == ref, (a, b, shape)
            assert sharding.logical_to_spec((a, b), shape, sizes) == ref
            checked += 1
    for logical in [("batch", "heads", "mlp"), ("batch", "batch"),
                    ("nodes", "edges", "rows"), ("experts", "vocab")]:
        for shape in itertools.product([8, 12, 512], repeat=len(logical)):
            assert sharding.logical_to_spec(logical, shape, mesh) == tuple(
                r_sharding.logical_to_spec(logical, shape, mesh))
    assert checked == len(names) ** 2 * len(DIMS) ** 2


PLACEMENT_MESHES = [(("data", "model"), (2, 2)),
                    (("pod", "data", "model"), (2, 2, 1)),
                    (("data", "model"), (1, 4))]
PLACEMENT_LOGICAL = [("batch", "heads", None), ("batch", None, "mlp"),
                     ("fsdp", "vocab", None), (None, "batch", None),
                     ("seq", None, None)]
PLACEMENT_SHAPE = (8, 12, 4)


def _placements_worker(rank, world):
    from torch.distributed.device_mesh import DeviceMesh
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.dist.sharding import local_block, placements_for

    x = torch.arange(np.prod(PLACEMENT_SHAPE), dtype=torch.float32).reshape(
        PLACEMENT_SHAPE)
    out = []
    for names, shape in PLACEMENT_MESHES:
        mesh = DeviceMesh("cpu", torch.arange(4).reshape(shape),
                          mesh_dim_names=names)
        for logical in PLACEMENT_LOGICAL:
            pl = placements_for(logical, x.shape, mesh)
            local = distribute_tensor(x, mesh, pl).to_local()
            cut = local_block(x, logical, mesh)
            assert torch.equal(local, cut), (names, logical)
            out.append((dict(zip(names, shape)), logical,
                        tuple(mesh.get_coordinate()), local.numpy()))
    return out


_REFERENCE_BLOCKS = textwrap.dedent("""
    import json
    import jax, numpy as np
    from jax.sharding import Mesh, NamedSharding
    from repro.dist.sharding import logical_to_spec
    MESHES, LOGICAL, SHAPE = %r, %r, %r
    x = np.arange(np.prod(SHAPE), dtype=np.float32).reshape(SHAPE)
    out = []
    for names, shape in MESHES:
        devs = np.array(jax.devices()[:4]).reshape(shape)
        mesh = Mesh(devs, names)
        coord = {d.id: tuple(int(c) for c in np.argwhere(devs == d)[0])
                 for d in devs.flat}
        for logical in LOGICAL:
            spec = logical_to_spec(logical, SHAPE, mesh)
            arr = jax.device_put(x, NamedSharding(mesh, spec))
            for sh in arr.addressable_shards:
                out.append([names, shape, list(logical), coord[sh.device.id],
                            np.asarray(sh.data).tolist()])
    print(json.dumps(out))
""")


def run_reference(code: str, n_devices: int):
    """``code`` in a subprocess whose JAX has ``n_devices`` host devices
    (as ``tests/test_dist.py`` runs the reference's mesh code); its last
    stdout line, parsed as JSON."""
    env = dict(os.environ, PYTHONPATH=str(SRC), JAX_PLATFORMS="cpu",
               XLA_FLAGS=f"--xla_force_host_platform_device_count="
                         f"{n_devices}")
    r = subprocess.run([sys.executable, "-c", code], env=env,
                       capture_output=True, text=True, timeout=240)
    assert r.returncode == 0, r.stderr[-3000:]
    return json.loads(r.stdout.strip().splitlines()[-1])


def test_placements_give_the_reference_blocks(tmp_path):
    """Each rank's DTensor block (and ``local_block``'s cut) is the block a
    ``NamedSharding`` of the reference's spec gives the device at the same
    coordinate of a 4-device JAX mesh of the same shape."""
    results = run_ranks(_placements_worker, 4, tmp_path)
    ref = run_reference(_REFERENCE_BLOCKS % (
        PLACEMENT_MESHES, PLACEMENT_LOGICAL, PLACEMENT_SHAPE), 4)
    want = {(tuple(names), tuple(shape), tuple(logical), tuple(coord)):
            np.asarray(block, np.float32)
            for names, shape, logical, coord, block in ref}
    got = {}
    for out in results:
        for sizes, logical, coord, local in out:
            got[(tuple(sizes), tuple(sizes.values()), logical, coord)] = local
    assert len(got) == len(want) == 4 * len(PLACEMENT_MESHES) * len(
        PLACEMENT_LOGICAL)
    for key, block in want.items():
        assert np.array_equal(got[key], block), key


def test_use_mesh_rules_nests_and_restores():
    assert sharding.current_mesh() is None
    outer, inner = {"data": 2}, {"data": 4, "model": 2}
    with sharding.use_mesh_rules(outer):
        assert sharding.current_mesh() is outer
        with sharding.use_mesh_rules(inner):
            assert sharding.current_mesh() is inner
            with sharding.use_mesh_rules(None):
                assert sharding.current_mesh() is None
            assert sharding.current_mesh() is inner
        assert sharding.current_mesh() is outer
    assert sharding.current_mesh() is None
    with pytest.raises(RuntimeError):
        with sharding.use_mesh_rules(outer):
            raise RuntimeError("inside")
    assert sharding.current_mesh() is None


def test_mesh_is_per_thread():
    seen = []
    with sharding.use_mesh_rules({"data": 2}):
        t = threading.Thread(target=lambda: seen.append(
            sharding.current_mesh()))
        t.start()
        t.join(timeout=10)
    assert not t.is_alive() and seen == [None]


def test_shard_is_the_identity_off_a_mesh_and_for_plain_tensors():
    x = torch.randn(4, 6)
    assert sharding.shard(x, "batch", "heads") is x
    with sharding.use_mesh_rules({"data": 2, "model": 2}):
        assert sharding.shard(x, "batch", "heads") is x
    assert sharding.sharding_for(("batch",), (4,)) is None


def test_mesh_axis_sizes_reads_every_kind_of_mesh():
    assert sharding.mesh_axis_sizes({"data": 2}) == {"data": 2}
    assert sharding.mesh_axis_sizes(FakeMesh(pod=2, data=3)) == {
        "pod": 2, "data": 3}
    with pytest.raises(TypeError):
        sharding.mesh_axis_sizes(object())
