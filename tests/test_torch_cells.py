"""The dry-run's cells of the port (``repro_torch.launch.cells``) against
the reference's (``repro.launch.cells``).

* Every non-skipped cell (37) built on an 8-rank fake process group's
  ``(4, 2)`` mesh by the port, and on an 8-host-device ``(4, 2)`` JAX mesh
  by the reference, each in a subprocess: ``kind``, ``model_flops``,
  ``tokens_or_items`` and ``description`` equal, ``arg_bytes_per_device``
  exactly equal (the placements the port gives each leaf hold the bytes
  the reference's ``NamedSharding`` does).
* ``shapes_only`` against a real init, leaf for leaf (paths, shapes,
  dtypes), for a smoke config of each model family, with no random number
  drawn; a built cell's tensors are all meta.
"""
import os
import subprocess
import sys
import textwrap

import pytest
import torch

from test_torch_sharding import SRC, run_reference

from repro_torch.configs import all_cells, get_arch
from repro_torch.launch.cells import META, shapes_only
from repro_torch.models import bert4rec as b4r
from repro_torch.models import transformer as tfm
from repro_torch.models.gnn import init_gnn
from repro_torch.train.tree import tree_leaves, tree_paths

_FIELDS = ("kind", "model_flops", "tokens_or_items", "description",
           "arg_bytes_per_device")

_REFERENCE = textwrap.dedent("""
    import json
    import jax
    from repro.configs import all_cells
    from repro.dist.sharding import use_mesh_rules
    from repro.launch.cells import arg_bytes_per_device, build_cell
    mesh = jax.make_mesh((4, 2), ("data", "model"))
    out = {}
    with use_mesh_rules(mesh):
        for arch, cell, _ in all_cells():
            c = build_cell(arch, cell.name, mesh)
            out[arch + "/" + cell.name] = [
                c.kind, c.model_flops, c.tokens_or_items, c.description,
                arg_bytes_per_device(c.args, 8)]
    print(json.dumps(out))
""")

_PORT = textwrap.dedent("""
    import json
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore
    from repro_torch.configs import all_cells
    from repro_torch.dist.sharding import use_mesh_rules
    from repro_torch.launch.cells import arg_bytes_per_device, build_cell
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=8)
    mesh = init_device_mesh("cuda", (4, 2), mesh_dim_names=("data", "model"))
    out = {}
    with use_mesh_rules(mesh):
        for arch, cell, _ in all_cells():
            c = build_cell(arch, cell.name, mesh)
            out[arch + "/" + cell.name] = [
                c.kind, c.model_flops, c.tokens_or_items, c.description,
                arg_bytes_per_device(c.args, 8)]
    dist.destroy_process_group()
    print(json.dumps(out))
""")


def _run_port(code: str) -> dict:
    import json
    env = dict(os.environ, PYTHONPATH=str(SRC))
    r = subprocess.run([sys.executable, "-c", code], env=env,
                       capture_output=True, text=True, timeout=240)
    assert r.returncode == 0, r.stderr[-3000:]
    return json.loads(r.stdout.strip().splitlines()[-1])


def test_every_cell_matches_the_reference():
    port = _run_port(_PORT)
    ref = run_reference(_REFERENCE, 8)
    want = {f"{a}/{c.name}" for a, c, _ in all_cells()}
    assert len(want) == 37
    assert set(port) == set(ref) == want
    for key in sorted(want):
        got, exp = dict(zip(_FIELDS, port[key])), \
            dict(zip(_FIELDS, ref[key]))
        assert got == exp, (key, got, exp)


def _leaves(tree) -> list:
    return [(p, tuple(x.shape), x.dtype)
            for p, x in zip(tree_paths(tree), tree_leaves(tree))]


def _inits():
    lm = [get_arch(a).make_smoke_cfg()
          for a in ("tinyllama-1.1b", "granite-moe-3b-a800m", "gemma2-27b")]
    gnn = [get_arch(a).make_smoke_cfg()
           for a in ("gat-cora", "gin-tu", "dimenet", "graphsage-reddit")]
    b4 = get_arch("bert4rec").make_smoke_cfg()
    out = [(f"lm:{c.name}", lambda g, d, c=c: tfm.init_params(c, g, d))
           for c in lm]
    out += [(f"gnn:{c.arch}", lambda g, d, c=c: init_gnn(g, c, d))
            for c in gnn]
    out.append(("bert4rec", lambda g, d: b4r.init_bert4rec(b4, g, d)))
    return out


@pytest.mark.parametrize("name,init", _inits(), ids=lambda v: v
                         if isinstance(v, str) else "")
def test_shapes_only_init_matches_a_real_init(name, init):
    real = init(torch.Generator(device="cpu").manual_seed(0), "cpu")
    gen = torch.Generator(device="cpu").manual_seed(0)
    state = gen.get_state()
    meta = shapes_only(init, gen, META)
    assert torch.equal(gen.get_state(), state)  # no random number drawn
    assert _leaves(meta) == _leaves(real)
    assert all(x.device.type == "meta" for x in tree_leaves(meta))


def test_a_built_cell_holds_no_memory():
    """A cell's arguments are meta DTensors (and decode's int ``pos``): the
    full Mixtral-8x22B decode cell costs no memory."""
    code = textwrap.dedent("""
        import torch.distributed as dist
        from torch.distributed.device_mesh import init_device_mesh
        from torch.distributed.tensor import DTensor
        from torch.testing._internal.distributed.fake_pg import FakeStore
        from repro_torch.launch.cells import build_cell
        from repro_torch.train.tree import tree_leaves
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=8)
        mesh = init_device_mesh("cuda", (4, 2), mesh_dim_names=("data",
                                                                "model"))
        c = build_cell("mixtral-8x22b", "decode_32k", mesh)
        leaves = tree_leaves(c.args)
        assert c.args[2] == 32767
        tensors = [x for x in leaves if not isinstance(x, int)]
        assert all(isinstance(x, DTensor) for x in tensors)
        assert all(x.to_local().device.type == "meta" for x in tensors)
        print(sum(x.numel() for x in tensors))
    """)
    env = dict(os.environ, PYTHONPATH=str(SRC))
    r = subprocess.run([sys.executable, "-c", code], env=env,
                       capture_output=True, text=True, timeout=240)
    assert r.returncode == 0, r.stderr[-3000:]
    assert int(r.stdout.strip().splitlines()[-1]) > 140e9
