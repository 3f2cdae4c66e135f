"""The models on a mesh (``repro_torch.models`` on DTensors) against one
device and against the reference, on 2- and 4-rank gloo groups.

* ``param_logical_axes`` is the reference's tree for every LM arch (its
  leading ``layers`` entry dropped, one dict a layer), and for every LM
  arch each parameter ``place_tree`` puts on a (2, 2) mesh (Gemma-2's
  layers restacked in pairs) leaves every rank the block that a
  ``NamedSharding`` of the reference's spec gives the device at the same
  coordinate of 4 JAX host devices.
* The smoke TinyLlama, Mixtral and Granite (fp32) on (1, 2), (2, 2) and
  (1, 4) meshes: logits, loss, aux loss and every gradient of ``loss_fn``
  equal one device at ``assert_close``'s fp32 defaults (the (1, 4) mesh
  leaves TinyLlama's 2 KV heads whole on every rank while its 4 q heads
  are split).  A mixture of experts on ``data`` = 2 is held against one
  device under ``use_mesh_rules({"data": 2, "model": 1})``: the same
  two-shard dispatch.
* ``serve_prefill`` and 8 greedy ``serve_decode`` steps on a cache split
  by ``kv_heads``: logits at the same tolerance, tokens equal.
* ``moe_block`` on (2, 1) and (2, 2), with and without capacity drops:
  each shard's expert ids and kept set exactly the reference's (its
  ``moe_block`` under a 4-device ``jax.sharding.Mesh`` with Auto axes, in
  a subprocess, and its routing and ``_bin_and_dispatch`` per shard), out
  and aux at fp32 defaults.
* The four GNNs on (2, 1) (batch placed by ``nodes`` / ``edges``), and
  GraphSAGE with ``binned_edges`` on a batch laid out by
  ``bin_edges_by_stripe``: forward equal to the reference's one-device
  forward at the GNN tolerance (1e-4).
* ``bert4rec_score`` and ``bert4rec_retrieve`` on (2, 2): ids and values
  those of one device under ``use_mesh_rules`` with the same axes.
"""
import dataclasses
import logging
import textwrap

import numpy as np
import pytest
import torch

from repro_torch.configs import get_arch
from repro_torch.dist.sharding import use_mesh_rules
from repro_torch.models import transformer as tfm
from test_torch_sharding import run_ranks, run_reference

LM_ARCHS = ["tinyllama-1.1b", "mixtral-8x22b", "granite-moe-3b-a800m"]
ALL_LM_ARCHS = LM_ARCHS + ["gemma-7b", "gemma2-27b"]
GNN_ARCHS = ["gat-cora", "gin-tu", "graphsage-reddit", "dimenet"]
B, S, PROMPT, STEPS = 4, 16, 6, 8
MOE_CASES = {"fits": 1.25, "drops": 0.5}
GNN_TOL = dict(rtol=1e-4, atol=1e-4)


def _lm_cfg(arch):
    return dataclasses.replace(get_arch(arch).make_smoke_cfg(),
                               compute_dtype="float32")


def _lm_setup(arch):
    cfg = _lm_cfg(arch)
    params = tfm.init_params(cfg, torch.Generator().manual_seed(3), "cpu")
    tokens = torch.randint(0, cfg.vocab, (B, S + 1),
                           generator=torch.Generator().manual_seed(5))
    return cfg, params, tokens


def _plain(x):
    from torch.distributed.tensor import DTensor

    return x.full_tensor() if isinstance(x, DTensor) else x


def _lm_run(arch, mesh=None):
    """Logits, loss, aux and gradients of ``loss_fn`` (numpy), the
    tokens as DTensors split by ``batch`` on ``mesh``."""
    from repro_torch.dist.sharding import place_tree
    from repro_torch.train.trainer import _value_and_grad
    from repro_torch.train.tree import tree_leaves

    cfg, params, tokens = _lm_setup(arch)
    if mesh is not None:
        params = place_tree(params, tfm.param_logical_axes(cfg), mesh)
        tokens = place_tree(tokens, ("batch", None), mesh)
    loss, metrics, grads = _value_and_grad(
        lambda p, b: tfm.loss_fn(p, b, cfg), params, {"tokens": tokens})
    with torch.no_grad():
        logits, _ = tfm.forward(params, tokens[:, :-1], cfg)
    return {"logits": _plain(logits).numpy(), "loss": float(_plain(loss)),
            "aux": float(_plain(metrics["moe_aux"])),
            "grads": [_plain(g).numpy() for g in tree_leaves(grads)]}


def _serve_run(arch, mesh=None):
    """Prefill logits, then the prompt decoded token by token and
    ``STEPS`` greedy steps: (prefill, decode logits, tokens)."""
    from torch.distributed.tensor import Replicate, distribute_tensor

    from repro_torch.dist.sharding import place_tree

    cfg, params, tokens = _lm_setup(arch)
    prompt = tokens[:, :PROMPT]
    if mesh is not None:
        params = place_tree(params, tfm.param_logical_axes(cfg), mesh)

    def on_mesh(t):
        if mesh is None:
            return t
        return distribute_tensor(t, mesh, [Replicate()] * mesh.ndim)

    cache = tfm.init_cache(cfg, B, PROMPT + STEPS, dtype=torch.float32,
                           device="cpu", mesh=mesh)
    with torch.no_grad():
        pre = _plain(tfm.serve_prefill(params, on_mesh(prompt), cfg))
        for pos in range(PROMPT - 1):
            _, cache = tfm.serve_decode(params, on_mesh(prompt[:, pos:pos + 1]),
                                        pos, cache, cfg)
        tok, logits, toks = prompt[:, -1:], [], []
        for i in range(STEPS):
            lg, cache = tfm.serve_decode(params, on_mesh(tok), PROMPT - 1 + i,
                                         cache, cfg)
            lg = _plain(lg)
            tok = lg.argmax(-1, keepdim=True)
            logits.append(lg.numpy())
            toks.append(tok.numpy())
    return pre.numpy(), np.stack(logits), np.stack(toks)


def _moe_cfg(cf):
    from repro_torch.models.moe import MoECfg

    return MoECfg(d_model=64, d_ff=32, num_experts=8, top_k=2,
                  capacity_factor=cf, kind="swiglu")


def _moe_run(mesh, ref):
    """``moe_block`` on DTensors for each case: out, aux and, per binning
    pass, the expert ids and kept set it saw."""
    from repro_torch.dist.sharding import place_tree
    from repro_torch.models import moe

    real = moe._bin_and_dispatch
    seen = []

    def spy(xt, gate_vals, expert_ids, E, C):
        got = real(xt, gate_vals, expert_ids, E, C)
        seen.append((expert_ids.numpy().copy(), got[4].numpy().copy()))
        return got

    moe._bin_and_dispatch = spy
    out = {}
    try:
        axes = {"router": ("fsdp", None), "w_up": ("experts", "fsdp", "mlp"),
                "w_gate": ("experts", "fsdp", "mlp"),
                "w_down": ("experts", "mlp", "fsdp")}
        for name, cf in MOE_CASES.items():
            r = ref[name]
            params = {k: torch.tensor(np.asarray(v, np.float32))
                      for k, v in r["params"].items()}
            x = torch.tensor(np.asarray(r["x"], np.float32))
            seen.clear()
            y, aux = moe.moe_block(place_tree(params, axes, mesh),
                                   place_tree(x, ("batch", None, None), mesh),
                                   _moe_cfg(cf))
            out[name] = {"out": _plain(y).numpy(),
                         "aux": float(_plain(aux)), "seen": list(seen)}
    finally:
        moe._bin_and_dispatch = real
    return out


def _gnn_run(mesh):
    """The four GNNs' forwards on DTensors (and GraphSAGE's with
    ``binned_edges`` on a stripe-laid batch)."""
    from repro_torch.dist.sharding import place_tree
    from repro_torch.models import gnn
    from test_torch_gnn import _case, _params

    out = {}
    for arch in GNN_ARCHS + ["graphsage-reddit/binned"]:
        name, binned = arch.split("/")[0], arch.endswith("binned")
        rc, pc, rb, pb, _, _ = _case(name)
        _, pp = _params(rc)
        if binned:
            pc = dataclasses.replace(pc, binned_edges=True)
            pb = gnn.bin_edges_by_stripe(pb, 2)
        with torch.no_grad():
            y = gnn.gnn_forward(place_tree(pp, None, mesh),
                                gnn.place_batch(pb, mesh, pc.graph_level), pc)
        out[arch] = _plain(y).numpy()
    return out


def _b4_setup():
    from repro_torch.models import bert4rec as B4

    cfg = B4.Bert4RecCfg(**{**dataclasses.asdict(
        get_arch("bert4rec").make_smoke_cfg()), "vocab": 1000})
    params = B4.init_bert4rec(cfg, torch.Generator().manual_seed(0),
                              device="cpu")
    rng = np.random.default_rng(1)
    items = torch.from_numpy(rng.integers(1, cfg.vocab, (8, cfg.max_len))
                             .astype(np.int32))
    items[:, -1] = cfg.mask_id
    items[0, :3] = cfg.pad_id
    cands = torch.from_numpy(rng.integers(1, cfg.vocab, (64,)).astype(
        np.int32))
    return B4, cfg, params, items, cands


def _b4_run(mesh=None):
    from repro_torch.dist.sharding import place_tree

    B4, cfg, params, items, cands = _b4_setup()
    if mesh is not None:
        params = place_tree(params, None, mesh)
        cands = place_tree(cands, ("candidates",), mesh)
    users = place_tree(items, ("batch", None), mesh)
    one = place_tree(items[:1], ("batch", None), mesh)
    with torch.no_grad():
        v, i = B4.bert4rec_score(params, users, cfg, top_k=20)
        rv, ri = B4.bert4rec_retrieve(params, one, cands, cfg, top_k=10)
    return [_plain(t).numpy() for t in (v, i, rv, ri)]


def _placed_blocks(mesh, trees):
    """Each rank's local block of every leaf of ``trees`` (filled numpy
    trees of the reference's layout) placed by ``param_logical_axes``."""
    from repro_torch.dist.sharding import place_tree
    from repro_torch.train.tree import tree_leaves

    out = {}
    for arch, tree in trees.items():
        cfg = _lm_cfg(arch)
        params = tfm.params_from_numpy(tree, cfg, device="cpu")
        placed = place_tree(params, tfm.param_logical_axes(cfg), mesh)
        out[arch] = [x.to_local().numpy() for x in tree_leaves(placed)]
    return out


def _mesh(shape, names=("data", "model")):
    from torch.distributed.device_mesh import DeviceMesh

    return DeviceMesh("cpu", torch.arange(int(np.prod(shape))).reshape(shape),
                      mesh_dim_names=names)


def _worker2(rank, world, moe_ref):
    logging.disable(logging.WARNING)
    out = {}
    mesh = _mesh((1, 2))
    with use_mesh_rules(mesh):
        for arch in LM_ARCHS:
            out[("lm", (1, 2), arch)] = _lm_run(arch, mesh)
        for arch in ("tinyllama-1.1b", "granite-moe-3b-a800m"):
            out[("serve", (1, 2), arch)] = _serve_run(arch, mesh)
    mesh = _mesh((2, 1))
    with use_mesh_rules(mesh):
        out[("moe", (2, 1))] = _moe_run(mesh, moe_ref)
        out["gnn"] = _gnn_run(mesh)
    return out


def _worker4(rank, world, moe_ref, trees):
    logging.disable(logging.WARNING)
    out = {}
    for shape in ((2, 2), (1, 4)):
        mesh = _mesh(shape)
        with use_mesh_rules(mesh):
            for arch in LM_ARCHS:
                out[("lm", shape, arch)] = _lm_run(arch, mesh)
            out[("serve", shape, "tinyllama-1.1b")] = _serve_run(
                "tinyllama-1.1b", mesh)
    mesh = _mesh((2, 2))
    with use_mesh_rules(mesh):
        out[("serve", (2, 2), "granite-moe-3b-a800m")] = _serve_run(
            "granite-moe-3b-a800m", mesh)
        out[("moe", (2, 2))] = _moe_run(mesh, moe_ref)
        out["b4"] = _b4_run(mesh)
    out["blocks"] = _placed_blocks(mesh, trees)
    out["coord"] = tuple(mesh.get_coordinate())
    return out


_REFERENCE = textwrap.dedent("""
    import json
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import Mesh, NamedSharding
    from repro.configs import get_arch
    from repro.dist.sharding import logical_to_spec, use_mesh_rules
    from repro.models import moe as M
    from repro.models import transformer as T
    CASES, ARCHS = %r, %r
    out = {"moe": {}, "axes": {}, "index": {}}
    for name, cf in CASES.items():
        cfg = M.MoECfg(d_model=64, d_ff=32, num_experts=8, top_k=2,
                       capacity_factor=cf, kind="swiglu")
        params = M.init_moe(jax.random.PRNGKey(0), cfg)
        x = jax.random.normal(jax.random.PRNGKey(1), (4, 16, 64))
        rec = {"params": {k: np.asarray(v).tolist() for k, v in
                          params.items()}, "x": np.asarray(x).tolist()}
        n, d = 64, 64
        xt = x.reshape(n, d)
        probs = jax.nn.softmax(xt @ params["router"], axis=-1)
        gv, eid = jax.lax.top_k(probs, cfg.top_k)
        gv = gv / jnp.maximum(gv.sum(-1, keepdims=True), 1e-9)
        for data, model in ((2, 1), (2, 2)):
            devs = np.array(jax.devices()[:data * model]).reshape(data, model)
            mesh = Mesh(devs, ("data", "model"))
            with mesh, use_mesh_rules(mesh):
                y, aux = jax.jit(lambda p, x: M.moe_block(p, x, cfg))(
                    params, x)
            C = M._capacity(n // data, cfg)
            shards = []
            for s in range(data):
                rows = slice(s * n // data, (s + 1) * n // data)
                got = M._bin_and_dispatch(xt[rows], gv[rows], eid[rows],
                                          cfg.num_experts, C)
                shards.append([np.asarray(eid[rows]).tolist(),
                               np.asarray(got[4]).tolist()])
            rec[f"{data}x{model}"] = {"out": np.asarray(y).tolist(),
                                      "aux": float(aux), "shards": shards}
        out["moe"][name] = rec
    devs = np.array(jax.devices()[:4]).reshape(2, 2)
    mesh = Mesh(devs, ("data", "model"))
    coord = {d.id: [int(c) for c in np.argwhere(devs == d)[0]]
             for d in devs.flat}
    for arch in ARCHS:
        cfg = get_arch(arch).make_smoke_cfg()
        axes = T.param_logical_axes(cfg)
        shapes = jax.eval_shape(lambda: T.init_params(cfg,
                                                      jax.random.PRNGKey(0)))
        flat_axes = jax.tree.leaves(axes, is_leaf=lambda a: isinstance(
            a, tuple))
        flat_shapes = jax.tree.leaves(shapes)
        out["axes"][arch] = [list(a) for a in flat_axes]
        idx = []
        for a, sds in zip(flat_axes, flat_shapes):
            spec = logical_to_spec(a, sds.shape, mesh)
            m = NamedSharding(mesh, spec).devices_indices_map(sds.shape)
            idx.append({str(coord[dev.id]): [[s.start or 0, s.stop
                                              if s.stop is not None else n]
                                             for s, n in zip(sl, sds.shape)]
                        for dev, sl in m.items()})
        out["index"][arch] = idx
    print(json.dumps(out))
""")


@pytest.fixture(scope="module")
def reference():
    return run_reference(_REFERENCE % (MOE_CASES, ALL_LM_ARCHS), 4)


def _filled_trees():
    """Each LM arch's reference parameter tree (stacked layers) with leaf
    ``i`` filled with ``arange`` values offset by ``i · 10⁶``."""
    import jax

    from repro.configs import get_arch as r_get_arch
    from repro.models import transformer as r_tfm

    out = {}
    for arch in ALL_LM_ARCHS:
        cfg = r_get_arch(arch).make_smoke_cfg()
        shapes = jax.eval_shape(
            lambda: r_tfm.init_params(cfg, jax.random.PRNGKey(0)))
        leaves, treedef = jax.tree.flatten(shapes)
        filled = [np.arange(int(np.prod(s.shape)), dtype=np.float32)
                  .reshape(s.shape) + i * 1e6 for i, s in enumerate(leaves)]
        out[arch] = jax.tree.unflatten(treedef, filled)
    return out


@pytest.fixture(scope="module")
def ranks2(reference, tmp_path_factory):
    return run_ranks(_worker2, 2, tmp_path_factory.mktemp("tp2"),
                     reference["moe"])


@pytest.fixture(scope="module")
def ranks4(reference, tmp_path_factory):
    return run_ranks(_worker4, 4, tmp_path_factory.mktemp("tp4"),
                     reference["moe"], _filled_trees())


@pytest.mark.parametrize("arch", ALL_LM_ARCHS)
def test_param_logical_axes_are_the_reference_tree(arch):
    from repro.configs import get_arch as r_get_arch
    from repro.models import transformer as r_tfm

    cfg = get_arch(arch).make_smoke_cfg()
    ref = r_tfm.param_logical_axes(r_get_arch(arch).make_smoke_cfg())
    ours = tfm.param_logical_axes(cfg)
    lead = 2 if cfg.pair_scan else 1

    def strip(tree):
        if isinstance(tree, dict):
            return {k: strip(v) for k, v in tree.items()}
        return tree[lead:]

    assert {k: v for k, v in ours.items() if k != "layers"} == \
        {k: v for k, v in ref.items() if k != "layers"}
    assert len(ours["layers"]) == cfg.n_layers
    assert all(layer == strip(ref["layers"]) for layer in ours["layers"])


@pytest.mark.parametrize("arch", ALL_LM_ARCHS)
def test_placed_params_are_the_reference_blocks(ranks4, reference, arch):
    """Rank (i, j)'s block of each placed parameter is the block a
    ``NamedSharding`` of the reference's spec gives device (i, j): the
    reference's leaf ``[layer]`` cut at that device's index."""
    import jax

    trees = _filled_trees()
    cfg = _lm_cfg(arch)
    ref_leaves = jax.tree.leaves(trees[arch])
    index = reference["index"][arch]
    paths = jax.tree_util.tree_leaves_with_path(trees[arch])
    lead = 2 if cfg.pair_scan else 1
    # the port's leaves in its own order, each with its reference leaf
    # and layer
    port_tree = tfm.params_from_numpy(trees[arch], cfg, device="cpu")
    from repro_torch.train.tree import tree_paths

    ref_at = {jax.tree_util.keystr(p): i for i, (p, _) in enumerate(paths)}
    checked = 0
    for leaf, path in enumerate(tree_paths(port_tree)):
        parts = path.split("]")
        if path.startswith("['layers']"):
            layer = int(parts[1].strip("["))
            rpath = "['layers']" + "]".join(parts[2:])
        else:
            layer, rpath = None, path
        i = ref_at[rpath]
        for out in ranks4:
            coord = str(list(out["coord"]))
            sl = index[i][coord]
            full = ref_leaves[i]
            if layer is not None:
                assert all(a == 0 and b == n for (a, b), n in zip(
                    sl[:lead], full.shape[:lead]))  # layers replicated
                full = full.reshape((-1,) + full.shape[lead:])[layer]
                sl = sl[lead:]
            want = full[tuple(slice(a, b) for a, b in sl)]
            np.testing.assert_array_equal(out["blocks"][arch][leaf], want)
            checked += 1
    assert checked == 4 * len(tree_paths(port_tree))


@pytest.mark.parametrize("shape", [(1, 2), (2, 2), (1, 4)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("arch", LM_ARCHS)
def test_lm_on_a_mesh_equals_one_device(ranks2, ranks4, arch, shape):
    got = (ranks2 if shape == (1, 2) else ranks4)
    with use_mesh_rules({"data": shape[0], "model": 1}):
        want = _lm_run(arch)
    for r in got:
        mine = r[("lm", shape, arch)]
        torch.testing.assert_close(torch.from_numpy(mine["logits"]),
                                   torch.from_numpy(want["logits"]))
        torch.testing.assert_close(torch.tensor(mine["loss"]),
                                   torch.tensor(want["loss"]))
        torch.testing.assert_close(torch.tensor(mine["aux"]),
                                   torch.tensor(want["aux"]))
        assert len(mine["grads"]) == len(want["grads"])
        for a, b in zip(mine["grads"], want["grads"]):
            torch.testing.assert_close(torch.from_numpy(a),
                                       torch.from_numpy(b))


@pytest.mark.parametrize("case", [((1, 2), "tinyllama-1.1b"),
                                  ((1, 2), "granite-moe-3b-a800m"),
                                  ((2, 2), "tinyllama-1.1b"),
                                  ((2, 2), "granite-moe-3b-a800m"),
                                  ((1, 4), "tinyllama-1.1b")],
                         ids=lambda c: f"{c[0][0]}x{c[0][1]}-{c[1]}")
def test_decode_on_a_split_cache_equals_one_device(ranks2, ranks4, case):
    shape, arch = case
    got = ranks2 if shape == (1, 2) else ranks4
    with use_mesh_rules({"data": shape[0], "model": 1}):
        pre, logits, toks = _serve_run(arch)
    for r in got:
        p, lg, tk = r[("serve", shape, arch)]
        torch.testing.assert_close(torch.from_numpy(p), torch.from_numpy(pre))
        torch.testing.assert_close(torch.from_numpy(lg),
                                   torch.from_numpy(logits))
        assert np.array_equal(tk, toks)


@pytest.mark.parametrize("shape", [(2, 1), (2, 2)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("case", list(MOE_CASES))
def test_moe_block_on_a_mesh_is_the_reference(ranks2, ranks4, reference,
                                              shape, case):
    ref = reference["moe"][case][f"{shape[0]}x{shape[1]}"]
    got = ranks2 if shape == (2, 1) else ranks4
    dropped = 0
    for rank, r in enumerate(got):
        mine = r[("moe", shape)][case]
        data = rank // shape[1]
        # one binning pass a rank: its data shard's tokens
        assert len(mine["seen"]) == 1
        ids, keep = mine["seen"][0]
        r_ids, r_keep = ref["shards"][data]
        assert np.array_equal(ids, np.asarray(r_ids))
        assert np.array_equal(keep, np.asarray(r_keep))
        dropped += int((~keep).sum())
        torch.testing.assert_close(torch.from_numpy(mine["out"]),
                                   torch.tensor(ref["out"]))
        torch.testing.assert_close(torch.tensor(mine["aux"]),
                                   torch.tensor(ref["aux"]))
    assert (dropped > 0) == (case == "drops")


def _gnn_reference(arch):
    import jax

    from repro.models import gnn as r_gnn
    from repro_torch.models import gnn
    from test_torch_gnn import _case, _params

    name, binned = arch.split("/")[0], arch.endswith("binned")
    rc, _, rb, pb, _, _ = _case(name)
    rp, _ = _params(rc)
    if binned:
        rc = dataclasses.replace(rc, binned_edges=True)
        sb = gnn.bin_edges_by_stripe(pb, 2)
        rb = dataclasses.replace(rb, edge_src=sb.edge_src.numpy(),
                                 edge_dst=sb.edge_dst.numpy(),
                                 edge_mask=sb.edge_mask.numpy())
    return np.asarray(r_gnn.gnn_forward(rp, jax.tree.map(np.asarray, rb),
                                        rc))


@pytest.mark.parametrize("arch", GNN_ARCHS + ["graphsage-reddit/binned"])
def test_gnn_on_a_mesh_is_the_reference(ranks2, arch):
    want = torch.from_numpy(_gnn_reference(arch))
    for r in ranks2:
        torch.testing.assert_close(torch.from_numpy(r["gnn"][arch]), want,
                                   **GNN_TOL)


def test_bert4rec_on_a_mesh_equals_one_device(ranks4):
    with use_mesh_rules({"data": 2, "model": 2}):
        want = _b4_run()
    for r in ranks4:
        for a, b in zip(r["b4"], want):
            assert np.array_equal(a, b)
