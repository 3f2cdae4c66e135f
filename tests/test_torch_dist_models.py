"""The models' mesh-aware paths of the port.

* ``bert4rec_score`` under ``use_mesh_rules`` with a ``model`` axis of 4
  takes the two-stage top-k: ids and values equal to the reference's
  ``distributed_topk`` applied to the same scores (bf16 products cast to
  fp32: ties are frequent, and they come in ``lax.top_k``'s order), and
  equal off a mesh in values (``torch.topk`` there).
* ``_binned_segment_sum`` under the stripe contract: on a 2-rank gloo
  group, values and ids as DTensors sharded over ``data``, the ranks'
  stripes put together are the flat ``segment_reduce`` (exactly for
  integer-valued sums, ``assert_close`` at fp32 defaults otherwise) with
  no collective; the plain-tensor form under ``{"data": 2}`` and ``4``
  likewise, and a value outside its stripe dropped as the reference's
  ``shard_map`` drops it; off a mesh the flat reduce.
* The GNNs with ``binned_edges`` / ``binned_triplets`` off a mesh against
  the reference's forward with the same config.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.dist.collectives import distributed_topk as r_topk
from repro_torch.configs import get_arch
from repro_torch.core import tocab
from repro_torch.dist.collectives import stable_topk
from repro_torch.dist.sharding import use_mesh_rules
from repro_torch.models import bert4rec as B4
from repro_torch.models import gnn
from test_torch_gnn import TOL, _case, _params
from test_torch_sharding import FakeMesh, run_ranks


def test_bert4rec_score_on_a_mesh_is_the_two_stage_topk(monkeypatch):
    cfg = B4.Bert4RecCfg(**{**dataclasses.asdict(
        get_arch("bert4rec").make_smoke_cfg()), "vocab": 1000})
    params = B4.init_bert4rec(cfg, torch.Generator().manual_seed(0),
                              device="cpu")
    items = torch.from_numpy(np.random.default_rng(1).integers(
        1, cfg.vocab, (6, cfg.max_len)).astype(np.int32))
    items[:, -1] = cfg.mask_id
    seen = {}
    real = B4.distributed_topk

    def spy(scores, k, mesh, axis="model"):
        seen["scores"] = scores.clone()
        return real(scores, k, mesh, axis)

    monkeypatch.setattr(B4, "distributed_topk", spy)
    with use_mesh_rules({"data": 1, "model": 4}):
        v, i = B4.bert4rec_score(params, items, cfg, top_k=50)
    scores = seen["scores"]
    assert scores.shape == (6, 1000)
    rv, ri = r_topk(jnp.asarray(scores.numpy()), 50, FakeMesh(data=1,
                                                              model=4))
    assert np.array_equal(v.numpy(), np.asarray(rv))
    assert np.array_equal(i.numpy(), np.asarray(ri))
    # ties are there, and they come lower id first
    sv, si = stable_topk(scores, 50)
    assert torch.equal(v, sv) and torch.equal(i, si)
    assert any(len(set(row.tolist())) < 50 for row in v)
    # off a mesh: the same values through torch.topk
    seen.clear()
    v0, _ = B4.bert4rec_score(params, items, cfg, top_k=50)
    assert not seen and torch.equal(v0, v)


def _stripe_case(n_out=32, shards=4, per=16, d=3, integer=False, seed=0):
    """Values whose destinations lie in their block's stripe."""
    rng = np.random.default_rng(seed)
    stripe = n_out // shards
    seg = np.concatenate([rng.integers(s * stripe, (s + 1) * stripe, per)
                          for s in range(shards)]).astype(np.int32)
    if integer:
        val = rng.integers(-50, 50, (shards * per, d)).astype(np.float32)
    else:
        val = rng.standard_normal((shards * per, d)).astype(np.float32)
    return torch.from_numpy(val), torch.from_numpy(seg)


def _flat(val, seg, n_out):
    return tocab.segment_reduce(val, seg, n_out, "sum")


def _binned_worker(rank, world):
    from torch.distributed.tensor import (DTensor, Replicate, Shard,
                                          distribute_tensor)

    from repro_torch.dist.elastic import make_mesh_for

    mesh = make_mesh_for()
    out = {}
    for integer in (True, False):
        val, seg = _stripe_case(shards=world, integer=integer)
        dv = distribute_tensor(val, mesh, [Shard(0), Replicate()])
        ds = distribute_tensor(seg, mesh, [Shard(0), Replicate()])
        got = gnn._binned_segment_sum(dv, ds, 32)
        assert isinstance(got, DTensor)
        out[integer] = got.to_local().numpy()
    return out


def test_binned_segment_sum_is_stripe_local_on_two_ranks(tmp_path):
    results = run_ranks(_binned_worker, 2, tmp_path)
    for integer in (True, False):
        val, seg = _stripe_case(shards=2, integer=integer)
        want = _flat(val, seg, 32)
        got = torch.from_numpy(np.concatenate([r[integer] for r in results]))
        assert results[0][integer].shape == (16, 3)
        if integer:
            assert torch.equal(got, want)
        else:
            torch.testing.assert_close(got, want)


@pytest.mark.parametrize("shards", [2, 4])
def test_binned_segment_sum_plain_form_equals_flat(shards):
    val, seg = _stripe_case(shards=4, integer=True)
    with use_mesh_rules({"data": shards, "model": 1}):
        got = gnn._binned_segment_sum(val, seg, 32)
    assert torch.equal(got, _flat(val, seg, 32))
    ref = jax.ops.segment_sum(jnp.asarray(val.numpy()),
                              jnp.asarray(seg.numpy()), num_segments=32)
    assert np.array_equal(got.numpy(), np.asarray(ref))


def test_binned_segment_sum_drops_values_outside_their_stripe():
    val, seg = _stripe_case(shards=2, integer=True)
    seg = seg.clone()
    seg[0] = 20  # block 0's value sent to stripe 1
    with use_mesh_rules({"data": 2}):
        got = gnn._binned_segment_sum(val, seg, 32)
    keep = torch.ones(len(seg), dtype=torch.bool)
    keep[0] = False
    assert torch.equal(got, _flat(val[keep], seg[keep], 32))
    # off a mesh, and where the shapes do not divide: the flat reduce
    assert torch.equal(gnn._binned_segment_sum(val, seg, 32),
                       _flat(val, seg, 32))
    with use_mesh_rules({"data": 3}):
        assert torch.equal(gnn._binned_segment_sum(val, seg, 32),
                           _flat(val, seg, 32))


@pytest.mark.parametrize("arch", ["gat-cora", "gin-tu", "graphsage-reddit",
                                  "dimenet"])
def test_binned_configs_off_a_mesh_match_the_reference(arch):
    from repro.models import gnn as r_gnn

    rc, pc, rb, pb, _, _ = _case(arch)
    rc = dataclasses.replace(rc, binned_edges=True, binned_triplets=True)
    pc = dataclasses.replace(pc, binned_edges=True, binned_triplets=True)
    rp, pp = _params(rc)
    torch.testing.assert_close(
        gnn.gnn_forward(pp, pb, pc),
        torch.from_numpy(np.array(r_gnn.gnn_forward(rp, rb, rc))), **TOL)
