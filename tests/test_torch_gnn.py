"""Port parity of the GNN slice (``repro_torch.models.gnn``,
``repro_torch.data.graphs``, ``repro_torch.data.sampler``) against the
reference package.

The four GNNs run on the reference's parameters (``init_gnn``, carried
across by ``params_from_numpy``) and the reference's batches (carried
across field by field): forward output, loss and every gradient leaf
against ``jax.value_and_grad`` of ``repro.models.gnn.gnn_loss_fn``, fp32
on the CPU, at ``rtol = atol = 1e-4`` (the port's fp32 model tolerance:
sums in another order), with ``bg=None`` (flat segment reduce) and with a
BlockedGraph (the TOCAB slab engines).  The data generators and the
sampler give the reference's batches element for element,
``build_triplets`` its arrays, and a max reduce splits its gradient among
tied entries as JAX's does.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.configs import get_arch
from repro_torch.core import build_blocked, from_edges
from repro_torch.core.tocab import segment_reduce, tocab_edge_reduce
from repro_torch.data import graphs as G
from repro_torch.data.sampler import NeighborSampler
from repro_torch.models import gnn
from repro_torch.train.tree import tree_leaves, tree_unflatten

TOL = dict(rtol=1e-4, atol=1e-4)
FIELDS = [f.name for f in dataclasses.fields(gnn.GraphBatch)]


def _port_batch(rb) -> gnn.GraphBatch:
    """The reference's GraphBatch as the port's, field for field."""
    return gnn.GraphBatch(**{
        f: None if getattr(rb, f) is None
        else torch.from_numpy(np.array(getattr(rb, f))) for f in FIELDS})


def _assert_batches_equal(pb, rb):
    for f in FIELDS:
        a, b = getattr(pb, f), getattr(rb, f)
        assert (a is None) == (b is None), f
        if a is not None:
            b = np.asarray(b)
            assert a.dtype == torch.from_numpy(np.array(b)).dtype, f
            np.testing.assert_array_equal(a.cpu().numpy(), b, err_msg=f)


def _case(arch):
    """(ref cfg, port cfg, ref batch, port batch, ref graph, port graph):
    the smoke config on a small graph of its regime."""
    from repro.configs import get_arch as r_get_arch
    from repro.core.graph import from_edges as r_from_edges
    from repro.data import graphs as RG

    rc, pc = r_get_arch(arch).make_smoke_cfg(), get_arch(arch).make_smoke_cfg()
    assert dataclasses.asdict(rc) == dataclasses.asdict(pc)
    if arch == "dimenet":
        rb = RG.molecule_batch(n_graphs=4, nodes_per=10, d_feat=rc.d_in,
                               seed=1, cutoff=1.5, triplet_cap=4)
        src, dst = np.asarray(rb.edge_src), np.asarray(rb.edge_dst)
        n = rb.node_feat.shape[0]
        rg, pg = r_from_edges(n, src, dst), from_edges(n, src, dst)
        # the batch's edges are in the graph's CSR order (TOCAB's edge_perm)
        np.testing.assert_array_equal(pg.edges()[0], src)
        np.testing.assert_array_equal(pg.edges()[1], dst)
    else:
        rg, rb = RG.cora_like(n=150, m=600, d_feat=rc.d_in,
                              n_classes=rc.n_classes, seed=2)
        src, dst = rg.edges()
        pg = from_edges(rg.n, src, dst)
    return rc, pc, rb, _port_batch(rb), rg, pg


def _params(rc, seed=0):
    from repro.models import gnn as r_gnn

    rp = r_gnn.init_gnn(jax.random.PRNGKey(seed), rc)
    return rp, gnn.params_from_numpy(jax.tree.map(np.asarray, rp),
                                     device="cpu")


@pytest.mark.parametrize("blocked", [False, True])
@pytest.mark.parametrize("arch", ["gat-cora", "gin-tu", "graphsage-reddit",
                                  "dimenet"])
def test_gnn_loss_and_grads_match_reference(arch, blocked):
    from repro.core.partition import build_blocked as r_build_blocked
    from repro.models import gnn as r_gnn

    rc, pc, rb, pb, rg, pg = _case(arch)
    rp, pp = _params(rc)
    block = 16 if arch == "dimenet" else 64  # 40 or 150 nodes
    rbg = r_build_blocked(rg, block_size=block) if blocked else None
    pbg = build_blocked(pg, block_size=block, device="cpu") if blocked \
        else None
    if blocked:
        assert pbg.num_blocks > 1

    torch.testing.assert_close(
        gnn.gnn_forward(pp, pb, pc, bg=pbg),
        torch.from_numpy(np.array(r_gnn.gnn_forward(rp, rb, rc, bg=rbg))),
        **TOL)
    (rloss, rm), rgrads = jax.value_and_grad(
        lambda p: r_gnn.gnn_loss_fn(p, rb, rc, bg=rbg), has_aux=True)(rp)
    leaves = [x.clone().requires_grad_() for x in tree_leaves(pp)]
    live = tree_unflatten(pp, leaves)
    ploss, pm = gnn.gnn_loss_fn(live, pb, pc, bg=pbg)
    ploss.backward()
    torch.testing.assert_close(ploss.detach(), torch.tensor(float(rloss)),
                               **TOL)
    for k in pm:
        torch.testing.assert_close(pm[k].detach(), torch.tensor(float(rm[k])),
                                   **TOL)
    ref_leaves = jax.tree.leaves(rgrads)
    assert len(ref_leaves) == len(leaves)
    nonzero = 0
    for x, r in zip(leaves, ref_leaves):
        assert x.grad is not None
        torch.testing.assert_close(x.grad, torch.from_numpy(np.array(r)),
                                   **TOL)
        nonzero += int(bool(x.grad.abs().sum() > 0))
    assert nonzero >= len(leaves) - 1  # GIN's eps may see a zero gradient


@pytest.mark.parametrize("arch", ["gat-cora", "gin-tu", "dimenet"])
def test_padded_edges_are_dropped_as_the_reference_drops_them(arch):
    """Five padded edges (``src = dst = n``, masked out) appended to the
    batch and three real edges masked out (GraphSAGE's neighbour sum is
    GIN's): the loss and every gradient
    equal the reference's, whose gathers clamp and whose segment
    reductions drop the out-of-range ids."""
    from repro.models import gnn as r_gnn

    rc, pc, rb, _, _, _ = _case(arch)
    n, pad = rb.node_feat.shape[0], 5
    mask = rb.edge_mask.at[:3].set(False)
    rb = dataclasses.replace(
        rb, edge_src=jnp.concatenate([rb.edge_src, jnp.full(pad, n,
                                                            jnp.int32)]),
        edge_dst=jnp.concatenate([rb.edge_dst, jnp.full(pad, n, jnp.int32)]),
        edge_mask=jnp.concatenate([mask, jnp.zeros(pad, bool)]))
    pb = _port_batch(rb)
    rp, pp = _params(rc)
    (rloss, _), rgrads = jax.value_and_grad(
        lambda p: r_gnn.gnn_loss_fn(p, rb, rc), has_aux=True)(rp)
    leaves = [x.clone().requires_grad_() for x in tree_leaves(pp)]
    ploss, _ = gnn.gnn_loss_fn(tree_unflatten(pp, leaves), pb, pc)
    ploss.backward()
    torch.testing.assert_close(ploss.detach(), torch.tensor(float(rloss)),
                               **TOL)
    for x, r in zip(leaves, jax.tree.leaves(rgrads)):
        torch.testing.assert_close(x.grad, torch.from_numpy(np.array(r)),
                                   **TOL)


def test_data_batches_equal_the_reference():
    from repro.data import graphs as RG

    rg, rb = RG.cora_like(n=300, m=1000, d_feat=12, n_classes=5, seed=3)
    pg, pb = G.cora_like(n=300, m=1000, d_feat=12, n_classes=5, seed=3,
                         device="cpu")
    np.testing.assert_array_equal(pg.colidx, rg.colidx)
    _assert_batches_equal(pb, rb)
    _, rb = RG.reddit_like(scale=8, edge_factor=4, d_feat=6, n_classes=3,
                           seed=1)
    _, pb = G.reddit_like(scale=8, edge_factor=4, d_feat=6, n_classes=3,
                          seed=1, device="cpu")
    _assert_batches_equal(pb, rb)
    _, rb = RG.products_like(scale=8, edge_factor=3, d_feat=5, n_classes=4)
    _, pb = G.products_like(scale=8, edge_factor=3, d_feat=5, n_classes=4,
                            device="cpu")
    _assert_batches_equal(pb, rb)
    rb = RG.molecule_batch(n_graphs=6, nodes_per=8, d_feat=3, seed=2)
    pb = G.molecule_batch(n_graphs=6, nodes_per=8, d_feat=3, seed=2,
                          device="cpu")
    _assert_batches_equal(pb, rb)
    rb = RG.graph_to_batch(rg, 4, 3, seed=5, with_positions=True,
                           triplet_cap=3)
    pb = G.graph_to_batch(pg, 4, 3, seed=5, with_positions=True,
                          triplet_cap=3, device="cpu")
    _assert_batches_equal(pb, rb)


def test_sampler_batches_equal_the_reference():
    from repro.core.graph import rmat_graph as r_rmat
    from repro.data.sampler import NeighborSampler as RSampler

    g = r_rmat(9, 4, seed=2)
    rng = np.random.default_rng(0)
    feats = rng.standard_normal((g.n, 5)).astype(np.float32)
    labels = rng.integers(0, 3, g.n)
    from repro_torch.core.graph import rmat_graph

    pg = rmat_graph(9, 4, seed=2)
    rs = RSampler(g, feats, labels, sample_sizes=(4, 3), seed=7)
    ps = NeighborSampler(pg, feats, labels, sample_sizes=(4, 3), seed=7,
                         device="cpu")
    for _ in range(2):
        _assert_batches_equal(ps.sample(16), rs.sample(16))
    assert NeighborSampler.batch_shapes(16, (4, 3), 5) == \
        RSampler.batch_shapes(16, (4, 3), 5)


@pytest.mark.parametrize("cap", [0, 2])
def test_build_triplets_equals_the_reference(cap):
    from repro.models.gnn import build_triplets as r_build

    rng = np.random.default_rng(4)
    src = rng.integers(0, 40, 200).astype(np.int32)
    dst = rng.integers(0, 40, 200).astype(np.int32)
    for a, b in zip(gnn.build_triplets(src, dst, 40, cap_per_edge=cap,
                                       seed=3),
                    r_build(src, dst, 40, cap_per_edge=cap, seed=3)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("reduce", ["max", "min"])
def test_extremum_reduce_splits_ties_as_jax(reduce):
    """A graph with duplicate edges and tied values: the gradient of the
    flat segment reduce and of the TOCAB edge reduce (whose ties also meet
    across blocks in the phase-3 reduction) equals JAX's."""
    from repro.core.graph import from_edges as r_from_edges
    from repro.core.partition import build_blocked as r_build_blocked
    from repro.core.tocab import tocab_edge_reduce as r_edge_reduce

    src = np.array([0, 0, 1, 2, 2, 3, 4, 5, 5, 6, 7, 7], np.int64)
    dst = np.array([1, 1, 2, 1, 1, 1, 3, 3, 3, 0, 0, 0], np.int64)
    n = 8
    rg = r_from_edges(n, src, dst)
    pg = from_edges(n, src, dst)
    vals = np.array([[1., 2.], [1., 2.], [3., 0.], [1., 2.], [0., 2.],
                     [1., -1.], [5., 5.], [5., 4.], [5., 5.], [2., 2.],
                     [2., 1.], [2., 2.]], np.float32)
    w = np.arange(1, 2 * n + 1, dtype=np.float32).reshape(n, 2)
    ids = pg.colidx.astype(np.int64)

    def jax_grad(fn):
        return np.array(jax.grad(lambda v: (fn(v) * w).sum())(
            jnp.asarray(vals)))

    def port_grad(fn):
        t = torch.from_numpy(vals.copy()).requires_grad_()
        (fn(t) * torch.from_numpy(w)).sum().backward()
        return t.grad

    seg = jax.ops.segment_max if reduce == "max" else jax.ops.segment_min
    ref = jax_grad(lambda v: seg(v, jnp.asarray(ids), n))
    got = port_grad(lambda t: segment_reduce(t, torch.from_numpy(ids), n,
                                             reduce))
    torch.testing.assert_close(got, torch.from_numpy(ref))
    assert bool((got != 0).sum() > 0) and set(np.unique(ref)) - {0} != set()
    rbg = r_build_blocked(rg, block_size=2)
    pbg = build_blocked(pg, block_size=2, device="cpu")
    ref = jax_grad(lambda v: r_edge_reduce(rbg, v, reduce=reduce))
    got = port_grad(lambda t: tocab_edge_reduce(pbg, t, reduce=reduce))
    torch.testing.assert_close(got, torch.from_numpy(ref))
