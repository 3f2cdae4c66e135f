"""Port parity: host graphs, validation and the TOCAB layout.

The generators of ``repro_torch`` must give the reference's CSR arrays and
fingerprint, and its ``build_blocked`` every ``BlockedGraph`` field of the
reference's, slot for slot (the layout is integer data: equality is exact).
"""
import dataclasses

import numpy as np
import pytest
import torch

import repro.core as R
import repro_torch.core as T

ARRAY_FIELDS = ("window_idx", "compact_idx", "edge_mask", "id_map",
                "n_local", "n_edges", "edge_perm", "edge_vals", "n_window")
META_FIELDS = ("n", "m", "direction", "block_size", "num_blocks",
               "edge_budget", "local_budget", "fingerprint")


def hub_graph(mod, n=256):
    """Everything points at a few hubs — extreme compaction ratio (the
    push hub case of tests/test_fused.py)."""
    src = np.concatenate([np.arange(1, n), np.arange(n)])
    dst = np.concatenate([np.zeros(n - 1, np.int64), (np.arange(n) + 1) % n])
    keep = src != dst
    vals = np.random.default_rng(4).random(int(keep.sum()), dtype=np.float32)
    return mod.from_edges(n, src[keep], dst[keep], vals=vals, dedup=True)


def balmix_graph(mod, n=2048, deg=8, seed=0):
    """Mixed-density graph shaped like benchmarks.common.balance_mix_graph."""
    rng = np.random.default_rng(seed)
    q = n // 4
    srcs, dsts = [], []
    for lo, hi, pool in ((0, q, 16), (q, 2 * q, 256), (2 * q, n, n)):
        src = np.repeat(np.arange(lo, hi), deg)
        srcs.append(src)
        dsts.append(rng.integers(0, pool, src.shape[0]))
    src, dst = np.concatenate(srcs), np.concatenate(dsts)
    keep = src != dst
    vals = rng.random(int(keep.sum()), dtype=np.float32)
    return mod.from_edges(n, src[keep], dst[keep], vals=vals, dedup=True)


GRAPHS = {
    "rmat9": lambda mod: mod.rmat_graph(9, 8, seed=7, weights=True),
    "rmat10u": lambda mod: mod.rmat_graph(10, 8, seed=3, undirected=True),
    "rmat11": lambda mod: mod.rmat_graph(11, 16, seed=1, weights=True),
    # 163,840 edges: 2.5 of the port generator's parallel chunks
    "rmat13": lambda mod: mod.rmat_graph(13, 20, seed=4, weights=True),
    "uniform": lambda mod: mod.uniform_random_graph(700, 5000, seed=5,
                                                    weights=True),
    "grid": lambda mod: mod.grid_graph(24, 17),
    "balmix": balmix_graph,
    "hub": hub_graph,
}


def assert_same_csr(a, b):
    assert a.n == b.n
    for name in ("rowptr", "colidx", "vals"):
        x, y = getattr(a, name), getattr(b, name)
        if x is None:
            assert y is None, name
            continue
        assert x.dtype == y.dtype and np.array_equal(x, y), name


def assert_same_blocked(ref, port):
    for name in META_FIELDS:
        assert getattr(ref, name) == getattr(port, name), name
    for name in ARRAY_FIELDS:
        x, y = getattr(ref, name), getattr(port, name)
        if x is None:
            assert y is None, name
            continue
        x, y = np.asarray(x), y.cpu().numpy()
        assert x.dtype == y.dtype and x.shape == y.shape, name
        assert np.array_equal(x, y), name
    if ref.schedule is None:
        assert port.schedule is None
    else:
        assert dataclasses.asdict(ref.schedule) == \
            dataclasses.asdict(port.schedule)


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_generators_equal_reference(name):
    ref, port = GRAPHS[name](R), GRAPHS[name](T)
    assert_same_csr(ref, port)
    assert R.graph_fingerprint(ref) == T.graph_fingerprint(port)
    assert_same_csr(ref.transpose(), port.transpose())


@pytest.mark.parametrize("direction", ["pull", "push"])
@pytest.mark.parametrize("name,block_size", [
    ("rmat9", 128), ("rmat10u", 100), ("rmat11", 256), ("rmat11", None),
    ("grid", 64), ("balmix", 64), ("hub", 64), ("uniform", 128),
])
def test_build_blocked_equals_reference(name, block_size, direction):
    g_ref, g_port = GRAPHS[name](R), GRAPHS[name](T)
    kw = dict(block_size=block_size, direction=direction)
    assert_same_blocked(R.build_blocked(g_ref, **kw),
                        T.build_blocked(g_port, device="cpu", **kw))


@pytest.mark.parametrize("kw", [
    dict(classify=False), dict(bin_thresholds="auto"),
    dict(bin_thresholds=(2.0, 8.0), pad_edges_to=32, pad_locals_to=16),
], ids=["unclassified", "auto-bins", "pads"])
def test_build_blocked_options_equal_reference(kw):
    g_ref, g_port = GRAPHS["balmix"](R), GRAPHS["balmix"](T)
    for direction in ("pull", "push"):
        assert_same_blocked(
            R.build_blocked(g_ref, block_size=128, direction=direction, **kw),
            T.build_blocked(g_port, block_size=128, direction=direction,
                            device="cpu", **kw))


def test_empty_and_tiny_graphs():
    for n, src, dst in ((8, [], []), (8, [0, 1], [2, 2]), (1, [], [])):
        g_ref, g_port = (mod.from_edges(n, np.array(src, np.int64),
                                        np.array(dst, np.int64))
                         for mod in (R, T))
        assert_same_csr(g_ref, g_port)
        for direction in ("pull", "push"):
            assert_same_blocked(
                R.build_blocked(g_ref, block_size=4, direction=direction),
                T.build_blocked(g_port, block_size=4, direction=direction,
                                device="cpu"))


def test_blocked_from_arrays_round_trip():
    g = GRAPHS["rmat9"](R)
    for direction in ("pull", "push"):
        ref = R.build_blocked(g, block_size=128, direction=direction)
        arrays = {f: getattr(ref, f) for f in ARRAY_FIELDS}
        meta = {f: getattr(ref, f) for f in META_FIELDS}
        meta["schedule"] = dataclasses.asdict(ref.schedule)
        port = T.blocked_from_arrays(arrays, meta, device="cpu")
        assert_same_blocked(ref, port)
        assert isinstance(port.schedule, T.BlockSchedule)


def test_device_graph_equals_reference():
    g_ref, g_port = GRAPHS["rmat9"](R), GRAPHS["rmat9"](T)
    ref = R.DeviceGraph.from_host(g_ref)
    port = T.DeviceGraph.from_host(g_port, device="cpu")
    assert port.n == ref.n and port.m == ref.m
    assert port.fingerprint == ref.fingerprint
    for name in ("src", "dst", "rowptr", "out_degree", "in_degree", "vals"):
        x, y = np.asarray(getattr(ref, name)), getattr(port, name).numpy()
        assert x.dtype == y.dtype and np.array_equal(x, y), name
    arrays = {f: np.asarray(getattr(ref, f)) for f in
              ("src", "dst", "rowptr", "out_degree", "in_degree", "vals")}
    again = T.device_graph_from_arrays(
        arrays, {"n": ref.n, "fingerprint": ref.fingerprint}, device="cpu")
    for name in arrays:
        assert torch.equal(getattr(again, name), getattr(port, name)), name
    # a hand-built DeviceGraph is hashed on the fly, to the same string
    bare = dataclasses.replace(port, fingerprint=None)
    assert T.graph_fingerprint(bare) == R.graph_fingerprint(g_ref)


def _invalid_graphs(mod):
    g = mod.rmat_graph(6, 4, seed=18)
    bad_mono = g.rowptr.copy()
    bad_mono[2] = bad_mono[1] - 1
    bad_mono[-1] = g.m  # keep the total right so monotonicity is what trips
    return {
        "rowptr_shape": mod.Graph(g.n, g.rowptr[:-1], g.colidx),
        "rowptr_origin": mod.Graph(
            g.n, np.concatenate([[1], g.rowptr[1:]]), g.colidx),
        "rowptr_total": mod.Graph(
            g.n, np.concatenate([g.rowptr[:-1], [g.m + 3]]), g.colidx),
        "rowptr_monotone": mod.Graph(g.n, bad_mono, g.colidx),
        "rowptr_dtype": mod.Graph(g.n, g.rowptr.astype(np.float64),
                                  g.colidx),
        "colidx_range": mod.Graph(g.n, g.rowptr,
                                  np.full_like(g.colidx, g.n)),
        "vals_length": mod.Graph(g.n, g.rowptr, g.colidx,
                                 vals=np.ones(g.m + 1, np.float32)),
        "n_negative": mod.Graph(-1, np.zeros(0, np.int64),
                                np.zeros(0, np.int32)),
    }


@pytest.mark.parametrize("level", ["cheap", "full"])
def test_validation_checks_fire_the_same(level):
    from repro.core.graph import GraphValidationError as RefError, \
        validate_graph as ref_validate

    ref_cases, port_cases = _invalid_graphs(R), _invalid_graphs(T)
    assert sorted(ref_cases) == sorted(port_cases)
    for check in ref_cases:
        with pytest.raises(RefError) as want:
            ref_validate(ref_cases[check], level)
        with pytest.raises(T.GraphValidationError) as got:
            T.validate_graph(port_cases[check], level)
        assert got.value.check == want.value.check == check
        assert str(got.value) == str(want.value)
    good = GRAPHS["rmat9"](T)
    assert T.validate_graph(good, level) is good and good.validate(level)


def test_coo_and_build_validation():
    from repro.core.graph import GraphValidationError as RefError

    for bad in (([0, 9], [1, 2]), ([0, 1], [1, -1])):
        with pytest.raises(RefError) as want:
            R.from_edges(4, *bad, validate="cheap")
        with pytest.raises(T.GraphValidationError) as got:
            T.from_edges(4, *bad, validate="cheap")
        assert got.value.check == want.value.check == "coo_range"
    with pytest.raises(T.GraphValidationError) as got:
        T.from_edges(4, [0, 1], [1])
    assert got.value.check == "coo_shape"
    bad = _invalid_graphs(T)["colidx_range"]
    with pytest.raises(T.GraphValidationError):
        T.build_blocked(bad, block_size=32, validate="full", device="cpu")
    with pytest.raises(ValueError, match="direction"):
        T.build_blocked(GRAPHS["rmat9"](T), direction="sideways",
                        device="cpu")


def test_choose_block_size_targets_h100_l2():
    """The default window is half the H100's 50 MB L2 (25 MiB of fp32),
    not the reference's 4 MB of TPU VMEM; small graphs get one block."""
    from repro_torch.core.partition import L2_WINDOW_BYTES

    assert L2_WINDOW_BYTES == 25 * 1024 * 1024
    assert T.choose_block_size(1 << 24) == 6_553_600
    assert T.choose_block_size(1 << 24, value_bytes=8) == 3_276_800
    assert T.choose_block_size(1000) == 1024
    # an explicit budget reproduces the reference's sizing rule
    for n in (100, 5000, 1 << 22):
        assert T.choose_block_size(n, fast_mem_bytes=4 << 20) == \
            R.choose_block_size(n)
