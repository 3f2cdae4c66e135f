"""Port parity of the tuner (``repro_torch.tune`` against ``repro.tune``)
and of the cache model it prunes with (``repro_torch.core.cache_model``).

The port's trials run on ``device="cpu"`` here.  Held against the
reference: the candidate lists and keys of every budget (the reference's
dense-bin name ``"pallas"`` is the port's ``"cuda"``), the cache model's
counters (exactly equal), the analytic prune, and plan resolution from a
DB the reference's tuner wrote.  The tuner may change *where time goes*,
never *what comes out*: ``"auto"`` equals the schedule / impl it resolves
to bit for bit on the CPU, and the flat baseline at ``rtol = atol = 2e-5``
(the reference's tolerance for the same check, fp32 sums in another
order); PageRank ranks (~1/n) at ``atol=1e-7``, as the reference's test.
"""
import dataclasses
import json
import os
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import repro.core as R
import repro.tune as RT
from repro.configs.graphcage import DEFAULT as REF_CFG
from repro.core.cache_model import CacheConfig as RefCacheConfig
from repro.core.cache_model import simulate_pagerank_variant as ref_simulate
import repro_torch.core as T
from repro_torch.configs.graphcage import DEFAULT as CFG
from repro_torch.core.cache_model import CacheConfig, simulate_pagerank_variant
from repro_torch.resilience import degrade
from repro_torch.tune import (
    BUDGETS, Candidate, SearchSpace, Trial, default_candidate, device_key,
    entry_key, resolve_alpha, resolve_impl, resolve_plan, resolve_schedule,
    tune,
)
from repro_torch.tune import analytic, db as tune_db, plan as tune_plan, runner
from repro_torch.tune.space import WORKLOADS

ROOT = Path(__file__).resolve().parents[1]
DEV = "cpu"


def _clear():
    for mod in (tune_plan, analytic, runner):
        mod.clear_cache()
    from repro.tune import analytic as ra, plan as rp, runner as rr

    for mod in (rp, ra, rr):
        mod.clear_cache()
    degrade.clear()


@pytest.fixture
def tune_dir(tmp_path, monkeypatch):
    """Isolated DB dir + cold caches (both packages), restored afterwards."""
    monkeypatch.setenv("REPRO_TUNE_DIR", str(tmp_path))
    _clear()
    yield tmp_path
    _clear()


def hub_graph(lib, n=512, deg=8, hubs=4, seed=0):
    """Scale-free caricature: most edges point at a few hub destinations."""
    rng = np.random.default_rng(seed)
    src = np.repeat(np.arange(n), deg)
    dst = np.where(rng.random(src.shape[0]) < 0.7,
                   rng.integers(0, hubs, src.shape[0]),
                   rng.integers(0, n, src.shape[0]))
    keep = src != dst
    vals = rng.random(int(keep.sum()), dtype=np.float32)
    return lib.from_edges(n, src[keep], dst[keep], vals=vals, dedup=True)


def _ref_key(key: str) -> str:
    return key.replace("pallas", "cuda")


# --------------------------- fingerprints --------------------------- #

def test_fingerprint_equals_reference_and_propagates():
    a1 = T.rmat_graph(8, 8, seed=3, weights=True)
    assert T.graph_fingerprint(a1) == R.graph_fingerprint(
        R.rmat_graph(8, 8, seed=3, weights=True))
    assert T.graph_fingerprint(a1) != T.graph_fingerprint(
        T.rmat_graph(8, 8, seed=4, weights=True))
    assert T.graph_fingerprint(a1) == T.graph_fingerprint(
        T.rmat_graph(8, 8, seed=3, weights=False))
    assert T.DeviceGraph.from_host(a1, device=DEV).fingerprint == \
        T.graph_fingerprint(a1)
    assert T.build_blocked(a1, block_size=64, device=DEV).fingerprint == \
        T.graph_fingerprint(a1)


# ------------------------------- DB -------------------------------- #

def test_db_roundtrip(tune_dir):
    path = tune_db.db_path()
    key = entry_key("deadbeefdeadbeef", DEV, workload="pagerank")
    entry = {"schema": tune_db.DB_SCHEMA, "graph": "toy",
             "chosen": default_candidate().to_json(), "best_us": 12.5}
    tune_db.put_entry(key, entry, path)
    tune_db.clear_cache()
    got = tune_db.get_entry(key, path)
    assert got["graph"] == "toy" and got["best_us"] == 12.5
    assert Candidate.from_json(got["chosen"]) == default_candidate()
    on_disk = json.loads(Path(path).read_text())
    assert on_disk["schema"] == tune_db.DB_SCHEMA == RT.DB_SCHEMA
    # the reference reads the port's file
    assert RT.db.get_entry(key, path)["graph"] == "toy"


def test_db_read_takes_no_fingerprint(tune_dir, monkeypatch):
    """Reading a DB that does not exist (the first ``"auto"`` lookup)
    starts no ``nvidia-smi``: the run fingerprint is taken at the first
    save, which stamps it into the file."""
    from repro_torch.obs import export as obs_export

    def no_fingerprint():
        raise AssertionError("a read took the run fingerprint")

    monkeypatch.setattr(obs_export, "run_fingerprint", no_fingerprint)
    path = tune_db.db_path(str(tune_dir))
    assert tune_db.load(path) == {"schema": tune_db.DB_SCHEMA,
                                  "entries": {}}
    assert tune_db.get_entry("k", path) is None
    assert resolve_plan(T.build_blocked(T.rmat_graph(6, 4, seed=1),
                                        block_size=16, device=DEV)) is None
    monkeypatch.setattr(obs_export, "run_fingerprint", lambda: {"fp": 1})
    tune_db.put_entry("k", {"chosen": Candidate().to_json()}, path)
    on_disk = json.loads(Path(path).read_text())
    assert on_disk["fingerprint"] == {"fp": 1}
    assert on_disk["schema"] == tune_db.DB_SCHEMA and "k" in on_disk["entries"]


def test_db_schema_mismatch_quarantined(tune_dir):
    path = tune_db.db_path()
    tune_db.save({"schema": "repro.tune.db/v999", "entries": {}}, path)
    tune_db.clear_cache()
    db = tune_db.load(path)
    assert db["entries"] == {} and db["schema"] == tune_db.DB_SCHEMA
    assert any(".corrupt-" in n for n in os.listdir(os.path.dirname(path)))


def test_entry_key_shape():
    assert device_key("cpu") == "cpu"
    k = entry_key("abc123", device_key("cpu"), dtype="float32",
                  workload="spmv")
    assert k == "abc123/cpu/float32/spmv"
    assert k == RT.entry_key("abc123", "cpu", dtype="float32",
                             workload="spmv")


# --------------------------- search space --------------------------- #

def test_candidates_valid_and_unique():
    space = SearchSpace()
    for wl in WORKLOADS:
        cands = space.candidates(wl)
        assert len(cands) == len(set(cands))
        for c in cands:
            if c.engine == "cb":
                assert c.direction == "pull" and c.schedule == "uniform"
            if wl == "bfs":
                assert c.direction == "pull"
            if c.schedule == "balanced":
                assert c.engine == "tocab"
            assert c == Candidate.from_json(c.to_json())
    with pytest.raises(ValueError):
        space.candidates("nope")


def test_budget_presets():
    assert set(BUDGETS) == {"smoke", "small", "full"}
    for name, b in BUDGETS.items():
        assert dataclasses.asdict(b) == dataclasses.asdict(RT.BUDGETS[name])
    smoke = SearchSpace.for_budget("smoke")
    assert len(smoke.candidates("pagerank")) <= BUDGETS["smoke"].max_trials
    with pytest.raises(ValueError):
        SearchSpace.for_budget("huge")


@pytest.mark.parametrize("budget", sorted(BUDGETS))
@pytest.mark.parametrize("with_cfg", [False, True], ids=["bare", "cfg"])
def test_candidates_and_keys_equal_reference(budget, with_cfg):
    port = SearchSpace.for_budget(budget, CFG if with_cfg else None)
    ref = RT.SearchSpace.for_budget(budget, REF_CFG if with_cfg else None)
    for wl in WORKLOADS:
        got = [c.key() for c in port.candidates(wl)]
        want = [_ref_key(c.key()) for c in ref.candidates(wl)]
        assert got == want
    assert dataclasses.asdict(default_candidate()) == dataclasses.asdict(
        RT.default_candidate())


def test_pallas_entry_reads_as_the_default():
    c = Candidate.from_json(dict(Candidate(schedule="balanced").to_json(),
                                 dense_impl="pallas"))
    assert c.dense_impl is None
    assert Candidate.from_json(dict(c.to_json(), dense_impl="onehot")
                               ).dense_impl == "onehot"


UNREAD_FIELDS = {"tune_db_dir", "retry_attempts", "retry_base_delay",
                 "trial_timeout_s", "allow_engine_fallback"}


def test_config_is_the_references_but_for_the_window():
    """The reference's fields and values, but for the card's window budget
    and the five fields nothing reads (their values in the docstring)."""
    port, ref = dataclasses.asdict(CFG), dataclasses.asdict(REF_CFG)
    assert set(ref) - set(port) == UNREAD_FIELDS
    assert set(port) <= set(ref)
    differ = {k for k in port if port[k] != ref[k]}
    assert differ == {"fast_mem_bytes"}
    assert CFG.fast_mem_bytes == T.partition.L2_WINDOW_BYTES
    import repro_torch.configs.graphcage as cfg_mod

    doc = " ".join(cfg_mod.__doc__.split())
    for k in UNREAD_FIELDS:
        assert f"``{k}`` ({ref[k]!r}" in doc


# --------------------------- cache model --------------------------- #

@pytest.mark.parametrize("scale", [8, 9, 10])
@pytest.mark.parametrize("variant", ["base", "cb", "tocab", "fused"])
def test_cache_model_counters_equal_reference(scale, variant):
    g_port = T.rmat_graph(scale, 8, seed=scale, weights=True)
    g_ref = R.rmat_graph(scale, 8, seed=scale, weights=True)
    for kb, block in ((8, 128), (64, None)):
        got = simulate_pagerank_variant(
            g_port, variant, CacheConfig(capacity_bytes=kb * 1024),
            block_size=block)
        want = ref_simulate(g_ref, variant,
                            RefCacheConfig(capacity_bytes=kb * 1024),
                            block_size=block)
        assert got == want


# --------------------------- analytic prune --------------------------- #

def test_analytic_prune_partitions_candidates(tune_dir):
    g = T.rmat_graph(9, 8, seed=1, weights=True)
    cands = SearchSpace().candidates("pagerank")
    kept, pruned = analytic.prune(g, cands, prune_ratio=1.0)
    assert sorted(kept + pruned, key=cands.index) == cands
    assert kept  # the best-scoring group always survives
    loose_kept, _ = analytic.prune(g, cands, prune_ratio=1e9)
    assert len(loose_kept) == len(cands)


@pytest.mark.parametrize("ratio", [1.0, 2.0])
def test_analytic_prune_equals_reference(tune_dir, ratio):
    g = T.rmat_graph(9, 8, seed=1, weights=True)
    rg = R.rmat_graph(9, 8, seed=1, weights=True)
    from repro.tune import analytic as ra

    for wl in WORKLOADS:
        kept, pruned = analytic.prune(
            g, SearchSpace().candidates(wl), prune_ratio=ratio)
        rkept, rpruned = ra.prune(
            rg, RT.SearchSpace().candidates(wl), prune_ratio=ratio)
        assert [c.key() for c in kept] == [c.key() for c in rkept]
        assert [c.key() for c in pruned] == [c.key() for c in rpruned]


# ------------------------- end-to-end tuning ------------------------- #

def _tiny_space():
    return SearchSpace(engines=("base", "tocab"), directions=("pull",),
                       schedules=("uniform", "balanced"), block_sizes=(128,))


def test_tune_twice_hits_db(tune_dir):
    g = T.rmat_graph(9, 8, seed=5, weights=True)
    first = tune({"toy": g}, workloads=("pagerank",), budget="smoke",
                 space=_tiny_space(), device=DEV)
    assert first["new_trials"] > 0 and first["db_hits"] == 0
    second = tune({"toy": g}, workloads=("pagerank",), budget="smoke",
                  space=_tiny_space(), device=DEV)
    assert second["new_trials"] == 0
    assert second["db_hits"] == len(second["entries"]) == 1
    entry = second["entries"][0]
    assert entry["schema"] == tune_db.DB_SCHEMA
    assert entry["graph_fp"] == T.graph_fingerprint(g)
    assert entry["device_kind"] == "cpu"
    trial = Trial.from_json(entry["trials"][0])
    assert trial.us > 0 and trial.workload == "pagerank"


def _force_plan(g, candidate, workload="pagerank"):
    """Write a DB entry by hand — the read path must honour whatever the
    tuner (or an operator) persisted, so tests can pin the winner."""
    key = entry_key(T.graph_fingerprint(g), DEV, workload=workload)
    tune_db.put_entry(key, {"schema": tune_db.DB_SCHEMA, "graph": "forced",
                            "chosen": candidate.to_json(), "best_us": 1.0},
                      tune_db.db_path())
    tune_plan.clear_cache()


@pytest.mark.parametrize("make_graph", [
    lambda: T.rmat_graph(9, 8, seed=2, weights=True),
    lambda: hub_graph(T),
], ids=["random", "hub"])
def test_auto_matches_baseline(tune_dir, make_graph):
    g = make_graph()
    dg = T.DeviceGraph.from_host(g, device=DEV)
    bg = T.build_blocked(g, block_size=128, device=DEV)
    _force_plan(g, Candidate(engine="tocab", schedule="balanced",
                             block_size=128))
    assert resolve_schedule(bg) == "balanced"
    rank_auto, it_auto = T.pagerank(dg, bg, variant="gc-pull",
                                    schedule="auto")
    rank_res, it_res = T.pagerank(dg, bg, variant="gc-pull",
                                  schedule="balanced")
    # bit-for-bit: auto IS the resolved schedule, not a reimplementation
    assert torch.equal(rank_auto, rank_res) and it_auto == it_res
    rank_base, _ = T.pagerank(dg, None, variant="base")
    torch.testing.assert_close(rank_auto, rank_base, rtol=0, atol=1e-7)
    x = torch.from_numpy(np.random.default_rng(0).random(g.n,
                                                         dtype=np.float32))
    torch.testing.assert_close(T.spmv(dg, bg, x, schedule="auto"),
                               T.baseline_pull(dg, x), rtol=2e-5, atol=2e-5)


def test_auto_without_db_is_uniform(tune_dir):
    g = T.rmat_graph(8, 8, seed=6, weights=True)
    bg = T.build_blocked(g, block_size=64, device=DEV)
    assert resolve_plan(bg) is None
    assert resolve_schedule(bg) == "uniform" and resolve_impl(bg) == "slab"
    assert resolve_alpha(bg) == 15.0
    x = torch.ones(g.n)
    assert torch.equal(T.tocab_pull(bg, x, schedule="auto", impl="auto"),
                       T.tocab_pull(bg, x))


def test_plan_cache_invalidates_on_db_rewrite(tune_dir):
    g = T.rmat_graph(8, 8, seed=7, weights=True)
    bg = T.build_blocked(g, block_size=64, device=DEV)
    assert resolve_schedule(bg) == "uniform"  # cached miss
    _force_plan(g, Candidate(engine="tocab", schedule="balanced",
                             block_size=64))
    assert resolve_schedule(bg) == "balanced"


def test_flat_winner_pins_uniform(tune_dir):
    g = T.rmat_graph(8, 8, seed=8, weights=True)
    bg = T.build_blocked(g, block_size=64, device=DEV)
    _force_plan(g, Candidate(engine="base", direction="pull"))
    assert resolve_schedule(bg) == "uniform" and resolve_impl(bg) == "slab"


def test_sibling_workload_borrowed(tune_dir):
    g = T.rmat_graph(8, 8, seed=9, weights=True)
    bg = T.build_blocked(g, block_size=64, device=DEV)
    _force_plan(g, Candidate(engine="tocab", schedule="balanced",
                             block_size=64), workload="spmv")
    plan = resolve_plan(bg, workload="pagerank")
    assert plan is not None and plan.source == "db:spmv"
    assert resolve_schedule(bg, workload="pagerank") == "balanced"


def test_plans_are_keyed_by_the_device(tune_dir):
    """A layout on the CPU reads the ``cpu`` entries only: a plan tuned on
    the card (or on the reference's TPU) does not apply to it."""
    g = T.rmat_graph(8, 8, seed=10, weights=True)
    bg = T.build_blocked(g, block_size=64, device=DEV)
    key = entry_key(T.graph_fingerprint(g), "nvidia-h100-80gb-hbm3")
    tune_db.put_entry(key, {"chosen": Candidate(
        engine="tocab", impl="fused").to_json()})
    tune_plan.clear_cache()
    assert resolve_plan(bg) is None
    assert resolve_plan(bg, device="cpu") is None
    assert resolve_plan(g, device="cpu") is None


def test_shared_db_written_by_the_reference(tune_dir):
    """The reference's tuner writes the DB (CPU, its own trials); the
    port's resolvers read it and answer as the reference's do, and its
    layout builder takes the same tuned block size."""
    from repro.tune import plan as rplan

    graphs = {"hub": (hub_graph(R), hub_graph(T))}
    space = RT.SearchSpace(engines=("base", "tocab"), directions=("pull",),
                           schedules=("uniform", "balanced"),
                           block_sizes=(64,), alphas=(4.0, 15.0))
    RT.tune({k: v[0] for k, v in graphs.items()},
            workloads=("pagerank", "spmv", "bfs"), budget="smoke",
            space=space)
    assert RT.device_key() == device_key("cpu")
    for name, (rg, g) in graphs.items():
        rbg = R.build_blocked(rg, block_size=64)
        bg = T.build_blocked(g, block_size=64, device=DEV)
        for wl in WORKLOADS:
            want, got = rplan.resolve_plan(rbg, wl), resolve_plan(bg, wl)
            assert want is not None and got is not None
            assert got.candidate.key() == want.candidate.key()
            assert got.source == want.source
            assert resolve_schedule(bg, wl) == rplan.resolve_schedule(rbg,
                                                                      wl)
            assert resolve_impl(bg, wl) == rplan.resolve_impl(rbg, wl)
            assert resolve_alpha(bg, wl) == rplan.resolve_alpha(rbg, wl)
            want_bg = rplan.blocked_for(rg, wl)
            got_bg = tune_plan.blocked_for(g, wl, device=DEV)
            assert got_bg.block_size == want_bg.block_size
            assert got_bg.num_blocks == want_bg.num_blocks


def test_shared_db_pallas_entry_maps_to_the_default(tune_dir):
    """A reference entry whose balanced dense bin says ``"pallas"`` runs
    the device's default dense implementation in the port."""
    g = hub_graph(T)
    key = entry_key(T.graph_fingerprint(g), DEV, workload="spmv")
    chosen = RT.Candidate(engine="tocab", schedule="balanced",
                          dense_impl="pallas", block_size=128)
    RT.db.put_entry(key, {"schema": RT.DB_SCHEMA,
                          "chosen": chosen.to_json(), "best_us": 1.0},
                    RT.db.db_path())
    tune_plan.clear_cache()
    bg = T.build_blocked(g, block_size=128, bin_thresholds="auto",
                         device=DEV)
    plan = resolve_plan(bg, "spmv")
    assert plan.candidate.dense_impl is None
    assert plan.candidate.schedule == "balanced"
    dg = T.DeviceGraph.from_host(g, device=DEV)
    x = torch.ones(g.n)
    assert torch.equal(T.spmv(dg, bg, x, schedule="auto"),
                       T.spmv(dg, bg, x, schedule="balanced"))


def _explicit(g, c: Candidate, workload: str, auto: bool):
    """Run ``workload`` on the layout the candidate names, with its
    schedule / impl / α given explicitly, or as ``"auto"``."""
    dg, bg = runner.build_for(g, c, DEV)
    variant = runner._pr_variant(c)
    kw = (dict(schedule="auto", impl="auto") if auto
          else dict(schedule=c.schedule, impl=c.impl))
    if workload == "pagerank":
        return T.pagerank(dg, bg, variant=variant, **kw)[0]
    if workload == "spmv":
        x = torch.from_numpy(np.random.default_rng(4).random(
            g.n, dtype=np.float32))
        return T.spmv(dg, bg, x, variant=variant, **kw)
    alpha = None if auto else c.alpha
    return T.bfs(dg, bg, 0, alpha=alpha, **kw)[0]


def test_auto_equals_the_chosen_candidate(tune_dir):
    """After a sweep, ``"auto"`` runs exactly the chosen candidate's
    schedule, impl and α on its layout (bit-equal on the CPU)."""
    g = hub_graph(T)
    space = SearchSpace(engines=("tocab",), directions=("pull",),
                        schedules=("uniform", "balanced"),
                        block_sizes=(64, 128), alphas=(4.0, 15.0))
    summary = tune({"hub": g}, workloads=WORKLOADS, budget="smoke",
                   space=space, device=DEV)
    for entry in summary["entries"]:
        c = Candidate.from_json(entry["chosen"])
        got = _explicit(g, c, entry["workload"], auto=True)
        want = _explicit(g, c, entry["workload"], auto=False)
        assert torch.equal(got, want), (entry["workload"], c.key())


# hypothesis is an optional dev dependency; only this test skips without it.
try:
    from hypothesis import given, settings, strategies as st
except ImportError:
    st = None

if st is not None:
    @st.composite
    def small_graph(draw):
        n = draw(st.integers(8, 128))
        m = draw(st.integers(4, 400))
        seed = draw(st.integers(0, 2**31 - 1))
        rng = np.random.default_rng(seed)
        src, dst = rng.integers(0, n, m), rng.integers(0, n, m)
        keep = src != dst
        if not keep.any():
            src, dst = np.array([0]), np.array([1])
            keep = np.array([True])
        vals = rng.random(int(keep.sum()), dtype=np.float32)
        return T.from_edges(n, src[keep], dst[keep], vals=vals, dedup=True)

    @given(g=small_graph(), forced=st.sampled_from(["uniform", "balanced"]),
           impl=st.sampled_from(["slab", "fused"]))
    @settings(max_examples=15, deadline=None)
    def test_auto_equals_baseline(tmp_path_factory, g, forced, impl):
        """∀ graph, ∀ persisted winner: ``"auto"`` ≡ the flat baseline."""
        tmp = tmp_path_factory.mktemp("tunedb")
        old = os.environ.get("REPRO_TUNE_DIR")
        os.environ["REPRO_TUNE_DIR"] = str(tmp)
        try:
            tune_plan.clear_cache()
            bg = T.build_blocked(g, block_size=32, device=DEV)
            chosen = Candidate(engine="tocab", schedule=forced, block_size=32,
                               impl=impl if forced == "uniform" else "slab")
            _force_plan(g, chosen)
            dg = T.DeviceGraph.from_host(g, device=DEV)
            x = torch.linspace(0.0, 1.0, g.n)
            out = T.tocab_pull(bg, x, schedule="auto", impl="auto")
            torch.testing.assert_close(out, T.baseline_pull(dg, x),
                                       rtol=2e-5, atol=2e-5)
        finally:
            tune_plan.clear_cache()
            if old is None:
                os.environ.pop("REPRO_TUNE_DIR", None)
            else:
                os.environ["REPRO_TUNE_DIR"] = old
else:
    @pytest.mark.skip(reason="hypothesis not installed "
                             "(pip install -r requirements-dev.txt)")
    def test_auto_equals_baseline():
        pass


# ------------------------------- CLI -------------------------------- #

def test_cli_tune_show_apply(tune_dir, capsys):
    from repro_torch.tune.__main__ import main

    assert main(["tune", "--trials-budget", "smoke", "--device", "cpu",
                 "--db-dir", str(tune_dir)]) == 0
    out = capsys.readouterr().out
    assert "rmat14/pagerank:" in out and "1 entries" in out
    assert main(["show", "--db-dir", str(tune_dir)]) == 0
    assert "rmat14" in capsys.readouterr().out
    assert main(["apply", "--json", "--db-dir", str(tune_dir)]) == 0
    picked = json.loads(capsys.readouterr().out)
    assert list(picked) == ["rmat14/pagerank"]
    entry = next(iter(tune_db.load(tune_db.db_path(str(tune_dir)))
                      ["entries"].values()))
    assert entry["device_kind"] == "cpu"


def test_suite_is_the_references():
    """The tuner's suite builds the reference benchmarks' graphs."""
    sys.path.insert(0, str(ROOT))
    try:
        from benchmarks.common import SUITE as REF_SUITE
    finally:
        sys.path.remove(str(ROOT))
    from repro_torch.tune.suite import SMOKE_GRAPH, SUITE

    assert sorted(SUITE) == sorted(REF_SUITE) and SMOKE_GRAPH == "rmat14"
    for name in ("rmat14", "grid256"):
        g, rg = SUITE[name](), REF_SUITE[name]()
        assert T.graph_fingerprint(g) == R.graph_fingerprint(rg)
        np.testing.assert_array_equal(g.vals, rg.vals)


# ------------------------------ the card ------------------------------- #

@pytest.mark.cuda
def test_cuda_tune_keys_by_the_card(tmp_path):
    """On the card: entries carry the card's name, trials launch the fused
    kernels, and ``"auto"`` on a card layout reads the card's plan."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from repro_torch.kernels import cuda_build

    g = T.rmat_graph(12, 8, seed=3, weights=True)
    cuda_build.reset_launches()
    space = SearchSpace(engines=("tocab",), directions=("pull",),
                        schedules=("uniform",), block_sizes=(1024,))
    s = tune({"g": g}, workloads=("pagerank",), budget="smoke", space=space,
             db_dir=str(tmp_path))
    entry = s["entries"][0]
    name = torch.cuda.get_device_name(0).strip().replace(" ", "-").lower()
    assert entry["device_kind"] == name == device_key()
    assert cuda_build.launches.get("fused_pull", 0) >= 1
    _clear()
    os.environ["REPRO_TUNE_DIR"] = str(tmp_path)
    try:
        bg = T.build_blocked(g, block_size=1024)
        assert resolve_plan(bg) is not None
        assert resolve_plan(bg, device="cpu") is None
    finally:
        os.environ.pop("REPRO_TUNE_DIR")
        _clear()
