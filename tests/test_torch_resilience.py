"""Port parity of the resilience layer (``repro_torch.resilience`` against
``repro.resilience``): chaos injection, retry / timeout policies, the
degradation ladder and the serving retry.

The invariant, as in the reference: faults change *where the work runs*
(ladder rung, retry attempt), never *what comes out* — a fallback result
is bit-equal to the engine it lands on (torch ops on the CPU are
deterministic), and a retried serving step gives bit-equal tokens.

Where the port deliberately differs, the difference is asserted: the
ladder arms only on an explicit ``allow_fallback=True``, and only for
values on the CPU.  ``impl="auto"``, the ``REPRO_RESILIENCE_FALLBACK``
environment variable and ``dense_impl=None`` arm nothing, so without the
opt-in a fault raises; on the card it raises with the opt-in too (the
``cuda`` test).  An argument refusal is no fault: it propagates and
demotes nothing.  On the card a tuner trial's failure poisons its
candidate only when it is an argument refusal of a candidate that launches
no kernel.
"""
import dataclasses
import time

import numpy as np
import pytest
import torch

import repro.resilience.chaos as ref_chaos
import repro.resilience.degrade as ref_degrade
import repro.resilience.retry as ref_retry
import repro_torch.core as T
from repro_torch.core import balance
from repro_torch.obs.metrics import registry as _obs
from repro_torch.resilience import chaos, degrade
from repro_torch.resilience.chaos import ChaosError
from repro_torch.resilience.retry import Policy, call_with_timeout, retry
from repro_torch.tune import db as tune_db
from repro_torch.tune import plan as tune_plan
from repro_torch.tune import analytic, runner, tuner
from repro_torch.tune.space import Candidate, SearchSpace, TrialBudget


@pytest.fixture(autouse=True)
def clean_resilience(monkeypatch, tmp_path):
    """Each test starts with chaos disarmed in both packages (even under a
    chaos run's environment: these tests inject their own faults), no
    memoized verdicts, and an empty tuning DB of its own."""
    for var in (chaos.ENV_SPEC, chaos.ENV_SITES, ref_degrade.ENV_FALLBACK):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("REPRO_TUNE_DIR", str(tmp_path / "tune"))
    for mod in (chaos, ref_chaos):
        mod.reset()
    degrade.clear()
    tune_plan.clear_cache()
    yield
    for mod in (chaos, ref_chaos):
        mod.reset()
    degrade.clear()
    tune_plan.clear_cache()


def small_graph(seed=0, scale=7):
    return T.rmat_graph(scale, 6, seed=seed, weights=True)


def layouts(seed, block_size=32):
    g = small_graph(seed)
    return (g, T.DeviceGraph.from_host(g, device="cpu"),
            T.build_blocked(g, block_size=block_size, device="cpu"),
            T.build_blocked(g, block_size=block_size, direction="push",
                            device="cpu"))


def fallbacks(site, frm, to, error="ChaosError"):
    return _obs.counter("resilience.fallbacks").value(
        site=site, error=error, **{"from": frm, "to": to})


# ------------------------------ chaos -------------------------------- #

def _pattern(mod, seed, site="s", draws=200):
    mod.reset()
    mod.configure(seed=seed, rate=0.3, sites={site})
    fired = []
    for _ in range(draws):
        try:
            mod.maybe_raise(site)
            fired.append(False)
        except mod.ChaosError:
            fired.append(True)
    mod.reset()
    return fired


def test_chaos_deterministic_by_seed():
    """Same seed → same fault pattern; different seed → different one; and
    the port draws exactly the reference's faults."""
    p7a, p7b, p8 = (_pattern(chaos, 7), _pattern(chaos, 7),
                    _pattern(chaos, 8))
    assert p7a == p7b
    assert p7a != p8
    assert 20 < sum(p7a) < 100  # rate 0.3 over 200 draws
    for seed in (7, 8, 1234):
        assert _pattern(chaos, seed, "kernel.tocab_fused") == \
            _pattern(ref_chaos, seed, "kernel.tocab_fused")


def test_chaos_spec_and_env_parsing(monkeypatch):
    cfg = chaos.configure_spec("42:0.5")
    assert (cfg.seed, cfg.rate) == (42, 0.5)
    assert cfg.sites == chaos.DEFAULT_SITES
    assert chaos.enabled()
    chaos.reset()

    monkeypatch.setenv(chaos.ENV_SPEC, "99:0.25")
    monkeypatch.setenv(chaos.ENV_SITES, "a,b")
    chaos.reset()  # force env re-read
    assert chaos.enabled()
    assert chaos.active_for("a") and chaos.active_for("b")
    assert not chaos.active_for("kernel.tocab_fused")

    monkeypatch.setenv(chaos.ENV_SPEC, "nonsense")
    chaos.reset()
    with pytest.raises(ValueError, match="REPRO_CHAOS"):
        chaos.enabled()


def test_chaos_inject_queue():
    chaos.inject("q", times=2)
    for _ in range(2):
        with pytest.raises(ChaosError):
            chaos.maybe_raise("q")
    chaos.maybe_raise("q")  # queue drained, rate not armed

    class Boom(RuntimeError):
        pass

    chaos.inject("q", exc=Boom("custom"))
    with pytest.raises(Boom):
        chaos.maybe_raise("q")


def test_sites_are_the_references():
    """The same named sites, and rate-based injection at the sites without
    a recovery path stays opt-in."""
    assert chaos.KNOWN_SITES == ref_chaos.KNOWN_SITES
    assert chaos.DEFAULT_SITES == ref_chaos.DEFAULT_SITES
    assert (chaos.ENV_SPEC, chaos.ENV_SITES) == (ref_chaos.ENV_SPEC,
                                                 ref_chaos.ENV_SITES)
    for site in ("kernel.tocab_slab", "tune.trial",
                 "kernel.tocab_fused.op", "kernel.tocab_spmm.op"):
        assert site not in chaos.DEFAULT_SITES
        assert site in chaos.KNOWN_SITES


# --------------------------- retry / timeout --------------------------- #

def test_retry_recovers_and_counts():
    calls = []

    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise OSError("transient")
        return "ok"

    pol = Policy(max_attempts=3, base_delay=0.001)
    before = _obs.counter("resilience.retries").value(
        site="t", error="OSError")
    assert pol.call(flaky, site="t") == "ok"
    assert len(calls) == 3
    assert _obs.counter("resilience.retries").value(
        site="t", error="OSError") == before + 2


def test_retry_exhaustion_reraises():
    pol = Policy(max_attempts=2, base_delay=0.001)
    before = _obs.counter("resilience.retry_exhausted").value(site="x")
    with pytest.raises(OSError, match="always"):
        pol.call(lambda: (_ for _ in ()).throw(OSError("always")), site="x")
    assert _obs.counter("resilience.retry_exhausted").value(
        site="x") == before + 1


def test_retry_does_not_catch_unlisted():
    pol = Policy(max_attempts=5, base_delay=0.001, retry_on=(OSError,))
    calls = []

    def bug():
        calls.append(1)
        raise ValueError("logic bug, not transient")

    with pytest.raises(ValueError):
        pol.call(bug, site="y")
    assert len(calls) == 1  # no retries for non-transient errors


def test_retry_decorator():
    state = {"n": 0}

    @retry(site="deco", max_attempts=2, base_delay=0.001)
    def fn(x):
        state["n"] += 1
        if state["n"] == 1:
            raise OSError
        return x + 1

    assert fn(1) == 2
    assert fn.policy.max_attempts == 2


def test_call_with_timeout():
    assert call_with_timeout(lambda: 5, None) == 5
    assert call_with_timeout(lambda: 5, 10.0) == 5
    with pytest.raises(TimeoutError):
        call_with_timeout(time.sleep, 0.05, 0.3)
    with pytest.raises(ZeroDivisionError):  # worker errors re-raise
        call_with_timeout(lambda: 1 / 0, 10.0)


@pytest.mark.parametrize("site", ["s", "serve.batch", "tune.db_save"])
def test_deterministic_jitter_equals_reference(site):
    pol, ref = Policy(base_delay=0.05), ref_retry.Policy(base_delay=0.05)
    assert pol.delay(site, 1) == pol.delay(site, 1)
    assert pol.delay(site, 1) != pol.delay(site, 2)
    for attempt in range(4):
        assert pol.delay(site, attempt) == ref.delay(site, attempt)


# -------------------------- degradation ladder -------------------------- #

def test_fallback_allowed_is_explicit_only(monkeypatch):
    """The port's opt-in: only ``True`` arms the ladder, and only for the
    CPU.  The reference also arms it for ``"auto"`` and under its
    environment variable."""
    assert degrade.fallback_allowed(True, "cpu") is True
    assert degrade.fallback_allowed(True, torch.device("cpu")) is True
    for device in ("cuda", "cuda:0", torch.device("cuda", 0), "meta"):
        assert degrade.fallback_allowed(True, device) is False
    assert degrade.fallback_allowed(False, "cpu") is False
    assert degrade.fallback_allowed(None, "cpu") is False
    assert ref_degrade.fallback_allowed("auto", None) is True
    monkeypatch.setenv(ref_degrade.ENV_FALLBACK, "1")
    assert ref_degrade.fallback_allowed("fused", None) is True
    assert degrade.fallback_allowed(None, "cpu") is False
    assert degrade.LADDER == ref_degrade.LADDER


@pytest.mark.parametrize("err", [ValueError, NotImplementedError])
def test_dispatch_lets_argument_refusals_through(err):
    """A rung that refuses its arguments raises to the caller: no
    fallback, no verdict, so the next valid call starts at the top."""
    before = fallbacks("s", "fused", "slab", error=err.__name__)

    def refuse():
        raise err("bad argument")

    with pytest.raises(err):
        degrade.dispatch("s", "fp", [("fused", refuse),
                                     ("slab", lambda: "slab")])
    assert fallbacks("s", "fused", "slab", error=err.__name__) == before
    assert degrade.apply_verdict("fp", "s", "fused") == "fused"
    assert degrade.dispatch("s", "fp", [("fused", lambda: "fused"),
                                        ("slab", lambda: "slab")]) == "fused"


def test_refused_engine_call_does_not_demote_the_next():
    """An opted-in call the fused rung refuses for its own arguments (an
    epilogue outside the sum semiring) raises and leaves the graph's
    verdict alone: the next valid opted-in call runs fused."""
    g, _, pull, _ = layouts(17)
    x = torch.ones(g.n)
    eng = _obs.counter("tocab.engine_traces")
    with pytest.raises(ValueError):
        T.tocab_pull(pull, x, reduce="max", impl="fused",
                     epilogue=(2.0, 0.0), allow_fallback=True)
    assert degrade.apply_verdict(pull.fingerprint, "tocab_pull",
                                 "fused") == "fused"
    f0 = eng.value(engine="tocab_pull_fused", direction="pull")
    got = T.tocab_pull(pull, x, impl="fused", allow_fallback=True)
    assert eng.value(engine="tocab_pull_fused", direction="pull") == f0 + 1
    assert torch.equal(got, T.tocab_pull(pull, x, impl="fused"))


def _engine_call(engine, g, pull, push):
    x = torch.from_numpy(
        np.random.default_rng(0).random(g.n, dtype=np.float32))
    if engine == "tocab_pull":
        return lambda **kw: T.tocab_pull(pull, x, **kw)
    if engine == "tocab_push":
        return lambda **kw: T.tocab_push(push, x, **kw)
    ev = torch.from_numpy(np.random.default_rng(1).random(g.m,
                                                          dtype=np.float32))
    return lambda **kw: T.tocab_edge_reduce(pull, ev, **kw)


ENGINES = ["tocab_pull", "tocab_push", "tocab_edge_reduce"]


@pytest.mark.parametrize("engine", ENGINES)
def test_fused_fallback_bit_identical_and_memoized(engine):
    g, _, pull, push = layouts(11)
    call = _engine_call(engine, g, pull, push)
    want = call(impl="slab")

    before = fallbacks(engine, "fused", "slab")
    chaos.inject("kernel.tocab_fused")
    got = call(impl="fused", allow_fallback=True)
    assert torch.equal(got, want)
    assert fallbacks(engine, "fused", "slab") == before + 1

    # the verdict is memoized for this (graph, site): a later opted-in
    # call starts at slab (the queue is empty: fused would have run)
    fused = _obs.counter("tocab.engine_traces").value(
        engine=f"{engine}_fused", direction=pull.direction
        if engine != "tocab_push" else "push")
    assert degrade.apply_verdict(pull.fingerprint, engine,
                                 "fused") == "slab"
    assert torch.equal(call(impl="fused", allow_fallback=True), want)
    assert fallbacks(engine, "fused", "slab") == before + 1
    assert _obs.counter("tocab.engine_traces").value(
        engine=f"{engine}_fused", direction=pull.direction
        if engine != "tocab_push" else "push") == fused
    degrade.clear()
    call(impl="fused", allow_fallback=True)  # fused runs again
    assert _obs.counter("tocab.engine_traces").value(
        engine=f"{engine}_fused", direction=pull.direction
        if engine != "tocab_push" else "push") == fused + 1


@pytest.mark.parametrize("engine", ENGINES)
def test_ladder_reaches_reference(engine):
    g, _, pull, push = layouts(12)
    call = _engine_call(engine, g, pull, push)
    want = call(impl="slab")
    direction = "push" if engine == "tocab_push" else "pull"
    eng = _obs.counter("tocab.engine_traces")
    r0 = eng.value(engine=f"{engine}_reference", direction=direction)
    chaos.inject("kernel.tocab_fused")
    chaos.inject("kernel.tocab_slab")
    got = call(impl="fused", allow_fallback=True)
    assert torch.equal(got, want)
    assert eng.value(engine=f"{engine}_reference",
                     direction=direction) == r0 + 1
    assert fallbacks(engine, "slab", "reference") >= 1
    # impl="reference" runs the last rung directly, with no opt-in
    assert torch.equal(call(impl="reference"), want)
    assert eng.value(engine=f"{engine}_reference",
                     direction=direction) == r0 + 2


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("opt", [None, False])
def test_no_fallback_without_opt_in(engine, opt, monkeypatch):
    """A fault raises unless ``allow_fallback=True``: ``None`` and
    ``False`` do, and so does the reference's environment variable."""
    g, _, pull, push = layouts(13)
    call = _engine_call(engine, g, pull, push)
    monkeypatch.setenv(ref_degrade.ENV_FALLBACK, "1")
    before = fallbacks(engine, "fused", "slab")
    chaos.inject("kernel.tocab_fused")
    with pytest.raises(ChaosError):
        call(impl="fused", allow_fallback=opt)
    assert fallbacks(engine, "fused", "slab") == before


def _force_plan(g, cand, workload="pagerank"):
    key = tune_db.entry_key(T.graph_fingerprint(g), "cpu",
                            workload=workload)
    tune_db.put_entry(key, {"chosen": cand.to_json(), "workload": workload})
    tune_plan.clear_cache()


def test_pagerank_auto_does_not_arm_the_ladder():
    """``impl="auto"`` resolved to fused by the DB: a fault at the fused
    dispatch raises (the reference degrades here); with
    ``allow_fallback=True`` the run completes, bit-equal to slab, with one
    fallback: the verdict pins every later iteration to slab."""
    g = small_graph(seed=14, scale=8)
    dg = T.DeviceGraph.from_host(g, device="cpu")
    bg = T.build_blocked(g, block_size=64, device="cpu")
    _force_plan(g, Candidate(engine="tocab", direction="pull",
                             schedule="uniform", impl="fused",
                             block_size=64))
    want, it_want = T.pagerank(dg, bg, impl="slab", max_iters=30)

    chaos.configure(seed=5, rate=1.0, sites={"kernel.tocab_fused"})
    with pytest.raises(ChaosError):
        T.pagerank(dg, bg, impl="auto", max_iters=30)
    before = fallbacks("tocab_pull", "fused", "slab")
    got, it_got = T.pagerank(dg, bg, impl="auto", max_iters=30,
                             allow_fallback=True)
    assert torch.equal(got, want) and it_got == it_want
    assert fallbacks("tocab_pull", "fused", "slab") == before + 1
    series = _obs.snapshot()["resilience.fallbacks"]["series"]
    assert any(s["labels"].get("site") == "tocab_pull" and
               s["labels"].get("from") == "fused" for s in series)


def test_ladder_result_matches_reference():
    """The slab rung a fault lands on computes the reference's slab
    result (fp32 sums in another order: ``assert_close`` defaults)."""
    import jax.numpy as jnp
    import repro.core as R

    g = R.rmat_graph(7, 6, seed=15, weights=True)
    rbg = R.build_blocked(g, block_size=32)
    bg = T.build_blocked(T.rmat_graph(7, 6, seed=15, weights=True),
                         block_size=32, device="cpu")
    x = np.random.default_rng(2).random(g.n, dtype=np.float32)
    want = np.array(R.tocab_pull(rbg, jnp.asarray(x), impl="slab"))
    chaos.inject("kernel.tocab_fused")
    got = T.tocab_pull(bg, torch.from_numpy(x), impl="fused",
                       allow_fallback=True)
    torch.testing.assert_close(got, torch.from_numpy(want))


def _dense_layout():
    g = T.rmat_graph(9, 8, seed=7, weights=True)
    bg = T.build_blocked(g, block_size=128, bin_thresholds="auto",
                         device="cpu")
    assert bg.schedule.blocks_in(balance.BIN_DENSE)
    return g, bg


@pytest.mark.parametrize("site", ["kernel.tocab_spmm",
                                  "kernel.tocab_spmm.op"])
def test_dense_bin_rung_cuda_to_onehot(site, monkeypatch):
    """The dense bin's kernel (picked as on the card, ``dense_impl=None``;
    its plain version runs here) falls to the one-hot strategy only under
    ``allow_fallback=True``, bit-equal to it; ``None`` raises."""
    g, bg = _dense_layout()
    x = torch.from_numpy(np.random.default_rng(3).random(g.n,
                                                         dtype=np.float32))
    want = T.tocab_pull(bg, x, schedule="balanced", dense_impl="onehot")
    monkeypatch.setattr(balance, "default_dense_impl", lambda v: "cuda")
    before = fallbacks("tocab_spmm", "cuda", "onehot")
    chaos.inject(site)
    got = T.tocab_pull(bg, x, schedule="balanced", allow_fallback=True)
    assert torch.equal(got, want)
    assert fallbacks("tocab_spmm", "cuda", "onehot") == before + 1
    degrade.clear()
    chaos.inject(site)
    with pytest.raises(ChaosError):
        T.tocab_pull(bg, x, schedule="balanced")
    assert fallbacks("tocab_spmm", "cuda", "onehot") == before + 1


@pytest.mark.parametrize("workload", ["pagerank", "spmv"])
def test_dense_rung_threaded_from_entry_points(workload, monkeypatch):
    """``pagerank`` and ``spmv`` carry the opt-in down to the dense bin."""
    g, bg = _dense_layout()
    dg = T.DeviceGraph.from_host(g, device="cpu")
    x = torch.ones(g.n)

    def run(**kw):
        if workload == "pagerank":
            return T.pagerank(dg, bg, schedule="balanced", max_iters=3,
                              **kw)[0]
        return T.spmv(dg, bg, x, schedule="balanced", **kw)

    want = run(dense_impl="onehot") if workload == "spmv" else run()
    monkeypatch.setattr(balance, "default_dense_impl", lambda v: "cuda")
    chaos.inject("kernel.tocab_spmm")
    with pytest.raises(ChaosError):
        run()
    chaos.inject("kernel.tocab_spmm")
    assert torch.equal(run(allow_fallback=True), want)


def test_fused_op_site_degrades_under_opt_in():
    g, _, pull, push = layouts(16)
    x = torch.ones(g.n)
    want = T.tocab_pull(pull, x, impl="slab")
    chaos.inject("kernel.tocab_fused.op")
    assert torch.equal(T.tocab_pull(pull, x, impl="fused",
                                    allow_fallback=True), want)
    chaos.inject("kernel.tocab_fused.op")
    with pytest.raises(ChaosError):
        T.tocab_push(push, x, impl="fused")


# ------------------------------- tuner -------------------------------- #

TEST_BUDGET = TrialBudget("test", warmup=0, reps=1, prune_ratio=100.0,
                          max_trials=8)
TEST_SPACE = SearchSpace(engines=("tocab",), directions=("pull",),
                         schedules=("uniform",), impls=("slab",),
                         block_sizes=(32, 64))


@pytest.fixture
def tune_dir(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_TUNE_DIR", str(tmp_path))
    for mod in (tune_plan, analytic, runner):
        mod.clear_cache()
    yield tmp_path
    for mod in (tune_plan, analytic, runner):
        mod.clear_cache()


def test_poisoned_candidate_skipped(tune_dir):
    g = small_graph(seed=15)
    chaos.inject("tune.trial")  # first trial of the sweep crashes
    e1 = tuner.tune_graph(g, "tg", space=TEST_SPACE, budget=TEST_BUDGET,
                          device="cpu")
    assert len(e1["skipped"]) == 1
    bad_key = Candidate.from_json(e1["skipped"][0]["candidate"]).key()
    key = tune_db.entry_key(T.graph_fingerprint(g), "cpu",
                            workload="pagerank")
    assert bad_key in tune_db.poisoned_for(key)

    # re-tune: the poisoned candidate is skipped upfront, not re-run
    e2 = tuner.tune_graph(g, "tg", space=TEST_SPACE, budget=TEST_BUDGET,
                          force=True, device="cpu")
    assert e2["poisoned_skipped"] == [bad_key]
    assert not e2["skipped"]
    assert all(t["candidate"]["block_size"] !=
               e1["skipped"][0]["candidate"]["block_size"]
               for t in e2["trials"])


def test_trial_timeout_is_cpu_only(tune_dir):
    """A CPU trial that outlives its timeout raises ``TimeoutError`` (the
    sweep poisons it); on the card a timeout is refused before anything
    runs: the abandoned thread would go on launching kernels."""
    g = small_graph(seed=16)
    cand = Candidate(engine="tocab", direction="pull", block_size=32)
    with pytest.raises(TimeoutError):
        runner.run_trial(g, cand, budget=TEST_BUDGET, timeout=1e-4,
                         device="cpu")
    assert runner.run_trial(g, cand, budget=TEST_BUDGET,
                            device="cpu").us > 0
    for device in ("cuda", "cuda:0"):
        with pytest.raises(ValueError, match="CPU trials only"):
            runner.run_trial(g, cand, budget=TEST_BUDGET, timeout=5.0,
                             device=device)
        with pytest.raises(ValueError, match="CPU trials only"):
            tuner.tune_graph(g, "tg", space=TEST_SPACE, budget=TEST_BUDGET,
                             trial_timeout=5.0, device=device)


KERNEL_CANDS = [Candidate(impl="fused"),
                Candidate(direction="push", impl="fused"),
                Candidate(schedule="balanced"),
                Candidate(schedule="balanced", dense_impl="cuda")]
PLAIN_CANDS = [Candidate(), Candidate(engine="base"),
               Candidate(schedule="balanced", dense_impl="onehot")]


@pytest.mark.parametrize("err", [
    ValueError("unusable"), NotImplementedError("unsupported"),
    RuntimeError("CUDA error: an illegal memory access was encountered"),
    RuntimeError("nvcc failed"), ChaosError("tune.trial"),
    TimeoutError("slow")], ids=lambda e: type(e).__name__)
def test_card_trial_failure_poisons_only_argument_refusals(err):
    """Which failed trials poison their candidate: on the CPU every one
    (the reference's rule); on the card only an argument refusal of a
    candidate that launches no kernel."""
    refusal = isinstance(err, (ValueError, NotImplementedError))
    for c in KERNEL_CANDS + PLAIN_CANDS:
        assert tuner._poisons(err, c, "cpu")
        assert tuner._poisons(err, c, "cuda") == (
            refusal and c in PLAIN_CANDS)


def test_card_sweep_stops_on_a_kernel_failure(tune_dir, monkeypatch):
    """A trial on the card that fails for any reason but an argument
    refusal ends the sweep with its error and poisons nothing, so a later
    ``"auto"`` cannot land on torch ops because a kernel failed."""
    g = small_graph(seed=18)
    monkeypatch.setattr(tune_db, "device_key", lambda device=None: "card")

    def fail(*a, **kw):
        raise RuntimeError("CUDA error: an illegal memory access")

    monkeypatch.setattr(runner, "run_trial", fail)
    with pytest.raises(RuntimeError, match="CUDA error"):
        tuner.tune_graph(g, "tg", space=TEST_SPACE, budget=TEST_BUDGET,
                         device="cuda")
    key = tune_db.entry_key(T.graph_fingerprint(g), "card",
                            workload="pagerank")
    assert tune_db.poisoned_for(key) == {}
    assert tune_db.get_entry(key) is None


# ------------------------------ tune DB -------------------------------- #

def test_db_corrupt_json_quarantined(tune_dir):
    import os

    path = tune_db.db_path()
    with open(path, "w") as f:
        f.write("{definitely not json")
    tune_db.clear_cache()
    before = _obs.counter("tune.db_recovered").value(reason="corrupt")
    db = tune_db.load(path)
    assert db["entries"] == {}
    assert db["schema"] == tune_db.DB_SCHEMA
    quarantined = [n for n in os.listdir(tune_dir) if ".corrupt-" in n]
    assert len(quarantined) == 1
    assert _obs.counter("tune.db_recovered").value(
        reason="corrupt") == before + 1
    # the DB keeps working after recovery
    tune_db.put_entry("k", {"chosen": {}})
    assert tune_db.get_entry("k", path) is not None


def test_db_schema_mismatch_quarantined(tune_dir):
    import json
    import os

    path = tune_db.db_path()
    with open(path, "w") as f:
        json.dump({"schema": "something/else", "entries": {"k": {}}}, f)
    tune_db.clear_cache()
    assert tune_db.load(path)["entries"] == {}
    assert any(".corrupt-" in n for n in os.listdir(tune_dir))


def test_db_transient_fault_preserves_file(tune_dir):
    """Injected read faults that exhaust retries must not quarantine a
    good file — the next clean load sees the original data."""
    import os

    tune_db.put_entry("keep-me", {"chosen": {}})
    path = tune_db.db_path()
    tune_db.clear_cache()
    chaos.inject("tune.db_load", times=tune_db.IO_POLICY.max_attempts)
    assert tune_db.load(path)["entries"] == {}  # served empty this call
    assert not any(".corrupt-" in n for n in os.listdir(tune_dir))
    tune_db.clear_cache()
    assert "keep-me" in tune_db.load(path)["entries"]


def test_db_save_fault_retried(tune_dir):
    chaos.inject("tune.db_save")  # one fault < retry budget
    tune_db.put_entry("retried", {"chosen": {}})
    tune_db.clear_cache()
    assert "retried" in tune_db.load(tune_db.db_path())["entries"]


# ----------------------------- serving -------------------------------- #

def test_serve_batch_step_retried():
    from repro.launch.serve import BATCH_POLICY as REF_POLICY
    from repro_torch.launch.serve import BATCH_POLICY, _resilient_step

    assert dataclasses.asdict(BATCH_POLICY) == dataclasses.asdict(REF_POLICY)
    before = _obs.counter("resilience.retries").value(
        site="serve.batch", error="ChaosError")
    chaos.inject("serve.batch")
    assert _resilient_step(lambda a, b: a + b, 20, 22) == 42
    assert _obs.counter("resilience.retries").value(
        site="serve.batch", error="ChaosError") == before + 1


def _lm():
    from repro_torch.configs import get_arch
    from repro_torch.models import transformer as tfm

    cfg = get_arch("tinyllama-1.1b").make_smoke_cfg()
    gen = torch.Generator().manual_seed(0)
    params = tfm.cast_params(tfm.init_params(cfg, gen, "cpu"), cfg)
    prompts = torch.from_numpy(
        np.random.default_rng(0).integers(0, cfg.vocab, (2, 5)))
    return tfm, cfg, params, prompts


@pytest.mark.parametrize("where", ["before", "after_cache_write"])
def test_retried_serve_step_gives_equal_tokens(where, monkeypatch):
    """A fault in one decode step — before it runs, or after it has
    written its K/V into the cache in place — is retried, and the greedy
    tokens are bit-equal to a run without the fault."""
    from repro_torch.launch import serve

    tfm, cfg, params, prompts = _lm()
    want = serve.serve_loop(params, prompts, cfg, 6).tokens
    before = _obs.counter("resilience.retries").value(
        site="serve.batch", error="ChaosError")
    if where == "before":
        chaos.inject("serve.batch")
    else:
        real, state = tfm.serve_decode, {"armed": True}

        def step(params, tok, pos, cache, cfg):
            out = real(params, tok, pos, cache, cfg)
            if pos == 6 and state.pop("armed", False):
                raise ChaosError("serve.batch")  # the cache is written
            return out

        monkeypatch.setattr(tfm, "serve_decode", step)
    got = serve.serve_loop(params, prompts, cfg, 6).tokens
    assert torch.equal(got, want)
    assert _obs.counter("resilience.retries").value(
        site="serve.batch", error="ChaosError") == before + 1


def test_retried_score_step_gives_equal_result():
    from repro_torch.configs import get_arch
    from repro_torch.launch import serve
    from repro_torch.models.bert4rec import init_bert4rec

    cfg = dataclasses.replace(get_arch("bert4rec").make_smoke_cfg(),
                              vocab=500)
    params = init_bert4rec(cfg, torch.Generator().manual_seed(0), "cpu")
    items = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (4, cfg.max_len)).astype(np.int32))
    want = serve.score_loop(params, items, cfg, top_k=5, reps=2)
    chaos.inject("serve.batch")
    got = serve.score_loop(params, items, cfg, top_k=5, reps=2)
    assert torch.equal(got.ids, want.ids)
    assert torch.equal(got.scores, want.scores)


# ------------------------------ the card ------------------------------- #

@pytest.mark.cuda
def test_cuda_ladder_on_the_card():
    """On the card the ladder stays off, ``allow_fallback=True`` or not: a
    fault at the fused dispatch or the dense bin's kernel raises, nothing
    falls back or is memoized, and an opted-in call without a fault
    launches its kernel.  The kernel and the slab engine add in other
    orders (``index_add_`` adds with atomics): rtol 1e-4
    (``chip_smoke.py``'s ``SUM_RTOL``) and atol 1e-5 (sums of at most a
    few hundred products of two values in [0, 1))."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from repro_torch.kernels import cuda_build

    g = T.rmat_graph(12, 8, seed=3, weights=True)
    bg = T.build_blocked(g, block_size=1024, bin_thresholds="auto",
                         device="cuda")
    assert bg.schedule.blocks_in(balance.BIN_DENSE)
    x = torch.rand(g.n, generator=torch.Generator().manual_seed(0)).cuda()
    want = T.tocab_pull(bg, x, impl="slab")
    for opt in (None, True):
        before = fallbacks("tocab_pull", "fused", "slab")
        chaos.inject("kernel.tocab_fused")
        with pytest.raises(ChaosError):
            T.tocab_pull(bg, x, impl="fused", allow_fallback=opt)
        chaos.inject("kernel.tocab_spmm")
        with pytest.raises(ChaosError):
            T.tocab_pull(bg, x, schedule="balanced", allow_fallback=opt)
        assert fallbacks("tocab_pull", "fused", "slab") == before
        assert fallbacks("tocab_spmm", "cuda", "onehot") == 0
        assert degrade.apply_verdict(bg.fingerprint, "tocab_pull",
                                     "fused") == "fused"
    cuda_build.reset_launches()
    torch.testing.assert_close(
        T.tocab_pull(bg, x, impl="fused", allow_fallback=True), want,
        rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(
        T.tocab_pull(bg, x, schedule="balanced", allow_fallback=True), want,
        rtol=1e-4, atol=1e-5)
    assert cuda_build.launches["fused_pull"] == 1
    assert cuda_build.launches["tocab_spmm"] >= 1
