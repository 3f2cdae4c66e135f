"""Deterministic, seed-driven fault injection.

Two ways to arm it:

* **Environment** — ``REPRO_CHAOS=<seed>:<rate>`` enables rate-based
  injection at every *default* site (``REPRO_CHAOS_SITES=a,b,c``
  restricts or extends the set; opt-in sites like ``tune.trial`` must be
  named explicitly).  The decision at a site is a pure function of
  ``(seed, site, per-site call index)`` — two runs with the same seed and
  the same call sequence inject the *same* faults, which is what lets CI
  run the whole tier-1 suite under chaos at a pinned seed.
* **Programmatic** — :func:`inject` queues an exception (by default a
  :class:`ChaosError`) for the next N checks of a site, regardless of the
  env configuration.  Tests use this to force a specific failure exactly
  once.

Sites call :func:`maybe_raise` on the host, before the work they guard is
issued: a fault raised there is what the degradation ladder
(:mod:`repro_torch.resilience.degrade`, behind an explicit
``allow_fallback=True`` on the CPU) or a retry policy catches.  Every injection
increments ``resilience.chaos_injected{site}``.  The sites, the
environment spec and the draws are the reference's (``repro.resilience.
chaos``): the same seed gives the same faults in both packages.
"""
from __future__ import annotations

import dataclasses
import hashlib
import os
import threading
from typing import Optional

from repro_torch.obs.metrics import registry as _obs

__all__ = [
    "ChaosError",
    "DEFAULT_SITES",
    "KNOWN_SITES",
    "configure",
    "configure_spec",
    "enabled",
    "active_for",
    "inject",
    "maybe_raise",
    "reset",
]

ENV_SPEC = "REPRO_CHAOS"
ENV_SITES = "REPRO_CHAOS_SITES"

#: sites armed by rate-based injection when ``REPRO_CHAOS_SITES`` is unset.
#: Every one of them sits on a *recoverable* path in the reference
#: (degradation ladder, retry policy, or quarantine-and-rebuild).  In the
#: port the kernel sites recover only under an explicit
#: ``allow_fallback=True`` on the CPU; elsewhere the fault raises.
DEFAULT_SITES = frozenset({
    "kernel.tocab_fused",   # fused-impl dispatch in core/tocab.py
    "kernel.tocab_spmm",    # dense-bin kernel dispatch in core/balance.py
    "ckpt.save",            # checkpoint write path (retried; ROADMAP A10)
    "ckpt.restore",         # checkpoint read path (retried; ROADMAP A10)
    "tune.db_load",         # tune/db.py load (retried, quarantine on corrupt)
    "tune.db_save",         # tune/db.py save (retried, degrade to in-process)
    "serve.batch",          # launch/serve.py per-batch step (retried)
})

#: every named site, including the opt-in ones rate-based injection skips
#: unless ``REPRO_CHAOS_SITES`` names them.
KNOWN_SITES = tuple(sorted(DEFAULT_SITES | {
    "kernel.tocab_slab",        # slab rung of the ladder (opt-in)
    "kernel.tocab_fused.op",    # kernels/tocab_fused ops entry (opt-in)
    "kernel.tocab_spmm.op",     # kernels/tocab_spmm ops entry (opt-in)
    "tune.trial",               # tuner trial execution (opt-in)
}))


class ChaosError(RuntimeError):
    """The fault :func:`maybe_raise` injects (rate-based or default queued)."""

    def __init__(self, site: str, seq: int = -1):
        self.site = site
        self.seq = seq
        super().__init__(f"chaos fault injected at site {site!r} (call #{seq})")


@dataclasses.dataclass(frozen=True)
class _Config:
    seed: int
    rate: float
    sites: frozenset


_lock = threading.Lock()
_cfg: Optional[_Config] = None  # programmatic override
_env_cfg: Optional[_Config] = None  # parsed REPRO_CHAOS (cached)
_env_parsed = False
_counters: dict = {}  # site -> call count (only while a config is active)
_queued: dict = {}  # site -> [exceptions]


def configure_spec(spec: str, sites: Optional[str] = None) -> _Config:
    """Parse ``"<seed>:<rate>"`` (+ optional comma-joined site list) and
    install it as the active configuration."""
    seed_s, _, rate_s = spec.partition(":")
    seed = int(seed_s)
    rate = float(rate_s) if rate_s else 1.0
    site_set = (
        frozenset(s.strip() for s in sites.split(",") if s.strip())
        if sites else DEFAULT_SITES)
    return configure(seed=seed, rate=rate, sites=site_set)


def configure(seed: int, rate: float, sites=None) -> _Config:
    """Programmatically arm rate-based injection (overrides the env)."""
    global _cfg
    cfg = _Config(seed=int(seed), rate=float(rate),
                  sites=frozenset(sites) if sites else DEFAULT_SITES)
    with _lock:
        _cfg = cfg
        _counters.clear()
    return cfg


def _from_env() -> Optional[_Config]:
    global _env_cfg, _env_parsed
    if _env_parsed:
        return _env_cfg
    spec = os.environ.get(ENV_SPEC)
    cfg = None
    if spec:
        try:
            seed_s, _, rate_s = spec.partition(":")
            seed, rate = int(seed_s), float(rate_s) if rate_s else 1.0
            sites = os.environ.get(ENV_SITES)
            site_set = (
                frozenset(s.strip() for s in sites.split(",") if s.strip())
                if sites else DEFAULT_SITES)
            cfg = _Config(seed=seed, rate=rate, sites=site_set)
        except ValueError:
            raise ValueError(
                f"{ENV_SPEC}={spec!r}: expected '<seed>:<rate>' "
                "(e.g. REPRO_CHAOS=1234:0.1)") from None
    with _lock:
        _env_cfg, _env_parsed = cfg, True
    return cfg


def _active() -> Optional[_Config]:
    return _cfg if _cfg is not None else _from_env()


def enabled() -> bool:
    """True when rate-based injection is armed (env or programmatic)."""
    cfg = _active()
    return cfg is not None and cfg.rate > 0


def active_for(site: str) -> bool:
    """True when rate-based injection can fire at ``site`` — tests that
    assert *which* engine ran (not its results) skip under this."""
    cfg = _active()
    return cfg is not None and cfg.rate > 0 and site in cfg.sites


def inject(site: str, exc: Optional[BaseException] = None, times: int = 1):
    """Queue ``exc`` (default: a :class:`ChaosError`) for the next
    ``times`` checks of ``site`` — independent of the env configuration."""
    with _lock:
        q = _queued.setdefault(site, [])
        for _ in range(max(times, 1)):
            q.append(exc if exc is not None else ChaosError(site))


def _draw(seed: int, site: str, seq: int) -> float:
    h = hashlib.sha256(f"repro.chaos:{seed}:{site}:{seq}".encode()).digest()
    return int.from_bytes(h[:8], "big") / 2.0**64


def maybe_raise(site: str):
    """Fault-injection check point.  Drains the programmatic queue first,
    then rolls the deterministic (seed, site, call-index) die."""
    if _queued:
        with _lock:
            q = _queued.get(site)
            exc = q.pop(0) if q else None
            if q is not None and not q:
                _queued.pop(site, None)
        if exc is not None:
            _obs.counter(
                "resilience.chaos_injected", "faults injected by site"
            ).inc(site=site, mode="queued")
            raise exc
    cfg = _active()
    if cfg is None or cfg.rate <= 0 or site not in cfg.sites:
        return
    with _lock:
        seq = _counters.get(site, 0)
        _counters[site] = seq + 1
    if _draw(cfg.seed, site, seq) < cfg.rate:
        _obs.counter(
            "resilience.chaos_injected", "faults injected by site"
        ).inc(site=site, mode="rate")
        raise ChaosError(site, seq)


def reset():
    """Disarm everything and forget call counts (tests; also re-reads the
    env on the next check)."""
    global _cfg, _env_cfg, _env_parsed
    with _lock:
        _cfg = None
        _env_cfg, _env_parsed = None, False
        _counters.clear()
        _queued.clear()
