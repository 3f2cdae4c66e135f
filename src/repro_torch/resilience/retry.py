"""Retry / backoff / timeout policies for the IO and serving paths.

A :class:`Policy` is a small frozen config; ``policy.call(fn, site=...)``
runs ``fn`` up to ``max_attempts`` times with exponential backoff.  The
jitter is *deterministic* (hashed from site + attempt), so a chaos run at
a pinned seed replays identically (the reference's hashes: the same
delays in both packages).  Timeouts are enforced with a daemon worker
thread — the only portable option for arbitrary Python callables; a
timed-out callable keeps running in the background (on the card it would
go on issuing kernels, so the tuner takes a timeout for CPU trials only).

Observability: ``resilience.retries{site,error}`` per retried failure,
``resilience.retry_exhausted{site}`` when a call gives up, and
``resilience.timeouts{site}`` per timeout.
"""
from __future__ import annotations

import dataclasses
import functools
import hashlib
import threading
import time
from typing import Callable, Optional, Tuple

from repro_torch.obs.metrics import registry as _obs

__all__ = ["Policy", "retry", "call_with_timeout"]


def call_with_timeout(fn: Callable, timeout: Optional[float], *args, **kw):
    """Run ``fn(*args, **kw)``, raising :class:`TimeoutError` after
    ``timeout`` seconds (``None``/``<=0`` disables the guard)."""
    if not timeout or timeout <= 0:
        return fn(*args, **kw)
    box: dict = {}

    def _run():
        try:
            box["value"] = fn(*args, **kw)
        except BaseException as e:  # re-raised on the caller's thread
            box["error"] = e

    t = threading.Thread(target=_run, daemon=True)
    t.start()
    t.join(timeout)
    if t.is_alive():
        raise TimeoutError(
            f"call exceeded {timeout:g}s (worker thread abandoned)")
    if "error" in box:
        raise box["error"]
    return box["value"]


def _jitter_frac(site: str, attempt: int) -> float:
    h = hashlib.sha256(f"repro.retry:{site}:{attempt}".encode()).digest()
    return int.from_bytes(h[:8], "big") / 2.0**64


@dataclasses.dataclass(frozen=True)
class Policy:
    """Retry policy: ``max_attempts`` tries, exponential backoff with
    deterministic jitter, optional per-attempt ``timeout``."""

    max_attempts: int = 3
    base_delay: float = 0.05
    backoff: float = 2.0
    jitter: float = 0.25
    timeout: Optional[float] = None
    retry_on: Tuple[type, ...] = (Exception,)

    def delay(self, site: str, attempt: int) -> float:
        d = self.base_delay * self.backoff ** attempt
        return d * (1.0 + self.jitter * _jitter_frac(site, attempt))

    def call(self, fn: Callable, *args, site: str = "retry", **kw):
        last: Optional[BaseException] = None
        for attempt in range(max(self.max_attempts, 1)):
            try:
                return call_with_timeout(fn, self.timeout, *args, **kw)
            except TimeoutError as e:
                _obs.counter("resilience.timeouts",
                             "timed-out resilient calls").inc(site=site)
                last = e
            except self.retry_on as e:
                last = e
            if attempt + 1 >= max(self.max_attempts, 1):
                break
            _obs.counter(
                "resilience.retries", "retried failures by site"
            ).inc(site=site, error=type(last).__name__)
            time.sleep(self.delay(site, attempt))
        _obs.counter("resilience.retry_exhausted",
                     "calls that exhausted their retry budget").inc(site=site)
        raise last


def retry(policy: Optional[Policy] = None, site: str = "retry", **overrides):
    """Decorator form: ``@retry(Policy(max_attempts=5), site="ckpt.save")``
    or ``@retry(site="x", max_attempts=2)``."""
    pol = policy or Policy()
    if overrides:
        pol = dataclasses.replace(pol, **overrides)

    def deco(fn):
        @functools.wraps(fn)
        def wrapped(*args, **kw):
            return pol.call(fn, *args, site=site, **kw)

        wrapped.policy = pol
        return wrapped

    return deco
