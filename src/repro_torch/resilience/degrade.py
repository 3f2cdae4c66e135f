"""Engine degradation ladder: fused → slab → reference.

The ladder is an ordered list of *rungs* — ``(name, thunk)`` pairs — and
:func:`dispatch` walks it: the first rung that returns wins; a rung that
raises records a ``resilience.fallbacks{site,from,to}`` counter and hands
off to the next.  The verdict is **memoized per (graph fingerprint,
dispatch site)**: once fused is known-broken for a graph, every later call
starts at the working rung instead of re-failing once per iteration.

The port arms the ladder **only on an explicit opt-in, and only for
tensors on the CPU**: :func:`fallback_allowed` is ``bool(allow_fallback)``
for a CPU device and ``False`` for any other, so ``None`` (the default
everywhere) means off, and a tensor on the card reaches its hand-written
kernel or the call raises, ``allow_fallback=True`` or not.  The reference
also arms it for ``impl="auto"``, under the ``REPRO_RESILIENCE_FALLBACK``
environment variable, and for the balanced dense bin whenever
``dense_impl=None``; the port does none of these (ROADMAP C, deliberate
differences).

What a rung can catch is what the call raises on the host: an injected
:class:`~repro_torch.resilience.chaos.ChaosError` or a failure of the
plain version on the CPU.  An argument refusal (``ValueError``,
``NotImplementedError``) is the caller's error, not a fault, and
propagates from the rung that raised it.
"""
from __future__ import annotations

import threading
from typing import Optional, Sequence, Tuple

import torch

from repro_torch.obs.metrics import registry as _obs

__all__ = [
    "LADDER",
    "fallback_allowed",
    "apply_verdict",
    "record_verdict",
    "dispatch",
    "clear",
]

#: canonical rung order, strongest (most specialized) first
LADDER = ("fused", "slab", "reference")

_lock = threading.Lock()
# (graph fingerprint, dispatch site) -> rung name decided by a past failure
_VERDICTS: dict = {}


def fallback_allowed(allow_fallback: Optional[bool], device) -> bool:
    """The ladder opt-in for one dispatch on ``device`` (where the call's
    values live): ``allow_fallback`` itself, with ``None`` off, and off
    for every device but the CPU."""
    return bool(allow_fallback) and torch.device(device).type == "cpu"


def apply_verdict(fp: Optional[str], site: str, impl: str) -> str:
    """Skip straight to a memoized verdict: if a past dispatch for this
    (graph, site) degraded below ``impl``, return the decided rung."""
    if fp is None:
        return impl
    v = _VERDICTS.get((fp, site))
    if v is None or v not in LADDER or impl not in LADDER:
        return impl
    return v if LADDER.index(v) > LADDER.index(impl) else impl


def record_verdict(fp: Optional[str], site: str, rung: str):
    if fp is None:
        return
    with _lock:
        _VERDICTS[(fp, site)] = rung


def dispatch(site: str, fp: Optional[str],
             rungs: Sequence[Tuple[str, callable]],
             allow_fallback: bool = True):
    """Run the first working rung of ``rungs``; on failure fall through,
    recording the fallback and memoizing the landing rung.  With
    ``allow_fallback=False`` (or on the last rung) the failure propagates
    unchanged, and so does an argument refusal (``ValueError``,
    ``NotImplementedError``) on any rung: it records no verdict."""
    names = [n for n, _ in rungs]
    start = 0
    if fp is not None:
        v = _VERDICTS.get((fp, site))
        if v in names:
            start = names.index(v)
    for i in range(start, len(rungs)):
        name, thunk = rungs[i]
        try:
            return thunk()
        except (ValueError, NotImplementedError):
            raise
        except Exception as e:
            if not allow_fallback or i + 1 >= len(rungs):
                raise
            nxt = names[i + 1]
            _obs.counter(
                "resilience.fallbacks",
                "engine degradations by dispatch site",
            ).inc(site=site, error=type(e).__name__,
                  **{"from": name, "to": nxt})
            record_verdict(fp, site, nxt)
    raise RuntimeError(f"{site}: empty degradation ladder")  # unreachable


def clear():
    """Forget memoized verdicts (tests / after a backend change)."""
    with _lock:
        _VERDICTS.clear()
