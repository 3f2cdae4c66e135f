"""Process-wide resilience layer of the port: fault injection, the engine
degradation ladder, retries.

* :mod:`repro_torch.resilience.chaos` — deterministic, seed-driven fault
  injection (``REPRO_CHAOS=<seed>:<rate>`` or programmatic
  :func:`~repro_torch.resilience.chaos.inject`) at the reference's named
  sites: kernel dispatch, tuner trials, tune-DB IO, the serve batch path.
* :mod:`repro_torch.resilience.degrade` — the fused → slab → reference
  ladder (and the dense bin's cuda → onehot), armed only by an explicit
  ``allow_fallback=True`` on values on the CPU (never on the card), with
  per-(graph, engine) verdict memoization and ``resilience.fallbacks``
  counters.
* :mod:`repro_torch.resilience.retry` — retry / backoff / timeout policies
  for tune-DB persistence, tuner trials and serving.

Everything records into :data:`repro_torch.obs.metrics.registry` under
the reference's ``resilience.*`` metric names.
"""
from . import chaos, degrade, retry  # noqa: F401
from .chaos import ChaosError  # noqa: F401
from .retry import Policy  # noqa: F401
