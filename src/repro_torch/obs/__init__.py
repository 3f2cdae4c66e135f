"""Observability layer of the port: the process-wide metrics registry and
nested tracing spans, with the metric names of ``repro.obs``.

* :mod:`repro_torch.obs.metrics` — labeled counters / gauges / histograms in
  one process-wide :data:`~repro_torch.obs.metrics.registry`.
* :mod:`repro_torch.obs.trace` — nested span context managers emitting
  JSONL, with ``torch.cuda.synchronize`` attribution.
"""
from . import metrics, trace  # noqa: F401
from .metrics import registry  # noqa: F401
from .trace import span  # noqa: F401
