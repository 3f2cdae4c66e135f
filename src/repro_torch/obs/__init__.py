"""Observability layer of the port: the process-wide metrics registry and
nested tracing spans, with the metric names of ``repro.obs``.

* :mod:`repro_torch.obs.metrics` — labeled counters / gauges / histograms in
  one process-wide :data:`~repro_torch.obs.metrics.registry`.
* :mod:`repro_torch.obs.trace` — nested span context managers emitting
  JSONL, with ``torch.cuda.synchronize`` attribution.
* :mod:`repro_torch.obs.export` — run fingerprint (torch, CUDA, the card
  and its power limit, git SHA) and the ``repro.obs.bench/v1`` writers.
* :mod:`repro_torch.obs.report` — ``python -m repro_torch.obs.report
  BENCH_x.json [--baseline prior.json]`` renders tables and deltas.
"""
from . import export, metrics, trace  # noqa: F401
from .metrics import registry  # noqa: F401
from .trace import span  # noqa: F401
