"""Observability layer of the port: the process-wide metrics registry and
nested tracing spans, with the metric names of ``repro.obs``.

* :mod:`repro_torch.obs.metrics` — labeled counters / gauges / histograms in
  one process-wide :data:`~repro_torch.obs.metrics.registry`.
* :mod:`repro_torch.obs.trace` — nested spans, off unless turned on
  (``trace.enable()``, a recording ``torch.profiler``, or
  ``REPRO_TORCH_TRACE=1`` at import); on, each span is a
  ``record_function`` range on the profiler's clock, with CUDA event
  markers at entry and exit where it names a device.  An event holds its
  name, id, parent and root ids, host ``perf_counter_ns`` times, waits on
  the card and attributes (and device-clock times where it has markers);
  the buffer keeps the newest ``trace.MAX_EVENTS``, JSONL on read.
* :mod:`repro_torch.obs.export` — run fingerprint (torch, CUDA, the card
  and its power limit, git SHA) and the ``repro.obs.bench/v1`` writers.
* :mod:`repro_torch.obs.report` — ``python -m repro_torch.obs.report
  BENCH_x.json [--baseline prior.json]`` renders tables and deltas.
"""
from . import export, metrics, trace  # noqa: F401
from .metrics import registry  # noqa: F401
from .trace import span  # noqa: F401
