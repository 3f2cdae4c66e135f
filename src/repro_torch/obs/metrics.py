"""Process-wide metrics registry: counters, gauges, histograms — all with
labeled series (Prometheus-style, zero dependencies).

The port's copy of ``repro.obs.metrics``: the same metric names and the same
snapshot layout, so telemetry from both packages compares key for key.

Design constraints, in order:

1. **Deterministic aggregation** — a snapshot is a plain nested dict with
   series sorted by label; two identical runs produce identical snapshots
   (histograms store exact count/sum/min/max plus fixed log2 buckets).
2. **Host scalars only** — recording takes Python numbers, never tensors,
   so no record forces a device synchronisation; the engines record
   *static* facts (shapes, block counts) per call.
3. **Cheap** — one dict lookup + float add per record, single lock.
"""
from __future__ import annotations

import math
import threading
from typing import Optional

__all__ = ["Counter", "Gauge", "Histogram", "Registry", "registry"]


def _label_key(labels: dict) -> tuple:
    return tuple(sorted((k, str(v)) for k, v in labels.items()))


class _Metric:
    kind = "metric"

    def __init__(self, name: str, help: str, lock: threading.Lock):
        self.name = name
        self.help = help
        self._lock = lock
        self._series: dict = {}

    def _snapshot_value(self, v):
        return v

    def snapshot(self) -> dict:
        with self._lock:
            series = [
                {"labels": dict(k), "value": self._snapshot_value(v)}
                for k, v in sorted(self._series.items())
            ]
        return {"kind": self.kind, "help": self.help, "series": series}


class Counter(_Metric):
    """Monotonic accumulator; ``inc(v, **labels)``."""

    kind = "counter"

    def inc(self, v: float = 1.0, **labels):
        key = _label_key(labels)
        with self._lock:
            self._series[key] = self._series.get(key, 0.0) + float(v)

    def value(self, **labels) -> float:
        return self._series.get(_label_key(labels), 0.0)


class Gauge(_Metric):
    """Last-write-wins value; ``set(v, **labels)``."""

    kind = "gauge"

    def set(self, v: float, **labels):
        with self._lock:
            self._series[_label_key(labels)] = float(v)

    def value(self, **labels) -> Optional[float]:
        return self._series.get(_label_key(labels))


class Histogram(_Metric):
    """Exact count/sum/min/max plus log2 buckets; ``observe(v, **labels)``.

    Buckets are powers of two over the observed magnitude (le=2^i), which
    keeps aggregation deterministic and merge-friendly without configuring
    per-metric bucket boundaries."""

    kind = "histogram"

    def observe(self, v: float, **labels):
        v = float(v)
        key = _label_key(labels)
        bucket = (
            "0" if v <= 0 else f"2^{max(-64, min(64, math.ceil(math.log2(v))))}"
        )
        with self._lock:
            s = self._series.get(key)
            if s is None:
                s = {"count": 0, "sum": 0.0, "min": math.inf,
                     "max": -math.inf, "buckets": {}}
                self._series[key] = s
            s["count"] += 1
            s["sum"] += v
            s["min"] = min(s["min"], v)
            s["max"] = max(s["max"], v)
            s["buckets"][bucket] = s["buckets"].get(bucket, 0) + 1

    def _snapshot_value(self, s: dict) -> dict:
        out = dict(s)
        out["mean"] = s["sum"] / s["count"] if s["count"] else 0.0
        out["buckets"] = dict(sorted(s["buckets"].items()))
        return out

    def stats(self, **labels) -> Optional[dict]:
        s = self._series.get(_label_key(labels))
        return None if s is None else self._snapshot_value(s)


class Registry:
    """Named metric store.  ``counter``/``gauge``/``histogram`` are
    get-or-create (idempotent, kind-checked)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: dict = {}

    def _get(self, cls, name: str, help: str):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = cls(name, help, self._lock)
                self._metrics[name] = m
        if not isinstance(m, cls):
            raise TypeError(
                f"metric {name!r} already registered as {m.kind}")
        return m

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get(Counter, name, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get(Gauge, name, help)

    def histogram(self, name: str, help: str = "") -> Histogram:
        return self._get(Histogram, name, help)

    def names(self) -> list:
        with self._lock:
            return sorted(self._metrics)

    def snapshot(self) -> dict:
        """Deterministic nested-dict view of every metric (JSON-ready)."""
        with self._lock:
            metrics = list(self._metrics.items())
        return {name: m.snapshot() for name, m in sorted(metrics)}

    def reset(self):
        with self._lock:
            self._metrics.clear()


#: the process-wide default registry every instrumented module records into
registry = Registry()
