"""Nested tracing spans on the profiler's timeline, with device-clock
markers, buffered in a bounded ring.

Usage::

    from repro_torch.obs import trace

    with trace.enable():                  # or a profiler, or the variable
        with trace.span("pagerank.solve", device=dg.device, n=dg.n) as sp:
            rank, iters = pagerank(dg, bg)
            sp.set(iterations=iters)
    for e in trace.events():              # the card's markers resolved here
        print(e["name"], e["dur_s"], e.get("device_ms"))

**When spans record.**  Tracing is off unless one of these holds:

* inside ``trace.enable()`` ... ``trace.disable()`` (``enable()`` is also a
  context manager; calls nest);
* while ``torch.profiler`` records;
* ``REPRO_TORCH_TRACE=1`` was set when this module was imported.

Off, a span makes one test of that state and times itself with two
``perf_counter`` calls (``Span.dur_s``, which the tuner's trials read); it
buffers, emits and records nothing else.  On, a span also opens a range of
its name in the profiler's trace, on the kernels' clock, and, when given a
CUDA ``device``, records a ``torch.cuda.Event`` on that device's current
stream at entry and exit.  Those markers are resolved only when
:func:`events` reads them, never on the hot path.

The range is ``torch._C._profiler._RecordFunctionFast``, the host-side
range of ``torch.profiler.record_function`` without its user-annotation
scope: under a CUDA profiler, ``record_function`` also adds a device-side
event per range, spanning the first to the last kernel launched in it, and
a reduction of the trace's device events would count those spans, idle
gaps included, as device work.

**An event** (one a finished span, in finish order) holds ``name``, ``id``,
``parent`` (the enclosing span's id, or None), ``root`` (the outermost open
span's id: every span of one solve or traversal shares it), ``depth``,
``t0_ns`` / ``t1_ns`` (``time.perf_counter_ns``), ``dur_s``, ``blocked_s``
(time spent waiting on the card inside the span: :meth:`Span.block`,
:meth:`Span.wait`) and ``attrs``; a span with device markers adds
``device``, ``dev_t0_ms`` / ``dev_t1_ms`` (device-clock ms since the first
marker of its root on that device) and ``device_ms``.

**The buffer is bounded**: the newest :data:`MAX_EVENTS` events are kept,
the oldest dropped first.  With a sink set (:func:`set_sink`), events are
appended to it as JSONL when they are read, never when they finish.
Nesting is tracked per thread.
"""
from __future__ import annotations

import collections
import itertools
import json
import os
import threading
import time
from typing import Optional

import torch
import torch.autograd.profiler as _autograd_profiler
from torch._C._profiler import _RecordFunctionFast as _Range

__all__ = ["Span", "span", "enable", "disable", "enabled", "events",
           "clear", "set_sink", "synchronize", "MAX_EVENTS"]

#: events the buffer keeps; the oldest go first
MAX_EVENTS = 1 << 16

_TLS = threading.local()
_LOCK = threading.Lock()
_EVENTS: collections.deque = collections.deque(maxlen=MAX_EVENTS)
_IDS = itertools.count(1)
_SINK_PATH: Optional[str] = None
#: ``enable()`` depth, plus one for the environment switch
_FORCED = int(os.environ.get("REPRO_TORCH_TRACE") == "1")
_perf = time.perf_counter
_perf_ns = time.perf_counter_ns


def enabled() -> bool:
    """Whether a span opened now records."""
    return bool(_FORCED or _autograd_profiler._is_profiler_enabled)


class _Enabled:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        disable()


def enable() -> _Enabled:
    """Turn tracing on until the matching :func:`disable` (or the end of
    the ``with`` block when used as a context manager)."""
    global _FORCED
    with _LOCK:
        _FORCED += 1
    return _Enabled()


def disable():
    """Undo one :func:`enable`."""
    global _FORCED
    with _LOCK:
        _FORCED = max(_FORCED - 1, 0)


def set_sink(path: Optional[str]):
    """Append events to ``path`` as JSONL when they are read (None: no
    sink)."""
    global _SINK_PATH
    _SINK_PATH = path


def _resolve(rec: dict):
    """Device-clock times of a record's markers (waits for its exit
    marker)."""
    m0, m1, epoch = rec.pop("_markers")
    m1.synchronize()
    rec["dev_t0_ms"] = epoch.elapsed_time(m0)
    rec["dev_t1_ms"] = epoch.elapsed_time(m1)
    rec["device_ms"] = rec["dev_t1_ms"] - rec["dev_t0_ms"]


def events() -> list:
    """Copies of the buffered events, in finish order, device markers
    resolved; appends those not yet written to the sink, if one is set."""
    with _LOCK:
        recs = list(_EVENTS)
        for rec in recs:
            if "_markers" in rec:
                _resolve(rec)
        sink = _SINK_PATH
        fresh = [r for r in recs if not r.get("_sunk")]
        for r in fresh:
            r["_sunk"] = True
        out = [{k: v for k, v in r.items() if k != "_sunk"} for r in recs]
    if sink is not None and fresh:
        with open(sink, "a") as f:
            for r in fresh:
                f.write(json.dumps({k: v for k, v in r.items()
                                    if k != "_sunk"}, default=str) + "\n")
    return out


def clear():
    with _LOCK:
        _EVENTS.clear()


def _cuda_devices(value, found: set):
    if isinstance(value, torch.Tensor):
        if value.is_cuda:
            found.add(value.device)
    elif isinstance(value, (tuple, list)):
        for v in value:
            _cuda_devices(v, found)
    elif isinstance(value, dict):
        for v in value.values():
            _cuda_devices(v, found)


def synchronize(value):
    """Wait for the device work behind ``value``: a tensor, or tuples /
    lists / dicts of them (leaves that are not tensors are ignored).  Host
    tensors need no wait.  Returns ``value``."""
    found: set = set()
    _cuda_devices(value, found)
    for dev in found:
        torch.cuda.synchronize(dev)
    return value


def _stack() -> list:
    s = getattr(_TLS, "stack", None)
    if s is None:
        s = _TLS.stack = []
    return s


def _marker(stream) -> torch.cuda.Event:
    ev = torch.cuda.Event(enable_timing=True)
    ev.record(stream)
    return ev


class Span:
    """One timed region, made by :func:`span` and used as a context
    manager.  ``dur_s`` is set on exit whether or not tracing is on."""

    __slots__ = ("name", "attrs", "device", "blocked_s", "dur_s", "_t0",
                 "_on", "_id", "_parent", "_root", "_depth", "_rf",
                 "_stream", "_m0", "_epochs", "_t0_ns")

    def __init__(self, name: str, attrs: dict, device=None):
        self.name, self.attrs, self.device = name, attrs, device
        self.blocked_s = 0.0
        self.dur_s: Optional[float] = None
        self._on = False

    def __enter__(self):
        if _FORCED or _autograd_profiler._is_profiler_enabled:
            self._open()
        self._t0 = _perf()
        return self

    def __exit__(self, *exc):
        self.dur_s = _perf() - self._t0
        if self._on:
            self._close()

    def _open(self):
        self._on = True
        stack = _stack()
        parent = stack[-1] if stack else None
        self._id = next(_IDS)
        self._parent = parent._id if parent else None
        self._root = stack[0] if stack else self
        self._depth = len(stack)
        self._epochs = {}
        stack.append(self)
        self._rf = _Range(self.name)
        self._rf.__enter__()
        dev = None if self.device is None else torch.device(self.device)
        if dev is not None and dev.type == "cuda":
            if dev.index is None:
                dev = torch.device("cuda", torch.cuda.current_device())
            # the exit marker goes on the stream the entry marker went on
            self._stream = torch.cuda.current_stream(dev)
            self._m0 = _marker(self._stream)
            self._root._epochs.setdefault(dev, self._m0)
        else:
            dev = None
        self.device = dev
        self._t0_ns = _perf_ns()

    def _close(self):
        t1_ns = _perf_ns()
        m1 = _marker(self._stream) if self.device is not None else None
        self._rf.__exit__(None, None, None)
        stack = _stack()
        if stack and stack[-1] is self:
            stack.pop()
        rec = {"name": self.name, "id": self._id, "parent": self._parent,
               "root": self._root._id, "depth": self._depth,
               "t0_ns": self._t0_ns, "t1_ns": t1_ns, "dur_s": self.dur_s,
               "blocked_s": self.blocked_s, "attrs": self.attrs}
        if m1 is not None:
            rec["device"] = str(self.device)
            rec["_markers"] = (self._m0, m1,
                               self._root._epochs[self.device])
        with _LOCK:
            _EVENTS.append(rec)

    def wait(self, fn, *args):
        """``fn(*args)``, its time counted as waiting (``blocked_s``): a
        read of a device value, a synchronise."""
        if not self._on:
            return fn(*args)
        t0 = _perf()
        out = fn(*args)
        self.blocked_s += _perf() - t0
        return out

    def block(self, value):
        """Synchronise with the card when ``value`` lives there, the wait
        counted in this span's ``blocked_s``; returns ``value``."""
        return self.wait(synchronize, value)

    def set(self, **attrs):
        """Add attributes to the span's event (nothing when off)."""
        if self._on:
            self.attrs.update(attrs)


def span(name: str, device=None, **attrs) -> Span:
    """A :class:`Span` named ``name`` with attributes ``attrs``; with a CUDA
    ``device`` it records device markers when tracing is on."""
    return Span(name, attrs, device)
