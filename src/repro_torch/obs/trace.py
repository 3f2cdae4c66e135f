"""Nested tracing spans with JSONL emission and device-work attribution.

Usage::

    from repro_torch import obs

    with obs.span("pagerank", variant="gc-pull") as sp:
        rank, iters = pagerank(dg, bg)
        sp.block(rank)         # torch.cuda.synchronize → device time lands
                               # in THIS span, not a later data-dependent one

    obs.trace.set_sink("trace.jsonl")      # persist events as JSONL

Span events carry ``name, ts, dur_s, blocked_s, depth, parent, attrs`` and
are buffered in memory (readable via :func:`events`) and appended to the
JSONL sink when one is configured.  Nesting is tracked per-thread."""
from __future__ import annotations

import contextlib
import json
import threading
import time
from typing import Optional

import torch

from .metrics import registry

__all__ = ["Span", "span", "events", "clear", "set_sink", "synchronize"]

_TLS = threading.local()
_BUF_LOCK = threading.Lock()
_EVENTS: list = []
_SINK_PATH: Optional[str] = None


def _stack() -> list:
    s = getattr(_TLS, "stack", None)
    if s is None:
        s = _TLS.stack = []
    return s


def set_sink(path: Optional[str]):
    """Append finished span events to ``path`` as JSONL (None disables)."""
    global _SINK_PATH
    _SINK_PATH = path


def events() -> list:
    """Copy of the in-memory span event buffer (finish order)."""
    with _BUF_LOCK:
        return list(_EVENTS)


def clear():
    with _BUF_LOCK:
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


class Span:
    """One timed region.  Created by :func:`span`; also records its duration
    into the ``obs.span_seconds`` histogram labeled by span name."""

    def __init__(self, name: str, attrs: dict):
        self.name = name
        self.attrs = attrs
        self.blocked_s = 0.0
        self._t0 = 0.0
        self.dur_s: Optional[float] = None

    def block(self, value):
        """Synchronise with the card when ``value`` lives there, attributing
        the wait to this span (recorded separately as ``blocked_s``).
        Returns ``value``."""
        t0 = time.perf_counter()
        value = synchronize(value)
        self.blocked_s += time.perf_counter() - t0
        return value

    def set(self, **attrs):
        self.attrs.update(attrs)


@contextlib.contextmanager
def span(name: str, **attrs):
    """Nested span context manager; yields a :class:`Span`."""
    sp = Span(name, attrs)
    stack = _stack()
    parent = stack[-1].name if stack else None
    depth = len(stack)
    stack.append(sp)
    sp._t0 = time.perf_counter()
    ts = time.time()
    try:
        yield sp
    finally:
        sp.dur_s = time.perf_counter() - sp._t0
        stack.pop()
        event = {
            "name": name,
            "ts": ts,
            "dur_s": sp.dur_s,
            "blocked_s": sp.blocked_s,
            "depth": depth,
            "parent": parent,
            "attrs": sp.attrs,
        }
        with _BUF_LOCK:
            _EVENTS.append(event)
            sink = _SINK_PATH
        if sink is not None:
            with open(sink, "a") as f:
                f.write(json.dumps(event, default=str) + "\n")
        registry.histogram(
            "obs.span_seconds", "span wall time by name"
        ).observe(sp.dur_s, name=name)
