"""Spans, counters and device reads inside the program; off by default.

    from mjrl_tpu_torch.utils import trace

    with trace.span("npg.cg"):          # a span of host time
        ...
    trace.count("K4.env_substeps", n)   # a counter
    value = trace.host_read("cg.rdotr", rdotr)   # the one way to read the device

A span records its name, its start and end on the host clock
(``time.perf_counter_ns``), the span open around it (its parent) and its
root: a span opened with no other open is a root and gets a new
identifier, which every span and read inside it shares, so that
``train_step``'s span names one iteration. While tracing is on, each span is
also a ``torch.profiler.record_function`` range named ``mjrl.<name>``: on
the profiler's host timeline, which shares a clock with the device's
events, every idle gap of the device falls inside some innermost program
span. :func:`host_read` returns ``tensor.tolist()`` and, while tracing is
on, records how long the host was blocked in it (the wait for the device
and the copy). Counters add (:func:`count`) or keep the largest value
(:func:`peak`).

Everything is kept in memory until :func:`reset`: :func:`take` sums what
was recorded since the last take (per span name its count, total and self
time, the total less the part its child spans cover; the counters; the
reads) and :func:`write_chrome` writes every span and read as Chrome trace
JSON. A long run traced whole holds every span of it.

The state is module-wide, one tracer per process, because a span sits on
the hot path: with tracing off :func:`span` costs one check of a
module-level flag and returns a shared no-op context (no allocation, no
``record_function``, no clock read), :func:`count` and :func:`peak` return
at once and :func:`host_read` is ``tensor.tolist()``.
"""

from __future__ import annotations

import functools
import json
import os
import time
from typing import Any, Callable, Dict, List

import torch

_on = False
_now = time.perf_counter_ns


class _Off:
    """The span of a tracer that is off: enters and exits, records nothing."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Records:
    """What the tracer holds: spans ``(name, id, parent, root, start,
    end)`` and reads ``(name, parent, root, start, end)`` (ns, host clock),
    in the order they closed; counters and peaks since the last take."""

    def __init__(self):
        self.spans: List[tuple] = []
        self.reads: List[tuple] = []
        self.counters: Dict[str, int] = {}
        self.peaks: Dict[str, int] = {}
        self.open: List[tuple] = []  # (id, root) of the spans open, innermost last
        self.next_id = 0
        self.next_root = 0
        self.taken_spans = 0
        self.taken_reads = 0


_rec = _Records()


class _Span:
    __slots__ = ("name", "id", "parent", "root", "start", "range")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        rec = _rec
        self.id = rec.next_id
        rec.next_id += 1
        if rec.open:
            self.parent, self.root = rec.open[-1]
        else:
            self.parent, self.root = None, rec.next_root
            rec.next_root += 1
        rec.open.append((self.id, self.root))
        self.range = torch.profiler.record_function("mjrl." + self.name)
        self.range.__enter__()
        self.start = _now()
        return self

    def __exit__(self, *exc):
        end = _now()
        self.range.__exit__(*exc)
        _rec.open.pop()
        _rec.spans.append((self.name, self.id, self.parent, self.root, self.start, end))
        return False


def enabled() -> bool:
    return _on


def enable() -> None:
    """Turn tracing on (what it records is kept until :func:`reset`)."""
    global _on
    _on = True


def disable() -> None:
    global _on
    _on = False


def reset() -> None:
    """Drop everything recorded."""
    global _rec
    _rec = _Records()


def span(name: str):
    """A context manager: the span ``name`` around its body while tracing
    is on, else a shared no-op."""
    if not _on:
        return _OFF
    return _Span(name)


def spanned(name: str) -> Callable:
    """A decorator: each call of the function is the span ``name``."""
    def wrap(fn):
        @functools.wraps(fn)
        def traced(*args, **kwargs):
            if not _on:
                return fn(*args, **kwargs)
            with _Span(name):
                return fn(*args, **kwargs)
        return traced
    return wrap


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` (while tracing is on)."""
    if _on:
        _rec.counters[name] = _rec.counters.get(name, 0) + n


def peak(name: str, n: int) -> None:
    """Keep the largest ``n`` seen under ``name`` (while tracing is on)."""
    if _on:
        _rec.peaks[name] = max(_rec.peaks.get(name, n), n)


def host_read(name: str, tensor: torch.Tensor) -> Any:
    """``tensor.tolist()``: the program's read of a device value. While
    tracing is on, the read is counted under ``name`` with the time the
    host was blocked in it."""
    if not _on:
        return tensor.tolist()
    start = _now()
    out = tensor.tolist()
    end = _now()
    parent, root = _rec.open[-1] if _rec.open else (None, None)
    _rec.reads.append((name, parent, root, start, end))
    return out


def take() -> Dict[str, Any]:
    """The sums of what was recorded since the last take, and clears the
    counters: ``spans`` (name -> ``count``, ``total_ms``, ``self_ms``),
    ``counters``, ``peaks``, ``reads`` (name -> ``count``, ``wait_ms``)
    and ``roots`` (the root identifiers the spans belong to)."""
    rec = _rec
    spans, reads = rec.spans[rec.taken_spans:], rec.reads[rec.taken_reads:]
    rec.taken_spans, rec.taken_reads = len(rec.spans), len(rec.reads)
    covered: Dict[int, int] = {}
    for _, _, parent, _, start, end in spans:
        if parent is not None:
            covered[parent] = covered.get(parent, 0) + (end - start)
    out_spans: Dict[str, Dict[str, float]] = {}
    for name, sid, _, _, start, end in spans:
        s = out_spans.setdefault(name, {"count": 0, "total_ms": 0.0, "self_ms": 0.0})
        s["count"] += 1
        s["total_ms"] += (end - start) * 1e-6
        s["self_ms"] += (end - start - covered.get(sid, 0)) * 1e-6
    out_reads: Dict[str, Dict[str, float]] = {}
    for name, _, _, start, end in reads:
        r = out_reads.setdefault(name, {"count": 0, "wait_ms": 0.0})
        r["count"] += 1
        r["wait_ms"] += (end - start) * 1e-6
    out = {"spans": out_spans, "counters": rec.counters, "peaks": rec.peaks, "reads": out_reads,
           "roots": sorted({root for *_, root, _, _ in spans})}
    rec.counters, rec.peaks = {}, {}
    return out


def write_chrome(path: str) -> None:
    """Every span and read recorded, as Chrome trace JSON (``chrome://tracing``,
    Perfetto): complete events in microseconds from the first record, each
    with its root's identifier and its parent span's (a span's own too)."""
    rec = _rec
    events = [(start, end, name, "span", {"root": root, "id": sid, "parent": parent})
              for name, sid, parent, root, start, end in rec.spans]
    events += [(start, end, name, "read", {"root": root, "parent": parent})
               for name, parent, root, start, end in rec.reads]
    t0 = min((e[0] for e in events), default=0)
    pid = os.getpid()
    trace_events = [{"name": name, "cat": cat, "ph": "X", "ts": (start - t0) * 1e-3,
                     "dur": (end - start) * 1e-3, "pid": pid, "tid": 0, "args": args}
                    for start, end, name, cat, args in sorted(events, key=lambda e: (e[0], -e[1]))]
    with open(path, "w") as f:
        json.dump({"traceEvents": trace_events, "displayTimeUnit": "ms"}, f)

