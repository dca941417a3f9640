"""Spans and counters of the program's own stages, recorded only while a
`torch.profiler` session records.

    with span("cm", device=True):      # a stage of the step
        ...
    count("host_int")                  # an event worth counting

Outside a profiler session `span` returns one shared no-op context and
`count` does nothing: a call costs one attribute read.  There is no flag
of its own: the CLI's `--profile DIR` and any caller's `torch.profiler`
session turn it on.

While a session records, a span

  - enters a profiler range `pigs::<name>`, so the profiler's trace (the
    Chrome trace of `--profile`) shows it as a host operation.  The range
    is a function-scope record (`_RecordFunctionFast`), not the user
    scope of `record_function`: the profiler mirrors every user-scope
    range that holds device work as an annotation on the device's
    timeline, and a trace reader that takes every device event for a
    kernel would then read the card as busy through each span;
  - stamps its start and end with `time.time_ns()`, the Unix clock the
    profiler stamps its own events on, so spans can be matched with the
    trace's host calls and device intervals;
  - keeps the index of the enclosing open span as its parent;
  - with device=True, records two CUDA timing events on the current
    stream (from a pool, reused after `take`).

It launches nothing and never waits for the device.  `take()` returns the
spans and counters recorded since the last `take()` and clears them; a
device span's time between its two events needs both to have completed
(after a synchronisation, or a read-back of the block's statistics)."""

from __future__ import annotations

import contextlib
import time
from typing import NamedTuple

import torch
from torch._C._profiler import _RecordFunctionFast
from torch.autograd import profiler as _profiler


class Span(NamedTuple):
    name: str
    parent: int          # index of the enclosing span in take()'s list, -1
    t0_ns: int           # time.time_ns() at entry
    t1_ns: int           # and at exit
    device_ms: float     # between the span's CUDA events, or None


_NOOP = contextlib.nullcontext()
_spans = []     # [name, parent, t0_ns, t1_ns, events or None]
_open = []      # indices of the spans entered and not yet left
_counts = {}
_pool = []      # free CUDA timing events


def _event():
    return _pool.pop() if _pool else torch.cuda.Event(enable_timing=True)


class _Live:
    __slots__ = ("name", "device", "idx", "rf")

    def __init__(self, name: str, device: bool):
        self.name, self.device = name, device

    def __enter__(self):
        # stamped outside the annotation, so that the span holds it
        t0 = time.time_ns()
        self.rf = _RecordFunctionFast("pigs::" + self.name)
        self.rf.__enter__()
        events = None
        if self.device:
            events = (_event(), _event())
            events[0].record()
        self.idx = len(_spans)
        _spans.append([self.name, _open[-1] if _open else -1, t0, None,
                       events])
        _open.append(self.idx)
        return self

    def __exit__(self, *exc):
        rec = _spans[self.idx]
        if rec[4] is not None:
            rec[4][1].record()
        self.rf.__exit__(*exc)
        rec[3] = time.time_ns()
        _open.pop()
        return False


def span(name: str, device: bool = False):
    """A context that records the span `name` while a profiler session
    records (device=True: with CUDA events around it), else a no-op."""
    if not _profiler._is_profiler_enabled:
        return _NOOP
    return _Live(name, device)


def count(name: str, n: int = 1) -> None:
    """Add n to the counter `name` while a profiler session records."""
    if _profiler._is_profiler_enabled:
        _counts[name] = _counts.get(name, 0) + n


def take() -> tuple:
    """(spans, counters) recorded since the last take(), cleared here:
    a list of Span in order of entry and a {name: count} dict.  Raises
    RuntimeError inside an open span, or when a device span's events have
    not completed."""
    global _spans, _counts
    if _open:
        raise RuntimeError("spans.take() inside an open span")
    for rec in _spans:
        if rec[4] is not None and not rec[4][1].query():
            raise RuntimeError(f"span {rec[0]!r}: its CUDA events have not "
                               "completed; synchronise first")
    out = []
    for name, parent, t0, t1, events in _spans:
        ms = None
        if events is not None:
            ms = events[0].elapsed_time(events[1])
            _pool.extend(events)
        out.append(Span(name, parent, t0, t1, ms))
    counts, _spans, _counts = _counts, [], {}
    return out, counts
