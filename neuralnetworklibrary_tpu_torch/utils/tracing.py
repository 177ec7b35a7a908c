"""Spans and counters of the port, at its layer boundaries; off by default.

A span is ``with span(name): ...`` around one layer's work.  Tracing is
on while :func:`enable` holds it on, and while a ``torch.profiler``
session records, so that every profiler trace carries the port's phases.
Off, :func:`span` returns one shared null context: it allocates nothing,
enters no profiler range and records no CUDA event.  On, a span records

- its name, and its start and end on ``time.perf_counter_ns()``;
- its thread;
- its parent: the innermost span open on its thread or, on a thread with
  none open, the innermost span open on the thread of the outermost one
  (the step's), so the spans that autograd's device thread opens in a
  backward sit under the span that called ``backward``;
- its step: the step span open when it opened (a span given ``step=``,
  ``learner.step``), else the step that follows the last one (0 before
  the first);
- while a profiler records, a ``record_function("nnl/" + name)`` range,
  which puts it among the profiler's host events on the clock of the
  device's kernels;
- with ``device=True``, a CUDA event on the current stream at entry and
  at exit (a device span that opens right where another closed, with no
  span boundary between, shares its event), read as device milliseconds
  by :func:`snapshot`.

:func:`mark` records a point: its device time is measured from the start
of its nearest device-span ancestor.  :func:`counters` reads the port's
launch counters where they live (the kernels' own ``.launches``
attributes, and the padded head product's and the expert layers' calls,
which count whether tracing is on or off, and the expert layers' held
assignments, counted on the device only while tracing is on); a step span
records them at its entry and exit.

Usage::

    tracing.enable()
    ...                       # train
    torch.cuda.synchronize()
    snap = tracing.snapshot() # {"spans": [...], "counters": {...}}
    tracing.disable(); tracing.reset()
"""

from __future__ import annotations

import itertools
import threading
import time

import torch

_profiler = torch.autograd.profiler   # imported by torch itself

_on = False
_local = threading.local()    # .stack: the spans open on this thread
_root: list = []              # the stack of the outermost open span's thread
_finished: list = []          # finished spans and marks, in closing order
_ids = itertools.count(1)
_step = 0
_last = None                  # (event, stream) of the last boundary, if a
                              # device span's


class _Null:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NULL = _Null()


def enable() -> None:
    """Turn tracing on until :func:`disable`."""
    global _on
    _on = True


def disable() -> None:
    global _on
    _on = False


def enabled() -> bool:
    """Whether spans record now: enabled, or under a recording profiler."""
    return _on or _profiler._is_profiler_enabled


def reset() -> None:
    """Drop every finished span and mark (spans still open stay open)."""
    global _step, _last
    _finished.clear()
    _step, _last = 0, None


def _stack() -> list:
    try:
        return _local.stack
    except AttributeError:
        _local.stack = []
        return _local.stack


def _parent(stack):
    global _root
    if stack:
        return stack[-1].id
    if _root and _root is not stack:
        return _root[-1].id
    _root = stack
    return None


def _boundary(device: bool, entry: bool = False):
    """The CUDA event of a device span's boundary (None off CUDA): at an
    entry, the event of the device span that just closed where no other
    boundary came between; at an exit, a new one.  Any other boundary
    (None) ends that sharing."""
    global _last
    if not (device and torch.cuda.is_initialized()):
        _last = None
        return None
    stream = torch.cuda.current_stream()
    if entry and _last is not None and _last[1] == stream:
        event = _last[0]
    else:
        event = torch.cuda.Event(enable_timing=True)
        event.record(stream)
    _last = None if entry else (event, stream)
    return event


class _Span:
    __slots__ = ("name", "id", "parent", "thread", "step", "begins",
                 "device", "start_ns", "end_ns", "e0", "e1", "data", "_rf")

    def __init__(self, name, device, begins):
        self.name, self.device, self.begins = name, device, begins
        self.data = {}

    def __enter__(self):
        global _step
        stack = _stack()
        self.id, self.parent = next(_ids), _parent(stack)
        self.thread = threading.get_ident()
        if self.begins is not None:
            _step = self.begins
            self.data["counters_in"] = counters()
        self.step = _step
        self._rf = None
        if _profiler._is_profiler_enabled:     # a range only a profiler sees
            self._rf = _profiler.record_function("nnl/" + self.name)
            self._rf.__enter__()
        self.e0 = _boundary(self.device, entry=True)
        self.start_ns = time.perf_counter_ns()
        stack.append(self)
        return self

    def __exit__(self, *exc):
        global _step
        self.end_ns = time.perf_counter_ns()
        self.e1 = _boundary(self.device)
        if self._rf is not None:
            self._rf.__exit__(*exc)
            self._rf = None
        _stack().pop()
        if self.begins is not None:
            self.data["counters_out"] = counters()
            _step = self.begins + 1
        _finished.append(self)
        return False


def span(name: str, device: bool = False, step=None):
    """A context manager around one layer's work (see the module's doc).
    ``step`` (an int) makes it the span of that step.  Entered, it gives
    the span, whose ``data`` dict :func:`snapshot` carries into its
    record, or None while tracing is off."""
    if not (_on or _profiler._is_profiler_enabled):
        return _NULL
    return _Span(name, device, step)


def mark(name: str) -> None:
    """Record the point ``name`` now, with a CUDA event where CUDA runs
    (e.g. from an autograd hook, when a gradient is ready)."""
    if not (_on or _profiler._is_profiler_enabled):
        return
    m = _Span(name, True, None)
    m.id, m.parent = next(_ids), _parent(_stack())
    m.thread, m.step = threading.get_ident(), _step
    m.start_ns = m.end_ns = time.perf_counter_ns()
    m.e0 = m.e1 = _boundary(True)
    m.data["mark"] = True
    _finished.append(m)


def counters() -> dict:
    """Every launch counter of the port, by ``<kernel>.launches``, and the
    expert layers' held assignments (``moe_experts.assignments``), which
    are counted on the device while tracing is on: a device copy here, a
    number in :func:`snapshot`."""
    from neuralnetworklibrary_tpu_torch.ops import (
        flash_attention,
        lstm_scan,
        moe,
        padded_head,
        paged_attention,
    )

    fns = (flash_attention.flash_fwd, flash_attention.flash_bwd_dq,
           flash_attention.flash_bwd_dkv, flash_attention.flash_bwd_dbias,
           lstm_scan.lstm_fwd, lstm_scan.lstm_bwd,
           paged_attention.paged_attention, padded_head.padded_head,
           moe.moe_experts)
    out = {f"{fn.__name__}.launches": fn.launches for fn in fns}
    out["moe_experts.assignments"] = moe.assignments()
    return out


def _numbers(counts: dict) -> dict:
    return {k: v if isinstance(v, int) else int(v) for k, v in counts.items()}


def _covered(intervals, a, b) -> int:
    """Nanoseconds of [a, b] that the (start, end) intervals cover."""
    total, at = 0, a
    for s, e in sorted(intervals):
        s, e = max(s, at), min(e, b)
        if e > s:
            total += e - s
            at = e
    return total


def snapshot() -> dict:
    """The finished spans and marks as records, and :func:`counters`.
    A record holds ``name``, ``id``, ``parent``, ``thread``, ``step``,
    ``start_ns``, ``end_ns``, ``self_ns`` (its duration less what its
    children cover), ``device_ms`` (a device span's time between its
    events; a mark's from its nearest device-span ancestor's start; else
    None) and its ``data`` (a mark's holds ``"mark": True``).  Reads the
    CUDA events: call it only after a synchronize."""
    done = list(_finished)
    by_id = {s.id: s for s in done}
    kids: dict = {}
    for s in done:
        kids.setdefault(s.parent, []).append((s.start_ns, s.end_ns))
    out = []
    for s in done:
        dev = None
        if s.e0 is not None and "mark" not in s.data:
            dev = s.e0.elapsed_time(s.e1)
        elif s.e0 is not None:
            up = by_id.get(s.parent)
            while up is not None and up.e0 is None:
                up = by_id.get(up.parent)
            if up is not None:
                dev = up.e0.elapsed_time(s.e0)
        data = {k: _numbers(v) if k.startswith("counters") else v
                for k, v in s.data.items()}
        out.append({"name": s.name, "id": s.id, "parent": s.parent,
                    "thread": s.thread, "step": s.step,
                    "start_ns": s.start_ns, "end_ns": s.end_ns,
                    "self_ns": s.end_ns - s.start_ns - _covered(
                        kids.get(s.id, ()), s.start_ns, s.end_ns),
                    "device_ms": dev, **data})
    return {"spans": out, "counters": _numbers(counters())}
