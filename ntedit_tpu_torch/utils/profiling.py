"""Profiling: the program's spans and counters, and a device trace of a run.

The reference's only observability is GNU-time wrappers per pipeline
stage (ntedit_run_pipeline.smk:78-81) and coarse timestamps
(ntedit.cpp:2376,2589-2598).  This module is the port's one recorder:

* ``span(name, **ids)`` — a context manager around a piece of the
  program's work (a stage, a batch, a chunk, a bucket, a contig), and
  ``count(name, n)``, which adds to a counter.  While no recording is on,
  each checks one module-level flag and returns: no record is made and no
  ``torch.profiler`` range is opened.  While one is on, a span keeps
  ``Span(name, tid, parent, start_ns, end_ns, ids)`` in memory, from any
  thread, on ``time.perf_counter_ns``: ``tid`` is the thread's native id
  (the one the profiler's host events carry), ``parent`` the name of the
  span open in the same thread, ``ids`` the span's own and those of its
  parent (the contig's ordinal, ``contig``).  A span in a worker thread
  takes its ids from ``ids()`` read in the thread that handed it the work.
* ``recording()`` — turns recording on for its body and yields the
  ``Recording`` that holds the spans and counters.  On entry it opens
  ``ntedit.clock`` ranges of ``torch.profiler`` and reads the clock inside
  each, so that a profiler session around it can put every span onto its
  own timeline (``Recording.offset_us``); the shortest range bounds the
  error.
* ``trace(logdir)`` — a ``torch.profiler`` session around the body, with
  the card's kernels and copies when the run is on CUDA, and a recording
  inside it, written as one Chrome trace (Perfetto, chrome://tracing) into
  ``logdir`` or the directory ``NTEDIT_TPU_TRACE`` names: the spans as
  complete events ``ntedit.<name>`` on their threads, the counters as
  counter events.  A no-op when neither is set; a profiler that fails
  raises, and so does one that was asked for the card's activity and
  recorded no kernel or copy: no trace is written then.

Recording turns on in these two ways only.
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
import time
from typing import NamedTuple, Optional

TRACE_ENV = "NTEDIT_TPU_TRACE"
CLOCK = "ntedit.clock"  # the profiler ranges the recorder's clock is read in
ANCHORS = 3  # clock ranges a recording opens: the first in a process is slow

_NULL = contextlib.nullcontext()
_on = False  # the flag every span and count checks
_rec: Optional["Recording"] = None
_lock = threading.Lock()
_local = threading.local()


class Span(NamedTuple):
    name: str
    tid: int
    parent: Optional[str]
    start_ns: int
    end_ns: int
    ids: dict


class Recording:
    """The spans and counters of one recording.  ``counts`` maps a counter
    to its increments ``(t_ns, n)``; ``anchors`` are the clock's readings
    inside the ``ntedit.clock`` ranges, in order."""

    def __init__(self):
        self.spans: list = []
        self.counts: dict = {}
        self.anchors: list = []

    @property
    def counters(self) -> dict:
        return {name: sum(n for _, n in incs) for name, incs in self.counts.items()}

    def offset_us(self, ranges) -> float:
        """The offset that puts this recording's clock onto a profiler's
        timeline, ``t_us = t_ns / 1000 + offset``, from the ``(start_us,
        duration_us)`` of its ``ntedit.clock`` ranges on that timeline, in
        order: the reading inside the shortest range against that range's
        start.  The error is under that range's duration."""
        if len(ranges) != len(self.anchors):
            raise ValueError(f"{len(ranges)} {CLOCK} ranges for {len(self.anchors)} readings")
        start, _, t_ns = min(((s, d, t) for (s, d), t in zip(ranges, self.anchors)),
                             key=lambda r: r[1])
        return start - t_ns / 1000


class _Span:
    __slots__ = ("name", "ids", "rec", "parent", "stack", "start")

    def __init__(self, name: str, ids: dict):
        self.name, self.ids = name, ids

    def __enter__(self):
        self.rec = _rec
        stack = self.stack = _local.__dict__.setdefault("stack", [])
        self.parent = stack[-1] if stack else None
        if self.parent is not None and self.parent.ids:
            self.ids = {**self.parent.ids, **self.ids}
        stack.append(self)
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        end = time.perf_counter_ns()
        self.stack.pop()
        if self.rec is not None and self.rec is _rec:  # one that outlives its recording is dropped
            rec = Span(self.name, threading.get_native_id(),
                       None if self.parent is None else self.parent.name,
                       self.start, end, self.ids)
            with _lock:
                self.rec.spans.append(rec)
        return False


def span(name: str, **ids):
    """A span of the program's work named ``name`` (see the module's
    docstring); a shared no-op context while no recording is on."""
    if not _on:
        return _NULL
    return _Span(name, ids)


def count(name: str, n: int) -> None:
    """Add ``n`` to the counter ``name`` while a recording is on."""
    if not _on:
        return
    t = time.perf_counter_ns()
    with _lock:
        if _rec is not None:
            _rec.counts.setdefault(name, []).append((t, int(n)))


def ids() -> dict:
    """The ids of the innermost span open in this thread ({} when none, or
    while no recording is on): what a span in a worker thread takes."""
    if not _on:
        return {}
    stack = getattr(_local, "stack", None)
    return dict(stack[-1].ids) if stack else {}


@contextlib.contextmanager
def recording():
    """Record spans and counters for the body; yields the ``Recording``.
    Recordings do not nest: entering one inside another raises."""
    global _on, _rec
    import torch

    with _lock:
        if _rec is not None:
            raise RuntimeError("a recording is already on")
        rec = _rec = Recording()
    for _ in range(ANCHORS):
        with torch.profiler.record_function(CLOCK):
            rec.anchors.append(time.perf_counter_ns())
    _on = True
    try:
        yield rec
    finally:
        with _lock:
            _on, _rec = False, None


@contextlib.contextmanager
def trace(logdir: Optional[str] = None, device=None):
    """Profile the body into ``logdir`` (or ``$NTEDIT_TPU_TRACE``), with
    CUDA activity when ``device`` is a CUDA device, and record the
    program's spans and counters into the same trace.  Yields the path the
    trace is written to when the body ends, or None when tracing is off.
    Raises instead of writing a trace that holds no device event where
    CUDA activity was asked for."""
    logdir = logdir or os.environ.get(TRACE_ENV)
    if not logdir:
        yield None
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if device is not None and torch.device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    path = os.path.join(logdir, f"ntedit_tpu_torch.{time.strftime('%Y%m%d-%H%M%S')}."
                                f"{os.getpid()}.pt.trace.json")
    with profile(activities=activities) as prof:
        with recording() as rec:
            yield path
            if ProfilerActivity.CUDA in activities:
                torch.cuda.synchronize()
    if ProfilerActivity.CUDA in activities and not device_events(prof):
        raise RuntimeError(
            "torch.profiler recorded no CUDA kernel or copy, so no trace was written to "
            f"{path}: the likely cause is a CUPTI session already spent in this process "
            "(an earlier profiler run)")
    prof.export_chrome_trace(path)
    merge_into_chrome_trace(path, rec)


def device_events(prof) -> int:
    """The CUDA kernels, copies and sets a finished profiler recorded."""
    from torch.autograd import DeviceType

    return sum(1 for e in prof.events()
               if e.device_type == DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False))


def merge_into_chrome_trace(path: str, rec: Recording) -> None:
    """Add the recording's spans (complete events ``ntedit.<name>``, ``cat``
    ntedit, on their threads, their ids as args) and counters (counter
    events, the running total at each increment) to the Chrome trace at
    ``path``, on its timeline."""
    with open(path) as f:
        doc = json.load(f)
    events = doc["traceEvents"]
    clock = sorted((e["ts"], e.get("dur", 0)) for e in events
                   if e.get("name") == CLOCK and e.get("ph") == "X"
                   and e.get("cat") != "gpu_user_annotation")
    off = rec.offset_us(clock)
    pid = os.getpid()
    for s in rec.spans:
        events.append({"ph": "X", "cat": "ntedit", "name": f"ntedit.{s.name}", "pid": pid,
                       "tid": s.tid, "ts": s.start_ns / 1000 + off,
                       "dur": (s.end_ns - s.start_ns) / 1000, "args": s.ids})
    for name, incs in rec.counts.items():
        total = 0
        for t, n in incs:
            total += n
            events.append({"ph": "C", "cat": "ntedit", "name": f"ntedit.{name}", "pid": pid,
                           "ts": t / 1000 + off, "args": {name: total}})
    with open(path, "w") as f:
        json.dump(doc, f)
