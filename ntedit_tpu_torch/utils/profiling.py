"""Profiling: a device trace of a run, and stage timers.

The reference's only observability is GNU-time wrappers per pipeline
stage (ntedit_run_pipeline.smk:78-81) and coarse timestamps
(ntedit.cpp:2376,2589-2598).  This module gives the port's equivalents of
the JAX package's utils/profiling.py:

* ``trace(logdir)`` — a context manager around ``torch.profiler``: host
  activity, and the card's kernels and copies when the run is on CUDA,
  written as a Chrome trace (Perfetto, chrome://tracing) into ``logdir``
  or the directory ``NTEDIT_TPU_TRACE`` names.  A no-op when neither is
  set; a profiler that fails raises, and so does one that was asked for
  the card's activity and recorded no kernel or copy: no trace is written
  then.
* ``StageTimer`` — named wall-clock and throughput accounting.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Optional

TRACE_ENV = "NTEDIT_TPU_TRACE"


@contextlib.contextmanager
def trace(logdir: Optional[str] = None, device=None):
    """Profile the body into ``logdir`` (or ``$NTEDIT_TPU_TRACE``), with
    CUDA activity when ``device`` is a CUDA device.  Yields the path the
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
        yield path
        if ProfilerActivity.CUDA in activities:
            torch.cuda.synchronize()
    if ProfilerActivity.CUDA in activities and not device_events(prof):
        raise RuntimeError(
            "torch.profiler recorded no CUDA kernel or copy, so no trace was written to "
            f"{path}: the likely cause is a CUPTI session already spent in this process "
            "(an earlier profiler run)")
    prof.export_chrome_trace(path)


def device_events(prof) -> int:
    """The CUDA kernels, copies and sets a finished profiler recorded."""
    from torch.autograd import DeviceType

    return sum(1 for e in prof.events()
               if e.device_type == DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False))


class StageTimer:
    """Named stage wall-clock accounting with bases/sec rates."""

    def __init__(self):
        self.stages = {}  # name -> [seconds, units]

    @contextlib.contextmanager
    def stage(self, name: str, units: int = 0):
        t0 = time.time()
        try:
            yield
        finally:
            dt = time.time() - t0
            acc = self.stages.setdefault(name, [0.0, 0])
            acc[0] += dt
            acc[1] += units

    def summary(self) -> str:
        parts = []
        for name, (sec, units) in self.stages.items():
            rate = f" ({units / sec:,.0f}/s)" if units and sec > 0 else ""
            parts.append(f"{name} {sec:.2f}s{rate}")
        return "; ".join(parts)
