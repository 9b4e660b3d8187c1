"""The program's own spans and counters over a run's window.

``ntedit_tpu_torch/utils/profiling.py`` records spans (``Span``: name,
thread, parent, start and end on ``time.perf_counter_ns``, ids) and
counters while a recording is on, and opens ``ntedit.clock`` ranges of the
profiler on entry, which put its clock onto the profiler's timeline.
``stats`` reads one recording of a window:

* ``spans``: the self time in seconds of each name.  A span's self time is
  the span less its children in its own thread; a name's time is the
  length of the union, over threads, of its self intervals, clipped to the
  window.
* ``counters``: the counters' totals (the recording is the window).
* ``idle_by_span``: with a device trace, the device's idle seconds by the
  program span that covers them: of the spans whose self interval covers
  an instant, the one that started last, over all threads; the harness's
  own label (``cli``, ``between_jobs``) where none does.
* ``idle_gaps``: the ten longest idle gaps, each labelled that way at its
  midpoint.
* ``cli_covered``: the share of each job's ``bench.cli`` range that the
  union of the program's spans covers (least, median, jobs).
* ``clock_error_us``: the shortest ``ntedit.clock`` range, the bound of
  the offset's error.

A run of a cell with the recorder on for its window, as ``run.py`` runs it
otherwise, and the metrics of ``metrics/`` that read these keys::

    python3 benchmark/program_trace.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

With ``--trace 1`` the window runs under the profiler as ``run.py --trace 1``
runs it, and the result line holds the per-layer metrics, the program's
keys under ``program`` and the gaps labelled by program span; with
``--trace 0`` it holds the end-to-end metrics with the recorder on (its cost
against ``run.py --trace 0`` on the same seed).  ``harness.run_cell`` does
not enter the recorder itself: this script gives it a ``Run`` whose window
span does, and a ``trace_stats`` that adds ``stats``.
"""

from __future__ import annotations

import contextlib
import json
import os
import statistics
import sys
import time
from collections import defaultdict
from typing import Optional

NEW_METRICS = {  # the per-layer metrics that read these keys, and their units
    "io.reader_ms_per_gbp.reads": "ms/Gbp",
    "io.files_ms_per_job.reads": "ms",
    "build.host_ms_per_gbp.reads": "ms/Gbp",
    "engine.ms_per_mbp.reads": "ms/Mbp",
    "engine.useful_gate_pct.reads": "%",
    "device.idle_in_reader_pct.reads": "%",
}
CLOCK = "ntedit.clock"


def program_keys(run) -> tuple:
    """A run's program spans and counters (``stats``' ``spans`` and
    ``counters``), or (None, None) where its trace has none."""
    t = run.trace or {}
    if "spans" not in t:
        return None, None
    return t["spans"], t["counters"]


def self_pieces(spans) -> list:
    """``spans`` as (name, tid, start, end) -> their self intervals, each
    (start, end, name, the span's start): in each thread the innermost
    open span owns an instant."""
    out = []
    by_tid = defaultdict(list)
    for s in spans:
        by_tid[s[1]].append(s)
    for ss in by_tid.values():
        ss.sort(key=lambda s: (s[2], -s[3]))
        stack, cur = [], None

        def close_until(t):
            nonlocal cur
            while stack and stack[-1][2] <= t:
                name, start, end = stack.pop()
                if end > cur:
                    out.append((cur, end, name, start))
                    cur = end
            if stack and t > cur:
                out.append((cur, t, stack[-1][0], stack[-1][1]))
            cur = max(cur, t)

        for name, _, a, b in ss:
            if cur is None:
                cur = a
            close_until(a)
            if stack:
                b = min(b, stack[-1][2])  # rounding of the mapped times
            stack.append((name, a, b))
        close_until(float("inf"))
    return [p for p in out if p[1] > p[0]]


def union_length(intervals, lo: float = float("-inf"), hi: float = float("inf")) -> float:
    """The length of the union of ``intervals`` (start, end, ...) within
    [lo, hi]."""
    total, end = 0.0, lo
    for a, b, *_ in sorted(intervals):
        a, b = max(a, end), min(b, hi)
        if b > a:
            total += b - a
            end = b
    return total


def owners(pieces, intervals) -> list:
    """For each stretch of ``intervals`` (start, end) the self piece that
    owns it: (start, end, name or None), the owner of an instant being the
    covering piece whose span started last."""
    marks = []
    for i, (a, b, name, start) in enumerate(pieces):
        marks += [(a, 1, i), (b, -1, i)]
    for a, b in intervals:
        marks += [(a, 2, -1), (b, -2, -1)]
    marks.sort(key=lambda m: (m[0], m[1]))
    active, inside, out, last = set(), 0, [], None
    for t, kind, i in marks:
        if last is not None and inside and t > last:
            who = max(active, key=lambda j: pieces[j][3]) if active else None
            out.append((last, t, None if who is None else pieces[who][2]))
        last = t
        if kind == 1:
            active.add(i)
        elif kind == -1:
            active.discard(i)
        else:
            inside += kind // 2
    return out


def _owner_at(pieces, t: float) -> Optional[str]:
    hit = [p for p in pieces if p[0] <= t < p[1]]
    return max(hit, key=lambda p: p[3])[2] if hit else None


def stats(rec, events=None) -> dict:
    """The program's keys of one recording of the window (see the module's
    docstring); ``events``: the profiler's events of the same window, or
    None for a run without one (the recorder's own clock then, and no
    device keys)."""
    off, w0, w1 = 0.0, float("-inf"), float("inf")
    if events is not None:
        from torch.autograd import DeviceType

        dev, notes, clock = [], [], []
        for e in events:
            t0, t1 = e.time_range.start, e.time_range.end
            if e.device_type == DeviceType.CUDA:
                if not getattr(e, "is_user_annotation", False):
                    dev.append((t0, t1))
            elif e.name == CLOCK:
                clock.append((t0, t1 - t0))
            elif e.name.startswith("bench."):
                notes.append((t0, t1, e.name[6:]))
        off = rec.offset_us(sorted(clock))
        w0, w1 = next((a, b) for a, b, n in notes if n == "window")
    raw = [(s.name, s.tid, s.start_ns / 1e3 + off, s.end_ns / 1e3 + off) for s in rec.spans]
    pieces = self_pieces(raw)
    names = defaultdict(list)
    for p in pieces:
        names[p[2]].append(p)
    out = {"spans": {n: union_length(ps, w0, w1) / 1e6 for n, ps in sorted(names.items())},
           "counters": rec.counters, "spans_recorded": len(rec.spans)}
    if events is None:
        return out
    # the device's idle stretches in the window
    idle, end = [], w0
    for a, b in sorted(dev):
        a, b = max(a, w0), min(b, w1)
        if b <= end:
            continue
        if a > end:
            idle.append((end, a))
        end = b
    if w1 > end:
        idle.append((end, w1))
    inner = [n for n in notes if n[2] not in ("window", "job")]

    def label(a, b):
        t = (a + b) / 2
        hit = [n[2] for n in inner if n[0] <= t <= n[1]]
        return hit[0] if hit else "between_jobs"

    by_span = defaultdict(float)
    for a, b, who in owners(pieces, idle):
        by_span[who or label(a, b)] += (b - a) / 1e6
    gaps = sorted(idle, key=lambda g: g[1] - g[0], reverse=True)[:10]
    whole = [(a, b) for _, _, a, b in raw]
    covered = [union_length(whole, c0, c1) / (c1 - c0) for c0, c1, n in notes
               if n == "cli" and c1 > c0]
    out.update({
        "idle_by_span": dict(sorted(by_span.items(), key=lambda x: -x[1])),
        "idle_s": sum(b - a for a, b in idle) / 1e6,
        "idle_gaps": [[_owner_at(pieces, (a + b) / 2) or label(a, b), (b - a) / 1e6]
                      for a, b in gaps],
        "cli_covered": {"least": min(covered) if covered else None,
                        "median": statistics.median(covered) if covered else None,
                        "jobs": len(covered)},
        "clock_error_us": min(d for _, d in clock)})
    return out


@contextlib.contextmanager
def recorded_window(harness):
    """``harness.run_cell`` with the recorder on for each run's window and,
    in a traced run, ``stats`` in its trace: yields a dict that holds the
    last window's ``stats`` under ``program``."""
    from ntedit_tpu_torch.utils import profiling

    box = {}
    base_run, base_stats = harness.Run, harness.trace_stats

    class Run(base_run):
        @contextlib.contextmanager
        def span(self, name, annotate=False):
            with super().span(name, annotate):
                if name != "window":
                    yield
                    return
                with profiling.recording() as rec:
                    box["rec"] = rec
                    yield
            if not annotate:  # an untraced run: no profiler, the recorder's own clock
                box["program"] = stats(rec)

    def trace_stats(prof):
        out = base_stats(prof)
        box["program"] = got = stats(box["rec"], prof.events())
        out.update(got)
        return out

    harness.Run, harness.trace_stats = Run, trace_stats
    try:
        yield box
    finally:
        harness.Run, harness.trace_stats = base_run, base_stats


def main(argv: Optional[list] = None) -> int:
    t_start = time.perf_counter()
    import argparse

    ap = argparse.ArgumentParser(description="one run of one cell with the program's spans on")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=1)
    args = ap.parse_args(argv)
    from benchmark import harness

    os.environ["TRITON_CACHE_DIR"] = os.path.join(harness.BENCH, "_cache", "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(harness.BENCH, "_cache", "torch_extensions")
    import torch

    if not torch.cuda.is_available():
        print("error: the run needs a CUDA device", file=sys.stderr)
        return 2
    spec = harness.load_spec(args.workload)
    spec["metrics"]["per_layer"] += [{"name": n, "unit": u} for n, u in NEW_METRICS.items()]
    with recorded_window(harness) as box:
        out = harness.run_cell(spec, args.seed, args.seconds, bool(args.trace), "cuda", t_start)
    program = box["program"]
    program.pop("idle_gaps", None)  # the breakdown's, labelled by program span
    program["spans_per_job"] = program["spans_recorded"] / max(1, out["job_s"]["n"])
    out["program"] = program
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.path[0] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.exit(main())
