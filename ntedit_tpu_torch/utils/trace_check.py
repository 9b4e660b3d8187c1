"""The recorder's clock against the device trace, and its cost, on the card.

    python -m ntedit_tpu_torch.utils.trace_check

Under one ``torch.profiler`` session (host and CUDA activity), inside
``profiling.recording()``: ``ROUNDS`` times, a tenth of a second apart, a
span opened inside a ``record_function`` range with a kernel launched
inside both.  It puts each span onto the profiler's timeline with the
recording's clock offset and prints one JSON line: the stated error (the
shortest ``ntedit.clock`` range), the largest distance of a span's start
from its range's start, how far each kernel's launch lies inside its span,
and the host cost in nanoseconds of a span and of a count, recording off
and on.  It needs a CUDA device.
"""

from __future__ import annotations

import json
import sys
import time
import timeit

from ntedit_tpu_torch.utils import profiling

ROUNDS = 100


def per_call_ns(fn, n: int = 200_000) -> float:
    return timeit.timeit(fn, number=n) / n * 1e9


def costs() -> dict:
    def one_span():
        with profiling.span("check"):
            pass

    def one_count():
        profiling.count("check", 1)

    off = {"span_ns": per_call_ns(one_span), "count_ns": per_call_ns(one_count)}
    with profiling.recording():
        on = {"span_ns": per_call_ns(one_span, 20_000), "count_ns": per_call_ns(one_count, 20_000)}
    return {"off": off, "on": on}


def main() -> int:
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    if not torch.cuda.is_available():
        print("error: trace_check needs a CUDA device", file=sys.stderr)
        return 2
    x = torch.ones(1 << 20, device="cuda")
    x.mul_(1.0)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with profiling.recording() as rec:
            for i in range(ROUNDS):
                with record_function(f"probe{i}"), profiling.span(f"probe{i}"):
                    x.mul_(1.0)
                time.sleep(0.1)
        torch.cuda.synchronize()
    events = sorted(prof.events(), key=lambda e: e.time_range.start)
    clock = [(e.time_range.start, e.time_range.end - e.time_range.start)
             for e in events if e.name == profiling.CLOCK]
    off = rec.offset_us(clock)
    ranges = {e.name: e.time_range for e in events if e.name.startswith("probe")
              and e.device_type.name == "CPU"}
    launches = [e.time_range for e in events if e.name in ("cudaLaunchKernel", "cuLaunchKernel")]
    start_err, inside = [], []
    for s in rec.spans:
        r = ranges[s.name]
        t0, t1 = s.start_ns / 1e3 + off, s.end_ns / 1e3 + off
        start_err.append(t0 - r.start)
        mine = [lr for lr in launches if r.start <= lr.start <= r.end]
        if mine:  # the launch's margins inside the span: both >= -error when placed right
            inside.append(min(mine[0].start - t0, t1 - mine[0].end))
    print(json.dumps({
        "device": torch.cuda.get_device_name(0), "rounds": ROUNDS, "spans": len(rec.spans),
        "stated_error_us": min(d for _, d in clock), "clock_ranges_us": [d for _, d in clock],
        "span_start_minus_range_start_us": {"least": min(start_err), "most": max(start_err)},
        "launches_found": len(inside),
        "launch_margin_in_span_us": {"least": min(inside), "most": max(inside)} if inside else None,
        "cost": costs()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
