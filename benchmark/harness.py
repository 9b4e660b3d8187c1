"""The benchmark's harness: one run of one cell.

It finds everything by name.  ``BENCHMARK.json`` names the cell, its
configuration and its traffic; the configuration is
``benchmark/configs/<config>.json``, the traffic
``benchmark/traffic/<traffic>.json``, whose ``kind`` is the module
``benchmark/kinds/<kind>.py`` that makes the inputs and runs the jobs;
each metric is the reader ``benchmark/metrics/<metric>.py``; each pass
the traffic names for the roofline's counts is ``benchmark/work/<pass>.py``.
A later cell, configuration, traffic or metric adds files and entries.

A run: set-up (inputs from the seed, the program made once, one job to
warm every shape), then jobs back to back for ``seconds``: the window
ends with the last job that started inside it, so every job counts
whole; with ``trace`` the window runs under one profiler session of its
own.  After the window the peak memory is read, the program's state is
freed, and the reference compares the jobs' outputs (``check.py``).
"""

from __future__ import annotations

import contextlib
import importlib.util
import json
import os
import sys
import time
from collections import defaultdict
from typing import Optional

import numpy as np

BENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH)
FORBIDDEN = ("jax", "jaxlib", "flax", "ntedit_tpu")  # top-level module names, whole


def load_module(kind: str, name: str):
    """``benchmark/<kind>/<name>.py`` as a module (names may hold dots)."""
    path = os.path.join(BENCH, kind, f"{name}.py")
    qual = f"benchmark.{kind}.{name.replace('.', '_')}"
    if qual in sys.modules:
        return sys.modules[qual]
    spec = importlib.util.spec_from_file_location(qual, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[qual] = mod
    spec.loader.exec_module(mod)
    return mod


def load_json(*parts):
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def load_spec(workload: str, root: str = ROOT) -> dict:
    """The cell ``workload`` of ``BENCHMARK.json``: its entry, its
    configuration and traffic files, and the metrics it reports."""
    bench = load_json(root, "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}: one of {', '.join(cells)}")
    cell = cells[workload]
    metrics = {group: [m for m in bench[group] if workload in m.get("workloads", [workload])]
               for group in ("end_to_end", "per_layer")}
    return spec_of(cell["config"], cell["traffic"], metrics, cell)


def spec_of(config: str, traffic: str, metrics: dict, cell: Optional[dict] = None) -> dict:
    """A cell's spec from its configuration and traffic names."""
    return {
        "cell": cell or {"name": f"{config}.{traffic}", "chips": 1},
        "config": load_json(BENCH, "configs", f"{config}.json"),
        "traffic": load_json(BENCH, "traffic", f"{traffic}.json"),
        "metrics": metrics,
    }


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


class Run:
    """What the metric readers read."""

    def __init__(self):
        self.spans = defaultdict(float)
        self.job_s = []
        self.bases = 0
        self.window_s = 0.0
        self.setup_s = 0.0
        self.trace = None
        self.least_s = None

    def span_s(self, name: str) -> float:
        return self.spans[name]

    @contextlib.contextmanager
    def span(self, name: str, annotate: bool = False):
        """Time the body into ``spans[name]``; with ``annotate``, also as a
        ``bench.<name>`` range of the profiler's trace."""
        import torch

        with torch.profiler.record_function(f"bench.{name}") if annotate else contextlib.nullcontext():
            t = time.perf_counter()
            try:
                yield
            finally:
                self.spans[name] += time.perf_counter() - t


def trace_stats(prof) -> dict:
    """Kernel time, the device's busy time, the window, the busiest device
    operations and the longest idle gaps, from one profiler session over
    the window (the pattern of ``ntedit_tpu_torch/utils/profiling.trace``,
    copied)."""
    from torch.autograd import DeviceType

    dev, notes = [], []
    for e in prof.events():
        t0, t1 = e.time_range.start, e.time_range.end
        if e.device_type == DeviceType.CUDA and not getattr(e, "is_user_annotation", False):
            dev.append((t0, t1, e.name))
        elif e.name.startswith("bench."):
            notes.append((t0, t1, e.name[6:]))
    window = [n for n in notes if n[2] == "window"]
    if not window or not dev:
        return {"kernel_s": 0.0, "busy_s": 0.0, "window_s": 0.0, "device_ops": [], "idle_gaps": []}
    w0, w1 = window[0][0], window[0][1]
    by_name = defaultdict(float)
    kernel_us = 0.0
    for t0, t1, name in dev:
        by_name[name] += (t1 - t0) / 1e6
        if not name.startswith(("Memcpy", "Memset")):
            kernel_us += t1 - t0
    busy, gaps, end = 0.0, [], w0
    for t0, t1, _ in sorted(dev):
        t0, t1 = max(t0, w0), min(t1, w1)
        if t1 <= end:
            continue
        if t0 > end:
            gaps.append((end, t0))
        busy += t1 - max(t0, end)
        end = t1
    if w1 > end:
        gaps.append((end, w1))
    inner = [n for n in notes if n[2] not in ("window", "job")]

    def doing(a, b):
        mid = (a + b) / 2
        hit = [n[2] for n in inner if n[0] <= mid <= n[1]]
        return hit[0] if hit else "between_jobs"

    gaps.sort(key=lambda g: g[1] - g[0], reverse=True)
    return {
        "kernel_s": kernel_us / 1e6,
        "busy_s": busy / 1e6,
        "window_s": (w1 - w0) / 1e6,
        "device_ops": [[n, s] for n, s in sorted(by_name.items(), key=lambda x: -x[1])[:10]],
        "idle_gaps": [[doing(a, b), (b - a) / 1e6] for a, b in gaps[:10]],
    }


def run_cell(spec: dict, seed: int, seconds: float, trace: bool, device: str,
             t_start: float, fault=None, log=sys.stderr) -> dict:
    """One run of the cell; -> the result line's object."""
    import torch

    traffic = spec["traffic"]
    kind = load_module("kinds", traffic["kind"])
    work = {p: load_module("work", p).needs for p in traffic.get("passes", [])} if trace else {}
    cell = kind.Cell(spec["config"], traffic, seed, device, work, fault=fault)
    run = Run()
    warm = Run()
    cell.job(0, warm.span)  # warms every shape the window uses
    if device == "cuda":
        torch.cuda.synchronize()
    run.setup_s = time.perf_counter() - t_start
    done, failed = [], 0
    prof = None
    if trace:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device == "cuda" else [])
        prof = profile(activities=acts)
        prof.__enter__()
    try:
        with run.span("window", annotate=trace):
            t0 = time.perf_counter()
            job = 1
            while time.perf_counter() - t0 < seconds:
                t = time.perf_counter()
                try:
                    with run.span("job", annotate=trace):
                        idx, bases, outputs = cell.job(job, lambda n: run.span(n, trace))
                except Exception as exc:  # a job that fails counts, and the loop goes on
                    print(f"job {job} failed: {exc!r}", file=log)
                    failed += 1
                else:
                    run.job_s.append(time.perf_counter() - t)
                    run.bases += bases
                    done.append((idx, outputs))
                job += 1
            if device == "cuda":
                torch.cuda.synchronize()
            run.window_s = time.perf_counter() - t0
    finally:
        if prof is not None:
            prof.__exit__(None, None, None)
    if prof is not None:
        run.trace = trace_stats(prof)
        prof = None
    if cell.least_s is not None:
        run.least_s = sum(cell.least_s[idx] for idx, _ in done)
    peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0
    cell.close()
    t = time.perf_counter()
    compared, on = cell.check(done)
    on["check_s"] = time.perf_counter() - t
    from benchmark import check

    correct = check.verdict(compared, on) and failed == 0 and bool(done)
    group = "per_layer" if trace else "end_to_end"
    metrics = {}
    for m in spec["metrics"][group]:
        v = load_module("metrics", m["name"]).read(run)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    dev = {"platform": "gpu" if device == "cuda" else "cpu",
           "kind": torch.cuda.get_device_name(0) if device == "cuda" else "cpu",
           "count": 1, "memory_peak_bytes": int(peak)}
    out = {"correct": bool(correct), "attempted": len(done) + failed, "failed": failed,
           "metrics": metrics, "device": dev}
    if trace and run.trace is not None:
        dev["busy_s"] = run.trace["busy_s"]
        dev["window_s"] = run.trace["window_s"]
        out["breakdown"] = {"device_ops": run.trace["device_ops"],
                            "idle_gaps": run.trace["idle_gaps"]}
    out["inputs"] = cell.stats
    if run.job_s:
        q = np.percentile(np.asarray(run.job_s), [0, 25, 50, 75, 95, 100])
        out["job_s"] = {"n": len(run.job_s), "quantiles_0_25_50_75_95_100": q.tolist()}
    out["checked"] = on
    out["compared"] = {k: {"value": v, "limit": check.LIMITS[k]} for k, v in compared.items()}
    return out


def main(argv: Optional[list] = None) -> int:
    t_start = time.perf_counter()
    import argparse

    ap = argparse.ArgumentParser(description="one run of one benchmark cell on the card")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    # build and kernel caches at fixed paths inside the checkout
    os.environ["TRITON_CACHE_DIR"] = os.path.join(BENCH, "_cache", "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(BENCH, "_cache", "torch_extensions")
    os.environ.setdefault("USE_FLAX", "0")
    import torch

    spec = load_spec(args.workload)
    chips = spec["cell"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"error: the cell needs {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    out = run_cell(spec, args.seed, args.seconds, bool(args.trace), "cuda", t_start)
    found = forbidden_modules()
    if found:
        print(f"error: the run loaded {', '.join(found)}", file=sys.stderr)
        return 3
    for name, c in out["compared"].items():
        print(f"compared {name} {c['value']} limit {c['limit']}", file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0
