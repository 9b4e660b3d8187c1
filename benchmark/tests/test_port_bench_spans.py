"""The program's spans in a run (``benchmark/program_trace.py``): self time
per thread and its union over threads, clipped to the window; the device's
idle time by the span that covers it; the gaps' labels; the metrics that
read them; and a tiny cell run with the recorder on, traced and not."""

from __future__ import annotations

import time
from types import SimpleNamespace

import pytest
from torch.autograd import DeviceType

from benchmark import harness, program_trace
from benchmark.tests import tiny
from ntedit_tpu_torch.utils import profiling


def test_self_time_is_the_span_less_its_children_in_its_thread():
    spans = [("cli.engine", 1, 0, 100), ("engine.contig", 1, 10, 90),
             ("engine.gates", 1, 20, 30), ("engine.gates", 1, 50, 60),
             ("engine.repair", 2, 25, 70)]  # another thread: not a child
    pieces = program_trace.self_pieces(spans)
    own = {}
    for a, b, name, _ in pieces:
        own[name] = own.get(name, 0) + b - a
    assert own == {"cli.engine": 20, "engine.contig": 60, "engine.gates": 20,
                   "engine.repair": 45}
    assert all(start <= a for a, _, _, start in pieces)


def test_a_names_time_is_the_union_over_threads_clipped_to_the_window():
    spans = [("engine.repair", 1, 0, 40), ("engine.repair", 2, 30, 80),
             ("engine.repair", 3, 100, 130)]
    by = [p for p in program_trace.self_pieces(spans) if p[2] == "engine.repair"]
    assert program_trace.union_length(by) == 110
    assert program_trace.union_length(by, 10, 120) == 90


def test_idle_time_goes_to_the_covering_span_that_started_last():
    spans = [("cli.filter", 1, 0, 100), ("io.read", 1, 10, 40),
             ("engine.repair", 2, 30, 60)]
    pieces = program_trace.self_pieces(spans)
    got = program_trace.owners(pieces, [(0, 20), (35, 50), (90, 120)])
    assert got == [(0, 10, "cli.filter"), (10, 20, "io.read"), (35, 40, "engine.repair"),
                   (40, 50, "engine.repair"), (90, 100, "cli.filter"), (100, 120, None)]


class Event(SimpleNamespace):
    def __init__(self, name, t0, t1, device=DeviceType.CPU, annotation=False):
        super().__init__(name=name, time_range=SimpleNamespace(start=t0, end=t1),
                         device_type=device, is_user_annotation=annotation)


def fake_recording(offset_us: float):
    """A recording whose spans, moved by ``offset_us``, sit at the given
    profiler times: a job's reader, build and engine, and a repair in a
    worker thread."""
    rec = profiling.Recording()
    rec.anchors = [int((t - offset_us) * 1e3) for t in (1.0, 3.0, 5.0)]
    for name, tid, t0, t1 in [("cli.filter", 1, 100, 400), ("io.read", 1, 120, 300),
                              ("build.count", 1, 310, 390), ("cli.engine", 1, 400, 600),
                              ("engine.contig", 1, 410, 590), ("engine.repair", 2, 420, 580)]:
        rec.spans.append(profiling.Span(name, tid, None, int((t0 - offset_us) * 1e3),
                                        int((t1 - offset_us) * 1e3), {}))
    rec.counts = {"io.read_bases": [(0, 2_000_000)], "engine.bases": [(0, 500_000)],
                  "engine.gates": [(0, 400)], "engine.records": [(0, 100)]}
    return rec


def fake_events():
    """The window [50, 700], a job's cli range [90, 610], the clock ranges
    (the second the shortest), and device work at [300, 320] and [620, 650]."""
    return [Event("bench.window", 50, 700), Event("bench.job", 90, 620),
            Event("bench.cli", 90, 610),
            Event(profiling.CLOCK, 1.0, 3.0), Event(profiling.CLOCK, 3.0, 3.5),
            Event(profiling.CLOCK, 5.0, 7.0),
            Event("kernel_a", 300, 320, DeviceType.CUDA), Event("kernel_b", 620, 650, DeviceType.CUDA),
            Event("bench.window", 300, 650, DeviceType.CUDA, annotation=True)]


def test_stats_put_the_spans_on_the_device_timeline():
    got = program_trace.stats(fake_recording(-1000.0), fake_events())
    assert got["spans"] == pytest.approx({
        "cli.filter": 40e-6, "io.read": 180e-6, "build.count": 80e-6, "cli.engine": 20e-6,
        "engine.contig": 180e-6, "engine.repair": 160e-6})
    assert got["counters"]["io.read_bases"] == 2_000_000
    assert got["idle_s"] == pytest.approx(600e-6)
    # idle: [50, 300), [320, 620) and [650, 700) in the window; [600, 620)
    # inside the job's cli range but no program span
    assert got["idle_by_span"] == pytest.approx({
        "between_jobs": 50e-6 + 50e-6, "cli": 20e-6, "cli.filter": 20e-6 + 10e-6,
        "io.read": 180e-6, "build.count": 70e-6, "cli.engine": 10e-6 + 10e-6,
        "engine.contig": 10e-6 + 10e-6, "engine.repair": 160e-6})
    assert got["idle_gaps"][0] == ["engine.repair", pytest.approx(300e-6)]  # midpoint 470
    assert got["idle_gaps"][1] == ["io.read", pytest.approx(250e-6)]  # [50, 300): 175
    assert got["idle_gaps"][2] == ["between_jobs", pytest.approx(50e-6)]
    assert got["cli_covered"]["least"] == pytest.approx(500 / 520)
    assert got["clock_error_us"] == 0.5


def test_the_new_metrics_read_the_program_keys_and_stay_silent_without():
    run = harness.Run()
    run.job_s = [1.0, 1.0]
    run.trace = program_trace.stats(fake_recording(0.0), fake_events())
    run.trace["spans"].update({"io.save": 0.002, "io.render": 0.001})
    read = {n: harness.load_module("metrics", n).read for n in program_trace.NEW_METRICS}
    got = {n: f(run) for n, f in read.items()}
    assert got == pytest.approx({
        "io.reader_ms_per_gbp.reads": 180e-6 * 1e3 / 0.002,
        "io.files_ms_per_job.reads": 1.5,
        "build.host_ms_per_gbp.reads": 80e-6 * 1e3 / 0.002,
        "engine.ms_per_mbp.reads": 340e-6 * 1e3 / 0.5,
        "engine.useful_gate_pct.reads": 25.0,
        "device.idle_in_reader_pct.reads": 100 * 180 / 600})
    run.trace = {"kernel_s": 0.0, "busy_s": 0.0, "window_s": 0.0}  # the harness's keys alone
    assert all(f(run) is None for f in read.values())
    run.trace = None
    assert all(f(run) is None for f in read.values())


@pytest.mark.parametrize("trace", [True, False])
def test_a_tiny_cell_runs_with_the_recorder_on(trace):
    spec = tiny.spec("ecoli_k25.reads")
    spec["metrics"]["per_layer"] += [{"name": n, "unit": u}
                                     for n, u in program_trace.NEW_METRICS.items()]
    with program_trace.recorded_window(harness) as box:
        out = harness.run_cell(spec, 4294967311, 0.2, trace, "cpu", time.perf_counter())
    assert harness.Run.__module__ == "benchmark.harness" and not profiling._on
    program = box["program"]
    assert out["correct"] and program["counters"]["io.read_bases"] > 0
    assert {"cli.histogram", "cli.filter", "cli.engine", "io.read", "engine.repair"} <= set(
        program["spans"])
    if trace:
        assert set(program_trace.NEW_METRICS) <= set(out["metrics"])
        assert program["cli_covered"]["least"] > 0.9
        assert [g[0] for g in out["breakdown"]["idle_gaps"]][0] != "cli"
    else:
        assert "read_bp_per_s" in out["metrics"]
