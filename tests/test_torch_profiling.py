"""The torch port's profiling (utils/profiling.py) on the CPU: ``trace()``
does nothing without NTEDIT_TPU_TRACE or a directory, and with either
writes a Chrome trace of the body's host activity with the program's spans
and counters merged in; the command line wraps each subcommand in it.  The
recorder: off, a span or a count records nothing and opens no profiler
range; on, spans nest in a thread, keep a worker thread's id, counters
add, and the spans land on a profiler's timeline within the clock's stated
error; a tiny ``polish --reads`` records every span its path reaches; an
SNV run records its device pass's two spans inside ``engine.gates`` and
counts its candidates, site rows and repair segments, and a polish run
keeps its names."""

import json
import os
import sys
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from ntedit_tpu_torch.utils import profiling


def test_trace_is_a_no_op_without_the_variable(tmp_path, monkeypatch):
    monkeypatch.delenv(profiling.TRACE_ENV, raising=False)
    monkeypatch.chdir(tmp_path)
    with profiling.trace() as path:
        torch.ones(8).sum()
    assert path is None and not os.listdir(tmp_path)


@pytest.mark.parametrize("source", ["variable", "argument"])
def test_trace_writes_a_chrome_trace(tmp_path, monkeypatch, source):
    logdir = tmp_path / "traces"
    if source == "variable":
        monkeypatch.setenv(profiling.TRACE_ENV, str(logdir))
        ctx = profiling.trace(device="cpu")
    else:
        monkeypatch.delenv(profiling.TRACE_ENV, raising=False)
        ctx = profiling.trace(str(logdir))
    with ctx as path:
        (torch.arange(1000, dtype=torch.float32) * 2).sum()
    assert os.path.dirname(path) == str(logdir) and os.path.exists(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    assert any("aten::mul" in str(e.get("name")) for e in events)


def test_trace_without_a_device_event_raises(tmp_path, monkeypatch):
    """Asked for the card's activity, a profiler that recorded no CUDA
    kernel or copy (here a stub with host events only) makes trace() raise,
    naming the spent CUPTI session, and write nothing."""
    from torch.autograd import DeviceType

    class Event:
        def __init__(self, device_type, is_user_annotation=False):
            self.device_type, self.is_user_annotation = device_type, is_user_annotation

    class StubProfile:
        exported = []

        def __init__(self, activities):
            self.activities = activities

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

        def events(self):  # host events and a user annotation on the card
            return [Event(DeviceType.CPU), Event(DeviceType.CUDA, True)]

        def export_chrome_trace(self, path):  # a trace holding the recorder's clock ranges
            self.exported.append(path)
            clock = [{"ph": "X", "name": profiling.CLOCK, "ts": 10.0 * i, "dur": 1.0}
                     for i in range(profiling.ANCHORS)]
            with open(path, "w") as f:
                json.dump({"traceEvents": clock}, f)

    monkeypatch.setattr(torch.profiler, "profile", StubProfile)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    logdir = tmp_path / "traces"
    with pytest.raises(RuntimeError, match="CUPTI"):
        with profiling.trace(str(logdir), device="cuda"):
            torch.ones(8).sum()
    assert StubProfile.exported == [] and not os.listdir(logdir)
    # the same stub with a kernel recorded writes its trace; host-only
    # tracing never asks for one
    monkeypatch.setattr(StubProfile, "events", lambda self: [Event(DeviceType.CUDA)])
    with profiling.trace(str(logdir), device="cuda") as path:
        pass
    with profiling.trace(str(logdir), device="cpu") as host_path:
        pass
    assert StubProfile.exported == [path, host_path]


def test_engine_command_line_writes_a_trace(tmp_path, monkeypatch):
    from ntedit_tpu_torch import cli
    from ntedit_tpu_torch.core import bloom
    from ntedit_tpu_torch.utils import simulate

    truth = simulate.random_genome(3000, seed=5)
    draft = truth.copy()
    draft[1500] = ord("A") if truth[1500] != ord("A") else ord("C")
    bf = bloom.BlockedKmerBloomFilter.zeros(1 << 12, 3, 25)
    bf.insert_seq(truth)
    bf.save(str(tmp_path / "f.bf"))
    (tmp_path / "d.fa").write_text(f">c1\n{draft.tobytes().decode()}\n")
    monkeypatch.setenv(profiling.TRACE_ENV, str(tmp_path / "tr"))
    monkeypatch.chdir(tmp_path)
    cli.main(["engine", "-r", "f.bf", "-f", "d.fa", "-b", "out", "--device", "cpu", "-t", "1"])
    (name,) = os.listdir(tmp_path / "tr")
    with open(tmp_path / "tr" / name) as f:
        assert json.load(f)["traceEvents"]
    assert (tmp_path / "out_changes.tsv").read_text().count("\n") == 2


def test_recording_off_records_nothing(monkeypatch):
    """Off, a span is one shared no-op context and a count returns: no
    recording exists to grow and no profiler range is opened."""
    def no_range(name):
        raise AssertionError(f"record_function({name!r}) while recording is off")

    monkeypatch.setattr(torch.profiler, "record_function", no_range)
    assert profiling._rec is None
    with profiling.span("cli.engine"), profiling.span("engine.contig", contig=3):
        profiling.count("engine.bases", 100)
    assert profiling.span("io.read") is profiling.span("io.save", contig=1)
    assert profiling.ids() == {} and profiling._rec is None


class FakeClock:
    """``time.perf_counter_ns`` stepping 10 ns a reading."""

    def __init__(self):
        self.t = 0

    def __call__(self):
        self.t += 10
        return self.t


def test_spans_nest_and_self_time_in_one_thread(monkeypatch):
    """On, a span's parent is the span open in its thread, ids pass from
    parent to child, and a span minus its children is its self time."""
    with profiling.recording() as rec:
        monkeypatch.setattr(profiling.time, "perf_counter_ns", FakeClock())
        with profiling.span("engine.contig", contig=7):      # 10
            with profiling.span("engine.gates"):              # 20
                pass                                          # 30
            with profiling.span("engine.repair"):             # 40
                assert profiling.ids() == {"contig": 7}
                profiling.count("engine.gates", 5)            # 50
            pass                                              # 60
        with profiling.span("io.render"):                     # 70
            pass                                              # 80
    got = [(s.name, s.parent, s.start_ns, s.end_ns, s.ids) for s in rec.spans]
    assert got == [("engine.gates", "engine.contig", 20, 30, {"contig": 7}),
                   ("engine.repair", "engine.contig", 40, 60, {"contig": 7}),
                   ("engine.contig", None, 10, 70, {"contig": 7}),
                   ("io.render", None, 80, 90, {})]
    assert {s.tid for s in rec.spans} == {threading.get_native_id()}
    contig = rec.spans[2]
    children = sum(s.end_ns - s.start_ns for s in rec.spans if s.parent == "engine.contig")
    assert contig.end_ns - contig.start_ns - children == 30
    assert rec.counts == {"engine.gates": [(50, 5)]}


def test_span_in_a_worker_thread_keeps_its_thread_id():
    """A span opened in a ThreadPoolExecutor worker is kept, with the
    worker's native thread id and the ids handed to it."""
    def work(ids):
        with profiling.span("engine.repair", **ids):
            return threading.get_native_id()

    with profiling.recording() as rec:
        with profiling.span("engine.contig", contig=2):
            with ThreadPoolExecutor(max_workers=1) as ex:
                worker = ex.submit(work, profiling.ids()).result(timeout=30)
    repair, contig = rec.spans
    assert (repair.name, repair.tid, repair.parent, repair.ids) == (
        "engine.repair", worker, None, {"contig": 2})
    assert contig.tid == threading.get_native_id() != worker
    assert contig.start_ns < repair.start_ns <= repair.end_ns < contig.end_ns


def test_counters_add_from_many_threads():
    """Counts from more threads than cores, with a short switch interval,
    add up exactly; a recording is read after it ends and another starts
    empty; recordings do not nest."""
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with profiling.recording() as rec:
            def add(_):
                for _ in range(500):
                    profiling.count("io.read_bases", 3)
                profiling.count("engine.records", 1)

            with ThreadPoolExecutor(max_workers=4 * (os.cpu_count() or 1)) as ex:
                list(ex.map(add, range(32), timeout=60))
            with pytest.raises(RuntimeError, match="already on"):
                with profiling.recording():
                    pass
    finally:
        sys.setswitchinterval(interval)
    assert rec.counters == {"io.read_bases": 32 * 500 * 3, "engine.records": 32}
    with profiling.recording() as again:
        profiling.count("engine.bases", 1)
    assert again.counters == {"engine.bases": 1} and len(rec.counts["io.read_bases"]) == 16000


def test_span_lands_on_the_profilers_timeline():
    """Under a CPU profiler session, a span opened inside a
    ``record_function`` range at the same point lands, through the clock
    ranges' offset, inside that range within the stated error: the
    duration of the shortest ``ntedit.clock`` range."""
    from torch.profiler import ProfilerActivity, profile, record_function

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with profiling.recording() as rec:
            for i in range(3):
                with record_function(f"probe{i}"), profiling.span(f"probe{i}"):
                    torch.ones(64).sum()
    events = sorted(prof.events(), key=lambda e: e.time_range.start)
    clock = [(e.time_range.start, e.time_range.end - e.time_range.start)
             for e in events if e.name == profiling.CLOCK]
    off = rec.offset_us(clock)
    err = min(d for _, d in clock)
    ranges = {e.name: e.time_range for e in events if e.name.startswith("probe")}
    for s in rec.spans:
        r = ranges[s.name]
        t0, t1 = s.start_ns / 1000 + off, s.end_ns / 1000 + off
        assert r.start - err - 1 <= t0 <= t1 <= r.end + 1, (s, r.start, r.end, err)


def test_trace_merges_the_spans_into_its_chrome_trace(tmp_path):
    """``trace()`` writes the spans as ``ntedit.<name>`` complete events on
    their threads (a worker's too), inside the profiler range opened at the
    same point, and the counters as counter events of running totals."""
    def work(ids):
        with profiling.span("engine.repair", **ids):
            return threading.get_native_id()

    with profiling.trace(str(tmp_path), device="cpu") as path:
        with torch.profiler.record_function("probe"), profiling.span("engine.contig", contig=0):
            with ThreadPoolExecutor(max_workers=1) as ex:
                worker = ex.submit(work, profiling.ids()).result(timeout=30)
            profiling.count("engine.bases", 40)
            profiling.count("engine.bases", 2)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    mine = {e["name"]: e for e in events if e.get("cat") == "ntedit" and e["ph"] == "X"}
    probe = next(e for e in events if e.get("name") == "probe" and e.get("ph") == "X")
    contig, repair = mine["ntedit.engine.contig"], mine["ntedit.engine.repair"]
    assert (contig["tid"], contig["args"]) == (threading.get_native_id(), {"contig": 0})
    assert (repair["tid"], repair["args"]) == (worker, {"contig": 0})
    err = min(e["dur"] for e in events if e.get("name") == profiling.CLOCK)
    assert probe["ts"] - err - 1 <= contig["ts"] <= repair["ts"]
    assert repair["ts"] + repair["dur"] <= contig["ts"] + contig["dur"] <= probe["ts"] + probe["dur"] + 1
    counts = [e["args"] for e in events if e.get("ph") == "C" and e.get("cat") == "ntedit"]
    assert counts == [{"engine.bases": 40}, {"engine.bases": 42}]


@pytest.fixture(scope="module")
def tiny_reads(tmp_path_factory):
    """A 20 kbp draft with 20 substitutions and 2,000 error-free 100 bp
    reads of its truth in one FASTQ file: (directory, read bases, draft
    bases)."""
    from ntedit_tpu_torch.utils import simulate

    d = tmp_path_factory.mktemp("torch_profiling")
    truth = simulate.random_genome(20000, seed=3)
    rng = np.random.default_rng(4)
    draft = truth.copy()
    for p in rng.choice(len(truth), 20, replace=False):
        draft[p] = ord("A") if truth[p] != ord("A") else ord("C")
    (d / "draft.fa").write_text(f">c1\n{draft.tobytes().decode()}\n")
    reads = [truth[s: s + 100].tobytes().decode() for s in rng.integers(0, len(truth) - 100, 2000)]
    (d / "reads_1.fq").write_text("".join(f"@r{i}\n{r}\n+\n{'I' * 100}\n" for i, r in enumerate(reads)))
    return d, sum(map(len, reads)), len(draft)


POLISH_READS_SPANS = {
    "cli.histogram", "cli.filter", "cli.engine", "io.read", "io.upload", "io.save", "io.load",
    "io.draft", "io.render", "build.histogram", "build.count", "build.insert", "build.download",
    "engine.load", "engine.contig", "engine.gates", "engine.repair"}


def polish_reads(d, monkeypatch) -> None:
    from ntedit_tpu_torch import cli

    monkeypatch.chdir(d)
    cli.main(["polish", "--draft", "draft.fa", "--reads", "reads", "-k", "25", "-t", "2",
              "--device", "cpu", "--force"])


def test_polish_reads_records_every_span_of_its_path(tiny_reads, monkeypatch):
    """``polish --reads --device cpu -t 2`` under ``recording()``: every
    span of its path (not the fallback's), the repair in a worker thread
    with the contig's ordinal, the read bases counted once and the draft's
    bases by the engine."""
    d, read_bases, draft_bases = tiny_reads
    with profiling.recording() as rec:
        polish_reads(d, monkeypatch)
    assert {s.name for s in rec.spans} == POLISH_READS_SPANS
    counters = rec.counters
    assert counters["io.read_bases"] == read_bases
    assert counters["engine.bases"] == draft_bases
    assert 0 < counters["engine.records"] <= counters["engine.gates"]
    main = threading.get_native_id()
    repairs = [s for s in rec.spans if s.name == "engine.repair"]
    assert all(s.tid != main and s.ids == {"contig": 0} for s in repairs)
    cli_spans = {s.name: s for s in rec.spans if s.name.startswith("cli.")}
    assert cli_spans["cli.histogram"].end_ns <= cli_spans["cli.filter"].start_ns
    assert cli_spans["cli.filter"].end_ns <= cli_spans["cli.engine"].start_ns


def test_polish_reads_trace_holds_the_build(tiny_reads, monkeypatch, tmp_path):
    """NTEDIT_TPU_TRACE wraps the whole ``polish`` subcommand: one trace
    file, holding the filter stages' spans beside the engine's."""
    d, _, _ = tiny_reads
    monkeypatch.setenv(profiling.TRACE_ENV, str(tmp_path / "tr"))
    polish_reads(d, monkeypatch)
    (name,) = os.listdir(tmp_path / "tr")
    with open(tmp_path / "tr" / name) as f:
        names = {e["name"][len("ntedit."):] for e in json.load(f)["traceEvents"]
                 if e.get("cat") == "ntedit" and e["ph"] == "X"}
    assert names == POLISH_READS_SPANS


@pytest.fixture(scope="module")
def snv_job():
    """A 20 kbp reference with an N run, a sample of it with 40 SNVs, and
    a blocked filter of the sample's k-mers: (filter, reference)."""
    from ntedit_tpu_torch.core import bloom
    from ntedit_tpu_torch.utils import simulate

    ref = simulate.random_genome(20000, seed=11)
    sample = ref.copy()
    rng = np.random.default_rng(12)
    for p in rng.choice(len(ref), 40, replace=False):
        sample[p] = ord("A") if ref[p] != ord("A") else ord("T")
    ref[9000:9200] = ord("N")
    bf = bloom.BlockedKmerBloomFilter.zeros(1 << 14, 3, 25)
    bf.insert_seq(sample)
    return bf, ref


SNV_COUNTERS = {"engine.snv_candidates", "engine.site_rows", "engine.segments"}


@pytest.mark.parametrize("rows", [True, False])
def test_snv_run_records_its_device_pass_and_counts(snv_job, rows):
    """An SNV run at -t 8 under ``recording()``: ``engine.snv_pass`` and
    ``engine.download`` inside ``engine.gates``, in that order;
    ``engine.snv_candidates`` the candidates ``flag.snv_candidate_positions``
    returns, ``engine.site_rows`` the same with rows on and absent with them
    off, ``engine.segments`` the native calls of the segmented repair, each
    an ``engine.repair`` span."""
    from ntedit_tpu_torch.engine import flag
    from ntedit_tpu_torch.engine.config import EngineConfig
    from ntedit_tpu_torch.engine.polish import Polisher

    bf, ref = snv_job
    pol = Polisher(bf, None, EngineConfig(k=25, hash_num=3, snv=True, threads=8),
                   chunk=1 << 15, device="cpu", site_rows=rows)
    with profiling.recording() as rec:
        (res,) = pol.polish(iter([("ref", ref)]))
    cand = flag.snv_candidate_positions(ref, pol.df, chunk=1 << 15)
    assert len(cand) > 0 and res.subs
    by_name = {}
    for s in rec.spans:
        by_name.setdefault(s.name, []).append(s)
    (gates,), (snv_pass,), (download,) = (by_name[n] for n in (
        "engine.gates", "engine.snv_pass", "engine.download"))
    assert snv_pass.parent == download.parent == "engine.gates"
    assert gates.start_ns <= snv_pass.start_ns <= snv_pass.end_ns <= download.start_ns
    assert download.end_ns <= gates.end_ns
    counters = rec.counters
    assert counters["engine.snv_candidates"] == len(cand)
    assert counters.get("engine.site_rows") == (len(cand) if rows else None)
    assert counters["engine.segments"] == len(by_name["engine.repair"]) >= 2
    assert counters["engine.gates"] == len(cand) and counters["engine.bases"] == len(ref)


def test_polish_run_keeps_its_span_and_counter_names(snv_job):
    """A polish-mode run records the names it recorded before the SNV
    pass's spans and counters came, and none of those."""
    from ntedit_tpu_torch.engine.config import EngineConfig
    from ntedit_tpu_torch.engine.polish import Polisher

    bf, ref = snv_job
    with profiling.recording() as rec:
        pol = Polisher(bf, None, EngineConfig(k=25, hash_num=3, threads=4), chunk=1 << 15,
                       device="cpu")
        (res,) = pol.polish(iter([("ref", ref)]))
    assert res.subs
    assert {s.name for s in rec.spans} == {"engine.load", "engine.contig", "engine.gates",
                                           "engine.repair"}
    assert set(rec.counters) == {"engine.bases", "engine.records", "engine.gates"}
    assert not SNV_COUNTERS & set(rec.counters)
