"""The torch port's profiling (utils/profiling.py) on the CPU: ``trace()``
does nothing without NTEDIT_TPU_TRACE or a directory, and with either
writes a Chrome trace of the body's host activity; the ``engine`` command
line wraps its run in it; ``StageTimer`` accounts stages and rates."""

import json
import os

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

        def export_chrome_trace(self, path):
            self.exported.append(path)

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


def test_stage_timer(monkeypatch):
    clock = iter([10.0, 12.0, 20.0, 21.0, 30.0, 30.5])
    monkeypatch.setattr(profiling.time, "time", lambda: next(clock))
    timer = profiling.StageTimer()
    with timer.stage("gate", units=1000):
        pass
    with timer.stage("gate", units=500):
        pass
    assert timer.stages == {"gate": [3.0, 1500]}
    assert timer.summary() == "gate 3.00s (500/s)"
    with pytest.raises(ValueError):
        with timer.stage("repair"):
            raise ValueError("the stage's time is kept all the same")
    assert timer.stages["repair"] == [0.5, 0]
    assert timer.summary() == "gate 3.00s (500/s); repair 0.50s"
