"""The SNV cell's readers of the program's spans and counters
(``benchmark/metrics/engine.*.snv.py``), fed synthetic runs: the value
from known ``spans`` and ``counters``, and None where a run has no
program keys or lacks what the reader reads (a program without the SNV
path's counters, a run with no bases)."""

from __future__ import annotations

import pytest

from benchmark import harness
from benchmark.harness import Run


def run_with(spans=None, counters=None) -> Run:
    run = Run()
    run.trace = None if spans is None else {"spans": spans, "counters": counters}
    return run


def read(name: str, run: Run):
    return harness.load_module("metrics", name).read(run)


def test_candidates_per_mbp():
    run = run_with({"engine.repair": 2.0}, {"engine.bases": 128_888_334,
                                            "engine.snv_candidates": 11_000_000})
    assert read("engine.snv_cand_per_mbp.snv", run) == pytest.approx(11e6 / 128.888334)


def test_repair_ms_per_mbp():
    run = run_with({"engine.repair": 6.5, "engine.gates": 1.0}, {"engine.bases": 64_444_167})
    assert read("engine.repair_ms_per_mbp.snv", run) == pytest.approx(6500 / 64.444167)


@pytest.mark.parametrize("name", ["engine.snv_cand_per_mbp.snv", "engine.repair_ms_per_mbp.snv"])
@pytest.mark.parametrize("spans,counters", [
    (None, None),  # no program keys: a run without the recorder
    ({}, {}),  # nothing recorded
    ({"engine.gates": 1.0}, {"engine.bases": 1000}),  # neither candidates nor repair
    ({"engine.repair": 1.0}, {"engine.snv_candidates": 5, "engine.bases": 0}),  # no bases
])
def test_nothing_to_read_is_none(name, spans, counters):
    assert read(name, run_with(spans, counters)) is None
