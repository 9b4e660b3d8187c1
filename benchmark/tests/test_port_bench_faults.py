"""A run with the timed path broken underneath comes out not correct, and
so does the control: the reference in the program's place with a
guarantee the configuration states broken (each k-mer probed by two of
its three filter bits).  The look for a card is skipped: the run drives
the Polisher's plain versions on the CPU at a tiny size."""

from __future__ import annotations

import time

import pytest

from benchmark import check, harness, inputs
from benchmark.kinds import engine as kind
from benchmark.reference import engine as ref_engine
from benchmark.tests import tiny


def _run(cell, fault=None, seed=2**31 + 99):
    return harness.run_cell(tiny.spec(cell), seed, 0.5, False, "cpu", time.perf_counter(), fault=fault)


def _unchanged(res, contigs):
    """A step that returns its state unchanged: the draft, no records."""
    from ntedit_tpu_torch.engine.records import ContigResult, RopeCells

    seq = dict(contigs)[res.header]
    return ContigResult(res.header, bytearray(seq.tobytes()), RopeCells(len(seq)), [])


def _half(res, contigs):
    """Half of the batch left out: every other contig's result dropped."""
    kept = [h for h, s in contigs if len(s) >= 100]
    return res if kept.index(res.header) % 2 == 0 else None


def _altered(res, contigs):
    """An answer altered where it is produced: each record's support off
    by one."""
    for rec in res.subs:
        rec.num_support += 1
    return res


def _reads_unchanged(out, ent):
    """The pipeline's step that returns its state unchanged: the draft
    out as it came in, no records."""
    name, seq = ent["contigs"][0]
    head = [ln for ln in out[1].splitlines(True) if ln.startswith("ID")]
    vhead = [ln for ln in out[2].splitlines(True) if ln.startswith("#")]
    return [f">{name}\n{seq.tobytes().decode()}\n", "".join(head), "".join(vhead)] + out[3:]


def _reads_half(out, ent):
    """Half of the batch left out: the filter's second half of words as
    if no k-mer had been inserted there."""
    from benchmark.kinds.reads import filter_words

    header, words = filter_words(out[4])
    words = words.copy()
    words[words.size // 2 :] = 0
    return out[:4] + [header.encode() + words.tobytes()]


def _reads_altered(out, ent):
    """An answer altered where it is produced: a histogram row off by one."""
    rows = out[3].splitlines(True)
    key, val = rows[3].split()
    rows[3] = f"{key}\t{int(val) + 1}\n"
    return out[:3] + ["".join(rows)] + out[4:]


@pytest.mark.parametrize("cell", tiny.ALL)
def test_sound_run_is_correct(cell):
    out = _run(cell)
    assert out["correct"] and out["failed"] == 0 and out["checked"]["rows"] > 0
    assert list(out)[-1] == "compared"


FAULTS = [("human_k55.snv", _unchanged), ("human_k55.snv", _altered),
          ("ecoli_k25.polish", _unchanged), ("ecoli_k25.polish", _half),
          ("ecoli_k25.polish", _altered), ("human_k55.polish", _half),
          ("human_k55.polish", _altered), ("ecoli_k25.reads", _reads_unchanged),
          ("ecoli_k25.reads", _reads_half), ("ecoli_k25.reads", _reads_altered)]


@pytest.mark.parametrize("cell,fault", FAULTS, ids=[f"{c}-{f.__name__[1:]}" for c, f in FAULTS])
def test_broken_run_is_not_correct(cell, fault):
    out = _run(cell, fault)
    assert not out["correct"], out["compared"]


CONTROL_CASES = [  # (cell, seed, stretches, width): at this size the two-bit control shows on
    ("human_k55.snv", 79, 8, 6000),  # 3 of 4 seeds tried (the cell's size: 3 of 3)
    ("human_k55.polish", 78, 8, 5000),  # 1 of 3 (the cell's size: 3 of 3)
    ("ecoli_k25.polish", 77, 4, 15000),
    ("ecoli_k25.reads", 77, 3, 10000),
]


@pytest.mark.parametrize("cell,seed,stretches,width", CONTROL_CASES, ids=[c[0] for c in CONTROL_CASES])
def test_control_is_not_correct(cell, seed, stretches, width):
    """The reference probing two of three bits, in the program's place
    (``benchmark/control.py`` at a tiny size)."""
    from benchmark import control

    s = tiny.spec(cell)
    s["traffic"]["check"].update(stretches=stretches, width=width)
    got = control.control_numbers(s, seed, "cpu")
    assert got["differing_rows"] > 0 and got["rows_compared"] > 0, got
