"""How ``correct`` is decided: the program's three outputs against the
plain reference's, on stretches of the jobs drawn from the seed.

The reference (``reference/engine.py``) scans a stretch ``[q0, b)`` of a
contig from the original bytes and is compared with the program on
``[c0, e)``, ``c0 = q0 + k + d + 8``.  The stretch starts where the
program's outputs hold no record in ``[q0, c0)``: a site at or after c0
reads no base that an earlier edit of the program changed (an edit at x
changes bases x..x+d, which only windows ending before x + k + d read),
so on ``[c0, e)`` the reference and a correct program agree exactly.
The stretch runs 2k + 2d + 16 bases past e, as far as a site before e
looks ahead, or to the contig's end.  Compared there: the changes and
variant rows with their position in the range, and the edited bases
between the two ends (each side's own indels map the original
coordinates onto its edited sequence).  Besides, every job's outputs
must equal the outputs of the first job run on the same input, and every
contig at least -z long must be in the edited FASTA.
"""

from __future__ import annotations

import bisect
from collections import Counter

import numpy as np

from benchmark.reference import engine as ref_engine

LIMITS = {  # the numbers compared, each with its limit: exact, so 0
    "differing_rows": 0,
    "differing_bases": 0,
    "differing_repeats": 0,
    "missing_contigs": 0,
    "stretches_missed": 0,
    "differing_hist_rows": 0,
    "differing_filter_words": 0,
}


def parse(outputs: tuple) -> dict:
    """(edited FASTA, changes TSV, variants VCF) text -> {header: [edited
    sequence, [(pos, row)] changes, [(pos, row)] variants]}; comment and
    column-header lines are skipped."""
    fa, tsv, vcf = outputs
    out = {}
    for rec in fa.split(">")[1:]:
        hdr, _, seq = rec.partition("\n")
        out[hdr] = [seq.replace("\n", ""), [], []]
    for col, text in ((1, tsv), (2, vcf)):
        for line in text.splitlines():
            if not line or line.startswith("#") or line.startswith("ID\t"):
                continue
            f = line.split("\t", 2)
            out.setdefault(f[0], ["", [], []])[col].append((int(f[1]), f[2]))
    return out


def _indel_shift(rows: list, x: int) -> int:
    """Net bases the changes rows before original position x insert."""
    net = 0
    for pos, rest in rows:
        if pos >= x:
            continue
        alt = rest.split("\t", 2)[1]
        if alt[:1] == "+":
            net += len(alt) - 1
        elif alt[:1] == "-":
            net -= len(alt) - 1
    return net


def _multiset_diff(a: list, b: list) -> int:
    ca, cb = Counter(a), Counter(b)
    return sum(((ca - cb) + (cb - ca)).values())


def pick_stretch(length: int, positions: list, rng, k: int, d: int, width: int):
    """-> (q0, c0, e, b) from a start drawn from ``rng``, or None."""
    quiet = k + d + 8
    q0 = int(rng.integers(0, max(1, length)))
    while True:
        i = bisect.bisect_left(positions, q0)
        if i < len(positions) and positions[i] < q0 + quiet:
            q0 = positions[i] + 1
            continue
        break
    c0 = q0 + quiet
    if c0 >= length:
        return None
    e = min(length, c0 + width)
    b = length if e == length else min(length, e + 2 * k + 2 * d + 16)
    return q0, c0, e, b


def compare_stretch(header: str, original: bytes, prog: list, stretch: tuple,
                    filt: ref_engine.HostFilter, cfg) -> dict:
    """Run the reference over the stretch and count the differences."""
    q0, c0, e, b = stretch
    fa, tsv, vcf = ref_engine.run(header, original[q0:b], filt, cfg)
    mine = parse((fa, tsv, vcf))[header]
    shifted = [[(p + q0, r) for p, r in mine[col]] for col in (1, 2)]
    rows = 0
    for col, theirs in ((1, shifted[0]), (2, shifted[1])):
        a = [x for x in prog[col] if c0 <= x[0] < e]
        r = [x for x in theirs if c0 <= x[0] < e]
        rows += _multiset_diff(a, r)
    p_start = c0 + _indel_shift(prog[1], c0)
    r_start = c0 - q0 + _indel_shift(mine[1], c0 - q0)
    if e == len(original):
        pseg, rseg = prog[0][p_start:], mine[0][r_start:]
    else:
        pseg = prog[0][p_start : e + _indel_shift(prog[1], e)]
        rseg = mine[0][r_start : e - q0 + _indel_shift(mine[1], e - q0)]
    n = min(len(pseg), len(rseg))
    diff = np.frombuffer(pseg[:n].encode(), np.uint8) != np.frombuffer(rseg[:n].encode(), np.uint8)
    return {"rows": rows, "bases": int(diff.sum()) + abs(len(pseg) - len(rseg)),
            "rows_compared": sum(1 for col in (1, 2) for x in prog[col] if c0 <= x[0] < e),
            "bases_compared": e - c0}


def check_jobs(pool: list, done: list, rng, filt, cfg, stretches: int, width: int) -> dict:
    """``pool``: each input, [(header, original bytes)]; ``done``: (pool
    index, outputs) of every job the window completed; ``filt``: the
    reference's filter, or a dict of one a pool entry.  -> the numbers
    compared and what they were compared on."""
    first = {}
    repeats = 0
    for idx, outputs in done:
        if idx not in first:
            first[idx] = outputs
        elif outputs != first[idx]:
            repeats += 1
    parsed = {idx: parse(outputs) for idx, outputs in first.items()}
    missing = 0
    for idx, got in parsed.items():
        missing += sum(1 for h, s in pool[idx] if len(s) >= cfg.min_contig_len and h not in got)
    counts = Counter()
    entries = sorted(parsed)
    contigs = [(idx, h, s) for idx in entries for h, s in pool[idx] if len(s) >= cfg.min_contig_len]
    weights = np.array([len(s) for _, _, s in contigs], dtype=np.float64)
    for _ in range(stretches if contigs else 0):
        idx, h, s = contigs[int(rng.choice(len(contigs), p=weights / weights.sum()))]
        prog = parsed[idx].get(h)
        if prog is None:
            continue
        positions = sorted(p for col in (1, 2) for p, _ in prog[col])
        st = pick_stretch(len(s), positions, rng, cfg.k, cfg.max_deletions, width)
        if st is None:
            continue
        got = compare_stretch(h, s, prog, st, filt[idx] if isinstance(filt, dict) else filt, cfg)
        counts["stretches"] += 1
        for key, v in got.items():
            counts[key] += v
    compared = {
        "differing_rows": counts["rows"],
        "differing_bases": counts["bases"],
        "differing_repeats": repeats,
        "missing_contigs": missing,
        "stretches_missed": stretches - counts["stretches"],
    }
    on = {"stretches": counts["stretches"], "rows": counts["rows_compared"],
          "bases": counts["bases_compared"], "jobs": len(done)}
    return compared, on


def verdict(compared: dict, on: dict) -> bool:
    """Every number within its limit, and rows to compare."""
    return all(v <= LIMITS[k] for k, v in compared.items()) and on["rows"] > 0
