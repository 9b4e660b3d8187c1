"""The filter build's kernels on one NVIDIA GPU, at the shapes
``polish --reads`` gives them.

    python -m ntedit_tpu_torch.utils.build_sweep
    python -m ntedit_tpu_torch.utils.build_sweep --against OTHER_CHECKOUT

The data: 30x of 150 bp reads of a seeded 4.7 Mbp genome (940,000 reads,
1% substitutions, one N per 1,000 reads), joined with 0x00 separators and
cut into 2^24-byte batches that overlap by k - 1 bytes (9 batches), as the
build reads them; k = 25, 3 hashes; the tables ``polish --reads`` sizes
from their histogram at cutoff 2 (a 2^29-slot count table, 2^22 blocked
words).  Each line is one JSON object.  Needs a CUDA device; prints the
card's name and power limit first.  Times are medians over the rounds,
CUDA events, the L2 flushed before each timed run, tables reset untimed.

* ``slices``: the count pass (``kmer_partition`` then ``kmer_count_apply``)
  with slices of 2^22 to 2^26 counters, taking turns round by round: ms
  of one batch and of the whole pass (9 batches), each pass's counters held
  equal to the plain version's.
* ``floors``: the random-atomic floor (as many random 32-bit atomicAdds as
  the apply makes for one batch, into an int32 table of the count table's
  bytes and of one slice's) and gate_kernel's random-probe floor at the
  insert's probes of one batch, on the counter table and on the solid bits.

* ``hashes``: the histogram's hashes kernel on the first batch (at s = 0
  and, as once the histogram samples, s = 1) and its whole pass (every
  batch's hashes and the histogram), against its plain version, its bytes
  bound and a device copy of those bytes.

With ``--against DIR`` it runs the ``hashes`` comparison instead: this
checkout's hashes kernel and pass and the dense kernel of DIR (a checkout
with ``ntb_kmer_hashes``: every window's hash and validity words) with
its compaction in torch, both held equal to the plain version, take turns
on the same data in ROUNDS rounds; each one's median ms and the rounds
this checkout won.
"""

from __future__ import annotations

import argparse
import json
import subprocess

import numpy as np
import torch

from ntedit_tpu_torch.core import bfbuild
from ntedit_tpu_torch.core import nthash as nt
from ntedit_tpu_torch.ops import build_kernel as bk
from ntedit_tpu_torch.ops import gate_kernel
from ntedit_tpu_torch.utils import simulate
from ntedit_tpu_torch.utils.other import DenseHashes

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3, NVIDIA data sheet
K = 25
HASH_NUM = 3
CUTOFF = 2
GENOME = 4_700_000
READ_LEN = 150
COVERAGE = 30
SLICE_SWEEP = (22, 23, 24, 25, 26)
ROUNDS = 5
MIB = 1 << 20


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------

def read_pieces(seed: int = 1102, batch: int = bfbuild.BATCH) -> list:
    """The simulated reads (see the module docstring) as the build's
    separator-joined pieces of ``batch`` bytes, overlapping by k - 1."""
    rng = np.random.default_rng(seed)
    genome = simulate.random_genome(GENOME, seed=seed - 2)
    n_reads = GENOME * COVERAGE // READ_LEN
    code = np.zeros(256, dtype=np.int64)
    code[simulate.BASES] = np.arange(4)
    rows = []
    for a in range(0, n_reads, 100_000):
        b = min(n_reads, a + 100_000)
        starts = rng.integers(0, GENOME - READ_LEN + 1, size=b - a)
        r = genome[starts[:, None] + np.arange(READ_LEN)]
        sub = rng.random(r.shape) < 0.01
        r[sub] = simulate.BASES[(code[r[sub]] + rng.integers(1, 4, size=int(sub.sum()))) % 4]
        r.reshape(-1)[rng.integers(0, r.size, size=(b - a) // 1000)] = ord("N")
        rows.append(np.concatenate([r, np.zeros((b - a, 1), np.uint8)], axis=1).reshape(-1))
    joined = np.concatenate(rows)
    step = batch - (K - 1)
    return [joined[s : s + batch] for s in range(0, len(joined) - (K - 1), step)]


def upload(pieces: list, device) -> list:
    """(seq, n) per piece, each in its own buffer on ``device``."""
    out = []
    for p in pieces:
        n = len(p) - K + 1
        buf = torch.zeros(gate_kernel.padded_len(n), dtype=torch.uint8)
        buf[: len(p)] = torch.from_numpy(p)
        out.append((buf.to(device), n))
    return out


def tables_for(seqs: list) -> tuple:
    """(count slots, blocked words) that polish --reads sizes for these
    batches at cutoff 2 (bfbuild.filter_sizes of their histogram)."""
    hist = bfbuild.histogram_of((bk.valid_hashes(s, n, K) for s, n in seqs), K)
    nbits, slots, _ = bfbuild.filter_sizes(hist, CUTOFF, HASH_NUM)
    return slots, nbits // 32


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------

def time_once(fn, flush, reset=None) -> float:
    """ms of ``fn`` on the card, the L2 flushed before (``reset()`` before
    that, untimed)."""
    if reset is not None:
        reset()
    flush.zero_()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b)


def take_turns(cases: dict, flush, rounds: int = ROUNDS) -> dict:
    """Time each case (name -> (fn, reset)) once per round, the cases
    taking turns in a rotated order; returns name -> [ms per round]."""
    names = list(cases)
    for fn, reset in cases.values():  # warm
        if reset is not None:
            reset()
        fn()
    times = {name: [] for name in names}
    for r in range(rounds):
        for name in names[r % len(names):] + names[: r % len(names)]:
            fn, reset = cases[name]
            times[name].append(time_once(fn, flush, reset))
    return times


def median(ts) -> float:
    return float(np.median(ts))


def copy_ms(nbytes: int, flush) -> float:
    """A device copy of ``nbytes`` / 2 bytes (``nbytes`` moved): the
    streaming floor of a kernel that reads and writes ``nbytes`` in all."""
    half = max(1, nbytes // 2)
    src = torch.empty(half, dtype=torch.uint8, device=flush.device)
    dst = torch.empty_like(src)
    return median(take_turns({"copy": (lambda: dst.copy_(src), None)}, flush, 5)["copy"])


def bound_ms(nbytes: int) -> float:
    return nbytes / HBM_BYTES_PER_S * 1e3


# ---------------------------------------------------------------------------
# the passes
# ---------------------------------------------------------------------------

def _slots_of(seq, n: int, slots: int) -> torch.Tensor:
    can = bk.valid_hashes(seq, n, K)
    return torch.cat([nt.umod(h, slots) for h in nt.extend(can, K, HASH_NUM)])


def plain_counts(seqs: list, slots: int) -> torch.Tensor:
    table = torch.zeros(-(-slots // 4) * 4, dtype=torch.uint8, device=seqs[0][0].device)
    for seq, n in seqs:
        bk.kmer_count_plain(seq, n, K, HASH_NUM, table, slots)
    return table


def count_numbers(seqs: list, slots: int, flush, slice_bits: int = bk.SLICE_BITS,
                  want: torch.Tensor = None) -> dict:
    """The count pass at ``slice_bits``: each kernel on the first batch
    (partition, apply, the two with the scan: ``kmer_count``) and the whole
    pass, against its plain versions, its bounds and floors.  ``want``:
    the plain version's counts of the whole pass (computed when None)."""
    dev = flush.device
    seq0, n0 = seqs[0]
    L0 = n0 + K - 1
    table = torch.zeros(-(-slots // 4) * 4, dtype=torch.uint8, device=dev)
    bins = bk.Bins(slots, HASH_NUM, max(n for _, n in seqs), dev, slice_bits)
    if want is None:
        want = plain_counts(seqs, slots)
    for seq, n in seqs:
        bk.kmer_count(seq, n, K, HASH_NUM, table, slots, bins)
    differing = int((table != want).sum())
    # the first batch's bins against the plain partition's, as multisets
    bk.kmer_partition(seq0, n0, K, bins)
    plain_bins = bk.Bins(slots, HASH_NUM, n0, dev, slice_bits)
    bk.kmer_partition_plain(seq0, n0, K, plain_bins)
    cells = bins.cells()
    same_bins = torch.equal(bins.counts[:cells], plain_bins.counts[:cells]) and torch.equal(
        torch.sort(bk.bin_slots(bins)).values, torch.sort(bk.bin_slots(plain_bins)).values)
    differing += 0 if same_bins else 1
    entries = int(bins.ends[cells - 1])
    slot0 = _slots_of(seq0, n0, slots)
    sectors = int(torch.unique(slot0 >> 5).numel())
    zero = table.zero_

    def whole_pass():
        for seq, n in seqs:
            bk.kmer_count(seq, n, K, HASH_NUM, table, slots, bins)

    cases = {
        "partition": (lambda: bk.kmer_partition(seq0, n0, K, bins), None),
        "apply": (lambda: bk.kmer_count_apply(bins, table), zero),
        "count": (lambda: bk.kmer_count(seq0, n0, K, HASH_NUM, table, slots, bins), zero),
        "pass": (whole_pass, zero),
    }
    times = take_turns(cases, flush)
    bk.kmer_partition(seq0, n0, K, bins)  # the bins of the first batch again, for the apply
    plain = {
        "partition": median(take_turns({"p": (lambda: bk.kmer_partition_plain(seq0, n0, K, plain_bins),
                                              None)}, flush, 2)["p"]),
        "apply": median(take_turns({"p": (lambda: bk.kmer_count_apply_plain(bins, table), zero)},
                                   flush, 2)["p"]),
        "count": median(take_turns({"p": (lambda: bk.kmer_count_plain(seq0, n0, K, HASH_NUM, table,
                                                                     slots), zero)}, flush, 2)["p"]),
    }
    # floors: the apply's atomics, random in the table's bytes and in one slice's
    threads = -(-entries // bk.APPLY_CHUNK) * 256
    floors = {}
    for name, nbytes in (("table", -(-slots // 4) * 4), ("slice", min(slots, 1 << bins.slice_bits))):
        t = torch.zeros(max(1, nbytes // 4), dtype=torch.int32, device=dev)
        floors[name] = median(take_turns({"f": (lambda: bk.atomic_floor(t, entries, threads),
                                                None)}, flush)["f"])
        if int(t.sum()) != entries * (ROUNDS + 1):
            raise AssertionError("the atomic floor lost an add")
        del t
    cell_bytes = 12 * cells  # the count matrix and its scan
    part_bytes = L0 + 4 * entries + cell_bytes
    apply_bytes = 4 * entries + cell_bytes + 2 * 32 * sectors
    count_bytes = L0 + 2 * 32 * sectors  # the count's bound: the function's bytes
    out = {
        "slots": slots, "slice_bits": bins.slice_bits, "slices": bins.n_slices,
        "scratch_bytes": bins.nbytes, "windows": n0, "increments": entries, "sectors": sectors,
        "differing": differing,
        "partition": {"ms": median(times["partition"]), "plain_ms": plain["partition"],
                      "bytes": part_bytes, "bound_ms": bound_ms(part_bytes),
                      "floor_ms": copy_ms(part_bytes, flush), "floor": "device copy of its bytes"},
        "apply": {"ms": median(times["apply"]), "plain_ms": plain["apply"],
                  "bytes": apply_bytes, "bound_ms": bound_ms(apply_bytes),
                  "floor_ms": floors["slice"], "floor_table_ms": floors["table"],
                  "floor": "random atomicAdd, one slice's bytes"},
        "count": {"ms": median(times["count"]), "plain_ms": plain["count"], "bytes": count_bytes,
                  "bound_ms": bound_ms(count_bytes), "floor_ms": floors["table"],
                  "pass_ms": median(times["pass"]), "batches": len(seqs)},
    }
    return out


def insert_numbers(seqs: list, counters: torch.Tensor, slots: int, nw: int, flush) -> dict:
    """The insert pass at cutoff 2 into ``nw`` blocked words, reading the
    whole build's ``counters``: the solid bits and the insert of each batch
    against their plain versions; the pass (solid bits, then every batch)
    against its bound, and per batch (the pass over its launches); the
    insert kernel alone on the first batch against the probe floor on the
    solid bits and on the counters."""
    dev = flush.device
    seq0, n0 = seqs[0]
    words = torch.zeros(nw, dtype=torch.int32, device=dev)
    want = torch.zeros_like(words)
    for seq, n in seqs:
        bk.kmer_insert_plain(seq, n, K, HASH_NUM, want, "blocked", nw, counters, slots, CUTOFF)
    solid = bk.kmer_solid_bits(counters, slots, CUTOFF)
    differing = int((solid != bk.kmer_solid_bits_plain(counters, slots, CUTOFF)).sum())
    for seq, n in seqs:
        bk.kmer_insert(seq, n, K, HASH_NUM, words, "blocked", nw, solid, slots)
    differing += int((words != want).sum())
    one = torch.zeros_like(words)
    bk.kmer_insert(seq0, n0, K, HASH_NUM, one, "blocked", nw, solid, slots)
    one_want = torch.zeros_like(words)
    bk.kmer_insert_bits_plain(seq0, n0, K, HASH_NUM, one_want, "blocked", nw, solid, slots)
    differing += int((one != one_want).sum())
    # the bound of the pass: every batch's ASCII, each counter sector its
    # probes touch and each word sector it writes, once
    c_touched = torch.zeros(-(-slots // 32), dtype=torch.bool, device=dev)
    w_touched = torch.zeros(-(-nw // 8), dtype=torch.bool, device=dev)
    ascii_bytes = probes0 = valid0 = b_sectors0 = 0
    for i, (seq, n) in enumerate(seqs):
        ascii_bytes += n + K - 1
        can = bk.valid_hashes(seq, n, K)
        idx = [nt.umod(h, slots) for h in nt.extend(can, K, HASH_NUM)]
        for s in idx:
            c_touched[s >> 5] = True
        ok = bk.min_count(can, K, HASH_NUM, counters, slots).long() >= CUTOFF
        w_touched[(can[ok] & (nw - 1)) >> 3] = True
        if i == 0:
            valid0, probes0 = int(can.numel()), HASH_NUM * int(can.numel())
            b_sectors0 = int(torch.unique(torch.cat(idx) >> 8).numel())
            w_sectors0 = int(torch.unique((can[ok] & (nw - 1)) >> 3).numel())
    pass_bytes = ascii_bytes + 32 * int(c_touched.sum()) + 2 * 32 * int(w_touched.sum())
    del c_touched, w_touched
    zero = words.zero_

    def whole_pass():
        s = bk.kmer_solid_bits(counters, slots, CUTOFF)
        for seq, n in seqs:
            bk.kmer_insert(seq, n, K, HASH_NUM, words, "blocked", nw, s, slots)

    cases = {
        "pass": (whole_pass, zero),
        "solid_bits": (lambda: bk.kmer_solid_bits(counters, slots, CUTOFF), None),
        "insert": (lambda: bk.kmer_insert(seq0, n0, K, HASH_NUM, words, "blocked", nw, solid, slots),
                   zero),
    }
    times = take_turns(cases, flush)
    plain = {
        "solid_bits": median(take_turns({"p": (lambda: bk.kmer_solid_bits_plain(counters, slots,
                                                                               CUTOFF), None)},
                                        flush, 2)["p"]),
        "insert": median(take_turns({"p": (lambda: bk.kmer_insert_bits_plain(
            seq0, n0, K, HASH_NUM, words, "blocked", nw, solid, slots), zero)}, flush, 2)["p"]),
        "pass": median(take_turns({"p": (lambda: [bk.kmer_insert_plain(
            seq, n, K, HASH_NUM, words, "blocked", nw, counters, slots, CUTOFF)
            for seq, n in seqs], zero)}, flush, 1)["p"]),
    }
    threads = -(-n0 // 32)
    floor_bits = median(take_turns({"f": (lambda: gate_kernel.probe_floor(solid, probes0, threads, 4),
                                          None)}, flush)["f"])
    floor_counters = median(take_turns({"f": (lambda: gate_kernel.probe_floor(
        counters, probes0, threads, 4), None)}, flush)["f"])
    solid_bytes = slots + 4 * solid.numel()
    one_bytes = n0 + K - 1 + 32 * b_sectors0 + 2 * 32 * w_sectors0
    pass_ms = median(times["pass"])
    out = {
        "slots": slots, "words": nw, "cutoff": CUTOFF, "batches": len(seqs), "valid": valid0,
        "probes": probes0, "differing": differing, "solid_bytes": 4 * solid.numel(),
        "solid_bits": {"ms": median(times["solid_bits"]), "plain_ms": plain["solid_bits"],
                       "bytes": solid_bytes, "bound_ms": bound_ms(solid_bytes),
                       "floor_ms": copy_ms(solid_bytes, flush), "floor": "device copy of its bytes"},
        "insert": {"ms": median(times["insert"]), "plain_ms": plain["insert"],
                   "bytes": one_bytes, "bound_ms": bound_ms(one_bytes), "floor_ms": floor_bits,
                   "floor_counters_ms": floor_counters,
                   "floor": "random probes of the solid bits, 4 in flight"},
        "pass": {"ms": pass_ms, "ms_per_batch": pass_ms / len(seqs), "plain_ms": plain["pass"],
                 "bytes": pass_bytes, "bound_ms": bound_ms(pass_bytes),
                 "floor_ms": median(times["solid_bits"]) + len(seqs) * floor_bits},
    }
    return out


def hashes_numbers(seqs: list, flush, other: DenseHashes = None) -> dict:
    """The hashes kernel on the first batch (s = 0 and s = 1: the call, with
    its read of the totals, and its device work alone) and the histogram's
    whole pass, against the plain version, the bytes bound and a copy of
    those bytes; with ``other``, its dense kernel alone, with its
    compaction, and its pass, in turns.  Raises on a difference."""
    seq0, n0 = seqs[0]
    differing = 0
    for s in (0, 1):
        got, valid = bk.kmer_valid_hashes(seq0, n0, K, s)
        want, want_valid = bk.kmer_valid_hashes_plain(seq0, n0, K, s)
        differing += int(not torch.equal(got, want)) + int(valid != want_valid)
    emitted = int(bk.valid_hashes(seq0, n0, K).numel())
    sampled = int(bk.kmer_valid_hashes(seq0, n0, K, 1)[0].numel())
    if other is not None:
        differing += int(not torch.equal(other.valid_hashes(seq0, n0, K), bk.valid_hashes(seq0, n0, K)))

    def device_only(s):  # both forms and the scan, no read of the totals
        lib = bk.load_library()
        bk._raise_if_failed(lib, bk._valid_hashes_forms(lib, seq0, n0, K, s)[0], "k-mer hashes")

    def hist(valid_hashes):
        kept = bfbuild.SampledHashes(1 << 26)
        for seq, n in seqs:
            s = kept.s
            kept.add(*valid_hashes(seq, n, s), s)
        return kept.histogram(K)

    def this_pass():
        return hist(lambda seq, n, s: bk.kmer_valid_hashes(seq, n, K, s))

    def other_pass():
        return bfbuild.histogram_of((other.valid_hashes(seq, n, K) for seq, n in seqs), K)

    want_hist = hist(lambda seq, n, s: bk.kmer_valid_hashes_plain(seq, n, K, s))
    got_hist = this_pass()
    differing += int((got_hist.f1, got_hist.f0) != (want_hist.f1, want_hist.f0)
                     or not np.array_equal(got_hist.spectrum, want_hist.spectrum))
    cases = {"hashes": (lambda: bk.kmer_valid_hashes(seq0, n0, K), None),
             "hashes_sampled": (lambda: bk.kmer_valid_hashes(seq0, n0, K, 1), None),
             "device": (lambda: device_only(0), None),
             "device_sampled": (lambda: device_only(1), None),
             "pass": (this_pass, None)}
    if other is not None:
        cases.update({"other_kernel": (lambda: other.kernel(seq0, n0, K), None),
                      "other_hashes": (lambda: other.valid_hashes(seq0, n0, K), None),
                      "other_pass": (other_pass, None)})
    times = take_turns(cases, flush)
    plain_ms = median(take_turns({"p": (lambda: bk.kmer_valid_hashes_plain(seq0, n0, K), None)},
                                 flush, 2)["p"])
    nbytes = n0 + K - 1 + 8 * emitted
    out = {"windows": n0, "valid": emitted, "sampled_at_1": sampled, "batches": len(seqs),
           "differing": differing, "bytes": nbytes, "bound_ms": bound_ms(nbytes),
           "floor_ms": copy_ms(nbytes, flush), "floor": "device copy of its bytes",
           "plain_ms": plain_ms, "rounds": ROUNDS,
           **{f"{name}_ms": median(t) for name, t in times.items()}}
    if other is not None:
        out["won"] = int(sum(a < b for a, b in zip(times["hashes"], times["other_hashes"])))
        out["device_won"] = int(sum(a < b for a, b in zip(times["device"], times["other_kernel"])))
        out["pass_won"] = int(sum(a < b for a, b in zip(times["pass"], times["other_pass"])))
    if differing:
        raise AssertionError(f"the hashes kernel differs from its plain version: {out}")
    return out


def build_numbers(seqs: list, flush) -> dict:
    """count_numbers and insert_numbers at the tables polish --reads sizes
    for ``seqs``; raises when a kernel differs from its plain version."""
    slots, nw = tables_for(seqs)
    want = plain_counts(seqs, slots)
    out = {"count": count_numbers(seqs, slots, flush, want=want)}
    out["insert"] = insert_numbers(seqs, want, slots, nw, flush)
    if out["count"]["differing"] or out["insert"]["differing"]:
        raise AssertionError(f"a build kernel differs from its plain version: {out}")
    return out


def slice_sweep(seqs: list, flush) -> None:
    slots, _ = tables_for(seqs)
    want = plain_counts(seqs, slots)
    for bits in SLICE_SWEEP:
        row = count_numbers(seqs, slots, flush, bits, want=want)
        if row["differing"]:
            raise AssertionError(f"slices of 2^{bits}: the count differs from its plain version")
        print(json.dumps({"sweep": "slices", **row}), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="build_sweep", description=__doc__.split("\n\n")[0])
    ap.add_argument("--against", metavar="DIR", default=None,
                    help="compare the hashes kernel with the dense one of the checkout at DIR instead")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("build_sweep: no CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    dev = torch.device("cuda")
    bk.load_library()
    flush = torch.empty(256 * MIB, dtype=torch.uint8, device=dev)
    seqs = upload(read_pieces(), dev)
    if args.against:
        print(json.dumps({"sweep": "hashes", "other": args.against,
                          **hashes_numbers(seqs, flush, DenseHashes(args.against))}), flush=True)
        return 0
    slice_sweep(seqs, flush)
    print(json.dumps({"sweep": "floors", **build_numbers(seqs, flush)}), flush=True)
    print(json.dumps({"sweep": "hashes", **hashes_numbers(seqs, flush)}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
