"""The SNV candidate pass on one NVIDIA GPU, at the shape of an SNV run
on a 50 Mbp reference: the binned pass against the candidate kernel.

    python -m ntedit_tpu_torch.utils.snv_sweep
    python -m ntedit_tpu_torch.utils.snv_sweep --against OTHER_CHECKOUT

The data: chip_smoke.py's snv_blocked workload (simulate.snv_genome, seed
700: contigs of 30, 15 and 5 Mbp, 5 kbp and 60 bp, with N runs, IUPAC
bytes and a lowercase stretch; the filter holds a copy with a substitution
about every kbp), k = 25, 3 hashes.  Blocked filters built on the card
from the copy's k-mers: 256 MiB (what a 50 Mbp assembly at 0.001 FPR
gets), 1 GiB and 4 GiB, where the probes of a group of chunks fall ever
more thinly on the filter's sectors.  Each line is one JSON object.
Needs a CUDA device; prints the card's name and power limit first.
Times are medians over ROUNDS rounds in turns, CUDA events, the L2
flushed before each.

* ``pass``: the whole candidate pass of every contig (the contigs already
  on the card; the words, not their compaction) by the path
  (``flag.snv_candidate_words``: the binned pass where ``binned`` says
  so), by this checkout's candidate kernel one
  2^22-head chunk at a time and, with ``--against DIR``, by DIR's
  candidate kernel (utils/other.py) the same way; every pass's words held
  equal to the candidate kernel's.  Per filter size; also the binned pass
  on every group whatever the density rule, with slices of 2^21 to 2^24
  words and with groups of 3 and 14 chunks.
* ``contigs``: per contig of at least 2^20 heads, the binned pass and the
  kernel in turns, beside the probes per filter sector of its first group:
  where the density rule's crossover lies.
* ``plain``: the candidate kernel on the 5 Mbp contig with snv_plain's
  plain filter (btllib-sized for 5 Mbp at 0.001 FPR), the layout that
  keeps it, against DIR's with ``--against``.
* ``kernels``: the binned pass's two kernels on the first group of the 30
  Mbp contig (7 chunks): the front end (count, scan, scatter) and the
  probes against their plain versions, with the entries and the distinct
  filter sectors they touch; the bytes bound of the function the two
  compute together (the group's ASCII, its words, 32 B per distinct
  sector: the candidate kernel's bound for the same heads), the bytes each
  moves in this design (``design_bytes``: the entries too), and floors: a
  device copy of the front end's design bytes; random probes of one
  slice's words (an L2-sized table), 4 in flight.
"""

from __future__ import annotations

import argparse
import json
import subprocess

import numpy as np
import torch

from ntedit_tpu_torch.core import bfbuild, bloom
from ntedit_tpu_torch.engine import flag
from ntedit_tpu_torch.ops import gate_kernel, snv_kernel
from ntedit_tpu_torch.utils import simulate
from ntedit_tpu_torch.utils.build_sweep import copy_ms
from ntedit_tpu_torch.utils.other import CandWords

K = 25
HASH_NUM = 3
LENGTHS = (30_000_000, 15_000_000, 5_000_000, 5_000, 60)
ROUNDS = 7
SIZES = (1, 4, 8, 16)  # the filter at 256 MiB, 1, 2 and 4 GiB
VARIANTS = {"slices_2^21": {"slice_bits": 21}, "slices_2^22": {"slice_bits": 22},
            "slices_2^23": {"slice_bits": 23}, "slices_2^24": {"slice_bits": 24},
            "groups_3_chunks": {"budget_chunks": 3}, "groups_14_chunks": {"budget_chunks": 14}}
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3, NVIDIA data sheet
MIB = 1 << 20


def variant_filter(variants, nbytes: int, dev) -> "bloom.DeviceFilter":
    """A blocked filter of ``nbytes`` holding every k-mer of ``variants``,
    built on the card by the insert kernel."""
    builder = bfbuild.FilterBuilder(K, HASH_NUM, 8 * nbytes, 0, "blocked", dev)
    zero = np.zeros(1, np.uint8)
    joined = np.concatenate([np.concatenate([v, zero]) for v in variants])
    step = bfbuild.BATCH - (K - 1)
    pieces = [joined[s : s + bfbuild.BATCH] for s in range(0, len(joined) - (K - 1), step)]
    for seq, n in bfbuild.upload_batches(pieces, K, dev):
        builder.insert_batch(seq, n, 1)
    return bloom.DeviceFilter("blocked", builder.words, builder.modulus, HASH_NUM, K)


def contigs_on_card(refs, dev) -> list:
    out = []
    for r in refs:
        n = len(r) - K + 1
        if n <= 0:
            continue
        buf = torch.zeros(gate_kernel.padded_len(n), dtype=torch.uint8)
        buf[: len(r)] = torch.from_numpy(r)
        out.append((buf.to(dev), n))
    return out


def chunk_words(contigs, df, words_fn) -> list:
    """Each contig's candidate words, one kernel per 2^22-head chunk."""
    c = flag.DEFAULT_CHUNK
    return [torch.cat([words_fn(seq[s:], min(c, n - s), df) for s in range(0, n, c)])
            for seq, n in contigs]


def time_turns(cases: dict, flush, rounds: int = ROUNDS) -> dict:
    """name -> [ms per round] of each case, the cases taking turns in a
    rotated order, the L2 flushed before each."""
    names = list(cases)
    for fn in cases.values():
        fn()  # warm
    times = {name: [] for name in names}
    for r in range(rounds):
        for name in names[r % len(names):] + names[: r % len(names)]:
            flush.zero_()
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            cases[name]()
            b.record()
            b.synchronize()
            times[name].append(a.elapsed_time(b))
    return times


def forced(fn, budget_chunks=None, slice_bits=None, density=None):
    """``fn`` run with flag.BIN_BUDGET (in chunks), snv_kernel.CAND_SLICE_BITS
    (up to MAX_CAND_SLICES slices) and snv_kernel.MIN_PROBES_PER_SECTOR set
    for the call."""
    def run():
        saved = (flag.BIN_BUDGET, snv_kernel.CAND_SLICE_BITS, snv_kernel.CAND_SLICES,
                 snv_kernel.MIN_PROBES_PER_SECTOR)
        if budget_chunks is not None:
            flag.BIN_BUDGET = budget_chunks * 3 * snv_kernel.ENTRY_BYTES * flag.DEFAULT_CHUNK
        if slice_bits is not None:  # this slice size, whatever the slices it makes
            snv_kernel.CAND_SLICE_BITS, snv_kernel.CAND_SLICES = slice_bits, snv_kernel.MAX_CAND_SLICES
        if density is not None:
            snv_kernel.MIN_PROBES_PER_SECTOR = density
        try:
            return fn()
        finally:
            (flag.BIN_BUDGET, snv_kernel.CAND_SLICE_BITS, snv_kernel.CAND_SLICES,
             snv_kernel.MIN_PROBES_PER_SECTOR) = saved
    return run


def pass_numbers(contigs, df, flush, other, variants: dict = None) -> dict:
    """The whole candidate pass by the path, by the binned pass whatever the
    density rule, by this checkout's kernel and (``other``) another
    checkout's, in turns, and ``variants`` (name -> forced() keywords) of
    the binned pass; raises when any pass's words differ from the
    kernel's."""
    want = chunk_words(contigs, df, snv_kernel.snv_cand_words)

    def path():
        return [flag.snv_candidate_words(seq, n, df) for seq, n in contigs]

    cases = {"path": path, "binned": forced(path, density=0.0),
             "kernel": lambda: chunk_words(contigs, df, snv_kernel.snv_cand_words)}
    if other is not None:
        cases["other"] = lambda: chunk_words(contigs, df, other.words)
    for name, kw in (variants or {}).items():
        cases[name] = forced(path, density=0.0, **kw)
    differing = {name: sum(int((a != b).sum()) for a, b in zip(fn(), want))
                 for name, fn in cases.items() if name != "kernel"}
    if any(differing.values()):
        raise AssertionError(f"candidate words differ from the kernel's: {differing}")
    times = time_turns(cases, flush)
    out = {name: float(np.median(t)) for name, t in times.items()}
    out["rounds"] = ROUNDS
    for a in ("path", "binned"):
        for b in ("kernel", "other"):
            if b in times:
                out[f"{a}_won_over_{b}"] = int(sum(x < y for x, y in zip(times[a], times[b])))
    return out


def contig_numbers(contigs, df, flush) -> list:
    """Per contig, the binned pass (whatever the rule) and the kernel in
    turns, beside the density of its first group's probes on the filter."""
    rows = []
    for seq, n in contigs:
        if n < 1 << 20:
            continue
        one = [(seq, n)]
        group = min(n, flag.DEFAULT_CHUNK * max(1, flag.BIN_BUDGET // (
            3 * snv_kernel.ENTRY_BYTES * flag.DEFAULT_CHUNK)))
        times = time_turns({
            "binned": forced(lambda: [flag.snv_candidate_words(s, m, df) for s, m in one],
                             density=0.0),
            "kernel": lambda: chunk_words(one, df, snv_kernel.snv_cand_words)}, flush)
        rows.append({"heads": n, "group_heads": group,
                     "probes_per_sector": 24 * group / df.modulus,
                     "binned": float(np.median(times["binned"])),
                     "kernel": float(np.median(times["kernel"])),
                     "binned_won": int(sum(a < b for a, b in zip(times["binned"], times["kernel"])))})
    return rows


def kernel_numbers(seq, n: int, df, flush) -> dict:
    """The binned pass's kernels on the first group of one contig, each
    against its plain version (the bins as multisets, the forced and the
    probed words, and those against snv_cand_words_plain), the bytes bound
    of the candidate words they compute together, their design bytes and
    a floor each: a device copy of the front end's design bytes; random
    probes of one slice's words, 4 in flight, as many as the probe kernel
    makes."""
    group = min(n, flag.DEFAULT_CHUNK * max(1, flag.BIN_BUDGET // (
        3 * snv_kernel.ENTRY_BYTES * flag.DEFAULT_CHUNK)))
    nw = -(-group // 32)
    bins, plain = (snv_kernel.CandBins(df.modulus, group, df.device) for _ in range(2))
    words = torch.empty(nw, dtype=torch.int32, device=df.device)
    plain_words = torch.empty_like(words)
    snv_kernel.snv_cand_bin(seq, group, df, bins, words)
    snv_kernel.snv_cand_bin_plain(seq, group, df, plain, plain_words)
    cells = bins.cells()
    differing = int((bins.counts[:cells] != plain.counts[:cells]).sum())
    differing += int((bins.ends[:cells] != plain.ends[:cells]).sum())
    if not differing:
        differing += sum(int((a != b).sum()) for a, b in zip(snv_kernel.bin_multiset(bins),
                                                             snv_kernel.bin_multiset(plain)))
    differing += int((words != plain_words).sum())
    snv_kernel.snv_cand_probe(bins, df, words)
    snv_kernel.snv_cand_probe_plain(plain, df, plain_words)
    want = snv_kernel.snv_cand_words_plain(seq, group, df)
    differing += int((words != plain_words).sum()) + int((words != want).sum())
    err = int(((words.long() & 0xFFFFFFFF) - (want.long() & 0xFFFFFFFF)).abs().max())
    del plain
    entries = bins.total()
    word = bins.can[:entries] & (df.modulus - 1)
    sectors = int(torch.unique(word >> 3).numel())
    times = time_turns({"bin": lambda: snv_kernel.snv_cand_bin(seq, group, df, bins, words),
                        "probe": lambda: snv_kernel.snv_cand_probe(bins, df, words)}, flush)
    spare = snv_kernel.CandBins(df.modulus, group, df.device)
    plain_ms = time_turns({
        "bin": lambda: snv_kernel.snv_cand_bin_plain(seq, group, df, spare, plain_words),
        "probe": lambda: snv_kernel.snv_cand_probe_plain(spare, df, plain_words)}, flush, 1)
    del spare
    table = df.table[: min(df.modulus, 1 << bins.slice_bits)]
    floor = time_turns({"f": lambda: gate_kernel.probe_floor(table, entries, -(-entries // 4), 4)},
                       flush)["f"]
    # the function both kernels compute together, the group's candidate
    # words, needs its ASCII once, the words and the distinct filter sectors
    # its probes touch: one bound for the two.  The entries (written by the
    # front end, read by the probes) and the count matrix exist only in
    # this design: each kernel's design_bytes counts them beside its share
    # of the function's bytes
    nbytes = group + K - 1 + 4 * nw + 32 * sectors
    bound = nbytes / HBM_BYTES_PER_S * 1e3
    bin_design = group + K - 1 + 4 * nw + snv_kernel.ENTRY_BYTES * entries + 12 * cells
    probe_design = snv_kernel.ENTRY_BYTES * entries + 32 * sectors + 4 * nw
    bin_ms, probe_ms = float(np.median(times["bin"])), float(np.median(times["probe"]))
    return {"heads": group, "entries": entries, "slices": bins.n_slices,
            "slice_bits": bins.slice_bits, "cells": cells, "scratch_bytes": bins.nbytes,
            "sectors": sectors, "probes_per_sector": entries / (df.modulus / 8),
            "differing": differing, "max_abs_err": err, "bytes": nbytes, "bound_ms": bound,
            "share_of_bound": bound / (bin_ms + probe_ms),
            "bin": {"ms": bin_ms, "plain_ms": float(np.median(plain_ms["bin"])),
                    "bytes": nbytes, "bound_ms": bound, "design_bytes": bin_design,
                    "floor_ms": copy_ms(bin_design, flush),
                    "floor": "device copy of its design bytes"},
            "probe": {"ms": probe_ms, "plain_ms": float(np.median(plain_ms["probe"])),
                      "bytes": nbytes, "bound_ms": bound, "design_bytes": probe_design,
                      "floor_ms": float(np.median(floor)),
                      "floor": "random probes of one slice's words, 4 in flight"}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="snv_sweep", description=__doc__.split("\n\n")[0])
    ap.add_argument("--against", metavar="DIR", default=None,
                    help="also time the candidate kernel of the checkout at DIR")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("snv_sweep: no CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    dev = torch.device("cuda")
    snv_kernel.load_library()
    other = CandWords(args.against) if args.against else None
    refs, variants, _ = simulate.snv_genome(LENGTHS, seed=700)
    contigs = contigs_on_card(refs, dev)
    flush = torch.empty(256 * MIB, dtype=torch.uint8, device=dev)
    base = bloom.pow2_size_bytes(sum(LENGTHS), HASH_NUM, 0.001)
    for times in SIZES:
        df = variant_filter(variants, base * times, dev)
        row = {"sweep": "pass", "filter_bytes": base * times, "against": args.against,
               **pass_numbers(contigs, df, flush, other, VARIANTS)}
        print(json.dumps(row), flush=True)
        print(json.dumps({"sweep": "contigs", "filter_bytes": base * times,
                          "rows": contig_numbers(contigs, df, flush)}), flush=True)
        row = kernel_numbers(*contigs[0], df, flush)
        if row["differing"]:
            raise AssertionError(f"a binned kernel differs from its plain version: {row}")
        print(json.dumps({"sweep": "kernels", "filter_bytes": base * times, **row}), flush=True)
        del df
        torch.cuda.empty_cache()
    pl = bloom.KmerBloomFilter.zeros(bloom.bf_size_bytes(LENGTHS[2], HASH_NUM, 0.001), HASH_NUM, K)
    pl.insert_seq(variants[2])
    df = bloom.DeviceFilter.from_host(pl, dev)
    print(json.dumps({"sweep": "plain", "filter_bytes": pl.bytes, "against": args.against,
                      **pass_numbers(contigs[2:3], df, flush, other)}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
