"""The site-row kernel on one NVIDIA GPU, at the shapes the SNV and polish
paths give it: builds that differ in one design choice, lanes a row among
them.

    python -m ntedit_tpu_torch.utils.site_sweep
    python -m ntedit_tpu_torch.utils.site_sweep --against OTHER_CHECKOUT

The data: the SNV path's (chip_smoke.py's snv_blocked workload,
simulate.snv_genome seed 700, k = 25, jump 3): the 30 Mbp contig's
candidates with a 256 MiB blocked filter of the copy's k-mers (built on
the card), and the 5 Mbp contig's with snv_plain's plain filter; the
polish path's: one 2^22-head chunk of a draft with simulate.inject_errors'
errors, its gates against a 256 MiB blocked filter of the truth.  Each
line is one JSON object.  Needs a CUDA device; prints the card's name and
power limit first.  Times are medians over ROUNDS rounds in turns, CUDA
events, the L2 flushed before each; every build's rows are held to the
plain version's first.

* ``builds``: resident blocks per SM of each build's row kernel forms.
* ``snv_blocked``, ``snv_plain``, ``polish``: each build's ms.  Builds:
  ``this`` (the source as it is: 4 lanes an SNV row, up to 8 a polish
  row), ``lanes1``, ``lanes2``, ``lanes4``, ``lanes8`` (that many lanes an
  SNV row, at most that many a polish row), ``bounds8`` (the SNV kernel
  under ``__launch_bounds__(128, 8)``: at most 64 registers, 8 blocks of
  128 per SM), ``blocked_windows1`` (one window's probes a batch with a
  blocked filter, four loads in flight, where ``this`` sends two windows'
  eight), ``plain_windows2`` (two windows a batch with a plain filter,
  where ``this`` sends one).  With ``--against DIR``, DIR's kernel too
  (utils/other.py SiteRows: ``other``), and the rounds in which ``this``
  was faster than it.
* ``polish_split``: the polish form's gate checks alone, as the time of a
  list of as many gates in one cluster (one row), beside the whole; and
  the device time of the polish kernel by torch.profiler.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess

import numpy as np
import torch

from ntedit_tpu_torch.core import bloom
from ntedit_tpu_torch.engine import flag
from ntedit_tpu_torch.ops import gate_kernel, snv_kernel
from ntedit_tpu_torch.utils import build, simulate
from ntedit_tpu_torch.utils.other import SiteRows
from ntedit_tpu_torch.utils.snv_sweep import MIB, contigs_on_card, time_turns, variant_filter

K = 25
JUMP = 3
ROUNDS = 20
# build -> [(a text of the source it changes, what it becomes)]
LANES = {f"lanes{rt}": [("constexpr int kRowLanes = 4;", f"constexpr int kRowLanes = {rt};"),
                        ("constexpr int kMaxPolishLanes = 8;", f"constexpr int kMaxPolishLanes = {rt};")]
         for rt in (1, 2, 4, 8)}
BUILDS = {
    "this": [],
    **LANES,
    "bounds8": [("__launch_bounds__(kRowThreads)\nsite_rows_kernel",
                 "__launch_bounds__(kRowThreads, 8)\nsite_rows_kernel")],
    "blocked_windows1": [("constexpr int kSiteWindowsBlocked = 2;",
                          "constexpr int kSiteWindowsBlocked = 1;")],
    "plain_windows2": [("constexpr int kSiteWindowsPlain = 1;",
                        "constexpr int kSiteWindowsPlain = 2;")],
}


def builds() -> dict:
    """build -> the kernel library built from the source with that
    build's changes, its site-row interface declared."""
    with open(snv_kernel.SOURCE) as f:
        src = f.read()
    libs = {"this": snv_kernel.load_library()}
    for name, changes in BUILDS.items():
        if not changes:
            continue
        text = src
        for old, new in changes:
            if old not in text:
                raise RuntimeError(f"build {name}: the source no longer holds {old!r}")
            text = text.replace(old, new)
        path = os.path.join(build.BUILD_DIR, f"snv_kernel_{name}.cu")
        os.makedirs(build.BUILD_DIR, exist_ok=True)
        with open(path, "w") as f:
            f.write(text)
        lib = ctypes.CDLL(build.build_library(f"snv_kernel_{name}", path, gate_kernel._command,
                                              deps=(snv_kernel.HEADER,)))
        snv_kernel.declare_site_rows(lib)
        lib.nts_occupancy.restype = ctypes.c_int
        lib.nts_occupancy.argtypes = [ctypes.c_int]
        libs[name] = lib
    return libs


def sweep(libs: dict, seq, n: int, heads, df, polish: bool, flush, other=None) -> dict:
    """ms of every build (and ``other``, a SiteRows) in turns, each held to
    the plain version first."""
    want = (snv_kernel.polish_site_rows_plain if polish else snv_kernel.snv_site_rows_plain)(
        seq, n, heads, df, JUMP)
    cases = {name: (lambda lib=lib: snv_kernel._site_rows(seq, n, heads, df, JUMP, polish, lib))
             for name, lib in libs.items()}
    if other is not None:
        cases["other"] = lambda: other.rows(seq, n, heads, df, JUMP, polish)
    for tag, fn in cases.items():
        diff = int((fn() != want).any(1).sum())
        if diff:
            raise AssertionError(f"{tag}: {diff} rows differ from the plain version")
    times = time_turns(cases, flush, ROUNDS)
    out = {"ms": {tag: float(np.median(t)) for tag, t in times.items()}}
    if other is not None:
        out["faster_than_other_rounds"] = sum(
            a < b for a, b in zip(times["this"], times["other"]))
    return out


def profiled(fn, reps: int = 20) -> dict:
    """Device ms per call of each kernel ``fn`` launches (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        us = getattr(e, "device_time_total", None) or getattr(e, "cuda_time_total", 0)
        if us and "rows_kernel" in e.key:
            out[e.key[:80]] = us / reps / 1e3
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="site_sweep", description=__doc__.split("\n\n")[0])
    ap.add_argument("--against", metavar="DIR", default=None,
                    help="also time the site-row kernel of the checkout at DIR")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("site_sweep: no CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    dev = torch.device("cuda")
    libs = builds()
    other = SiteRows(args.against) if args.against else None
    forms = ("site_plain", "site_blocked", "polish_site_plain", "polish_site_blocked")
    print(json.dumps({"sweep": "builds", "blocks_per_sm": {
        name: {form: lib.nts_occupancy(snv_kernel.OCCUPANCY_FORMS.index(form)) for form in forms}
        for name, lib in libs.items()}}), flush=True)
    flush = torch.empty(256 * MIB, dtype=torch.uint8, device=dev)
    lengths = (30_000_000, 15_000_000, 5_000_000, 5_000, 60)  # snv_blocked's
    refs, variants, _ = simulate.snv_genome(lengths, seed=700)
    contigs = contigs_on_card(refs[:3], dev)
    blk = variant_filter(variants, bloom.pow2_size_bytes(sum(lengths), 3, 0.001), dev)
    pl = bloom.KmerBloomFilter.zeros(bloom.bf_size_bytes(lengths[2], 3, 0.001), 3, K)
    pl.insert_seq(variants[2])
    for tag, (seq, n), df in (("snv_blocked", contigs[0], blk),
                              ("snv_plain", contigs[2], bloom.DeviceFilter.from_host(pl, dev))):
        cand = flag.positions_on_device(flag.snv_candidate_words(seq, n, df))
        print(json.dumps({"sweep": tag, "rows": int(cand.numel()), "against": args.against,
                          **sweep(libs, seq, n, cand, df, False, flush, other)}), flush=True)
    del contigs
    # the polish chunk
    n = flag.DEFAULT_CHUNK
    truth = simulate.random_genome(n + K - 1 + 1000, seed=31)
    draft, _ = simulate.inject_errors(truth, seed=32)
    seq = torch.zeros(gate_kernel.padded_len(n), dtype=torch.uint8)
    seq[: n + K - 1] = torch.from_numpy(draft[: n + K - 1].copy())
    seq = seq.to(dev)
    df = variant_filter([truth], bloom.pow2_size_bytes(50_000_000, 3, 0.001), dev)
    gates = flag.positions_on_device(gate_kernel.gate_words(seq, n, df))
    g = int(gates.numel())
    print(json.dumps({"sweep": "polish", "gates": g, "against": args.against,
                      **sweep(libs, seq, n, gates, df, True, flush, other)}), flush=True)
    one_cluster = torch.arange(1000, 1000 + g, dtype=torch.int64, device=dev)
    times = time_turns({
        "whole": lambda: snv_kernel.polish_site_rows(seq, n, gates, df, JUMP),
        "gate_pass": lambda: snv_kernel.polish_site_rows(seq, n, one_cluster, df, JUMP)},
        flush, ROUNDS)
    print(json.dumps({"sweep": "polish_split", "gates": g,
                      "ms": {k: float(np.median(t)) for k, t in times.items()},
                      "profiler_ms": profiled(
                          lambda: snv_kernel.polish_site_rows(seq, n, gates, df, JUMP))}),
          flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
