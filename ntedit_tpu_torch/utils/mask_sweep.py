"""The candidate-mask kernel on one NVIDIA GPU at the native path's shape,
as it is and with a shared-memory stage; and the native engine with masks
against another checkout's, in turns.

    python -m ntedit_tpu_torch.utils.mask_sweep
    python -m ntedit_tpu_torch.utils.mask_sweep --against OTHER_CHECKOUT

The data: chip_smoke.py's main_blocked (simulate.polish_genome seed 500:
contigs of 30, 15 and 5 Mbp, 5 kbp and 60 bp, k = 25) with a 256 MiB
blocked filter of the truth built on the host.  Each line is one JSON
object.  Needs a CUDA device; prints the card's name and power limit
first.

* ``kernel``: the 30 Mbp contig's gates (one launch a contig on the
  path), both forms (``gated``, ``four_probe``) in two builds: ``this``
  (the source as it is: every thread reads its window from global memory)
  and ``staged`` (a block of 256 consecutive gates first copies the span
  of its run, [first, last + k) as aligned 16-byte vectors, into 16 KB of
  shared memory where it fits, and its threads hash their windows from
  there).  Every case is held to the plain version first; then ms,
  medians of ROUNDS rounds in turns, CUDA events, the L2 flushed before
  each; each round's ms, and the rounds in which the staged build was
  faster.
* ``engine`` (with ``--against DIR``): ``Polisher(engine="native", -t 8)``
  over the draft with masks and without, from this checkout and from DIR,
  each in a process of its own, the processes in turns (DIR, this; then
  this, DIR), PROCESSES of each.  A process runs masks on and off once
  untimed, then REPS times each in turns, and prints each wall and a
  digest of the edited contigs, which must agree across every process.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import torch

from ntedit_tpu_torch.core import bloom
from ntedit_tpu_torch.engine import flag
from ntedit_tpu_torch.io import fastx
from ntedit_tpu_torch.ops import gate_kernel, snv_kernel
from ntedit_tpu_torch.utils import build, simulate
from ntedit_tpu_torch.utils.snv_sweep import MIB, time_turns

K = 25
LENGTHS = (30_000_000, 15_000_000, 5_000_000, 5_000, 60)  # main_blocked's
ROUNDS = 20
REPS = 5
PROCESSES = 3
THREADS = 8
# the staged build: [(a text of the mask kernel, what it becomes)]
STAGED = [
    ("\t__shared__ MaskTables tb;\n",
     "\tconstexpr int kStage = 16384;\n"
     "\t__shared__ __align__(16) uint8_t stage[kStage];\n"
     "\t__shared__ MaskTables tb;\n"),
    ("\t__syncthreads();\n"
     "\tconst uint64_t g = (uint64_t)blockIdx.x * kThreads + t;\n"
     "\tif (g >= n_gates)\n"
     "\t\treturn;\n"
     "\tconst int64_t h = gates[g];\n"
     "\tbool ok = h >= 0 && (uint64_t)h < n;\n"
     "\tconst uint8_t* p = seq + h;\n",
     "\tconst uint64_t g0 = (uint64_t)blockIdx.x * kThreads, g = g0 + t;\n"
     "\tconst uint64_t g1 = (g0 + kThreads < n_gates ? g0 + kThreads : n_gates) - 1;\n"
     "\tconst int64_t lo = gates[g0], last = gates[g1], hi = last + k;\n"
     "\tconst uintptr_t base = reinterpret_cast<uintptr_t>(seq);\n"
     "\tconst uintptr_t a0 = (base + (uintptr_t)lo) & ~(uintptr_t)15;\n"
     "\tconst uintptr_t a1 = (base + (uintptr_t)hi + 15) & ~(uintptr_t)15;\n"
     "\tconst bool staged = lo >= 0 && lo <= last && (uint64_t)last < n && a1 - a0 <= kStage;\n"
     "\tif (staged)\n"
     "\t\tfor (uintptr_t a = a0 + 16 * t; a < a1; a += 16 * kThreads)\n"
     "\t\t\t*reinterpret_cast<uint4*>(stage + (a - a0)) =\n"
     "\t\t\t\tload16(reinterpret_cast<const uint8_t*>(a));\n"
     "\t__syncthreads();\n"
     "\tif (g >= n_gates)\n"
     "\t\treturn;\n"
     "\tconst int64_t h = gates[g];\n"
     "\tbool ok = h >= 0 && (uint64_t)h < n;\n"
     "\tconst uint8_t* p = staged && h >= lo && h <= last ? stage + (base + (uintptr_t)h - a0)\n"
     "\t                                                  : seq + h;\n"),
]

# One process of the engine's turns.  It uses only what both checkouts
# have: Polisher(engine="native", cand_masks=...) and the readers.
ENGINE_RUN = r"""
import hashlib, json, sys, time
from ntedit_tpu_torch.core import bloom
from ntedit_tpu_torch.engine.config import EngineConfig
from ntedit_tpu_torch.engine.polish import Polisher
from ntedit_tpu_torch.io import fastx

bf_path, draft_path, reps, threads = sys.argv[1], sys.argv[2], int(sys.argv[3]), int(sys.argv[4])
bf = bloom.load_any(bf_path)
cfg = EngineConfig(k=bf.k, hash_num=bf.hash_num, threads=threads).validate()
recs = [(r.header, r.seq) for r in fastx.read_fastx(draft_path)
        if len(r.seq) >= cfg.min_contig_len]
pols = {on: Polisher(bf, None, cfg, device="cuda", engine="native", cand_masks=on)
        for on in (True, False)}
digests = set()


def run(on):
    t0 = time.perf_counter()
    results = list(pols[on].polish(iter(recs)))
    wall = time.perf_counter() - t0
    h = hashlib.sha256()
    for res in results:
        h.update(res.header.encode() + b"\n" + res.edited + b"\n")
    digests.add(h.hexdigest())
    return wall


run(True), run(False)
times = {True: [], False: []}
for i in range(reps):
    for on in ((True, False) if i % 2 == 0 else (False, True)):
        times[on].append(run(on))
print(json.dumps({"masks_on_s": times[True], "masks_off_s": times[False],
                  "digests": sorted(digests)}))
"""


def staged_library():
    """The kernels built from the source with the mask kernel's stage."""
    with open(snv_kernel.SOURCE) as f:
        src = f.read()
    for old, new in STAGED:
        if src.count(old) != 1:
            raise RuntimeError(f"the source does not hold {old!r} once")
        src = src.replace(old, new)
    path = os.path.join(build.BUILD_DIR, "snv_kernel_staged.cu")
    os.makedirs(build.BUILD_DIR, exist_ok=True)
    with open(path, "w") as f:
        f.write(src)
    return snv_kernel.open_library(build.build_library(
        "snv_kernel_staged", path, gate_kernel._command, deps=(snv_kernel.HEADER,)))


def on_library(lib, fn):
    """``fn`` run with the mask wrapper launching from ``lib``."""
    def run():
        saved = snv_kernel._lib
        snv_kernel._lib = lib
        try:
            return fn()
        finally:
            snv_kernel._lib = saved
    return run


def kernel_sweep(draft: np.ndarray, host_bf, flush) -> dict:
    dev = flush.device
    df = bloom.DeviceFilter.from_host(host_bf, dev)
    n = len(draft) - K + 1
    seq = torch.from_numpy(draft).to(dev)
    gates = torch.from_numpy(flag.flag_contig_gates(draft, df)).to(dev)
    libs = {"this": snv_kernel.load_library(), "staged": staged_library()}
    cases = {}
    for gated, form in ((True, "gated"), (False, "four_probe")):
        want = snv_kernel.polish_cand_masks_plain(seq, n, gates, df, gated)
        for build_name, lib in libs.items():
            fn = on_library(lib, lambda gated=gated: snv_kernel.polish_cand_masks(
                seq, n, gates, df, gated=gated))
            diff = int((fn() != want).sum())
            if diff:
                raise AssertionError(f"{build_name} {form}: {diff} masks differ from plain")
            cases[f"{build_name}.{form}"] = fn
    times = time_turns(cases, flush, ROUNDS)
    out = {"sweep": "kernel", "gates": int(gates.numel()),
           "ms": {name: float(np.median(t)) for name, t in times.items()},
           "round_ms": times}
    out["staged_faster_rounds"] = {
        form: sum(a < b for a, b in zip(times[f"staged.{form}"], times[f"this.{form}"]))
        for form in ("gated", "four_probe")}
    return out


def engine_turns(other: str, bf_path: str, draft_path: str) -> dict:
    here = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    roots = {"this": here, "other": os.path.abspath(other)}
    walls = {name: {"masks_on_s": [], "masks_off_s": []} for name in roots}
    digests = set()
    for i in range(PROCESSES):
        for name in (("other", "this") if i % 2 == 0 else ("this", "other")):
            env = dict(os.environ, PYTHONPATH=roots[name])
            res = subprocess.run([sys.executable, "-c", ENGINE_RUN, bf_path, draft_path,
                                  str(REPS), str(THREADS)], cwd=roots[name], env=env,
                                 capture_output=True, text=True)
            if res.returncode:
                raise RuntimeError(f"engine run in {roots[name]} failed:\n{res.stderr[-4000:]}")
            one = json.loads(res.stdout.strip().splitlines()[-1])
            for key in ("masks_on_s", "masks_off_s"):
                walls[name][key].append(one[key])
            digests.update(one["digests"])
    if len(digests) != 1:
        raise AssertionError(f"the edited contigs differ between runs: {sorted(digests)}")
    out = {"sweep": "engine", "against": other, "threads": THREADS, "reps": REPS,
           "processes": PROCESSES, "walls": walls}
    for name, w in walls.items():
        for key, per in w.items():
            out[f"{name}_{key.removesuffix('_s')}_median_s"] = float(np.median(np.concatenate(per)))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="mask_sweep", description=__doc__.split("\n\n")[0])
    ap.add_argument("--against", metavar="DIR", default=None,
                    help="also time the native engine of the checkout at DIR")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("mask_sweep: no CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    truths, drafts = simulate.polish_genome(LENGTHS, seed=500)
    host_bf = bloom.BlockedKmerBloomFilter.zeros(bloom.pow2_size_bytes(sum(LENGTHS), 3, 0.001),
                                                 3, K)
    for t in truths:
        host_bf.insert_seq(t)
    flush = torch.empty(256 * MIB, dtype=torch.uint8, device="cuda")
    print(json.dumps(kernel_sweep(drafts[0], host_bf, flush)), flush=True)
    if args.against:
        work = os.path.join(build.BUILD_DIR, "mask_sweep")
        os.makedirs(work, exist_ok=True)
        try:
            bf_path, draft_path = os.path.join(work, "draft.bf"), os.path.join(work, "draft.fa")
            host_bf.save(bf_path)
            fastx.write_fasta(draft_path, [(f"contig{i} simulated", d.tobytes())
                                           for i, d in enumerate(drafts)])
            del flush
            torch.cuda.empty_cache()
            print(json.dumps(engine_turns(args.against, bf_path, draft_path)), flush=True)
        finally:
            shutil.rmtree(work, ignore_errors=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
