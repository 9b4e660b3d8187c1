"""Witness of a fault of the program that keeps the benchmark's cells at
``-t 1``: the native repair library's first calls, made from several
threads at once, race on its lazily built static tables
(``native/repair.cpp``: ``build_tables`` and ``init_tables``, run by every
call until one has finished them).  Run from the checkout's root:

    python3 benchmark/race_witness.py --processes 200 [--warm]

Each process builds a small polish job, then 8 threads enter
``ntr_polish_contig`` through a barrier.  Without ``--warm`` some processes
abort (``double free or corruption``, ``malloc(): invalid next size``) or
segfault; with ``--warm`` one call from one thread comes first and none
does.  It prints the exit codes and the distinct outputs counted."""

from __future__ import annotations

import collections
import os
import subprocess
import sys
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def one(warm: bool) -> str:
    sys.path.insert(0, ROOT)
    from ntedit_tpu_torch.core import bloom
    from ntedit_tpu_torch.engine import native_repair as nr
    from ntedit_tpu_torch.engine.config import EngineConfig

    rng = np.random.default_rng(3)
    truth = np.frombuffer(b"ACGT", dtype=np.uint8)[rng.integers(0, 4, 20000)]
    draft = truth.copy()
    draft[rng.choice(np.arange(100, 19900), 20, replace=False)] = ord("N")
    bf = bloom.BlockedKmerBloomFilter.zeros(1 << 20, 3, 25)
    bf.insert_seq(truth)
    gates = np.nonzero(~bf.contains_seq_kmers(draft))[0].astype(np.int64)
    cfg = EngineConfig(k=25, hash_num=3, threads=8).validate()
    lib = nr.get_lib()
    bf_struct, rep_struct, _keep = nr._filters_of(bf, None)
    params = nr._params_of(cfg)
    seq = draft.tobytes()
    if warm:
        nr._run_raw(lib, draft.copy(), seq, gates, bf_struct, rep_struct, params)
    barrier = threading.Barrier(8)
    out = [None] * 8

    def work(i: int) -> None:
        contig = draft.copy()
        barrier.wait()
        sb, nb = nr._run_raw(lib, contig, seq, gates, bf_struct, rep_struct, params)
        out[i] = (len(sb), int(sb.sum()), len(nb))

    threads = [threading.Thread(target=work, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return f"{len(set(out))} {out[0]}"


def main() -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--processes", type=int, default=200)
    ap.add_argument("--warm", action="store_true")
    ap.add_argument("--one", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.one:
        print(one(args.warm))
        return 0
    cmd = [sys.executable, os.path.abspath(__file__), "--one"] + (["--warm"] if args.warm else [])

    def run(_):
        p = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
        return p.returncode, p.stdout.strip() or (p.stderr.strip().splitlines() or [""])[-1]

    with ThreadPoolExecutor(max_workers=4) as ex:
        got = list(ex.map(run, range(args.processes)))
    print({"warm": args.warm, "exit_codes": dict(collections.Counter(c for c, _ in got)),
           "outputs": dict(collections.Counter(o for _, o in got))})
    return 0


if __name__ == "__main__":
    sys.exit(main())
