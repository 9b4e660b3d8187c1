"""The port's native repair library (``csrc/repair.cpp``) entered from many
threads at once: eight threads released together by a barrier into a
fresh process's first calls, through ``native_repair._run_raw`` and
straight into ``ntr_polish_contig``, in eight fresh processes each, every
process exiting 0 with the output of one call alone; and two Polishers of
k 25 and k 55 in one process, their calls interleaved from threads, each
output equal to its own ``-t 1`` run's.  (``native/repair.cpp``, which the
JAX package builds, fills its tables on every call until one has finished
and aborts or crashes this way.)"""

from __future__ import annotations

import ctypes
import hashlib
import io
import os
import subprocess
import sys
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
THREADS = 8
PROCESSES = 8


def _job():
    """A 20 kbp draft with 20 N bytes, its truth's k-mers in a blocked
    filter, and its gates: (library, draft, gates, filter, parameters,
    what the caller keeps referenced)."""
    from ntedit_tpu_torch.core import bloom
    from ntedit_tpu_torch.engine import native_repair as nr
    from ntedit_tpu_torch.engine.config import EngineConfig

    rng = np.random.default_rng(3)
    truth = np.frombuffer(b"ACGT", dtype=np.uint8)[rng.integers(0, 4, 20000)]
    draft = truth.copy()
    draft[rng.choice(np.arange(100, 19900), 20, replace=False)] = ord("N")
    for p in rng.choice(np.arange(200, 19800), 20, replace=False):
        draft[p] = ord("A") if truth[p] != ord("A") else ord("G")
    bf = bloom.BlockedKmerBloomFilter.zeros(1 << 20, 3, 25)
    bf.insert_seq(truth)
    gates = np.nonzero(~bf.contains_seq_kmers(draft))[0].astype(np.int64)
    lib = nr.get_lib()
    bf_struct, rep_struct, keep = nr._filters_of(bf, None)
    params = nr._params_of(EngineConfig(k=25, hash_num=3, threads=THREADS).validate())
    return lib, draft, gates, (bf_struct, rep_struct), params, keep


def _digest(sb, nb, contig) -> str:
    return hashlib.sha1(sb.tobytes() + nb.tobytes() + contig.tobytes()).hexdigest()


def _call(job, how: str, barrier=None) -> str:
    """One call on a copy of the draft: through ``_run_raw``, or with every
    argument made before the barrier and ``ntr_polish_contig`` called
    straight after it (the least time between the threads' first calls)."""
    from ntedit_tpu_torch.engine import native_repair as nr

    lib, draft, gates, (bf_struct, rep_struct), params, _keep = job
    contig = draft.copy()
    if how == "run_raw":
        if barrier is not None:
            barrier.wait()
        sb, nb = nr._run_raw(lib, contig, draft.tobytes(), gates, bf_struct, rep_struct, params)
        return _digest(sb, nb, contig)
    cap = 1 << 16
    sb, nb = np.empty(cap * 10, np.int64), np.empty(cap * 4, np.int64)
    n_subs, n_nodes = ctypes.c_int64(0), ctypes.c_int64(0)
    args = [contig.ctypes.data, contig.size, gates.ctypes.data, gates.size,
            ctypes.byref(bf_struct), None, ctypes.byref(params),
            sb.ctypes.data, cap, ctypes.byref(n_subs), nb.ctypes.data, cap, ctypes.byref(n_nodes)]
    polish = lib.ntr_polish_contig
    if barrier is not None:
        barrier.wait()
    assert polish(*args) == 0
    return _digest(sb[: n_subs.value * 10], nb[: n_nodes.value * 4], contig)


def child(how: str) -> str:
    """THREADS threads into their process's first calls at once: the
    number of distinct outputs and the first."""
    job = _job()
    barrier = threading.Barrier(THREADS)
    out = [None] * THREADS

    def work(i):
        out[i] = _call(job, how, barrier)

    threads = [threading.Thread(target=work, args=(i,)) for i in range(THREADS)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return f"{len(set(out))} {out[0]}"


@pytest.mark.parametrize("how", ["run_raw", "ntr_polish_contig"])
def test_first_calls_from_eight_threads_at_once(how):
    """In each of 8 fresh processes, 8 threads make the process's first
    native calls together: every process exits 0, and every thread's
    output is that of one call alone (made here, in another process)."""
    alone = _call(_job(), how)  # also builds the library before the children load it

    def run(_):
        p = subprocess.run([sys.executable, os.path.abspath(__file__), how],
                           capture_output=True, text=True, timeout=120, cwd=ROOT)
        return p.returncode, p.stdout.strip() or p.stderr.strip()[-300:]

    with ThreadPoolExecutor(max_workers=4) as ex:
        got = list(ex.map(run, range(PROCESSES)))
    assert got == [(0, f"1 {alone}")] * PROCESSES, got


def _polisher(k: int, seed: int):
    """A blocked filter of a 60 kbp truth's k-mers, its Polisher at -t 1
    (one native call over each whole contig: the longest calls) and two
    drafts of the truth with substitutions and indels."""
    from ntedit_tpu_torch.core import bloom
    from ntedit_tpu_torch.engine.config import EngineConfig
    from ntedit_tpu_torch.engine.polish import Polisher
    from ntedit_tpu_torch.utils import simulate

    truth = simulate.random_genome(60000, seed=seed)
    drafts = [simulate.inject_errors(truth, sub_rate=5e-3, ins_rate=3e-4, del_rate=3e-4,
                                     seed=seed + i)[0] for i in (1, 2)]
    bf = bloom.BlockedKmerBloomFilter.zeros(1 << 16, 3, k)
    bf.insert_seq(truth)
    pol = Polisher(bf, None, EngineConfig(k=k, hash_num=3, threads=1), chunk=1 << 15,
                   device="cpu")
    return pol, [(f"k{k}_{i}", d) for i, d in enumerate(drafts)]


def _render(res) -> tuple:
    from ntedit_tpu_torch.io import writers

    sinks = io.StringIO(), io.StringIO(), io.StringIO()
    writers.write_contig(res, *sinks, None)
    return tuple(s.getvalue() for s in sinks)


def test_two_k_in_one_process_from_interleaved_threads():
    """Polishers of k 25 and k 55 in one process, six threads each running
    contigs of both in turn, four rounds: every output equals the
    Polisher's own -t 1 output, made before with no other call in flight,
    and the runs made edits.  (Where calls of one k could overwrite the
    tables that calls of the other are reading, 6-22 of the 96 outputs
    differed.)"""
    by_k = []
    for k, seed in ((25, 40), (55, 50)):
        pol, contigs = _polisher(k, seed)
        by_k.append([(pol, h, s, _render(pol.polish_contig(h, s))) for h, s in contigs])
    jobs = [job for pair in zip(*by_k) for job in pair]  # k 25 and k 55 in turn
    assert all(want[1].count("\n") > 5 for *_, want in jobs)  # edits to compare

    def work(i):
        order = jobs[i % len(jobs):] + jobs[: i % len(jobs)]
        return [(_render(pol.polish_contig(h, s)), want) for pol, h, s, want in order * 4]

    with ThreadPoolExecutor(max_workers=6) as ex:
        got = [pair for part in ex.map(work, range(6), timeout=600) for pair in part]
    assert len(got) == 6 * 4 * len(jobs)
    assert all(out == want for out, want in got)


if __name__ == "__main__":
    sys.path.insert(0, ROOT)
    print(child(sys.argv[1]))
