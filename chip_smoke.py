#!/usr/bin/env python3
"""Smoke run of the torch port (ntedit_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py            # every phase, as a user-sized run (no options)

Phases, each printing one JSON line; any failure exits nonzero:

1. build    - builds the CUDA gate kernel (nvcc) and the host repair
              library (g++) from the sources in this checkout, side by side.
2. kernel   - the gate kernel against its plain torch version on the card,
              bit for bit: blocked, plain (hash_num 3 and 4) and counting
              (-p 1 and 3) filters, k in {17, 25, 40}, snv on and off, on a
              draft with N runs, IUPAC and lowercase bytes and a ragged tail.
3. main     - ``python -m ntedit_tpu_torch engine -t 8`` (in-process) on a
              seeded 50 Mbp draft with a 256 MiB blocked filter, then with a
              btllib-sized plain filter; the three output files must equal,
              byte for byte, a host-only full sequential scan of the same
              C++ engine rendered by the same writers.
4. counting - the same check with a count-min filter and -p 2 -q 254.
5. numbers  - the gate pass alone at the main path's chunk shape (CUDA
              events, L2 flushed between launches), its plain version, a
              torch.take gather of as many random words as a yardstick, and
              the least time the card could take for the same bytes.

Then a ``{"kernels": [...]}`` line and, last, the device line
``{"ok": true, "device": {...}}``.  Without a CUDA device, or outside a
checkout of the repository, it exits nonzero and prints no result.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3, NVIDIA data sheet
GENOME = 50_000_000  # bases of the main-path draft and of the timed filters
CBF_LENGTH = 4_700_000  # bases of the counting-filter contig
IUPAC = np.frombuffer(b"RYSWKMBDHV", dtype=np.uint8)


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# simulated data
# ---------------------------------------------------------------------------

def decorate(draft: np.ndarray, rng, n_runs: int, n_iupac: int, lower: int) -> np.ndarray:
    """Put short N runs, IUPAC bytes and one lowercase stretch into a draft."""
    d = draft.copy()
    L = len(d)
    for p in rng.integers(0, max(1, L - 16), size=n_runs):
        d[p : p + int(rng.integers(1, 13))] = ord("N")
    d[rng.integers(0, L, size=n_iupac)] = IUPAC[rng.integers(0, len(IUPAC), size=n_iupac)]
    if lower:
        a = int(rng.integers(0, max(1, L - lower)))
        d[a : a + lower] |= 0x20
    return d


def make_genome(lengths, seed: int):
    """Seeded truth contigs and their drafts (simulate.inject_errors
    defaults plus N runs, IUPAC bytes and a lowercase stretch)."""
    from ntedit_tpu_torch.utils import simulate

    rng = np.random.default_rng(seed)
    truths, drafts = [], []
    for i, L in enumerate(lengths):
        t = simulate.random_genome(L, seed=seed + 2 * i)
        d = t
        if L > 1000:
            d, _ = simulate.inject_errors(t, seed=seed + 2 * i + 1)
            d = decorate(d, rng, n_runs=max(1, L // 5_000_000), n_iupac=max(1, L // 1_000_000),
                         lower=min(2000, L // 10))
        truths.append(t)
        drafts.append(d)
    return truths, drafts


def fill_counts(cbf, seq: np.ndarray, times: int = 1) -> None:
    """Insert every k-mer of ``seq`` into a counting filter ``times`` times."""
    from ntedit_tpu_torch.core import nthash_ref as ref

    fh, rh = ref.all_window_hashes(seq, cbf.k)
    hashes = ref.extend_hashes_vec(ref.canonical(fh, rh), cbf.k, cbf.hash_num)
    for _ in range(times):
        cbf.insert_hashes(hashes)


def write_fasta(path: str, contigs) -> None:
    from ntedit_tpu_torch.io import fastx

    fastx.write_fasta(path, [(f"contig{i} simulated", s.tobytes()) for i, s in enumerate(contigs)])


def census(edited: np.ndarray, truth: np.ndarray, window: int = 30, max_skew: int = 12) -> dict:
    """Residual differences between a polished contig and its truth (the
    resynchronising walk of bench.py's residual_census, case-folded,
    skipping equal stretches with numpy)."""
    E = (edited & 0xDF).tobytes()
    T = (truth & 0xDF).tobytes()
    e, t = np.frombuffer(E, np.uint8), np.frombuffer(T, np.uint8)
    kinds: dict = {}
    i = j = 0
    while i < len(E) and j < len(T):
        m = min(len(E) - i, len(T) - j, 1 << 20)
        neq = np.flatnonzero(e[i : i + m] != t[j : j + m])
        if not len(neq):
            i += m
            j += m
            continue
        i += int(neq[0])
        j += int(neq[0])
        found = None
        for d in range(1, 2 * max_skew + 2):
            for di in range(min(d, max_skew) + 1):
                dj = d - di
                if dj <= max_skew and E[i + di : i + di + window] == T[j + dj : j + dj + window]:
                    found = (di, dj)
                    break
            if found:
                break
        if found is None:
            kinds["desync"] = kinds.get("desync", 0) + 1
            break
        di, dj = found
        kind = "sub" if di == dj else ("extra_bases" if di > dj else "missing_bases")
        kinds[kind] = kinds.get(kind, 0) + 1
        i += di
        j += dj
    return kinds


# ---------------------------------------------------------------------------
# phase 1: build
# ---------------------------------------------------------------------------

def phase_build() -> dict:
    import torch

    from ntedit_tpu_torch.engine import native_repair
    from ntedit_tpu_torch.ops import gate_kernel

    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is false")

    def timed(fn):
        t0 = time.perf_counter()
        fn()
        return time.perf_counter() - t0

    with ThreadPoolExecutor(max_workers=2) as ex:  # nvcc and g++ side by side
        jobs = {"gate_kernel_s": ex.submit(timed, gate_kernel.load_library),
                "repair_s": ex.submit(timed, native_repair.get_lib)}
        times = {name: job.result() for name, job in jobs.items()}
    return {"phase": "build", **times, "device": torch.cuda.get_device_name(0)}


# ---------------------------------------------------------------------------
# phase 2: kernel against plain version
# ---------------------------------------------------------------------------

def _filters_for(truth: np.ndarray, k: int, device):
    """(name, DeviceFilter, min_threshold) cases for one k."""
    from ntedit_tpu_torch.core import bloom

    out = []
    blk = bloom.BlockedKmerBloomFilter.zeros(1 << 16, 3, k)
    blk.insert_seq(truth)
    out.append(("blocked", blk, 1))
    for h in (3, 4):
        pl = bloom.KmerBloomFilter.zeros(50_021 + h, h, k)  # not a power of two
        pl.insert_seq(truth)
        out.append((f"plain_h{h}", pl, 1))
    cbf = bloom.KmerCountingBloomFilter8.zeros(300_007, 3, k)
    fill_counts(cbf, truth[: len(truth) // 2], 2)
    fill_counts(cbf, truth)
    for p in (1, 3):
        out.append((f"counting_p{p}", cbf, p))
    return [(name, bloom.DeviceFilter.from_host(f, device), p) for name, f, p in out]


def check_kernel(seq_dev, n, df, snv, p) -> int:
    """Kernel words vs plain words on one input; returns the number of
    differing words (0 when bit-equal)."""
    import torch

    from ntedit_tpu_torch.ops import gate_kernel

    got = gate_kernel.gate_words(seq_dev, n, df, snv, p)
    want = gate_kernel.gate_words_plain(seq_dev, n, df, snv, p)
    return int((got != want).sum())  # .sum() to the host synchronises


def phase_kernel() -> dict:
    import torch

    from ntedit_tpu_torch.ops import gate_kernel
    from ntedit_tpu_torch.utils import simulate

    dev = torch.device("cuda")
    rng = np.random.default_rng(7)
    truth = simulate.random_genome(40_000, seed=70)
    draft, _ = simulate.inject_errors(truth, sub_rate=3e-3, seed=71)
    draft = decorate(draft, rng, n_runs=4, n_iupac=40, lower=700)
    n_cases = differing = 0
    bad = []
    for k in (17, 25, 40):
        for name, df, p in _filters_for(truth, k, dev):
            for L in (len(draft), 8192 + k - 1 + 77, k + 30):  # ragged tails
                n = L - k + 1
                buf = torch.zeros(gate_kernel.padded_len(n), dtype=torch.uint8)
                buf[:L] = torch.from_numpy(draft[:L].copy())
                seq_dev = buf.to(dev)
                for snv in (False, True):
                    diff = check_kernel(seq_dev, n, df, snv, p)
                    n_cases += 1
                    differing += diff
                    if diff:
                        bad.append({"k": k, "filter": name, "L": L, "snv": snv, "words": diff})
    if bad:
        raise AssertionError(f"gate kernel differs from its plain version: {bad}")
    return {"phase": "kernel", "cases": n_cases, "differing_words": differing}


# ---------------------------------------------------------------------------
# phases 3 and 4: the main path against the host-only full scan
# ---------------------------------------------------------------------------

def reference_outputs(host_bf, draft_path: str, prefix: str, cfg) -> None:
    """The host-only full sequential scan of the port's C++ engine (no
    gate hint, one thread), rendered by the CLI's writers."""
    from ntedit_tpu_torch.engine import native_repair
    from ntedit_tpu_torch.io import fastx, writers

    counting = hasattr(host_bf, "counters")
    with open(prefix + "_edited.fa", "w") as dfout, \
         open(prefix + "_changes.tsv", "w") as rfout, \
         open(prefix + "_variants.vcf", "w") as vfout:
        rfout.write(writers.changes_tsv_header(cfg.k, cfg.jump, counting))
        vfout.write(writers.vcf_header(draft_path))
        for rec in fastx.read_fastx(draft_path):
            if len(rec.seq) < cfg.min_contig_len:
                continue
            res = native_repair.polish_contig_native(host_bf, None, cfg, rec.header, rec.seq)
            if res is None:
                raise RuntimeError(f"host engine failed on {rec.header}")
            writers.write_contig(res, dfout, rfout, vfout, {})


def _same_outputs(a: str, b: str) -> dict:
    out = {}
    for suffix in ("_edited.fa", "_changes.tsv", "_variants.vcf"):
        with open(a + suffix, "rb") as f:
            x = f.read()
        with open(b + suffix, "rb") as f:
            y = f.read()
        if suffix == "_variants.vcf":  # the date line may cross midnight
            x, y = (b"".join(l for l in z.splitlines(True) if not l.startswith(b"##fileDate"))
                    for z in (x, y))
        out[suffix] = x == y
    return out


def run_and_check(tag: str, work: str, host_bf, draft_path: str, truths, cli_args,
                  cfg) -> dict:
    """Run the port's engine CLI and the host-only reference; compare."""
    from ntedit_tpu_torch import cli
    from ntedit_tpu_torch.core import bloom
    from ntedit_tpu_torch.io import fastx
    from ntedit_tpu_torch.ops import gate_kernel

    bf_path = os.path.join(work, f"{tag}.bf")
    t0 = time.perf_counter()
    host_bf.save(bf_path)
    save_s = time.perf_counter() - t0
    prefix = os.path.join(work, tag)
    gate_kernel.gate_words.launches = 0
    t0 = time.perf_counter()
    cli.main(["engine", "-r", bf_path, "-f", draft_path, "-b", prefix, "--device", "cuda",
              *cli_args])
    wall = time.perf_counter() - t0
    launches = gate_kernel.gate_words.launches
    ref_prefix = prefix + "_ref"
    t0 = time.perf_counter()
    reference_outputs(bloom.load_any(bf_path), draft_path, ref_prefix, cfg)
    ref_s = time.perf_counter() - t0
    same = _same_outputs(prefix, ref_prefix)
    edited = {r.header.split()[0]: r.seq for r in fastx.read_fastx(prefix + "_edited.fa")}
    resid: dict = {}
    for i, t in enumerate(truths):
        e = edited.get(f"contig{i}")
        if e is not None:
            for kk, v in census(e, t).items():
                resid[kk] = resid.get(kk, 0) + v
    bases = sum(len(r.seq) for r in fastx.read_fastx(draft_path) if len(r.seq) >= cfg.min_contig_len)
    out = {"phase": tag, "bp": bases, "wall_s": wall, "bp_per_s": bases / wall,
           "launches": launches, "reference_full_scan_s": ref_s, "filter_save_s": save_s,
           "byte_identical": same, "residual_vs_truth": resid}
    if not all(same.values()):
        raise AssertionError(f"{tag}: outputs differ from the host-only full scan: {same}")
    if launches <= 0:
        raise AssertionError(f"{tag}: the gate kernel was never launched")
    return out


def time_split(host_bf, draft_path: str, threads: int) -> dict:
    """The main path's stages one at a time, none overlapped: read the
    draft, upload the filter, the gate pass of every contig, the threaded
    repair from those gates, and rendering the outputs."""
    import io

    from ntedit_tpu_torch.engine import native_repair
    from ntedit_tpu_torch.engine.config import EngineConfig
    from ntedit_tpu_torch.engine.polish import Polisher
    from ntedit_tpu_torch.io import fastx, writers

    out = {}
    t0 = time.perf_counter()
    cfg = EngineConfig(k=host_bf.k, hash_num=host_bf.hash_num, threads=threads).validate()
    recs = [r for r in fastx.read_fastx(draft_path) if len(r.seq) >= cfg.min_contig_len]
    out["read_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    pol = Polisher(host_bf, None, cfg, device="cuda")
    out["filter_upload_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    hints = [pol.gate_positions(r.seq) for r in recs]
    out["gate_pass_s"] = time.perf_counter() - t0
    out["gates"] = int(sum(len(h) for h in hints))
    t0 = time.perf_counter()
    results = [native_repair.polish_contig_pipelined(
        host_bf, None, cfg, r.header, r.seq, [(len(r.seq) - cfg.k + 1, h)], threads=threads)
        for r, h in zip(recs, hints)]
    out["repair_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    sinks = [io.StringIO() for _ in range(3)]
    for res in results:
        writers.write_contig(res, *sinks, {})
    out["render_s"] = time.perf_counter() - t0
    out.update(device_share(pol, recs))
    return out


def device_share(pol, recs) -> dict:
    """Polisher.polish over the draft under torch.profiler: the device's
    busy time (kernels and copies) against the wall."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        n = len(list(pol.polish((r.header, r.seq) for r in recs)))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    busy_us = {}
    for ev in prof.key_averages():
        dt = getattr(ev, "self_device_time_total", getattr(ev, "self_cuda_time_total", 0))
        if dt > 0:
            busy_us[ev.key] = dt
    busy_s = sum(busy_us.values()) / 1e6
    return {"profiled_contigs": n, "profiled_wall_s": wall, "device_busy_s": busy_s,
            "device_idle_share": 1 - busy_s / wall if busy_us else None,
            "device_top": sorted(busy_us.items(), key=lambda kv: -kv[1])[:4]}


def phase_main(work: str) -> list:
    from ntedit_tpu_torch.core import bloom
    from ntedit_tpu_torch.engine.config import EngineConfig

    k = 25
    lengths = [30_000_000, 15_000_000, 5_000_000, 5_000, 60]  # GENOME + 5,060 bases
    t0 = time.perf_counter()
    truths, drafts = make_genome(lengths, seed=500)
    draft_path = os.path.join(work, "draft50.fa")
    write_fasta(draft_path, drafts)
    sim_s = time.perf_counter() - t0
    n_kmers = sum(lengths)
    t0 = time.perf_counter()
    blk = bloom.BlockedKmerBloomFilter.zeros(bloom.pow2_size_bytes(n_kmers, 3, 0.001), 3, k)
    for t in truths:
        blk.insert_seq(t)
    build_s = time.perf_counter() - t0
    cfg = EngineConfig(k=k, hash_num=3, threads=1).validate()
    out = [run_and_check("main_blocked", work, blk, draft_path, truths, ["-t", "8"], cfg)]
    out[0].update(simulate_s=sim_s, filter_build_s=build_s, filter_bytes=blk.bytes,
                  contigs=lengths, split=time_split(blk, draft_path, 8))
    del blk
    t0 = time.perf_counter()
    pl = bloom.KmerBloomFilter.zeros(bloom.bf_size_bytes(n_kmers, 3, 0.001), 3, k)
    for t in truths:
        pl.insert_seq(t)
    build_s = time.perf_counter() - t0
    out.append(run_and_check("main_plain", work, pl, draft_path, truths, ["-t", "8"], cfg))
    out[1].update(filter_build_s=build_s, filter_bytes=pl.bytes)
    return out


def phase_counting(work: str) -> dict:
    from ntedit_tpu_torch.core import bloom
    from ntedit_tpu_torch.engine.config import EngineConfig

    k = 25
    length = CBF_LENGTH
    truths, drafts = make_genome([length], seed=900)
    draft_path = os.path.join(work, "draft_cbf.fa")
    write_fasta(draft_path, drafts)
    # one counter per bit of the plain filter's size: the same 0.001 FPR
    cbf = bloom.KmerCountingBloomFilter8.zeros(8 * bloom.bf_size_bytes(length, 3, 0.001), 3, k)
    fill_counts(cbf, truths[0], 3)
    # the draft's first half once: its error k-mers count 1 there, so -p 2
    # gates them but the missing check (count > 0) leaves them; the second
    # half's errors are absent and get repaired
    fill_counts(cbf, drafts[0][: length // 2])
    cfg = EngineConfig(k=k, hash_num=3, threads=1, min_threshold=2, max_threshold=254).validate()
    return run_and_check("counting", work, cbf, draft_path, truths,
                         ["-t", "8", "-p", "2", "-q", "254"], cfg)


# ---------------------------------------------------------------------------
# phase 5: numbers
# ---------------------------------------------------------------------------

def probed_sectors(seq_dev, n: int, df, snv: bool) -> int:
    """Distinct 32-byte DRAM sectors the gate pass must read from the
    filter for these heads: the valid, unforced windows, each probe in the
    kernel's order (plain and counting stop at the first deciding probe)."""
    import torch

    from ntedit_tpu_torch.core import nthash as nt
    from ntedit_tpu_torch.ops import gate_kernel

    if snv:
        return 0
    s = seq_dev[: n + df.k - 1]
    valid, iupac = gate_kernel.window_flags(s, n, df.k)
    live = valid & ~iupac
    can = nt.canonical(*nt.window_hashes(s, df.k))
    if df.blocked:
        return int(torch.unique(((can & (df.modulus - 1)) >> 3)[live]).numel())
    sectors = []
    for h in nt.extend(can, df.k, df.hash_num):
        idx = nt.umod(h, df.modulus)
        if df.counting:
            sectors.append((idx >> 5)[live])  # every counter is read
            continue
        sectors.append((idx >> 8)[live])
        live = live & (((df.table[idx >> 5].long() & 0xFFFFFFFF) >> (idx & 31)) & 1 == 1)
    return int(torch.unique(torch.cat(sectors)).numel())


def time_cuda(fn, reps: int, flush) -> float:
    """Median ms of ``fn`` over ``reps`` launches, L2 flushed before each."""
    import torch

    fn()  # warm
    times = []
    for _ in range(reps):
        flush.zero_()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def phase_numbers(power: str) -> dict:
    """The gate pass at the main path's chunk shape (2^22 heads, k=25)
    with the filters of a 50 Mbp assembly (256 MiB blocked), for the
    blocked, plain and counting layouts."""
    import torch

    from ntedit_tpu_torch.core import bloom
    from ntedit_tpu_torch.engine import flag
    from ntedit_tpu_torch.ops import gate_kernel
    from ntedit_tpu_torch.utils import simulate

    dev = torch.device("cuda")
    k = 25
    n = flag.DEFAULT_CHUNK
    L = n + k - 1
    truth = simulate.random_genome(L + 1000, seed=31)  # indels change the length
    draft, _ = simulate.inject_errors(truth, seed=32)
    draft = decorate(draft[:L], np.random.default_rng(33), 2, 20, 2000)
    buf = torch.zeros(gate_kernel.padded_len(n), dtype=torch.uint8)
    buf[:L] = torch.from_numpy(draft.copy())
    seq_dev = buf.to(dev)
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)  # 5x the L2
    plain_bytes = bloom.bf_size_bytes(GENOME, 3, 0.001)
    filters = {
        "blocked": bloom.BlockedKmerBloomFilter.zeros(
            bloom.pow2_size_bytes(GENOME, 3, 0.001), 3, k),
        "plain": bloom.KmerBloomFilter.zeros(plain_bytes, 3, k),
        "counting": bloom.KmerCountingBloomFilter8.zeros(8 * plain_bytes, 3, k),
    }
    # this chunk's truth k-mers, plus random bits in an eighth of the
    # words (counters) for the occupancy of the rest of the genome
    rng = np.random.default_rng(34)
    rows = {}
    for name, hf in filters.items():
        if name == "counting":
            fill_counts(hf, truth, 3)
        else:
            hf.insert_seq(truth)
        arr = hf.words if name == "blocked" else (hf.data if name == "plain" else hf.counters)
        fill = rng.integers(0, arr.size, size=arr.size // 8)
        if name == "counting":
            arr[fill] = np.maximum(arr[fill], rng.integers(1, 4, size=fill.size).astype(np.uint8))
        else:
            arr[fill] |= (1 << rng.integers(0, 8 * arr.itemsize, size=fill.size)).astype(arr.dtype)
        df = bloom.DeviceFilter.from_host(hf, dev)
        p = 3 if name == "counting" else 1
        got = gate_kernel.gate_words(seq_dev, n, df, False, p)
        want = gate_kernel.gate_words_plain(seq_dev, n, df, False, p)
        diff = int((got != want).sum())
        err = int(((got.long() & 0xFFFFFFFF) - (want.long() & 0xFFFFFFFF)).abs().max())
        if diff or err:
            raise AssertionError(f"{name}: kernel differs from plain at the chunk shape")
        before = gate_kernel.gate_words.launches
        ms = time_cuda(lambda: gate_kernel.gate_words(seq_dev, n, df, False, p), 20, flush)
        gate_kernel.gate_words.launches = before  # timing launches are not the path's
        plain_ms = time_cuda(lambda: gate_kernel.gate_words_plain(seq_dev, n, df, False, p),
                             3, flush)
        sectors = probed_sectors(seq_dev, n, df, False)
        nbytes = L + 4 * (-(-n // 32)) + 32 * sectors
        table = df.table
        idx = torch.randint(0, table.numel(), (n,), device=dev)
        take_ms = time_cuda(lambda: torch.take(table, idx), 10, flush)
        rows[name] = {"heads": n, "ms": ms, "plain_ms": plain_ms, "take_ms": take_ms,
                      "sectors": sectors, "bytes": nbytes,
                      "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
                      "differing_words": diff, "max_abs_err": err,
                      "filter_bytes": hf.bytes}
        del df, table, idx
        torch.cuda.empty_cache()
    return {"phase": "numbers", "power_limit": power, "layouts": rows,
            "max_memory_allocated": torch.cuda.max_memory_allocated()}


# ---------------------------------------------------------------------------

def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is false)",
              file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    try:
        import ntedit_tpu_torch  # noqa: F401
    except ImportError as exc:
        print(f"chip_smoke: run from a checkout of the repository ({exc})", file=sys.stderr)
        return 2

    smi = nvidia_smi()
    print(smi, flush=True)
    power = smi.split(",")[-1].strip()
    t_start = time.perf_counter()
    emit(phase_build())
    kernel = phase_kernel()
    emit(kernel)
    main_rows = []
    with tempfile.TemporaryDirectory(prefix="ntedit_smoke_") as work:
        torch.cuda.reset_peak_memory_stats()
        for row in phase_main(work):
            row["max_memory_allocated"] = torch.cuda.max_memory_allocated()
            main_rows.append(row)
            emit(row)
        row = phase_counting(work)
        main_rows.append(row)
        emit(row)
    torch.cuda.reset_peak_memory_stats()
    numbers = phase_numbers(power)
    emit(numbers)
    blk = numbers["layouts"]["blocked"]
    differing = kernel["differing_words"] + sum(
        r["differing_words"] for r in numbers["layouts"].values())
    emit({"kernels": [{
        "name": "gate_words",
        "route": "cuda",
        "source": "ntedit_tpu_torch/csrc/gate_kernel.cu",
        "replaces": "ntedit_tpu/ops/flag_kernel.py:86",
        "launches": main_rows[0]["launches"],
        "matches_plain": differing == 0,
        "max_abs_err": blk["max_abs_err"],
        "ms": blk["ms"],
        "plain_ms": blk["plain_ms"],
        "bound_ms": blk["bound_ms"],
        "bound_by": "bytes",
        "library_ms": None,
        "take_ms": blk["take_ms"],
    }], "power_limit": power, "seconds": time.perf_counter() - t_start})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
