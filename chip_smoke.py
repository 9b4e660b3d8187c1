#!/usr/bin/env python3
"""Smoke run of the torch port (ntedit_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py            # every phase, as a user-sized run; no options

Phases, each printing one JSON line; any failure exits nonzero:

1. build    - builds the CUDA kernels (nvcc: the gate kernel, the SNV
              kernels, the filter-build kernels and the collectives'
              reduce), the host repair
              library and the batch reader (g++, zlib: its version) from
              the sources in this checkout, side by side.
   Then the kernels' registers, shared memory and spills (nvcc -Xptxas -v)
   and resident blocks per SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor).
2. kernel   - the gate kernel against its plain torch version on the card,
              bit for bit: blocked, plain (hash_num 3 and 4) and counting
              (-p 1 and 3) filters, k in {1, 17, 25, 33, 34, 40, 1025}, snv
              on and off, on a draft with N runs, IUPAC and lowercase bytes;
              ragged tails, n in {1, 31, 32, 33} and at a tile boundary +-1;
              and a plain filter of 8e9 bits (above 2^32, not 2^n).  On the
              same grid, blocked and plain filters: the SNV candidate kernel
              against its plain version, and the SNV site kernel (jump 1, 3
              and k) on those candidates plus heads at both contig ends, on
              both sides of a tile edge and before N and IUPAC bytes; with
              the blocked filter the binned candidate pass (its front end's
              bins, as multisets per range, and its probed words) with the
              filter in 1, 16 and 256 slices; the polish site-row kernel
              (jump 1, 3 and k) and the candidate-mask kernel on the gates
              of the same inputs plus those heads, the masks also on that
              list in reverse order.  Both site
              forms also on simulate.site_lists (every gate a cluster
              start, a cluster of 300, starts at list index 0 and 255-257,
              overlapping scans, h + 2k at n, n + 1 and past the contig) at
              k = 25 and 1025.
              On the same k and lengths, with 0x00 separators added: the
              filter-build kernels against their plain versions (the
              compacted hashes at sample slices 0, 1 and 3; the count's
              partition, bucket by bucket as multisets, and its apply,
              into tables of 4m + 1 to 4m + 3 bytes split into 1, 3 and 7
              slices, the last one partial, at hash_num 1 to 4; the solid
              bits and blocked and plain insertion at cutoffs 1, 2 and 255),
              and the count and hashes of a poly-A batch (every increment in
              one slot) and the hashes of a batch with no valid window.
3. main     - ``python -m ntedit_tpu_torch engine -t 8`` (in-process, the
              default pipelined engine), then the same with the polish site
              rows on (through the function the command line calls, which
              takes the switch), on a seeded 50 Mbp draft with a 256 MiB
              blocked filter, then with a btllib-sized plain filter; each
              run's three output files must equal, byte for byte, a
              host-only full sequential scan of the same C++ engine rendered
              by the same writers.  With the blocked filter also
              ``Polisher(engine="native")`` through the Python API, with
              the candidate masks on and off, each held the same way: on,
              one mask launch and one contig upload a contig, and every
              contig's gates and masks from one pass equal to the gate
              pass's, the gate stream's and the mask pass's; off, no mask
              launch.  Then the two polish kernels at the
              path's shapes (site rows on one 2^22-head chunk's gates, masks
              on the 30 Mbp contig's gates, the native engine's gates and
              masks in one pass, flag.contig_gates_and_masks, held to the
              gate pass and the mask pass) against their plain versions,
              their bytes bound, the probe floor and a torch.take yardstick.
4. counting - the same check with a count-min filter and -p 2 -q 254, in
              polish mode and with -s 1: the SNV path of the configurations
              the candidate kernel does not serve (the gate kernel with snv
              on, every valid head a hint for the whole-contig engine).
              Neither polish row nor mask kernel may run there.
5. snv      - ``engine -s 1 -t 8`` on a 50 Mbp reference with a 256 MiB
              blocked filter that holds a copy of it with substitutions
              (about 1 per kbp): one run with the device's site rows and one
              without, each byte-identical to the host-only full SNV scan;
              and one run with a plain filter on a 5 Mbp contig.  Then the
              SNV site kernel alone at the shape that path gives it, one
              launch on a whole contig's candidates (the 30 Mbp contig,
              blocked; the 5 Mbp contig, plain): against its plain version,
              its bytes bound, the probe floor and a torch.take yardstick.
              And the candidate pass at snv_blocked's shape: every contig's
              by the path (the binned pass on its dense groups) and by the
              candidate kernel a chunk at a time, the words held equal; the
              binned pass's two kernels on the 30 Mbp contig's first group
              against their plain versions, bounds and floors.
6. filter_build - the filter build on the card from 30x of 150 bp reads
              of a seeded 4.7 Mbp genome (940,000 reads, 1% substitutions,
              a few N bytes, two gzip FASTQ files under one prefix):
              ``polish --reads R -k 25 -t 8`` (histogram, count and insert
              kernels into a blocked filter, then the engine), its .hist
              held to the histogram of the plain hashes, its filter to a
              whole build by the plain versions on the card, its outputs to
              the host-only full scan; the
              reads read once by the batch reader (each file opened once,
              the pieces kept on the card: ``reads`` with ``read_s``, the
              kept bytes and the passes), and a build with budget 0 (each
              pass reads them again) byte-equal to the kept build and to
              the plain one; ``polish --reads R --cbf -p 2 -q 254`` (a
              counting filter of 374 M slots) held the same way;
              ``make-genome-bf`` on the 50 Mbp draft of phase 3 (a
              btllib-sized plain filter), its genome read once, held to the
              plain build; and ``snv --reference REF --genome SAMPLE`` on
              the 5 Mbp contig of phase 5, its outputs held to the host-only
              full SNV scan on the filter it built.
7. numbers  - the gate pass alone at the main path's chunk shape (CUDA
              events, L2 flushed between launches), its plain version, a
              torch.take gather of as many random words as a yardstick, the
              least time the card could take for the same bytes, and the
              random-probe floor: a probe-only kernel making as many random
              probes of the same table with the same loads in flight.  The
              same for the SNV candidate kernel (blocked and plain).  The
              filter-build kernels on phase 6's reads, in its 2^24-byte
              batches, at the tables polish --reads sized for them
              (build_numbers): the hashes kernel on one batch (the call,
              and its device work alone) and the histogram's pass; the
              count's partition, apply and both on one batch and the whole
              count pass; the solid bits, the insert on one batch and the
              whole insert pass; each with its plain version's ms, its bytes
              bound and its floor (the random-atomic floor in one slice and
              in the whole table; the probe floor on the solid bits and on
              the counters), the slice size and the scratch bytes.
8. engines  - (run after phase 2, before phase 3; its traced run is then
              the process's first profiler session) the engines beside
              the native repair, with a 256 MiB
              blocked filter and a plain filter at phase 3's sizes holding
              the truth: ``Polisher(engine="wavefront")`` on a seeded 4.7
              Mbp contig (a bacterial genome) in polish mode (the gate
              kernel's hint) and on a 500 kbp draft in SNV mode (the
              candidate kernels' heads; there it commits one site a
              round, its time growing with the square of the length);
              ``engine="sequential"`` through the command line's function
              and ``engine -v 1`` on a 500 kbp draft, the -v stdout equal to
              the trace the same Oracle prints over the hint of the gate
              kernel's plain version (and with the scalar site path, which
              prints every trial, through the API); the fallback after a
              failed native repair (the repair functions replaced by ones
              that return None) in polish and SNV mode; and
              ``NTEDIT_TPU_TRACE`` on two ``engine`` runs of the 4.7 Mbp
              contig in this process: each Chrome trace names the gate
              kernel and holds device events (trace() raises on one that
              holds none), and the device's busy share of each trace.  Every run's three files
              equal the host-only full scan's; each reports its wall and its
              gate and candidate launches.

9. mesh     - (run after phase 6, on its inputs and those of phases 3 and
              5) the collectives' reduce kernels (or_rows, sat_add_rows)
              against their plain versions bit for bit (D in {1, 2, 3, 4,
              8}, widths 1 to 70 elements, 16-, 4- and 1-byte vectors,
              counters at 0, 1, 128, 254, 255 and eight rows of 40), then
              timed at the shape the collective at D = 4 gives them (a 256
              MiB filter's words, a 512 MiB count table) against their
              bytes bound, their plain versions and a bitwise_or_ chain.  A
              world of one rank over NCCL (one untimed collective first,
              which makes NCCL's communicator): sharded_bf_build of phase
              6's 940,000 reads into a 2^31-bit plain filter and
              sharded_cbf_build into 2^29 counters, each equal to one
              kmer_insert / kmer_count over the same reads, each wall
              beside its kernels' summed device ms; sharded_polish
              over phase 3's draft (256 MiB blocked filter, with
              NTEDIT_TPU_CAND=1, and the plain filter) and over phase 5's
              reference with -s 1, each byte-identical to that phase's
              host-only scan, with the Polisher's wall beside.  Then
              ``engine -t 4`` as two processes sharing the card (records
              over gloo), the merged files byte-identical to phase 3's
              host-only scan; each rank's contigs, bases and wall.
Then a ``{"kernels": [...]}`` line (14 kernels: launches on the path,
equality with the plain version, ms alone against the bytes bound and the
floor) and, last, the device line ``{"ok": true, "device": {...}}``.
Without a CUDA device, or outside a checkout of the repository, it exits
nonzero and prints no result.  Every kernel's ms is the median of REPS
launches, CUDA events around each, the L2 flushed before each.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3, NVIDIA data sheet
REPS = 20  # timed launches of a kernel alone; its ms is their median
GENOME = 50_000_000  # bases of the main-path draft and of the timed filters
CBF_LENGTH = 4_700_000  # bases of the counting-filter contig


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

    import ctypes

    from ntedit_tpu_torch.engine import native_repair
    from ntedit_tpu_torch.io import native
    from ntedit_tpu_torch.ops import build_kernel, gate_kernel, mesh_kernel, snv_kernel

    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is false")

    def timed(fn):
        t0 = time.perf_counter()
        fn()
        return time.perf_counter() - t0

    with ThreadPoolExecutor(max_workers=6) as ex:  # four nvcc and two g++ side by side
        jobs = {"gate_kernel_s": ex.submit(timed, gate_kernel.load_library),
                "snv_kernel_s": ex.submit(timed, snv_kernel.load_library),
                "build_kernel_s": ex.submit(timed, build_kernel.load_library),
                "mesh_kernel_s": ex.submit(timed, mesh_kernel.load_library),
                "repair_s": ex.submit(timed, native_repair.get_lib),
                "reader_s": ex.submit(timed, native.get_lib)}
        times = {name: job.result() for name, job in jobs.items()}
    # the batch reader links zlib (a failed build raised with g++'s output)
    zlib_version = native.get_lib().zlibVersion
    zlib_version.restype = ctypes.c_char_p
    return {"phase": "build", **times, "reader_zlib": zlib_version().decode(),
            "device": torch.cuda.get_device_name(0)}


_FORMS = {"gate_words_kernelILi0E": "plain", "gate_words_kernelILi1E": "blocked",
          "gate_words_kernelILi2E": "counting", "probe_floor_kernelIjE": "floor_words",
          "probe_floor_kernelIhE": "floor_counters",
          "snv_cand_words_kernelILi0E": "cand_plain", "snv_cand_words_kernelILi1E": "cand_blocked",
          "snv_cand_bin_kernelILb0E": "cand_bin_count", "snv_cand_bin_kernelILb1E": "cand_bin_scatter",
          "snv_cand_probe_kernel": "cand_probe",
          "site_rows_kernelILi0EE": "site_plain", "site_rows_kernelILi1EE": "site_blocked",
          "polish_rows_kernelILi0EE": "polish_site_plain",
          "polish_rows_kernelILi1EE": "polish_site_blocked",
          "cand_masks_kernelILi0EE": "masks_plain", "cand_masks_kernelILi1EE": "masks_blocked",
          "kmer_valid_count_kernelILb0E": "kmer_valid_count",
          "kmer_valid_count_kernelILb1E": "kmer_valid_count_sampled",
          "kmer_valid_hashes_kernel": "kmer_valid_hashes",
          "kmer_partition_kernelILb0E": "kmer_partition_count",
          "kmer_partition_kernelILb1E": "kmer_partition_scatter",
          "kmer_count_apply_kernel": "kmer_count_apply", "kmer_solid_bits_kernel": "kmer_solid_bits",
          "kmer_insert_kernelILi0E": "kmer_insert_plain",
          "kmer_insert_kernelILi1E": "kmer_insert_blocked", "atomic_floor_kernel": "atomic_floor",
          "reduce_rows_kernelILi0E5uint4": "or_rows_16", "reduce_rows_kernelILi0EjE": "or_rows_4",
          "reduce_rows_kernelILi0EhE": "or_rows_1",
          "reduce_rows_kernelILi1E5uint4": "sat_add_rows_16",
          "reduce_rows_kernelILi1EjE": "sat_add_rows_4",
          "reduce_rows_kernelILi1EhE": "sat_add_rows_1"}


def ptxas_resources(log: str) -> dict:
    """Registers, shared memory, stack and spills per kernel form from
    nvcc's ``-Xptxas -v`` output."""
    out: dict = {}
    cur = None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            cur = out.setdefault(next((v for k, v in _FORMS.items() if k in m.group(1)),
                                      m.group(1)), {})
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            cur.update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                       spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur["registers"] = int(m.group(1))
        m = re.search(r"(\d+) bytes smem", line)
        if m:
            cur["smem_bytes"] = int(m.group(1))
    return out


def phase_resources() -> dict:
    import torch

    from ntedit_tpu_torch.ops import build_kernel, gate_kernel, mesh_kernel, snv_kernel

    res = {}
    for mod in (gate_kernel, snv_kernel, build_kernel, mesh_kernel):
        res.update(ptxas_resources(mod.build_log()))
    for form, blocks in {**gate_kernel.occupancy(), **snv_kernel.occupancy(),
                         **build_kernel.occupancy(), **mesh_kernel.occupancy()}.items():
        res.setdefault(form, {})["blocks_per_sm"] = blocks
    if any(r.get("blocks_per_sm", 0) <= 0 for r in res.values()):
        raise RuntimeError(f"a kernel form cannot be resident: {res}")
    spills = any(r.get("spill_stores") or r.get("spill_loads") for r in res.values())
    return {"phase": "kernel_resources", "forms": res, "spills": spills,
            "sms": torch.cuda.get_device_properties(0).multi_processor_count,
            "threads_per_block": gate_kernel.TILE // 32}


# ---------------------------------------------------------------------------
# phase 2: kernel against plain version
# ---------------------------------------------------------------------------

def _filters_for(truth: np.ndarray, k: int, device):
    """(name, DeviceFilter, min_threshold) cases for one k."""
    from ntedit_tpu_torch.core import bloom
    from ntedit_tpu_torch.utils import simulate

    out = []
    blk = bloom.BlockedKmerBloomFilter.zeros(1 << 16, 3, k)
    blk.insert_seq(truth)
    out.append(("blocked", blk, 1))
    for h in (3, 4):
        pl = bloom.KmerBloomFilter.zeros(50_021 + h, h, k)  # not a power of two
        pl.insert_seq(truth)
        out.append((f"plain_h{h}", pl, 1))
    cbf = bloom.KmerCountingBloomFilter8.zeros(300_007, 3, k)
    simulate.fill_counts(cbf, truth[: len(truth) // 2], 2)
    simulate.fill_counts(cbf, truth)
    for p in (1, 3):
        out.append((f"counting_p{p}", cbf, p))
    return [(name, bloom.DeviceFilter.from_host(f, device), p) for name, f, p in out]


def check_kernel(seq_dev, n, df, snv, p) -> int:
    """Kernel words vs plain words on one input; returns the number of
    differing words (0 when bit-equal)."""
    from ntedit_tpu_torch.ops import gate_kernel

    got = gate_kernel.gate_words(seq_dev, n, df, snv, p)
    want = gate_kernel.gate_words_plain(seq_dev, n, df, snv, p)
    return int((got != want).sum())  # .sum() to the host synchronises


def _kernel_lengths(k: int, full: int) -> list:
    """Window-stream lengths L (n = L - k + 1 heads) checked at one k: the
    whole draft, a ragged tail past one tile, a short contig and, at
    k = 25 and 34, n = 1, 31, 32, 33 and n at a tile boundary +-1."""
    from ntedit_tpu_torch.ops import gate_kernel

    out = [full, gate_kernel.TILE + k - 1 + 77, k + 30]
    if k in (25, 34):
        t = gate_kernel.TILE
        out += [n + k - 1 for n in (1, 31, 32, 33, t - 1, t, t + 1)]
    return out


def site_heads(words, draft: np.ndarray, n: int, k: int):
    """Sorted heads to ask site rows for: the candidates in ``words`` plus
    heads at both contig ends (0, n-k-1 the last valid row, n-k, n-1), on
    both sides of a tile edge, and 2k, 2k-1, k and 1 bytes before, and at,
    the first N and IUPAC bytes."""
    import torch

    from ntedit_tpu_torch.engine import flag
    from ntedit_tpu_torch.ops import gate_kernel

    t = gate_kernel.TILE
    extra = [0, n - k - 1, n - k, n - 1, t - 1, t]
    for e in np.flatnonzero(~np.isin(draft & 0xDF, np.frombuffer(b"ACGT", np.uint8)))[:6]:
        extra += [int(e) - 2 * k, int(e) - 2 * k + 1, int(e) - k, int(e) - 1, int(e)]
    extra = torch.tensor([h for h in extra if 0 <= h < n], dtype=torch.int64, device=words.device)
    return torch.unique(torch.cat([flag.positions_on_device(words), extra]))


INDEX_LIST_KS = (25, 1025)  # the k at which the kernel phase runs simulate.site_lists
MIDDLE_LISTS = ("block_edges", "all_starts", "long_cluster", "overlapping")


def index_lists(n: int, k: int, dev) -> list:
    """simulate.site_lists on the card in two lists, where the contig holds
    them: the middle ones one after another, each on a stretch of its own
    (so each keeps its cluster starts; ``block_edges`` first, at list index
    0), then ``ends_at``; and ``ends_past``."""
    import torch

    from ntedit_tpu_torch.utils import simulate

    span = simulate.SITE_LIST_SPAN + 2 * k
    if n < (len(MIDDLE_LISTS) + 2) * span:
        return []
    lists = [simulate.site_lists(n, k, span * (1 + i))[name] for i, name in enumerate(MIDDLE_LISTS)]
    ends = simulate.site_lists(n, k, 0)
    return [torch.from_numpy(h).to(dev)
            for h in (np.concatenate([*lists, ends["ends_at"]]), ends["ends_past"])]


def check_binned(seq_dev, n: int, df, want) -> tuple:
    """The binned candidate pass against its plain versions and the
    candidate words ``want``, with the filter in 1, 16 and 256 slices:
    (cases, differences: count matrix, scan, each (slice, column) range as
    a multiset, the forced words and the probed words)."""
    import torch

    from ntedit_tpu_torch.ops import snv_kernel

    diff = 0
    for bits in (None, 10, 0):
        got, plain = (snv_kernel.CandBins(df.modulus, n, seq_dev.device, bits) for _ in range(2))
        words = torch.full((-(-n // 32),), -1, dtype=torch.int32, device=seq_dev.device)
        plain_words = words.clone()
        snv_kernel.snv_cand_bin(seq_dev, n, df, got, words)
        snv_kernel.snv_cand_bin_plain(seq_dev, n, df, plain, plain_words)
        cells = got.cells()
        diff += int((got.counts[:cells] != plain.counts[:cells]).sum())
        diff += int((got.ends[:cells] != plain.ends[:cells]).sum())
        if not diff:
            diff += sum(int((a != b).sum()) for a, b in zip(snv_kernel.bin_multiset(got),
                                                            snv_kernel.bin_multiset(plain)))
        diff += int((words != plain_words).sum())
        snv_kernel.snv_cand_probe(got, df, words)
        snv_kernel.snv_cand_probe_plain(plain, df, plain_words)
        diff += int((words != plain_words).sum()) + int((words != want).sum())
    return 3, diff


def check_snv_kernels(seq_dev, draft: np.ndarray, n: int, df, jumps, more=()) -> tuple:
    """The SNV kernels vs their plain versions on one input, the site rows
    also on the head lists ``more``: (differing candidate words, site
    cases, differing site rows, binned cases, binned differences)."""
    from ntedit_tpu_torch.ops import snv_kernel

    got = snv_kernel.snv_cand_words(seq_dev, n, df)
    want = snv_kernel.snv_cand_words_plain(seq_dev, n, df)
    words = int((got != want).sum())
    bin_cases, bin_diff = check_binned(seq_dev, n, df, want) if df.blocked else (0, 0)
    lists = [site_heads(want, draft, n, df.k), *more]
    rows = 0
    for jump in jumps:
        for cand in lists:
            got = snv_kernel.snv_site_rows(seq_dev, n, cand, df, jump)
            want = snv_kernel.snv_site_rows_plain(seq_dev, n, cand, df, jump)
            rows += int((got != want).any(1).sum())
    return words, len(jumps) * len(lists), rows, bin_cases, bin_diff


def check_polish_kernels(seq_dev, draft: np.ndarray, n: int, df, jumps, more=()) -> tuple:
    """The polish site-row and candidate-mask kernels vs their plain
    versions on one input, on the contig's gates (cluster starts, later
    gates and IUPAC-forced ones) plus the heads of ``site_heads``, the rows
    also on the head lists ``more``, the masks also on the list in reverse
    order: (row cases, differing rows, mask cases, differing masks)."""
    from ntedit_tpu_torch.ops import gate_kernel, snv_kernel

    gates = site_heads(gate_kernel.gate_words_plain(seq_dev, n, df), draft, n, df.k)
    lists = [gates, *more]
    rows = 0
    for jump in jumps:
        for heads in lists:
            got = snv_kernel.polish_site_rows(seq_dev, n, heads, df, jump)
            want = snv_kernel.polish_site_rows_plain(seq_dev, n, heads, df, jump)
            rows += int((got != want).any(1).sum())
    masks = 0
    for heads in (gates, gates.flip(0)):
        got = snv_kernel.polish_cand_masks(seq_dev, n, heads, df)
        masks += int((got != snv_kernel.polish_cand_masks_plain(seq_dev, n, heads, df, True)).sum())
    return len(jumps) * len(lists), rows, 2, masks


BUILD_SLICE_BITS = 13  # slices of 8192 counters: the kernel phase's tables split 1, 3 and 7 ways


def _bucket_multisets(bins) -> list:
    """Each (slice, column) range of the bins' entries, sorted."""
    import torch

    cells = bins.cells()
    ends, counts = bins.ends[:cells].tolist(), bins.counts[:cells].tolist()
    entries = bins.entries.long() & 0xFFFFFFFF
    return [torch.sort(entries[e - c : e]).values for e, c in zip(ends, counts)]


def check_count(seq_dev, n: int, k: int, hash_num: int, slots: int) -> int:
    """The count's partition (count matrix, scan and each range's entries as
    a multiset) and apply against their plain versions, and the counters
    against the one-step plain count; returns the number of differences."""
    import torch

    from ntedit_tpu_torch.ops import build_kernel as bk

    dev = seq_dev.device
    bins = bk.Bins(slots, hash_num, n, dev, BUILD_SLICE_BITS)
    plain = bk.Bins(slots, hash_num, n, dev, BUILD_SLICE_BITS)
    bk.kmer_partition(seq_dev, n, k, bins)
    bk.kmer_partition_plain(seq_dev, n, k, plain)
    cells = bins.cells()
    diff = int((bins.counts[:cells] != plain.counts[:cells]).sum())
    diff += int((bins.ends[:cells] != plain.ends[:cells]).sum())
    if not diff:
        diff += sum(not torch.equal(a, b)
                    for a, b in zip(_bucket_multisets(bins), _bucket_multisets(plain)))
    counters = torch.zeros(-(-slots // 4) * 4, dtype=torch.uint8, device=dev)
    applied = counters.clone()
    want = counters.clone()
    bk.kmer_count_apply(bins, counters)
    bk.kmer_count_apply_plain(plain, applied)
    bk.kmer_count_plain(seq_dev, n, k, hash_num, want, slots)
    return diff + int((counters != applied).sum()) + int((counters != want).sum())


def check_build_kernels(seq_dev, n: int, k: int, case: int) -> int:
    """The filter-build kernels vs their plain versions on one input: the
    hashes (sample slices 0, 1 and 3); the count (partition and apply) at hash_num 1 + case % 4 into
    a table of 4m + 1 + case % 3 bytes split into 1, 3 or 7 slices of 8192
    counters (by case), the last one partial; the solid bits at cutoffs 1,
    2 and 255 over those counts, and blocked and plain (not 2^n bits)
    insertion over them (cutoff 1: no bits) against the count-min
    reference.  Returns the number of differing elements."""
    import torch

    from ntedit_tpu_torch.ops import build_kernel as bk

    dev = seq_dev.device
    diff = 0
    for s in (0, 1, 3):
        got, valid = bk.kmer_valid_hashes(seq_dev, n, k, s)
        want, want_valid = bk.kmer_valid_hashes_plain(seq_dev, n, k, s)
        diff += int(got.numel() != want.numel() or valid != want_valid)
        diff += 0 if got.numel() != want.numel() else int((got != want).sum())
    hash_num = 1 + case % 4
    ways = (1, 3, 7)[case % 3]
    slots = (ways - 1) * (1 << BUILD_SLICE_BITS) + 4 * 1000 + 1 + case % 3
    diff += check_count(seq_dev, n, k, hash_num, slots)
    counters = torch.zeros(-(-slots // 4) * 4, dtype=torch.uint8, device=dev)
    bk.kmer_count_plain(seq_dev, n, k, hash_num, counters, slots)
    for cutoff in (1, 2, 255):
        solid = bk.kmer_solid_bits(counters, slots, cutoff)
        diff += int((solid != bk.kmer_solid_bits_plain(counters, slots, cutoff)).sum())
        for layout, modulus in (("blocked", 1 << 12), ("plain", 8 * 16_411)):
            nw = modulus if layout == "blocked" else -(-modulus // 32)
            words = torch.zeros(nw, dtype=torch.int32, device=dev)
            plain_words = words.clone()
            bk.kmer_insert(seq_dev, n, k, hash_num, words, layout, modulus,
                           solid if cutoff > 1 else None, slots)
            bk.kmer_insert_plain(seq_dev, n, k, hash_num, plain_words, layout, modulus, counters,
                                 slots, cutoff)
            diff += int((words != plain_words).sum())
    return diff


def check_poly_a(dev) -> int:
    """The count of a poly-A batch (every window one k-mer: at hash_num 1
    every increment in one slot of one bucket) against the plain count;
    the hashes of that batch and of one of separators only (no valid
    window), against their plain versions."""
    import torch

    from ntedit_tpu_torch.ops import build_kernel as bk
    from ntedit_tpu_torch.ops import gate_kernel

    k = 25
    n = 1 << 20
    buf = torch.zeros(gate_kernel.padded_len(n), dtype=torch.uint8)
    empty = buf.to(dev)
    buf[: n + k - 1] = ord("A")
    seq = buf.to(dev)
    diff = sum(check_count(seq, n, k, h, 7 * (1 << BUILD_SLICE_BITS) - 3) for h in (1, 3))
    for batch in (seq, empty):
        got, valid = bk.kmer_valid_hashes(batch, n, k)
        want, want_valid = bk.kmer_valid_hashes_plain(batch, n, k)
        diff += int(valid != want_valid) + int(not torch.equal(got, want))
    return diff


def phase_kernel() -> dict:
    import torch

    from ntedit_tpu_torch.core import bloom
    from ntedit_tpu_torch.ops import gate_kernel
    from ntedit_tpu_torch.utils import simulate

    dev = torch.device("cuda")
    rng = np.random.default_rng(7)
    truth = simulate.random_genome(40_000, seed=70)
    draft, _ = simulate.inject_errors(truth, sub_rate=3e-3, seed=71)
    draft = simulate.decorate(draft, rng, n_runs=4, n_iupac=40, lower=700)
    # the last head's tail bears an alternate: a stretch of the truth, its last base changed
    draft[-60:] = truth[1000:1060]
    draft[-1] = b"ACGT"[(b"ACGT".index(int(truth[1059])) + 1) % 4]
    # the filter build reads separator-joined records: add 0x00 bytes
    build_draft = draft.copy()
    build_draft[rng.integers(0, len(draft), size=40)] = 0
    count = {"cases": 0, "differing_words": 0, "cand_cases": 0, "cand_differing_words": 0,
             "site_cases": 0, "site_differing_rows": 0, "polish_site_cases": 0,
             "polish_site_differing_rows": 0, "mask_cases": 0, "mask_differing": 0,
             "bin_cases": 0, "bin_differing": 0, "build_cases": 0, "build_differing": 0}
    bad = []

    def check_all(k, filters, lengths):
        # the site kernel's plain version loops over strides x k: jump 1 only at small k
        jumps = sorted({1, 3, k}) if k <= 40 else [k]
        for name, df, p in filters:
            for L in lengths:
                n = L - k + 1
                buf = torch.zeros(gate_kernel.padded_len(n), dtype=torch.uint8)
                buf[:L] = torch.from_numpy(draft[:L].copy())
                seq_dev = buf.to(dev)
                for snv in (False, True):
                    diff = check_kernel(seq_dev, n, df, snv, p)
                    count["cases"] += 1
                    count["differing_words"] += diff
                    if diff:
                        bad.append({"k": k, "filter": name, "L": L, "snv": snv, "words": diff})
                if df.counting or p != 1:
                    continue
                # simulate.site_lists on the whole draft at two k
                more = index_lists(n, k, dev) if k in INDEX_LIST_KS and L == lengths[0] else []
                words, site_cases, rows, bin_cases, bins = check_snv_kernels(
                    seq_dev, draft[:L], n, df, jumps, more)
                count["cand_cases"] += 1
                count["cand_differing_words"] += words
                count["site_cases"] += site_cases
                count["site_differing_rows"] += rows
                count["bin_cases"] += bin_cases
                count["bin_differing"] += bins
                if words or rows or bins:
                    bad.append({"k": k, "filter": name, "L": L, "cand_words": words,
                                "site_rows": rows, "binned": bins})
                cases, rows, mask_cases, masks = check_polish_kernels(seq_dev, draft[:L], n, df,
                                                                      jumps, more)
                count["polish_site_cases"] += cases
                count["polish_site_differing_rows"] += rows
                count["mask_cases"] += mask_cases
                count["mask_differing"] += masks
                if rows or masks:
                    bad.append({"k": k, "filter": name, "L": L, "polish_rows": rows,
                                "masks": masks})

    def check_build(k, lengths):
        for L in lengths:
            n = L - k + 1
            buf = torch.zeros(gate_kernel.padded_len(n), dtype=torch.uint8)
            buf[:L] = torch.from_numpy(build_draft[:L].copy())
            diff = check_build_kernels(buf.to(dev), n, k, count["build_cases"])
            count["build_cases"] += 1
            count["build_differing"] += diff
            if diff:
                bad.append({"k": k, "L": L, "build_differing": diff})

    # k = 1; 33 and 34 cross the 33-bit half of srol; the largest k taken
    for k in (1, 17, 25, 33, 34, 40, gate_kernel.MAX_K):
        check_all(k, _filters_for(truth, k, dev), _kernel_lengths(k, len(draft)))
        check_build(k, _kernel_lengths(k, len(draft)))
    # a plain filter above 2^32 bits, not a power of two: about half of
    # its indices need the modulo's upper 32 bits
    big = bloom.KmerBloomFilter.zeros(1_000_000_004, 3, 25)
    big.insert_seq(truth)
    big_df = bloom.DeviceFilter.from_host(big, dev)
    del big
    check_all(25, [("plain_8e9_bits", big_df, 1)], [len(draft)])
    del big_df
    diff = check_poly_a(dev)
    count["build_cases"] += 4
    count["build_differing"] += diff
    if diff:
        bad.append({"poly_a_build_differing": diff})
    torch.cuda.empty_cache()
    if bad:
        raise AssertionError(f"a kernel differs from its plain version: {bad}")
    return {"phase": "kernel", **count}


# ---------------------------------------------------------------------------
# phases 3 and 4: the main path against the host-only full scan
# ---------------------------------------------------------------------------

def reference_outputs(host_bf, draft_path: str, prefix: str, cfg, threads: int = 1) -> None:
    """The host-only full sequential scan of the port's C++ engine (no
    gate hint, one thread per contig, ``threads`` contigs at a time: ctypes
    releases the GIL), rendered by the CLI's writers."""
    from ntedit_tpu_torch.engine import native_repair
    from ntedit_tpu_torch.io import fastx, writers

    counting = hasattr(host_bf, "counters")
    recs = [r for r in fastx.read_fastx(draft_path) if len(r.seq) >= cfg.min_contig_len]
    with ThreadPoolExecutor(max_workers=threads) as ex:
        results = list(ex.map(lambda r: native_repair.polish_contig_native(
            host_bf, None, cfg, r.header, r.seq), recs))
    with open(prefix + "_edited.fa", "w") as dfout, \
         open(prefix + "_changes.tsv", "w") as rfout, \
         open(prefix + "_variants.vcf", "w") as vfout:
        rfout.write(writers.changes_tsv_header(cfg.k, cfg.jump, counting))
        vfout.write(writers.vcf_header(draft_path))
        for rec, res in zip(recs, results):
            if res is None:
                raise RuntimeError(f"host engine failed on {rec.header}")
            writers.write_contig(res, dfout, rfout, vfout, {}, snv=cfg.snv)


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


def run_and_check(tag: str, work: str, host_bf, draft_path: str, truths, cfg,
                  cli_args=(), also=None) -> dict:
    """Run the port's engine CLI and the host-only reference; compare.
    ``also`` maps a name to keywords of the function the command line calls
    (cli._run_engine, which also takes the switches it has no flag for):
    each such run follows, is held to the same reference on all three
    files, and reports under its name.  The launch counts are set to 0 just
    before each run and read just after."""
    from ntedit_tpu_torch import cli
    from ntedit_tpu_torch.core import bloom
    from ntedit_tpu_torch.io import fastx

    bf_path = os.path.join(work, f"{tag}.bf")
    t0 = time.perf_counter()
    host_bf.save(bf_path)
    save_s = time.perf_counter() - t0
    prefix = os.path.join(work, tag)
    reset_launches()
    t0 = time.perf_counter()
    cli.main(["engine", "-r", bf_path, "-f", draft_path, "-b", prefix, "--device", "cuda",
              *cli_args])
    wall = time.perf_counter() - t0
    launches = kernel_launches()
    with open(prefix + "_changes.tsv") as f:
        records = sum(1 for _ in f) - 1
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
           "launches": launches["gate_words"], "site_row_launches": launches["polish_site_rows"],
           "mask_launches": launches["polish_cand_masks"], "records": records,
           "reference_full_scan_s": ref_s, "filter_save_s": save_s,
           "byte_identical": same, "residual_vs_truth": resid}
    if not all(same.values()):
        raise AssertionError(f"{tag}: outputs differ from the host-only full scan: {same}")
    if launches["gate_words"] <= 0:
        raise AssertionError(f"{tag}: the gate kernel was never launched")
    for name, kw in (also or {}).items():
        other = f"{prefix}_{name}"
        reset_launches()
        t0 = time.perf_counter()
        cli._run_engine(bf_path, draft_path, other, device="cuda", **kw)
        wall = time.perf_counter() - t0
        launches = kernel_launches()
        same = _same_outputs(other, ref_prefix)
        out[name] = {"engine_kw": kw, "wall_s": wall, "bp_per_s": bases / wall,
                     "launches": launches["gate_words"],
                     "site_row_launches": launches["polish_site_rows"],
                     "mask_launches": launches["polish_cand_masks"], "byte_identical": same}
        if not all(same.values()):
            raise AssertionError(f"{tag} {name}: outputs differ from the host-only full scan: "
                                 f"{same}")
        if launches["gate_words"] <= 0:
            raise AssertionError(f"{tag} {name}: the gate kernel was never launched")
    return out


def run_native(tag: str, work: str, host_bf, draft_path: str, ref_prefix: str,
               threads: int, cand_masks: bool) -> dict:
    """``Polisher(engine="native", cand_masks=cand_masks)`` through the
    Python API (the command line has no engine switch) over the draft,
    rendered by the command line's writers and held to the host-only full
    scan at ``ref_prefix``.  The launch and contig-upload counts are set to
    0 just before the run and read just after.  Masks on: one mask launch
    and one upload a contig (flag.contig_gates_and_masks), whose gates and
    masks then equal, for every contig at the engine's chunk, the gate
    pass's, the gate stream's and the mask pass's from those gates.  Masks
    off: the gate pass and the segmented repair, and no mask launch."""
    from ntedit_tpu_torch.engine import flag
    from ntedit_tpu_torch.engine.config import EngineConfig
    from ntedit_tpu_torch.engine.polish import Polisher
    from ntedit_tpu_torch.io import fastx, writers

    prefix = os.path.join(work, tag)
    reset_launches()
    flag.uploads = 0
    t0 = time.perf_counter()
    cfg = EngineConfig(k=host_bf.k, hash_num=host_bf.hash_num, threads=threads).validate()
    pol = Polisher(host_bf, None, cfg, device="cuda", engine="native", cand_masks=cand_masks)
    records = contigs = 0
    with open(prefix + "_edited.fa", "w") as dfout, \
         open(prefix + "_changes.tsv", "w") as rfout, \
         open(prefix + "_variants.vcf", "w") as vfout:
        rfout.write(writers.changes_tsv_header(cfg.k, cfg.jump, False))
        vfout.write(writers.vcf_header(draft_path))
        for res in pol.polish((r.header, r.seq) for r in fastx.read_fastx(draft_path)):
            writers.write_contig(res, dfout, rfout, vfout, {})
            records += len(res.subs)
            contigs += 1
    wall = time.perf_counter() - t0
    launches = kernel_launches()
    uploads = flag.uploads
    same = _same_outputs(prefix, ref_prefix)
    out = {"engine": "native", "cand_masks": cand_masks, "wall_s": wall, "records": records,
           "contigs": contigs, "contig_uploads": uploads,
           "launches": launches["gate_words"], "mask_launches": launches["polish_cand_masks"],
           "site_row_launches": launches["polish_site_rows"], "byte_identical": same}
    if not all(same.values()):
        raise AssertionError(f"{tag}: outputs differ from the host-only full scan: {same}")
    if launches["gate_words"] <= 0:
        raise AssertionError(f"{tag}: the gate kernel was never launched")
    if not cand_masks:
        if out["mask_launches"]:
            raise AssertionError(f"{tag}: the mask kernel ran with the masks off: {out}")
        return out
    if out["mask_launches"] != contigs or uploads != contigs:
        raise AssertionError(f"{tag}: not one mask launch and one upload a contig: {out}")
    for r in fastx.read_fastx(draft_path):
        if len(r.seq) < cfg.min_contig_len:
            continue
        gates, masks = flag.contig_gates_and_masks(r.seq, pol.df, chunk=pol.chunk)
        hints = pol.gate_positions(r.seq)
        stream = [g for _, g, _ in flag.iter_polish_site_chunks(r.seq, pol.df, cfg.jump)]
        if not (np.array_equal(gates, hints) and np.array_equal(gates, np.concatenate(stream))
                and np.array_equal(masks, flag.polish_candidate_masks(r.seq, pol.df, hints))):
            raise AssertionError(f"{tag} {r.header}: flag.contig_gates_and_masks differs from "
                                 f"the gate pass, the gate stream or the mask pass")
    return out


# the mask kernel's own keys in the kernels line
MASK_KEYS = ("probes", "probes_per_informative_gate", "informative", "loads_in_flight")


def phase_main(work: str) -> list:
    from ntedit_tpu_torch.core import bloom
    from ntedit_tpu_torch.engine.config import EngineConfig
    from ntedit_tpu_torch.utils import simulate

    k = 25
    lengths = [30_000_000, 15_000_000, 5_000_000, 5_000, 60]  # GENOME + 5,060 bases
    t0 = time.perf_counter()
    truths, drafts = simulate.polish_genome(lengths, seed=500)
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
    # the default path (the command line, -t 8), then the same with polish
    # site rows on (off by default: the command line has no flag)
    args = ["-t", "8"]
    rows_on = {"site_rows": dict(threads=8, site_rows=True)}
    out = [run_and_check("main_blocked", work, blk, draft_path, truths, cfg, args, rows_on)]
    out[0].update(simulate_s=sim_s, filter_build_s=build_s, filter_bytes=blk.bytes,
                  contigs=lengths)
    for on, name in ((True, "native"), (False, "native_masks_off")):
        out[0][name] = run_native(f"main_{name}", work, blk, draft_path,
                                  os.path.join(work, "main_blocked_ref"), 8, on)
    out[0]["polish_kernels"] = polish_kernel_numbers(drafts[0], blk, cfg.jump)
    del blk
    t0 = time.perf_counter()
    pl = bloom.KmerBloomFilter.zeros(bloom.bf_size_bytes(n_kmers, 3, 0.001), 3, k)
    for t in truths:
        pl.insert_seq(t)
    build_s = time.perf_counter() - t0
    out.append(run_and_check("main_plain", work, pl, draft_path, truths, cfg, args, rows_on))
    out[1].update(filter_build_s=build_s, filter_bytes=pl.bytes,
                  polish_kernels=polish_kernel_numbers(drafts[0], pl, cfg.jump))
    for row in out:
        if row["site_row_launches"] or row["mask_launches"]:
            raise AssertionError(f"{row['phase']}: a polish row or mask kernel ran by default")
        if row["site_rows"]["site_row_launches"] <= 0:
            raise AssertionError(f"{row['phase']}: the polish site-row kernel was never launched")
    return out


def phase_counting(work: str) -> list:
    from ntedit_tpu_torch.core import bloom
    from ntedit_tpu_torch.engine.config import EngineConfig
    from ntedit_tpu_torch.utils import simulate

    k = 25
    length = CBF_LENGTH
    truths, drafts = simulate.polish_genome([length], seed=900)
    draft_path = os.path.join(work, "draft_cbf.fa")
    write_fasta(draft_path, drafts)
    # one counter per bit of the plain filter's size: the same 0.001 FPR
    cbf = bloom.KmerCountingBloomFilter8.zeros(8 * bloom.bf_size_bytes(length, 3, 0.001), 3, k)
    simulate.fill_counts(cbf, truths[0], 3)
    # the draft's first half once: its error k-mers count 1 there, so -p 2
    # gates them but the missing check (count > 0) leaves them; the second
    # half's errors are absent and get repaired
    simulate.fill_counts(cbf, drafts[0][: length // 2])
    cfg = EngineConfig(k=k, hash_num=3, threads=1, min_threshold=2, max_threshold=254).validate()
    args = ["-t", "8", "-p", "2", "-q", "254"]
    out = [run_and_check("counting", work, cbf, draft_path, truths, cfg, args)]
    # SNV mode with a filter the candidate kernel does not take: the gate
    # kernel with snv on hints every valid head to the whole-contig engine
    snv_cfg = dataclasses.replace(cfg, snv=True).validate()
    out.append(run_and_check("counting_snv", work, cbf, draft_path, truths, snv_cfg,
                             args + ["-s", "1"]))
    if out[1]["records"] <= 0:
        raise AssertionError("counting_snv: no SNV record")
    for row in out:  # neither polish pass serves a counting filter
        if row["site_row_launches"] or row["mask_launches"]:
            raise AssertionError(f"{row['phase']}: a polish row or mask kernel ran: {row}")
    return out


# ---------------------------------------------------------------------------
# phase 5: SNV mode
# ---------------------------------------------------------------------------

def run_snv_engine(tag: str, work: str, bf_path: str, draft_path: str, site_rows: bool) -> dict:
    """``engine -s 1 -t 8``: through the command line with the device's
    site rows (its default), or through the function the command line calls
    with the rows off, for which it has no flag.  The launch counts are set
    to 0 just before and read just after."""
    from ntedit_tpu_torch import cli
    from ntedit_tpu_torch.ops import snv_kernel

    prefix = os.path.join(work, tag)
    counted = (snv_kernel.snv_cand_words, snv_kernel.snv_cand_bin, snv_kernel.snv_cand_probe,
               snv_kernel.snv_site_rows)
    for fn in counted:
        fn.launches = 0
    t0 = time.perf_counter()
    if site_rows:
        cli.main(["engine", "-r", bf_path, "-f", draft_path, "-b", prefix, "--device", "cuda",
                  "-s", "1", "-t", "8"])
    else:
        cli._run_engine(bf_path, draft_path, prefix, s=1, threads=8, device="cuda",
                        site_rows=False)
    wall = time.perf_counter() - t0
    with open(prefix + "_changes.tsv") as f:
        records = sum(1 for _ in f) - 1
    return {"prefix": prefix, "site_rows": site_rows, "wall_s": wall, "records": records,
            "cand_launches": snv_kernel.snv_cand_words.launches,
            "bin_launches": snv_kernel.snv_cand_bin.launches,
            "probe_launches": snv_kernel.snv_cand_probe.launches,
            "site_launches": snv_kernel.snv_site_rows.launches}


def phase_snv(work: str) -> list:
    import torch

    from ntedit_tpu_torch.core import bloom
    from ntedit_tpu_torch.engine.config import EngineConfig
    from ntedit_tpu_torch.utils import simulate

    def site_kernel(host_bf, seq):
        return snv_site_numbers(seq, bloom.DeviceFilter.from_host(host_bf, torch.device("cuda")),
                                cfg.jump, flush_buffer())

    k = 25
    lengths = [30_000_000, 15_000_000, 5_000_000, 5_000, 60]  # main_blocked's
    t0 = time.perf_counter()
    refs, variants, planted = simulate.snv_genome(lengths, seed=700)
    draft_path = os.path.join(work, "ref50.fa")
    write_fasta(draft_path, refs)
    sim_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    blk = bloom.BlockedKmerBloomFilter.zeros(bloom.pow2_size_bytes(sum(lengths), 3, 0.001), 3, k)
    for v in variants:
        blk.insert_seq(v)
    build_s = time.perf_counter() - t0
    bf_path = os.path.join(work, "snv_blocked.bf")
    blk.save(bf_path)
    cfg = EngineConfig(k=k, hash_num=3, snv=True, threads=1).validate()
    bases = sum(L for L in lengths if L >= cfg.min_contig_len)

    def checked(tag, bp, runs, ref_s, same, extra, binned):
        row = {"phase": tag, "bp": bp, "runs": runs, "reference_full_scan_s": ref_s,
               "byte_identical": same, **extra}
        for r in runs:
            r["bp_per_s"] = bp / r["wall_s"]
            # the blocked filter's dense groups go through the binned pass,
            # its sparse tails (and the plain filter) through the candidate kernel
            if r["cand_launches"] <= 0 or (r["site_rows"] and r["site_launches"] <= 0) or (
                    binned and min(r["bin_launches"], r["probe_launches"]) <= 0):
                raise AssertionError(f"{tag}: an SNV kernel was never launched: {r}")
            if not binned and r["bin_launches"] + r["probe_launches"]:
                raise AssertionError(f"{tag}: the plain filter went through the binned pass: {r}")
            if not r["site_rows"] and r["site_launches"]:
                raise AssertionError(f"{tag}: the run without rows launched the site kernel")
            if r["records"] <= 0:
                raise AssertionError(f"{tag}: no SNV record")
        if not all(all(v.values()) for v in same.values()):
            raise AssertionError(f"{tag}: SNV outputs differ: {same}")
        return row

    # the host-only scan visits every base: the contigs run side by side
    t0 = time.perf_counter()
    ref_prefix = os.path.join(work, "snv_blocked_ref")
    reference_outputs(blk, draft_path, ref_prefix, cfg, threads=4)
    ref_s = time.perf_counter() - t0
    # with rows, then without
    runs = [run_snv_engine(f"snv_{i}", work, bf_path, draft_path, rows)
            for i, rows in enumerate((True, False))]
    same = {"rows_vs_no_rows": _same_outputs(runs[0]["prefix"], runs[1]["prefix"]),
            "rows_vs_full_scan": _same_outputs(runs[0]["prefix"], ref_prefix),
            "no_rows_vs_full_scan": _same_outputs(runs[1]["prefix"], ref_prefix)}
    out = [checked("snv_blocked", bases, runs, ref_s, same,
                   {"planted_variants": planted, "simulate_s": sim_s, "filter_build_s": build_s,
                    "filter_bytes": blk.bytes, "contigs": lengths, "reference": "full_scan_4_threads",
                    "site_kernel": site_kernel(blk, refs[0]),
                    "binned": binned_numbers(refs, blk, flush_buffer())}, binned=True)]
    del blk
    torch.cuda.empty_cache()
    # the plain layout on the 5 Mbp contig alone
    small_path = os.path.join(work, "ref5.fa")
    write_fasta(small_path, refs[2:3])
    write_fasta(os.path.join(work, "sample5.fa"), variants[2:3])  # phase filter_build's genome
    pl = bloom.KmerBloomFilter.zeros(bloom.bf_size_bytes(lengths[2], 3, 0.001), 3, k)
    pl.insert_seq(variants[2])
    pl_path = os.path.join(work, "snv_plain.bf")
    pl.save(pl_path)
    t0 = time.perf_counter()
    ref_prefix = os.path.join(work, "snv_plain_ref")
    reference_outputs(pl, small_path, ref_prefix, cfg)
    ref_s = time.perf_counter() - t0
    runs = [run_snv_engine("snv_plain_rows", work, pl_path, small_path, True)]
    same = {"rows_vs_full_scan": _same_outputs(runs[0]["prefix"], ref_prefix)}
    out.append(checked("snv_plain", lengths[2], runs, ref_s, same,
                       {"filter_bytes": pl.bytes, "site_kernel": site_kernel(pl, refs[2])},
                       binned=False))
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# phase 6: the filter build
# ---------------------------------------------------------------------------

READ_GENOME = 4_700_000  # bases of the reads' genome (E. coli scale, like CBF_LENGTH)
READ_LEN = 150
COVERAGE = 30
BASES = np.frombuffer(b"ACGT", dtype=np.uint8)


def simulate_reads(genome: np.ndarray, prefix: str, seed: int) -> list:
    """30x of 150 bp reads of ``genome`` at uniform starts, 1% substitutions
    (each to another base) and one N per 1,000 reads, written as two gzip
    FASTQ files under ``prefix``; returns their paths."""
    import gzip

    rng = np.random.default_rng(seed)
    n_reads = len(genome) * COVERAGE // READ_LEN
    starts = rng.integers(0, len(genome) - READ_LEN + 1, size=n_reads)
    code = np.zeros(256, dtype=np.int64)
    code[BASES] = np.arange(4)
    qual = b"I" * READ_LEN
    paths = []
    for part, (lo, hi) in enumerate(((0, n_reads // 2), (n_reads // 2, n_reads))):
        path = f"{prefix}_{part + 1}.fq.gz"
        with gzip.open(path, "wb", compresslevel=1) as f:
            for a in range(lo, hi, 100_000):
                b = min(hi, a + 100_000)
                r = genome[starts[a:b, None] + np.arange(READ_LEN)]
                sub = rng.random(r.shape) < 0.01
                r[sub] = BASES[(code[r[sub]] + rng.integers(1, 4, size=int(sub.sum()))) % 4]
                r.reshape(-1)[rng.integers(0, r.size, size=(b - a) // 1000)] = ord("N")
                f.write(b"".join(b"@r%d\n%s\n+\n%s\n" % (a + i, row.tobytes(), qual)
                                 for i, row in enumerate(r)))
        paths.append(path)
    return paths


def _launch_counted():
    from ntedit_tpu_torch.ops import build_kernel, gate_kernel, mesh_kernel, snv_kernel

    return (*build_kernel.KERNELS, gate_kernel.gate_words, snv_kernel.snv_cand_words,
            snv_kernel.snv_cand_bin, snv_kernel.snv_cand_probe, snv_kernel.snv_site_rows,
            snv_kernel.polish_site_rows, snv_kernel.polish_cand_masks, *mesh_kernel.KERNELS)


def kernel_launches() -> dict:
    """name -> launches of each counted wrapper."""
    return {fn.__name__: fn.launches for fn in _launch_counted()}


def reset_launches() -> None:
    for fn in _launch_counted():
        fn.launches = 0


def reads_of(run) -> tuple:
    """``run()`` with the reader's opens counted from 0, every
    bfbuild.DeviceBatches it makes kept, and the program's spans recorded:
    (its result, the batches made, the opens of each path, the seconds of
    its ``io.read`` spans)."""
    from ntedit_tpu_torch.core import bfbuild
    from ntedit_tpu_torch.io import native
    from ntedit_tpu_torch.utils import profiling

    made = []
    real = bfbuild.device_batches

    def record(*args, **kw):
        made.append(real(*args, **kw))
        return made[-1]

    native.read_batches.opens.clear()
    bfbuild.device_batches = record
    try:
        with profiling.recording() as rec:
            got = run()
    finally:
        bfbuild.device_batches = real
    read_s = sum(s.end_ns - s.start_ns for s in rec.spans if s.name == "io.read") / 1e9
    return got, made, dict(native.read_batches.opens), read_s


def reads_row(made: list, opens: dict, read_s: float, paths: list) -> dict:
    """The read of ``paths`` by one command: each file's opens (1 when the
    pieces stayed on the device), the host seconds of the reader (its
    ``io.read`` spans: reading, joining and cutting pieces), the passes and
    the bytes kept."""
    return {"opens": {os.path.basename(p): opens.get(p, 0) for p in paths},
            "read_s": read_s, "passes": sum(b.passes for b in made),
            "kept_bytes": sum(b.kept_bytes for b in made),
            "budget_bytes": [b.budget for b in made]}


def run_cli(argv: list, cwd: str) -> tuple:
    """``python -m ntedit_tpu_torch`` in process from ``cwd``, on the card:
    (wall seconds, the kernels' launches, peak device memory).  The launch
    counts are set to 0 just before and read just after."""
    import torch

    from ntedit_tpu_torch import cli

    here = os.getcwd()
    os.chdir(cwd)
    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    try:
        cli.main(argv)
    finally:
        os.chdir(here)
    return time.perf_counter() - t0, kernel_launches(), torch.cuda.max_memory_allocated()


def plain_build(pieces, k: int, hash_num: int, nbits: int, slots: int, layout: str,
                cutoff: int) -> tuple:
    """A whole filter build by the plain versions on the card, over the
    same pieces: (counters, words) as numpy (None where the build has no
    such table)."""
    import torch

    from ntedit_tpu_torch.core import bfbuild
    from ntedit_tpu_torch.ops import build_kernel as bk

    dev = torch.device("cuda")
    counters = torch.zeros(slots, dtype=torch.uint8, device=dev) if slots else None
    if slots:
        for seq, n in bfbuild.upload_batches(pieces, k, dev):
            bk.kmer_count_plain(seq, n, k, hash_num, counters, slots)
    words = None
    if layout != "counting":
        modulus = nbits // 32 if layout == "blocked" else nbits
        words = torch.zeros(-(-nbits // 32), dtype=torch.int32, device=dev)
        for seq, n in bfbuild.upload_batches(pieces, k, dev):
            bk.kmer_insert_plain(seq, n, k, hash_num, words, layout, modulus, counters, slots,
                                 cutoff)
        words = words.cpu().numpy().view(np.uint32)
    return (None if counters is None else counters.cpu().numpy()), words


def phase_filter_build(work: str) -> dict:
    """polish --reads (blocked, cutoff 2) and --cbf, make-genome-bf and
    snv --genome through the command line on the card, each filter held to
    the plain versions' build and each output to the host-only full scan."""
    import torch

    from ntedit_tpu_torch.core import bfbuild, bloom
    from ntedit_tpu_torch.engine.config import EngineConfig
    from ntedit_tpu_torch.ops import build_kernel as bk
    from ntedit_tpu_torch.utils import simulate

    k, hash_num, cutoff = 25, 3, 2  # polish --reads' k, hashes and the cutoff its filter takes
    dev = torch.device("cuda")
    out = {"phase": "filter_build"}
    t0 = time.perf_counter()
    truth = simulate.random_genome(READ_GENOME, seed=1100)
    draft, _ = simulate.inject_errors(truth, seed=1101)
    draft_path = os.path.join(work, "draft_reads.fa")
    write_fasta(draft_path, [draft])
    prefix = os.path.join(work, "reads")
    read_files = simulate_reads(truth, prefix, seed=1102)
    out["simulate_s"] = time.perf_counter() - t0
    out["reads"] = len(truth) * COVERAGE // READ_LEN

    # polish --reads: the main path of the build, blocked, cutoff 2
    (wall, launches, peak), made, opens, io_read_s = reads_of(lambda: run_cli(
        ["polish", "--draft", draft_path, "--reads", prefix, "-k", str(k), "-t", "8", "-b",
         os.path.join(work, "fb")], work))
    reads = reads_row(made, opens, io_read_s, read_files)
    if set(reads["opens"].values()) != {1}:
        raise AssertionError(f"polish --reads read its reads more than once: {reads}")
    for name in ("kmer_valid_hashes", "kmer_partition", "kmer_count_apply", "kmer_solid_bits",
                 "kmer_insert", "gate_words"):
        if launches[name] <= 0:
            raise AssertionError(f"polish --reads never launched {name}: {launches}")
    hist = bfbuild.Histogram.load(f"{prefix}_k{k}.hist", k=k)
    bf = bloom.load_any(f"{prefix}_k{k}.bf")
    t0 = time.perf_counter()
    pieces = list(bfbuild.iter_separated_buffers(read_files, k))
    read_s = time.perf_counter() - t0
    # the histogram from the plain hashes on the card, and every read k-mer's count
    plain_hashes = [bk.valid_hashes_plain(seq, n, k) for seq, n in bfbuild.upload_batches(pieces, k, dev)]
    plain_hist = bfbuild.histogram_of(plain_hashes, k)
    same_hist = (plain_hist.f1, plain_hist.f0) == (hist.f1, hist.f0) and np.array_equal(
        plain_hist.spectrum, hist.spectrum)
    kmers, mult = torch.unique(torch.cat(plain_hashes), return_counts=True)
    del plain_hashes
    df = bloom.DeviceFilter.from_host(bf, dev)
    solid = kmers[mult >= cutoff]
    absent = int((~df.contains([solid])).sum())
    truth_can = bk.valid_hashes(*_padded(truth, k, dev))
    truth_absent = int((~df.contains([torch.unique(truth_can)])).sum())
    del kmers, mult, solid, truth_can, df
    nbits, slots, cbf_slots = bfbuild.filter_sizes(hist, cutoff)
    plain_counters, words = plain_build(pieces, k, hash_num, nbits, slots, "blocked", cutoff)
    same_bf = isinstance(bf, bloom.BlockedKmerBloomFilter) and np.array_equal(bf.words, words)
    # the same build with budget 0: each pass reads the reads again
    t0 = time.perf_counter()
    (again, _, _), _, reread_opens, _ = reads_of(lambda: bfbuild.build_read_filter(
        read_files, k, cutoff=cutoff, hist=hist, device=dev, budget=0))
    torch.cuda.synchronize()
    reread = {"wall_s": time.perf_counter() - t0,
              "opens": {os.path.basename(p): reread_opens.get(p, 0) for p in read_files},
              "filter_equals_kept": np.array_equal(again.words, bf.words),
              "filter_equals_plain": np.array_equal(again.words, words)}
    del again
    cfg = EngineConfig(k=k, hash_num=hash_num, threads=1).validate()
    ref_prefix = os.path.join(work, "fb_ref")
    t0 = time.perf_counter()
    reference_outputs(bf, draft_path, ref_prefix, cfg)
    ref_s = time.perf_counter() - t0
    same = _same_outputs(os.path.join(work, f"fb_ntedit_k{k}"), ref_prefix)
    out["polish_reads"] = {
        "wall_s": wall, "reads": reads, "read_pass_s": read_s, "reread": reread,
        "launches": launches, "max_memory_allocated": peak,
        "f1": hist.f1, "f0": hist.f0, "cutoff": cutoff, "filter_bytes": bf.bytes,
        "count_slots": slots, "hist_equals_plain": same_hist, "filter_equals_plain": same_bf,
        "solid_read_kmers_absent": absent, "genome_kmers_absent": truth_absent,
        "reference_full_scan_s": ref_s, "byte_identical": same}
    if not (same_hist and same_bf and all(same.values())) or absent \
            or not (reread["filter_equals_kept"] and reread["filter_equals_plain"]) \
            or set(reread["opens"].values()) != {2}:
        raise AssertionError(f"polish --reads: {out['polish_reads']}")
    del bf
    out["kernel_numbers"] = build_numbers(list(bfbuild.upload_batches(pieces, k, dev, keep=True)),
                                          k, hash_num, cutoff, plain_counters, nbits // 32,
                                          flush_buffer())
    del words, plain_counters
    torch.cuda.empty_cache()

    # polish --reads --cbf: the counting filter of every valid k-mer
    (wall, launches, peak), made, opens, io_read_s = reads_of(lambda: run_cli(
        ["polish", "--draft", draft_path, "--reads", prefix, "-k", str(k), "-t", "8", "--cbf",
         "-p", "2", "-q", "254", "-b", os.path.join(work, "fbc")], work))
    cbf_reads = reads_row(made, opens, io_read_s, read_files)
    if min(launches[name] for name in ("kmer_partition", "kmer_count_apply", "gate_words")) <= 0:
        raise AssertionError(f"polish --cbf never launched its kernels: {launches}")
    cbf = bloom.load_any(f"{prefix}_k{k}.cbf")
    plain_counters, _ = plain_build(pieces, k, 3, 0, cbf_slots, "counting", 1)
    same_cbf = cbf.bytes == cbf_slots and np.array_equal(cbf.counters, plain_counters)
    del plain_counters
    cfg = EngineConfig(k=k, hash_num=3, threads=1, min_threshold=2, max_threshold=254).validate()
    ref_prefix = os.path.join(work, "fbc_ref")
    reference_outputs(cbf, draft_path, ref_prefix, cfg)
    same = _same_outputs(os.path.join(work, f"fbc_ntedit_k{k}"), ref_prefix)
    out["polish_cbf"] = {"wall_s": wall, "reads": cbf_reads, "launches": launches,
                         "max_memory_allocated": peak,
                         "slots": cbf.bytes, "filter_equals_plain": same_cbf,
                         "byte_identical": same}
    if not (same_cbf and all(same.values())) or set(cbf_reads["opens"].values()) != {1}:
        raise AssertionError(f"polish --cbf: {out['polish_cbf']}")
    del cbf, pieces
    torch.cuda.empty_cache()

    # make-genome-bf on phase 3's 50 Mbp draft: btllib size, plain layout
    genome_path = os.path.join(work, "draft50.fa")
    bf_path = os.path.join(work, "genome50.bf")
    (wall, launches, peak), made, opens, io_read_s = reads_of(lambda: run_cli(
        ["make-genome-bf", "--genome", genome_path, "-k", str(k), "--fpr", "0.01", "-o",
         bf_path], work))
    genome_reads = reads_row(made, opens, io_read_s, [genome_path])
    if launches["kmer_insert"] <= 0:
        raise AssertionError(f"make-genome-bf never launched kmer_insert: {launches}")
    gbf = bloom.load_any(bf_path)
    _, words = plain_build(list(bfbuild.iter_separated_buffers([genome_path], k)), k, 3,
                           gbf.bits, 0, "plain", 1)
    same_gbf = np.array_equal(gbf.data, words.view(np.uint8)[: gbf.bytes])
    out["make_genome_bf"] = {"wall_s": wall, "reads": genome_reads, "launches": launches,
                             "max_memory_allocated": peak, "filter_bytes": gbf.bytes,
                             "filter_equals_plain": same_gbf}
    if not same_gbf or genome_reads["opens"][os.path.basename(genome_path)] != 1:
        raise AssertionError(f"make-genome-bf: {out['make_genome_bf']}")
    del gbf, words

    # snv --genome on phase 5's 5 Mbp contig and its sample
    # the artifacts land in the working directory, named after the genome
    ref_path, sample_path = os.path.join(work, "ref5.fa"), os.path.join(work, "sample5.fa")
    (wall, launches, peak), made, opens, io_read_s = reads_of(lambda: run_cli(
        ["snv", "--reference", ref_path, "--genome", sample_path, "-k", str(k), "-t", "8"], work))
    sample_reads = reads_row(made, opens, io_read_s, [sample_path])
    for name in ("kmer_valid_hashes", "kmer_insert", "snv_cand_words", "snv_site_rows"):
        if launches[name] <= 0:
            raise AssertionError(f"snv --genome never launched {name}: {launches}")
    sbf = bloom.load_any(os.path.join(work, f"sample5_k{k}.bf"))
    _, words = plain_build(list(bfbuild.iter_separated_buffers([sample_path], k)), k, 3,
                           sbf.bits, 0, "plain", 1)
    same_sbf = np.array_equal(sbf.data, words.view(np.uint8)[: sbf.bytes])
    cfg = EngineConfig(k=k, hash_num=3, snv=True, threads=1).validate()
    ref_prefix = os.path.join(work, "snvg_ref")
    reference_outputs(sbf, ref_path, ref_prefix, cfg)
    same = _same_outputs(os.path.join(work, f"sample5_ntedit_k{k}"), ref_prefix)
    with open(os.path.join(work, f"sample5_ntedit_k{k}_changes.tsv")) as f:
        records = sum(1 for _ in f) - 1
    out["snv_genome"] = {"wall_s": wall, "reads": sample_reads, "launches": launches,
                         "max_memory_allocated": peak,
                         "filter_bytes": sbf.bytes, "filter_equals_plain": same_sbf,
                         "records": records, "byte_identical": same}
    if not (same_sbf and all(same.values())) or records <= 0 \
            or sample_reads["opens"][os.path.basename(sample_path)] != 1:
        raise AssertionError(f"snv --genome: {out['snv_genome']}")
    return out


def _padded(seq: np.ndarray, k: int, dev) -> tuple:
    """(seq on ``dev`` padded for the kernels, its windows)."""
    import torch

    from ntedit_tpu_torch.ops import gate_kernel

    n = len(seq) - k + 1
    buf = torch.zeros(gate_kernel.padded_len(n), dtype=torch.uint8)
    buf[: len(seq)] = torch.from_numpy(seq)
    return buf.to(dev), n, k



# ---------------------------------------------------------------------------
# phase 8: the wavefront and sequential engines, -v, the fallback, the trace
# ---------------------------------------------------------------------------

ENGINE_CONTIG = 4_700_000  # bases of the polish-mode wavefront's contig: a bacterial genome
# bases of the SNV wavefront's, the sequential, -v and fallback runs' draft: in
# SNV mode every head gates, so no zone re-flag is quiet and the wavefront
# commits one leader a round (about 13 s a Mbp, growing with the square)
SEQ_DRAFT = 500_000


def _cand_launches(launches: dict) -> int:
    return launches["snv_cand_words"] + launches["snv_cand_bin"] + launches["snv_cand_probe"]


def polish_api(tag: str, work: str, pol, draft_path: str, ref_prefix: str) -> dict:
    """Polisher.polish over the draft through the Python API, rendered by
    the command line's writers and held on all three files to the
    host-only full scan at ``ref_prefix``.  The launch counts are set to 0
    just before the run and read just after."""
    from ntedit_tpu_torch.io import fastx, writers

    cfg = pol.cfg
    prefix = os.path.join(work, tag)
    records = 0
    reset_launches()
    t0 = time.perf_counter()
    with open(prefix + "_edited.fa", "w") as dfout, \
         open(prefix + "_changes.tsv", "w") as rfout, \
         open(prefix + "_variants.vcf", "w") as vfout:
        rfout.write(writers.changes_tsv_header(cfg.k, cfg.jump, False))
        vfout.write(writers.vcf_header(draft_path))
        for res in pol.polish((r.header, r.seq) for r in fastx.read_fastx(draft_path)):
            writers.write_contig(res, dfout, rfout, vfout, {}, snv=cfg.snv)
            records += len(res.subs)
    wall = time.perf_counter() - t0
    launches = kernel_launches()
    same = _same_outputs(prefix, ref_prefix)
    out = {"engine": pol.engine, "snv": cfg.snv, "wall_s": wall, "records": records,
           "gate_launches": launches["gate_words"], "cand_launches": _cand_launches(launches),
           "byte_identical": same}
    if not all(same.values()) or records <= 0:
        raise AssertionError(f"{tag}: outputs differ from the host-only full scan: {out}")
    return out


def trace_numbers(path: str) -> dict:
    """A Chrome trace of torch.profiler: its device events (kernels,
    copies, sets), their busy time (overlaps merged) against the span of
    the whole trace, and whether the gate kernel is named in it."""
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    device = sorted((e["ts"], e["ts"] + e.get("dur", 0)) for e in events
                    if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"))
    busy, end = 0.0, None
    for a, b in device:
        if end is None or a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    span = (max(e["ts"] + e.get("dur", 0) for e in events) - min(e["ts"] for e in events)) \
        if events else 0.0
    categories: dict = {}
    for e in events:
        categories[e.get("cat")] = categories.get(e.get("cat"), 0) + 1
    return {"trace_bytes": os.path.getsize(path), "events": len(events), "categories": categories,
            "device_events": len(device), "device_busy_s": busy / 1e6, "span_s": span / 1e6,
            "device_busy_share": busy / span if span else None,
            "names_gate_kernel": any("gate_words_kernel" in e.get("name", "") for e in events)}


def phase_engines(work: str, device: str = "cuda") -> dict:
    """The engines beside the native repair, on a 4.7 Mbp contig and a
    500 kbp draft, with a 256 MiB blocked filter and a plain filter at the
    sizes of phase 3 holding their truth: ``Polisher(engine="wavefront")``
    in polish mode (4.7 Mbp) and in SNV mode (500 kbp);
    ``engine="sequential"`` and ``engine
    -v 1`` through the command line's function; the fallback after a
    failed native repair (the repair functions replaced by ones returning
    None) in both modes; and ``NTEDIT_TPU_TRACE`` on one ``engine`` run of
    the 4.7 Mbp contig.  Every run's three files equal the host-only full
    scan's; the -v stdout equals the trace the same Oracle prints with
    the gate hint of the gate kernel's plain version."""
    import contextlib
    import io

    import torch

    from ntedit_tpu_torch import cli
    from ntedit_tpu_torch.core import bloom
    from ntedit_tpu_torch.engine import flag, native_repair
    from ntedit_tpu_torch.engine.config import EngineConfig
    from ntedit_tpu_torch.engine.oracle import Oracle
    from ntedit_tpu_torch.engine.polish import Polisher
    from ntedit_tpu_torch.io import fastx
    from ntedit_tpu_torch.ops import gate_kernel
    from ntedit_tpu_torch.utils import profiling, simulate

    k = 25
    dev = torch.device(device)
    out = {"phase": "engines", "contig_bp": ENGINE_CONTIG, "draft_bp": SEQ_DRAFT}
    t0 = time.perf_counter()
    truths, drafts = simulate.polish_genome([ENGINE_CONTIG, SEQ_DRAFT], seed=1300)
    big_path, small_path = os.path.join(work, "eng47.fa"), os.path.join(work, "eng05.fa")
    write_fasta(big_path, drafts[:1])
    write_fasta(small_path, drafts[1:])
    blk = bloom.BlockedKmerBloomFilter.zeros(bloom.pow2_size_bytes(GENOME, 3, 0.001), 3, k)
    pl = bloom.KmerBloomFilter.zeros(bloom.bf_size_bytes(GENOME, 3, 0.001), 3, k)
    for t in truths:
        blk.insert_seq(t)
        pl.insert_seq(t)
    blk_path, pl_path = os.path.join(work, "eng_blk.bf"), os.path.join(work, "eng_pl.bf")
    blk.save(blk_path)
    pl.save(pl_path)
    out["setup_s"] = time.perf_counter() - t0
    out["filter_bytes"] = {"blocked": blk.bytes, "plain": pl.bytes}

    def reference(tag, host_bf, draft_path, **cfg_kw):
        prefix = os.path.join(work, tag)
        t0 = time.perf_counter()
        reference_outputs(host_bf, draft_path, prefix, EngineConfig(
            k=k, hash_num=3, threads=1, **cfg_kw).validate())
        out.setdefault("reference_full_scan_s", {})[tag] = time.perf_counter() - t0
        return prefix

    refs = {"big": reference("eng_ref47", blk, big_path),
            "small": reference("eng_ref05", pl, small_path),
            "small_snv": reference("eng_ref05_snv", pl, small_path, snv=True)}

    # the wavefront engine: polish mode on the bacterial genome (the gate
    # kernel's hint), SNV mode on the draft (the candidate kernels' heads)
    for tag, snv, host_bf, path, ref in (
            ("wavefront", False, blk, big_path, refs["big"]),
            ("wavefront_snv", True, pl, small_path, refs["small_snv"])):
        cfg = EngineConfig(k=k, hash_num=3, threads=8, snv=snv).validate()
        pol = Polisher(host_bf, None, cfg, device=dev, engine="wavefront")
        out[tag] = polish_api(tag, work, pol, path, ref)
        kernel = "cand_launches" if snv else "gate_launches"
        if out[tag][kernel] <= 0:
            raise AssertionError(f"{tag}: its device pass was never launched: {out[tag]}")
        del pol

    # the sequential engine through the command line's function
    prefix = os.path.join(work, "sequential")
    reset_launches()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        cli._run_engine(pl_path, small_path, prefix, threads=8, device=device,
                        engine="sequential")
    launches = kernel_launches()
    out["sequential"] = {"wall_s": time.perf_counter() - t0,
                         "gate_launches": launches["gate_words"],
                         "byte_identical": _same_outputs(prefix, refs["small"])}
    if not all(out["sequential"]["byte_identical"].values()) or launches["gate_words"] <= 0:
        raise AssertionError(f"sequential: {out['sequential']}")

    # engine -v 1: its stdout against the Oracle's trace over the plain gate hint
    prefix = os.path.join(work, "verbose")
    stdout = io.StringIO()
    reset_launches()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(stdout):
        cli.main(["engine", "-r", pl_path, "-f", small_path, "-b", prefix, "-t", "8", "-v", "1",
                  "--device", device])
    wall = time.perf_counter() - t0
    launches = kernel_launches()
    lines = stdout.getvalue().splitlines()
    got = "\n".join(l for l in lines[lines.index(" -v 1") + 1:] if not l.startswith("engine: "))
    df = bloom.DeviceFilter.from_host(pl, dev)
    cfg = EngineConfig(k=k, hash_num=3, threads=8, verbose=True).validate()
    hints = []  # the gate kernel's plain version's hint of each contig
    for rec in fastx.read_fastx(small_path):
        seq_dev, n, _ = _padded(rec.seq, k, dev)
        words = gate_kernel.gate_words_plain(seq_dev, n, df, False, 1)
        hints.append((rec, flag.packed_to_positions(words.cpu().numpy().view(np.uint32), n)))
    hint_same = all(np.array_equal(h, flag.flag_contig_gates(r.seq, df)) for r, h in hints)
    del df

    def oracle_trace(fast: bool, headers: bool) -> str:
        """What the Oracle prints over the plain hints, each contig's trace
        after its header when ``headers`` (as the command line prints)."""
        text = io.StringIO()
        with contextlib.redirect_stdout(text):
            for rec, hint in hints:
                if headers:
                    print(rec.header)
                Oracle(pl, None, cfg, fast=fast).polish_contig(rec.header, bytes(rec.seq),
                                                               gate_hint=hint)
        return text.getvalue()

    want = oracle_trace(True, True).rstrip("\n")
    out["verbose"] = {"wall_s": wall, "gate_launches": launches["gate_words"],
                      "stdout_lines": len(lines), "trace_lines": got.count("check_present"),
                      "stdout_equals_oracle_trace": got == want,
                      "plain_hint_equals_kernel_hint": bool(hint_same),
                      "byte_identical": _same_outputs(prefix, refs["small"])}
    if not (got == want and hint_same and all(out["verbose"]["byte_identical"].values())) \
            or launches["gate_words"] <= 0:
        raise AssertionError(f"engine -v 1: {out['verbose']}")
    # the batched site fixer takes most sites silently (as in the JAX
    # package): -v with the scalar site path prints every trial
    stdout = io.StringIO()
    pol = Polisher(pl, None, cfg, device=dev, fast_sites=False)
    with contextlib.redirect_stdout(stdout):
        scalar = polish_api("verbose_scalar", work, pol, small_path, refs["small"])
    want = oracle_trace(False, False)
    scalar.update(trace_lines=stdout.getvalue().count("check_present"),
                  stdout_equals_oracle_trace=stdout.getvalue() == want)
    out["verbose_scalar"] = scalar
    if not scalar["stdout_equals_oracle_trace"] or scalar["trace_lines"] <= 0 \
            or scalar["gate_launches"] <= 0:
        raise AssertionError(f"-v with the scalar site path: {scalar}")

    # the fallback: every native and segmented repair returns None
    real = {name: getattr(native_repair, name) for name in (
        "polish_contig_pipelined", "polish_contig_native", "polish_contig_segmented")}
    try:
        for name in real:
            setattr(native_repair, name, lambda *a, **kw: None)
        for tag, snv in (("fallback", False), ("fallback_snv", True)):
            cfg = EngineConfig(k=k, hash_num=3, threads=8, snv=snv).validate()
            pol = Polisher(pl, None, cfg, device=dev)
            out[tag] = polish_api(tag, work, pol, small_path,
                                  refs["small_snv" if snv else "small"])
            if out[tag]["cand_launches" if snv else "gate_launches"] <= 0:
                raise AssertionError(f"{tag}: its device pass was never launched: {out[tag]}")
    finally:
        for name, fn in real.items():
            setattr(native_repair, name, fn)

    # NTEDIT_TPU_TRACE on the default engine run of the bacterial genome,
    # twice in this process: a trace with no device event raises in trace()
    # (a spent CUPTI session), and that failure is the run's
    for i, tag in enumerate(("traced", "traced_again")):
        logdir = os.path.join(work, f"trace{i}")
        prefix = os.path.join(work, tag)
        os.environ[profiling.TRACE_ENV] = logdir
        reset_launches()
        t0 = time.perf_counter()
        try:
            with contextlib.redirect_stdout(io.StringIO()):
                cli.main(["engine", "-r", blk_path, "-f", big_path, "-b", prefix, "-t", "8",
                          "--device", device])
        finally:
            del os.environ[profiling.TRACE_ENV]
        wall = time.perf_counter() - t0
        files = sorted(os.listdir(logdir)) if os.path.isdir(logdir) else []
        out[tag] = {"wall_s": wall, "gate_launches": kernel_launches()["gate_words"],
                    "trace_files": len(files), "byte_identical": _same_outputs(prefix, refs["big"])}
        if len(files) != 1:
            raise AssertionError(f"NTEDIT_TPU_TRACE: no single trace file in {logdir}: {files}")
        out[tag].update(trace_numbers(os.path.join(logdir, files[0])))
        if not (out[tag]["names_gate_kernel"] and out[tag]["device_events"] > 0
                and all(out[tag]["byte_identical"].values())):
            raise AssertionError(f"NTEDIT_TPU_TRACE: {out[tag]}")
    return out


# ---------------------------------------------------------------------------
# phase 7: numbers
# ---------------------------------------------------------------------------

def probe_cost(df, can, min_threshold: int = 1) -> tuple:
    """(sector ids, probes) of probing the canonical hashes ``can``: the
    32-byte DRAM sectors of the filter read, one tensor per probe round,
    and the number of probes made.  Plain and counting stop at the first
    deciding probe, as the kernels do: a clear bit, or a counter below
    max(min_threshold, 1)."""
    import torch

    from ntedit_tpu_torch.core import nthash as nt

    if df.blocked:
        return [(can & (df.modulus - 1)) >> 3], can.numel()
    live = torch.ones_like(can, dtype=torch.bool)
    sectors = []
    probes = 0
    for h in nt.extend(can, df.k, df.hash_num):
        probes += int(live.sum())
        idx = nt.umod(h, df.modulus)
        if df.counting:  # 32 counters per sector
            sectors.append((idx >> 5)[live])
            live = live & (df.table[idx].long() >= max(min_threshold, 1))
        else:  # 256 bits per sector
            sectors.append((idx >> 8)[live])
            live = live & (((df.table[idx >> 5].long() & 0xFFFFFFFF) >> (idx & 31)) & 1 == 1)
    return sectors, probes


def probed_sectors(seq_dev, n: int, df, min_threshold: int) -> tuple:
    """(sectors, live heads, probes): the distinct 32-byte DRAM sectors of
    the filter that the gate pass must read for these heads, the number of
    heads it probes (valid, not forced) and the probes it makes."""
    import torch

    from ntedit_tpu_torch.core import nthash as nt
    from ntedit_tpu_torch.ops import gate_kernel

    s = seq_dev[: n + df.k - 1]
    valid, iupac = gate_kernel.window_flags(s, n, df.k)
    live = valid & ~iupac
    can = nt.canonical(*nt.window_hashes(s, df.k))
    sectors, probes = probe_cost(df, can[live], min_threshold)
    return int(torch.unique(torch.cat(sectors)).numel()), int(live.sum()), probes


def snv_cand_probed(seq_dev, n: int, df) -> tuple:
    """(sectors, live heads, probes) of the SNV candidate pass: three
    alternates per valid head with no IUPAC byte."""
    import torch

    from ntedit_tpu_torch.ops import gate_kernel, snv_kernel

    valid, iupac = gate_kernel.window_flags(seq_dev[: n + df.k - 1], n, df.k)
    live = valid & ~iupac
    can = torch.cat([c[live & allowed] for _b, allowed, c in
                     snv_kernel.alternate_hashes(seq_dev, n, df.k)])
    sectors, probes = probe_cost(df, can)
    return int(torch.unique(torch.cat(sectors)).numel()), int(live.sum()), probes


def snv_site_probed(seq_dev, n: int, cand, df, jump: int) -> tuple:
    """(sectors, valid rows, probes) of the SNV site pass: the probes the
    function needs per valid row: at the head and at each stride window
    that holds the site, the pristine window and the three alternates (the
    draft's own base is the pristine window), and one for the window past
    the site; 37 at k = 25, jump 3."""
    import torch

    from ntedit_tpu_torch.ops import snv_kernel

    k = df.k
    valid, windows = snv_kernel.site_windows(seq_dev, n, cand, k, jump)
    tail = seq_dev[cand[valid] + k - 1].long() & 0xDF  # the draft's base at the site
    cans = []
    for item, c, can in windows:
        past = item > 0 and 1 + (item - 1) * jump > k - 1  # the window starts past the site
        if c < 0:
            cans.append(can)
        elif not past:
            cans.append(can[tail != snv_kernel.ACGT[c]])
    sectors, probes = probe_cost(df, torch.cat(cans))
    return int(torch.unique(torch.cat(sectors)).numel()), int(valid.sum()), probes


def flush_buffer():
    """256 MiB on the card, five times the L2: zeroed before a timed launch."""
    import torch

    return torch.empty(256 << 20, dtype=torch.uint8, device=torch.device("cuda"))


def binned_numbers(refs, host_bf, flush) -> dict:
    """The SNV candidate pass at the shape snv_blocked gives it: the whole
    pass over every contig (on the card; the words) by the path, which bins
    its dense groups, and by the candidate kernel one chunk at a time, the
    path's words held to the kernel's; and the binned pass's two kernels on
    the 30 Mbp contig's first group (7 chunks) against their plain versions,
    their bounds and floors (binned_kernel_numbers)."""
    import torch

    from ntedit_tpu_torch.core import bloom
    from ntedit_tpu_torch.engine import flag
    from ntedit_tpu_torch.ops import snv_kernel

    df = bloom.DeviceFilter.from_host(host_bf, torch.device("cuda"))
    contigs = [_padded(r, df.k, df.device)[:2] for r in refs if len(r) >= df.k]

    def path():
        return [flag.snv_candidate_words(seq, n, df) for seq, n in contigs]

    def kernel():  # one launch a 2^22-head chunk
        c = flag.DEFAULT_CHUNK
        return [torch.cat([snv_kernel.snv_cand_words(seq[s:], min(c, n - s), df)
                           for s in range(0, n, c)]) for seq, n in contigs]

    differing = sum(int((a != b).sum()) for a, b in zip(path(), kernel()))
    if differing:
        raise AssertionError(f"the path's candidate words differ from the kernel's: {differing}")
    out = {"pass": {"path": time_cuda(path, REPS, flush), "kernel": time_cuda(kernel, REPS, flush)},
           **binned_kernel_numbers(*contigs[0], df, flush)}
    if out["differing"]:
        raise AssertionError(f"a binned kernel differs from its plain version: {out}")
    return out


def binned_kernel_numbers(seq, n: int, df, flush) -> dict:
    """The binned pass's kernels on the first group of one contig, each
    against its plain version (the bins as multisets, the forced and the
    probed words, and those against snv_cand_words_plain), the bytes bound
    of the candidate words they compute together, their design bytes and
    a floor each: a device copy of the front end's design bytes; random
    probes of one slice's words, 4 in flight, as many as the probe kernel
    makes."""
    import torch

    from ntedit_tpu_torch.engine import flag
    from ntedit_tpu_torch.ops import gate_kernel, snv_kernel

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
    entries = bins.total()
    sectors = int(torch.unique((bins.can[:entries] & (df.modulus - 1)) >> 3).numel())
    bin_ms = time_cuda(lambda: snv_kernel.snv_cand_bin(seq, group, df, bins, words), REPS, flush)
    probe_ms = time_cuda(lambda: snv_kernel.snv_cand_probe(bins, df, words), REPS, flush)
    plain_bin_ms = time_cuda(lambda: snv_kernel.snv_cand_bin_plain(seq, group, df, plain,
                                                                   plain_words), 1, flush)
    plain_probe_ms = time_cuda(lambda: snv_kernel.snv_cand_probe_plain(plain, df, plain_words),
                               1, flush)
    del plain
    table = df.table[: min(df.modulus, 1 << bins.slice_bits)]
    floor_ms = time_cuda(lambda: gate_kernel.probe_floor(table, entries, -(-entries // 4), 4),
                         REPS, flush)
    # the function both kernels compute together, the group's candidate
    # words, needs its ASCII once, the words and the distinct filter sectors
    # its probes touch: one bound for the two.  The entries (written by the
    # front end, read by the probes) and the count matrix exist only in
    # this design: each kernel's design_bytes counts them beside its share
    # of the function's bytes
    nbytes = group + df.k - 1 + 4 * nw + 32 * sectors
    bound = bound_ms(nbytes)
    bin_design = group + df.k - 1 + 4 * nw + snv_kernel.ENTRY_BYTES * entries + 12 * cells
    probe_design = snv_kernel.ENTRY_BYTES * entries + 32 * sectors + 4 * nw
    return {"heads": group, "entries": entries, "slices": bins.n_slices,
            "slice_bits": bins.slice_bits, "cells": cells, "scratch_bytes": bins.nbytes,
            "sectors": sectors, "probes_per_sector": entries / (df.modulus / 8),
            "differing": differing, "max_abs_err": err, "bytes": nbytes, "bound_ms": bound,
            "share_of_bound": bound / (bin_ms + probe_ms),
            "bin": {"ms": bin_ms, "plain_ms": plain_bin_ms, "bytes": nbytes, "bound_ms": bound,
                    "design_bytes": bin_design, "floor_ms": copy_ms(bin_design, flush),
                    "floor": "device copy of its design bytes"},
            "probe": {"ms": probe_ms, "plain_ms": plain_probe_ms, "bytes": nbytes,
                      "bound_ms": bound, "design_bytes": probe_design, "floor_ms": floor_ms,
                      "floor": "random probes of one slice's words, 4 in flight"}}


def time_cuda(fn, reps: int, flush, reset=None) -> float:
    """Median ms of ``fn`` over ``reps`` launches, L2 flushed before each
    (and ``reset()`` called before that, untimed), after one untimed call."""
    import torch

    fn()  # warm
    times = []
    for _ in range(reps):
        if reset is not None:
            reset()
        flush.zero_()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def bound_ms(nbytes: int) -> float:
    """The least ms the card could take to move ``nbytes`` at its HBM rate."""
    return nbytes / HBM_BYTES_PER_S * 1e3


def copy_ms(nbytes: int, flush) -> float:
    """A device copy of ``nbytes`` / 2 bytes (``nbytes`` moved): the
    streaming floor of a kernel that reads and writes ``nbytes`` in all."""
    import torch

    src = torch.empty(max(1, nbytes // 2), dtype=torch.uint8, device=flush.device)
    dst = torch.empty_like(src)
    return time_cuda(lambda: dst.copy_(src), REPS, flush)


def yardsticks(table, probes: int, threads: int, batch: int, flush) -> tuple:
    """(floor ms, take ms): the probe floor at ``probes`` random probes of
    ``table`` from ``threads`` threads with ``batch`` loads in flight, and
    a torch.take gather of as many random words."""
    import torch

    from ntedit_tpu_torch.ops import gate_kernel

    floor_ms = time_cuda(lambda: gate_kernel.probe_floor(table, probes, threads, batch), REPS,
                         flush)
    idx = torch.randint(0, table.numel(), (probes,), device=table.device)
    return floor_ms, time_cuda(lambda: torch.take(table, idx), 10, flush)


def snv_cand_numbers(seq_dev, n: int, L: int, df, flush) -> dict:
    """The SNV candidate kernel on the chunk against its plain version, its
    bytes bound, the probe floor at its own probe count and loads in
    flight, and a torch.take gather of as many random words."""
    from ntedit_tpu_torch.ops import snv_kernel

    got = snv_kernel.snv_cand_words(seq_dev, n, df)
    want = snv_kernel.snv_cand_words_plain(seq_dev, n, df)
    diff = int((got != want).sum())
    err = int(((got.long() & 0xFFFFFFFF) - (want.long() & 0xFFFFFFFF)).abs().max())
    if diff or err:
        raise AssertionError("SNV candidate kernel differs from plain at the chunk shape")
    sectors, live, probes = snv_cand_probed(seq_dev, n, df)
    nbytes = L + 4 * (-(-n // 32)) + 32 * sectors
    floor_ms, take_ms = yardsticks(df.table, probes, -(-n // 32),
                                   snv_kernel.CAND_BATCH[df.layout], flush)
    ms = time_cuda(lambda: snv_kernel.snv_cand_words(seq_dev, n, df), REPS, flush)
    plain_ms = time_cuda(lambda: snv_kernel.snv_cand_words_plain(seq_dev, n, df), 3, flush)
    return {"heads": n, "live_heads": live, "probes": probes, "sectors": sectors,
            "bytes": nbytes, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms(nbytes),
            "floor_ms": floor_ms, "take_ms": take_ms, "share_of_bound": bound_ms(nbytes) / ms,
            "ms_over_floor": ms / floor_ms, "differing_words": diff, "max_abs_err": err}


# what the kernels line gives of the site kernel beside the usual keys
SITE_KEYS = ("probes", "floor_threads")


def snv_site_numbers(seq: np.ndarray, df, jump: int, flush) -> dict:
    """The SNV site kernel at the shape the SNV path gives it: one launch on
    all the candidates of the contig ``seq``.  The rows the path's own pass
    brings back (flag.snv_site_data) and the kernel's on the same candidates
    are held to the plain version; then the kernel's ms, the plain
    version's, the bytes bound, the probe floor (the probes the function
    needs, from as many threads as the kernel gives the list, its loads in
    flight) and a torch.take gather of as many words."""
    import torch

    from ntedit_tpu_torch.engine import flag
    from ntedit_tpu_torch.ops import gate_kernel, snv_kernel

    n = len(seq) - df.k + 1
    cand_host, path_rows = flag.snv_site_data(seq, df, jump)
    buf = torch.zeros(gate_kernel.padded_len(n), dtype=torch.uint8)
    buf[: len(seq)] = torch.from_numpy(seq.copy())
    seq_dev = buf.to(df.device)
    cand = torch.from_numpy(cand_host).to(df.device)
    g = int(cand.numel())
    if not g:
        raise AssertionError("the contig gave no SNV candidate")
    got = snv_kernel.snv_site_rows(seq_dev, n, cand, df, jump)
    want = snv_kernel.snv_site_rows_plain(seq_dev, n, cand, df, jump)
    diff = int((got != want).any(1).sum())
    path_diff = int((torch.from_numpy(path_rows).to(df.device) != want).any(1).sum())
    err = int((got.long() - want.long()).abs().max())
    if diff or path_diff or err:
        raise AssertionError(f"SNV site kernel differs from plain at the contig shape: "
                             f"{diff} rows, {path_diff} of the path's own")
    sectors, valid, probes = snv_site_probed(seq_dev, n, cand, df, jump)
    # the candidates' list and rows, the 2k bytes of each (overlaps once), the sectors
    seq_bytes = int(torch.clamp(cand[1:] - cand[:-1], max=2 * df.k).sum()) + 2 * df.k
    nbytes = 8 * g + 6 * g + seq_bytes + 32 * sectors
    threads = snv_kernel.SITE_LANES * g
    floor_ms, take_ms = yardsticks(df.table, probes, threads, snv_kernel.SITE_BATCH[df.layout],
                                   flush)
    ms = time_cuda(lambda: snv_kernel.snv_site_rows(seq_dev, n, cand, df, jump), REPS, flush)
    plain_ms = time_cuda(lambda: snv_kernel.snv_site_rows_plain(seq_dev, n, cand, df, jump),
                         1, flush)
    return {"heads": n, "candidates": g, "valid_rows": valid, "jump": jump, "probes": probes,
            "floor_threads": threads, "sectors": sectors, "bytes": nbytes, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms(nbytes), "floor_ms": floor_ms,
            "take_ms": take_ms, "share_of_bound": bound_ms(nbytes) / ms,
            "ms_over_floor": ms / floor_ms, "differing_rows": diff,
            "path_differing_rows": path_diff, "max_abs_err": err}


def covered_bytes(heads, widths, size: int) -> int:
    """Distinct bytes of [h, h + w) over the heads and widths (tensors)."""
    import torch

    marks = torch.zeros(size + 1, dtype=torch.int32, device=heads.device)
    marks.index_add_(0, heads, torch.ones_like(heads, dtype=torch.int32))
    marks.index_add_(0, torch.clamp(heads + widths, max=size),
                     -torch.ones_like(heads, dtype=torch.int32))
    return int((torch.cumsum(marks, 0)[:size] > 0).sum())


def mask_kernel_numbers(seq: np.ndarray, seq_dev, n: int, df, flush) -> dict:
    """The mask kernel at the native path's shape, the contig's gates (one
    launch a contig), bit-exact to its plain version, and the path's masks
    (flag.contig_gates_and_masks, and the replay's
    flag.polish_candidate_masks) to it; its probes (and per informative
    gate), its bytes bound (the gate list, the output, the distinct bytes
    of the windows, the filter sectors it probes once), its probe floor
    (as many random probes from one thread a gate, its loads in flight), a
    torch.take gather of as many words, its plain version's ms."""
    import torch

    from ntedit_tpu_torch.engine import flag
    from ntedit_tpu_torch.ops import snv_kernel

    k = df.k
    host_gates, path_masks = flag.contig_gates_and_masks(seq, df)
    if not np.array_equal(host_gates, flag.flag_contig_gates(seq, df)):
        raise AssertionError("flag.contig_gates_and_masks: gates differ from the gate pass")
    replay_masks = flag.polish_candidate_masks(seq, df, host_gates)
    gates = torch.from_numpy(host_gates).to(seq_dev.device)
    g = int(gates.numel())
    got = snv_kernel.polish_cand_masks(seq_dev, n, gates, df)
    want = snv_kernel.polish_cand_masks_plain(seq_dev, n, gates, df, True)
    diff = int((got != want).sum())
    path_diff = sum(int((torch.from_numpy(m).to(want.device) != want).sum())
                    for m in (path_masks, replay_masks))
    err = int((got.long() - want.long()).abs().max())
    if diff or path_diff or err:
        raise AssertionError(f"mask kernel differs from plain at the contig shape: "
                             f"{diff} masks, {path_diff} of the path's own")
    clean, hashes, probed = snv_kernel.mask_hashes(seq_dev, n, gates, k, True)
    secs, probes = probe_cost(df, torch.cat([x[p] for x, p in zip(hashes, probed)]))
    sectors = int(torch.unique(torch.cat(secs)).numel())
    read = covered_bytes(gates, torch.full_like(gates, k), len(seq))
    nbytes = 8 * g + g + read + 32 * sectors
    floor_ms, take_ms = yardsticks(df.table, probes, g, snv_kernel.MASK_BATCH, flush)
    ms = time_cuda(lambda: snv_kernel.polish_cand_masks(seq_dev, n, gates, df), REPS, flush)
    plain_ms = time_cuda(lambda: snv_kernel.polish_cand_masks_plain(seq_dev, n, gates, df, True),
                         1, flush)
    informative = int(clean.sum())
    return {"gates": g, "informative": informative, "probes": probes,
            "probes_per_informative_gate": probes / max(informative, 1),
            "loads_in_flight": snv_kernel.MASK_BATCH, "sectors": sectors, "bytes": nbytes,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms(nbytes), "floor_ms": floor_ms,
            "take_ms": take_ms, "share_of_bound": bound_ms(nbytes) / ms,
            "ms_over_floor": ms / floor_ms, "differing_masks": diff,
            "path_differing_masks": path_diff, "max_abs_err": err}


def polish_kernel_numbers(seq: np.ndarray, host_bf, jump: int) -> dict:
    """The polish kernels at the shapes the main path gives them, on the
    30 Mbp contig: the site-row kernel on its first 2^22-head chunk's gates
    (one launch a chunk on the path), the mask kernel on all its gates (one
    launch a contig on the native path: mask_kernel_numbers).  The rows
    against their plain version, with the path's own rows
    (flag.iter_polish_site_chunks) held to it too; then ms (CUDA events, L2
    flushed), the plain version's ms, the bytes bound (the gate list, the
    output, every distinct byte read, the filter sectors probed once), the
    probe floor (as many random probes from as many threads, the kernel's
    loads in flight) and a torch.take gather of as many words."""
    import torch

    from ntedit_tpu_torch.core import bloom
    from ntedit_tpu_torch.engine import flag
    from ntedit_tpu_torch.ops import gate_kernel, snv_kernel

    dev = torch.device("cuda")
    df = bloom.DeviceFilter.from_host(host_bf, dev)
    flush = flush_buffer()
    k = df.k
    n = len(seq) - k + 1
    buf = torch.zeros(gate_kernel.padded_len(n), dtype=torch.uint8)
    buf[: len(seq)] = torch.from_numpy(seq.copy())
    seq_dev = buf.to(dev)
    out = {"layout": df.layout, "heads": n, "jump": jump}

    # site rows: the first chunk's gates
    m = min(flag.DEFAULT_CHUNK, n)
    gates = flag.positions_on_device(gate_kernel.gate_words(seq_dev, m, df))
    _, path_gates, path_rows = next(flag.iter_polish_site_chunks(seq, df, jump))
    got = snv_kernel.polish_site_rows(seq_dev, n, gates, df, jump)
    want = snv_kernel.polish_site_rows_plain(seq_dev, n, gates, df, jump)
    diff = int((got != want).any(1).sum())
    path_diff = int(not np.array_equal(path_gates, gates.cpu().numpy())) or int(
        (torch.from_numpy(path_rows).to(dev) != want).any(1).sum())
    err = int((got.long() - want.long()).abs().max())
    if diff or path_diff or err:
        raise AssertionError(f"polish site kernel differs from plain at the chunk shape: "
                             f"{diff} rows, {path_diff} of the path's own")
    g = int(gates.numel())
    starts = gates[snv_kernel.cluster_starts(gates)]
    sectors, valid, probes = snv_site_probed(seq_dev, n, starts, df, jump)
    valid_starts = starts[want[snv_kernel.cluster_starts(gates), 0] & 1 == 1]
    read = covered_bytes(torch.cat([gates, valid_starts]),
                         torch.cat([torch.full_like(gates, k), torch.full_like(valid_starts, 2 * k)]),
                         len(seq))
    nbytes = 8 * g + 6 * g + read + 32 * sectors
    # the threads on rows: each block's listed rows times its lanes a row
    per_block = torch.bincount(torch.nonzero(want[:, 0] & 1 == 1).squeeze(1)
                               // snv_kernel.POLISH_GATES).tolist()
    lanes = [snv_kernel.polish_lanes(c) for c in per_block]
    threads = max(sum(rt * c for rt, c in zip(lanes, per_block)), 1)
    floor_ms, take_ms = yardsticks(df.table, probes, threads, snv_kernel.SITE_BATCH[df.layout],
                                   flush)
    ms = time_cuda(lambda: snv_kernel.polish_site_rows(seq_dev, n, gates, df, jump), REPS, flush)
    plain_ms = time_cuda(lambda: snv_kernel.polish_site_rows_plain(seq_dev, n, gates, df, jump),
                         1, flush)
    out["site_rows"] = {
        "chunk_heads": m, "gates": g, "cluster_starts": int(starts.numel()), "valid_rows": valid,
        "exact_gates": int((want[:, 0] & 32 != 0).sum()), "probes": probes, "sectors": sectors,
        "floor_threads": threads, "bytes": nbytes, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": bound_ms(nbytes), "floor_ms": floor_ms, "take_ms": take_ms,
        "share_of_bound": bound_ms(nbytes) / ms, "ms_over_floor": ms / floor_ms,
        "differing_rows": diff, "path_differing_rows": path_diff, "max_abs_err": err}

    # candidate masks: every gate of the contig
    out["cand_masks"] = mask_kernel_numbers(seq, seq_dev, n, df, flush)
    del df, flush
    torch.cuda.empty_cache()
    return out


def phase_numbers(power: str) -> dict:
    """The gate pass at the main path's chunk shape (2^22 heads, k=25)
    with the filters of a 50 Mbp assembly (256 MiB blocked), for the
    blocked, plain and counting layouts, and the SNV candidate pass for the
    first two."""
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
    draft = simulate.decorate(draft[:L], np.random.default_rng(33), 2, 20, 2000)
    buf = torch.zeros(gate_kernel.padded_len(n), dtype=torch.uint8)
    buf[:L] = torch.from_numpy(draft.copy())
    seq_dev = buf.to(dev)
    flush = flush_buffer()
    rows = {}
    snv_rows = {}
    for name, hf in simulate.chunk_filters(truth, k, GENOME).items():
        df = bloom.DeviceFilter.from_host(hf, dev)
        p = 3 if name == "counting" else 1
        got = gate_kernel.gate_words(seq_dev, n, df, False, p)
        want = gate_kernel.gate_words_plain(seq_dev, n, df, False, p)
        diff = int((got != want).sum())
        err = int(((got.long() & 0xFFFFFFFF) - (want.long() & 0xFFFFFFFF)).abs().max())
        if diff or err:
            raise AssertionError(f"{name}: kernel differs from plain at the chunk shape")
        ms = time_cuda(lambda: gate_kernel.gate_words(seq_dev, n, df, False, p), REPS, flush)
        plain_ms = time_cuda(lambda: gate_kernel.gate_words_plain(seq_dev, n, df, False, p),
                             3, flush)
        sectors, live, probes = probed_sectors(seq_dev, n, df, p)
        nbytes = L + 4 * (-(-n // 32)) + 32 * sectors
        table = df.table
        # the floor: as many random probes of this table as the kernel
        # issues, from as many threads, checked against its Python version
        threads = -(-n // 32)
        floor_words = gate_kernel.probe_floor(table, probes, threads).cpu().numpy()
        host_table = table.cpu().numpy()
        for tid in (0, threads // 2, threads - 1):
            want_word = gate_kernel.probe_floor_word(host_table, probes, threads, tid)
            if int(floor_words[tid]) & 0xFFFFFFFF != want_word:
                raise AssertionError(f"{name}: probe floor word {tid} differs from its plain version")
        del host_table
        floor_ms = time_cuda(lambda: gate_kernel.probe_floor(table, probes, threads), REPS, flush)
        idx = torch.randint(0, table.numel(), (n,), device=dev)
        take_ms = time_cuda(lambda: torch.take(table, idx), 10, flush)
        if name != "counting":
            snv_rows[name] = snv_cand_numbers(seq_dev, n, L, df, flush)
        rows[name] = {"heads": n, "live_heads": live, "probes": probes,
                      "ms": ms, "plain_ms": plain_ms, "take_ms": take_ms, "floor_ms": floor_ms,
                      "sectors": sectors, "bytes": nbytes, "bound_ms": bound_ms(nbytes),
                      "share_of_bound": bound_ms(nbytes) / ms, "ms_over_floor": ms / floor_ms,
                      "differing_words": diff, "max_abs_err": err,
                      "filter_bytes": hf.bytes}
        del df, table, idx
        torch.cuda.empty_cache()
    return {"phase": "numbers", "power_limit": power, "layouts": rows, "snv": snv_rows,
            "max_memory_allocated": torch.cuda.max_memory_allocated()}


# ---------------------------------------------------------------------------
# phase 7: numbers of the filter-build kernels, on phase 6's reads
# ---------------------------------------------------------------------------

def count_numbers(seqs: list, k: int, h: int, slots: int, want, flush) -> dict:
    """The count pass: each kernel on the first batch (partition, apply, the
    two with the scan: ``kmer_count``) and the whole pass, against its plain
    versions (``want``: the plain version's counts of the whole pass), its
    bounds and floors."""
    import torch

    from ntedit_tpu_torch.core import nthash as nt
    from ntedit_tpu_torch.ops import build_kernel as bk

    dev = flush.device
    seq0, n0 = seqs[0]
    table = torch.zeros(-(-slots // 4) * 4, dtype=torch.uint8, device=dev)
    bins = bk.Bins(slots, h, max(n for _, n in seqs), dev)

    def whole_pass():
        for seq, n in seqs:
            bk.kmer_count(seq, n, k, h, table, slots, bins)

    whole_pass()
    differing = int((table != want).sum())
    # the first batch's bins against the plain partition's, as multisets
    bk.kmer_partition(seq0, n0, k, bins)
    plain_bins = bk.Bins(slots, h, n0, dev)
    bk.kmer_partition_plain(seq0, n0, k, plain_bins)
    cells = bins.cells()
    same_bins = torch.equal(bins.counts[:cells], plain_bins.counts[:cells]) and torch.equal(
        torch.sort(bk.bin_slots(bins)).values, torch.sort(bk.bin_slots(plain_bins)).values)
    differing += 0 if same_bins else 1
    entries = int(bins.ends[cells - 1])
    can = bk.valid_hashes(seq0, n0, k)
    sectors = int(torch.unique(torch.cat([nt.umod(x, slots) for x in nt.extend(can, k, h)])
                               >> 5).numel())
    zero = table.zero_
    ms = {"partition": time_cuda(lambda: bk.kmer_partition(seq0, n0, k, bins), REPS, flush),
          "apply": time_cuda(lambda: bk.kmer_count_apply(bins, table), REPS, flush, zero),
          "plain_apply": time_cuda(lambda: bk.kmer_count_apply_plain(bins, table), 2, flush,
                                   zero),
          "plain_partition": time_cuda(lambda: bk.kmer_partition_plain(seq0, n0, k, plain_bins),
                                       2, flush),
          "count": time_cuda(lambda: bk.kmer_count(seq0, n0, k, h, table, slots, bins), REPS,
                             flush, zero),
          "plain_count": time_cuda(lambda: bk.kmer_count_plain(seq0, n0, k, h, table, slots), 2,
                                   flush, zero),
          "pass": time_cuda(whole_pass, REPS, flush, zero)}
    # floors: the apply's atomics, random in the table's bytes and in one slice's
    threads = -(-entries // bk.APPLY_CHUNK) * 256
    floors = {}
    for name, nbytes in (("table", -(-slots // 4) * 4), ("slice", min(slots, 1 << bins.slice_bits))):
        t = torch.zeros(max(1, nbytes // 4), dtype=torch.int32, device=dev)
        floors[name] = time_cuda(lambda: bk.atomic_floor(t, entries, threads), REPS, flush)
        if int(t.sum()) != entries * (REPS + 1):
            raise AssertionError("the atomic floor lost an add")
        del t
    cell_bytes = 12 * cells  # the count matrix and its scan
    part_bytes = n0 + k - 1 + 4 * entries + cell_bytes
    apply_bytes = 4 * entries + cell_bytes + 2 * 32 * sectors
    count_bytes = n0 + k - 1 + 2 * 32 * sectors  # the count's bound: the function's bytes
    return {
        "slots": slots, "slice_bits": bins.slice_bits, "slices": bins.n_slices,
        "scratch_bytes": bins.nbytes, "windows": n0, "increments": entries, "sectors": sectors,
        "differing": differing,
        "partition": {"ms": ms["partition"], "plain_ms": ms["plain_partition"],
                      "bytes": part_bytes, "bound_ms": bound_ms(part_bytes),
                      "floor_ms": copy_ms(part_bytes, flush), "floor": "device copy of its bytes"},
        "apply": {"ms": ms["apply"], "plain_ms": ms["plain_apply"], "bytes": apply_bytes,
                  "bound_ms": bound_ms(apply_bytes), "floor_ms": floors["slice"],
                  "floor_table_ms": floors["table"],
                  "floor": "random atomicAdd, one slice's bytes"},
        "count": {"ms": ms["count"], "plain_ms": ms["plain_count"], "bytes": count_bytes,
                  "bound_ms": bound_ms(count_bytes), "floor_ms": floors["table"],
                  "pass_ms": ms["pass"], "batches": len(seqs)},
    }


def insert_numbers(seqs: list, k: int, h: int, cutoff: int, counters, slots: int, nw: int,
                   flush) -> dict:
    """The insert pass at ``cutoff`` into ``nw`` blocked words, reading the
    whole build's ``counters``: the solid bits and the insert of each batch
    against their plain versions; the pass (solid bits, then every batch)
    against its bound, and per batch (the pass over its launches); the
    insert kernel alone on the first batch against the probe floor on the
    solid bits and on the counters."""
    import torch

    from ntedit_tpu_torch.core import nthash as nt
    from ntedit_tpu_torch.ops import build_kernel as bk
    from ntedit_tpu_torch.ops import gate_kernel

    dev = flush.device
    seq0, n0 = seqs[0]
    words = torch.zeros(nw, dtype=torch.int32, device=dev)
    want = torch.zeros_like(words)
    for seq, n in seqs:
        bk.kmer_insert_plain(seq, n, k, h, want, "blocked", nw, counters, slots, cutoff)
    solid = bk.kmer_solid_bits(counters, slots, cutoff)
    differing = int((solid != bk.kmer_solid_bits_plain(counters, slots, cutoff)).sum())
    for seq, n in seqs:
        bk.kmer_insert(seq, n, k, h, words, "blocked", nw, solid, slots)
    differing += int((words != want).sum())
    one = torch.zeros_like(words)
    bk.kmer_insert(seq0, n0, k, h, one, "blocked", nw, solid, slots)
    one_want = torch.zeros_like(words)
    bk.kmer_insert_bits_plain(seq0, n0, k, h, one_want, "blocked", nw, solid, slots)
    differing += int((one != one_want).sum())
    # the bound of the pass: every batch's ASCII, each counter sector its
    # probes touch and each word sector it writes, once
    c_touched = torch.zeros(-(-slots // 32), dtype=torch.bool, device=dev)
    w_touched = torch.zeros(-(-nw // 8), dtype=torch.bool, device=dev)
    ascii_bytes = probes0 = valid0 = b_sectors0 = w_sectors0 = 0
    for i, (seq, n) in enumerate(seqs):
        ascii_bytes += n + k - 1
        can = bk.valid_hashes(seq, n, k)
        idx = [nt.umod(x, slots) for x in nt.extend(can, k, h)]
        for s in idx:
            c_touched[s >> 5] = True
        ok = bk.min_count(can, k, h, counters, slots).long() >= cutoff
        w_touched[(can[ok] & (nw - 1)) >> 3] = True
        if i == 0:
            valid0, probes0 = int(can.numel()), h * int(can.numel())
            b_sectors0 = int(torch.unique(torch.cat(idx) >> 8).numel())
            w_sectors0 = int(torch.unique((can[ok] & (nw - 1)) >> 3).numel())
    pass_bytes = ascii_bytes + 32 * int(c_touched.sum()) + 2 * 32 * int(w_touched.sum())
    del c_touched, w_touched
    zero = words.zero_

    def whole_pass():
        s = bk.kmer_solid_bits(counters, slots, cutoff)
        for seq, n in seqs:
            bk.kmer_insert(seq, n, k, h, words, "blocked", nw, s, slots)

    ms = {"pass": time_cuda(whole_pass, REPS, flush, zero),
          "solid_bits": time_cuda(lambda: bk.kmer_solid_bits(counters, slots, cutoff), REPS,
                                  flush),
          "insert": time_cuda(lambda: bk.kmer_insert(seq0, n0, k, h, words, "blocked", nw, solid,
                                                     slots), REPS, flush, zero),
          "plain_solid_bits": time_cuda(lambda: bk.kmer_solid_bits_plain(counters, slots, cutoff),
                                        2, flush),
          "plain_insert": time_cuda(lambda: bk.kmer_insert_bits_plain(
              seq0, n0, k, h, words, "blocked", nw, solid, slots), 2, flush, zero),
          "plain_pass": time_cuda(lambda: [bk.kmer_insert_plain(
              seq, n, k, h, words, "blocked", nw, counters, slots, cutoff) for seq, n in seqs],
              1, flush, zero)}
    threads = -(-n0 // 32)
    floor_bits = time_cuda(lambda: gate_kernel.probe_floor(solid, probes0, threads, 4), REPS,
                           flush)
    floor_counters = time_cuda(lambda: gate_kernel.probe_floor(counters, probes0, threads, 4),
                               REPS, flush)
    solid_bytes = slots + 4 * solid.numel()
    one_bytes = n0 + k - 1 + 32 * b_sectors0 + 2 * 32 * w_sectors0
    return {
        "slots": slots, "words": nw, "cutoff": cutoff, "batches": len(seqs), "valid": valid0,
        "probes": probes0, "differing": differing, "solid_bytes": 4 * solid.numel(),
        "solid_bits": {"ms": ms["solid_bits"], "plain_ms": ms["plain_solid_bits"],
                       "bytes": solid_bytes, "bound_ms": bound_ms(solid_bytes),
                       "floor_ms": copy_ms(solid_bytes, flush), "floor": "device copy of its bytes"},
        "insert": {"ms": ms["insert"], "plain_ms": ms["plain_insert"], "bytes": one_bytes,
                   "bound_ms": bound_ms(one_bytes), "floor_ms": floor_bits,
                   "floor_counters_ms": floor_counters,
                   "floor": "random probes of the solid bits, 4 in flight"},
        "pass": {"ms": ms["pass"], "ms_per_batch": ms["pass"] / len(seqs),
                 "plain_ms": ms["plain_pass"], "bytes": pass_bytes,
                 "bound_ms": bound_ms(pass_bytes),
                 "floor_ms": ms["solid_bits"] + len(seqs) * floor_bits},
    }


def hashes_numbers(seqs: list, k: int, flush) -> dict:
    """The hashes kernel on the first batch (the call, with its read of the
    totals, at s = 0 and s = 1) and the histogram's whole pass, against the
    plain version, the bytes bound and a copy of those bytes."""
    from ntedit_tpu_torch.core import bfbuild
    from ntedit_tpu_torch.ops import build_kernel as bk

    seq0, n0 = seqs[0]
    differing = 0
    for s in (0, 1):
        got, valid = bk.kmer_valid_hashes(seq0, n0, k, s)
        want, want_valid = bk.kmer_valid_hashes_plain(seq0, n0, k, s)
        differing += int(not got.equal(want)) + int(valid != want_valid)
    emitted = int(bk.valid_hashes(seq0, n0, k).numel())

    def hist(valid_hashes):
        kept = bfbuild.SampledHashes(1 << 26)
        for seq, n in seqs:
            s = kept.s
            kept.add(*valid_hashes(seq, n, s), s)
        return kept.histogram(k)

    def this_pass():
        return hist(lambda seq, n, s: bk.kmer_valid_hashes(seq, n, k, s))

    want_hist = hist(lambda seq, n, s: bk.kmer_valid_hashes_plain(seq, n, k, s))
    got_hist = this_pass()
    differing += int((got_hist.f1, got_hist.f0) != (want_hist.f1, want_hist.f0)
                     or not np.array_equal(got_hist.spectrum, want_hist.spectrum))
    nbytes = n0 + k - 1 + 8 * emitted
    out = {"windows": n0, "valid": emitted, "batches": len(seqs), "differing": differing,
           "bytes": nbytes, "bound_ms": bound_ms(nbytes), "floor_ms": copy_ms(nbytes, flush),
           "floor": "device copy of its bytes",
           "plain_ms": time_cuda(lambda: bk.kmer_valid_hashes_plain(seq0, n0, k), 2, flush),
           "ms": time_cuda(lambda: bk.kmer_valid_hashes(seq0, n0, k), REPS, flush),
           "sampled_ms": time_cuda(lambda: bk.kmer_valid_hashes(seq0, n0, k, 1), REPS, flush),
           "pass_ms": time_cuda(this_pass, REPS, flush)}
    if differing:
        raise AssertionError(f"the hashes kernel differs from its plain version: {out}")
    return out


def build_numbers(seqs: list, k: int, hash_num: int, cutoff: int, counters: np.ndarray,
                  nw: int, flush) -> dict:
    """hashes_numbers, count_numbers and insert_numbers on the reads'
    batches ``seqs`` with polish --reads' k, hashes and cutoff, at the
    tables it sized for them (the plain build's ``counters``, ``nw`` blocked
    words); raises when a kernel differs from its plain version."""
    import torch

    slots = len(counters)
    want = torch.zeros(-(-slots // 4) * 4, dtype=torch.uint8, device=flush.device)
    want[:slots] = torch.from_numpy(counters)
    out = {"kmer_valid_hashes": hashes_numbers(seqs, k, flush),
           "count": count_numbers(seqs, k, hash_num, slots, want, flush),
           "insert": insert_numbers(seqs, k, hash_num, cutoff, want, slots, nw, flush)}
    if out["count"]["differing"] or out["insert"]["differing"]:
        raise AssertionError(f"a build kernel differs from its plain version: {out}")
    return out


# ---------------------------------------------------------------------------
# phase 9: the mesh programs and the multi-host engine
# ---------------------------------------------------------------------------

MESH_BITS = 1 << 31   # the sharded read filter: 256 MiB of words
MESH_SLOTS = 1 << 29  # the sharded count table: 512 MiB of counters
REDUCE_D = 4          # the ranks the reduce is timed for


def reduce_cases():
    """(rows int32, rows uint8) of the reduce's grid: D in {1, 2, 3, 4, 8};
    widths 1 to 70 elements, so tails of 1 to 15 bytes past the 16-byte
    vectors; zero, all-ones and random words; counters at 0, 1, 128, 254 and
    255 and random; eight rows of 40 (320 saturates)."""
    rng = np.random.default_rng(990)
    edges = np.array([0, 1, 128, 254, 255], dtype=np.uint8)
    for d in (1, 2, 3, 4, 8):
        for m in range(1, 71):
            words = rng.integers(-2**31, 2**31, size=(d, m)).astype(np.int32)
            words[0, : m // 3] = 0
            words[-1, m // 2 :] = -1
            counts = edges[rng.integers(0, 5, size=(d, m))]
            counts[:, ::4] = rng.integers(0, 256, size=counts[:, ::4].shape)
            yield words, counts
        yield np.zeros((d, 64), np.int32), np.full((d, 64), 40, dtype=np.uint8)


def check_reduce() -> dict:
    """Both reduce kernels against their plain versions, bit for bit, on the
    grid, on rows with 16-byte vectors and on views one element in (4- and
    1-byte vectors)."""
    import torch

    from ntedit_tpu_torch.ops import mesh_kernel as mk

    cases = differing = err = 0
    for words, counts in reduce_cases():
        for host, fn, plain in ((words, mk.or_rows, mk.or_rows_plain),
                                (counts, mk.sat_add_rows, mk.sat_add_rows_plain)):
            rows = torch.from_numpy(host).cuda()
            wide = torch.from_numpy(np.pad(host, ((0, 0), (1, 0)))).cuda()[:, 1:]
            want = plain(rows)
            for view in (rows, wide):
                got = fn(view)
                torch.cuda.synchronize()
                cases += 1
                differing += int(not torch.equal(got, want))
                err = max(err, int((got.long() - want.long()).abs().max()))
    if differing:
        raise AssertionError(f"reduce kernels: {differing} of {cases} cases differ from plain")
    return {"cases": cases, "differing": differing, "max_abs_err": err}


def reduce_numbers(flush) -> dict:
    """Each reduce at the shape the collective at D = 4 gives it, one rank's
    rows [4, size / 4] of a 256 MiB filter's words and of a 512 MiB count
    table: ms (CUDA events, L2 flushed), the plain version's, the bytes
    bound ((D + 1) x m x elt at the HBM rate) and, for the OR,
    torch.Tensor.bitwise_or_ chained over the rows (no one PyTorch call
    computes the saturating sum)."""
    import torch

    from ntedit_tpu_torch.ops import mesh_kernel as mk

    dev = torch.device("cuda")
    out = {}
    for name, fn, plain, size, dtype in (
            ("or_rows", mk.or_rows, mk.or_rows_plain, MESH_BITS // 8, torch.int32),
            ("sat_add_rows", mk.sat_add_rows, mk.sat_add_rows_plain, MESH_SLOTS, torch.uint8)):
        m = size // dtype.itemsize // REDUCE_D
        low, high = (-2**31, 2**31 - 1) if dtype == torch.int32 else (0, 256)
        rows = torch.randint(low, high, (REDUCE_D, m), dtype=dtype, device=dev)
        got = fn(rows)
        want = plain(rows)
        err = int((got.long() - want.long()).abs().max())
        if err:
            raise AssertionError(f"{name} differs from its plain version at the timed shape")
        row = {"rows": REDUCE_D, "m": m, "bytes": (REDUCE_D + 1) * m * dtype.itemsize,
               "ms": time_cuda(lambda: fn(rows), REPS, flush),
               "plain_ms": time_cuda(lambda: plain(rows), 10, flush), "max_abs_err": err}
        row["bound_ms"] = bound_ms(row["bytes"])
        row["share_of_bound"] = row["bound_ms"] / row["ms"]
        row["library_ms"] = None
        if name == "or_rows":
            acc = torch.empty(m, dtype=dtype, device=dev)

            def chained():
                torch.bitwise_or(rows[0], rows[1], out=acc)
                for r in rows[2:]:
                    acc.bitwise_or_(r)

            row["library_ms"] = time_cuda(chained, REPS, flush)
        out[name] = row
        del rows, got, want
    return out


def read_rows(paths: list, length: int) -> np.ndarray:
    """The reads of ``paths`` (all ``length`` bases) as rows uint8 [R, length],
    by the batch reader."""
    from ntedit_tpu_torch.io import native

    parts = []
    for p in paths:
        for seq, offs, _, _ in native.read_batches(p, want_headers=False):
            if np.any(np.diff(offs) != length):
                raise AssertionError(f"{p}: a read is not {length} bases")
            parts.append(seq)
    return np.concatenate(parts).reshape(-1, length)


def joined_on_card(rows: np.ndarray, k: int) -> tuple:
    """All rows joined with a 0x00 byte after each, in one buffer on the
    card laid out for the kernels, and its windows."""
    import torch

    from ntedit_tpu_torch.ops import gate_kernel

    joined = np.zeros((rows.shape[0], rows.shape[1] + 1), dtype=np.uint8)
    joined[:, :-1] = rows
    n = joined.size - k + 1
    buf = torch.zeros(gate_kernel.padded_len(n), dtype=torch.uint8)
    buf[: joined.size] = torch.from_numpy(joined.reshape(-1))
    return buf.cuda(), n


def kernel_event_ms(run) -> tuple:
    """(run's result, ms by kernel wrapper): ``run()`` with CUDA events on
    the current stream around each call of the build and reduce kernels'
    wrappers (the partition and the apply, not kmer_count, which calls
    them), summed per wrapper after a synchronisation."""
    import torch

    from ntedit_tpu_torch.ops import build_kernel, mesh_kernel

    events = []
    real = {(mod, name): getattr(mod, name) for mod, name in (
        (build_kernel, "kmer_insert"), (build_kernel, "kmer_partition"),
        (build_kernel, "kmer_count_apply"), (mesh_kernel, "or_rows"),
        (mesh_kernel, "sat_add_rows"))}

    def timed(name, fn):
        def call(*args, **kwargs):
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            res = fn(*args, **kwargs)
            b.record()
            events.append((name, a, b))
            return res
        call.launches = fn.launches  # the wrapper counts on the name it is called by
        return call

    for (mod, name), fn in real.items():
        setattr(mod, name, timed(name, fn))
    try:
        got = run()
        torch.cuda.synchronize()
    finally:
        for (mod, name), fn in real.items():
            fn.launches = getattr(mod, name).launches
            setattr(mod, name, fn)
    ms: dict = {}
    for name, a, b in events:
        ms[name] = ms.get(name, 0.0) + a.elapsed_time(b)
    return got, ms


def sharded_builds(mesh, rows: np.ndarray, k: int) -> dict:
    """sharded_bf_build into a 2^31-bit plain filter and sharded_cbf_build
    into 2^29 counters, each held to one kmer_insert / kmer_count over all
    the reads joined in one buffer; the launch counts set to 0 just before
    each and read just after.  One untimed collective first, where NCCL
    makes its communicator (``nccl_setup_s``); each build's wall beside
    its kernels' summed device ms (``kernels_ms``: CUDA events around each
    kernel call of a second build, kernel_event_ms)."""
    import torch
    import torch.distributed as dist

    from ntedit_tpu_torch.ops import build_kernel as bk
    from ntedit_tpu_torch.parallel import mesh as pmesh

    t0 = time.perf_counter()
    dist.all_reduce(torch.zeros(1, device=mesh.device), group=mesh.group)
    torch.cuda.synchronize()
    out = {"nccl_setup_s": time.perf_counter() - t0}
    seq, n = joined_on_card(rows, k)
    for name, run, reference in (
            ("bf", lambda: pmesh.sharded_bf_build(mesh, rows, k, 3, MESH_BITS),
             lambda t: bk.kmer_insert(seq, n, k, 3, t, "plain", MESH_BITS)),
            ("cbf", lambda: pmesh.sharded_cbf_build(mesh, rows, k, 3, MESH_SLOTS),
             lambda t: bk.kmer_count(seq, n, k, 3, t, MESH_SLOTS))):
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        got = run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = kernel_launches()
        want = (torch.zeros(MESH_BITS // 32, dtype=torch.int32, device=seq.device) if name == "bf"
                else torch.zeros(MESH_SLOTS, dtype=torch.uint8, device=seq.device))
        reference(want)
        same = torch.equal(got, want)
        del got
        got, kernels_ms = kernel_event_ms(run)
        out[name] = {"wall_s": wall, "launches": launches, "equals_single_build": same,
                     "set": int(torch.count_nonzero(got)), "kernels_ms": kernels_ms}
        if not same or not torch.equal(got, want):
            raise AssertionError(f"sharded {name} build differs from the single build")
        del got, want
        torch.cuda.empty_cache()
    if min(out["bf"]["launches"]["kmer_insert"], out["bf"]["launches"]["or_rows"],
           out["cbf"]["launches"]["kmer_count_apply"],
           out["cbf"]["launches"]["sat_add_rows"]) <= 0:
        raise AssertionError(f"a sharded build never launched its kernels: {out}")
    return out


def sharded_polish_run(tag: str, work: str, mesh, host_bf, draft_path: str, ref_prefix: str,
                       cfg, cand: bool = False) -> dict:
    """parallel.mesh.sharded_polish over every contig of the draft (its
    default repair threads), rendered by the command line's writers and
    held to the host-only scan at ``ref_prefix``; then Polisher.polish (-t 8)
    over the same contigs, its wall beside."""
    import torch

    from ntedit_tpu_torch.core import bloom
    from ntedit_tpu_torch.engine.polish import Polisher
    from ntedit_tpu_torch.io import fastx, writers
    from ntedit_tpu_torch.parallel import mesh as pmesh

    recs = [r for r in fastx.read_fastx(draft_path) if len(r.seq) >= cfg.min_contig_len]
    table = bloom.DeviceFilter.from_host(host_bf, mesh.device).table
    prefix = os.path.join(work, tag)
    before = os.environ.get("NTEDIT_TPU_CAND")
    os.environ["NTEDIT_TPU_CAND"] = "1" if cand else "0"
    try:
        reset_launches()
        t0 = time.perf_counter()
        results = [pmesh.sharded_polish(mesh, r.header, r.seq, host_bf, table, cfg) for r in recs]
        wall = time.perf_counter() - t0
        launches = kernel_launches()
    finally:
        if before is None:
            del os.environ["NTEDIT_TPU_CAND"]
        else:
            os.environ["NTEDIT_TPU_CAND"] = before
    with open(prefix + "_edited.fa", "w") as dfout, \
         open(prefix + "_changes.tsv", "w") as rfout, \
         open(prefix + "_variants.vcf", "w") as vfout:
        rfout.write(writers.changes_tsv_header(cfg.k, cfg.jump, False))
        vfout.write(writers.vcf_header(draft_path))
        for res in results:
            writers.write_contig(res, dfout, rfout, vfout, {}, snv=cfg.snv)
    same = _same_outputs(prefix, ref_prefix)
    pol = Polisher(host_bf, None, dataclasses.replace(cfg, threads=8), device="cuda")
    t0 = time.perf_counter()
    n = len(list(pol.polish((r.header, r.seq) for r in recs)))
    polisher_s = time.perf_counter() - t0
    del table
    torch.cuda.empty_cache()
    out = {"wall_s": wall, "polisher_wall_s": polisher_s, "contigs": n,
           "gate_launches": launches["gate_words"],
           "cand_launches": _cand_launches(launches),
           "mask_launches": launches["polish_cand_masks"],
           "gather_ranks": mesh.size, "byte_identical": same}
    if not all(same.values()):
        raise AssertionError(f"{tag}: outputs differ from the host-only full scan: {same}")
    kernel = "snv_cand_words" if cfg.snv else "gate_words"
    if (_cand_launches(launches) if cfg.snv else launches[kernel]) <= 0 or (
            cand and launches["polish_cand_masks"] <= 0):
        raise AssertionError(f"{tag}: a kernel of the sharded polish never launched: {launches}")
    return out


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


RANK_LINE = re.compile(r"\[rank (\d+)\] (\d+) contigs, ([\d,]+) bp in ([\d.]+)s")


def multihost_engine(work: str, bf_path: str, draft_path: str, ref_prefix: str) -> dict:
    """``python -m ntedit_tpu_torch engine -t 4`` as two processes sharing the
    card (NTEDIT_TPU_COORDINATOR at a free port: records over gloo), rank 0's
    merged files held to the host-only scan; each rank's contigs, bases and
    wall, and the bases' imbalance (process_slice splits by contig count)."""
    prefix = os.path.join(work, "multihost")
    port = free_port()
    procs = []
    t0 = time.perf_counter()
    try:
        for rank in range(2):
            env = dict(os.environ, PYTHONPATH=HERE + os.pathsep + os.environ.get("PYTHONPATH", ""),
                       NTEDIT_TPU_COORDINATOR=f"127.0.0.1:{port}", NTEDIT_TPU_NUM_PROCESSES="2",
                       NTEDIT_TPU_PROCESS_ID=str(rank))
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "ntedit_tpu_torch", "engine", "-r", bf_path, "-f",
                 draft_path, "-b", prefix, "-t", "4"], cwd=HERE, env=env,
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        logs = [p.communicate(timeout=600)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    wall = time.perf_counter() - t0
    for p, log in zip(procs, logs):
        if p.returncode != 0:
            raise AssertionError(f"multi-host engine rank failed ({p.returncode}):\n{log[-4000:]}")
    ranks = []
    for log in logs:
        m = RANK_LINE.search(log)
        if m is None:
            raise AssertionError(f"no rank line in:\n{log[-4000:]}")
        head = re.search(r"\[rank \d+/2\] contigs \[(\d+), (\d+)\) of (\d+)", log)
        ranks.append({"rank": int(m.group(1)), "contigs": int(m.group(2)),
                      "bp": int(m.group(3).replace(",", "")), "wall_s": float(m.group(4)),
                      "slice": [int(head.group(1)), int(head.group(2))] if head else None})
    same = _same_outputs(prefix, ref_prefix)
    bp = [r["bp"] for r in ranks]
    out = {"wall_s": wall, "ranks": ranks, "bp_imbalance": max(bp) / max(1, min(bp)),
           "byte_identical": same}
    if not all(same.values()):
        raise AssertionError(f"multi-host engine: outputs differ from the host-only scan: {same}")
    return out


def phase_mesh(work: str) -> dict:
    """The reduce kernels against their plain versions and timed; a world of
    one rank on the card (NCCL): the sharded builds of phase 6's reads, the
    sharded polish of phase 3's draft (blocked, NTEDIT_TPU_CAND=1, plain)
    and of phase 5's reference with -s 1; the multi-host engine as two
    processes sharing the card."""
    import torch
    import torch.distributed as dist

    from ntedit_tpu_torch.core import bloom
    from ntedit_tpu_torch.engine.config import EngineConfig
    from ntedit_tpu_torch.parallel import distributed, mesh as pmesh

    out = {"phase": "mesh", "reduce": check_reduce()}
    flush = flush_buffer()
    out["reduce"]["numbers"] = reduce_numbers(flush)
    del flush
    torch.cuda.empty_cache()
    k = 25
    distributed.initialize(coordinator_address=f"127.0.0.1:{free_port()}", num_processes=1,
                           process_id=0, device="cuda")
    try:
        mesh = pmesh.make_mesh()
        out["world"] = {"ranks": mesh.size, "backend": str(dist.get_backend())}
        t0 = time.perf_counter()
        # phase filter_build's two gzip FASTQ files
        rows = read_rows([os.path.join(work, f"reads_{i}.fq.gz") for i in (1, 2)], READ_LEN)
        out["reads"] = {"rows": int(rows.shape[0]), "read_s": time.perf_counter() - t0}
        out["builds"] = sharded_builds(mesh, rows, k)
        del rows
        cfg = EngineConfig(k=k, hash_num=3, threads=1).validate()
        blk = bloom.load_any(os.path.join(work, "main_blocked.bf"))
        draft = os.path.join(work, "draft50.fa")
        ref = os.path.join(work, "main_blocked_ref")
        out["polish_blocked"] = sharded_polish_run("mesh_blocked", work, mesh, blk, draft, ref,
                                                   cfg)
        out["polish_cand"] = sharded_polish_run("mesh_cand", work, mesh, blk, draft, ref, cfg,
                                                cand=True)
        del blk
        pl = bloom.load_any(os.path.join(work, "main_plain.bf"))
        out["polish_plain"] = sharded_polish_run("mesh_plain", work, mesh, pl, draft,
                                                 os.path.join(work, "main_plain_ref"), cfg)
        del pl
        snv = bloom.load_any(os.path.join(work, "snv_blocked.bf"))
        out["snv_blocked"] = sharded_polish_run(
            "mesh_snv", work, mesh, snv, os.path.join(work, "ref50.fa"),
            os.path.join(work, "snv_blocked_ref"), dataclasses.replace(cfg, snv=True))
        del snv
    finally:
        dist.destroy_process_group()
    torch.cuda.empty_cache()
    out["multihost_engine"] = multihost_engine(work, os.path.join(work, "main_blocked.bf"),
                                               draft, ref)
    return out


# ---------------------------------------------------------------------------

def main(argv=None) -> int:
    import argparse

    import torch

    argparse.ArgumentParser(prog="chip_smoke.py", description=__doc__.split("\n\n")[0]
                            ).parse_args(argv)
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
    phase_s = {}  # seconds of each phase

    def timed(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        phase_s[name] = time.perf_counter() - t0
        return out

    emit(timed("build", phase_build))
    emit(timed("kernel_resources", phase_resources))
    kernel = timed("kernel", phase_kernel)
    emit(kernel)
    main_rows = []
    with tempfile.TemporaryDirectory(prefix="ntedit_smoke_") as work:
        emit(timed("engines", phase_engines, work))
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        for row in timed("main", phase_main, work):
            row["max_memory_allocated"] = torch.cuda.max_memory_allocated()
            main_rows.append(row)
            emit(row)
        for row in timed("counting", phase_counting, work):
            main_rows.append(row)
            emit(row)
        torch.cuda.reset_peak_memory_stats()
        snv_rows = timed("snv", phase_snv, work)
        for row in snv_rows:
            row["max_memory_allocated"] = torch.cuda.max_memory_allocated()
            emit(row)
        build = timed("filter_build", phase_filter_build, work)
        build_kernels = build.pop("kernel_numbers")
        emit(build)
        torch.cuda.empty_cache()
        mesh = timed("mesh", phase_mesh, work)
        emit(mesh)
    torch.cuda.reset_peak_memory_stats()
    numbers = timed("numbers", phase_numbers, power)
    numbers["build"] = build_kernels
    emit(numbers)
    blk = numbers["layouts"]["blocked"]
    differing = kernel["differing_words"] + sum(
        r["differing_words"] for r in numbers["layouts"].values())
    snv_run = snv_rows[0]["runs"][0]  # the 50 Mbp SNV run with site rows
    lines = [{
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
        "floor_ms": blk["floor_ms"],
        "layouts": {name: {key: r[key] for key in ("ms", "bound_ms", "floor_ms", "take_ms",
                                                   "plain_ms")}
                    for name, r in numbers["layouts"].items()},
    }]
    # the candidate kernel at the chunk shape; the site kernel at the contig
    # shape of the SNV runs (30 Mbp blocked, 5 Mbp plain), one launch each
    site_parts = {"blocked": snv_rows[0]["site_kernel"], "plain": snv_rows[1]["site_kernel"]}
    for name, parts, replaces, launches, cases_diff, diff_key in (
            ("snv_cand_words", numbers["snv"], "ntedit_tpu/engine/flag.py:351",
             snv_run["cand_launches"], kernel["cand_differing_words"], "differing_words"),
            ("snv_site_rows", site_parts, "ntedit_tpu/engine/flag.py:425",
             snv_run["site_launches"], kernel["site_differing_rows"], "differing_rows")):
        one = parts["blocked"]
        lines.append({
            "name": name,
            "route": "cuda",
            "source": "ntedit_tpu_torch/csrc/snv_kernel.cu",
            "replaces": replaces,
            "launches": launches,
            "matches_plain": cases_diff + sum(r[diff_key] for r in parts.values()) == 0,
            "max_abs_err": one["max_abs_err"],
            "ms": one["ms"],
            "plain_ms": one["plain_ms"],
            "bound_ms": one["bound_ms"],
            "bound_by": "bytes",
            "library_ms": None,
            "take_ms": one["take_ms"],
            "floor_ms": one["floor_ms"],
            **({key: one[key] for key in SITE_KEYS} if name == "snv_site_rows" else {}),
            "layouts": {layout: {key: r[key] for key in ("ms", "bound_ms", "floor_ms", "take_ms",
                                                         "plain_ms", *SITE_KEYS)
                                 if key in r}
                        for layout, r in parts.items()},
        })
    # the binned candidate pass (blocked filter, dense groups): its kernels
    # on the 30 Mbp contig's first group, launches from the 50 Mbp SNV run;
    # both rows carry the bound of the candidate words they compute together
    binned = snv_rows[0]["binned"]
    for name, part in (("snv_cand_bin", "bin"), ("snv_cand_probe", "probe")):
        one = binned[part]
        lines.append({
            "name": name,
            "route": "cuda",
            "source": "ntedit_tpu_torch/csrc/snv_kernel.cu",
            "replaces": "ntedit_tpu/engine/flag.py:351",
            "launches": snv_run[f"{part}_launches"],
            "matches_plain": kernel["bin_differing"] + binned["differing"] == 0,
            "max_abs_err": binned["max_abs_err"],
            "ms": one["ms"],
            "plain_ms": one["plain_ms"],
            "bound_ms": one["bound_ms"],
            "bound_by": "bytes",
            "library_ms": None,
            "floor_ms": one["floor_ms"],
            "bound_of": "the group's candidate words, both kernels together",
            "design_bytes": one["design_bytes"],
            "pass_share_of_bound": binned["share_of_bound"],
            "heads": binned["heads"],
            "entries": binned["entries"],
            "pass_ms": binned["pass"]["path"],
            "kernel_pass_ms": binned["pass"]["kernel"],
        })
    # the polish kernels: the site rows at the chunk shape of main_blocked's
    # and main_plain's rows-on runs, the masks at the contig shape of the
    # native-engine run, whose launches they take
    for name, key, line, launches, cases_diff, diff_key in (
            ("polish_site_rows", "site_rows", 605,
             main_rows[0]["site_rows"]["site_row_launches"],
             kernel["polish_site_differing_rows"], "differing_rows"),
            ("polish_cand_masks", "cand_masks", 844, main_rows[0]["native"]["mask_launches"],
             kernel["mask_differing"], "differing_masks")):
        parts = {r["polish_kernels"]["layout"]: r["polish_kernels"][key] for r in main_rows[:2]}
        one = parts["blocked"]
        lines.append({
            "name": name,
            "route": "cuda",
            "source": "ntedit_tpu_torch/csrc/snv_kernel.cu",
            "replaces": f"ntedit_tpu/engine/flag.py:{line}",
            "launches": launches,
            "matches_plain": cases_diff + sum(r[diff_key] for r in parts.values()) == 0,
            "max_abs_err": one["max_abs_err"],
            "ms": one["ms"],
            "plain_ms": one["plain_ms"],
            "bound_ms": one["bound_ms"],
            "bound_by": "bytes",
            "library_ms": None,
            "take_ms": one["take_ms"],
            "floor_ms": one["floor_ms"],
            **({key: one[key] for key in SITE_KEYS} if name == "polish_site_rows" else {}),
            **({"form": "gated", **{key: one[key] for key in MASK_KEYS}}
               if name == "polish_cand_masks" else {}),
            "layouts": {layout: {key: r[key] for key in ("ms", "bound_ms", "floor_ms", "take_ms",
                                                         "plain_ms", *SITE_KEYS, *MASK_KEYS)
                                 if key in r}
                        for layout, r in parts.items()},
        })
    # the filter-build kernels: launches from polish --reads, times on its
    # batches at its tables (build_numbers)
    count, insert = build_kernels["count"], build_kernels["insert"]
    hashes = build_kernels["kmer_valid_hashes"]
    build_ok = kernel["build_differing"] == 0  # build_numbers raised on any other difference
    for name, line, one, extra in (
            ("kmer_valid_hashes", 49, hashes,
             {"sampled_ms": hashes["sampled_ms"], "pass_ms": hashes["pass_ms"]}),
            ("kmer_partition", 293, count["partition"],
             {"slice_bits": count["slice_bits"], "scratch_bytes": count["scratch_bytes"],
              "count_ms": count["count"]["ms"], "count_bound_ms": count["count"]["bound_ms"],
              "count_pass_ms": count["count"]["pass_ms"]}),
            ("kmer_count_apply", 293, count["apply"], {"floor_table_ms": count["apply"]["floor_table_ms"]}),
            ("kmer_solid_bits", 319, insert["solid_bits"], {}),
            ("kmer_insert", 319, insert["insert"],
             {"pass_ms": insert["pass"]["ms"], "pass_ms_per_batch": insert["pass"]["ms_per_batch"],
              "pass_bound_ms": insert["pass"]["bound_ms"],
              "floor_counters_ms": insert["insert"]["floor_counters_ms"]})):
        lines.append({
            "name": name,
            "route": "cuda",
            "source": "ntedit_tpu_torch/csrc/build_kernel.cu",
            "replaces": f"ntedit_tpu/core/bfbuild.py:{line}",
            "launches": build["polish_reads"]["launches"][name],
            "matches_plain": build_ok,
            "max_abs_err": {"kmer_valid_hashes": hashes, "kmer_partition": count,
                            "kmer_count_apply": count}.get(name, insert)["differing"],
            "ms": one["ms"],
            "plain_ms": one["plain_ms"],
            "bound_ms": one["bound_ms"],
            "bound_by": "bytes",
            "library_ms": None,
            "floor_ms": one["floor_ms"],
            **extra,
        })
    # the collectives' reduce: launches from the world-of-one sharded
    # builds, times at the shape the collective at D = 4 gives it
    for name, line, build_name in (("or_rows", 58, "bf"), ("sat_add_rows", 78, "cbf")):
        one = mesh["reduce"]["numbers"][name]
        lines.append({
            "name": name,
            "route": "cuda",
            "source": "ntedit_tpu_torch/csrc/mesh_kernel.cu",
            "replaces": f"ntedit_tpu/parallel/mesh.py:{line}",
            "launches": mesh["builds"][build_name]["launches"][name],
            "matches_plain": mesh["reduce"]["differing"] == 0,
            "max_abs_err": max(one["max_abs_err"], mesh["reduce"]["max_abs_err"]),
            "ms": one["ms"],
            "plain_ms": one["plain_ms"],
            "bound_ms": one["bound_ms"],
            "bound_by": "bytes",
            "library_ms": one["library_ms"],
            "rows": one["rows"],
            "m": one["m"],
        })
    emit({"kernels": lines, "power_limit": power, "seconds": time.perf_counter() - t_start,
          "phase_s": phase_s})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
