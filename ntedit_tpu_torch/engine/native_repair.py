"""ctypes binding of the native sparse-repair engine (csrc/repair.cpp).

The engine consumes the device's gate hints and performs the exact
sequential scan-and-repair of the reference at native speed; its output is
rebuilt into a ``ContigResult`` (contig buffer with substitutions/masks
applied, RopeCells node stream for indels, SubRec list) for the writers.

The binding builds the port's copy of ``native/repair.cpp``,
``csrc/repair.cpp``, with g++ into the port's own build directory
(utils/build.py), with the flags of native/Makefile, and raises when the
build or the load fails.  The copy builds its tables once (the original
rebuilds them on every call until one has finished, which races), so
calls may start from many threads at once, with any k.
"""

from __future__ import annotations

import ctypes
import os
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

import numpy as np

from ntedit_tpu_torch.core import bloom
from ntedit_tpu_torch.engine.config import EngineConfig
from ntedit_tpu_torch.engine.records import ContigResult, RopeCells, SubRec
from ntedit_tpu_torch.utils import profiling
from ntedit_tpu_torch.utils.build import build_library, host_cpu

SOURCE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                      "csrc", "repair.cpp")

_lib = None


class _NtrFilter(ctypes.Structure):
    _fields_ = [
        ("kind", ctypes.c_int32),
        ("hash_num", ctypes.c_int32),
        ("data", ctypes.c_void_p),
        ("nbytes", ctypes.c_uint64),
    ]


class _NtrParams(ctypes.Structure):
    _fields_ = [
        ("k", ctypes.c_int32),
        ("jump", ctypes.c_int32),
        ("mode", ctypes.c_int32),
        ("max_insertions", ctypes.c_int32),
        ("max_deletions", ctypes.c_int32),
        ("min_threshold", ctypes.c_int32),
        ("max_threshold", ctypes.c_int32),
        ("insertion_cap", ctypes.c_int32),
        ("snv", ctypes.c_int32),
        ("mask", ctypes.c_int32),
        ("missing_needed", ctypes.c_double),
        ("present_needed", ctypes.c_double),
        ("present_needed_deletion", ctypes.c_double),
        ("rope_compat", ctypes.c_int32),
    ]


def _command(src: str, out: str) -> list:
    # native/Makefile: CXXFLAGS and the libntedit_repair.so rule
    return ["g++", "-O3", "-march=native", "-std=c++17", "-Wall", "-shared", "-fPIC",
            "-o", out, src]


def get_lib():
    """Load the native repair library, building it on first use."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build_library("ntedit_repair", SOURCE, _command, salt=host_cpu()))
        lib.ntr_polish_contig.restype = ctypes.c_int64
        lib.ntr_polish_contig.argtypes = [
            ctypes.c_void_p, ctypes.c_int64,              # contig, L
            ctypes.c_void_p, ctypes.c_int64,              # gates, n_gates
            ctypes.POINTER(_NtrFilter), ctypes.POINTER(_NtrFilter),
            ctypes.POINTER(_NtrParams),
            ctypes.c_void_p, ctypes.c_int64, ctypes.POINTER(ctypes.c_int64),
            ctypes.c_void_p, ctypes.c_int64, ctypes.POINTER(ctypes.c_int64),
        ]
        # the same call with two more arrays parallel to the gates:
        # gate_cand (uint8 per gate) and site_rows (uint8[6] per gate),
        # both from ops/snv_kernel.py
        lib.ntr_polish_contig_v2.restype = ctypes.c_int64
        lib.ntr_polish_contig_v2.argtypes = (
            lib.ntr_polish_contig.argtypes + [ctypes.c_void_p, ctypes.c_void_p])
        _lib = lib
    return _lib


def _filter_desc(bf) -> tuple:
    """Host filter -> (C descriptor, backing array).  Callers keep the
    array referenced across the native call."""
    if isinstance(bf, bloom.BlockedKmerBloomFilter):
        arr, kind = bf.words, 1
    elif isinstance(bf, bloom.KmerCountingBloomFilter8):
        arr, kind = bf.counters, 2
    elif isinstance(bf, bloom.KmerBloomFilter):
        arr, kind = bf.data, 0
    else:
        raise TypeError(f"not a k-mer filter: {type(bf).__name__}")
    arr = np.ascontiguousarray(arr)
    return _NtrFilter(
        kind=kind, hash_num=bf.hash_num,
        data=arr.ctypes.data_as(ctypes.c_void_p).value, nbytes=arr.nbytes,
    ), arr


def _filters_of(host_bloom, host_bloomrep) -> tuple:
    bf_struct, bf_keep = _filter_desc(host_bloom)
    rep_struct = rep_keep = None
    if host_bloomrep is not None:
        rep_struct, rep_keep = _filter_desc(host_bloomrep)
    return bf_struct, rep_struct, (bf_keep, rep_keep)


def _params_of(cfg: EngineConfig) -> _NtrParams:
    return _NtrParams(
        k=cfg.k, jump=cfg.jump, mode=cfg.mode,
        max_insertions=cfg.max_insertions, max_deletions=cfg.max_deletions,
        min_threshold=cfg.min_threshold, max_threshold=cfg.max_threshold,
        insertion_cap=cfg.insertion_cap,
        snv=int(cfg.snv), mask=int(cfg.mask),
        missing_needed=float(cfg.missing_needed),
        present_needed=float(cfg.present_needed),
        present_needed_deletion=float(cfg.present_needed_deletion),
        rope_compat=int(cfg.rope_compat),
    )


def _parallel(arr, gates, width: int, what: str):
    """``arr`` as a contiguous uint8 array parallel to ``gates`` (``width``
    bytes per gate, 0 for one byte), or None; raises when it is not."""
    if arr is None:
        return None
    n_gates = 0 if gates is None else len(gates)
    want = (n_gates, width) if width else (n_gates,)
    if gates is None or arr.shape != want:
        raise ValueError(f"{what} {arr.shape} are not parallel to {n_gates} gates")
    return np.ascontiguousarray(arr, dtype=np.uint8)


def _run_raw(lib, contig: np.ndarray, pristine: bytes, gates, bf_struct,
             rep_struct, params, gate_cand=None, site_rows=None):
    """One ntr_polish_contig call with capacity retries, its gates
    counted into ``engine.gates``.

    ``gate_cand``: uint8 [n_gates] candidate masks parallel to ``gates``
    (flag.polish_candidate_masks), or None.  ``site_rows``: uint8
    [n_gates, 6] rows parallel to ``gates`` (flag.snv_site_data,
    flag.iter_polish_site_chunks), or None.  The engine consumes both
    instead of probing, with the same output.

    ``contig`` is modified in place (it may be a view into a shared
    whole-contig buffer); every retry restores it from ``pristine`` first —
    the engine applies substitutions/masks before a capacity retcode can
    surface.  Returns (subs [N,10] int64, nodes [M,4] int64) or None.
    ctypes releases the GIL for the call, so segment runs parallelize."""
    L = contig.size
    if gates is not None:
        gates = np.ascontiguousarray(gates, dtype=np.int64)
        gates_ptr = gates.ctypes.data_as(ctypes.c_void_p).value
        n_gates = gates.size
    else:
        gates_ptr, n_gates = None, 0
    gate_cand = _parallel(gate_cand, gates, 0, "candidate masks")
    site_rows = _parallel(site_rows, gates, 6, "site rows")
    profiling.count("engine.gates", n_gates)
    extra = None
    if gate_cand is not None or site_rows is not None:
        extra = [None if a is None else a.ctypes.data_as(ctypes.c_void_p).value
                 for a in (gate_cand, site_rows)]
    subs_cap = max(4096, L // 64)
    nodes_cap = max(4096, L // 64)
    first = True
    while True:
        if not first:
            contig[:] = np.frombuffer(pristine, dtype=np.uint8)
        first = False
        subs_buf = np.empty(subs_cap * 10, dtype=np.int64)
        nodes_buf = np.empty(nodes_cap * 4, dtype=np.int64)
        n_subs = ctypes.c_int64(0)
        n_nodes = ctypes.c_int64(0)
        args = [
            contig.ctypes.data_as(ctypes.c_void_p).value, L,
            gates_ptr, n_gates,
            ctypes.byref(bf_struct),
            ctypes.byref(rep_struct) if rep_struct is not None else None,
            ctypes.byref(params),
            subs_buf.ctypes.data_as(ctypes.c_void_p).value, subs_cap,
            ctypes.byref(n_subs),
            nodes_buf.ctypes.data_as(ctypes.c_void_p).value, nodes_cap,
            ctypes.byref(n_nodes),
        ]
        if extra is not None:
            rc = lib.ntr_polish_contig_v2(*args, *extra)
        else:
            rc = lib.ntr_polish_contig(*args)
        if rc == -2:
            subs_cap *= 4
            continue
        if rc == -3:
            nodes_cap *= 4
            continue
        if rc != 0:
            return None
        return (
            subs_buf[: n_subs.value * 10].reshape(-1, 10),
            nodes_buf[: n_nodes.value * 4].reshape(-1, 4),
        )


def _subs_of(sb: np.ndarray, offset: int = 0) -> list:
    return [
        SubRec(
            pos=int(r[0]) + offset, draft_char=int(r[1]), sub_base=int(r[2]),
            num_support=int(r[3]),
            altbase1=int(r[4]), altsupp1=int(r[5]),
            altbase2=int(r[6]), altsupp2=int(r[7]),
            altbase3=int(r[8]), altsupp3=int(r[9]),
        )
        for r in sb
    ]


def _append_nodes(nodes: list, nb: np.ndarray, offset: int = 0) -> int:
    """Raw [M,4] node rows -> RopeCells node list entries (span coords
    shifted by ``offset``).  Returns the cell count appended."""
    total = 0
    for kind, a, b, sup in nb:
        if kind == 0:
            nodes.append(["span", int(a) + offset, int(b) + offset, int(sup)])
            total += int(b) - int(a) + 1
        else:
            # ins cell [-1, char, ins_sup, span_sup]
            nodes.append(["ins", [-1, int(a), int(sup), int(b)]])
            total += 1
    return total


def _result(header: str, contig: np.ndarray, sb: np.ndarray, nb: np.ndarray) -> ContigResult:
    nodes = []
    total = _append_nodes(nodes, nb)
    return ContigResult(header, bytearray(contig.tobytes()), RopeCells(total, nodes),
                        _subs_of(sb))


def _whole_contig(lib, header: str, seq_bytes: bytes, gates, bf_struct, rep_struct, params,
                  gate_cand=None, site_rows=None) -> Optional[ContigResult]:
    """One native call over a whole contig (the span ``engine.repair``):
    its ContigResult, or None when the engine reports an error."""
    contig = np.frombuffer(seq_bytes, dtype=np.uint8).copy()
    with profiling.span("engine.repair"):
        out = _run_raw(lib, contig, seq_bytes, gates, bf_struct, rep_struct, params,
                       gate_cand, site_rows=site_rows)
    return None if out is None else _result(header, contig, *out)


def polish_contig_native(
    host_bloom,
    host_bloomrep,
    cfg: EngineConfig,
    header: str,
    seq: bytes | np.ndarray,
    gate_hint: Optional[np.ndarray] = None,
    site_rows: Optional[np.ndarray] = None,
    gate_cand: Optional[np.ndarray] = None,
) -> Optional[ContigResult]:
    """Run the native engine on one whole contig; with no ``gate_hint`` it
    scans every head (the full sequential scan).  ``site_rows`` and
    ``gate_cand`` are parallel to ``gate_hint`` (see _run_raw).  Returns
    None when the engine reports an error."""
    lib = get_lib()
    bf_struct, rep_struct, _keep = _filters_of(host_bloom, host_bloomrep)
    params = _params_of(cfg.validate())
    return _whole_contig(lib, header, bytes(seq), gate_hint, bf_struct, rep_struct, params,
                         gate_cand, site_rows)


# ---------------------------------------------------------------------------
# Segmented parallel repair: gate runs far enough apart are independent
# (the reference's only engine parallelism is contigs, ntedit.cpp:2213-2250;
# segment parallelism is the single-contig analogue and is exact — see the
# overflow guard below).
# ---------------------------------------------------------------------------


def _gap_margin(cfg) -> tuple:
    """(gap, margin): a gap of > ``gap`` gate-free heads between
    consecutive gates means the dense pass proved the region clean against
    ORIGINAL content; an edit's influence (content change + re-gate reach
    + trial lookahead) cannot cross it, so the scan state on the far side
    is exactly the fresh-seed state.  ``margin`` is the per-segment
    activity bound checked by the overflow guard: a segment whose records
    all lie at or before its last gate + ``margin`` is exact.

    SNV mode (``cfg.snv``, validated: i = d = 0; the callers pass no mask)
    has a reach of its own, from csrc/repair.cpp.  The rope never changes
    shape, and the engine writes only in place at a visited head h's site
    h + k - 1, each write a record (make_edit type 1), so the guard sees
    every write.  A write at site t sets dirty_until = t + 1, and the scan
    visits every head up to t (gate or not); past a bucket's last gate g a
    visited head therefore lies at or before the furthest record.  A
    visited head reads to h + 2k - 1 (fix_site rolls its window k times,
    and each alternate's verify rolls k times from the same head; a site
    row stands for the same reads).  So with every record at or before
    g + margin, every read lies below g + margin + 2k, the slice's end:
    gap = margin + 2k.
    The margin is where the guard trips: 2k - 2 holds every record one
    substitution at g's site can bring (it re-visits the heads up to
    g + k - 1, whose sites reach g + 2k - 2), so a trip takes a second
    substitution among those heads and a record past it."""
    if cfg.snv:
        margin = 2 * cfg.k - 2
        return margin + 2 * cfg.k, margin
    gap = 4 * cfg.k + cfg.insertion_cap + cfg.max_deletions + 32
    margin = gap - 2 * cfg.k - cfg.max_deletions - 2
    return gap, margin


def _seg_runner(lib, contig, seq_bytes, bf_struct, rep_struct, params, margin):
    """Closure running one segment: (lo, hi, abs_gates[, masks, rows]) ->
    (sb, nb) raw arrays, "overflow" when activity reaches the right margin,
    or None on engine failure.  Each run is the span ``engine.repair`` in
    the worker thread that runs it, with the ids of the span open where the
    closure is made (the contig's)."""
    ids = profiling.ids()

    def run(lo: int, hi: int, seg_gates_abs: np.ndarray, seg_cand=None, seg_rows=None):
        view = contig[lo:hi]
        pristine = seq_bytes[lo:hi]
        with profiling.span("engine.repair", **ids):
            out = _run_raw(lib, view, pristine, seg_gates_abs - lo, bf_struct,
                           rep_struct, params, seg_cand, site_rows=seg_rows)
        if out is None:
            return None
        sb, nb = out
        # overflow guard: activity must stay left of the margin
        limit = int(seg_gates_abs[-1]) - lo + margin
        if len(sb) and int(sb[:, 0].max()) > limit:
            return "overflow"
        if len(nb):
            last = nb[-1]
            if not (last[0] == 0 and int(last[2]) == hi - lo - 1
                    and int(last[1]) <= limit):
                return "overflow"
        return sb, nb

    return run


def _finish_segments(lib, header, seq_bytes, contig, all_gates, bf_struct,
                     rep_struct, params, bounds, results, gate_cand=None, site_rows=None):
    """Handle overflow/failure fallbacks, then stitch segment results.  An
    overflow reruns the whole contig in one call (with ``gate_cand`` and
    ``site_rows``, parallel to ``all_gates``), counted into
    ``engine.segment_fallbacks``."""
    L = len(seq_bytes)
    if any(r is None for r in results):
        return None
    if any(isinstance(r, str) for r in results):
        # pathological cascade: exact fallback to the sequential whole run
        profiling.count("engine.segment_fallbacks", 1)
        return _whole_contig(lib, header, seq_bytes, all_gates, bf_struct, rep_struct, params,
                             gate_cand, site_rows)

    # stitch: inter-segment clean spans + per-segment node streams (writers
    # merge coordinate-contiguous spans, so seam splits are render-equal)
    subs = []
    nodes = []
    total = 0
    cursor = 0
    for (lo, hi), (sb, nb) in zip(bounds, results):
        if lo > cursor:
            nodes.append(["span", cursor, lo - 1, 0])
            total += lo - cursor
        subs.extend(_subs_of(sb, offset=lo))
        total += _append_nodes(nodes, nb, offset=lo)
        cursor = hi
    if cursor < L:
        nodes.append(["span", cursor, L - 1, 0])
        total += L - cursor
    return ContigResult(header, bytearray(contig.tobytes()), RopeCells(total, nodes), subs)


def _bucket_bounds(gates: np.ndarray, cfg, n_buckets: int) -> tuple:
    """Group gates into <= n_buckets contiguous buckets cut only at quiet
    gaps (> gap gate-free heads), balanced by gate count.  One native call
    per bucket: within a bucket the engine fast-forwards across internal
    gaps exactly like the whole-contig run, so only bucket BOUNDARIES need
    the independence argument (and the trailing overflow guard).

    Returns (idx_bounds, margin): idx_bounds is a list of (i0, i1) gate
    index ranges."""
    gap, margin = _gap_margin(cfg)
    n = len(gates)
    cuts = np.nonzero(np.diff(gates) > gap)[0] + 1  # legal cut indices
    if n_buckets <= 1 or not len(cuts):
        return [(0, n)], margin
    targets = n * np.arange(1, n_buckets) / n_buckets
    chosen = sorted({int(cuts[np.abs(cuts - t).argmin()]) for t in targets})
    edges = [0] + chosen + [n]
    return [
        (edges[i], edges[i + 1])
        for i in range(len(edges) - 1)
        if edges[i + 1] > edges[i]
    ], margin


def polish_contig_segmented(
    host_bloom,
    host_bloomrep,
    cfg: EngineConfig,
    header: str,
    seq: bytes | np.ndarray,
    gates: np.ndarray,
    threads: int = 4,
    allow_snv: bool = False,
    site_rows: Optional[np.ndarray] = None,
    gate_cand: Optional[np.ndarray] = None,
) -> Optional[ContigResult]:
    """Parallel exact repair from a complete gate list: independent
    gate-run segments in threads.

    Output is identical to the sequential native scan: segments are cut
    only across gate-free gaps wider than any edit's influence, each
    segment's repair is the sequential engine on its slice, and an
    overflow guard falls back to the whole-contig sequential run if a
    segment's activity ever reaches its right margin.  Returns None when
    the engine reports an error.

    ``allow_snv``: SNV mode gates every head, so cutting at gaps between
    hints is only sound when the hints are the CANDIDATE set
    (flag.snv_candidate_positions: heads between candidates are provably
    no-ops); the Polisher sets this after checking eligibility, and an SNV
    run without it raises.  ``site_rows`` and ``gate_cand``: rows and
    candidate masks parallel to ``gates`` (see _run_raw)."""
    if cfg.snv and not allow_snv:
        raise ValueError("raw SNV gates every head: there are no quiet gaps to cut at")
    lib = get_lib()
    bf_struct, rep_struct, _keep = _filters_of(host_bloom, host_bloomrep)
    cfg = cfg.validate()
    params = _params_of(cfg)
    seq_bytes = bytes(seq)
    L = len(seq_bytes)
    gates = np.ascontiguousarray(gates, dtype=np.int64)
    if not len(gates):
        return ContigResult(header, bytearray(seq_bytes), RopeCells(L), [])
    site_rows = _parallel(site_rows, gates, 6, "site rows")
    gate_cand = _parallel(gate_cand, gates, 0, "candidate masks")

    gap, _ = _gap_margin(cfg)
    idx_bounds, margin = _bucket_bounds(gates, cfg, n_buckets=4 * threads)
    if len(idx_bounds) == 1 or threads <= 1:
        profiling.count("engine.segments", 1)
        return _whole_contig(lib, header, seq_bytes, gates, bf_struct, rep_struct, params,
                             gate_cand, site_rows)

    contig = np.frombuffer(seq_bytes, dtype=np.uint8).copy()
    runner = _seg_runner(lib, contig, seq_bytes, bf_struct, rep_struct, params, margin)
    jobs = []
    for i0, i1 in idx_bounds:
        lo = int(gates[i0])
        hi = int(min(L, gates[i1 - 1] + gap))
        jobs.append((lo, hi, gates[i0:i1],
                     gate_cand[i0:i1] if gate_cand is not None else None,
                     site_rows[i0:i1] if site_rows is not None else None))
    profiling.count("engine.segments", len(jobs))
    with ThreadPoolExecutor(max_workers=min(threads, len(jobs))) as ex:
        results = list(ex.map(lambda j: runner(*j), jobs))
    return _finish_segments(
        lib, header, seq_bytes, contig, gates, bf_struct, rep_struct, params,
        [(j[0], j[1]) for j in jobs], results, gate_cand, site_rows,
    )


def polish_contig_pipelined(
    host_bloom,
    host_bloomrep,
    cfg: EngineConfig,
    header: str,
    seq: bytes | np.ndarray,
    gate_chunks,
    threads: int = 4,
    collect_gates: Optional[list] = None,
) -> Optional[ContigResult]:
    """Segmented repair overlapped with the streaming dense pass.

    ``gate_chunks`` yields (frontier, abs_gates) with every head <
    frontier final (flag.iter_gate_chunks), or (frontier, abs_gates, rows)
    with uint8 [len(gates), 6] rows parallel to the gates
    (flag.iter_polish_site_chunks), which travel with their gates into the
    segments.  Segments whose closing quiet gap is confirmed are submitted
    to the repair pool immediately, so the host repairs chunk i while the
    device still computes chunk i+1's gates; each bucket handed to the pool
    is one native call, counted into ``engine.segments``.  Output is
    identical to the sequential scan.

    ``collect_gates``: optional list the consumed gate arrays are appended
    to, so a caller can reuse the dense pass as a hint if this engine
    returns None after the stream was (partially) drained."""
    if cfg.snv:
        raise ValueError("the streamed repair cuts at quiet gaps, which raw SNV gates do "
                         "not have: SNV candidates go to polish_contig_segmented")
    lib = get_lib()
    bf_struct, rep_struct, _keep = _filters_of(host_bloom, host_bloomrep)
    cfg = cfg.validate()
    params = _params_of(cfg)
    seq_bytes = bytes(seq)
    L = len(seq_bytes)
    gap, margin = _gap_margin(cfg)
    contig = np.frombuffer(seq_bytes, dtype=np.uint8).copy()
    runner = _seg_runner(lib, contig, seq_bytes, bf_struct, rep_struct,
                         params, margin)

    # closed segments accumulate into a bucket; one native call per bucket
    # (few large calls, not thousands of tiny ones) sized so ~2 buckets per
    # thread stay in flight against typical gate densities.  A bucket is a
    # run of consecutive closed segments, so it is a slice of the stream.
    bucket_budget = 16384
    gbuf = np.empty(0, dtype=np.int64)  # gates not yet assigned to a segment
    rbuf = None                         # their rows, when the stream has rows
    bucket = []                         # closed gate runs awaiting submit
    bucket_rows = []
    bucket_n = 0
    chunks = []                         # all gate arrays (fallback replay)
    bounds = []
    futures = []
    with ThreadPoolExecutor(max_workers=max(1, threads)) as ex:

        def add(lo_i: int, hi_i: int):
            nonlocal bucket_n
            bucket.append(gbuf[lo_i:hi_i])
            bucket_rows.append(None if rbuf is None else rbuf[lo_i:hi_i])
            bucket_n += hi_i - lo_i

        def submit_bucket():
            nonlocal bucket, bucket_rows, bucket_n
            if not bucket:
                return
            bgates = np.concatenate(bucket)
            brows = None if bucket_rows[0] is None else np.concatenate(bucket_rows)
            lo = int(bgates[0])
            hi = int(min(L, bgates[-1] + gap))
            bounds.append((lo, hi))
            profiling.count("engine.segments", 1)
            futures.append(ex.submit(runner, lo, hi, bgates, None, brows))
            bucket = []
            bucket_rows = []
            bucket_n = 0

        stream = iter(gate_chunks)
        while True:
            with profiling.span("engine.gates"):  # the wait for the device's next chunk
                item = next(stream, None)
            if item is None:
                break
            frontier, g = item[0], np.asarray(item[1], dtype=np.int64)
            chunks.append(g)
            if collect_gates is not None:
                collect_gates.append(g)
            gbuf = np.concatenate([gbuf, g])
            if len(item) > 2:
                if len(item[2]) != len(g):
                    raise ValueError(f"{len(item[2])} rows for {len(g)} gates")
                rbuf = item[2] if rbuf is None else np.concatenate([rbuf, item[2]])
            elif rbuf is not None:
                raise ValueError("a chunk without rows in a stream with rows")
            if not len(gbuf):
                continue
            # the groups of gates closed by a confirmed trailing quiet gap
            # (> gap before the next group's first gate AND before the
            # frontier) end at these indices of gbuf
            ends = np.nonzero(np.diff(gbuf) > gap)[0] + 1
            if int(gbuf[-1]) + gap < frontier:
                ends = np.append(ends, len(gbuf))
            if not len(ends):
                continue
            # a bucket is submitted at the first group end that fills it
            pos = 0
            while True:
                i = int(np.searchsorted(ends, pos + bucket_budget - bucket_n))
                if i == len(ends):
                    break
                add(pos, int(ends[i]))
                submit_bucket()
                pos = int(ends[i])
            closed = int(ends[-1])
            if pos < closed:
                add(pos, closed)
            gbuf = gbuf[closed:]
            rbuf = None if rbuf is None else rbuf[closed:]
        if len(gbuf):
            add(0, len(gbuf))
        submit_bucket()
        results = [f.result() for f in futures]

    all_gates = (
        np.concatenate(chunks) if chunks else np.empty(0, dtype=np.int64)
    )
    if not len(all_gates):
        return ContigResult(header, bytearray(seq_bytes), RopeCells(L), [])
    return _finish_segments(
        lib, header, seq_bytes, contig, all_gates, bf_struct, rep_struct,
        params, bounds, results,
    )
