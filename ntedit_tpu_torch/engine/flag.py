"""Dense passes: the device side of the polish and SNV paths.

For every window head of a draft contig the gate kernel
(ops/gate_kernel.py) computes the reference's absence gate
``snv || !contains || (counting && count < p)`` (ntedit.cpp:1806-1807)
on valid windows, plus a forced gate on windows that hold an accepted
IUPAC byte, packed to little-endian uint32 words.  The contig uploads once
as ASCII; the gate words stream back chunk by chunk so the host repair can
start on chunk i while the device still computes chunk i+1.

In SNV mode every head is gated, so the device computes which heads can
matter instead (ops/snv_kernel.py): the candidate heads, where some
alternate base's k-mer is in the filter, and optionally each candidate's
site row, the probe results the host engine would otherwise gather itself.

Polish mode has two such optional passes (ops/snv_kernel.py): site rows
parallel to each chunk's gates (iter_polish_site_chunks), and the
substitution-candidate masks of a whole contig's gates: with the gates in
one pass over the contig on the card (contig_gates_and_masks), or from
gates the caller holds (polish_candidate_masks).

Every contig upload goes through ``_upload`` and counts in ``uploads``.

The SNV passes record two spans (utils/profiling.py): ``engine.snv_pass``,
the host's side of the device pass (the upload, the candidate words, the
compaction, whose ``torch.nonzero`` waits for the words, and the site-row
kernel, enqueued), and ``engine.download``, the wait until the candidates
and rows are on the host.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Iterator, Optional

import numpy as np
import torch

from ntedit_tpu_torch.ops import gate_kernel, snv_kernel
from ntedit_tpu_torch.utils import profiling

# heads per streamed chunk (a multiple of the kernel's 8192-head tile)
DEFAULT_CHUNK = 1 << 22
# bytes of entries the binned SNV candidate pass keeps at a time: it bins
# the probes of as many whole chunks as fit (7 chunks of 2^22 heads), so
# each filter slice is probed by many chunks' heads while it sits in L2
BIN_BUDGET = 1 << 30


def _effective_chunk(n: int, chunk: int) -> int:
    """Smallest power-of-two chunk >= n, clamped to [2^15, chunk]: a short
    contig is one small chunk, a long one streams in ``chunk``-head
    pieces."""
    c = 1 << 15
    while c < n and c < chunk:
        c <<= 1
    return min(c, chunk)


def packed_to_positions(words: np.ndarray, n: int) -> np.ndarray:
    """Little-endian packed gate words -> sorted gate head positions < n.
    Gates are sparse (~0.1-3% of heads): touch only the nonzero words."""
    nzw = np.nonzero(words)[0]
    if not len(nzw):
        return np.zeros(0, dtype=np.int64)
    sub = np.unpackbits(
        words[nzw].view(np.uint8), bitorder="little"
    ).reshape(-1, 32)
    rows, cols = np.nonzero(sub)
    g = nzw[rows].astype(np.int64) * 32 + cols
    return g[g < n]


def _staged(seq: np.ndarray, size: int, pin: bool) -> torch.Tensor:
    """The contig's ASCII bytes zero-padded to ``size`` in a host tensor."""
    buf = torch.zeros(size, dtype=torch.uint8, pin_memory=pin)
    buf.numpy()[: len(seq)] = seq
    return buf


uploads = 0  # contig uploads since the last reset (chip_smoke.py reads it)
_uploads_lock = threading.Lock()


def _upload(seq: np.ndarray, size: int, device) -> tuple:
    """(the contig zero-padded to ``size`` bytes on ``device``, its host
    staging buffer): one copy on the current stream, from pinned memory
    without blocking on CUDA, so the staging buffer must outlive it."""
    global uploads
    cuda = device.type == "cuda"
    staged = _staged(seq, size, pin=cuda)
    dev_seq = staged.to(device, non_blocking=cuda)
    with _uploads_lock:
        uploads += 1
    return dev_seq, staged


def _iter_chunks(seq: np.ndarray, df, snv: bool, min_threshold: int, chunk: int,
                 stream, jump: Optional[int]) -> Iterator[tuple]:
    """iter_gate_chunks, and with ``jump`` the polish rows of each chunk's
    gates as a third element."""
    k = df.k
    if k > gate_kernel.MAX_K:
        raise ValueError(f"the gate pass supports k <= {gate_kernel.MAX_K}, got k={k}")
    L = len(seq)
    n = L - k + 1
    if n <= 0:
        return
    chunk = _effective_chunk(n, chunk)
    starts = range(0, n, chunk)
    size = gate_kernel.padded_len(n)
    if df.device.type != "cuda":
        host, _ = _upload(seq, size, df.device)
        for start in starts:
            m = min(chunk, n - start)
            words = gate_kernel.gate_words(host[start:], m, df, snv, min_threshold)
            gates = packed_to_positions(words.cpu().numpy().view(np.uint32), m) + start
            if jump is None:
                yield start + m, gates
            else:
                rows = snv_kernel.polish_site_rows(host, n, torch.from_numpy(gates), df, jump)
                yield start + m, gates, rows.numpy()
        return
    if stream is None:
        stream = torch.cuda.Stream(df.device)
    words_host = torch.empty(-(-n // 32), dtype=torch.int32, pin_memory=True)
    with torch.cuda.stream(stream):
        dev_seq, staged = _upload(seq, size, df.device)
        launched = [(start, min(chunk, n - start),
                     gate_kernel.gate_words(dev_seq[start:], min(chunk, n - start), df, snv,
                                            min_threshold))
                    for start in starts]

    def drain(start, m, words):
        """Queue a chunk's words (and its rows) back to the host; its event
        marks them there."""
        with torch.cuda.stream(stream):
            dst = words_host[start // 32 : start // 32 + words.numel()]
            dst.copy_(words, non_blocking=True)
            rows_host = rows = None
            if jump is not None:
                # the compaction waits for the stream so far; the rows of
                # this chunk's gates come back beside its words
                rows = snv_kernel.polish_site_rows(
                    dev_seq, n, positions_on_device(words) + start, df, jump)
                rows_host = torch.empty(rows.shape, dtype=torch.uint8, pin_memory=True)
                rows_host.copy_(rows, non_blocking=True)
            done = torch.cuda.Event()
            done.record(stream)
        return dst, rows_host, rows, done

    # without rows every chunk drains up front; with rows the next chunk's
    # compaction and rows are queued before a chunk is yielded, so the card
    # computes them while the host repairs this one
    pending = [drain(*c) for c in (launched if jump is None else launched[:1])]
    for i, (start, m, _words) in enumerate(launched):
        if len(pending) <= i + 1 < len(launched):
            pending.append(drain(*launched[i + 1]))
        dst, rows_host, _rows, done = pending[i]
        done.synchronize()
        gates = packed_to_positions(dst.numpy().view(np.uint32), m) + start
        if jump is None:
            yield start + m, gates
        else:
            yield start + m, gates, rows_host.numpy()


def iter_gate_chunks(
    seq: np.ndarray,
    df,
    snv: bool = False,
    min_threshold: int = 1,
    chunk: int = DEFAULT_CHUNK,
    stream: Optional["torch.cuda.Stream"] = None,
) -> Iterator[tuple]:
    """Stream gate positions per chunk: yields (frontier, gates) where
    ``gates`` are ABSOLUTE head positions < ``frontier`` and every head
    < frontier has now been reported; frontiers strictly increase.

    On CUDA the contig uploads once, every chunk's kernel is launched up
    front on ``stream`` (a new one when None), and each chunk's words are
    copied without blocking into a pinned host buffer with one event per
    chunk; the chunks then drain in order.  On the CPU each chunk runs the
    plain version when it is consumed."""
    return _iter_chunks(seq, df, snv, min_threshold, chunk, stream, None)


def iter_polish_site_chunks(
    seq: np.ndarray,
    df,
    jump: int,
    chunk: int = DEFAULT_CHUNK,
    stream: Optional["torch.cuda.Stream"] = None,
) -> Iterator[tuple]:
    """The polish gate stream with per-gate rows: yields (frontier, gates,
    rows), the gates of iter_gate_chunks (polish mode) and uint8
    [len(gates), 6] rows parallel to them (ops/snv_kernel.py
    polish_site_rows): flags bit 5 on every gate whose window holds no
    accepted IUPAC byte, and at cluster starts with a valid row its flags
    bits 0-4, check_missing and verify counts, which the engine consumes at
    pristine windows instead of probing.  Needs a blocked or plain filter.

    On CUDA every chunk's gate kernel is launched up front; then chunk by
    chunk its gates are compacted on the card (a synchronisation), the row
    kernel runs on them, and the rows are copied back beside the gate
    words.  Chunk i+1's compaction and rows are queued before chunk i is
    yielded, so the card computes them while the host repairs chunk i."""
    return _iter_chunks(seq, df, False, 1, chunk, stream, jump)


def flag_contig_gates(
    seq: np.ndarray,
    df,
    snv: bool = False,
    min_threshold: int = 1,
    chunk: int = DEFAULT_CHUNK,
) -> np.ndarray:
    """Gate head positions for one contig: every chunk of iter_gate_chunks,
    concatenated."""
    parts = [g for _, g in iter_gate_chunks(seq, df, snv, min_threshold, chunk)]
    return np.concatenate(parts) if parts else np.zeros(0, dtype=np.int64)


def positions_on_device(words: torch.Tensor) -> torch.Tensor:
    """Little-endian packed words -> sorted int64 bit positions, on the
    words' device; touches only the nonzero words."""
    nz = torch.nonzero(words).squeeze(1)
    lanes = torch.arange(32, dtype=torch.int32, device=words.device)
    rows, cols = torch.nonzero((words[nz, None] >> lanes) & 1, as_tuple=True)
    return nz[rows] * 32 + cols


def _snv_candidates(seq: np.ndarray, df, chunk: int, bins=None) -> tuple:
    """(contig on the device, its sorted candidate heads on the device,
    staging buffer): one upload, the candidate words (snv_candidate_words,
    with ``bins``), and the words compacted to positions with torch ops, so
    that only the positions travel back.  On CUDA the work is queued on
    the current stream, which the compaction waits for; the staging buffer
    must outlive the upload."""
    n = len(seq) - df.k + 1
    dev_seq, staged = _upload(seq, gate_kernel.padded_len(n), df.device)
    words = snv_candidate_words(dev_seq, n, df, chunk, bins)
    return dev_seq, positions_on_device(words), staged


def _group(chunk: int) -> int:
    """Heads of a group: as many whole chunks as BIN_BUDGET holds."""
    return chunk * max(1, BIN_BUDGET // (3 * snv_kernel.ENTRY_BYTES * chunk))


def cand_bins(df, chunk: int = DEFAULT_CHUNK) -> Optional["snv_kernel.CandBins"]:
    """Scratch for the binned pass of snv_candidate_words on the card,
    sized for a whole group of chunks, to be reused contig after contig by
    one caller at a time; None off the card (each call then allocates what
    its contig needs) and where no group is binned (a filter that the
    densest group would not cover: ``snv_kernel.binned``)."""
    group = _group(chunk)  # no contig's group is larger
    if df.device.type != "cuda" or not snv_kernel.binned(df, group):
        return None
    return snv_kernel.CandBins(df.modulus, group, df.device)


def snv_candidate_words(dev_seq: torch.Tensor, n: int, df, chunk: int = DEFAULT_CHUNK,
                        bins: Optional["snv_kernel.CandBins"] = None) -> torch.Tensor:
    """The candidate words of heads [0, n) of a contig laid out on the
    device as the kernels read it (``gate_kernel.padded_len(n)`` bytes), in
    groups of as many chunks as BIN_BUDGET holds: where
    ``snv_kernel.binned`` says so (a blocked filter whose sectors the
    group's probes cover densely), the binned pass, the group's probes
    binned by filter slice and probed slice by slice; elsewhere one
    candidate kernel per chunk.  The binned pass uses ``bins`` (cand_bins;
    the caller's scratch, free of other work) or allocates its own."""
    chunk = _effective_chunk(n, chunk)
    group = _group(chunk)
    parts = []
    for start in range(0, n, group):
        m = min(group, n - start)
        if not snv_kernel.binned(df, m):
            parts += [snv_kernel.snv_cand_words(dev_seq[c:], min(chunk, n - c), df)
                      for c in range(start, start + m, chunk)]
            continue
        if bins is None:
            bins = snv_kernel.CandBins(df.modulus, min(group, n), df.device)
        out = torch.empty(-(-m // 32), dtype=torch.int32, device=df.device)
        snv_kernel.snv_cand_bin(dev_seq[start:], m, df, bins, out)
        snv_kernel.snv_cand_probe(bins, df, out)
        parts.append(out)
    return torch.cat(parts)


def _on_stream(df, stream):
    """Context that runs CUDA work on ``stream`` (a new one when None);
    nothing on the CPU."""
    if df.device.type != "cuda":
        return contextlib.nullcontext()
    return torch.cuda.stream(stream if stream is not None else torch.cuda.Stream(df.device))


def snv_candidate_positions(
    seq: np.ndarray,
    df,
    chunk: int = DEFAULT_CHUNK,
    stream: Optional["torch.cuda.Stream"] = None,
    bins: Optional["snv_kernel.CandBins"] = None,
) -> np.ndarray:
    """Sorted SNV candidate heads of one contig: the heads where the engine
    can produce a record or an edit (see ops/snv_kernel.py); every other
    head is a no-op in SNV mode, so this is an exact hint.  Needs a blocked
    or plain filter (Polisher._snv_fast_eligible).  ``bins``: the binned
    pass's scratch (cand_bins), if the caller keeps one."""
    if len(seq) < df.k:
        return np.zeros(0, dtype=np.int64)
    with _on_stream(df, stream):
        with profiling.span("engine.snv_pass"):
            _dev_seq, cand, _staged_buf = _snv_candidates(seq, df, chunk, bins)
        with profiling.span("engine.download"):
            return cand.cpu().numpy()


def polish_candidate_masks(
    seq: np.ndarray,
    df,
    gates: np.ndarray,
    stream: Optional["torch.cuda.Stream"] = None,
) -> np.ndarray:
    """uint8 masks parallel to the polish-mode gate heads ``gates`` of one
    contig (ops/snv_kernel.py polish_cand_masks, gated): bit c = the
    window's k-mer with its last base set to "ACGT"[c] is in the filter,
    the draft's own base 0 (a gate's own k-mer is absent); 0xFF = the
    window holds a byte that is not ACGT, probe live.  For callers that
    hold the gates already (the pipelined engine's replay): one upload of
    the contig and of the gates (int64: no limit on the contig's length),
    one kernel, one byte per gate back.  Needs a blocked or plain filter."""
    gates = np.ascontiguousarray(gates, dtype=np.int64)
    n = len(seq) - df.k + 1
    if n <= 0 or not len(gates):
        return np.zeros(len(gates), dtype=np.uint8)
    with _on_stream(df, stream):
        dev_seq, _staged_buf = _upload(seq, len(seq), df.device)
        dev_gates = torch.from_numpy(gates).to(df.device)
        return snv_kernel.polish_cand_masks(dev_seq, n, dev_gates, df, gated=True).cpu().numpy()


def contig_gates_and_masks(
    seq: np.ndarray,
    df,
    chunk: int = DEFAULT_CHUNK,
    stream: Optional["torch.cuda.Stream"] = None,
) -> tuple:
    """(gates int64 [G], masks uint8 [G]) of one contig in polish mode: the
    gates of flag_contig_gates and the masks of polish_candidate_masks on
    them, in one pass.  The contig uploads once; the gate kernel runs per
    chunk; the words are compacted to positions on the card (torch.nonzero
    waits for the gate kernels); one gated mask launch runs on the
    resident contig; gates and masks come back together after one
    synchronisation.  Needs a blocked or plain filter."""
    n = len(seq) - df.k + 1
    if n <= 0:
        return np.zeros(0, dtype=np.int64), np.zeros(0, dtype=np.uint8)
    chunk = _effective_chunk(n, chunk)
    with _on_stream(df, stream):
        dev_seq, _staged_buf = _upload(seq, gate_kernel.padded_len(n), df.device)
        words = torch.cat([gate_kernel.gate_words(dev_seq[start:], min(chunk, n - start), df)
                           for start in range(0, n, chunk)])
        gates = positions_on_device(words)
        masks = snv_kernel.polish_cand_masks(dev_seq, n, gates, df, gated=True)
        if df.device.type != "cuda":
            return gates.numpy(), masks.numpy()
        host = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True).copy_(t, non_blocking=True)
                for t in (gates, masks)]
        torch.cuda.current_stream(df.device).synchronize()
        return host[0].numpy(), host[1].numpy()


def snv_site_data(
    seq: np.ndarray,
    df,
    jump: int,
    chunk: int = DEFAULT_CHUNK,
    stream: Optional["torch.cuda.Stream"] = None,
    bins: Optional["snv_kernel.CandBins"] = None,
) -> tuple:
    """(candidate heads int64 [G], site rows uint8 [G, 6]), parallel
    arrays: the candidates of snv_candidate_positions (``bins`` as there)
    and, for each, the row the engine consumes instead of probing
    (ops/snv_kernel.py), from one site kernel over the contig's
    candidates."""
    n = len(seq) - df.k + 1
    if n <= 0:
        return np.zeros(0, dtype=np.int64), np.zeros((0, 6), dtype=np.uint8)
    with _on_stream(df, stream):
        with profiling.span("engine.snv_pass"):
            dev_seq, cand, _staged_buf = _snv_candidates(seq, df, chunk, bins)
            rows = snv_kernel.snv_site_rows(dev_seq, n, cand, df, jump)
        with profiling.span("engine.download"):
            return cand.cpu().numpy(), rows.cpu().numpy()
