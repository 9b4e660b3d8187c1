"""Bloom-filter construction on the card: the ntCard + ntStat +
make_genome_bf path of the JAX package's ``core/bfbuild.py``.

* ``count_histogram``  — ntCard's role: the k-mer multiplicity histogram
  (F1 = total k-mers, F0 = distinct, the f_i spectrum), saved and loaded in
  ntCard's .hist text format.  Exact up to ``sample_budget`` kept hashes;
  beyond it, ntCard-style hash sampling keeps the k-mers whose mixed hash
  falls in a 2^-s slice and scales by 2^s.  The final s is the smallest
  whose kept count fits the budget, which does not depend on record order.
* ``solid_cutoff``     — ntStat's ``--solid``: the first valley of the
  spectrum, clamped to [2, 255].
* ``build_read_filter`` — ntStat ``filter``: a Bloom filter of the read
  k-mers with multiplicity >= cutoff (count-min counting, then threshold
  insertion), or with ``counts=True`` the counting filter of all of them.
* ``build_genome_bf``  — ntedit_make_genome_bf: a plain filter of all
  genome k-mers, sized from --bf | --num_elements | the total length.

The records are read on the host by the batch reader (io/native.py) and
joined with a 0x00 separator into pieces of at most ``batch`` bytes,
uploaded as ASCII through one pinned host buffer; consecutive pieces of a
long buffer overlap by exactly k - 1 bytes, so every window is seen once.
The uploaded pieces stay on the device (``DeviceBatches``) when they fit a
budget, a quarter of the device's free memory by default: the histogram,
count and insert passes then read the reads once in all; otherwise every
pass reads them again.  Each pass over a batch runs the kernels of
ops/build_kernel.py: the canonical hashes of the valid windows for the
histogram, compacted on the card and sampled there once the histogram
samples; the count-min increments, binned by slice of the counter table
and then applied slice by slice; the threshold insertion, which reads
solid bits packed once per pass from the counters.  The histogram's unique-count, and the
sampling of the batches kept before the slice rose, are torch ops on the
device.  ``device="cpu"`` runs the kernels' plain
versions on the CPU.  Only valid windows (all k bytes ACGTacgt) count.

Filters, histograms and their files equal the JAX package's for the same
inputs.  One difference is a fault of the reference: its device counting
reduces the low 32 bits of a hash, so a count table above 2^32 slots
folds into its first 2^32; here every slot index is the exact
``h mod slots``.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Iterable, Iterator, Optional, Sequence

import numpy as np
import torch

from ntedit_tpu_torch.core import bloom
from ntedit_tpu_torch.engine.polish import resolve_device
from ntedit_tpu_torch.io import fastx, native
from ntedit_tpu_torch.ops import build_kernel
from ntedit_tpu_torch.ops.gate_kernel import padded_len
from ntedit_tpu_torch.utils import profiling

BATCH = 1 << 24  # bytes of separator-joined records per device batch
LAYOUTS = ("blocked", "plain", "counting")


# ---------------------------------------------------------------------------
# separator-joined batches
# ---------------------------------------------------------------------------

def _iter_seqs(paths: Sequence[str]) -> Iterator[np.ndarray]:
    for p in paths:
        for rec in fastx.read_fastx(p):
            yield rec.seq


def _separated(paths: Sequence[str], bases: Optional[list] = None) -> Iterator[np.ndarray]:
    """Each batch of the reader with a 0x00 byte after each record, joined
    in one vectorised pass.  ``bases``: a one-element list the records'
    bases are added to."""
    for p in paths:
        for seq_bytes, offs, _, _ in native.read_batches(p, want_headers=False):
            if bases is not None:
                bases[0] += len(seq_bytes)
            yield np.insert(seq_bytes, offs[1:], np.uint8(0))


def iter_separated_buffers(paths: Sequence[str], k: int, batch: int = BATCH) -> Iterator[np.ndarray]:
    """Records joined with a 0x00 byte after each (non-ACGT: no valid window
    straddles two records), in pieces of ``batch`` bytes (the last one
    shorter).  Consecutive pieces overlap by exactly k - 1 bytes, so every
    window lies in exactly one piece (count-min updates must not count a
    window twice)."""
    return _pieces(_separated(paths), k, batch)


def _pieces(stream: Iterable[np.ndarray], k: int, batch: int) -> Iterator[np.ndarray]:
    """The pieces of a stream of separator-joined records."""
    if batch < k:
        raise ValueError(f"a batch of {batch} bytes holds no window of k={k}")
    step = batch - (k - 1)
    pend: list = []
    n = 0
    for joined in stream:
        pend.append(joined)
        n += len(joined)
        if n >= batch:
            buf = np.concatenate(pend)
            s = 0
            while len(buf) - s >= batch:
                yield buf[s : s + batch]
                s += step
            pend, n = [buf[s:]], len(buf) - s  # the next piece's k - 1 bytes of overlap and more
    if n >= k:  # a remainder of k - 1 bytes holds no window of its own
        yield np.concatenate(pend)


def upload_batches(pieces: Iterable[np.ndarray], k: int, device, batch: int = BATCH,
                   keep: bool = False) -> Iterator[tuple]:
    """(seq, n) per piece of at most ``batch`` bytes: ``seq`` a uint8
    buffer on ``device`` holding the piece at its start, padded for the
    kernels' tile and halo, ``n`` its windows.  The buffer is reused (it
    is valid until the next piece, for work queued on the current stream)
    unless ``keep``: then each piece has a buffer of its own.  On CUDA each
    piece is staged through one pinned host buffer, written again only
    once its last copy is done.  Each piece's staging is the span
    ``io.upload``."""
    dev = torch.device(device)
    buf = None
    staged = pinned = None
    if dev.type == "cuda":
        pinned = torch.empty(batch, dtype=torch.uint8, pin_memory=True)
        staged = torch.cuda.Event()
    for piece in pieces:
        n = len(piece) - k + 1
        if n <= 0:
            continue
        if keep:
            out = torch.empty(padded_len(n), dtype=torch.uint8, device=dev)
            out[len(piece):].zero_()
        else:
            if buf is None:
                buf = torch.zeros(padded_len(batch), dtype=torch.uint8, device=dev)
            out = buf
        with profiling.span("io.upload"):
            if pinned is None:
                out[: len(piece)].copy_(torch.from_numpy(piece))
            else:
                staged.synchronize()  # the previous piece's copy has read the pinned buffer
                pinned[: len(piece)].numpy()[:] = piece
                out[: len(piece)].copy_(pinned[: len(piece)], non_blocking=True)
                staged.record()
        yield out, n


def default_budget(device) -> int:
    """A quarter of the device's free memory (of the host's available
    memory for the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda":
        return torch.cuda.mem_get_info(dev)[0] // 4
    return os.sysconf("SC_AVPHYS_PAGES") * os.sysconf("SC_PAGE_SIZE") // 4


class DeviceBatches:
    """The uploaded pieces of the records of ``paths``, each pass over them
    an iteration: (seq, n) as ``upload_batches`` yields them.  The first
    pass keeps every piece in a device buffer of its own while their bytes
    fit ``budget`` (None: ``default_budget``, taken here, before any table
    of the build is allocated); once they all fit, the later passes iterate
    the kept pieces and the files are read once.  Otherwise every pass
    reads them again.  Each pull of the next piece from the files (reading
    and joining records, cutting the piece) is the span ``io.read``, and
    its records' bases count into ``io.read_bases``."""

    def __init__(self, paths: Sequence[str], k: int, device, batch: int = BATCH,
                 budget: Optional[int] = None):
        self.paths = list(paths)
        self.k = k
        self.device = resolve_device(device)
        self.batch = batch
        self.budget = default_budget(self.device) if budget is None else budget
        self.kept: Optional[list] = None  # the pieces, once a whole pass fitted
        self.kept_bytes = 0
        self.passes = 0
        self._bases: Optional[int] = None  # the records' bases, after a whole pass

    def bases(self) -> int:
        """The records' bases in all (a pass over them when none ended yet)."""
        if self._bases is None:
            for _ in self:
                pass
        return self._bases

    def _read(self) -> Iterator[np.ndarray]:
        bases = [0]
        it = _pieces(_separated(self.paths, bases), self.k, self.batch)
        while True:
            seen = bases[0]
            with profiling.span("io.read"):
                piece = next(it, None)
            profiling.count("io.read_bases", bases[0] - seen)
            if piece is None:
                self._bases = bases[0]
                return
            yield piece

    def __iter__(self) -> Iterator[tuple]:
        self.passes += 1
        if self.kept is not None:
            yield from self.kept
            return
        keeping = self.passes == 1 and self.budget > 0
        kept, size = [], 0
        for seq, n in upload_batches(self._read(), self.k, self.device, self.batch, keep=keeping):
            if keeping:
                size += seq.numel()
                if size > self.budget:
                    keeping, kept = False, []  # over budget: every pass reads again
                else:
                    kept.append((seq, n))
            yield seq, n
        if keeping:
            self.kept, self.kept_bytes = kept, size


def device_batches(paths: Sequence[str], k: int, device, batch: int = BATCH,
                   budget: Optional[int] = None) -> DeviceBatches:
    """The ``DeviceBatches`` of the records of ``paths``."""
    return DeviceBatches(paths, k, device, batch, budget)


# ---------------------------------------------------------------------------
# histogram (ntCard role)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Histogram:
    k: int
    f1: int                 # total k-mers (F1)
    f0: int                 # distinct k-mers (F0)
    spectrum: np.ndarray    # spectrum[i] = # distinct k-mers with count i (i>=1)

    def f(self, i: int) -> int:
        return int(self.spectrum[i]) if 0 < i < len(self.spectrum) else 0

    def solid_cardinality(self, cutoff: int) -> int:
        """Distinct k-mers with multiplicity >= cutoff."""
        below = int(self.spectrum[1:cutoff].sum()) if cutoff > 1 else 0
        return max(1, self.f0 - below)

    def save(self, path: str) -> None:
        """ntCard .hist text format, written under a name of this
        process's own and renamed (ranks may save the same stage file)."""
        tmp = f"{path}.{os.getpid()}.tmp"
        with profiling.span("io.save"):
            with open(tmp, "w") as f:
                f.write(f"F1\t{self.f1}\n")
                f.write(f"F0\t{self.f0}\n")
                for i in range(1, len(self.spectrum)):
                    f.write(f"{i}\t{int(self.spectrum[i])}\n")
            os.replace(tmp, path)

    @classmethod
    def load(cls, path: str, k: int = 0) -> "Histogram":
        f1 = f0 = 0
        pairs = {}
        with open(path) as f:
            for line in f:
                key, val = line.split()
                if key == "F1":
                    f1 = int(val)
                elif key == "F0":
                    f0 = int(val)
                else:
                    pairs[int(key)] = int(val)
        top = max(pairs) if pairs else 0
        spec = np.zeros(top + 1, dtype=np.int64)
        for i, v in pairs.items():
            spec[i] = v
        return cls(k=k, f1=f1, f0=f0, spectrum=spec)


class SampledHashes:
    """The histogram's kept hashes, batch by batch: exact until more than
    ``budget`` are kept, then ntCard-style hash sampling keeps those in a
    2^-s slice (``build_kernel.in_slice``), s rising one step at a time (each halving
    what is kept) until the kept ones fit.  The final s is the smallest
    whose kept count fits the budget, so it does not depend on the order
    of the hashes.  A batch given as a view into a buffer more than twice
    its size (the hashes kernel returns one, of a buffer of a hash per
    window) is kept as a copy, so the kept batches hold at most twice the
    bytes of their hashes, whatever s."""

    def __init__(self, budget: int):
        self.budget = budget
        self.s = 0
        self.total = 0  # valid windows seen (F1)
        self.kept: list = []
        self.kept_n = 0

    def add(self, h: torch.Tensor, total: int, s: int = 0) -> None:
        """A batch of ``total`` valid windows, given by the hashes of those
        in slice ``s`` (at most the current slice)."""
        self.total += total
        if self.s > s:
            h = h[build_kernel.in_slice(h, self.s)]
        elif h.untyped_storage().nbytes() > 2 * h.numel() * h.element_size():
            h = h.clone()
        self.kept.append(h)
        self.kept_n += h.numel()
        while self.kept_n > self.budget:
            self.s += 1
            self.kept = [a[build_kernel.in_slice(a, self.s)] for a in self.kept]
            self.kept_n = sum(a.numel() for a in self.kept)

    def histogram(self, k: int, max_count: int = 255) -> "Histogram":
        """The unique-count and the spectrum, run where the hashes lie."""
        sampled = torch.cat(self.kept) if self.kept else torch.zeros(0, dtype=torch.int64)
        self.kept = []
        uniq, counts = torch.unique(sampled, return_counts=True)
        scale = 1 << self.s
        spec = torch.bincount(counts.clamp(max=max_count), minlength=max_count + 1)
        spectrum = spec.cpu().numpy().astype(np.int64) * scale
        spectrum[0] = 0
        return Histogram(k=k, f1=self.total, f0=int(uniq.numel()) * scale, spectrum=spectrum)


def histogram_of(hashes: Iterable[torch.Tensor], k: int, max_count: int = 255,
                 sample_budget: int = 1 << 26) -> Histogram:
    """The histogram of the canonical hashes of every valid window, given
    in batches; the sampling, the unique-count and the spectrum run where
    the hashes lie."""
    kept = SampledHashes(sample_budget)
    for h in hashes:
        kept.add(h, h.numel())
    return kept.histogram(k, max_count)


def count_histogram(paths: Sequence[str], k: int, max_count: int = 255,
                    sample_budget: int = 1 << 26, device=None, batch: int = BATCH,
                    budget: Optional[int] = None,
                    batches: Optional[DeviceBatches] = None) -> Histogram:
    """Stream the reads through the hashes kernel and build the k-mer
    multiplicity histogram on ``device`` (the card by default).  Each
    batch's kernel emits only the hashes of the current sample slice and
    counts every valid window beside them.  ``batches``: the reads'
    ``DeviceBatches`` when a build shares them (else made here, keeping
    the pieces within ``budget`` bytes).  The pass and the readback are
    the span ``build.histogram``."""
    dev = resolve_device(device)
    if batches is None:
        batches = device_batches(paths, k, dev, batch, budget)
    with profiling.span("build.histogram"):
        kept = SampledHashes(sample_budget)
        for seq, n in batches:
            s = kept.s
            kept.add(*build_kernel.kmer_valid_hashes(seq, n, k, s), s)
        return kept.histogram(k, max_count)


def solid_cutoff(hist: Histogram) -> int:
    """First valley of the multiplicity spectrum: errors dominate low counts
    with a steeply falling f_i; genuine coverage forms a later peak.  The
    first i where f_i stops falling separates them.  Clamped to [2, 255]."""
    f = hist.spectrum
    top = len(f) - 1
    i = 2
    while i < top and f[i] > f[i + 1]:
        i += 1
    return int(min(max(i, 2), 255))


# ---------------------------------------------------------------------------
# the device builder
# ---------------------------------------------------------------------------

class FilterBuilder:
    """Streaming count-min counting and threshold insertion on one device.

    ``layout``:
    * ``blocked`` — ``nbits`` a power of two: the framework-native
      BlockedKmerBloomFilter, one word and hash_num 5-bit offsets per k-mer;
    * ``plain``   — ``nbits`` a multiple of 8, any size: btllib's
      KmerBloomFilter, bit ``h_j mod nbits``;
    * ``counting`` — no bit array: ``finish`` returns the counters as
      btllib's KmerCountingBloomFilter8.

    ``slots`` counters (uint8, any size, exact ``h_j mod slots``) back the
    count pass; 0 means none (no ``count_batch``, insertion at cutoff 1
    only).  The tables live on the device, padded to whole 32-bit words for
    the kernels' atomics, and ``finish`` trims them.  Every pass runs on
    the current stream, so insertion sees the finished count pass.

    A count batch is binned by slice of ``2^build_kernel.SLICE_BITS``
    counters into bins allocated at the first ``count_batch`` (4 B per
    increment: ``hash_num`` times the batch's windows; again only for a
    larger batch), and applied slice by slice.  The first ``insert_batch``
    above cutoff 1 packs the counters at or above its cutoff into solid
    bits (one bit per slot), which every insertion of the pass then reads;
    from then on a ``count_batch`` (the bits would be stale) or another
    cutoff raises."""

    def __init__(self, k: int, hash_num: int, nbits: int, slots: int,
                 layout: str = "blocked", device=None):
        if layout not in LAYOUTS:
            raise ValueError(f"unknown layout {layout!r}")
        if hash_num < 1:
            raise ValueError(f"hash_num must be at least 1, got {hash_num}")
        if layout == "blocked":
            nw = nbits // 32
            if nbits % 32 or nw < 1 or nw & (nw - 1):
                raise ValueError(f"the blocked layout needs a power-of-two word count, got {nbits} bits")
            if nw > bloom.MAX_BLOCKED_WORDS:
                raise NotImplementedError("single-device blocked filter limited to 2^31 words")
            if hash_num * 5 + nw.bit_length() - 1 > 64:
                raise ValueError("hash_num too large for blocked layout")
        elif layout == "plain":
            if nbits < 8 or nbits % 8:
                raise ValueError(f"the plain layout needs a positive whole number of bytes, got {nbits} bits")
            if nbits > bloom.MAX_PLAIN_BITS:
                raise NotImplementedError("single-device filter limited to 2^36 bits (8 GiB)")
        elif slots < 1:
            raise ValueError("a counting filter needs at least one slot")
        if slots < 0:
            raise ValueError(f"slots must be >= 0, got {slots}")
        if slots and hash_num > build_kernel.MAX_HASH_NUM:
            raise ValueError(f"the count pass takes at most {build_kernel.MAX_HASH_NUM} hashes, "
                             f"got {hash_num}")
        self.k = k
        self.hash_num = hash_num
        self.layout = layout
        self.nbits = nbits if layout != "counting" else 0
        self.slots = slots
        self.device = resolve_device(device)
        self.counters = (torch.zeros(-(-slots // 4) * 4, dtype=torch.uint8, device=self.device)
                         if slots else None)
        nwords = -(-self.nbits // 32)
        self.words = (torch.zeros(nwords, dtype=torch.int32, device=self.device)
                      if layout != "counting" else None)
        self.bins = None   # the count pass's scratch, at the first count_batch
        self.solid = None  # the solid bits, at the first insert_batch above cutoff 1
        self.solid_cutoff = None
        self._finished = False

    @property
    def modulus(self) -> int:
        """What a hash is reduced by in the bit array: words (blocked) or bits."""
        return self.nbits // 32 if self.layout == "blocked" else self.nbits

    def _live(self) -> None:
        if self._finished:
            raise RuntimeError("builder already finished")

    def count_batch(self, seq: torch.Tensor, n: int) -> None:
        """Count-min increments of the valid windows [0, n) of ``seq``."""
        self._live()
        if self.counters is None:
            raise RuntimeError("builder has no counter table (slots=0)")
        if self.solid is not None:
            raise RuntimeError("count_batch after an insert_batch above cutoff 1: the solid "
                               "bits already read the counters")
        if self.bins is None or n > self.bins.windows:
            self.bins = build_kernel.Bins(self.slots, self.hash_num, max(1, n), self.device)
        build_kernel.kmer_count(seq, n, self.k, self.hash_num, self.counters, self.slots,
                                self.bins)

    def insert_batch(self, seq: torch.Tensor, n: int, cutoff: int) -> None:
        """Insert the valid windows of [0, n) whose count-min read is at
        least ``cutoff`` (all of them when cutoff <= 1)."""
        self._live()
        if self.words is None:
            raise RuntimeError("a counting builder has no bit array to insert into")
        solid = None
        if cutoff > 1:
            if self.counters is None:
                raise RuntimeError("insertion above cutoff 1 needs the counter table")
            if self.solid is None:
                self.bins = None  # the count pass is over
                self.solid = build_kernel.kmer_solid_bits(self.counters, self.slots, cutoff)
                self.solid_cutoff = cutoff
            elif cutoff != self.solid_cutoff:
                raise RuntimeError(f"insert_batch at cutoff {cutoff} after solid bits at "
                                   f"{self.solid_cutoff}: one cutoff per builder")
            solid = self.solid
        build_kernel.kmer_insert(seq, n, self.k, self.hash_num, self.words, self.layout,
                                 self.modulus, solid, self.slots)

    def finish(self):
        """Download the filter: BlockedKmerBloomFilter, KmerBloomFilter or
        KmerCountingBloomFilter8 by layout (span ``build.download``, which
        waits for the passes queued before it)."""
        self._live()
        self._finished = True
        if self.layout == "counting":
            with profiling.span("build.download"):
                counters = self.counters[: self.slots].cpu().numpy()
            self.counters = self.bins = None
            return bloom.KmerCountingBloomFilter8(counters, self.hash_num, self.k)
        with profiling.span("build.download"):
            words = self.words.cpu().numpy().view(np.uint32)
        self.words = self.counters = self.solid = self.bins = None  # device tables released
        if self.layout == "blocked":
            return bloom.BlockedKmerBloomFilter(words, self.hash_num, self.k)
        data = words.view(np.uint8)[: self.nbits // 8].copy()
        return bloom.KmerBloomFilter(data, self.hash_num, self.k)


# ---------------------------------------------------------------------------
# read-derived BF / CBF (ntStat filter role) and the genome BF
# ---------------------------------------------------------------------------

def filter_sizes(hist: Histogram, cutoff: int, hash_num: int = 3, fpr: float = 0.01,
                 layout: str = "blocked") -> tuple:
    """(bits, count slots, counting-filter slots) of a read filter: the JAX
    package's device branch (``blocked``: power-of-two sizes) or host
    branch (``plain``: btllib sizes).  A counting filter has as many slots
    as the bit-array formula gives bits for F0 (one byte per slot)."""
    n_solid = hist.solid_cardinality(cutoff)
    cbf_slots = bloom.bf_size_bytes(hist.f0, hash_num, fpr) * 8
    if layout == "blocked":
        return (bloom.pow2_size_bytes(n_solid, hash_num, fpr) * 8,
                1 << max(12, (cbf_slots - 1).bit_length()), cbf_slots)
    return bloom.bf_size_bytes(n_solid, hash_num, fpr) * 8, cbf_slots, cbf_slots


def build_read_filter(
    paths: Sequence[str],
    k: int,
    cutoff: int = 2,
    solid: bool = False,
    fpr: float = 0.01,
    hash_num: int = 3,
    counts: bool = False,
    hist: Optional[Histogram] = None,
    layout: str = "blocked",
    device=None,
    batch: int = BATCH,
    budget: Optional[int] = None,
    batches: Optional[DeviceBatches] = None,
):
    """BF (or CBF when counts=True) of read k-mers with multiplicity
    >= cutoff.  ``solid`` derives the cutoff from the histogram.  Returns
    (filter, hist, cutoff).  The histogram (when ``hist`` is None), count
    and insert passes iterate one ``DeviceBatches`` of the reads:
    ``batches``, or one made here that keeps the uploaded pieces on the
    device within ``budget`` bytes (None: a quarter of the free memory;
    0: every pass reads the files again).

    ``layout`` mirrors the JAX package's two branches: ``blocked`` is its
    device build (power-of-two sizes, a count table of
    ``1 << max(12, bit_length(cbf_slots - 1))`` slots, counted only when
    cutoff > 1), ``plain`` its host build (btllib sizes, a count table of
    ``cbf_slots``).  ``counts=True`` counts every valid k-mer into
    ``cbf_slots`` counters, with no cutoff."""
    dev = resolve_device(device)
    if layout not in ("blocked", "plain"):
        raise ValueError(f"unknown layout {layout!r}")
    if batches is None:
        batches = device_batches(paths, k, dev, batch, budget)
    if hist is None:
        hist = count_histogram(paths, k, device=dev, batches=batches)
    if solid:
        cutoff = solid_cutoff(hist)
    cutoff = max(1, int(cutoff))

    nbits, slots, cbf_slots = filter_sizes(hist, cutoff, hash_num, fpr, layout)

    if counts:
        builder = FilterBuilder(k, hash_num, 0, cbf_slots, "counting", dev)
        with profiling.span("build.count"):
            for seq, n in batches:
                builder.count_batch(seq, n)
        return builder.finish(), hist, cutoff

    builder = FilterBuilder(k, hash_num, nbits, slots if cutoff > 1 else 0, layout, dev)
    if cutoff > 1:
        with profiling.span("build.count"):
            for seq, n in batches:
                builder.count_batch(seq, n)
    with profiling.span("build.insert"):
        for seq, n in batches:
            builder.insert_batch(seq, n, cutoff)
    return builder.finish(), hist, cutoff


def build_genome_bf(
    genome_paths: Sequence[str],
    k: int,
    fpr: float = 0.01,
    hash_num: int = 3,
    bf_bytes: Optional[int] = None,
    num_elements: Optional[int] = None,
    device=None,
    batch: int = BATCH,
    budget: Optional[int] = None,
    batches: Optional[DeviceBatches] = None,
) -> bloom.KmerBloomFilter:
    """Plain BF over all genome k-mers.  Size precedence --bf >
    --num_elements > total genome length, each through the
    Broder–Mitzenmacher formula (src/ntedit_make_genome_bf.cpp:124-138).
    The total length comes from a pass over the genome's ``DeviceBatches``
    (``batches``, or made here within ``budget``), whose kept pieces the
    insertion then reads: the genome is read once when they fit."""
    dev = resolve_device(device)
    if batches is None:
        batches = device_batches(genome_paths, k, dev, batch, budget)
    if bf_bytes is None:
        n = num_elements if num_elements is not None else batches.bases()
        bf_bytes = bloom.bf_size_bytes(max(1, n), hash_num, fpr)
    builder = FilterBuilder(k, hash_num, bf_bytes * 8, 0, "plain", dev)
    with profiling.span("build.insert"):
        for seq, n in batches:
            builder.insert_batch(seq, n, 1)
    return builder.finish()
