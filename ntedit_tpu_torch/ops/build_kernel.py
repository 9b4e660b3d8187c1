"""The filter-build passes: CUDA kernel wrappers and their plain torch versions.

Each pass reads one batch of separator-joined records as ASCII, ``seq``,
and its windows [0, n).  A window is valid when its k bytes are all
ACGTacgt; only valid windows count.  For a valid window with canonical
ntHash2 value ``can``, hash j is ``can`` for j = 0 and NTM64's extension
of it otherwise (``nthash.extend``).

* ``kmer_valid_hashes(seq, n, k, s)`` -> (int64 [v] the canonical hashes
  of the valid windows in window order, the number of valid windows):
  with ``s`` > 0 only the hashes in the histogram's sample slice s
  (``in_slice``), all valid windows counted.  ``valid_hashes(seq, n, k)``
  is its first element at s = 0.
* ``kmer_count(seq, n, k, hash_num, counters, slots, bins)`` adds one,
  saturating at 255, to counter ``h_j mod slots`` of the uint8 table
  ``counters``, for every valid window and every j < hash_num (btllib's
  counting filter).  It runs in two kernels: ``kmer_partition`` bins the
  increments of the batch by slice of ``2^bins.slice_bits`` counters into
  ``bins`` (a ``Bins``: the scratch, reused across batches), and
  ``kmer_count_apply`` applies them slice by slice.
* ``kmer_solid_bits(counters, slots, cutoff)`` -> int32 [ceil(slots/32)]:
  bit s set when counter s is at least ``cutoff``, little-endian.
* ``kmer_insert(seq, n, k, hash_num, words, layout, modulus, solid, slots)``
  ORs the bits of every valid window whose hash_num slots ``h_j mod slots``
  are all set in ``solid`` (every valid window when ``solid`` is None) into
  ``words`` (uint32 bits held as int32): ``blocked``, one word
  ``can & (modulus - 1)`` with hash_num 5-bit offsets from bits
  ``log2(modulus) + 5j`` of ``can``; ``plain``, bit ``h_j mod modulus``,
  little-endian, so the words' bytes are the btllib filter's.  With the
  solid bits at ``cutoff`` this is threshold insertion: a window goes in
  when the count-min of its counters is at least ``cutoff``
  (``kmer_insert_plain``, the reference).

``counters``, ``bins`` and ``words`` are updated in place.  On a CUDA tensor
a wrapper launches csrc/build_kernel.cu (built with nvcc at first use) on the
current stream, does not synchronise, and raises when it cannot; on a CPU
tensor it runs its plain version.  The kernels replace the JAX package's XLA
programs core/bfbuild.py::DeviceFilterBuilder._count_fn and _insert_fn and
its host numpy build passes; see the note in the .cu source.
"""

from __future__ import annotations

import ctypes
import os
import threading

import torch

from ntedit_tpu_torch.core import nthash as nt
from ntedit_tpu_torch.ops import gate_kernel
from ntedit_tpu_torch.ops.gate_kernel import HEADER, LAYOUT_CODE, MAX_K, TILE, mod_magic, padded_len
from ntedit_tpu_torch.utils.build import build_library

SOURCE = os.path.join(gate_kernel.CSRC, "build_kernel.cu")
LAYOUTS = ("blocked", "plain")
# counters per slice of the count pass: 2^25, 32 MiB, the fastest (PERF.md section 6)
SLICE_BITS = 25
MAX_SLICES = 1024  # slices of one count table (csrc kMaxSlices)
MAX_SLICE_BITS = 32  # a slot's offset in its slice is a uint32
APPLY_CHUNK = 2048  # entries per block of the apply kernel (csrc kApplyChunk)
STAGE = 6144       # entries a partition block stages per round (csrc kStage)
MAX_HASH_NUM = STAGE // 256  # a round holds at least one window of each thread


# ---------------------------------------------------------------------------
# the slices of a count table
# ---------------------------------------------------------------------------

def slice_bits_for(slots: int, slice_bits: int = SLICE_BITS) -> int:
    """The slice size (log2 counters) the count pass uses for ``slots``
    counters: ``slice_bits``, raised until the table has at most
    MAX_SLICES slices.  Raises when that takes more than 32 bits."""
    if slots < 1:
        raise ValueError(f"a counter table needs at least one slot, got {slots}")
    if not 2 <= slice_bits <= MAX_SLICE_BITS:
        raise ValueError(f"slice_bits must lie in [2, {MAX_SLICE_BITS}], got {slice_bits}")
    bits = slice_bits
    while (slots - 1) >> bits >= MAX_SLICES:
        bits += 1
    if bits > MAX_SLICE_BITS:
        raise ValueError(f"{slots} slots need more than {MAX_SLICES} slices of 2^32 counters")
    return bits


def partition_rounds(hash_num: int) -> tuple:
    """(rounds, windows per thread per round) of a partition block at
    ``hash_num``: a round's entries (256 threads x windows x hash_num) fit
    the block's stage of STAGE entries."""
    if not 1 <= hash_num <= MAX_HASH_NUM:
        raise ValueError(f"the count pass takes 1 <= hash_num <= {MAX_HASH_NUM}, got {hash_num}")
    per = STAGE // (256 * hash_num)
    return -(-32 // per), per


def slice_of(h: torch.Tensor, slots: int, slice_bits: int) -> tuple:
    """(slice id, offset in the slice), int64, of the slot ``h mod slots``
    of each hash (uint64 bits held in int64): the partition's arithmetic."""
    slot = nt.umod(h, slots)
    return slot >> slice_bits, slot & ((1 << slice_bits) - 1)


class Bins:
    """The count pass's bins for a table of ``slots`` counters, for batches
    of up to ``windows`` windows at ``hash_num`` hashes: the scratch that
    ``kmer_partition`` fills and ``kmer_count_apply`` reads.

    * ``counts``  int32 [slices * columns]: increments of (slice, column),
      slice-major; column b * rounds + r holds round r of block b (blocks
      of 8192 windows; in round r each thread of a block takes its windows
      [r * w, (r + 1) * w), ``(rounds, w) = partition_rounds(hash_num)``);
    * ``ends``    int64, the same shape: its inclusive scan, so slice s's
      bucket is ``entries[ends[s*columns] - counts[s*columns] :
      ends[s*columns + columns - 1]]`` and the buckets lie in slice order;
    * ``entries`` int32 [hash_num * windows]: each increment's offset in its
      slice (uint32 bits), at most one per (valid window, j).

    ``columns`` and ``windows_binned`` are those of the batch last binned
    (0 before any).  ``slice_bits`` None takes SLICE_BITS.  The buffers
    are allocated once, with torch.empty."""

    def __init__(self, slots: int, hash_num: int, windows: int, device, slice_bits: int = None):
        if windows < 1:
            raise ValueError(f"bins need room for at least one window, got {windows}")
        self.slots = slots
        self.hash_num = hash_num
        self.windows = windows
        self.rounds, self.round_windows = partition_rounds(hash_num)
        self.slice_bits = slice_bits_for(slots, SLICE_BITS if slice_bits is None else slice_bits)
        self.n_slices = ((slots - 1) >> self.slice_bits) + 1
        cells = self.n_slices * -(-windows // TILE) * self.rounds
        self.counts = torch.empty(cells, dtype=torch.int32, device=device)
        self.ends = torch.empty(cells, dtype=torch.int64, device=device)
        self.entries = torch.empty(hash_num * windows, dtype=torch.int32, device=device)
        self.columns = 0
        self.windows_binned = 0

    @property
    def device(self) -> torch.device:
        return self.entries.device

    @property
    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in (self.counts, self.ends, self.entries))

    def cells(self) -> int:
        """Entries of the count matrix of the batch last binned."""
        return self.n_slices * self.columns

    def _check(self, seq: torch.Tensor, n: int) -> None:
        if seq.device != self.device:
            raise ValueError(f"bins on {self.device}, batch on {seq.device}")
        if n > self.windows:
            raise ValueError(f"bins hold batches of up to {self.windows} windows, got {n}")


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def kmer_hashes_plain(seq: torch.Tensor, n: int, k: int) -> tuple:
    """(int64 [n] canonical hashes, 0 where invalid; int32 [ceil(n/32)]
    validity words, little-endian like the gate words) of windows [0, n),
    in plain torch int64, on any device: the reference the plain versions
    build on."""
    if n <= 0:
        return (torch.zeros(0, dtype=torch.int64, device=seq.device),
                torch.zeros(0, dtype=torch.int32, device=seq.device))
    accepted, iupac = gate_kernel.window_flags(seq, n, k)
    valid = accepted & ~iupac  # every byte ACGTacgt
    can = nt.canonical(*nt.window_hashes(seq[: n + k - 1], k))
    return torch.where(valid, can, 0), gate_kernel.pack_bits(valid)


def unpack_bits(words: torch.Tensor, n: int) -> torch.Tensor:
    """Little-endian uint32 words (held as int32) -> bool [n]."""
    lanes = torch.arange(32, dtype=torch.int64, device=words.device)
    return ((words.long()[:, None] >> lanes) & 1).reshape(-1)[:n] == 1


def _saturating_add(counters: torch.Tensor, idx: torch.Tensor) -> None:
    """counters[s] = min(counters[s] + #(s in idx), 255) for every slot s of
    ``idx``: per-slot totals, then one clamped add (saturation is monotone,
    so this equals one saturating increment at a time)."""
    slot, inc = torch.unique(idx, return_counts=True)
    counters[slot] = torch.clamp(counters[slot].long() + inc, max=255).to(torch.uint8)


def kmer_count_plain(seq: torch.Tensor, n: int, k: int, hash_num: int,
                     counters: torch.Tensor, slots: int) -> None:
    """The count pass in plain torch, on any device, in one step: the
    reference of the partition and apply kernels
    (KmerCountingBloomFilter8.insert_hashes)."""
    can = valid_hashes_plain(seq, n, k)
    if can.numel():
        _saturating_add(counters, torch.cat([nt.umod(h, slots) for h in nt.extend(can, k, hash_num)]))


def valid_hashes_plain(seq: torch.Tensor, n: int, k: int) -> torch.Tensor:
    """int64 [v]: the canonical hashes of the valid windows, in order, by
    the plain version."""
    can, words = kmer_hashes_plain(seq, n, k)
    return can[unpack_bits(words, n)]


_MIX1 = nt._signed(0x9E3779B97F4A7C15)
_MIX2 = nt._signed(0xBF58476D1CE4E5B9)


def sample_key(h: torch.Tensor) -> torch.Tensor:
    """Avalanche mix (splitmix64's finalizer) for the histogram's hash-slice
    sampling: the canonical hash behaves like a minimum of two uniforms, so
    slicing on its raw top bits would over-sample; a bijective mixer keeps
    distinctness.  uint64 arithmetic on int64 bits (multiplies wrap, shifts
    are logical)."""
    x = h * _MIX1
    x = x ^ nt.shr(x, 29)
    x = x * _MIX2
    return x ^ nt.shr(x, 32)


def in_slice(h: torch.Tensor, s: int) -> torch.Tensor:
    """bool: the hashes whose mixed key has its top ``s`` bits clear."""
    return nt.shr(sample_key(h), 64 - s) == 0


def kmer_valid_hashes_plain(seq: torch.Tensor, n: int, k: int, s: int = 0) -> tuple:
    """The histogram's hashes pass in plain torch, on any device."""
    _check_sample(s)
    h = valid_hashes_plain(seq, n, k)
    return (h[in_slice(h, s)] if s else h), int(h.numel())


def kmer_partition_plain(seq: torch.Tensor, n: int, k: int, bins: Bins) -> None:
    """The partition in plain torch, on any device: the same count matrix
    and scan as the kernel, and each (slice, column) range of ``entries``
    holding the same offsets (here in window order per j; the kernel's
    order within a range depends on its atomics)."""
    bins._check(seq, n)
    bins.columns, bins.windows_binned = max(1, -(-n // TILE)) * bins.rounds, max(0, n)
    cells = bins.cells()
    can, words = kmer_hashes_plain(seq, n, k)
    pos = torch.nonzero(unpack_bits(words, n)).reshape(-1)
    col = pos // TILE * bins.rounds + pos % 32 // bins.round_windows
    key, off = [], []
    for h in nt.extend(can[pos], k, bins.hash_num):
        s, o = slice_of(h, bins.slots, bins.slice_bits)
        key.append(s * bins.columns + col)
        off.append(o)
    key = torch.cat(key)
    counts = torch.bincount(key, minlength=cells)
    bins.counts[:cells] = counts.to(torch.int32)
    torch.cumsum(counts, 0, out=bins.ends[:cells])
    off = torch.cat(off)[torch.sort(key, stable=True).indices]
    bins.entries[: off.numel()] = torch.where(off >= 1 << 31, off - (1 << 32), off).to(torch.int32)


def bin_slots(bins: Bins) -> torch.Tensor:
    """int64: the slot of every entry the last partition binned, in
    ``entries`` order (the apply's input as slots)."""
    cells = bins.cells()
    total = int(bins.ends[cells - 1]) if cells else 0
    per_slice = bins.counts[:cells].view(bins.n_slices, bins.columns).long().sum(1)
    ids = torch.arange(bins.n_slices, device=bins.device)
    s = torch.repeat_interleave(ids, per_slice)
    return (s << bins.slice_bits) | (bins.entries[:total].long() & 0xFFFFFFFF)


def kmer_count_apply_plain(bins: Bins, counters: torch.Tensor) -> None:
    """The apply in plain torch, on any device: every binned increment,
    saturating at 255."""
    slots = bin_slots(bins)
    if slots.numel():
        _saturating_add(counters, slots)


def kmer_solid_bits_plain(counters: torch.Tensor, slots: int, cutoff: int) -> torch.Tensor:
    """The solid bits in plain torch, on any device (compared widened: a
    uint8 tensor against 256 or more would wrap the scalar)."""
    return gate_kernel.pack_bits(counters[:slots].to(torch.int32) >= cutoff)


def min_count(can: torch.Tensor, k: int, hash_num: int, counters: torch.Tensor,
              slots: int) -> torch.Tensor:
    """uint8 [n]: the count-min read of each canonical hash."""
    cnt = None
    for h in nt.extend(can, k, hash_num):
        got = counters[nt.umod(h, slots)]
        cnt = got if cnt is None else torch.minimum(cnt, got)
    return cnt


def all_solid(can: torch.Tensor, k: int, hash_num: int, solid: torch.Tensor,
              slots: int) -> torch.Tensor:
    """bool [n]: whether every slot of each canonical hash is set in the
    solid bits."""
    ok = torch.ones_like(can, dtype=torch.bool)
    for h in nt.extend(can, k, hash_num):
        slot = nt.umod(h, slots)
        ok &= ((solid[slot >> 5].long() >> (slot & 31)) & 1) == 1
    return ok


def blocked_bits(can: torch.Tensor, hash_num: int, words: int) -> torch.Tensor:
    """Bit indices [hash_num, n] of the blocked layout of ``words`` words."""
    wbits = words.bit_length() - 1
    base = (can & (words - 1)) << 5
    return torch.stack([base + (nt.shr(can, wbits + 5 * j) & 31) for j in range(hash_num)])


def or_bits(words: torch.Tensor, bits: torch.Tensor) -> None:
    """words[b >> 5] |= 1 << (b & 31) for every bit index b, in place.
    Torch has no scatter-OR: each distinct bit that is still clear adds its
    power of two once, and adds of distinct powers of two are carry-free."""
    b = torch.unique(bits.reshape(-1))
    w = b >> 5
    one = torch.ones_like(b) << (b & 31)
    old = words[w].long() & 0xFFFFFFFF
    new = torch.where(old & one == 0, one, 0)
    uw, inv = torch.unique_consecutive(w, return_inverse=True)  # b sorted: w sorted
    val = (words[uw].long() & 0xFFFFFFFF) | torch.zeros_like(uw).index_add_(0, inv, new)
    words[uw] = torch.where(val >= 1 << 31, val - (1 << 32), val).to(torch.int32)


def _or_windows(can: torch.Tensor, k: int, hash_num: int, words: torch.Tensor, layout: str,
                modulus: int) -> None:
    if not can.numel():
        return
    if layout == "blocked":
        bits = blocked_bits(can, hash_num, modulus)
    else:
        bits = torch.stack([nt.umod(h, modulus) for h in nt.extend(can, k, hash_num)])
    or_bits(words, bits)


def kmer_insert_plain(seq: torch.Tensor, n: int, k: int, hash_num: int, words: torch.Tensor,
                      layout: str, modulus: int, counters=None, slots: int = 0,
                      cutoff: int = 1) -> None:
    """Threshold insertion in plain torch, on any device, from the counters
    (count-min read >= cutoff): the reference of the solid-bits and insert
    kernels."""
    can = valid_hashes_plain(seq, n, k)
    if cutoff > 1 and can.numel():
        can = can[min_count(can, k, hash_num, counters, slots).long() >= cutoff]
    _or_windows(can, k, hash_num, words, layout, modulus)


def kmer_insert_bits_plain(seq: torch.Tensor, n: int, k: int, hash_num: int, words: torch.Tensor,
                           layout: str, modulus: int, solid=None, slots: int = 0) -> None:
    """The insert kernel's function in plain torch, on any device: from the
    solid bits (every valid window when ``solid`` is None)."""
    can = valid_hashes_plain(seq, n, k)
    if solid is not None and can.numel():
        can = can[all_solid(can, k, hash_num, solid, slots)]
    _or_windows(can, k, hash_num, words, layout, modulus)


# ---------------------------------------------------------------------------
# the kernels
# ---------------------------------------------------------------------------

_lib = None
_lib_lock = threading.Lock()


def build(force: bool = False) -> str:
    """Compile the kernels (once per content of the source and its header);
    returns the .so path."""
    return build_library("build_kernel", SOURCE, gate_kernel._command, force=force, deps=(HEADER,))


def build_log() -> str:
    """What nvcc printed when it built the library (``-Xptxas -v``)."""
    with open(build() + ".log") as f:
        return f.read()


def open_library(path: str):
    """Load a build of the kernels and declare its C interface.  Raises
    when it cannot be loaded or its tile, halo, slices or apply chunk
    differ from the wrapper's."""
    lib = ctypes.CDLL(path)
    ptr, u64, i32 = ctypes.c_void_p, ctypes.c_uint64, ctypes.c_int
    lib.ntb_kmer_valid_count.restype = i32
    lib.ntb_kmer_valid_count.argtypes = [ptr, u64, i32, i32, ptr, ptr]  # seq, n, k, s, counts, stream
    lib.ntb_kmer_valid_hashes.restype = i32
    lib.ntb_kmer_valid_hashes.argtypes = [ptr, u64, i32, i32,       # seq, n, k, s
                                          ptr, ptr, ptr]            # ends, out, stream
    lib.ntb_kmer_partition.restype = i32
    lib.ntb_kmer_partition.argtypes = [ptr, u64, i32, i32,          # seq, n, k, hash_num
                                       u64, u64, i32, i32,          # slots, magic, slice_bits, slices
                                       ptr, ptr, ptr, i32, ptr]     # counts, ends, entries, scatter,
    #                                                                 stream
    lib.ntb_kmer_count_apply.restype = i32
    lib.ntb_kmer_count_apply.argtypes = [ptr, ptr, ptr, u64,        # entries, counts, ends, columns
                                         i32, i32, u64, ptr, ptr]   # slices, slice_bits, max_entries,
    #                                                                 counters, stream
    lib.ntb_kmer_solid_bits.restype = i32
    lib.ntb_kmer_solid_bits.argtypes = [ptr, u64, i32, ptr, ptr]    # counters, slots, cutoff, out,
    #                                                                 stream
    lib.ntb_kmer_insert.restype = i32
    lib.ntb_kmer_insert.argtypes = [ptr, u64, i32, i32,             # seq, n, k, hash_num
                                    ptr, u64, u64,                  # solid, slots, magic
                                    ptr, u64, u64, i32, i32, ptr]   # words, modulus, magic, wbits,
    #                                                                 layout, stream
    lib.ntb_atomic_floor.restype = i32
    lib.ntb_atomic_floor.argtypes = [ptr, u64, u64, u64, u64, ptr, ptr]  # table, size, magic, ops,
    #                                                                      threads, out, stream
    lib.ntb_occupancy.restype = i32
    lib.ntb_occupancy.argtypes = [i32]
    lib.ntb_partition_rounds.restype = i32
    lib.ntb_partition_rounds.argtypes = [i32]
    for name in ("ntb_tile_heads", "ntb_halo_bytes", "ntb_max_slices", "ntb_apply_chunk"):
        getattr(lib, name).restype = i32
        getattr(lib, name).argtypes = []
    lib.ntb_error_string.restype = ctypes.c_char_p
    lib.ntb_error_string.argtypes = [i32]
    got = (lib.ntb_tile_heads(), lib.ntb_halo_bytes(), lib.ntb_max_slices(), lib.ntb_apply_chunk())
    got += tuple(lib.ntb_partition_rounds(h) for h in range(1, MAX_HASH_NUM + 2))
    want = (gate_kernel.TILE, gate_kernel.HALO, MAX_SLICES, APPLY_CHUNK,
            *(partition_rounds(h)[0] for h in range(1, MAX_HASH_NUM + 1)), 0)
    if got != want:
        raise RuntimeError(f"build kernel constants {got} differ from the wrapper's {want}")
    return lib


def load_library():
    """The kernels' ctypes library, built at first use.  Raises when it
    cannot be built or loaded."""
    global _lib
    with _lib_lock:
        if _lib is None:
            _lib = open_library(build())
        return _lib


def _check_seq(seq: torch.Tensor, n: int, k: int) -> None:
    if seq.device.type != "cuda":
        raise ValueError(f"the build kernels need a CUDA sequence, got {seq.device}")
    if seq.dtype != torch.uint8 or seq.dim() != 1 or not seq.is_contiguous():
        raise ValueError("the build kernels need a contiguous 1-D uint8 sequence")
    if not 1 <= k <= MAX_K:
        raise ValueError(f"the build kernels support 1 <= k <= {MAX_K}, got k={k}")
    if seq.numel() < padded_len(n) or seq.data_ptr() % 16:
        raise ValueError(f"the build kernels need {padded_len(n)} bytes from a 16-byte "
                         f"aligned start (got {seq.numel()} at {seq.data_ptr() % 16})")


def _check_table(t: torch.Tensor, dtype, device, what: str, need: int) -> None:
    if t.device != device or t.dtype != dtype or t.dim() != 1 or not t.is_contiguous():
        raise ValueError(f"{what} must be a contiguous 1-D {dtype} tensor on {device}")
    if t.numel() < need or t.data_ptr() % 4:
        raise ValueError(f"{what} needs {need} elements from a 4-byte aligned start")


def _raise_if_failed(lib, rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} kernel launch failed: {lib.ntb_error_string(rc).decode()}")


def _launched(lib, rc: int, fn, what: str) -> None:
    _raise_if_failed(lib, rc, what)
    with _count_lock:
        fn.launches += 1


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _check_sample(s: int) -> None:
    if not 0 <= s <= 64:
        raise ValueError(f"the sample slice takes 0 <= s <= 64, got {s}")


def _valid_hashes_forms(lib, seq: torch.Tensor, n: int, k: int, s: int) -> tuple:
    """Queue the hashes kernel's two forms and the scan between them on the
    current stream: (rc, the output buffer of n hashes, its per-block
    counts, their scan)."""
    blocks = -(-n // TILE)
    counts = torch.empty(2 * blocks, dtype=torch.int32, device=seq.device)
    out = torch.empty(n, dtype=torch.int64, device=seq.device)
    stream = _stream(seq)
    rc = lib.ntb_kmer_valid_count(seq.data_ptr(), n, k, s, counts.data_ptr(), stream)
    ends = None
    if rc == 0:
        ends = torch.cumsum(counts[:blocks], 0, dtype=torch.int64)
        rc = lib.ntb_kmer_valid_hashes(seq.data_ptr(), n, k, s, ends.data_ptr(), out.data_ptr(),
                                       stream)
    return rc, out, counts, ends


def kmer_valid_hashes(seq: torch.Tensor, n: int, k: int, s: int = 0) -> tuple:
    """(hashes, valid windows) of windows [0, n) of ``seq`` (see the module
    docstring): the kernel's counting form, the scan of its per-block
    counts (torch.cumsum), its emitting form into a buffer of n hashes,
    then one small read of the totals (a synchronisation) that sizes the
    returned view.  One call is one launch (its two forms).  On CUDA,
    ``seq`` holds ``padded_len(n)`` bytes from a 16-byte aligned start."""
    _check_sample(s)
    if seq.device.type == "cpu":
        return kmer_valid_hashes_plain(seq, n, k, s)
    lib = load_library()
    _check_seq(seq, n, k)
    if n <= 0:
        return torch.empty(0, dtype=torch.int64, device=seq.device), 0
    rc, out, counts, ends = _valid_hashes_forms(lib, seq, n, k, s)
    _launched(lib, rc, kmer_valid_hashes, "k-mer hashes")
    emitted, valid = torch.stack([ends[-1], counts[ends.numel():].sum(dtype=torch.int64)]).tolist()
    return out[:emitted], valid


def valid_hashes(seq: torch.Tensor, n: int, k: int) -> torch.Tensor:
    """int64 [v]: the canonical hashes of the valid windows, in order."""
    return kmer_valid_hashes(seq, n, k)[0]


def _check_counters(counters: torch.Tensor, slots: int, device) -> None:
    if slots < 1:
        raise ValueError(f"a counter table needs at least one slot, got {slots}")
    if device.type == "cuda":
        _check_table(counters, torch.uint8, device, "counters", -(-slots // 4) * 4)
    elif counters.numel() < slots:
        raise ValueError(f"counters holds {counters.numel()} of {slots} slots")


def kmer_partition(seq: torch.Tensor, n: int, k: int, bins: Bins) -> None:
    """Bin the count-min increments of the valid windows of [0, n) by slice
    into ``bins``, in place: the kernel's counting form, the scan of the
    count matrix (torch.cumsum), then its scattering form.  One call is
    one launch of the partition (its two forms)."""
    bins._check(seq, n)
    if seq.device.type == "cpu":
        return kmer_partition_plain(seq, n, k, bins)
    lib = load_library()
    _check_seq(seq, n, k)
    bins.columns, bins.windows_binned = max(1, -(-n // TILE)) * bins.rounds, max(0, n)
    cells = bins.cells()
    counts, ends = bins.counts[:cells], bins.ends[:cells]
    if n <= 0:
        counts.zero_()
        ends.zero_()
        return None
    args = (seq.data_ptr(), n, k, bins.hash_num, bins.slots, mod_magic(bins.slots),
            bins.slice_bits, bins.n_slices, counts.data_ptr())
    stream = _stream(seq)
    _raise_if_failed(lib, lib.ntb_kmer_partition(*args, None, None, 0, stream), "k-mer partition")
    torch.cumsum(counts, 0, dtype=torch.int64, out=ends)
    rc = lib.ntb_kmer_partition(*args, ends.data_ptr(), bins.entries.data_ptr(), 1, stream)
    _launched(lib, rc, kmer_partition, "k-mer partition")
    return None


def kmer_count_apply(bins: Bins, counters: torch.Tensor) -> None:
    """Apply the increments the last ``kmer_partition`` binned to
    ``counters[:bins.slots]``, in place, saturating at 255.  On CUDA the
    table is padded to a multiple of 4 bytes (bytes rise through 32-bit
    CAS)."""
    _check_counters(counters, bins.slots, bins.device)
    if bins.device.type == "cpu":
        return kmer_count_apply_plain(bins, counters)
    lib = load_library()
    max_entries = bins.hash_num * bins.windows_binned
    if not max_entries:
        return None
    rc = lib.ntb_kmer_count_apply(
        bins.entries.data_ptr(), bins.counts.data_ptr(), bins.ends.data_ptr(), bins.columns,
        bins.n_slices, bins.slice_bits, max_entries, counters.data_ptr(), _stream(counters))
    _launched(lib, rc, kmer_count_apply, "k-mer count apply")
    return None


def kmer_count(seq: torch.Tensor, n: int, k: int, hash_num: int, counters: torch.Tensor,
               slots: int, bins: Bins = None) -> None:
    """Count-min increments of the valid windows of [0, n) into
    ``counters[:slots]``, in place: ``kmer_partition`` into ``bins`` (bins
    for this batch alone when None), then ``kmer_count_apply``."""
    if hash_num < 1:
        raise ValueError(f"hash_num must be at least 1, got {hash_num}")
    _check_counters(counters, slots, seq.device)
    if bins is None:
        bins = Bins(slots, hash_num, max(1, n), seq.device)
    elif (bins.slots, bins.hash_num) != (slots, hash_num):
        raise ValueError(f"bins for {bins.slots} slots and {bins.hash_num} hashes, "
                         f"asked for {slots} and {hash_num}")
    kmer_partition(seq, n, k, bins)
    kmer_count_apply(bins, counters)


def kmer_solid_bits(counters: torch.Tensor, slots: int, cutoff: int) -> torch.Tensor:
    """int32 [ceil(slots / 32)]: bit s set when ``counters[s] >= cutoff``
    (see the module docstring).  On CUDA the table is padded to a multiple
    of 4 bytes."""
    _check_counters(counters, slots, counters.device)
    if counters.device.type == "cpu":
        return kmer_solid_bits_plain(counters, slots, cutoff)
    lib = load_library()
    out = torch.empty(-(-slots // 32), dtype=torch.int32, device=counters.device)
    # cutoff above 255 sets no bit; clamp so the C int holds it
    rc = lib.ntb_kmer_solid_bits(counters.data_ptr(), slots, min(int(cutoff), 256),
                                 out.data_ptr(), _stream(counters))
    _launched(lib, rc, kmer_solid_bits, "k-mer solid bits")
    return out


def kmer_insert(seq: torch.Tensor, n: int, k: int, hash_num: int, words: torch.Tensor,
                layout: str, modulus: int, solid=None, slots: int = 0) -> None:
    """Insertion of the valid windows of [0, n) whose slots are all set in
    ``solid`` (every valid window when it is None) into ``words``, in place;
    ``modulus`` is the word count (blocked, a power of two) or the bit count
    (plain)."""
    if layout not in LAYOUTS:
        raise ValueError(f"unknown layout {layout!r}")
    if hash_num < 1:
        raise ValueError(f"hash_num must be at least 1, got {hash_num}")
    if layout == "blocked" and (modulus & (modulus - 1) or hash_num * 5 + modulus.bit_length() - 1 > 64):
        raise ValueError("blocked words need a power-of-two count and "
                         "hash_num * 5 + log2(words) <= 64")
    need = modulus if layout == "blocked" else -(-modulus // 32)
    if modulus < 1 or words.numel() < need:
        raise ValueError(f"words holds {words.numel()} of the {need} the layout needs")
    if solid is not None:
        if slots < 1:
            raise ValueError(f"solid bits need at least one slot, got {slots}")
        if solid.numel() < -(-slots // 32):
            raise ValueError(f"solid holds {solid.numel()} of the {-(-slots // 32)} words "
                             f"of {slots} slots")
    if seq.device.type == "cpu":
        return kmer_insert_bits_plain(seq, n, k, hash_num, words, layout, modulus, solid, slots)
    lib = load_library()
    _check_seq(seq, n, k)
    _check_table(words, torch.int32, seq.device, "words", need)
    if solid is not None:
        _check_table(solid, torch.int32, seq.device, "solid", -(-slots // 32))
    if n <= 0:
        return None
    blocked = layout == "blocked"
    rc = lib.ntb_kmer_insert(
        seq.data_ptr(), n, k, hash_num,
        None if solid is None else solid.data_ptr(), slots if solid is not None else 0,
        mod_magic(slots) if solid is not None else 0,
        words.data_ptr(), modulus, 0 if blocked else mod_magic(modulus),
        modulus.bit_length() - 1 if blocked else 0, LAYOUT_CODE[layout], _stream(seq))
    _launched(lib, rc, kmer_insert, "k-mer insert")
    return None


def atomic_floor(table: torch.Tensor, ops: int, threads: int) -> torch.Tensor:
    """The random-atomic floor on the card: ``threads`` threads make ``ops``
    uniformly random ``atomicAdd(table[i], 1)`` (int32 ``table``), with the
    apply kernel's entries in flight each, and nothing else; returns each
    thread's sum of the old values.  The table's sum rises by ``ops``.  A
    measuring stick: in no launch count."""
    lib = load_library()
    if table.device.type != "cuda" or table.dtype != torch.int32 or table.dim() != 1 \
            or not table.is_contiguous():
        raise ValueError("the atomic floor needs a contiguous 1-D int32 CUDA table")
    if ops * (threads + 1) > gate_kernel.MASK64:
        raise ValueError("the atomic floor needs ops * threads < 2^64")
    out = torch.empty(threads, dtype=torch.int32, device=table.device)
    rc = lib.ntb_atomic_floor(table.data_ptr(), table.numel(), mod_magic(table.numel()), ops,
                              threads, out.data_ptr(), _stream(table))
    _raise_if_failed(lib, rc, "atomic floor")
    return out


_count_lock = threading.Lock()
# kernel launches since the last reset
kmer_valid_hashes.launches = 0
kmer_partition.launches = 0
kmer_count_apply.launches = 0
kmer_solid_bits.launches = 0
kmer_insert.launches = 0
KERNELS = (kmer_valid_hashes, kmer_partition, kmer_count_apply, kmer_solid_bits, kmer_insert)

OCCUPANCY_FORMS = ("kmer_valid_hashes", "kmer_partition_count", "kmer_partition_scatter",
                   "kmer_count_apply", "kmer_solid_bits", "kmer_insert_plain",
                   "kmer_insert_blocked", "atomic_floor", "kmer_valid_count",
                   "kmer_valid_count_sampled")


def occupancy() -> dict:
    """Resident blocks per SM of each kernel form on the current card;
    negative on error."""
    lib = load_library()
    return {name: lib.ntb_occupancy(i) for i, name in enumerate(OCCUPANCY_FORMS)}
