"""The filter-build passes: CUDA kernel wrappers and their plain torch versions.

Each pass reads one batch of separator-joined records as ASCII, ``seq``,
and its windows [0, n).  A window is valid when its k bytes are all
ACGTacgt; only valid windows count.  For a valid window with canonical
ntHash2 value ``can``, hash j is ``can`` for j = 0 and NTM64's extension
of it otherwise (``nthash.extend``).

* ``kmer_hashes(seq, n, k)`` -> (int64 [n] canonical hashes, 0 where
  invalid; int32 [ceil(n/32)] validity words, little-endian like the gate
  words).  ``valid_hashes`` compacts them.
* ``kmer_count(seq, n, k, hash_num, counters, slots)`` adds one, saturating
  at 255, to counter ``h_j mod slots`` of the uint8 table ``counters``, for
  every valid window and every j < hash_num (btllib's counting filter).
* ``kmer_insert(seq, n, k, hash_num, words, layout, modulus, counters,
  slots, cutoff)`` ORs the bits of every valid window whose hash_num
  counters are all at least ``cutoff`` (every valid window when cutoff <= 1)
  into ``words`` (uint32 bits held as int32): ``blocked``, one word
  ``can & (modulus - 1)`` with hash_num 5-bit offsets from bits
  ``log2(modulus) + 5j`` of ``can``; ``plain``, bit ``h_j mod modulus``,
  little-endian, so the words' bytes are the btllib filter's.

``counters`` and ``words`` are updated in place.  On a CUDA tensor a wrapper
launches csrc/build_kernel.cu (built with nvcc at first use) on the current
stream, does not synchronise, and raises when it cannot; on a CPU tensor it
runs its plain version.  The kernels replace the JAX package's XLA programs
core/bfbuild.py::DeviceFilterBuilder._count_fn and _insert_fn and its host
numpy build passes; see the note in the .cu source.
"""

from __future__ import annotations

import ctypes
import os
import threading

import torch

from ntedit_tpu_torch.core import nthash as nt
from ntedit_tpu_torch.ops import gate_kernel
from ntedit_tpu_torch.ops.gate_kernel import HEADER, LAYOUT_CODE, MAX_K, mod_magic, padded_len
from ntedit_tpu_torch.utils.build import build_library

SOURCE = os.path.join(gate_kernel.CSRC, "build_kernel.cu")
LAYOUTS = ("blocked", "plain")


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def kmer_hashes_plain(seq: torch.Tensor, n: int, k: int) -> tuple:
    """The hashes pass in plain torch int64, on any device."""
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


def _slot_counts(can: torch.Tensor, k: int, hash_num: int, slots: int) -> tuple:
    """(slots, increments): every slot ``h_j mod slots`` of ``can`` once,
    with the number of (window, j) that land on it."""
    idx = torch.cat([nt.umod(h, slots) for h in nt.extend(can, k, hash_num)])
    return torch.unique(idx, return_counts=True)


def kmer_count_plain(seq: torch.Tensor, n: int, k: int, hash_num: int,
                     counters: torch.Tensor, slots: int) -> None:
    """The count pass in plain torch, on any device: per-slot totals, then
    one clamped add (saturation is monotone, so this equals one saturating
    increment at a time, KmerCountingBloomFilter8.insert_hashes)."""
    can = valid_hashes_plain(seq, n, k)
    if not can.numel():
        return
    idx, inc = _slot_counts(can, k, hash_num, slots)
    counters[idx] = torch.clamp(counters[idx].long() + inc, max=255).to(torch.uint8)


def valid_hashes_plain(seq: torch.Tensor, n: int, k: int) -> torch.Tensor:
    """int64 [v]: the canonical hashes of the valid windows, in order, by
    the plain version."""
    can, words = kmer_hashes_plain(seq, n, k)
    return can[unpack_bits(words, n)]


def min_count(can: torch.Tensor, k: int, hash_num: int, counters: torch.Tensor,
              slots: int) -> torch.Tensor:
    """uint8 [n]: the count-min read of each canonical hash."""
    cnt = None
    for h in nt.extend(can, k, hash_num):
        got = counters[nt.umod(h, slots)]
        cnt = got if cnt is None else torch.minimum(cnt, got)
    return cnt


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


def kmer_insert_plain(seq: torch.Tensor, n: int, k: int, hash_num: int, words: torch.Tensor,
                      layout: str, modulus: int, counters=None, slots: int = 0,
                      cutoff: int = 1) -> None:
    """The insert pass in plain torch, on any device."""
    can = valid_hashes_plain(seq, n, k)
    if cutoff > 1 and can.numel():
        can = can[min_count(can, k, hash_num, counters, slots).long() >= cutoff]
    if not can.numel():
        return
    if layout == "blocked":
        bits = blocked_bits(can, hash_num, modulus)
    else:
        bits = torch.stack([nt.umod(h, modulus) for h in nt.extend(can, k, hash_num)])
    or_bits(words, bits)


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
    when it cannot be loaded or its tile or halo differ from the wrapper's."""
    lib = ctypes.CDLL(path)
    ptr, u64, i32 = ctypes.c_void_p, ctypes.c_uint64, ctypes.c_int
    lib.ntb_kmer_hashes.restype = i32
    lib.ntb_kmer_hashes.argtypes = [ptr, u64, i32, ptr, ptr, ptr]  # seq, n, k, hashes, valid, stream
    lib.ntb_kmer_count.restype = i32
    lib.ntb_kmer_count.argtypes = [ptr, u64, i32, i32,              # seq, n, k, hash_num
                                   ptr, u64, u64, ptr]              # counters, slots, magic, stream
    lib.ntb_kmer_insert.restype = i32
    lib.ntb_kmer_insert.argtypes = [ptr, u64, i32, i32,             # seq, n, k, hash_num
                                    ptr, u64, u64, i32,             # counters, slots, magic, cutoff
                                    ptr, u64, u64, i32, i32, ptr]   # words, modulus, magic, wbits,
    #                                                                 layout, stream
    lib.ntb_occupancy.restype = i32
    lib.ntb_occupancy.argtypes = [i32]
    for name in ("ntb_tile_heads", "ntb_halo_bytes"):
        getattr(lib, name).restype = i32
        getattr(lib, name).argtypes = []
    lib.ntb_error_string.restype = ctypes.c_char_p
    lib.ntb_error_string.argtypes = [i32]
    if (lib.ntb_tile_heads(), lib.ntb_halo_bytes()) != (gate_kernel.TILE, gate_kernel.HALO):
        raise RuntimeError("build kernel tile/halo differ from the wrapper's")
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


def _check_table(t: torch.Tensor, dtype, seq: torch.Tensor, what: str, need: int) -> None:
    if t.device != seq.device or t.dtype != dtype or t.dim() != 1 or not t.is_contiguous():
        raise ValueError(f"{what} must be a contiguous 1-D {dtype} tensor on {seq.device}")
    if t.numel() < need or t.data_ptr() % 4:
        raise ValueError(f"{what} needs {need} elements from a 4-byte aligned start")


def _launched(lib, rc: int, fn, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} kernel launch failed: {lib.ntb_error_string(rc).decode()}")
    with _count_lock:
        fn.launches += 1


def _stream(seq: torch.Tensor) -> int:
    return torch.cuda.current_stream(seq.device).cuda_stream


def kmer_hashes(seq: torch.Tensor, n: int, k: int) -> tuple:
    """(hashes, validity words) of windows [0, n) of ``seq`` (see the module
    docstring).  On CUDA, ``seq`` holds ``padded_len(n)`` bytes from a
    16-byte aligned start."""
    if seq.device.type == "cpu":
        return kmer_hashes_plain(seq, n, k)
    lib = load_library()
    _check_seq(seq, n, k)
    hashes = torch.empty(max(0, n), dtype=torch.int64, device=seq.device)
    valid = torch.empty(max(0, -(-n // 32)), dtype=torch.int32, device=seq.device)
    if n <= 0:
        return hashes, valid
    rc = lib.ntb_kmer_hashes(seq.data_ptr(), n, k, hashes.data_ptr(), valid.data_ptr(), _stream(seq))
    _launched(lib, rc, kmer_hashes, "k-mer hashes")
    return hashes, valid


def valid_hashes(seq: torch.Tensor, n: int, k: int) -> torch.Tensor:
    """int64 [v]: the canonical hashes of the valid windows, in order."""
    hashes, words = kmer_hashes(seq, n, k)
    return hashes[unpack_bits(words, n)]


def _check_counters(counters: torch.Tensor, slots: int, seq: torch.Tensor) -> None:
    if slots < 1:
        raise ValueError(f"a counter table needs at least one slot, got {slots}")
    if seq.device.type == "cuda":
        _check_table(counters, torch.uint8, seq, "counters", -(-slots // 4) * 4)
    elif counters.numel() < slots:
        raise ValueError(f"counters holds {counters.numel()} of {slots} slots")


def kmer_count(seq: torch.Tensor, n: int, k: int, hash_num: int, counters: torch.Tensor,
               slots: int) -> None:
    """Count-min increments of the valid windows of [0, n) into
    ``counters[:slots]``, in place.  On CUDA the table is padded to a
    multiple of 4 bytes (the kernel raises bytes through 32-bit CAS)."""
    if hash_num < 1:
        raise ValueError(f"hash_num must be at least 1, got {hash_num}")
    _check_counters(counters, slots, seq)
    if seq.device.type == "cpu":
        return kmer_count_plain(seq, n, k, hash_num, counters, slots)
    lib = load_library()
    _check_seq(seq, n, k)
    if n <= 0:
        return None
    rc = lib.ntb_kmer_count(seq.data_ptr(), n, k, hash_num, counters.data_ptr(), slots,
                            mod_magic(slots), _stream(seq))
    _launched(lib, rc, kmer_count, "k-mer count")
    return None


def kmer_insert(seq: torch.Tensor, n: int, k: int, hash_num: int, words: torch.Tensor,
                layout: str, modulus: int, counters=None, slots: int = 0,
                cutoff: int = 1) -> None:
    """Threshold insertion of the valid windows of [0, n) into ``words``, in
    place; ``modulus`` is the word count (blocked, a power of two) or the bit
    count (plain).  ``counters``/``slots`` are read only when cutoff > 1."""
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
    if cutoff > 1:
        _check_counters(counters, slots, seq)
    if seq.device.type == "cpu":
        return kmer_insert_plain(seq, n, k, hash_num, words, layout, modulus, counters, slots,
                                 cutoff)
    lib = load_library()
    _check_seq(seq, n, k)
    _check_table(words, torch.int32, seq, "words", need)
    if n <= 0:
        return None
    blocked = layout == "blocked"
    rc = lib.ntb_kmer_insert(
        seq.data_ptr(), n, k, hash_num,
        counters.data_ptr() if cutoff > 1 else None, slots if cutoff > 1 else 0,
        mod_magic(slots) if cutoff > 1 else 0, int(cutoff),
        words.data_ptr(), modulus, 0 if blocked else mod_magic(modulus),
        modulus.bit_length() - 1 if blocked else 0, LAYOUT_CODE[layout], _stream(seq))
    _launched(lib, rc, kmer_insert, "k-mer insert")
    return None


_count_lock = threading.Lock()
kmer_hashes.launches = 0  # kernel launches since the last reset
kmer_count.launches = 0
kmer_insert.launches = 0

OCCUPANCY_FORMS = ("kmer_hashes", "kmer_count", "kmer_insert_plain", "kmer_insert_blocked")


def occupancy() -> dict:
    """Resident blocks per SM of each kernel form on the current card;
    negative on error."""
    lib = load_library()
    return {name: lib.ntb_occupancy(i) for i, name in enumerate(OCCUPANCY_FORMS)}
