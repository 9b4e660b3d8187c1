"""The gate pass: CUDA kernel wrapper and its plain torch version.

``gate_words(seq, n, df, snv, min_threshold)`` returns the gate bitmap of
heads [0, n) of an ASCII sequence as little-endian uint32 words (stored
as int32): head 32*w + i is bit i of word w, and bits of heads >= n are 0.

    gate(h) = valid(h) & (snv | ~present(h) | low_count(h) | has_iupac(h))

* ``valid``: every byte of the window passes isAcceptedBase, case-folded;
* ``has_iupac``: some byte of the window is accepted but not ACGTacgt;
* ``low_count``: counting filter, min_threshold > 1 and count < it.

On a CUDA tensor the wrapper launches csrc/gate_kernel.cu (built with
nvcc at first use, see utils/build.py) or raises; on a CPU tensor it runs
``gate_words_plain``.  The kernel replaces the JAX package's Pallas kernel
(ops/flag_kernel.py) and, on the main path, its XLA gate program
(engine/flag.py::_gate_words_from_codes); see the note in the .cu source.
"""

from __future__ import annotations

import ctypes
import os
import threading

import numpy as np
import torch

from ntedit_tpu_torch.core import nthash as nt
from ntedit_tpu_torch.engine.config import ACCEPTED
from ntedit_tpu_torch.utils.build import build_library

TILE = 8192  # heads per CUDA block: 256 threads x 32 heads
HALO = 1024  # bytes a block may read past its tile
MAX_K = HALO + 1
BATCH = 2  # heads a thread hashes before their probes issue (csrc kBatch)
LAYOUT_CODE = {"plain": 0, "blocked": 1, "counting": 2}
MASK64 = (1 << 64) - 1

SOURCE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                      "csrc", "gate_kernel.cu")


def padded_len(n: int) -> int:
    """Bytes the kernel reads for heads [0, n): whole tiles plus the halo."""
    return -(-n // TILE) * TILE + HALO


def mod_magic(m: int) -> int:
    """The kernel's reciprocal of a modulus ``m``: floor((2^64 - 1) / m).

    With it ``q = floor(x * magic / 2^64)`` is floor(x / m) or one less
    for every 64-bit x (magic = (2^64 - e) / m with 0 < e <= m, so
    x * magic / 2^64 > x / m - 1), and one correction step makes
    ``x - q * m`` the exact remainder (the kernel's ``fastmod``)."""
    if not 0 < m <= MASK64:
        raise ValueError(f"modulus {m} outside [1, 2^64)")
    return MASK64 // m


# byte classes: bit 0 = fails isAcceptedBase, bit 1 = accepted IUPAC
_CLASS = np.ones(256, dtype=np.uint8)
for _c in ACCEPTED:
    _CLASS[_c] = _CLASS[_c | 0x20] = 0 if _c in b"ACGT" else 2


def window_flags(seq: torch.Tensor, n: int, k: int) -> tuple:
    """(valid, has_iupac) bool [n] for the windows of ASCII ``seq``."""
    cls = torch.from_numpy(_CLASS).to(seq.device)[seq[: n + k - 1].long()]
    out = []
    for bit in (1, 2):
        c = torch.cumsum((cls & bit != 0).long(), 0)
        c = torch.cat([torch.zeros(1, dtype=torch.int64, device=seq.device), c])
        out.append(c[k : k + n] - c[:n] > 0)
    return ~out[0], out[1]


def pack_bits(gate: torch.Tensor) -> torch.Tensor:
    """bool [n] -> little-endian uint32 words [ceil(n/32)], held as int32."""
    n = gate.shape[0]
    bits = torch.zeros(-(-n // 32) * 32, dtype=torch.int64, device=gate.device)
    bits[:n] = gate.long()
    lanes = torch.arange(32, dtype=torch.int64, device=gate.device)
    words = (bits.view(-1, 32) << lanes).sum(1)
    return torch.where(words >= 1 << 31, words - (1 << 32), words).to(torch.int32)


def gate_words_plain(seq: torch.Tensor, n: int, df, snv: bool = False,
                     min_threshold: int = 1) -> torch.Tensor:
    """The gate pass in plain torch int64, on any device."""
    k = df.k
    if n <= 0:
        return torch.zeros(0, dtype=torch.int32, device=seq.device)
    s = seq[: n + k - 1]
    valid, iupac = window_flags(s, n, k)
    fh, rh = nt.window_hashes(s, k)
    can = nt.canonical(fh, rh)
    hashes = [can] if df.blocked else nt.extend(can, k, df.hash_num)
    gate = iupac | snv
    if df.counting:
        cnt = df.count(hashes)
        gate = gate | (cnt == 0)
        if min_threshold > 1:
            gate = gate | (cnt < min_threshold)
    else:
        gate = gate | ~df.contains(hashes)
    return pack_bits(gate & valid)


_lib = None
_lib_lock = threading.Lock()


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found: the gate kernel needs nvcc")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def _command(src: str, out: str) -> list:
    return [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
            "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC", "-o", out, src]


def build(force: bool = False) -> str:
    """Compile the kernel (once per source content); returns the .so path."""
    return build_library("gate_kernel", SOURCE, _command, force=force)


def build_log() -> str:
    """What nvcc printed when it built the library: ptxas's registers,
    shared memory and spills per kernel (``-Xptxas -v``)."""
    with open(build() + ".log") as f:
        return f.read()


def open_library(path: str, batch: int = BATCH):
    """Load a build of the kernel and declare its C interface.  Raises when
    it cannot be loaded or its tile, halo or batch (``batch``: the build's
    kBatch) differ from the wrapper's."""
    lib = ctypes.CDLL(path)
    lib.ntg_gate_words.restype = ctypes.c_int
    lib.ntg_gate_words.argtypes = [
        ctypes.c_void_p, ctypes.c_uint64, ctypes.c_int,     # seq, n, k
        ctypes.c_void_p, ctypes.c_uint64, ctypes.c_uint64,  # table, modulus, magic
        ctypes.c_int, ctypes.c_int, ctypes.c_int,           # wbits, layout, hash_num
        ctypes.c_int, ctypes.c_int,                         # snv, min_threshold
        ctypes.c_void_p, ctypes.c_void_p,                   # out, stream
    ]
    lib.ntg_probe_floor.restype = ctypes.c_int
    lib.ntg_probe_floor.argtypes = [
        ctypes.c_void_p, ctypes.c_uint64, ctypes.c_uint64, ctypes.c_int,  # table, size, magic, elem
        ctypes.c_uint64, ctypes.c_uint64, ctypes.c_int,     # probes, threads, batch
        ctypes.c_void_p, ctypes.c_void_p,                   # out, stream
    ]
    lib.ntg_occupancy.restype = ctypes.c_int
    lib.ntg_occupancy.argtypes = [ctypes.c_int]
    for name in ("ntg_tile_heads", "ntg_halo_bytes", "ntg_batch"):
        getattr(lib, name).restype = ctypes.c_int
        getattr(lib, name).argtypes = []
    lib.ntg_error_string.restype = ctypes.c_char_p
    lib.ntg_error_string.argtypes = [ctypes.c_int]
    if (lib.ntg_tile_heads(), lib.ntg_halo_bytes(), lib.ntg_batch()) != (TILE, HALO, batch):
        raise RuntimeError("gate kernel tile/halo/batch differ from the wrapper's")
    return lib


def load_library():
    """The kernel's ctypes library, built at first use.  Raises when it
    cannot be built or loaded."""
    global _lib
    with _lib_lock:
        if _lib is None:
            _lib = open_library(build())
        return _lib


def gate_words(seq: torch.Tensor, n: int, df, snv: bool = False,
               min_threshold: int = 1) -> torch.Tensor:
    """Gate words of heads [0, n) of ``seq`` (see the module docstring).

    On CUDA, ``seq`` is a uint8 buffer of at least ``padded_len(n)`` bytes
    starting 16-byte aligned (bytes past the contig are ignored); the
    kernel runs on the current stream and the call does not synchronise."""
    if seq.device.type == "cpu":
        return gate_words_plain(seq, n, df, snv, min_threshold)
    lib = load_library()
    k = df.k
    if seq.device.type != "cuda" or df.device != seq.device:
        raise ValueError(f"gate kernel needs seq and filter on one CUDA device "
                         f"(got {seq.device} and {df.device})")
    if seq.dtype != torch.uint8 or seq.dim() != 1 or not seq.is_contiguous():
        raise ValueError("gate kernel needs a contiguous 1-D uint8 sequence")
    if not 1 <= k <= MAX_K:
        raise ValueError(f"gate kernel supports 1 <= k <= {MAX_K}, got k={k}")
    if seq.numel() < padded_len(n) or seq.data_ptr() % 16:
        raise ValueError(f"gate kernel needs {padded_len(n)} bytes from a 16-byte "
                         f"aligned start (got {seq.numel()} at {seq.data_ptr() % 16})")
    out = torch.empty(max(0, -(-n // 32)), dtype=torch.int32, device=seq.device)
    if n <= 0:
        return out
    rc = lib.ntg_gate_words(
        seq.data_ptr(), n, k, df.table.data_ptr(), df.modulus,
        0 if df.blocked else mod_magic(df.modulus),
        df.wbits if df.blocked else 0, LAYOUT_CODE[df.layout], df.hash_num,
        int(bool(snv)), int(min_threshold), out.data_ptr(),
        torch.cuda.current_stream(seq.device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"gate kernel launch failed: {lib.ntg_error_string(rc).decode()}")
    with _count_lock:
        gate_words.launches += 1
    return out


_count_lock = threading.Lock()
gate_words.launches = 0  # kernel launches since the last reset


OCCUPANCY_FORMS = ("plain", "blocked", "counting", "floor_words", "floor_counters")


def occupancy() -> dict:
    """Resident blocks per SM of each kernel form on the current card
    (cudaOccupancyMaxActiveBlocksPerMultiprocessor at the launch's block
    size); negative on error."""
    lib = load_library()
    return {name: lib.ntg_occupancy(i) for i, name in enumerate(OCCUPANCY_FORMS)}


def mix64(c: int) -> int:
    """splitmix64 of counter ``c``: the floor kernel's random index."""
    z = ((c + 1) * 0x9E3779B97F4A7C15) & MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & MASK64
    return z ^ (z >> 31)


def probe_floor(table: torch.Tensor, probes: int, threads: int,
                batch: int = BATCH) -> torch.Tensor:
    """The random-probe floor on the card: ``threads`` threads (blocks of
    the gate kernel's size) make ``probes`` uniformly random probes of
    ``table`` (int32 words or uint8 counters), ``batch`` (1 to 8) loads in
    flight each (the gate kernel's by default), and nothing else; returns each
    thread's XOR of what it read (int32 [threads]).  A measuring stick: not
    in ``gate_words.launches``."""
    lib = load_library()
    if table.device.type != "cuda" or table.dim() != 1 or not table.is_contiguous():
        raise ValueError("probe floor needs a contiguous 1-D CUDA table")
    if table.dtype not in (torch.int32, torch.uint8):
        raise ValueError(f"probe floor reads int32 words or uint8 counters, not {table.dtype}")
    if probes * (threads + 1) > MASK64:
        raise ValueError("probe floor needs probes * threads < 2^64")
    out = torch.empty(threads, dtype=torch.int32, device=table.device)
    rc = lib.ntg_probe_floor(table.data_ptr(), table.numel(), mod_magic(table.numel()),
                             table.element_size(), probes, threads, batch, out.data_ptr(),
                             torch.cuda.current_stream(table.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"probe floor launch failed: {lib.ntg_error_string(rc).decode()}")
    return out


def probe_floor_word(table: np.ndarray, probes: int, threads: int, tid: int) -> int:
    """The floor kernel's word for thread ``tid``, in Python (its plain
    version): XOR of table[mix64(c) % size] over the thread's probes c."""
    acc = 0
    for c in range(probes * tid // threads, probes * (tid + 1) // threads):
        acc ^= int(table[mix64(c) % table.size]) & 0xFFFFFFFF
    return acc
