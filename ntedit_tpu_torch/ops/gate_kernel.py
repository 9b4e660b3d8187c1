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
HALO = 1024  # bytes a block reads past its tile
MAX_K = HALO + 1
LAYOUT_CODE = {"plain": 0, "blocked": 1, "counting": 2}

SOURCE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                      "csrc", "gate_kernel.cu")


def padded_len(n: int) -> int:
    """Bytes the kernel reads for heads [0, n): whole tiles plus the halo."""
    return -(-n // TILE) * TILE + HALO


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
            "-shared", "-Xcompiler", "-fPIC", "-o", out, src]


def build(force: bool = False) -> str:
    """Compile the kernel (once per source content); returns the .so path."""
    return build_library("gate_kernel", SOURCE, _command, force=force)


def load_library():
    """The kernel's ctypes library, built at first use.  Raises when it
    cannot be built or loaded."""
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            lib.ntg_gate_words.restype = ctypes.c_int
            lib.ntg_gate_words.argtypes = [
                ctypes.c_void_p, ctypes.c_uint64, ctypes.c_int,     # seq, n, k
                ctypes.c_void_p, ctypes.c_uint64, ctypes.c_int,     # table, modulus, wbits
                ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,  # layout, hash_num, snv, min_thr
                ctypes.c_void_p, ctypes.c_void_p,                   # out, stream
            ]
            lib.ntg_error_string.restype = ctypes.c_char_p
            lib.ntg_error_string.argtypes = [ctypes.c_int]
            if lib.ntg_tile_heads() != TILE or lib.ntg_halo_bytes() != HALO:
                raise RuntimeError("gate kernel tile/halo differ from the wrapper's")
            _lib = lib
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
