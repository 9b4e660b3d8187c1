"""ctypes binding of the batch FASTA/FASTQ(.gz) reader
(csrc/fastx_reader.cpp), the counterpart of the JAX package's io/native.py.

The reader fills flat batch buffers (one concatenated sequence byte array
and offset arrays per batch), so the Python side takes numpy slices
without per-line Python work: the reason the reference keeps its readers
native (kseq, btllib::SeqReader).  The library is built with g++ and zlib
into the package's ``_build/`` directory at first use (utils/build.py); a
build or load that fails raises, with the compiler's output.  There is no
fallback: ``fastx.read_fastx_plain`` is the plain version the tests hold
the reader to, and nothing on the main path reads through it.

A gzip file's members are decoded one at a time by the reader's own
inflater (csrc/inflate.h) into one buffer: whole where a member's output is
at most ``WHOLE_CAP`` bytes (and a quarter of the host's available
memory), else in stretches of whole deflate blocks of at most that.  From a
member it refuses to the file's end, and in a file that is not mapped,
zlib's gzread reads.  The counters ``io.inflate_whole_bytes`` and
``io.inflate_stream_bytes`` (utils/profiling.py) add each file's decoded
bytes by inflater.

``read_batches.opens`` counts the opens of each path, for the filter
build's one read of the reads (core/bfbuild.py).
"""

from __future__ import annotations

import collections
import ctypes
import os
import threading
from typing import Iterator, Optional

import numpy as np

from ntedit_tpu_torch.utils import profiling
from ntedit_tpu_torch.utils.build import build_library, host_cpu

SOURCE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                      "csrc", "fastx_reader.cpp")
HEADERS = [os.path.join(os.path.dirname(SOURCE), "inflate.h")]

SEQ_CAP = 1 << 24  # 16 MiB of sequence per batch (grown for a larger record)
HDR_CAP = 1 << 20
MAX_REC = 1 << 15
# the most bytes of a gzip member decoded in one stretch: a read file of a
# bacterial genome at 30x is one member of ~150 MB, decoded whole; a human
# read file's one member of ~100 GB is decoded 1 GiB at a time
WHOLE_CAP = 1 << 30

_lib = None
_lib_lock = threading.Lock()


def _command(src: str, out: str) -> list:
    return ["g++", "-O3", "-march=native", "-std=c++17", "-Wall", "-shared", "-fPIC",
            "-o", out, src, "-lz"]


def build(force: bool = False) -> str:
    """Build the reader library (g++ and zlib) and return its path."""
    return build_library("ntpu_io", SOURCE, _command, force=force, salt=host_cpu(),
                         deps=HEADERS)


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the reader's C interface on ``lib``."""
    lib.ntpu_fastx_open.restype = ctypes.c_void_p
    lib.ntpu_fastx_open.argtypes = [ctypes.c_char_p, ctypes.c_long]
    lib.ntpu_fastx_inflated.restype = None
    lib.ntpu_fastx_inflated.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_ulonglong)]
    lib.zlibVersion.restype = ctypes.c_char_p
    lib.ntpu_fastx_close.restype = None
    lib.ntpu_fastx_close.argtypes = [ctypes.c_void_p]
    lib.ntpu_fastx_error.restype = ctypes.c_char_p
    lib.ntpu_fastx_error.argtypes = [ctypes.c_void_p]
    lib.ntpu_fastx_next.restype = ctypes.c_long
    lib.ntpu_fastx_next.argtypes = [
        ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_long, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_long, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_int),
        ctypes.c_long,
    ]
    return lib


def get_lib() -> ctypes.CDLL:
    """Load the reader library, building it at first use."""
    global _lib
    with _lib_lock:
        if _lib is None:
            _lib = bind(ctypes.CDLL(build()))
    return _lib


def inflater() -> str:
    """The inflaters the loaded library reads gzip members with."""
    return f"csrc/inflate.h, zlib {get_lib().zlibVersion().decode()}"


def whole_cap() -> int:
    """``WHOLE_CAP``, or a quarter of the host's available memory where
    that is less."""
    try:
        with open("/proc/meminfo") as f:
            avail = next(int(l.split()[1]) * 1024 for l in f if l.startswith("MemAvailable:"))
    except (OSError, StopIteration):
        avail = os.sysconf("SC_AVPHYS_PAGES") * os.sysconf("SC_PAGE_SIZE")
    return min(WHOLE_CAP, avail // 4)


def _ptr(a: np.ndarray) -> ctypes.c_void_p:
    return a.ctypes.data_as(ctypes.c_void_p)


def read_batches(path: str, want_headers: bool = True) -> Iterator[
        tuple[np.ndarray, np.ndarray, Optional[list], Optional[np.ndarray]]]:
    """Yield (seq_bytes, seq_offsets, headers, qual_bytes) batches.

    seq_bytes: uint8 [total]; record i = seq_bytes[offs[i]:offs[i+1]];
    headers: the header strings (after the '>'/'@' tag byte), or None when
    ``want_headers`` is False (bulk k-mer consumers skip the decode);
    qual_bytes: uint8 with the same offsets (None for FASTA).  A batch
    holds at most 16 MiB of sequence; a record larger than that comes in a
    batch of its own, the buffers grown for it.  Malformed input raises
    ValueError, a read error (a truncated gzip stream) OSError."""
    lib = get_lib()
    h = lib.ntpu_fastx_open(os.fsencode(path), whole_cap())
    if not h:
        raise OSError(f"cannot open {path}")
    read_batches.opens[path] += 1
    seq_cap, hdr_cap = SEQ_CAP, HDR_CAP
    seq_offs = np.empty(MAX_REC + 1, dtype=np.int64)
    hdr_offs = np.empty(MAX_REC + 1, dtype=np.int64)
    is_fastq = ctypes.c_int(0)
    try:
        seq_buf = qual_buf = hdr_buf = None
        while True:
            if seq_buf is None or len(seq_buf) < seq_cap:
                seq_buf = np.empty(seq_cap, dtype=np.uint8)
                qual_buf = np.empty(seq_cap, dtype=np.uint8)
                hdr_buf = np.empty(hdr_cap, dtype=np.uint8)
            n = lib.ntpu_fastx_next(h, _ptr(seq_buf), seq_cap, _ptr(seq_offs),
                                    _ptr(hdr_buf), hdr_cap, _ptr(hdr_offs),
                                    _ptr(qual_buf), ctypes.byref(is_fastq), MAX_REC)
            if n == -2:  # one record outgrew the buffers: it is read again
                seq_cap *= 4
                hdr_cap *= 4
                continue
            err = lib.ntpu_fastx_error(h)
            if err:
                raise OSError(f"{path}: {err.decode()}")
            if n == -1:
                raise ValueError(f"{path}: malformed FASTA/FASTQ")
            if n == 0:
                return
            total = int(seq_offs[n])
            hdrs = None
            if want_headers:
                hb = hdr_buf[: hdr_offs[n]].tobytes()
                hdrs = [hb[hdr_offs[i]: hdr_offs[i + 1]].decode() for i in range(n)]
            quals = qual_buf[:total].copy() if is_fastq.value else None
            yield seq_buf[:total].copy(), seq_offs[: n + 1].copy(), hdrs, quals
    finally:
        inflated = (ctypes.c_ulonglong * 2)()
        lib.ntpu_fastx_inflated(h, inflated)
        lib.ntpu_fastx_close(h)
        profiling.count("io.inflate_whole_bytes", inflated[0])
        profiling.count("io.inflate_stream_bytes", inflated[1])


read_batches.opens = collections.Counter()
