"""The batch reader on gzip FASTQ files, builds of it timed in turns.

    python -m ntedit_tpu_torch.utils.reader_sweep [--against DIR] [--rounds N] [--scale S]

Files, made in a temporary directory from a fixed seed: the two mates of
the benchmark's ``ecoli_k25.reads`` cell (696,247 pairs of 100 bp reads,
300 bp fragments, 0.2% substitutions, from a 4.64 Mbp genome; FASTQ of
150,389,352 bytes each at ``gzip -1``, one member), and one member of
5,100,000 reads (1,101,600,000 bytes: just over ``native.WHOLE_CAP``, so
decoded in two stretches).  ``--scale`` shrinks both (a quick check on a
small host).

Builds of the reader: this checkout's (``this``); the same without the
buffer one reader keeps for the next (``no_spare``,
``-DNTPU_READER_NO_SPARE``); this checkout's with a cap of 0, every member
read by gzread (``gzread``); and with ``--against DIR`` that checkout's
reader (``other``: ``DIR/ntedit_tpu_torch/csrc``).

Per file set and build, in turns for ``--rounds`` rounds (each build
first in turn): ``reader_ms``,
every batch read as ``native.read_batches(want_headers=False)`` reads it
(the records' copies included); for this checkout's builds also
``io_read_ms``, the filter build's read of the mates
(``bfbuild._pieces(_separated(...))``, what the span ``io.read`` times).
One JSON line a file set, the rounds' medians and every round.
"""

from __future__ import annotations

import argparse
import ctypes
import gzip
import json
import os
import shutil
import statistics
import tempfile
import time

import numpy as np

from ntedit_tpu_torch.io import native
from ntedit_tpu_torch.utils.build import build_library, host_cpu

COMPLEMENT = np.frombuffer(b"TGCA", dtype=np.uint8)
ACGT = np.frombuffer(b"ACGT", dtype=np.uint8)


def fastq(reads: np.ndarray, mate: int) -> bytes:
    """The benchmark's FASTQ text: ``@r<7 digits>/<mate>``, bases, ``+``, I."""
    n, L = reads.shape
    head = np.frombuffer(b"@r0000000/%d\n" % mate, dtype=np.uint8)
    rec = np.empty((n, len(head) + 2 * L + 4), dtype=np.uint8)
    rec[:, : len(head)] = head
    idx = np.arange(n)
    for p in range(7):
        rec[:, 8 - p] = 48 + (idx // 10**p) % 10
    o = len(head)
    rec[:, o: o + L] = reads
    rec[:, o + L: o + L + 3] = np.frombuffer(b"\n+\n", dtype=np.uint8)
    rec[:, o + L + 3: o + 2 * L + 3] = ord("I")
    rec[:, -1] = ord("\n")
    return rec.tobytes()


def mates(rng, genome: np.ndarray, pairs: int, read_bp=100, fragment_bp=300, sub=0.002):
    """Two [pairs, read_bp] arrays: a fragment's start, and the reverse
    complement of its end; substitutions at rate ``sub``."""
    start = rng.integers(0, len(genome) - fragment_bp + 1, size=(pairs, 1))
    offs = np.arange(read_bp)
    code = np.zeros(256, dtype=np.uint8)
    code[ACGT] = np.arange(4, dtype=np.uint8)
    out = []
    for bases in (genome[start + offs], COMPLEMENT[code[genome[start + fragment_bp - 1 - offs]]]):
        err = rng.random(bases.shape) < sub
        wrong = ACGT[(code[bases] + rng.integers(1, 4, size=bases.shape)) % 4]
        out.append(np.where(err, wrong, bases))
    return out


def make_files(root: str, scale: float) -> dict:
    rng = np.random.default_rng(15)
    genome = ACGT[rng.integers(0, 4, size=4_641_652)]
    sets = {}
    paths = []
    for mate, reads in enumerate(mates(rng, genome, int(696_247 * scale)), 1):
        paths.append(os.path.join(root, f"reads_{mate}.fq.gz"))
        with open(paths[-1], "wb") as f:
            f.write(gzip.compress(fastq(reads, mate), compresslevel=1, mtime=0))
    sets["ecoli_mates"] = paths
    big = os.path.join(root, "over_cap.fq.gz")
    with open(big, "wb") as f:
        f.write(gzip.compress(fastq(mates(rng, genome, int(5_100_000 * scale))[0], 1),
                              compresslevel=1, mtime=0))
    sets["one_member_over_cap"] = [big]
    return sets


def bind_other(lib: ctypes.CDLL) -> ctypes.CDLL:
    """The C interface that every checkout's reader has."""
    lib.ntpu_fastx_open.restype = ctypes.c_void_p
    lib.ntpu_fastx_open.argtypes = [ctypes.c_char_p, ctypes.c_long]  # an older one ignores cap
    lib.ntpu_fastx_close.argtypes = [ctypes.c_void_p]
    lib.ntpu_fastx_error.restype = ctypes.c_char_p
    lib.ntpu_fastx_error.argtypes = [ctypes.c_void_p]
    lib.ntpu_fastx_next.restype = ctypes.c_long
    lib.ntpu_fastx_next.argtypes = [ctypes.c_void_p] + [ctypes.c_void_p, ctypes.c_long,
                                                        ctypes.c_void_p] * 2 + [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_int), ctypes.c_long]
    return lib


def builds(against: str | None) -> dict:
    """name -> (library, cap): this checkout's variants and DIR's reader."""
    def variant(flags):
        def command(src, out):
            cmd = native._command(src, out)
            return cmd[:1] + flags + cmd[1:]
        return command

    out = {}
    for name, flags in (("this", []), ("no_spare", ["-DNTPU_READER_NO_SPARE"])):
        path = build_library(f"ntpu_io_{name}", native.SOURCE, variant(flags),
                             salt=host_cpu(), deps=native.HEADERS)
        out[name] = (native.bind(ctypes.CDLL(path)), native.whole_cap())
    out["gzread"] = (out["this"][0], 0)
    if against:
        csrc = os.path.join(against, "ntedit_tpu_torch", "csrc")
        deps = [os.path.join(csrc, f) for f in sorted(os.listdir(csrc)) if f.endswith(".h")]
        path = build_library("ntpu_io_other", os.path.join(csrc, "fastx_reader.cpp"),
                             native._command, salt=host_cpu(), deps=deps)
        out["other"] = (bind_other(ctypes.CDLL(path)), native.whole_cap())
    return out


def read_all(lib, path: str, cap: int) -> int:
    """Every batch, as ``native.read_batches(want_headers=False)`` reads
    them; returns the bases."""
    h = lib.ntpu_fastx_open(os.fsencode(path), cap)
    if not h:
        raise OSError(f"cannot open {path}")
    seq = np.empty(native.SEQ_CAP, np.uint8)
    qual = np.empty(native.SEQ_CAP, np.uint8)
    hdr = np.empty(native.HDR_CAP, np.uint8)
    offs = np.empty(native.MAX_REC + 1, np.int64)
    hoffs = np.empty(native.MAX_REC + 1, np.int64)
    fq = ctypes.c_int(0)
    bases = 0
    try:
        while True:
            n = lib.ntpu_fastx_next(h, seq.ctypes.data, len(seq), offs.ctypes.data,
                                    hdr.ctypes.data, len(hdr), hoffs.ctypes.data,
                                    qual.ctypes.data, ctypes.byref(fq), native.MAX_REC)
            if lib.ntpu_fastx_error(h) or n < 0:
                raise OSError(f"{path}: {lib.ntpu_fastx_error(h).decode()} ({n})")
            if n == 0:
                return bases
            total = int(offs[n])
            seq[:total].copy(), offs[: n + 1].copy(), qual[:total].copy()
            bases += total
    finally:
        lib.ntpu_fastx_close(h)


def io_read(paths: list, lib, cap: int) -> int:
    """The filter build's read of ``paths`` through ``lib`` (a build with
    this checkout's interface) at k = 25; returns the pieces' bytes."""
    from ntedit_tpu_torch.core import bfbuild

    saved, saved_cap = native._lib, native.WHOLE_CAP
    native._lib, native.WHOLE_CAP = lib, cap
    try:
        return sum(len(p) for p in bfbuild._pieces(bfbuild._separated(paths), 25, bfbuild.BATCH))
    finally:
        native._lib, native.WHOLE_CAP = saved, saved_cap


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--against", help="another checkout, whose reader is timed in turns")
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--scale", type=float, default=1.0)
    args = ap.parse_args(argv)
    libs = builds(args.against)
    root = tempfile.mkdtemp(prefix="reader_sweep_")
    try:
        t0 = time.perf_counter()
        sets = make_files(root, args.scale)
        made_s = time.perf_counter() - t0
        for name, paths in sets.items():
            rounds = {b: [] for b in libs}
            io_rounds = {b: [] for b in libs if b != "other"}
            bases = {}
            names = list(libs)
            for r in range(args.rounds + 1):  # round 0 warms up, and is not kept
                for b in names[r % len(names):] + names[: r % len(names)]:  # each first in turn
                    lib, cap = libs[b]
                    t = time.perf_counter()
                    bases[b] = sum(read_all(lib, p, cap) for p in paths)
                    if r > 0:
                        rounds[b].append(1e3 * (time.perf_counter() - t))
                    if name == "ecoli_mates" and b in io_rounds:
                        t = time.perf_counter()
                        io_read(paths, lib, cap)
                        if r > 0:
                            io_rounds[b].append(1e3 * (time.perf_counter() - t))
            line = {"files": name, "decoded_bytes": sum(_decoded(p) for p in paths),
                    "gz_bytes": sum(os.path.getsize(p) for p in paths), "bases": bases,
                    "made_s": round(made_s, 3),
                    "reader_ms": {b: round(statistics.median(v), 1) for b, v in rounds.items()},
                    "reader_ms_rounds": {b: [round(x, 1) for x in v] for b, v in rounds.items()}}
            if name == "ecoli_mates":
                line["io_read_ms"] = {b: round(statistics.median(v), 1)
                                      for b, v in io_rounds.items()}
                line["io_read_ms_rounds"] = {b: [round(x, 1) for x in v]
                                             for b, v in io_rounds.items()}
            print(json.dumps(line), flush=True)
    finally:
        shutil.rmtree(root, ignore_errors=True)


def _decoded(path: str) -> int:
    with open(path, "rb") as f:
        f.seek(-4, os.SEEK_END)
        return int.from_bytes(f.read(4), "little")  # ISIZE: exact below 4 GiB


if __name__ == "__main__":
    main()
