"""The gate kernel and the card's random-probe floor, on one NVIDIA GPU.

    python -m ntedit_tpu_torch.utils.gate_sweep
    python -m ntedit_tpu_torch.utils.gate_sweep --against OTHER_CHECKOUT

Each line is one JSON object; times are medians over 10 launches with the
L2 flushed before each.  Needs a CUDA device; prints the card's name and
power limit first.

* ``floor``: the floor kernel (csrc/gate_kernel.cu, probe_floor_kernel).
  131,072 threads, as many as the gate kernel has for a 2^22-head chunk,
  make 4,194,304 uniformly random probes (one per head, as the blocked
  layout does).  It sweeps the table's size at the gate kernel's loads in
  flight, the loads in flight (1 to 8) at the blocked filter's 256 MiB,
  and the L2 fetch granularity (cudaLimitMaxL2FetchGranularity, a hint to
  the whole process, set back afterwards) at 256 MiB.
* ``batch``: the gate kernel built with kBatch = 1, 2, 4 and 8 (the heads
  a thread hashes before their probes issue), each build held bit-equal
  to the plain version, timed at the 2^22-head chunk (k = 25) with the
  filters of a 50 Mbp assembly.  The builds take turns in 10 rounds, each
  round in a rotated order; per layout and build, the median and the
  rounds in which it beat the shipped build.

With ``--against DIR`` it runs one comparison instead: the gate kernel of
this checkout and the one built from ``DIR/ntedit_tpu_torch/csrc/
gate_kernel.cu`` (another checkout of the repository, with the same C
interface), both held bit-equal to the plain version, take turns in 10
rounds on the same data; per layout, each build's median ms and the rounds
this checkout won.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import subprocess

import numpy as np
import torch

from ntedit_tpu_torch.core import bloom
from ntedit_tpu_torch.engine import flag
from ntedit_tpu_torch.ops import gate_kernel
from ntedit_tpu_torch.utils import build, simulate
from ntedit_tpu_torch.utils.other import library_path

PROBES = 1 << 22
THREADS = PROBES // 32
L2_FETCH_LIMIT = 0x05  # cudaLimitMaxL2FetchGranularity
MIB = 1 << 20
GENOME = 50_000_000  # bases of the assembly the timed filters are sized for
BATCHES = (1, 2, 4, 8)
ROUNDS = 10


def time_ms(fn, flush, reps: int = 10) -> float:
    """Median ms of ``fn`` over ``reps`` launches, the L2 flushed before each."""
    fn()
    times = []
    for _ in range(reps):
        flush.zero_()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def floor_row(table: torch.Tensor, flush, batch: int, **tags) -> dict:
    ms = time_ms(lambda: gate_kernel.probe_floor(table, PROBES, THREADS, batch), flush)
    return {**tags, "table_bytes": table.numel() * table.element_size(),
            "elem_bytes": table.element_size(), "batch": batch, "probes": PROBES,
            "ms": ms, "gprobes_per_s": PROBES / ms / 1e6}


def _cudart():
    """The CUDA runtime torch loaded, for the L2 fetch-granularity limit;
    None when it cannot be found."""
    for name in ("libcudart.so.12", "libcudart.so"):
        try:
            rt = ctypes.CDLL(name)
        except OSError:
            continue
        rt.cudaDeviceGetLimit.restype = ctypes.c_int
        rt.cudaDeviceGetLimit.argtypes = [ctypes.POINTER(ctypes.c_size_t), ctypes.c_int]
        rt.cudaDeviceSetLimit.restype = ctypes.c_int
        rt.cudaDeviceSetLimit.argtypes = [ctypes.c_int, ctypes.c_size_t]
        return rt
    return None


def floor_sweep(flush) -> None:
    dev = flush.device
    gen = torch.Generator(device=dev).manual_seed(5)

    def words(nbytes: int) -> torch.Tensor:
        return torch.randint(-(1 << 31), 1 << 31, (nbytes // 4,), dtype=torch.int32,
                             device=dev, generator=gen)

    for mib in (16, 64, 256, 1024, 4096):
        t = words(mib * MIB)
        print(json.dumps(floor_row(t, flush, gate_kernel.BATCH, sweep="size")), flush=True)
        del t
    # the counting filter of a 50 Mbp assembly (chip_smoke.py's)
    counters = torch.randint(0, 256, (8 * bloom.bf_size_bytes(GENOME, 3, 0.001),),
                             dtype=torch.uint8, device=dev, generator=gen)
    print(json.dumps(floor_row(counters, flush, gate_kernel.BATCH, sweep="size")), flush=True)
    del counters
    t = words(256 * MIB)
    for batch in range(1, 9):
        print(json.dumps(floor_row(t, flush, batch, sweep="batch")), flush=True)
    rt = _cudart()
    if rt is None:
        print(json.dumps({"sweep": "l2_fetch", "error": "no CUDA runtime library found"}))
        return
    torch.cuda.synchronize()
    old = ctypes.c_size_t(0)
    if rt.cudaDeviceGetLimit(ctypes.byref(old), L2_FETCH_LIMIT) != 0:
        print(json.dumps({"sweep": "l2_fetch", "error": "cudaDeviceGetLimit failed"}))
        return
    try:
        for g in (32, 64, 128):
            rc = rt.cudaDeviceSetLimit(L2_FETCH_LIMIT, g)
            got = ctypes.c_size_t(0)
            rt.cudaDeviceGetLimit(ctypes.byref(got), L2_FETCH_LIMIT)
            print(json.dumps(floor_row(t, flush, gate_kernel.BATCH, sweep="l2_fetch",
                                       default_granularity=old.value, asked=g, set_rc=rc,
                                       granularity=got.value)), flush=True)
    finally:
        rt.cudaDeviceSetLimit(L2_FETCH_LIMIT, old.value)


def batch_builds() -> dict:
    """kBatch -> the kernel library built with it (the source with only
    that constant changed, into the build directory)."""
    with open(gate_kernel.SOURCE) as f:
        src = f.read()
    os.makedirs(build.BUILD_DIR, exist_ok=True)
    libs = {}
    for b in BATCHES:
        path = os.path.join(build.BUILD_DIR, f"gate_kernel_batch{b}.cu")
        with open(path, "w") as f:
            f.write(re.sub(r"constexpr int kBatch = \d+;", f"constexpr int kBatch = {b};", src))
        lib = build.build_library(f"gate_kernel_batch{b}", path, gate_kernel._command,
                                  deps=(gate_kernel.HEADER,))
        libs[b] = gate_kernel.open_library(lib, b)
    return libs


def take_turns(flush, libs: dict):
    """Time the builds ``libs`` (tag -> library) of the gate kernel at the
    2^22-head chunk (k = 25) with the filters of a 50 Mbp assembly: the
    builds take turns in ROUNDS rounds, each round in a rotated order, each
    held bit-equal to the plain version.  Yields (layout, {tag: [ms]})."""
    dev = flush.device
    k = 25
    n = flag.DEFAULT_CHUNK
    L = n + k - 1
    truth = simulate.random_genome(L + 1000, seed=31)  # indels change the length
    draft, _ = simulate.inject_errors(truth, seed=32)
    buf = torch.zeros(gate_kernel.padded_len(n), dtype=torch.uint8)
    buf[:L] = torch.from_numpy(draft[:L].copy())
    seq = buf.to(dev)
    tags = tuple(libs)
    shipped = gate_kernel.load_library()
    try:
        for name, hf in simulate.chunk_filters(truth, k, GENOME).items():
            df = bloom.DeviceFilter.from_host(hf, dev)
            p = 3 if name == "counting" else 1
            want = gate_kernel.gate_words_plain(seq, n, df, False, p)
            times: dict = {b: [] for b in tags}
            for r in range(ROUNDS):
                for b in tags[r % len(tags):] + tags[: r % len(tags)]:
                    gate_kernel._lib = libs[b]  # gate_words launches this build
                    if not torch.equal(gate_kernel.gate_words(seq, n, df, False, p), want):
                        raise AssertionError(f"{name}: the build {b!r} differs from plain")
                    times[b].append(time_ms(lambda: gate_kernel.gate_words(seq, n, df, False, p),
                                            flush, 20))
            yield name, times
            del df
            torch.cuda.empty_cache()
    finally:
        gate_kernel._lib = shipped


def batch_sweep(flush) -> None:
    for name, times in take_turns(flush, batch_builds()):
        ship = np.array(times[gate_kernel.BATCH])
        for b in BATCHES:
            t = np.array(times[b])
            print(json.dumps({"sweep": "batch", "layout": name, "batch": b,
                              "ms": float(np.median(t)), "rounds": ROUNDS,
                              "beat_shipped": int((t < ship).sum())}), flush=True)


def against(flush, other: str) -> None:
    """This checkout's gate kernel against the one of the checkout at
    ``other``, built from its sources with this checkout's flags."""
    theirs = gate_kernel.open_library(
        library_path(other, "gate_kernel.cu", "gate_kernel_other"))
    libs = {"this": gate_kernel.load_library(), "other": theirs}
    for name, times in take_turns(flush, libs):
        a, b = np.array(times["this"]), np.array(times["other"])
        print(json.dumps({"sweep": "against", "other": other, "layout": name,
                          "this_ms": float(np.median(a)), "other_ms": float(np.median(b)),
                          "rounds": ROUNDS, "this_won": int((a < b).sum()),
                          "other_quartiles_ms": [float(q) for q in np.percentile(b, [25, 75])]}),
              flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="gate_sweep", description=__doc__.split("\n\n")[0])
    ap.add_argument("--against", metavar="DIR", default=None,
                    help="compare with the gate kernel of the checkout at DIR instead")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("gate_sweep: no CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    gate_kernel.load_library()
    flush = torch.empty(256 * MIB, dtype=torch.uint8, device=torch.device("cuda"))
    if args.against:
        against(flush, args.against)
        return 0
    floor_sweep(flush)
    batch_sweep(flush)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
