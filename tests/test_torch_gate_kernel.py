"""The gate kernel's host side, on the CPU: the multiply-based modulo the
kernel uses for plain and counting filters (mod_magic's reciprocal, with
the kernel's fastmod written out in Python ints) against ``%``; the
wrapper's tile, halo and batch constants against the CUDA source and the
gate stream's chunks; the probe floor's plain version; and the helpers
with which chip_smoke.py reports the kernel (ptxas resources, probed
sectors).  The kernel itself runs only on a card (tests marked ``cuda``
in test_torch_package.py, and chip_smoke.py)."""

import re

import numpy as np
import pytest
import torch

import chip_smoke
from ntedit_tpu_torch.core import bloom
from ntedit_tpu_torch.engine import flag
from ntedit_tpu_torch.ops import gate_kernel, snv_kernel
from ntedit_tpu_torch.utils import simulate

MASK64 = (1 << 64) - 1

# the sizes the filters allow (core/bloom.py) and the ones the main path
# uses: 1, powers of two, the largest plain bit count and counter count,
# the plain and counting filters of a 50 Mbp assembly, and small primes
MODULI = [
    1, 2, 3, 7, 1 << 5, 1 << 31, (1 << 31) - 1, (1 << 36) - 1, 1 << 36,
    bloom.bf_size_bytes(50_000_000, 3, 0.001) * 8,
    8 * bloom.bf_size_bytes(4_700_000, 3, 0.001),
    8_000_000_032, 150_001, 1_000_003,
]


def fastmod(x: int, m: int, magic: int) -> int:
    """The kernel's fastmod, wrapped to 64 bits as the card's registers
    wrap: q = __umul64hi(x, magic), r = x - q * m, one correction."""
    q = (x * magic) >> 64
    r = (x - q * m) & MASK64
    return r - m if r >= m else r


def edge_hashes(m: int, rng) -> list:
    """0, m - 1, m, m + 1, q*m +- 1 for the largest q and a few others,
    hashes with bit 63 set, 2^64 - 1, and random 64-bit values."""
    q_top = MASK64 // m
    xs = [0, 1, m - 1, m, m + 1, 1 << 63, (1 << 63) - 1, (1 << 63) + 1, MASK64]
    for q in (1, 2, q_top - 1, q_top, int(rng.integers(1, 1 << 62)) % q_top + 1):
        xs += [q * m - 1, q * m, q * m + 1]
    xs += [int(v) for v in rng.integers(0, 1 << 63, size=400, dtype=np.int64)]
    xs += [int(v) | (1 << 63) for v in rng.integers(0, 1 << 63, size=400, dtype=np.int64)]
    return [x & MASK64 for x in xs]


@pytest.mark.parametrize("m", MODULI)
def test_fastmod_is_the_remainder(m):
    rng = np.random.default_rng(m % 1000)
    magic = gate_kernel.mod_magic(m)
    for x in edge_hashes(m, rng):
        q = (x * magic) >> 64
        assert q in (x // m, x // m - 1)  # one correction step is enough
        assert fastmod(x, m, magic) == x % m, (x, m)


def test_fastmod_small_moduli_exhaustively():
    rng = np.random.default_rng(1)
    xs = [int(v) for v in rng.integers(0, 1 << 63, size=64, dtype=np.int64)]
    xs += [x | (1 << 63) for x in xs] + [MASK64, 0]
    for m in range(1, 600):
        magic = gate_kernel.mod_magic(m)
        for x in xs:
            assert fastmod(x, m, magic) == x % m


@pytest.mark.parametrize("m", [0, 1 << 64, -3])
def test_mod_magic_rejects_out_of_range(m):
    with pytest.raises(ValueError):
        gate_kernel.mod_magic(m)


def source_constant(name: str) -> int:
    """A constant of the kernel source or of the header it shares."""
    text = ""
    for path in (gate_kernel.SOURCE, gate_kernel.HEADER):
        with open(path) as f:
            text += f.read()
    return int(re.search(rf"constexpr int {name} = (\d+);", text).group(1))


def test_wrapper_constants_match_the_source():
    threads, heads = source_constant("kThreads"), source_constant("kHeads")
    assert gate_kernel.TILE == threads * heads
    assert gate_kernel.HALO == source_constant("kHalo")
    assert gate_kernel.BATCH == source_constant("kBatch")
    assert gate_kernel.MAX_K == gate_kernel.HALO + 1
    assert heads == 32  # one gate word per thread: a warp's lanes own consecutive words
    assert heads % gate_kernel.BATCH == 0
    with open(snv_kernel.SOURCE) as f:  # the SNV kernels share the tile through the header
        snv = f.read()
    assert '#include "nthash.cuh"' in snv and "constexpr int kTile" not in snv
    for layout, name in (("blocked", "kSnvHeadsBlocked"), ("plain", "kSnvHeadsPlain")):
        per_batch = int(re.search(rf"constexpr int {name} = (\d+);", snv).group(1))
        assert heads % per_batch == 0 and snv_kernel.CAND_BATCH[layout] == 3 * per_batch


@pytest.mark.parametrize("n", [1, 31, (1 << 15) - 1, (1 << 15) + 1, 1_000_003,
                               flag.DEFAULT_CHUNK + 5, 250_000_000])
def test_chunks_are_whole_tiles_and_fit_the_buffer(n):
    """Every chunk of the gate stream starts on a tile, 16-byte aligned,
    and its kernel's reads (whole tiles plus the halo) stay inside the
    contig's buffer; every window's bytes are inside it."""
    assert flag.DEFAULT_CHUNK % gate_kernel.TILE == 0
    chunk = flag._effective_chunk(n, flag.DEFAULT_CHUNK)
    assert chunk % gate_kernel.TILE == 0
    size = gate_kernel.padded_len(n)
    assert size % 16 == 0 and size >= n + gate_kernel.MAX_K - 1
    for start in (0, chunk, (n - 1) // chunk * chunk):
        if start >= n:
            continue
        m = min(chunk, n - start)
        assert start % 16 == 0
        assert start + gate_kernel.padded_len(m) <= size


def test_mix64_is_splitmix64():
    # splitmix64 seeded with 0: its first two outputs
    assert gate_kernel.mix64(0) == 0xE220A8397B1DCDAF
    assert gate_kernel.mix64(1) == 0x6E789E6AA1B965F4


def test_probe_floor_word_partitions_the_probes():
    """The floor's threads split the probes without gap or overlap, and a
    thread's word is the XOR of the words its probes read."""
    table = np.random.default_rng(4).integers(-2**31, 2**31, size=1009, dtype=np.int64)
    table = table.astype(np.int32)
    probes, threads = 1000, 37
    counts = [probes * (t + 1) // threads - probes * t // threads for t in range(threads)]
    assert sum(counts) == probes and max(counts) - min(counts) <= 1
    words = [gate_kernel.probe_floor_word(table, probes, threads, t) for t in range(threads)]
    acc = 0
    for c in range(probes):
        acc ^= int(table[gate_kernel.mix64(c) % table.size]) & 0xFFFFFFFF
    total = 0
    for w in words:
        total ^= w
    assert total == acc


def test_probe_floor_needs_the_card():
    """The floor kernel has no CPU version to fall back to: a CPU table
    raises (no library to build here, or not a CUDA tensor)."""
    with pytest.raises((RuntimeError, OSError, ValueError)):
        gate_kernel.probe_floor(torch.zeros(64, dtype=torch.int32), 10, 2)


PTXAS_LOG = """ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN4_GLOBAL__N_117gate_words_kernelILi0EEEvPKhmNS_6FilterEiPjm' for 'sm_90a'
ptxas info    : Function properties for _ZN4_GLOBAL__N_117gate_words_kernelILi0EEEvPKhmNS_6FilterEiPjm
    8 bytes stack frame, 4 bytes spill stores, 4 bytes spill loads
ptxas info    : Used 64 registers, used 1 barriers, 10944 bytes smem
ptxas info    : Compiling entry function '_ZN4_GLOBAL__N_118probe_floor_kernelIhEEvPKT_mmmmiPj' for 'sm_90a'
ptxas info    : Function properties for _ZN4_GLOBAL__N_118probe_floor_kernelIhEEvPKT_mmmmiPj
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 54 registers, used 0 barriers
"""


def test_ptxas_resources_reads_nvcc_output():
    res = chip_smoke.ptxas_resources(PTXAS_LOG)
    assert res["plain"] == {"stack": 8, "spill_stores": 4, "spill_loads": 4,
                            "registers": 64, "smem_bytes": 10944}
    assert res["floor_counters"] == {"stack": 0, "spill_stores": 0, "spill_loads": 0,
                                     "registers": 54}


@pytest.mark.parametrize("layout,p", [("blocked", 1), ("plain", 1), ("counting", 1),
                                      ("counting", 3)])
def test_probed_sectors_counts_the_kernels_probes(layout, p):
    """The probes chip_smoke.py gives the floor are those the kernel makes:
    one per live head (blocked), or hash_num rounds each over the heads
    still undecided, counted here head by head with the host filter."""
    k, h = 25, 3
    truth = simulate.random_genome(6000, seed=11)
    draft, _ = simulate.inject_errors(truth, sub_rate=0.01, seed=12)
    if layout == "blocked":
        hf = bloom.BlockedKmerBloomFilter.zeros(1 << 12, h, k)
        hf.insert_seq(truth)
    elif layout == "plain":
        hf = bloom.KmerBloomFilter.zeros(20_011, h, k)
        hf.insert_seq(truth)
    else:
        hf = bloom.KmerCountingBloomFilter8.zeros(40_009, h, k)
        simulate.fill_counts(hf, truth)
        simulate.fill_counts(hf, truth[:3000])  # counts 2 in the first half
    df = bloom.DeviceFilter.from_host(hf, "cpu")
    n = 5000
    buf = torch.zeros(gate_kernel.padded_len(n), dtype=torch.uint8)
    buf[: n + k - 1] = torch.from_numpy(draft[: n + k - 1].copy())
    sectors, live, probes = chip_smoke.probed_sectors(buf, n, df, p)
    valid, iupac = gate_kernel.window_flags(buf[: n + k - 1], n, k)
    assert live == int((valid & ~iupac).sum())
    if layout == "blocked":
        assert probes == live
        return
    from ntedit_tpu_torch.core import nthash as nt

    can = nt.canonical(*nt.window_hashes(buf[: n + k - 1], k))
    hashes = nt.extend(can, k, h)
    want = 0
    for i in torch.nonzero(valid & ~iupac).flatten().tolist():
        for j in range(h):
            want += 1
            idx = int(nt.umod(hashes[j][i : i + 1], df.modulus))
            if layout == "plain":
                if not (int(df.table[idx >> 5]) >> (idx & 31)) & 1:
                    break
            elif int(df.table[idx]) < max(p, 1):
                break
    assert probes == want
    assert live < probes < h * live  # some heads stop early, most do not
    assert 0 < sectors <= probes
