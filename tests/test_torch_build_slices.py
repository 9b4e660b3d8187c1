"""The count pass binned by slice and the insert pass over solid bits
(ops/build_kernel.py), on the CPU: the plain partition and apply against
``kmer_count_plain`` and the JAX package's host counting filter with the
slice size shrunk so that a table splits 1, 3 and 7 ways (a last slice
partial or of one slot), at hash_num 1 to 4; each slice's bucket against
the slots computed directly; a poly-A batch, whose increments all land in
one slot and one bucket; the plain solid bits against the count-min read at
cutoffs 1, 2, 254, 255 and 256, and the insert over them against
``kmer_insert_plain``; FilterBuilder's rules for the solid bits; and the
slice arithmetic on hashes with bit 63 set at slot counts above 2^32, with
no table allocated.  Tests marked ``cuda`` hold each new kernel to its
plain version on a card and skip without one."""

import re

import numpy as np
import pytest
import torch

from ntedit_tpu_torch.core import bfbuild
from ntedit_tpu_torch.core import nthash as nt
from ntedit_tpu_torch.ops import build_kernel as bk
from ntedit_tpu_torch.ops import gate_kernel
from ntedit_tpu_torch.utils import simulate

K = 25
MASK64 = (1 << 64) - 1


def _batch(length: int = 12_000, seed: int = 21) -> np.ndarray:
    """Records with N, IUPAC, lowercase and separator bytes, and one k-mer
    repeated 300 times (counts past 255)."""
    g = simulate.random_genome(length, seed=seed)
    g[100] = ord("N")
    g[700] = ord("Y")
    g[1200:1500] |= 0x20
    g[2000] = 0
    g[9000] = 0
    return np.concatenate([g] + [g[40:70], np.zeros(1, np.uint8)] * 300)


def _seq(arr: np.ndarray, device="cpu") -> tuple:
    n = len(arr) - K + 1
    buf = torch.zeros(gate_kernel.padded_len(n), dtype=torch.uint8)
    buf[: len(arr)] = torch.from_numpy(arr)
    return buf.to(device), n


def _table(slots: int, device="cpu") -> torch.Tensor:
    return torch.zeros(-(-slots // 4) * 4, dtype=torch.uint8, device=device)


# slots and slice bits: 1, 3 (last slice partial) and 7 ways (last slice
# whole, or of one slot); the windows span several 8192-window blocks
SPLITS = [(4 * 517 + 1, 12, 1), (3 * 1024 - 300, 10, 3), (7 * 512, 9, 7), (6 * 512 + 1, 9, 7)]


@pytest.mark.parametrize("hash_num", [1, 2, 3, 4])
@pytest.mark.parametrize("slots,slice_bits,ways", SPLITS)
def test_partition_and_apply_equal_the_count(slots, slice_bits, ways, hash_num):
    """The plain partition then the plain apply equal kmer_count_plain and
    the JAX package's KmerCountingBloomFilter8 over the same windows."""
    from ntedit_tpu.core import bfbuild as jb
    from ntedit_tpu.core import bloom as jbloom
    from ntedit_tpu.core import nthash_ref as jref

    arr = _batch(20_000)
    seq, n = _seq(arr)
    bins = bk.Bins(slots, hash_num, n, "cpu", slice_bits)
    assert (bins.slice_bits, bins.n_slices) == (slice_bits, ways)
    got = _table(slots)
    bk.kmer_partition(seq, n, K, bins)
    assert bins.columns == -(-n // gate_kernel.TILE) * bins.rounds and n > gate_kernel.TILE
    bk.kmer_count_apply(bins, got)
    want = _table(slots)
    bk.kmer_count_plain(seq, n, K, hash_num, want, slots)
    assert torch.equal(got, want) and int(got.max()) == 255
    cbf = jbloom.KmerCountingBloomFilter8.zeros(slots, hash_num, K)
    cbf.insert_hashes(jref.extend_hashes_vec(jb.valid_canonical_hashes(arr, K), K, hash_num))
    assert np.array_equal(got[:slots].numpy(), cbf.counters)


@pytest.mark.parametrize("slots,slice_bits,ways", SPLITS)
def test_each_bucket_holds_its_slices_offsets(slots, slice_bits, ways):
    """The count matrix is the number of increments of each (slice,
    column: a round of a block's windows); its scan places the buckets in
    slice order; the range of each (slice, column) holds, as a multiset,
    the offsets of the slots of that column's windows in that slice."""
    hash_num = 3
    seq, n = _seq(_batch(20_000))
    bins = bk.Bins(slots, hash_num, n, "cpu", slice_bits)
    bk.kmer_partition(seq, n, K, bins)
    can, words = bk.kmer_hashes_plain(seq, n, K)
    pos = torch.nonzero(bk.unpack_bits(words, n)).reshape(-1)
    slot = torch.cat([nt.umod(h, slots) for h in nt.extend(can[pos], K, hash_num)])
    col = (pos // gate_kernel.TILE * bins.rounds + pos % 32 // bins.round_windows).repeat(hash_num)
    cells = bins.cells()
    ends = bins.ends[:cells]
    assert torch.equal(ends, torch.cumsum(bins.counts[:cells].long(), 0))
    assert int(ends[-1]) == slot.numel()
    for s in range(ways):
        for b in range(bins.columns):
            c = s * bins.columns + b
            lo, hi = int(ends[c]) - int(bins.counts[c]), int(ends[c])
            mine = slot[(slot >> slice_bits == s) & (col == b)]
            got = bins.entries[lo:hi].long() & 0xFFFFFFFF
            assert torch.equal(torch.sort(got).values,
                               torch.sort(mine & ((1 << slice_bits) - 1)).values), (s, b)
    assert torch.equal(torch.sort(bk.bin_slots(bins)).values, torch.sort(slot).values)


@pytest.mark.parametrize("hash_num", [1, 3])
def test_poly_a_batch_counts_in_one_bucket(hash_num):
    """Every window of a poly-A batch is one k-mer: at hash_num 1 all its
    increments land in one slot and one bucket, which holds them all (no
    fixed capacity), and the count saturates at 255."""
    arr = np.full(30_000, ord("A"), np.uint8)
    arr[10_000] = 0  # two records
    seq, n = _seq(arr)
    slots = 4 * 1000 + 3
    bins = bk.Bins(slots, hash_num, n, "cpu", 9)
    got = _table(slots)
    bk.kmer_count(seq, n, K, hash_num, got, slots, bins)
    per_slice = bins.counts[: bins.cells()].view(bins.n_slices, bins.columns).long().sum(1)
    valid = n - K  # the separator's K windows are invalid
    assert int(per_slice.sum()) == hash_num * valid
    if hash_num == 1:
        assert int((per_slice > 0).sum()) == 1 and int(per_slice.max()) == valid
        assert int(torch.unique(bk.bin_slots(bins)).numel()) == 1
    assert int((got[:slots] == 255).sum()) == int(torch.unique(bk.bin_slots(bins)).numel())
    assert int(got[:slots].count_nonzero()) == int((got[:slots] == 255).sum())
    want = _table(slots)
    bk.kmer_count_plain(seq, n, K, hash_num, want, slots)
    assert torch.equal(got, want)


def test_bins_are_reused_across_batches(monkeypatch):
    """A FilterBuilder bins every batch into the scratch it allocated at its
    first count_batch (a larger batch allocates anew); the counts of
    several batches equal kmer_count_plain's."""
    arr = _batch(20_000)
    slots = 3 * 1024 - 300
    monkeypatch.setattr(bk, "SLICE_BITS", 10)
    b = bfbuild.FilterBuilder(K, 3, 1 << 12, slots, "blocked", "cpu")
    want = _table(slots)
    bins = None
    for seq, n in bfbuild.upload_batches([arr[:20_000], arr[20_000 - K + 1:]], K, "cpu", 20_000):
        b.count_batch(seq, n)
        bins = bins or b.bins
        assert b.bins is bins and b.bins.slice_bits == 10
        bk.kmer_count_plain(seq, n, K, 3, want, slots)
    assert torch.equal(b.counters, want)
    seq, n = _seq(_batch(30_000, seed=22))
    b.count_batch(seq, n)
    assert b.bins is not bins and b.bins.windows == n


@pytest.mark.parametrize("cutoff", [1, 2, 254, 255, 256])
def test_solid_bits_are_the_count_min_read(cutoff):
    """Bit s of the plain solid bits is counters[s] >= cutoff (0 past
    slots); every slot of a window set exactly when its count-min read is
    at least cutoff; and the insert over the bits equals kmer_insert_plain
    over the counters, blocked and plain."""
    rng = np.random.default_rng(cutoff)
    slots = 4 * 1003 + 2
    table = torch.from_numpy(rng.integers(0, 256, size=-(-slots // 4) * 4).astype(np.uint8))
    table[:40] = torch.tensor([253, 254, 255] * 13 + [0], dtype=torch.uint8)
    seq, n = _seq(_batch())
    can = bk.valid_hashes_plain(seq, n, K)
    for h in nt.extend(can[:30], K, 3):  # some windows at 255 or 254 on every slot
        table[nt.umod(h, slots)] = 255
    table[nt.umod(can[10:20], slots)] = 254
    table[slots:] = 255  # padding: never a solid bit
    solid = bk.kmer_solid_bits(table, slots, cutoff)
    assert solid.dtype == torch.int32 and solid.numel() == -(-slots // 32)
    bits = bk.unpack_bits(solid, solid.numel() * 32)
    assert torch.equal(bits[:slots], table[:slots].long() >= cutoff)
    assert not bits[slots:].any()
    assert torch.equal(bk.all_solid(can, K, 3, solid, slots),
                       bk.min_count(can, K, 3, table, slots).long() >= cutoff)
    for layout, modulus in (("blocked", 1 << 10), ("plain", 8 * 4099)):
        nw = modulus if layout == "blocked" else -(-modulus // 32)
        got = torch.zeros(nw, dtype=torch.int32)
        want = got.clone()
        # cutoff 1 inserts every valid window and reads no counter
        bk.kmer_insert(seq, n, K, 3, got, layout, modulus, solid if cutoff > 1 else None, slots)
        bk.kmer_insert_plain(seq, n, K, 3, want, layout, modulus, table, slots, cutoff)
        assert torch.equal(got, want)
        assert bool(got.any()) == (cutoff < 256)


def test_builder_builds_the_solid_bits_once():
    """The first insert above cutoff 1 packs the solid bits; later inserts
    read the same bits; a count_batch after them, or an insert at another
    cutoff, raises; inserts at cutoff 1 need no bits."""
    seq, n = _seq(_batch())
    slots = 4 * 301 + 1
    b = bfbuild.FilterBuilder(K, 3, 8 * 4099, slots, "plain", "cpu")
    b.count_batch(seq, n)
    b.count_batch(seq, n)
    assert b.solid is None
    b.insert_batch(seq, n, 3)
    solid = b.solid
    assert solid is not None and b.solid_cutoff == 3 and b.bins is None
    b.insert_batch(seq, n, 3)
    assert b.solid is solid
    with pytest.raises(RuntimeError, match="stale|solid bits"):
        b.count_batch(seq, n)
    with pytest.raises(RuntimeError, match="cutoff 2"):
        b.insert_batch(seq, n, 2)
    want = torch.zeros_like(b.words)
    counters = _table(slots)
    bk.kmer_count_plain(seq, n, K, 3, counters, slots)
    bk.kmer_count_plain(seq, n, K, 3, counters, slots)
    bk.kmer_insert_plain(seq, n, K, 3, want, "plain", 8 * 4099, counters, slots, 3)
    assert torch.equal(b.words, want) and bool(want.any())
    ones = bfbuild.FilterBuilder(K, 3, 8 * 4099, 0, "plain", "cpu")
    ones.insert_batch(seq, n, 1)
    assert ones.solid is None and bool(ones.words.any())


HASHES = [0, 1, (1 << 63), (1 << 64) - 1, 0x9E3779B97F4A7C15, (1 << 63) + (1 << 32) - 1,
          0xDEADBEEFCAFEF00D, (1 << 40) + 12345]


@pytest.mark.parametrize("slots", [(1 << 29), 374_000_017, (1 << 32) + 1, 5 * (1 << 32) + 7,
                                   (1 << 36)])
def test_slice_arithmetic_above_2_32_slots(slots):
    """slice_of is (h mod slots) >> S and its low S bits for unsigned
    64-bit h (bit 63 set included); S is raised until the table has at most
    MAX_SLICES slices, so slice ids pass 2^11 only with S and the offsets
    stay 32-bit.  No table is allocated."""
    bits = bk.slice_bits_for(slots)
    assert bits >= bk.SLICE_BITS and ((slots - 1) >> bits) < bk.MAX_SLICES
    assert bits == bk.SLICE_BITS or ((slots - 1) >> (bits - 1)) >= bk.MAX_SLICES
    for s_bits in {bits, bk.slice_bits_for(slots, 2)}:
        h = nt.as_int64(np.array(HASHES, dtype=np.uint64))
        sl, off = bk.slice_of(h, slots, s_bits)
        for v, a, b in zip(HASHES, sl.tolist(), off.tolist()):
            slot = (v & MASK64) % slots
            assert (a, b) == (slot >> s_bits, slot & ((1 << s_bits) - 1))
            assert 0 <= b < 1 << 32 and a < bk.MAX_SLICES


def test_slice_bits_limits():
    assert bk.slice_bits_for(1) == bk.SLICE_BITS
    assert bk.slice_bits_for(1 << 36) == max(bk.SLICE_BITS, 36 - (bk.MAX_SLICES.bit_length() - 1))
    assert bk.slice_bits_for(1000, 9) == 9
    assert bk.slice_bits_for(bk.MAX_SLICES * 4 + 1, 2) == 3
    assert [bk.partition_rounds(h) for h in (1, 2, 3, 4, 24)] == [(2, 24), (3, 12), (4, 8),
                                                                  (6, 6), (32, 1)]
    with pytest.raises(ValueError):
        bk.partition_rounds(bk.MAX_HASH_NUM + 1)
    with pytest.raises(ValueError):
        bk.slice_bits_for(1 << 44)
    with pytest.raises(ValueError):
        bk.slice_bits_for(1000, 1)
    with pytest.raises(ValueError):
        bk.slice_bits_for(0)
    slots = 5 * (1 << 32) + 7
    b = bk.Bins(slots, 3, 100, "meta")  # no storage on the meta device
    assert (b.slice_bits, b.n_slices) == (bk.SLICE_BITS, ((slots - 1) >> bk.SLICE_BITS) + 1)
    assert b.n_slices > 256 and b.entries.numel() == 300


def test_wrapper_constants_match_the_source():
    with open(bk.SOURCE) as f:
        src = f.read()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))

    assert const("kMaxSlices") == bk.MAX_SLICES and const("kStage") == bk.STAGE
    assert bk.APPLY_CHUNK == const("kApplyPerThread") * 256
    assert bk.MAX_SLICES % 256 == 0  # the partition's block scan: whole slices per thread
    assert "kmer_count_kernel" not in src  # the count runs binned, only


def test_builder_rejects_more_hashes_than_a_round_holds():
    with pytest.raises(ValueError, match="at most"):
        bfbuild.FilterBuilder(K, bk.MAX_HASH_NUM + 1, 1 << 12, 1000, "plain", "cpu")
    bfbuild.FilterBuilder(K, bk.MAX_HASH_NUM + 1, 1 << 12, 0, "plain", "cpu")  # no count pass


def test_bins_check_the_batch():
    seq, n = _seq(_batch())
    bins = bk.Bins(1000, 3, n - 1, "cpu")
    with pytest.raises(ValueError, match="windows"):
        bk.kmer_partition(seq, n, K, bins)
    with pytest.raises(ValueError, match="bins for"):
        bk.kmer_count(seq, n - 1, K, 2, _table(1000), 1000, bins)


# ---------------------------------------------------------------------------
# on a card: each new kernel against its plain version
# ---------------------------------------------------------------------------

def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the build kernels have no CPU mode")


def _bucket_multisets(bins) -> list:
    cells = bins.cells()
    ends = bins.ends[:cells].cpu()
    counts = bins.counts[:cells].cpu()
    entries = bins.entries.cpu().long() & 0xFFFFFFFF
    out = []
    for c in range(cells):
        lo, hi = int(ends[c]) - int(counts[c]), int(ends[c])
        out.append(torch.sort(entries[lo:hi]).values)
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("hash_num", [1, 4])
@pytest.mark.parametrize("slots,slice_bits,ways", SPLITS)
def test_partition_and_apply_kernels_match_plain_on_the_card(slots, slice_bits, ways, hash_num):
    _need_card()
    seq, n = _seq(_batch(40_000), "cuda")
    got, want = bk.Bins(slots, hash_num, n, "cuda", slice_bits), bk.Bins(slots, hash_num, n, "cpu",
                                                                         slice_bits)
    bk.kmer_partition(seq, n, K, got)
    bk.kmer_partition_plain(seq.cpu(), n, K, want)
    cells = want.cells()
    assert torch.equal(got.counts[:cells].cpu(), want.counts[:cells])
    assert torch.equal(got.ends[:cells].cpu(), want.ends[:cells])
    assert all(torch.equal(a, b) for a, b in zip(_bucket_multisets(got), _bucket_multisets(want)))
    table = _table(slots, "cuda")
    bk.kmer_count_apply(got, table)
    plain = _table(slots, "cuda")
    bk.kmer_count_plain(seq, n, K, hash_num, plain, slots)
    assert torch.equal(table, plain) and int(table.max()) == 255


@pytest.mark.cuda
def test_poly_a_batch_on_the_card():
    _need_card()
    arr = np.full(100_000, ord("A"), np.uint8)
    seq, n = _seq(arr, "cuda")
    for hash_num in (1, 3):
        slots = 4 * 50_000 + 1
        got, want = _table(slots, "cuda"), _table(slots, "cuda")
        bk.kmer_count(seq, n, K, hash_num, got, slots)
        bk.kmer_count_plain(seq, n, K, hash_num, want, slots)
        assert torch.equal(got, want) and int((got == 255).sum()) >= 1


@pytest.mark.cuda
@pytest.mark.parametrize("pad", [1, 2, 3])
@pytest.mark.parametrize("cutoff", [1, 2, 255, 256])
def test_solid_bits_kernel_matches_plain_on_the_card(pad, cutoff):
    _need_card()
    slots = 4 * 20_011 + pad
    rng = np.random.default_rng(pad)
    table = torch.from_numpy(rng.integers(0, 256, size=-(-slots // 4) * 4).astype(np.uint8))
    table = table.cuda()
    assert torch.equal(bk.kmer_solid_bits(table, slots, cutoff),
                       bk.kmer_solid_bits_plain(table, slots, cutoff))
    # a table that starts off the 16-byte grid takes the scalar loads
    off = torch.zeros(table.numel() + 4, dtype=torch.uint8, device="cuda")
    off[4:] = table
    assert torch.equal(bk.kmer_solid_bits(off[4:], slots, cutoff),
                       bk.kmer_solid_bits_plain(table, slots, cutoff))


@pytest.mark.cuda
def test_atomic_floor_adds_every_op_on_the_card():
    _need_card()
    table = torch.zeros(10_007, dtype=torch.int32, device="cuda")
    bk.atomic_floor(table, 1_000_003, 4099)
    assert int(table.sum()) == 1_000_003
    want = torch.bincount(torch.tensor([gate_kernel.mix64(c) % 10_007 for c in range(20_000)]),
                          minlength=10_007)
    small = torch.zeros(10_007, dtype=torch.int32, device="cuda")
    bk.atomic_floor(small, 20_000, 7)
    assert torch.equal(small.cpu().long(), want)
