"""The torch port's filter build (core/bfbuild.py over ops/build_kernel.py)
against the JAX package's, on the CPU: the histogram exact and sampled,
solid_cutoff and the .hist file, the device builder's counters and words
in the blocked and plain layouts, build_read_filter in its three forms
and build_genome_bf at each of its size sources, all equal.  Edge cases:
N, IUPAC and lowercase bytes, reads across a batch seam, several files,
k in {17, 25, 33}, hash_num 1-4, a 300-fold repeat, tables of 4n + 1 to
4n + 3 bytes.  Tests marked ``cuda`` hold each kernel to its plain
version on a card and skip without one.

The JAX package is imported inside the tests that compare with it, so
that the card's run of the ``cuda`` tests needs no JAX."""

import gzip

import numpy as np
import pytest
import torch

from ntedit_tpu_torch.core import bfbuild, bloom
from ntedit_tpu_torch.core import nthash as nt
from ntedit_tpu_torch.ops import build_kernel, gate_kernel
from ntedit_tpu_torch.utils import simulate

IUPAC = b"RYSWKMBDHV"


def _fastq(reads) -> bytes:
    return b"".join(b"@r%d\n%s\n+\n%s\n" % (i, r, b"I" * len(r)) for i, r in enumerate(reads))


@pytest.fixture(scope="module")
def reads(tmp_path_factory):
    """Two read files under one prefix: 600 gzipped 100 bp reads (about 3x
    of a 20 kbp genome) with 1% substitutions, and 200 plain ones with N
    runs, IUPAC bytes and lowercase stretches, plus 300 copies of one read
    (counts past 255)."""
    d = tmp_path_factory.mktemp("torch_bfbuild")
    rng = np.random.default_rng(1)
    genome = simulate.random_genome(20_000, seed=9)
    first, second = [], []
    for _ in range(600):
        s = int(rng.integers(0, len(genome) - 100))
        r = genome[s : s + 100].copy()
        flip = rng.random(100) < 0.01
        r[flip] = simulate.BASES[rng.integers(0, 4, size=int(flip.sum()))]
        first.append(r.tobytes())
    for i in range(200):
        s = int(rng.integers(0, len(genome) - 90))
        r = genome[s : s + 90].copy()
        if i % 3 == 0:
            r[int(rng.integers(0, 90))] = ord("N")
        if i % 5 == 0:
            r[int(rng.integers(0, 90))] = IUPAC[int(rng.integers(0, len(IUPAC)))]
        if i % 7 == 0:
            a = int(rng.integers(0, 60))
            r[a : a + 30] |= 0x20
        second.append(r.tobytes())
    second += [genome[500:560].tobytes()] * 300
    with gzip.open(d / "reads_1.fq.gz", "wb") as f:
        f.write(_fastq(first))
    (d / "reads_2.fq").write_bytes(_fastq(second))
    fasta = d / "genome.fa"
    fasta.write_bytes(b">g1 one\n" + genome[:12_000].tobytes() + b"\n>g2\n"
                      + genome[12_000:].tobytes().lower() + b"NNNN" + genome[:500].tobytes() + b"\n")
    return [str(d / "reads_1.fq.gz"), str(d / "reads_2.fq")], str(fasta), d


def _same_hist(got, want):
    assert (got.f1, got.f0) == (want.f1, want.f0)
    assert np.array_equal(got.spectrum, want.spectrum)


# ---------------------------------------------------------------------------
# batches and the histogram
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("batch", [64, 1000, bfbuild.BATCH])
def test_batches_see_every_window_once(reads, batch):
    """Consecutive pieces overlap by exactly k - 1 bytes: the windows of all
    pieces are the windows of the records, each once, in order."""
    paths, _, _ = reads
    k = 25
    whole = np.concatenate([np.concatenate([r, np.zeros(1, np.uint8)])
                            for r in bfbuild._iter_seqs(paths)])
    want = build_kernel.valid_hashes(torch.from_numpy(whole), len(whole) - k + 1, k)
    pieces = list(bfbuild.iter_separated_buffers(paths, k, batch))
    assert all(len(p) == batch for p in pieces[:-1]) and len(pieces[-1]) <= batch
    got = torch.cat([build_kernel.valid_hashes(torch.from_numpy(p), len(p) - k + 1, k)
                     for p in pieces])
    assert torch.equal(got, want)
    if batch < len(whole):
        assert len(pieces) > 1


@pytest.mark.parametrize("k", [17, 25, 33])
@pytest.mark.parametrize("batch", [1000, bfbuild.BATCH])
def test_histogram_exact_matches_jax(reads, k, batch):
    from ntedit_tpu.core import bfbuild as jb

    paths, _, _ = reads
    got = bfbuild.count_histogram(paths, k, device="cpu", batch=batch)
    _same_hist(got, jb.count_histogram(paths, k))
    assert got.spectrum[255] > 0  # the 300-fold read's k-mers, clamped


def test_histogram_sampled_matches_jax(reads):
    """The final slice is the smallest whose kept count fits the budget,
    whatever the batches: the port's per-batch sampling equals the JAX
    package's per-record sampling."""
    from ntedit_tpu.core import bfbuild as jb

    paths, _, _ = reads
    want = jb.count_histogram(paths, 25, sample_budget=5000)
    got = bfbuild.count_histogram(paths, 25, sample_budget=5000, device="cpu", batch=3000)
    _same_hist(got, want)
    assert got.f0 % 2 == 0 and got.f0 != bfbuild.count_histogram(paths, 25, device="cpu").f0


@pytest.mark.parametrize("budget,batch", [(2000, 700), (12_000, 700), (2000, 5000),
                                          (12_000, bfbuild.BATCH)])
def test_fused_sampling_matches_jax(reads, budget, batch):
    """The hashes kernel's plain version emits only the current slice's
    hashes and counts every valid window; batches kept before the slice
    rose are thinned on the device: the JAX package's histogram."""
    from ntedit_tpu.core import bfbuild as jb

    paths, _, _ = reads
    got = bfbuild.count_histogram(paths, 25, sample_budget=budget, device="cpu", batch=batch)
    _same_hist(got, jb.count_histogram(paths, 25, sample_budget=budget))


@pytest.mark.parametrize("k", [1, 17, 25, 33])
@pytest.mark.parametrize("s", [0, 1, 4])
def test_valid_hashes_match_jax(k, s):
    """The hashes pass (``kmer_valid_hashes``, plain on the CPU): the JAX
    package's valid canonical hashes in window order, those in sample
    slice s, and the count of valid windows, on a batch with N, IUPAC,
    lowercase and separator bytes."""
    from ntedit_tpu.core import bfbuild as jb

    seq = _edge_seq()
    n = len(seq) - k + 1
    want = jb.valid_canonical_hashes(seq, k)
    if s:
        want = want[(jb._sample_key(want) >> np.uint64(64 - s)) == 0]
    got, valid = build_kernel.kmer_valid_hashes(torch.from_numpy(seq), n, k, s)
    assert valid == len(jb.valid_canonical_hashes(seq, k)) > len(want) * (1 << s) // 2
    assert np.array_equal(nt.as_uint64(got), want)
    assert k == 1 or (nt.as_uint64(got) >= 1 << 63).any()  # k = 1 has four k-mers


@pytest.mark.parametrize("budget", [500, 4000])
def test_sampled_hashes_keep_only_their_bytes(budget):
    """Batches given as views into buffers of a hash per window, as the
    hashes kernel returns them: after every batch the kept ones hold at
    most twice the bytes of their hashes (not a buffer each), and the
    histogram equals that of the same hashes given compact."""
    rng = np.random.default_rng(11)
    n = 4096
    views, compact = bfbuild.SampledHashes(budget), bfbuild.SampledHashes(budget)
    for _ in range(60):
        h = torch.from_numpy(rng.integers(-(1 << 63), (1 << 63) - 1, size=n // 4, dtype=np.int64))
        h = torch.cat([h, h[: n // 8]])  # counts of 2
        s = views.s
        emit = h[build_kernel.in_slice(h, s)] if s else h
        buf = torch.zeros(n, dtype=torch.int64)
        buf[: emit.numel()] = emit
        views.add(buf[: emit.numel()], h.numel(), s)
        compact.add(emit.clone(), h.numel(), s)
        held = sum(a.untyped_storage().nbytes() for a in views.kept)
        assert held <= 2 * 8 * views.kept_n, (held, views.kept_n, views.s)
    assert views.s >= 3
    _same_hist(views.histogram(25), compact.histogram(25))


def test_sample_key_matches_jax():
    from ntedit_tpu.core import bfbuild as jb

    h = np.random.default_rng(5).integers(0, 1 << 64, size=4000, dtype=np.uint64)
    h[:4] = [0, 1 << 63, (1 << 64) - 1, 0x9E3779B97F4A7C15]
    got = nt.as_uint64(build_kernel.sample_key(nt.as_int64(h)))
    assert np.array_equal(got, jb._sample_key(h))
    for s in (1, 3, 17):
        want = (jb._sample_key(h) >> np.uint64(64 - s)) == 0
        assert np.array_equal(build_kernel.in_slice(nt.as_int64(h), s).numpy(), want)


def test_solid_cutoff_and_hist_file_match_jax(reads, tmp_path):
    from ntedit_tpu.core import bfbuild as jb

    paths, _, _ = reads
    got = bfbuild.count_histogram(paths, 25, device="cpu")
    want = jb.count_histogram(paths, 25)
    assert bfbuild.solid_cutoff(got) == jb.solid_cutoff(want)
    got.save(str(tmp_path / "port.hist"))
    want.save(str(tmp_path / "jax.hist"))
    assert (tmp_path / "port.hist").read_bytes() == (tmp_path / "jax.hist").read_bytes()
    back = bfbuild.Histogram.load(str(tmp_path / "port.hist"), k=25)
    _same_hist(back, got)
    assert back.solid_cardinality(2) == jb.Histogram.load(str(tmp_path / "jax.hist")).solid_cardinality(2)


# ---------------------------------------------------------------------------
# the device builder against DeviceFilterBuilder (JAX on its CPU backend)
# ---------------------------------------------------------------------------

def _jax_builder(paths, k, hash_num, nbits, slots, layout, cutoff):
    """DeviceFilterBuilder over the JAX package's own batches, each padded
    to one shape (zeros are invalid windows) so JAX compiles once."""
    from ntedit_tpu.core import bfbuild as jb

    pad = 1 << 14
    b = jb.DeviceFilterBuilder(k, hash_num, nbits, slots, layout=layout)
    bufs = []
    for buf in jb._iter_separated_buffers(paths, k, pad_to=pad):
        out = np.zeros(pad, np.uint8)
        out[: len(buf)] = buf
        bufs.append(out)
    if cutoff > 1:
        for buf in bufs:
            b.count_batch(buf)
    counters = np.asarray(b.counters)
    for buf in bufs:
        b.insert_batch(buf, cutoff)
    return counters, b.finish()


def _port_builder(paths, k, hash_num, nbits, slots, layout, cutoff, batch=5000):
    b = bfbuild.FilterBuilder(k, hash_num, nbits, slots if cutoff > 1 else 0, layout, "cpu")
    if cutoff > 1:
        for seq, n in bfbuild.device_batches(paths, k, "cpu", batch):
            b.count_batch(seq, n)
    counters = None if b.counters is None else b.counters[:slots].numpy().copy()
    for seq, n in bfbuild.device_batches(paths, k, "cpu", batch):
        b.insert_batch(seq, n, cutoff)
    return counters, b.finish()


@pytest.mark.parametrize("layout,cutoff", [("blocked", 1), ("blocked", 2), ("plain", 2)])
def test_filter_builder_matches_device_builder(reads, layout, cutoff):
    paths, _, _ = reads
    k, hash_num, nbits, slots = 25, 3, 1 << 16, 1 << 12
    want_c, want = _jax_builder(paths, k, hash_num, nbits, slots, layout, cutoff)
    got_c, got = _port_builder(paths, k, hash_num, nbits, slots, layout, cutoff)
    if cutoff > 1:
        assert np.array_equal(got_c, want_c) and got_c.max() == 255
    if layout == "blocked":
        assert isinstance(got, bloom.BlockedKmerBloomFilter)
        assert np.array_equal(got.words, want.words)
    else:
        assert isinstance(got, bloom.KmerBloomFilter)
        assert np.array_equal(got.data, want.data)
    assert got.pop_count > 0


@pytest.fixture(scope="module")
def jax_blocked_build(reads):
    """DeviceFilterBuilder's counters and words: blocked, cutoff 2, 2^12 slots."""
    paths, _, _ = reads
    return _jax_builder(paths, 25, 3, 1 << 16, 1 << 12, "blocked", 2)


@pytest.mark.parametrize("slice_bits,ways", [(12, 1), (10, 4), (9, 8)])
def test_filter_builder_slices_match_device_builder(reads, jax_blocked_build, monkeypatch,
                                                   slice_bits, ways):
    """The count pass binned by slice, over several batches, with the
    table split 1, 4 and 8 ways, then insertion over the solid bits: the
    counters and words of DeviceFilterBuilder."""
    paths, _, _ = reads
    want_c, want = jax_blocked_build
    monkeypatch.setattr(build_kernel, "SLICE_BITS", slice_bits)
    got_c, got = _port_builder(paths, 25, 3, 1 << 16, 1 << 12, "blocked", 2)
    assert ((1 << 12) - 1) >> slice_bits == ways - 1
    assert np.array_equal(got_c, want_c) and got_c.max() == 255
    assert np.array_equal(got.words, want.words)


# ---------------------------------------------------------------------------
# build_read_filter and build_genome_bf against the JAX package's
# ---------------------------------------------------------------------------

def test_build_read_filter_blocked_matches_jax_device_build(reads, monkeypatch):
    from ntedit_tpu.core import bfbuild as jb

    monkeypatch.setenv("NTEDIT_TPU_DEVICE_BUILD", "1")
    paths, _, _ = reads
    want, want_hist, want_cut = jb.build_read_filter(paths, 25, cutoff=2)
    got, hist, cut = bfbuild.build_read_filter(paths, 25, cutoff=2, device="cpu", batch=7000)
    assert cut == want_cut == 2
    _same_hist(hist, want_hist)
    assert isinstance(got, bloom.BlockedKmerBloomFilter)
    assert np.array_equal(got.words, want.words)


@pytest.mark.parametrize("counts,cutoff,solid", [(False, 2, False), (False, 1, False),
                                                 (False, 2, True), (True, 2, False)])
def test_build_read_filter_host_branch_matches_jax(reads, monkeypatch, tmp_path, counts,
                                                   cutoff, solid):
    """layout='plain' is the JAX package's host branch (btllib sizes, exact
    modulo); counts=True its counting filter.  The saved files are equal."""
    from ntedit_tpu.core import bfbuild as jb

    monkeypatch.setenv("NTEDIT_TPU_DEVICE_BUILD", "0")
    paths, _, _ = reads
    want, _, want_cut = jb.build_read_filter(paths, 25, cutoff=cutoff, solid=solid, counts=counts)
    got, _, cut = bfbuild.build_read_filter(paths, 25, cutoff=cutoff, solid=solid, counts=counts,
                                            layout="plain", device="cpu")
    assert cut == want_cut
    assert type(got).__name__ == type(want).__name__
    want.save(str(tmp_path / "jax.bf"))
    got.save(str(tmp_path / "port.bf"))
    assert (tmp_path / "port.bf").read_bytes() == (tmp_path / "jax.bf").read_bytes()


@pytest.mark.parametrize("source", ["bf_bytes", "num_elements", "length"])
def test_build_genome_bf_matches_jax(reads, tmp_path, source):
    from ntedit_tpu.core import bfbuild as jb

    _, fasta, _ = reads
    kw = {"bf_bytes": {"bf_bytes": 4 * 1001 + 3}, "num_elements": {"num_elements": 7_777},
          "length": {}}[source]
    want = jb.build_genome_bf([fasta], 25, **kw)
    got = bfbuild.build_genome_bf([fasta], 25, device="cpu", batch=4096, **kw)
    assert got.bytes == want.bytes
    want.save(str(tmp_path / "jax.bf"))
    got.save(str(tmp_path / "port.bf"))
    assert (tmp_path / "port.bf").read_bytes() == (tmp_path / "jax.bf").read_bytes()


# ---------------------------------------------------------------------------
# edge cases of the passes against the JAX package's host filters
# ---------------------------------------------------------------------------

def _edge_seq():
    """Windows with N, IUPAC, lowercase and separator bytes, and one k-mer
    repeated 300 times."""
    g = simulate.random_genome(3000, seed=12)
    g[100] = ord("N")
    g[700] = ord("Y")
    g[1200:1500] |= 0x20
    g[2000] = 0
    return np.concatenate([g] + [g[40:70], np.zeros(1, np.uint8)] * 300)


@pytest.mark.parametrize("pad", [1, 2, 3])
@pytest.mark.parametrize("hash_num", [1, 2, 3, 4])
def test_count_and_plain_insert_match_host_filters(hash_num, pad):
    """Tables of 4n + 1, 4n + 2 and 4n + 3 bytes (not powers of two: the
    exact modulo on hashes with bit 63 set), hash_num 1 to 4."""
    from ntedit_tpu.core import bfbuild as jb
    from ntedit_tpu.core import bloom as jbloom
    from ntedit_tpu.core import nthash_ref as jref

    k = 25
    seq = _edge_seq()
    base = jb.valid_canonical_hashes(seq, k)
    ext = jref.extend_hashes_vec(base, k, hash_num)
    size = 4 * 517 + pad
    cbf = jbloom.KmerCountingBloomFilter8.zeros(size, hash_num, k)
    cbf.insert_hashes(ext)
    bf = jbloom.KmerBloomFilter.zeros(size, hash_num, k)
    bf.insert_hashes(ext)

    t = torch.from_numpy(seq)
    n = len(seq) - k + 1
    counting = bfbuild.FilterBuilder(k, hash_num, 0, size, "counting", "cpu")
    counting.count_batch(t, n)
    got_cbf = counting.finish()
    assert got_cbf.bytes == size and np.array_equal(got_cbf.counters, cbf.counters)
    assert got_cbf.counters.max() == 255
    plain = bfbuild.FilterBuilder(k, hash_num, 8 * size, 0, "plain", "cpu")
    plain.insert_batch(t, n, 1)
    got_bf = plain.finish()
    assert got_bf.bytes == size and np.array_equal(got_bf.data, bf.data)
    assert (nt.as_uint64(nt.as_int64(base)) >> np.uint64(63)).any()


@pytest.mark.parametrize("cutoff", [2, 256])
def test_threshold_insert_matches_count_min(cutoff):
    """Insertion above the cutoff reads the count-min of every k-mer: the
    300-fold k-mers reach 255 and pass cutoff 2; nothing passes 256."""
    from ntedit_tpu.core import bfbuild as jb
    from ntedit_tpu.core import bloom as jbloom
    from ntedit_tpu.core import nthash_ref as jref

    k, hash_num, size = 25, 3, 4 * 301 + 1
    seq = _edge_seq()
    ext = jref.extend_hashes_vec(jb.valid_canonical_hashes(seq, k), k, hash_num)
    cbf = jbloom.KmerCountingBloomFilter8.zeros(size, hash_num, k)
    cbf.insert_hashes(ext)
    want = jbloom.KmerBloomFilter.zeros(4099, hash_num, k)
    ok = cbf.count_hashes(ext) >= cutoff
    if ok.any():
        want.insert_hashes(ext[ok])
    b = bfbuild.FilterBuilder(k, hash_num, 8 * 4099, size, "plain", "cpu")
    t = torch.from_numpy(seq)
    b.count_batch(t, len(seq) - k + 1)
    b.insert_batch(t, len(seq) - k + 1, cutoff)
    got = b.finish()
    assert np.array_equal(got.data, want.data)
    assert (got.pop_count > 0) == (cutoff == 2)


def test_or_bits_is_exact_under_duplicates():
    """The plain version's scatter-OR: repeated bits, bits already set and
    bit 31, against a Python loop."""
    rng = np.random.default_rng(3)
    start = rng.integers(0, 1 << 32, size=64, dtype=np.uint64).astype(np.uint32)
    bits = rng.integers(0, 64 * 32, size=900)
    bits[:40] = 31 + 32 * rng.integers(0, 64, size=40)
    want = start.copy()
    for b in bits:
        want[b >> 5] |= np.uint32(1 << (b & 31))
    words = torch.from_numpy(start.view(np.int32).copy())
    build_kernel.or_bits(words, torch.from_numpy(bits))
    assert np.array_equal(words.numpy().view(np.uint32), want)


def test_builder_limits_and_finish():
    with pytest.raises(NotImplementedError, match="2\\^31 words"):
        bfbuild.FilterBuilder(25, 3, 1 << 37, 0, "blocked", "cpu")
    with pytest.raises(NotImplementedError, match="2\\^36 bits"):
        bfbuild.FilterBuilder(25, 3, (1 << 36) + 8, 0, "plain", "cpu")
    with pytest.raises(ValueError):
        bfbuild.FilterBuilder(25, 3, 3 << 10, 0, "blocked", "cpu")
    with pytest.raises(ValueError):
        bfbuild.FilterBuilder(25, 3, 12, 0, "plain", "cpu")
    with pytest.raises(ValueError):
        bfbuild.FilterBuilder(25, 3, 0, 0, "counting", "cpu")
    b = bfbuild.FilterBuilder(25, 3, 1 << 10, 0, "blocked", "cpu")
    with pytest.raises(RuntimeError, match="counter"):
        b.count_batch(torch.zeros(64, dtype=torch.uint8), 40)
    b.finish()
    with pytest.raises(RuntimeError, match="already finished"):
        b.finish()
    with pytest.raises(RuntimeError, match="already finished"):
        b.insert_batch(torch.zeros(64, dtype=torch.uint8), 40, 1)


def test_build_defaults_to_the_card(reads):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is usable")
    paths, fasta, _ = reads
    with pytest.raises(RuntimeError, match="CUDA"):
        bfbuild.count_histogram(paths, 25)
    with pytest.raises(RuntimeError, match="CUDA"):
        bfbuild.build_genome_bf([fasta], 25)


# ---------------------------------------------------------------------------
# on a card: each kernel against its plain version
# ---------------------------------------------------------------------------

def _card_batch(k: int, length: int = 40_000):
    """A separator-joined batch with N, IUPAC and lowercase bytes and a
    300-fold repeat, padded for the kernels, on the card."""
    seq = _edge_seq()
    seq = np.concatenate([seq, simulate.random_genome(length, seed=13)])[:length]
    n = len(seq) - k + 1
    buf = torch.zeros(gate_kernel.padded_len(n), dtype=torch.uint8)
    buf[: len(seq)] = torch.from_numpy(seq)
    return buf.cuda(), n


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the build kernels have no CPU mode")


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 17, 25, 33, 64])
def test_hashes_kernel_matches_plain_on_the_card(k):
    _need_card()
    seq, n = _card_batch(k)
    for m in (n, gate_kernel.TILE + 1, gate_kernel.TILE, 33, 1):
        for s in (0, 1, 3):
            got, valid = build_kernel.kmer_valid_hashes(seq, m, k, s)
            want, want_valid = build_kernel.kmer_valid_hashes_plain(seq, m, k, s)
            assert torch.equal(got, want) and valid == want_valid, (m, s)
    none = torch.zeros_like(seq)  # separators only: no valid window
    got, valid = build_kernel.kmer_valid_hashes(none, n, k, 0)
    assert got.numel() == 0 and valid == 0


@pytest.mark.cuda
def test_histogram_keeps_only_emitted_bytes_on_the_card():
    """The kernel's hashes, batch after batch at a small budget: the kept
    batches hold at most twice the bytes of their hashes."""
    _need_card()
    seq, n = _card_batch(25)
    kept = bfbuild.SampledHashes(2000)
    for _ in range(40):
        s = kept.s
        kept.add(*build_kernel.kmer_valid_hashes(seq, n, 25, s), s)
        assert sum(a.untyped_storage().nbytes() for a in kept.kept) <= 2 * 8 * kept.kept_n
    assert kept.s >= 3


@pytest.mark.cuda
@pytest.mark.parametrize("hash_num", [1, 3, 4])
@pytest.mark.parametrize("slots", [4 * 1000 + 1, 4 * 1000 + 3, 1 << 12])
def test_count_kernel_matches_plain_on_the_card(hash_num, slots):
    _need_card()
    seq, n = _card_batch(25)
    got = torch.zeros(-(-slots // 4) * 4, dtype=torch.uint8, device="cuda")
    want = got.clone()
    build_kernel.kmer_count(seq, n, 25, hash_num, got, slots)
    build_kernel.kmer_count_plain(seq, n, 25, hash_num, want, slots)
    assert torch.equal(got, want) and int(got.max()) == 255


@pytest.mark.cuda
@pytest.mark.parametrize("layout,modulus", [("blocked", 1 << 10), ("plain", 8 * 4099),
                                            ("plain", 1 << 15)])
@pytest.mark.parametrize("cutoff", [1, 2, 3])
def test_insert_kernel_matches_plain_on_the_card(layout, modulus, cutoff):
    _need_card()
    seq, n = _card_batch(25)
    slots = 4 * 2001 + 2
    counters = torch.zeros(-(-slots // 4) * 4, dtype=torch.uint8, device="cuda")
    build_kernel.kmer_count_plain(seq, n // 2, 25, 3, counters, slots)
    nw = modulus if layout == "blocked" else -(-modulus // 32)
    got = torch.zeros(nw, dtype=torch.int32, device="cuda")
    want = got.clone()
    solid = build_kernel.kmer_solid_bits(counters, slots, cutoff) if cutoff > 1 else None
    build_kernel.kmer_insert(seq, n, 25, 3, got, layout, modulus, solid, slots)
    build_kernel.kmer_insert_plain(seq, n, 25, 3, want, layout, modulus, counters, slots, cutoff)
    assert torch.equal(got, want) and int(got.count_nonzero()) > 0
