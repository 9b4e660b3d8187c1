"""The binned SNV candidate pass (ops/snv_kernel.py snv_cand_bin and
snv_cand_probe, and its grouping in engine/flag.py) on the CPU, through
the plain versions: every due probe binned once into the (slice, block)
range of its filter word, the forced bits stored, and the probed words
equal to the candidate kernel's plain version (snv_cand_words_plain, the
whole pass's reference) bit for bit, with filters split into 1 to 256
slices, contigs of several 8192-head blocks, a poly-A contig (every probe
in at most three slices), all-N and IUPAC bytes, n = 1, 31-33 and a tile
+-1.  Then the whole pass in groups of chunks against the JAX package's
candidate heads (one JAX program for the module).  Tests marked ``cuda``
hold the kernels to the plain versions on a card (tests/test_torch_package.py)."""

import numpy as np
import pytest
import torch

from ntedit_tpu_torch.core import bloom
from ntedit_tpu_torch.engine import flag
from ntedit_tpu_torch.ops import gate_kernel, snv_kernel
from ntedit_tpu_torch.utils import simulate

K = 25
WORDS = 1 << 14
IUPAC = np.frombuffer(b"RYSWKMBDHV", np.uint8)


def contig(length: int, seed: int) -> tuple:
    """(variant the filter holds, draft): a substitution about every 300
    bases, N runs, IUPAC bytes and a lowercase stretch."""
    rng = np.random.default_rng(seed)
    variant = simulate.random_genome(length, seed=seed)
    draft = variant.copy()
    sub = rng.integers(0, length, size=max(1, length // 300))
    draft[sub] = simulate.BASES[(rng.integers(1, 4, size=sub.size) + (draft[sub] == ord("C"))) % 4]
    draft[rng.integers(0, length, size=max(1, length // 2000))] = IUPAC[rng.integers(0, 10)]
    for p in rng.integers(0, max(1, length - 10), size=max(1, length // 5000)):
        draft[p : p + 5] = ord("N")
    draft[length // 3 : length // 3 + 200] |= 0x20
    return variant, draft


def device_filter(variant, k=K, words=WORDS):
    f = bloom.BlockedKmerBloomFilter.zeros(words * 4, 3, k)
    f.insert_seq(variant)
    return bloom.DeviceFilter.from_host(f, "cpu")


def padded(draft: np.ndarray, n: int, k: int) -> torch.Tensor:
    buf = torch.zeros(gate_kernel.padded_len(max(n, 1)), dtype=torch.uint8)
    buf[: min(len(draft), n + k - 1)] = torch.from_numpy(draft[: n + k - 1].copy())
    return buf


def due_probes(seq, n, df) -> tuple:
    """(head, can) of every probe the pass is due, straight from the plain
    hashes: the three alternates of each valid head with no IUPAC byte."""
    valid, iupac = gate_kernel.window_flags(seq[: n + df.k - 1], n, df.k)
    heads, cans = [], []
    for _b, allowed, can in snv_kernel.alternate_hashes(seq, n, df.k):
        pos = torch.nonzero(valid & ~iupac & allowed).squeeze(1)
        heads.append(pos)
        cans.append(can[pos])
    return torch.cat(heads), torch.cat(cans)


def binned_words(seq, n, df, slice_bits):
    bins = snv_kernel.CandBins(df.modulus, max(1, n), "cpu", slice_bits)
    out = torch.full((max(1, -(-n // 32)),), -1, dtype=torch.int32)  # stored over, not ORed
    snv_kernel.snv_cand_bin(seq, n, df, bins, out)
    snv_kernel.snv_cand_probe(bins, df, out)
    return bins, out[: -(-n // 32)]


@pytest.mark.parametrize("slice_bits,k", [(23, 25), (10, 25), (6, 25), (0, 33), (3, 1)])
def test_bins_hold_every_due_probe_once(slice_bits, k):
    variant, draft = contig(30_000, seed=40 + slice_bits)
    df = device_filter(variant, k)
    n = len(draft) - k + 1
    seq = padded(draft, n, k)
    bins, _ = binned_words(seq, n, df, slice_bits)
    assert bins.n_slices == ((WORDS - 1) >> bins.slice_bits) + 1 <= snv_kernel.MAX_CAND_SLICES
    assert bins.columns == -(-n // gate_kernel.TILE) * snv_kernel.CAND_ROUNDS
    assert n > 2 * gate_kernel.TILE
    cells = bins.cells()
    counts, ends = bins.counts[:cells].long(), bins.ends[:cells]
    assert torch.equal(torch.cumsum(counts, 0), ends)
    cell, head, can = snv_kernel.bin_entries(bins)
    slice_id = (can & (WORDS - 1)) >> bins.slice_bits
    column = head // gate_kernel.TILE * snv_kernel.CAND_ROUNDS + head % 32 // 4
    assert torch.equal(cell, slice_id * bins.columns + column)
    want_head, want_can = due_probes(seq, n, df)
    got = torch.sort(head * (1 << 20) + (can & 0xFFFFF)).values
    want = torch.sort(want_head * (1 << 20) + (want_can & 0xFFFFF)).values
    assert torch.equal(got, want) and bins.total() == want_head.numel()
    assert torch.equal(torch.sort(can).values, torch.sort(want_can).values)
    if slice_bits <= 10:
        assert int((counts.view(bins.n_slices, bins.columns).sum(1) > 0).sum()) > 1


@pytest.mark.parametrize("case", ["contig", "poly_a", "all_n", "iupac_run", "short"])
def test_binned_words_equal_the_candidate_kernels(case):
    variant, draft = contig(20_000, seed=50)
    df = device_filter(variant)
    lengths = [len(draft)]
    if case == "poly_a":
        draft = np.full(20_000, ord("A"), np.uint8)
        draft[777] = ord("C")
        df = device_filter(np.concatenate([draft[:5000], np.full(100, ord("C"), np.uint8)]))
    elif case == "all_n":
        draft = np.full(9000, ord("N"), np.uint8)
    elif case == "iupac_run":
        draft[4000:4100] = ord("Y")
    elif case == "short":
        t = gate_kernel.TILE
        lengths = [n + K - 1 for n in (1, 31, 32, 33, t - 1, t, t + 1)]
    for L in lengths:
        n = L - K + 1
        seq = padded(draft, n, K)
        want = snv_kernel.snv_cand_words_plain(seq, n, df)
        for bits in (23, 4):
            bins, got = binned_words(seq, n, df, bits)
            assert torch.equal(got, want), (case, L, bits)
    if case == "poly_a":  # the A-run's probes share three words: three cells a column at most,
        # beside the 75 probes of the windows over the one C
        assert 0 < int((bins.counts[: bins.cells()] > 0).sum()) <= 3 * bins.columns + 75
    if case == "all_n":
        assert bins.total() == 0 and not got.any()


def test_bin_wrappers_check_their_arguments():
    variant, draft = contig(3000, seed=60)
    df = device_filter(variant)
    n = len(draft) - K + 1
    seq = padded(draft, n, K)
    out = torch.zeros(-(-n // 32), dtype=torch.int32)
    with pytest.raises(ValueError, match="power-of-two"):
        snv_kernel.CandBins(3 * 1024, n, "cpu")
    with pytest.raises(ValueError, match="heads"):
        snv_kernel.CandBins(WORDS, 0, "cpu")
    with pytest.raises(ValueError, match="up to"):
        snv_kernel.snv_cand_bin(seq, n, df, snv_kernel.CandBins(WORDS, n - 1, "cpu"), out)
    with pytest.raises(ValueError, match="blocked filter of"):
        snv_kernel.snv_cand_bin(seq, n, df, snv_kernel.CandBins(WORDS * 2, n, "cpu"), out)
    pl = bloom.KmerBloomFilter.zeros(40_001, 3, K)
    pdf = bloom.DeviceFilter.from_host(pl, "cpu")
    with pytest.raises(ValueError):
        snv_kernel.snv_cand_bin(seq, n, pdf, snv_kernel.CandBins(WORDS, n, "cpu"), out)
    with pytest.raises(ValueError, match="int32"):
        snv_kernel.snv_cand_bin(seq, n, df, snv_kernel.CandBins(WORDS, n, "cpu"), out[:3])
    # slices of 16 MiB, at most 64 by default; at most 256 at a given size
    assert [snv_kernel.CandBins(1 << w, 10, "meta").n_slices for w in (20, 26, 28, 30, 31)] == \
        [1, 16, 64, 64, 64]
    assert snv_kernel.CandBins(1 << 31, 10, "meta", 0).n_slices == snv_kernel.MAX_CAND_SLICES
    assert snv_kernel.CandBins(1 << 14, 10, "meta", 4).n_slices == 256
    # the density rule: a group's three probes a head against the filter's sectors
    assert not snv_kernel.binned(pdf, 1 << 30) and snv_kernel.binned(df, 1 << 30)
    assert snv_kernel.binned(df, -(-WORDS // 24)) and not snv_kernel.binned(df, WORDS // 24)


@pytest.fixture(scope="module")
def groups_workload():
    from ntedit_tpu.core import bloom as jbloom

    variant, draft = contig(70_000, seed=70)
    jf = jbloom.BlockedKmerBloomFilter.zeros(WORDS * 4, 3, K)
    jf.insert_seq(variant)
    return draft, jbloom.DeviceFilter.from_host(jf), device_filter(variant)


@pytest.mark.parametrize("chunks_per_group,slice_bits,density", [(1, 23, 0), (2, 5, 0), (3, 9, 0),
                                                                 (100, 0, 0), (2, 5, 10.0),
                                                                 (1, 5, 1e9)])
def test_grouped_pass_matches_jax(groups_workload, monkeypatch, chunks_per_group, slice_bits,
                                  density):
    """The binned pass over groups of 1, 2, 3 and every chunk (the last group
    partial), filters of 1 to 256 slices; groups below the density rule (the
    last group's 4,440 heads at 10 probes a sector, every group at 1e9) by the candidate
    kernel: the JAX package's candidate heads."""
    from ntedit_tpu.engine import flag as jflag

    draft, jdf, tdf = groups_workload
    chunk = 1 << 15
    monkeypatch.setattr(flag, "BIN_BUDGET", chunks_per_group * chunk * 3 * snv_kernel.ENTRY_BYTES)
    monkeypatch.setattr(snv_kernel, "CAND_SLICE_BITS", slice_bits)
    monkeypatch.setattr(snv_kernel, "MIN_PROBES_PER_SECTOR", density)
    calls = {"bin": 0, "words": 0}

    def spy(name, fn):
        def run(*args):
            calls[name] += 1
            return fn(*args)
        return run

    monkeypatch.setattr(snv_kernel, "snv_cand_bin", spy("bin", snv_kernel.snv_cand_bin))
    monkeypatch.setattr(snv_kernel, "snv_cand_words", spy("words", snv_kernel.snv_cand_words))
    got = flag.snv_candidate_positions(draft, tdf, chunk=chunk)
    np.testing.assert_array_equal(got, jflag.snv_candidate_positions(draft, jdf, chunk=chunk))
    assert len(got) > 100
    n = len(draft) - K + 1
    groups = -(-n // (chunks_per_group * chunk))
    last = n - (groups - 1) * chunks_per_group * chunk
    binned = 0 if density > 1e6 else groups - int(24 * last < density * WORDS)
    assert calls["bin"] == binned and (calls["words"] > 0) == (binned < groups)


def test_given_bins_serve_contig_after_contig(groups_workload, monkeypatch):
    """One caller's scratch (flag.cand_bins sizes it for a whole group)
    reused by contig after contig, no other allocated: the JAX package's
    candidate heads each time.  Off the card cand_bins gives none."""
    from ntedit_tpu.engine import flag as jflag

    draft, jdf, tdf = groups_workload
    chunk = 1 << 15
    assert flag.cand_bins(tdf, chunk) is None
    monkeypatch.setattr(flag, "BIN_BUDGET", 2 * chunk * 3 * snv_kernel.ENTRY_BYTES)
    monkeypatch.setattr(snv_kernel, "CAND_SLICE_BITS", 5)
    monkeypatch.setattr(snv_kernel, "MIN_PROBES_PER_SECTOR", 0)
    bins = snv_kernel.CandBins(tdf.modulus, flag._group(chunk), "cpu")

    def no_other(*args):
        raise AssertionError("the pass allocated bins of its own")

    monkeypatch.setattr(snv_kernel, "CandBins", no_other)
    for piece in (draft, draft[20_000:55_000].copy(), draft):
        got = flag.snv_candidate_positions(piece, tdf, chunk=chunk, bins=bins)
        np.testing.assert_array_equal(got, jflag.snv_candidate_positions(piece, jdf, chunk=chunk))
        assert len(got) > 50
