"""The torch port's SNV passes (plain versions, on the CPU) against the JAX
package's: equal candidate heads (snv_candidate_positions) and equal
candidates and [G, 6] site rows (snv_site_data), exactly (integers,
tolerance 0), for blocked and plain filters, k = 25 and k > 33, jump 1
and 3, a contig of more than two 2^15-head chunks with N runs, IUPAC
bytes, a lowercase stretch and variants at both contig ends.

One difference is deliberate and asserted: where the byte after a
candidate's 2k - 1 checked bytes is not ACGT and the last stride window
reads it (jump divides k - 1), the JAX package hands out a row computed
from that byte coded as 'A'; the port's row is invalid (all zero).

The segmented SNV repair takes those candidates and rows: cut at SNV
mode's own reach (``native_repair._gap_margin``), it equals the
whole-contig engine, falls back to it once when a cascade of substitutions
passes a bucket's margin, makes 32 buckets of the human cell's job at
``-t 8``, and leaves polish mode's reach as it was."""

import dataclasses
import io

import numpy as np
import pytest
import torch

from ntedit_tpu.core import bloom as jbloom
from ntedit_tpu.engine import flag as jflag
from ntedit_tpu.utils import simulate
from ntedit_tpu_torch import convert
from ntedit_tpu_torch.core import bloom as tbloom
from ntedit_tpu_torch.engine import flag as tflag
from ntedit_tpu_torch.ops import snv_kernel
from ntedit_tpu_torch.utils import simulate as tsimulate

CHUNK = 1 << 15
LENGTH = 70_000  # more than two chunks of heads
BASES = np.frombuffer(b"ACGT", dtype=np.uint8)


def other_base(b, step=1):
    return BASES[(int(np.where(BASES == (b & 0xDF))[0][0]) + step) % 4]


def edge_heads(k, phase, length=LENGTH):
    """Heads whose tail base is a planted variant: the first head, the last
    head with a valid row (n-k-1) and the last head of the contig, the
    heads on one side of each chunk edge (phase 0); or the first head whose
    row is invalid (n-k) and the heads on the other side (phase 1).  The
    two sets cannot share a draft: neighbours lie in each other's windows."""
    n = length - k + 1
    if phase == 0:
        return [0, CHUNK - 1, 2 * CHUNK, n - k - 1, n - 1]
    return [1, CHUNK, 2 * CHUNK - 1, n - k]


def workload(k, seed, phase, length=LENGTH):
    """(variant genome the filter holds, the reference to call against):
    substitutions about 1 per 500 bases, the tails of ``edge_heads`` among
    them, N runs, IUPAC bytes and a lowercase stretch."""
    variant = simulate.random_genome(length, seed=seed)
    rng = np.random.default_rng(seed + 1)
    draft = variant.copy()
    planted = np.asarray(edge_heads(k, phase, length)) + k - 1
    tails = rng.integers(k, length - k, size=length // 500)
    tails = tails[np.abs(tails[:, None] - planted).min(axis=1) > 2 * k]
    for p in np.concatenate([tails, planted]):
        draft[p] = other_base(variant[p], int(rng.integers(1, 4)))
    noise = rng.integers(3 * k, length - 3 * k, size=14)
    noise = noise[np.abs(noise[:, None] - planted).min(axis=1) > 2 * k]
    draft[noise[:-4]] = np.frombuffer(b"RYSWKMBDHV", np.uint8)[: len(noise) - 4]
    for p in noise[-4:]:
        draft[p : p + int(rng.integers(1, 9))] = ord("N")
    draft[length // 2 : length // 2 + 400] |= 0x20
    return variant, draft


def filters(layout, k, variant):
    if layout == "blocked":
        f = jbloom.BlockedKmerBloomFilter.zeros(1 << 18, 3, k)
        f.insert_seq(variant)
        arr = f.words
    else:
        f = jbloom.KmerBloomFilter.zeros(150_001, 3, k)  # not a power of two
        f.insert_seq(variant)
        arr = f.data
    _, tdf = convert.filter_from_numpy(layout, arr, 3, k, device="cpu")
    return jbloom.DeviceFilter.from_host(f), tdf


@pytest.mark.parametrize("layout,k,phase", [("blocked", 25, 0), ("plain", 25, 1),
                                            ("blocked", 40, 1), ("plain", 35, 0)])
def test_candidates_match_jax(layout, k, phase):
    variant, draft = workload(k, 10 + k, phase)
    jdf, tdf = filters(layout, k, variant)
    want = jflag.snv_candidate_positions(draft, jdf, chunk=CHUNK)
    got = tflag.snv_candidate_positions(draft, tdf, chunk=CHUNK)
    assert got.dtype == np.int64
    np.testing.assert_array_equal(got, want)
    n = len(draft) - k + 1
    assert set(edge_heads(k, phase)).issubset(set(got.tolist()))
    assert len(got) < n // 20  # sparse: a hint, not every head


@pytest.mark.parametrize("layout,k,jump,phase", [("blocked", 25, 1, 1), ("blocked", 25, 3, 0),
                                                 ("plain", 25, 3, 1), ("blocked", 40, 3, 0),
                                                 ("plain", 35, 7, 0)])
def test_site_data_matches_jax(layout, k, jump, phase):
    variant, draft = workload(k, 20 + k + jump, phase)
    jdf, tdf = filters(layout, k, variant)
    want_cand, want_rows = jflag.snv_site_data(draft, jdf, jump, chunk=CHUNK)
    got_cand, got_rows = tflag.snv_site_data(draft, tdf, jump, chunk=CHUNK)
    np.testing.assert_array_equal(got_cand, want_cand)
    np.testing.assert_array_equal(got_cand, tflag.snv_candidate_positions(draft, tdf, chunk=CHUNK))
    assert got_rows.dtype == np.uint8 and got_rows.shape == (len(got_cand), 6)
    # the byte past the 2k - 1 that the JAX package checks, where it exists
    past = np.minimum(got_cand + 2 * k - 1, len(draft) - 1)
    stricter = (got_cand <= len(draft) - 2 * k) & ~np.isin(draft[past] & 0xDF, BASES)
    assert not got_rows[stricter].any()
    np.testing.assert_array_equal(got_rows[~stricter], want_rows[~stricter])
    n = len(draft) - k + 1
    valid = got_rows[:, 0] & 1 == 1
    assert valid.sum() > len(got_cand) // 2
    edges = np.asarray(edge_heads(k, phase))
    assert np.isin(edges, got_cand).all()
    np.testing.assert_array_equal(valid[np.isin(got_cand, edges)], edges <= n - k - 1)
    assert not valid[got_cand >= n - k].any()  # the scan would leave the contig
    assert (got_rows[~valid] == 0).all()
    # a true variant: its base in the filter's genome is verified by every stride
    strides = len(range(0, k, jump))
    assert (got_rows[valid, 2:].max(axis=1) == strides).sum() >= 50


@pytest.mark.parametrize("end", ["ends_at", "ends_past"])
def test_site_data_matches_jax_on_index_lists(end, monkeypatch):
    """Candidates planted as simulate.site_lists' ``overlapping`` heads
    (k to 2k - 1 apart, so their [h, h + 2k) overlap; the filter's false
    positives add candidates between them) and the first head of ``end``
    (h + 2k = n, or n + 1): the rows equal the JAX package's, and each
    planted row is valid."""
    k, jump = 25, 3
    variant = simulate.random_genome(LENGTH, seed=41)
    n = LENGTH - k + 1
    lists = tsimulate.site_lists(n, k, at=1000)
    planted = np.concatenate([lists["overlapping"], lists[end][:1]])
    draft = variant.copy()
    for h in planted:
        draft[h + k - 1] = other_base(variant[h + k - 1])
    jdf, tdf = filters("blocked", k, variant)  # test_site_data_matches_jax's compiled program
    # the JAX package caches a packed draft by its id and 192 of its bytes
    monkeypatch.setenv("NTEDIT_TPU_NO_PACK_CACHE", "1")
    want_cand, want_rows = jflag.snv_site_data(draft, jdf, jump, chunk=CHUNK)
    got_cand, got_rows = tflag.snv_site_data(draft, tdf, jump, chunk=CHUNK)
    np.testing.assert_array_equal(got_cand, want_cand)
    np.testing.assert_array_equal(got_rows, want_rows)
    at = np.searchsorted(got_cand, planted)
    np.testing.assert_array_equal(got_cand[at], planted)
    assert (np.diff(planted[:-1]) < 2 * k).all()  # their scans overlap
    assert (got_rows[at, 0] & 1 == 1).all()


def test_rows_at_the_stricter_validity():
    """A candidate whose byte h + 2k - 1 is N: every byte the JAX package
    checks is ACGT, but the last stride window (kk = k - 1, jump 3 divides
    24) reads the N.  The port's row is zero; one byte earlier it is valid."""
    k, jump = 25, 3
    variant = simulate.random_genome(3000, seed=5)
    f = tbloom.BlockedKmerBloomFilter.zeros(1 << 14, 3, k)
    f.insert_seq(variant)
    df = tbloom.DeviceFilter.from_host(f, "cpu")
    draft = variant.copy()
    h = 1000
    draft[h + k - 1] = other_base(variant[h + k - 1])
    draft[h + 2 * k - 1] = ord("N")
    n = len(draft) - k + 1
    seq = torch.from_numpy(draft)
    cand = torch.tensor([h - 1, h], dtype=torch.int64)
    rows = snv_kernel.snv_site_rows(seq, n, cand, df, jump).numpy()
    assert rows[0, 0] & 1 == 1 and not rows[1].any()
    assert h in tflag.snv_candidate_positions(draft, df, chunk=CHUNK)


def test_short_and_empty_contigs():
    k = 25
    variant = simulate.random_genome(500, seed=6)
    f = tbloom.BlockedKmerBloomFilter.zeros(1 << 12, 3, k)
    f.insert_seq(variant)
    df = tbloom.DeviceFilter.from_host(f, "cpu")
    for L in (0, k - 1):
        assert tflag.snv_candidate_positions(variant[:L], df).shape == (0,)
        cand, rows = tflag.snv_site_data(variant[:L], df, 3)
        assert cand.shape == (0,) and rows.shape == (0, 6)
    one = variant[:k].copy()  # one head; its scan cannot fit
    one[k - 1] = other_base(one[k - 1])
    cand, rows = tflag.snv_site_data(one, df, 3)
    np.testing.assert_array_equal(cand, [0])
    assert not rows.any()
    cand, rows = tflag.snv_site_data(np.full(300, ord("N"), np.uint8), df, 3)
    assert cand.shape == (0,) and rows.shape == (0, 6)


def test_wrappers_check_their_arguments():
    k = 25
    seq = torch.from_numpy(simulate.random_genome(400, seed=7))
    cbf = tbloom.KmerCountingBloomFilter8.zeros(4099, 3, k)
    cdf = tbloom.DeviceFilter.from_host(cbf, "cpu")
    with pytest.raises(ValueError, match="counting"):
        snv_kernel.snv_cand_words(seq, 100, cdf)
    with pytest.raises(ValueError, match="counting"):
        snv_kernel.snv_site_rows(seq, 100, torch.zeros(1, dtype=torch.int64), cdf, 3)
    f = tbloom.BlockedKmerBloomFilter.zeros(1 << 12, 3, k)
    df = tbloom.DeviceFilter.from_host(f, "cpu")
    with pytest.raises(ValueError, match="int64"):
        snv_kernel.snv_site_rows(seq, 100, torch.zeros(1, dtype=torch.int32), df, 3)
    with pytest.raises(ValueError, match="jump"):
        snv_kernel.snv_site_rows(seq, 100, torch.zeros(1, dtype=torch.int64), df, 0)
    assert snv_kernel.snv_cand_words(seq, 0, df).shape == (0,)
    assert snv_kernel.snv_site_rows(seq, 100, torch.zeros(0, dtype=torch.int64), df, 3).shape == (0, 6)


def test_positions_on_device_matches_host_unpack():
    rng = np.random.default_rng(8)
    words = rng.integers(0, 1 << 32, size=500, dtype=np.uint64).astype(np.uint32)
    words[rng.integers(0, 500, size=350)] = 0
    words[7] = 0x80000001
    want = tflag.packed_to_positions(words, 32 * len(words))
    got = tflag.positions_on_device(torch.from_numpy(words.view(np.int32)))
    np.testing.assert_array_equal(got.numpy(), want)


# ---------------------------------------------------------------------------
# The segmented SNV repair's cut rule (native_repair._gap_margin in SNV mode):
# the device's candidates and site rows through polish_contig_segmented equal
# the whole-contig engine on the same candidates, bucket for bucket.
# ---------------------------------------------------------------------------

# (filter bytes, stand-in hashes) a k: ~4.3% candidates at k 25 (the human
# cell's 4.55%), ~1% at k 55, so that both have legal cuts on 100 kbp
SEGMENT_FILTERS = {25: (1 << 18, 45_000), 55: (1 << 19, 0)}


def snv_segment_job(k, seed, length=100_000):
    """(reference, blocked filter of a sample): one SNV a 400 bp at random
    sites, 40% homozygous, both haplotypes in the filter, plus seeded
    stand-in hashes for the rest of a genome's k-mers."""
    rng = np.random.default_rng(seed)
    ref = tsimulate.random_genome(length, seed=seed)
    hap_a, hap_b = ref.copy(), ref.copy()
    for s in rng.choice(np.arange(k, length - k), size=length // 400, replace=False):
        hap_b[s] = other_base(ref[s], int(rng.integers(1, 4)))
        if rng.random() >= 0.6:
            hap_a[s] = hap_b[s]
    nbytes, filler = SEGMENT_FILTERS[k]
    bf = tbloom.BlockedKmerBloomFilter.zeros(nbytes, 3, k)
    bf.insert_seq(hap_a)
    bf.insert_seq(hap_b)
    bf.insert_base(rng.integers(0, 2**64, size=filler, dtype=np.uint64))
    return ref, bf


def _segmented_and_whole(ref, bf, k, threads):
    """The Polisher's candidates and site rows of ``ref``, then the
    segmented repair under ``recording()`` and the whole-contig engine:
    (segmented result, whole result, counters, candidates)."""
    from ntedit_tpu_torch.engine import native_repair
    from ntedit_tpu_torch.engine.config import EngineConfig
    from ntedit_tpu_torch.engine.polish import Polisher
    from ntedit_tpu_torch.utils import profiling

    cfg = EngineConfig(k=k, hash_num=3, snv=True, threads=threads)
    pol = Polisher(bf, None, cfg, chunk=CHUNK, device="cpu")
    assert pol._snv_fast_eligible()
    cand, rows = tflag.snv_site_data(ref, pol.df, cfg.jump, chunk=pol.chunk)
    with profiling.recording() as rec:
        seg = native_repair.polish_contig_segmented(
            bf, None, cfg, "c", ref, cand, threads=threads, allow_snv=True, site_rows=rows)
    whole = native_repair.polish_contig_native(bf, None, cfg, "c", ref, gate_hint=cand,
                                               site_rows=rows)
    return seg, whole, rec.counters, cand


def _render(res):
    from ntedit_tpu_torch.io import writers

    sinks = io.StringIO(), io.StringIO(), io.StringIO()
    writers.write_contig(res, *sinks, None, snv=True)
    return tuple(s.getvalue() for s in sinks)


@pytest.mark.parametrize("seed", [2**31 + 19, 19])
@pytest.mark.parametrize("threads", [2, 8])
@pytest.mark.parametrize("k", [25, 55])
def test_segmented_snv_repair_equals_whole_contig(k, threads, seed):
    """SNV mode cuts at candidate-free gaps of more than 4k - 2 heads: ten
    or more legal cuts on 100 kbp, four or more native calls, and the
    edited sequence, records and the three outputs of the whole-contig
    engine on the same candidates and rows."""
    from ntedit_tpu_torch.engine import native_repair
    from ntedit_tpu_torch.engine.config import EngineConfig

    ref, bf = snv_segment_job(k, seed)
    seg, whole, counters, cand = _segmented_and_whole(ref, bf, k, threads)
    gap, _ = native_repair._gap_margin(EngineConfig(k=k, snv=True).validate())
    assert gap == 4 * k - 2
    assert int((np.diff(cand) > gap).sum()) >= 10
    assert counters["engine.segments"] >= 4
    assert len(whole.subs) > 100
    assert seg.edited == whole.edited and seg.subs == whole.subs
    assert _render(seg) == _render(whole)


@pytest.mark.parametrize("k", [25, 55])
def test_snv_cascade_past_the_margin_falls_back_to_the_whole_contig(k):
    """Homozygous SNVs chained from a bucket's last candidate g: the
    substitution at its site makes the engine visit the next k - 1 heads,
    one of them substitutes again, and the record after it lies past
    g + 2k - 2, found by a verify that reads to g + 4k - 3, the slice's
    last base.  The overflow guard sends the contig back to one whole call,
    once (``engine.segment_fallbacks``), with the same output.  Every site
    starts such a chain, so whichever candidate ends a bucket, some bucket
    ends at one."""
    from ntedit_tpu_torch.engine import native_repair
    from ntedit_tpu_torch.engine.config import EngineConfig

    threads, length = 8, 40_000
    rng = np.random.default_rng(k)
    ref = tsimulate.random_genome(length, seed=k)
    sites = np.arange(1000, length - 1000, 400)
    hap_a, hap_b = ref.copy(), ref.copy()
    for s0 in sites:
        # homozygous at s0 and in its re-visits (s0 + k - 2), then one past the margin
        for s, hom in ((s0, True), (s0 + k - 2, True), (s0 + 2 * k - 4, False)):
            hap_b[s] = other_base(ref[s], int(rng.integers(1, 4)))
            if hom:
                hap_a[s] = hap_b[s]
    bf = tbloom.BlockedKmerBloomFilter.zeros(1 << 20, 3, k)
    bf.insert_seq(hap_a)
    bf.insert_seq(hap_b)

    seg, whole, counters, cand = _segmented_and_whole(ref, bf, k, threads)
    cfg = EngineConfig(k=k, hash_num=3, snv=True, threads=threads).validate()
    bounds, margin = native_repair._bucket_bounds(cand, cfg, 4 * threads)
    ends = [int(cand[i1 - 1]) + k - 1 for _i0, i1 in bounds[:-1]]
    chained = [s0 for s0 in ends if s0 in set(sites.tolist())]
    assert chained and margin == 2 * k - 2
    subs = {r.pos: r for r in whole.subs}
    for s0 in chained:
        assert subs[s0].sub_base != subs[s0].draft_char
        assert subs[s0 + k - 2].sub_base != subs[s0 + k - 2].draft_char
        assert s0 + 2 * k - 4 in subs and s0 + 2 * k - 4 > s0 - k + 1 + margin
    assert counters["engine.segment_fallbacks"] == 1
    assert counters["engine.segments"] == len(bounds) >= 4
    assert seg.edited == whole.edited and seg.subs == whole.subs
    assert _render(seg) == _render(whole)


def test_snv_buckets_at_the_cells_scale():
    """The human cell's job, as candidates only: 64.4 M heads at 4.55%
    candidates, no candidate in the 500 kbp N run at 44%.  At -t 8 the SNV
    rule (gap 218 at k 55) makes 32 buckets, none more than twice the
    mean; polish mode's rule (gap 334 with d = 0) found 1 or 2 cuts there."""
    from ntedit_tpu_torch.engine import native_repair
    from ntedit_tpu_torch.engine.config import EngineConfig

    n = 64_444_167 - 55 + 1
    rng = np.random.default_rng(2**31 + 5)
    gates = np.cumsum(rng.geometric(0.0455, size=int(n * 0.0455 * 1.05))) - 1
    run = int(0.44 * n)
    gates = gates[(gates < run) | ((gates >= run + 500_000) & (gates < n))]
    snv = EngineConfig(k=55, hash_num=3, snv=True, threads=8).validate()
    assert native_repair._gap_margin(snv) == (218, 108)
    bounds, margin = native_repair._bucket_bounds(gates, snv, 4 * 8)
    sizes = np.array([i1 - i0 for i0, i1 in bounds])
    assert margin == 108 and len(bounds) == 32 and sizes.sum() == len(gates)
    assert all(b[1] == c[0] for b, c in zip(bounds, bounds[1:]))
    assert sizes.max() <= 2 * len(gates) / 32
    old = dataclasses.replace(snv, max_insertions=0, max_deletions=0, snv=False)
    assert native_repair._gap_margin(old)[0] == 334
    assert len(native_repair._bucket_bounds(gates, old, 4 * 8)[0]) <= 3


@pytest.mark.parametrize("k,i,d,want", [(25, 4, 5, (174, 117)), (55, 5, 5, (339, 222))])
def test_polish_gap_margin_is_unchanged(k, i, d, want):
    """Polish mode keeps its reach: the ecoli cell's -k 25 -i 4 -d 5 and the
    human polish configuration's -k 55 -i 5 -d 5, 4k + 1.5k + d + 32 and
    that less 2k + d + 2."""
    from ntedit_tpu_torch.engine import native_repair
    from ntedit_tpu_torch.engine.config import EngineConfig

    cfg = EngineConfig(k=k, hash_num=3, max_insertions=i, max_deletions=d).validate()
    assert native_repair._gap_margin(cfg) == want
