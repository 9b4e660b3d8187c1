"""The torch port's gate stream (iter_gate_chunks, on the CPU through the
gate kernel's plain version) against the JAX package's: the same
(frontier, gates) sequence on drafts with N, IUPAC and lowercase bytes,
for the blocked, plain and counting layouts; and, for blocked filters,
against the Pallas kernel run in interpret mode."""

import numpy as np
import pytest
import torch

from ntedit_tpu.core import bloom as jbloom
from ntedit_tpu.core import nthash_ref as ref
from ntedit_tpu.engine import flag as jflag
from ntedit_tpu.ops import flag_kernel
from ntedit_tpu.utils import simulate
from ntedit_tpu_torch import convert
from ntedit_tpu_torch.engine import flag as tflag
from ntedit_tpu_torch.ops import gate_kernel

CHUNK = 1 << 15


def make_draft(k, length=70_000, seed=0):
    rng = np.random.default_rng(seed)
    truth = simulate.random_genome(length + 500, seed=seed + 1)
    draft, _ = simulate.inject_errors(truth, sub_rate=3e-3, seed=seed + 2)
    draft = draft[:length].copy()
    for p in rng.integers(0, length - 20, size=6):  # N runs
        draft[p : p + int(rng.integers(1, 15))] = ord("N")
    draft[rng.integers(0, length, size=40)] = np.frombuffer(b"RYSWKMBDHV", np.uint8)[
        rng.integers(0, 10, size=40)]
    draft[length // 70 : length // 20] |= 0x20  # lowercase stretch
    draft[length // 2 : length // 2 + 4] = np.frombuffer(b"acgn", np.uint8)
    return truth, draft


def make_filter(layout, truth, k):
    if layout == "blocked":
        f = jbloom.BlockedKmerBloomFilter.zeros(1 << 16, 3, k)
        f.insert_seq(truth)
        return f, f.words, 3
    if layout == "plain":
        f = jbloom.KmerBloomFilter.zeros(150_001, 4, k)  # not a power of two
        f.insert_seq(truth)
        return f, f.data, 4
    f = jbloom.KmerCountingBloomFilter8.zeros(400_009, 3, k)
    fh, rh = ref.all_window_hashes(truth, k)
    hashes = ref.extend_hashes_vec(ref.canonical(fh, rh), k, 3)
    f.insert_hashes(hashes)
    f.insert_hashes(hashes[: len(hashes) // 2])  # counts 1 and 2
    return f, f.counters, 3


# (k, layout, min_threshold, snv): both k, all three layouts, counting
# with -p 1 and 3, snv on and off
CASES = [
    (17, "blocked", 1, False), (25, "blocked", 1, True),
    (17, "plain", 1, True), (25, "plain", 1, False),
    (17, "counting", 3, False), (25, "counting", 1, False),
    (25, "counting", 3, True),
]


@pytest.mark.parametrize("k,layout,p,snv", CASES)
def test_gate_stream_matches_jax(k, layout, p, snv):
    truth, draft = make_draft(k, seed=k)
    jf, arr, h = make_filter(layout, truth, k)
    _, df = convert.filter_from_numpy(layout, arr, h, k, device="cpu")
    jdf = jbloom.DeviceFilter.from_host(jf)
    want = list(jflag.iter_gate_chunks(draft, jdf, snv=snv, min_threshold=p, chunk=CHUNK))
    got = list(tflag.iter_gate_chunks(draft, df, snv=snv, min_threshold=p, chunk=CHUNK))
    assert len(got) == len(want) >= 3
    last = 0
    for (gf, gg), (wf, wg) in zip(got, want):
        assert gf == wf and gf > last
        assert gg.dtype == np.int64
        np.testing.assert_array_equal(gg, wg)
        assert ((gg >= last) & (gg < gf)).all()
        last = gf
    assert last == len(draft) - k + 1
    gates = np.concatenate([g for _, g in got])
    assert 0 < len(gates) < len(draft) - k + 1
    if layout == "blocked":
        pallas = flag_kernel.flag_contig_gates_pallas(draft, jdf, snv=snv, chunk=8192,
                                                      interpret=True)
        np.testing.assert_array_equal(gates, pallas)


@pytest.mark.parametrize("layout", ["blocked", "plain", "counting"])
def test_short_contigs(layout):
    k = 25
    truth, draft = make_draft(k, length=3000, seed=4)
    jf, arr, h = make_filter(layout, truth, k)
    _, df = convert.filter_from_numpy(layout, arr, h, k, device="cpu")
    jdf = jbloom.DeviceFilter.from_host(jf)
    assert list(tflag.iter_gate_chunks(draft[: k - 1], df)) == []
    assert len(tflag.flag_contig_gates(draft[:10], df)) == 0
    for L in (k, k + 40):
        want = jflag.flag_contig_gates(draft[:L], jdf, min_threshold=2)
        got = tflag.flag_contig_gates(draft[:L], df, min_threshold=2)
        np.testing.assert_array_equal(got, want)


def test_gate_words_layout():
    """Little-endian words, zero bits past n, and the gate formula."""
    k = 17
    truth, draft = make_draft(k, length=5000, seed=8)
    jf, arr, h = make_filter("blocked", truth, k)
    _, df = convert.filter_from_numpy("blocked", arr, h, k, device="cpu")
    n = 1000 + 13
    buf = torch.zeros(gate_kernel.padded_len(n), dtype=torch.uint8)
    buf[: n + k - 1] = torch.from_numpy(draft[: n + k - 1].copy())
    words = gate_kernel.gate_words(buf, n, df, snv=True).numpy().view(np.uint32)
    assert words.shape == (-(-n // 32),)
    bits = np.unpackbits(words.view(np.uint8), bitorder="little")
    assert not bits[n:].any()
    valid, _ = gate_kernel.window_flags(buf, n, k)
    np.testing.assert_array_equal(bits[:n].astype(bool), valid.numpy())  # snv gates every valid head
    np.testing.assert_array_equal(tflag.packed_to_positions(words, n), np.flatnonzero(bits[:n]))


def test_k_above_halo_raises():
    f = jbloom.BlockedKmerBloomFilter.zeros(1 << 10, 3, gate_kernel.MAX_K + 1)
    _, df = convert.filter_from_numpy("blocked", f.words, 3, f.k, device="cpu")
    with pytest.raises(ValueError, match="k <="):
        list(tflag.iter_gate_chunks(np.full(3000, ord("A"), np.uint8), df))
