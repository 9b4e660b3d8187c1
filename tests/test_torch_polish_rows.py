"""Polish mode's two optional device passes in the torch port (plain
versions, on the CPU) against the JAX package's, and the Polisher's
engines that use them.

* Site rows (flag.iter_polish_site_chunks, ops/snv_kernel.py
  polish_site_rows): at every head where both packages hand out a valid
  row, the rows are equal (integers, tolerance 0), for blocked and plain
  filters, k 25 and 21, jump 1 and 3; the gates are the JAX package's,
  chunk by chunk across 2^15-head chunk seams; flags bit 5 ("device-exact
  gate") is set on every gate but the IUPAC-forced ones.  Two differences
  are deliberate and asserted: the port checks the bytes [h, h + 2k) that
  the row's scan reads, where the JAX package checks [h, h + 2k - 1); and
  the port's cluster starts are those of its own gate list, so a head
  after an IUPAC-forced gate starts no cluster.
* Candidate masks (flag.polish_candidate_masks, ops/snv_kernel.py
  polish_cand_masks): the gated form (the heads are absence gates, the
  draft's own base is not probed) equal to the JAX package's at every gate,
  0xFF cases included; the four-probe form (gated=False) at any head, its
  own-base bit the window's own presence; both computed from int64
  positions (the JAX gather gives up past 2^31); the one-pass
  flag.contig_gates_and_masks equal to the gate pass followed by the masks,
  with one contig upload.
* Polisher(engine="pipelined"|"native", site_rows=, cand_masks=): outputs
  byte-equal to the JAX Polisher with NTEDIT_TPU_SITE_ROWS /
  NTEDIT_TPU_CAND and to the host-only full scan; rows and masks reach the
  engine, which acts on them; runs they are not exact for get neither."""

import io

import numpy as np
import pytest
import torch

from ntedit_tpu.core import bloom as jbloom
from ntedit_tpu.engine import flag as jflag
from ntedit_tpu.engine.config import EngineConfig as JConfig
from ntedit_tpu.engine.polish import Polisher as JPolisher
from ntedit_tpu.io import writers as jwriters
from ntedit_tpu.utils import simulate
from ntedit_tpu_torch import convert
from ntedit_tpu_torch.core import bloom as tbloom
from ntedit_tpu_torch.engine import flag as tflag
from ntedit_tpu_torch.engine import native_repair
from ntedit_tpu_torch.engine.config import EngineConfig as TConfig
from ntedit_tpu_torch.engine.polish import Polisher as TPolisher
from ntedit_tpu_torch.io import writers as twriters
from ntedit_tpu_torch.ops import snv_kernel
from ntedit_tpu_torch.utils import simulate as tsimulate

CHUNK = 1 << 15
LENGTH = 70_000  # more than two chunks of heads
ACGT = np.frombuffer(b"ACGT", dtype=np.uint8)
IUPAC = np.frombuffer(b"RYSWKMBDHV", dtype=np.uint8)


def workload(length, seed):
    """(truth, draft): substitutions and short indels, IUPAC bytes, an N
    run and a lowercase stretch."""
    truth = simulate.random_genome(length, seed=seed)
    draft, _ = simulate.inject_errors(truth, sub_rate=2e-3, ins_rate=3e-4, del_rate=3e-4,
                                      seed=seed + 1)
    draft = draft.copy()
    rng = np.random.default_rng(seed + 2)
    draft[rng.integers(100, len(draft) - 100, size=10)] = IUPAC[:10]
    draft[len(draft) // 3 : len(draft) // 3 + 6] = ord("N")
    draft[len(draft) // 2 : len(draft) // 2 + 300] |= 0x20
    return truth, draft


def filters(layout, k, truth, hash_num=3):
    """(JAX host filter, JAX DeviceFilter, torch host filter, torch
    DeviceFilter) holding the truth's k-mers."""
    if layout == "blocked":
        f = jbloom.BlockedKmerBloomFilter.zeros(1 << 18, hash_num, k)
        f.insert_seq(truth)
        arr = f.words
    else:
        f = jbloom.KmerBloomFilter.zeros(150_001, hash_num, k)  # not a power of two
        f.insert_seq(truth)
        arr = f.data
    th, tdf = convert.filter_from_numpy(layout, arr, hash_num, k, device="cpu")
    return f, jbloom.DeviceFilter.from_host(f), th, tdf


def window_has(draft, heads, k, classes):
    """bool per head: the window [h, h + k) holds a byte of ``classes``."""
    hit = np.isin(draft & 0xDF, classes)
    c = np.concatenate([[0], np.cumsum(hit)])
    return c[heads + k] - c[heads] > 0


def stream(it):
    return [(f, g, r) for f, g, r in it]


# The JAX package compiles its row program once per (filter shape, k, jump)
# and unrolls the strides: on the CPU that takes 5-19 s for a blocked
# filter and 14-120 s for a plain one (hash extension and the 64-bit modulo
# in 32-bit halves), so the plain layout is compiled twice: with one hash,
# and with three (the layout of the main path's btllib filter) at jump = k,
# one stride, which keeps the unrolled program small.  The kernels are held
# to the plain version, at hash_num 3 and 4 and jump 1, 3 and k, on the card.
@pytest.mark.parametrize("layout,k,jump,hash_num", [("blocked", 25, 3, 3), ("blocked", 21, 1, 3),
                                                    ("plain", 21, 3, 1), ("plain", 25, 25, 3)])
def test_rows_match_jax_at_common_valid_heads(layout, k, jump, hash_num):
    truth, draft = workload(LENGTH, seed=10 + k + jump)
    _, jdf, _, tdf = filters(layout, k, truth, hash_num)
    want = stream(jflag.iter_polish_site_chunks(draft, jdf, jump, chunk=CHUNK))
    got = stream(tflag.iter_polish_site_chunks(draft, tdf, jump, chunk=CHUNK))
    assert [(f, len(g)) for f, g, _ in got] == [(f, len(g)) for f, g, _ in want]
    g = np.concatenate([x[1] for x in got])
    np.testing.assert_array_equal(g, np.concatenate([x[1] for x in want]))
    rows = np.concatenate([x[2] for x in got])
    jrows = np.concatenate([x[2] for x in want])
    assert rows.dtype == np.uint8 and rows.shape == (len(g), 6)
    np.testing.assert_array_equal(rows[:, 0] & 32, jrows[:, 0] & 32)
    valid, jvalid = rows[:, 0] & 1 == 1, jrows[:, 0] & 1 == 1
    both = valid & jvalid
    np.testing.assert_array_equal(rows[both], jrows[both])
    assert both.sum() >= 40
    # JAX rows the port does not hand out: the stricter validity (byte
    # h + 2k - 1 not ACGT) or a predecessor gate forced by an IUPAC byte
    n = len(draft) - k + 1
    past = draft[np.minimum(g + 2 * k - 1, len(draft) - 1)] & 0xDF
    stricter = ~np.isin(past, ACGT)
    after_forced = np.isin(g - 1, g[window_has(draft, g, k, IUPAC)])
    assert not (jvalid & ~valid & ~stricter & ~after_forced).any()
    assert not valid[g > n - k - 1].any()
    assert (rows[~valid, 1:] == 0).all() and (rows[~valid, 0] & ~np.uint8(32) == 0).all()
    # check_missing: a cluster start's windows miss the error it starts at
    strides = len(range(0, k, jump))
    assert (rows[valid, 1] <= strides).all() and rows[valid, 1].max() > 0


def test_rows_at_the_stricter_validity():
    """A cluster start h (a substitution at h + k - 1) whose byte h + 2k - 1
    is N: every byte the JAX package checks is ACGT, but the last stride
    window (kk = k - 1, jump 3 divides 24) reads the N.  The JAX row is
    valid, the port's carries bit 5 alone; with the N one byte later both
    are valid and equal."""
    k, jump = 25, 3
    truth = simulate.random_genome(3000, seed=5)
    _, jdf, _, tdf = filters("blocked", k, truth)  # the first case's compiled program
    h = 1000
    for at, port_valid in ((h + 2 * k - 1, False), (h + 2 * k, True)):
        draft = truth.copy()
        draft[h + k - 1] = ACGT[(int(np.flatnonzero(ACGT == truth[h + k - 1])[0]) + 1) % 4]
        draft[at] = ord("N")
        (_, jg, jrows), = list(jflag.iter_polish_site_chunks(draft, jdf, jump, chunk=CHUNK))
        (_, g, rows), = list(tflag.iter_polish_site_chunks(draft, tdf, jump, chunk=CHUNK))
        np.testing.assert_array_equal(g, jg)
        i = int(np.searchsorted(g, h))
        assert g[i] == h and (i == 0 or g[i - 1] != h - 1)
        assert jrows[i, 0] & 1 == 1
        if port_valid:
            np.testing.assert_array_equal(rows[i], jrows[i])
        else:
            assert rows[i].tolist() == [32, 0, 0, 0, 0, 0]


def test_exact_gate_bit():
    """Flags bit 5 is off at every gate whose window holds an IUPAC byte
    (a forced gate) and on at every other gate."""
    k = 25
    truth, draft = workload(40_000, seed=31)
    draft[np.arange(3000, 40_000, 997)] = IUPAC[np.arange(38) % 10]
    *_, tdf = filters("plain", k, truth)
    chunks = list(tflag.iter_polish_site_chunks(draft, tdf, 3, chunk=CHUNK))
    g = np.concatenate([c[1] for c in chunks])
    rows = np.concatenate([c[2] for c in chunks])
    forced = window_has(draft, g, k, IUPAC)
    assert forced.sum() > 300 and (~forced).sum() > 300
    np.testing.assert_array_equal(rows[:, 0] & 32 == 32, ~forced)
    np.testing.assert_array_equal(g, tflag.flag_contig_gates(draft, tdf, chunk=CHUNK))


def test_site_chunks_across_seams():
    """Chunk by chunk the gates are iter_gate_chunks' and the JAX package's;
    each chunk's rows are the whole list's rows but at its first gate,
    which always starts a cluster (a cluster crosses each seam here)."""
    k, jump = 25, 3
    truth, draft = workload(LENGTH, seed=38)
    for seam in (CHUNK, 2 * CHUNK):  # a substitution whose cluster spans the seam
        p = seam + k // 2
        draft[p] = ACGT[(int(np.flatnonzero(ACGT == draft[p] & 0xDF)[0]) + 2) % 4]
    _, jdf, _, tdf = filters("blocked", k, truth)
    got = stream(tflag.iter_polish_site_chunks(draft, tdf, jump, chunk=CHUNK))
    want = stream(jflag.iter_polish_site_chunks(draft, jdf, jump, chunk=CHUNK))
    plain = list(tflag.iter_gate_chunks(draft, tdf, chunk=CHUNK))
    assert len(got) == 3
    for (f, g, _), (jf, jg, _), (pf, pg) in zip(got, want, plain):
        assert f == jf == pf
        np.testing.assert_array_equal(g, jg)
        np.testing.assert_array_equal(g, pg)
    g = np.concatenate([x[1] for x in got])
    rows = np.concatenate([x[2] for x in got])
    n = len(draft) - k + 1
    whole = snv_kernel.polish_site_rows(torch.from_numpy(draft), n, torch.from_numpy(g),
                                        tdf, jump).numpy()
    firsts = np.cumsum([0] + [len(x[1]) for x in got[:-1]])
    at_seam = np.zeros(len(g), dtype=bool)
    at_seam[firsts] = True
    np.testing.assert_array_equal(rows[~at_seam], whole[~at_seam])
    for i, seam in zip(firsts[1:], (CHUNK, 2 * CHUNK)):
        assert g[i] == seam and g[i - 1] == seam - 1  # the cluster crosses it
        assert rows[i, 0] & 1 == 1 and whole[i, 0] & 1 == 0


def list_workload(truth, k, heads):
    """(draft, JAX DeviceFilter, torch DeviceFilter): the draft is ``truth``
    around ``heads`` and N elsewhere; the filters (blocked, the first
    case's shape) hold the k-mers of that stretch but those at ``heads``,
    so the gates are exactly ``heads`` (the N windows are no gates, and a
    few thousand k-mers leave the filter all but free of false positives)."""
    lo, hi = max(int(heads[0]) - 2 * k, 0), min(int(heads[-1]) + 3 * k, len(truth))
    draft = np.full(len(truth), ord("N"), dtype=np.uint8)
    draft[lo:hi] = truth[lo:hi]
    f = jbloom.BlockedKmerBloomFilter.zeros(1 << 18, 3, k)
    keep = np.zeros(len(truth) - k + 1, dtype=np.int8)
    keep[lo : hi - k + 1] = 1
    keep[heads] = 0
    edges = np.flatnonzero(np.diff(np.concatenate([[0], keep, [0]])))
    for a, b in zip(edges[::2], edges[1::2]):  # the kept heads [a, b)
        f.insert_seq(truth[a : b + k - 1])
    _, tdf = convert.filter_from_numpy("blocked", f.words, 3, k, device="cpu")
    return draft, jbloom.DeviceFilter.from_host(f), tdf


@pytest.mark.parametrize("name", ["all_starts", "long_cluster", "block_edges", "ends_at",
                                  "ends_past"])
def test_rows_match_jax_on_index_lists(name, monkeypatch):
    """The gate list is one of simulate.site_lists (list_workload): every
    gate a cluster start, a cluster of 300 gates, starts at list index 0,
    255-258 and 511-514, rows with h + 2k at n and n + 1 and past the
    contig's last byte.  The port's rows equal the JAX package's at every
    gate, and a row is valid exactly at the cluster starts whose scan fits
    the contig."""
    k, jump = 25, 3
    truth = simulate.random_genome(LENGTH, seed=77)
    n = LENGTH - k + 1
    heads = tsimulate.site_lists(n, k, at=1000)[name]
    draft, jdf, tdf = list_workload(truth, k, heads)
    # the JAX package caches a packed draft by its id and its first, middle
    # and last 64 bytes, which these drafts share (all N)
    monkeypatch.setenv("NTEDIT_TPU_NO_PACK_CACHE", "1")
    want = stream(jflag.iter_polish_site_chunks(draft, jdf, jump, chunk=CHUNK))
    got = stream(tflag.iter_polish_site_chunks(draft, tdf, jump, chunk=CHUNK))
    g = np.concatenate([x[1] for x in got])
    np.testing.assert_array_equal(g, heads)
    np.testing.assert_array_equal(g, np.concatenate([x[1] for x in want]))
    rows = np.concatenate([x[2] for x in got])
    np.testing.assert_array_equal(rows, np.concatenate([x[2] for x in want]))
    start = np.ones(len(g), dtype=bool)
    start[1:] = g[1:] != g[:-1] + 1
    np.testing.assert_array_equal(rows[:, 0] & 1 == 1, start & (g <= n - k - 1))
    assert (rows[:, 0] & 32 == 32).all()
    if name == "all_starts":
        assert start.all()
    elif name == "block_edges":
        assert np.flatnonzero(start).tolist() == [0, 255, 256, 257, 258, 511, 512, 513, 514]
    elif name == "long_cluster":
        assert np.diff(np.flatnonzero(start)).max() == 300


@pytest.mark.parametrize("layout", ["blocked", "plain"])
def test_masks_match_jax(layout):
    """On the gates of a contig longer than two chunks (IUPAC windows, an N
    run, a lowercase stretch): the gated masks, through flag and from the
    plain version, equal the JAX package's."""
    k = 25
    truth, draft = workload(LENGTH, seed=44)
    _, jdf, _, tdf = filters(layout, k, truth)
    gates = tflag.flag_contig_gates(draft, tdf, chunk=CHUNK)
    want = jflag.polish_candidate_masks(draft, jdf, gates, chunk=CHUNK)
    got = tflag.polish_candidate_masks(draft, tdf, gates)
    assert got.dtype == np.uint8 and got.shape == gates.shape
    np.testing.assert_array_equal(got, want)
    n = len(draft) - k + 1
    plain = snv_kernel.polish_cand_masks_plain(torch.from_numpy(draft), n,
                                               torch.from_numpy(gates), tdf, gated=True)
    np.testing.assert_array_equal(plain.numpy(), want)
    other = window_has(draft, gates, k, np.setdiff1d(np.arange(256), ACGT))
    np.testing.assert_array_equal(got == 0xFF, other)
    assert other.sum() > 100 and (got[~other] != 0).sum() > 100
    lower = (draft[gates + k - 1] >= ord("a")) & ~other
    assert lower.sum() > 5 and (got[lower] != 0).any()
    assert tflag.polish_candidate_masks(draft, tdf, gates[:0]).shape == (0,)


@pytest.mark.parametrize("layout", ["blocked", "plain"])
def test_mask_forms_at_any_head(layout):
    """At every head of a stretch (gates and present windows): the
    four-probe form's bit for the draft's own base is the window's own
    presence, its other bits the alternates'; the gated form is the same
    with that bit 0, and at the gates the two forms agree."""
    k = 25
    truth, draft = workload(20_000, seed=45)
    *_, tdf = filters(layout, k, truth)
    n = len(draft) - k + 1
    seq = torch.from_numpy(draft)
    heads = torch.arange(0, n + 3, dtype=torch.int64)  # and three past the last window
    four = snv_kernel.polish_cand_masks(seq, n, heads, tdf, gated=False).numpy()
    three = snv_kernel.polish_cand_masks(seq, n, heads, tdf, gated=True).numpy()
    clean = four != 0xFF
    assert (~clean[n:]).all() and clean.sum() > n // 2
    own = 1 << np.searchsorted(ACGT, draft[np.minimum(heads.numpy(), n - 1) + k - 1] & 0xDF)
    own = own.astype(np.uint8)
    gate = np.zeros(n + 3, dtype=bool)
    gate[tflag.flag_contig_gates(draft, tdf, chunk=CHUNK)] = True
    np.testing.assert_array_equal((four[clean] & own[clean]) != 0, ~gate[clean])
    np.testing.assert_array_equal(three[clean], four[clean] & ~own[clean])
    np.testing.assert_array_equal(three[~clean], four[~clean])
    np.testing.assert_array_equal(three[gate], four[gate])


@pytest.mark.parametrize("layout,chunk", [("blocked", CHUNK), ("plain", CHUNK),
                                          ("blocked", tflag.DEFAULT_CHUNK)])
def test_contig_gates_and_masks_equal_two_passes(layout, chunk):
    """flag.contig_gates_and_masks equals flag_contig_gates followed by
    polish_candidate_masks, across chunk seams or in one chunk, with one
    contig upload where the two passes make two; and on contigs with no
    gate or no window."""
    k = 25
    truth, draft = workload(LENGTH, seed=46)
    *_, tdf = filters(layout, k, truth)
    before = tflag.uploads
    gates, masks = tflag.contig_gates_and_masks(draft, tdf, chunk=chunk)
    assert tflag.uploads == before + 1
    want = tflag.flag_contig_gates(draft, tdf, chunk=chunk)
    np.testing.assert_array_equal(gates, want)
    np.testing.assert_array_equal(masks, tflag.polish_candidate_masks(draft, tdf, want))
    assert gates.dtype == np.int64 and masks.dtype == np.uint8 and len(gates) > 500
    clean = truth[:5000]
    for seq in (clean, clean[: k - 1]):
        g, m = tflag.contig_gates_and_masks(seq, tdf, chunk=chunk)
        assert g.shape == m.shape == (0,)


def test_mask_positions_above_2_31():
    """The masks of windows at heads past 2^31 and 2^32, on a contig that is
    one byte expanded (no storage is allocated): the same as at a head near
    the start.  The poly-A k-mer with its last base C is in the filter,
    poly-A itself is not, so every mask is 0b0010."""
    k = 25
    f = tbloom.BlockedKmerBloomFilter.zeros(1 << 12, 3, k)
    f.insert_seq(np.frombuffer(b"A" * (k - 1) + b"C", np.uint8))
    df = tbloom.DeviceFilter.from_host(f, "cpu")
    length = (1 << 32) + 1000
    big = torch.full((1,), ord("A"), dtype=torch.uint8).expand(length)
    heads = torch.tensor([5, (1 << 31) - 1, 1 << 31, (1 << 31) + 7, (1 << 32) + 3,
                          length - k], dtype=torch.int64)
    masks = snv_kernel.polish_cand_masks(big, length - k + 1, heads, df, gated=False)
    assert masks.tolist() == [0b0010] * len(heads)
    past = torch.tensor([length - k + 1, -1], dtype=torch.int64)  # no window there
    assert snv_kernel.polish_cand_masks(big, length - k + 1, past, df,
                                        gated=False).tolist() == [0xFF] * 2


def host_scan(tf, cfg, draft):
    return native_repair.polish_contig_native(tf, None, cfg.validate(), "ctg one", draft)


def render(writers, result):
    sinks = io.StringIO(), io.StringIO(), io.StringIO()
    writers.write_contig(result, *sinks, {})
    return tuple(s.getvalue() for s in sinks)


POLISHER_CASES = [("pipelined", True, 1), ("pipelined", True, 4), ("pipelined", False, 4),
                  ("native", True, 1), ("native", True, 4), ("native", False, 4)]


@pytest.mark.parametrize("engine,on,threads", POLISHER_CASES)
def test_polisher_matches_jax_and_the_host_scan(engine, on, threads, monkeypatch):
    k = 25
    truth, draft = workload(50_000, seed=60 + threads)
    jf, _, tf, _ = filters("blocked", k, truth)
    monkeypatch.setenv("NTEDIT_TPU_SITE_ROWS" if engine == "pipelined" else "NTEDIT_TPU_CAND",
                       "1" if on else "0")
    jpol = JPolisher(jf, None, JConfig(k=k, hash_num=3, threads=threads), chunk=CHUNK,
                     engine=engine)
    tpol = TPolisher(tf, None, TConfig(k=k, hash_num=3, threads=threads), chunk=CHUNK,
                     device="cpu", engine=engine, site_rows=on, cand_masks=on)
    want = jpol.polish_contig("ctg one", draft)
    got = tpol.polish_contig("ctg one", draft)
    scan = host_scan(tf, TConfig(k=k, hash_num=3), draft)
    assert len(got.subs) > 20
    assert render(twriters, got) == render(jwriters, want) == render(twriters, scan)
    assert got.edited == scan.edited


def spy_on_the_engine(monkeypatch):
    """Record (n_gates, masks, rows) of every native call."""
    seen = []
    real = native_repair._run_raw

    def spy(lib, contig, pristine, gates, *args, site_rows=None):
        cand = args[3] if len(args) > 3 else None  # (bf, reject, params, gate_cand)
        seen.append((0 if gates is None else len(gates), cand, site_rows))
        return real(lib, contig, pristine, gates, *args, site_rows=site_rows)

    monkeypatch.setattr(native_repair, "_run_raw", spy)
    return seen


def test_rows_and_masks_reach_the_engine(monkeypatch):
    """The pipelined engine with rows hands the native calls rows parallel
    to their gates, the native engine with masks hands them masks, from one
    upload of the contig; and the engine acts on what it is handed (rows or
    masks that claim the wrong probe results change the output)."""
    k = 25
    truth, draft = workload(30_000, seed=91)
    *_, tf, _ = filters("blocked", k, truth)
    cfg = TConfig(k=k, hash_num=3, threads=4)
    scan = host_scan(tf, cfg, draft)
    seen = spy_on_the_engine(monkeypatch)
    for engine in ("pipelined", "native"):
        seen.clear()
        pol = TPolisher(tf, None, cfg, chunk=CHUNK, device="cpu", engine=engine,
                        site_rows=True, cand_masks=True)
        before = tflag.uploads
        assert pol.polish_contig("c", draft).edited == scan.edited
        assert tflag.uploads == before + 1
        assert seen
        if engine == "pipelined":
            assert all(c is None and r is not None and r.shape == (n, 6) for n, c, r in seen)
            rows = np.concatenate([r for _, _, r in seen])
            assert (rows[:, 0] & 1).sum() > 20 and (rows[:, 0] & 32).sum() > len(rows) // 2
        else:
            assert all(r is None and c is not None and c.shape == (n,) for n, c, r in seen)
            masks = np.concatenate([c for _, c, _ in seen])
            assert (masks == 0xFF).sum() > 0 and ((masks != 0xFF) & (masks != 0)).sum() > 20
    gates = tflag.flag_contig_gates(draft, pol.df, chunk=CHUNK)
    n = len(draft) - k + 1
    rows = snv_kernel.polish_site_rows(torch.from_numpy(draft), n, torch.from_numpy(gates),
                                       pol.df, 3).numpy()
    lying = rows.copy()
    lying[lying[:, 0] & 1 == 1, 1] = 0  # "no stride window is missing": no attempt
    masks = np.zeros(len(gates), dtype=np.uint8)  # "no base fits"
    for kw in (dict(site_rows=lying), dict(gate_cand=masks)):
        res = native_repair.polish_contig_native(tf, None, cfg, "c", draft, gate_hint=gates, **kw)
        assert res.edited != scan.edited
    res = native_repair.polish_contig_native(tf, None, cfg, "c", draft, gate_hint=gates,
                                             site_rows=rows, gate_cand=tflag.polish_candidate_masks(
                                                 draft, pol.df, gates))
    assert res.edited == scan.edited


def test_replay_takes_the_masks_of_the_streamed_gates(monkeypatch):
    """The pipelined engine with masks on, its segment run failed: the
    replay hands the native engine the streamed gates with their gated
    masks, and the output is the host-only scan's."""
    k = 25
    truth, draft = workload(30_000, seed=93)
    *_, tf, _ = filters("blocked", k, truth)
    cfg = TConfig(k=k, hash_num=3, threads=4)
    scan = host_scan(tf, cfg, draft)
    real = native_repair.polish_contig_pipelined

    def failed(*args, collect_gates=None, **kw):
        res = real(*args, collect_gates=collect_gates, **kw)
        assert res is not None and collect_gates
        return None

    monkeypatch.setattr(native_repair, "polish_contig_pipelined", failed)
    seen = spy_on_the_engine(monkeypatch)
    pol = TPolisher(tf, None, cfg, chunk=CHUNK, device="cpu", cand_masks=True)
    assert render(twriters, pol.polish_contig("ctg one", draft)) == render(twriters, scan)
    gates = tflag.flag_contig_gates(draft, pol.df, chunk=CHUNK)
    want = tflag.polish_candidate_masks(draft, pol.df, gates)
    masks = [c for n, c, _ in seen if c is not None]
    assert masks and sum(len(c) for c in masks) == len(gates)
    np.testing.assert_array_equal(np.concatenate(masks), want)


@pytest.mark.parametrize("case", ["counting", "reject", "mode2"])
def test_no_rows_or_masks_where_they_are_not_exact(case, monkeypatch):
    """A counting filter, a reject filter and -m 2 get neither rows nor
    masks (the engine's probes there are not plain contains), whatever the
    switches say; the outputs equal the host-only scan."""
    k = 25
    truth, draft = workload(30_000, seed=95)
    *_, tf, _ = filters("blocked", k, truth)
    rep = None
    kw = {}
    if case == "counting":
        tf = tbloom.KmerCountingBloomFilter8.zeros(300_007, 3, k)
        tsimulate.fill_counts(tf, truth, 2)
    elif case == "reject":
        rep = tbloom.KmerBloomFilter.zeros(20_011, 3, k)
        rep.insert_seq(truth[2000:6000])
    else:
        kw = dict(mode=2)
    cfg = TConfig(k=k, hash_num=3, threads=4, **kw)
    want = native_repair.polish_contig_native(tf, rep, cfg, "c", draft)
    seen = spy_on_the_engine(monkeypatch)
    for engine in ("pipelined", "native"):
        pol = TPolisher(tf, rep, cfg, chunk=CHUNK, device="cpu", engine=engine,
                        site_rows=True, cand_masks=True)
        assert not pol._polish_probes_eligible()
        assert render(twriters, pol.polish_contig("c", draft)) == render(twriters, want)
    assert seen and all(c is None and r is None for _, c, r in seen)


def test_engine_choice():
    """auto means pipelined; every engine of the JAX package is taken and
    an unknown one raises; the defaults measured on the card: rows on in
    SNV mode, off in polish mode, masks off, the batched site fixer on."""
    f = tbloom.BlockedKmerBloomFilter.zeros(1 << 12, 3, 25)
    cfg = TConfig(k=25, hash_num=3)
    assert TPolisher(f, device="cpu").engine == "pipelined"
    for engine in ("pipelined", "native", "wavefront", "sequential"):
        pol = TPolisher(f, device="cpu", engine=engine)
        assert pol.engine == engine and pol.oracle.fast is True
    assert TPolisher(f, device="cpu", fast_sites=False).oracle.fast is False
    with pytest.raises(ValueError, match="engine"):
        TPolisher(f, device="cpu", engine="fast")
    pol = TPolisher(f, None, cfg, device="cpu")
    assert (pol.site_rows, pol.cand_masks) == (False, False)
    snv = TPolisher(f, None, TConfig(k=25, hash_num=3, snv=True), device="cpu")
    assert snv.site_rows is True
    flipped = TPolisher(f, None, cfg, device="cpu", site_rows=True, cand_masks=True)
    assert (flipped.site_rows, flipped.cand_masks) == (True, True)
