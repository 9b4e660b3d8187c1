"""The torch port's Polisher (on the CPU) against the JAX package's
Polisher with the pipelined engine: equal substitution records and equal
output bytes, each rendered by its own package's writers, for all three
filter layouts, -t 1 and -t 4, -m 0 and -m 1, -a 1 and a reject filter;
and in SNV mode, for the runs whose candidates the device computes (with
and without site rows) and for those that go through the gate pass."""

import io

import numpy as np
import pytest

from ntedit_tpu.core import bloom as jbloom
from ntedit_tpu.core import nthash_ref as ref
from ntedit_tpu.engine.config import EngineConfig as JConfig
from ntedit_tpu.engine.polish import Polisher as JPolisher
from ntedit_tpu.io import writers as jwriters
from ntedit_tpu.utils import simulate
from ntedit_tpu_torch import convert
from ntedit_tpu_torch.engine.config import EngineConfig as TConfig
from ntedit_tpu_torch.engine.polish import Polisher as TPolisher
from ntedit_tpu_torch.io import writers as twriters

CHUNK = 1 << 15
K = 25


def render(writers, result):
    d, r, v = io.StringIO(), io.StringIO(), io.StringIO()
    writers.write_contig(result, d, r, v, {})
    return d.getvalue(), r.getvalue(), v.getvalue()


def sub_fields(res):
    return [(s.pos, s.draft_char, s.sub_base, s.num_support, s.altbase1, s.altsupp1,
             s.altbase2, s.altsupp2, s.altbase3, s.altsupp3) for s in res.subs]


def workload(length, seed):
    truth = simulate.random_genome(length, seed=seed)
    draft, _ = simulate.inject_errors(truth, sub_rate=2e-3, ins_rate=3e-4, del_rate=3e-4,
                                      seed=seed + 1)
    draft = draft.copy()
    rng = np.random.default_rng(seed + 2)
    draft[rng.integers(0, len(draft), size=8)] = ord("R")
    draft[len(draft) // 3 : len(draft) // 3 + 6] = ord("N")
    draft[len(draft) // 2 : len(draft) // 2 + 300] |= 0x20
    return truth, draft


def make_filter(layout, truth):
    if layout == "blocked":
        f = jbloom.BlockedKmerBloomFilter.zeros(1 << 16, 3, K)
        f.insert_seq(truth)
        return f, f.words, 3
    if layout == "plain":
        f = jbloom.KmerBloomFilter.zeros(200_003, 3, K)
        f.insert_seq(truth)
        return f, f.data, 3
    f = jbloom.KmerCountingBloomFilter8.zeros(600_011, 3, K)
    fh, rh = ref.all_window_hashes(truth, K)
    hashes = ref.extend_hashes_vec(ref.canonical(fh, rh), K, 3)
    for _ in range(3):
        f.insert_hashes(hashes)
    f.insert_hashes(hashes[len(hashes) // 3 : len(hashes) // 2])  # counts above -q
    return f, f.counters, 3


def pair(layout, truth, reject=False, site_rows=True, **cfg_kw):
    jf, arr, h = make_filter(layout, truth)
    tf, _ = convert.filter_from_numpy(layout, arr, h, K, device="cpu")
    jrep = trep = None
    if reject:  # repeat k-mers: a stretch of the truth
        jrep = jbloom.KmerBloomFilter.zeros(20_011, 3, K)
        jrep.insert_seq(truth[2000:6000])
        trep, _ = convert.filter_from_numpy("plain", jrep.data, 3, K, device="cpu")
    jpol = JPolisher(jf, jrep, JConfig(k=K, hash_num=h, **cfg_kw), chunk=CHUNK,
                     engine="pipelined")
    tpol = TPolisher(tf, trep, TConfig(k=K, hash_num=h, **cfg_kw), chunk=CHUNK, device="cpu",
                     site_rows=site_rows)
    return jpol, tpol


CASES = [
    ("blocked", dict(threads=1, mode=0), False),
    ("blocked", dict(threads=4, mode=1), False),
    ("plain", dict(threads=4, mode=0), True),
    ("plain", dict(threads=1, mode=0, mask=True), False),
    ("counting", dict(threads=4, mode=0, min_threshold=2, max_threshold=254), False),
    ("counting", dict(threads=1, mode=1, max_threshold=4), False),
]


@pytest.mark.parametrize("layout,cfg_kw,reject", CASES)
def test_polish_contig_matches_jax(layout, cfg_kw, reject):
    truth, draft = workload(50_000, seed=len(layout) + 3 * cfg_kw["threads"])
    jpol, tpol = pair(layout, truth, reject, **cfg_kw)
    want = jpol.polish_contig("ctg one", draft)
    got = tpol.polish_contig("ctg one", draft)
    assert sub_fields(got) == sub_fields(want)
    assert got.edited == want.edited
    assert render(twriters, got) == render(jwriters, want)
    assert len(got.subs) > 0


RATIO = dict(use_ratio=True, missing_ratio=0.5, edit_ratio=0.5)
SNV_CASES = [
    # the device computes the candidates: layout, config, reject filter, site rows
    ("blocked", dict(threads=1), False, True),
    ("blocked", dict(threads=1), False, False),
    ("blocked", dict(threads=4), False, True),
    ("blocked", dict(threads=4), False, False),
    ("plain", dict(threads=4), False, True),
    ("plain", dict(threads=1), False, False),
    ("blocked", dict(threads=4, **RATIO), False, True),
    ("plain", dict(threads=4, mode=1, jump=1), False, True),
    # not eligible: every valid head is hinted through the gate pass
    ("counting", dict(threads=4, min_threshold=2, max_threshold=254), False, True),
    ("plain", dict(threads=4), True, True),
    ("blocked", dict(threads=1, mode=2), False, True),
    ("blocked", dict(threads=4, mask=True), False, True),
]


@pytest.mark.parametrize("layout,cfg_kw,reject,site_rows", SNV_CASES)
def test_snv_contig_matches_jax(layout, cfg_kw, reject, site_rows):
    truth, draft = workload(50_000, seed=len(layout) + 3 * cfg_kw["threads"] + int(site_rows))
    jpol, tpol = pair(layout, truth, reject, site_rows, snv=True, **cfg_kw)
    eligible = layout != "counting" and not reject and cfg_kw.get("mode") != 2 \
        and not cfg_kw.get("mask")
    assert tpol._snv_fast_eligible() == jpol._snv_fast_eligible() == eligible
    want = jpol.polish_contig("ctg one", draft)
    got = tpol.polish_contig("ctg one", draft)
    assert sub_fields(got) == sub_fields(want)
    assert got.edited == want.edited
    assert render_snv(got, want)
    assert len(got.subs) > 20


def render_snv(got, want):
    out = []
    for writers, res in ((twriters, got), (jwriters, want)):
        sinks = io.StringIO(), io.StringIO(), io.StringIO()
        writers.write_contig(res, *sinks, {}, snv=True)
        out.append(tuple(s.getvalue() for s in sinks))
    return out[0] == out[1] and "\n" in out[0][2]


def test_snv_rows_reach_the_engine(monkeypatch):
    """With site rows on, the repair is handed rows parallel to its gates
    (and consumes them: the output equals the run without)."""
    from ntedit_tpu_torch.engine import native_repair

    truth, draft = workload(30_000, seed=91)
    seen = []
    real = native_repair._run_raw

    def spy(lib, contig, pristine, gates, *args, site_rows=None):
        seen.append(None if site_rows is None else (len(gates), site_rows.shape,
                                                    int((site_rows[:, 0] & 1).sum())))
        return real(lib, contig, pristine, gates, *args, site_rows=site_rows)

    monkeypatch.setattr(native_repair, "_run_raw", spy)
    results = []
    for rows in (True, False):
        seen.clear()
        _, tpol = pair("blocked", truth, site_rows=rows, snv=True, threads=4)
        results.append(tpol.polish_contig("c", draft))
        if rows:
            assert seen and all(s is not None and s[1] == (s[0], 6) for s in seen)
            assert sum(s[2] for s in seen) > 0
        else:
            assert seen and all(s is None for s in seen)
    assert sub_fields(results[0]) == sub_fields(results[1])
    assert results[0].edited == results[1].edited


@pytest.mark.parametrize("threads", [1, 4])
def test_snv_stream_matches_jax(threads):
    """polish() in SNV mode: an all-N contig, one shorter than k (longer
    than -z), one shorter than -z (dropped), results in input order."""
    truth, draft = workload(30_000, seed=60)
    contigs = [("c0 x", draft), ("allN", np.full(400, ord("N"), np.uint8)),
               ("short", truth[:20].copy()), ("c3", draft[5000:9000].copy())]
    jpol, tpol = pair("blocked", truth, snv=True, threads=threads, min_contig_len=25)
    want = list(jpol.polish(iter(contigs)))
    got = list(tpol.polish(iter(contigs)))
    assert [r.header for r in got] == [r.header for r in want] == ["c0 x", "allN", "c3"]
    for g, w in zip(got, want):
        assert sub_fields(g) == sub_fields(w)
        assert render_snv(g, w) or not g.subs
    assert not got[1].subs and got[1].edited == bytes(contigs[1][1])
    jpol, tpol = pair("blocked", truth, snv=True, threads=threads, min_contig_len=10)
    (w,), (g,) = list(jpol.polish(iter(contigs[2:3]))), list(tpol.polish(iter(contigs[2:3])))
    assert g.edited == w.edited == bytes(contigs[2][1]) and not g.subs and not w.subs


def test_polish_stream_matches_jax():
    """polish(): several contigs, one shorter than -z (dropped), two in
    flight with -t 4, results in input order."""
    contigs, truths = [], []
    for i, L in enumerate((30_000, 80, 22_000, 41_000)):
        t, d = workload(L, seed=50 + i) if L > 1000 else (None, simulate.random_genome(L, 9))
        contigs.append((f"c{i} x", d))
        if t is not None:
            truths.append(t)
    truth = np.concatenate(truths)
    for threads in (1, 4):
        jpol, tpol = pair("blocked", truth, threads=threads)
        want = list(jpol.polish(iter(contigs)))
        got = list(tpol.polish(iter(contigs)))
        assert [r.header for r in got] == [r.header for r in want] == ["c0 x", "c2 x", "c3 x"]
        for g, w in zip(got, want):
            assert sub_fields(g) == sub_fields(w)
            assert render(twriters, g) == render(jwriters, w)


def test_gate_positions_matches_jax():
    truth, draft = workload(40_000, seed=77)
    jpol, tpol = pair("plain", truth)
    np.testing.assert_array_equal(tpol.gate_positions(draft), jpol.gate_positions(draft))


def test_replay_when_the_stream_engine_fails(monkeypatch):
    """When the pipelined engine returns None, the collected gates replay
    through the whole-contig native engine: same result."""
    from ntedit_tpu_torch.engine import native_repair

    truth, draft = workload(30_000, seed=88)
    jpol, tpol = pair("blocked", truth, threads=4)
    want = jpol.polish_contig("c", draft)
    real = native_repair.polish_contig_pipelined

    def drained_then_none(*args, **kw):
        real(*args, **kw)
        return None

    monkeypatch.setattr(native_repair, "polish_contig_pipelined", drained_then_none)
    got = tpol.polish_contig("c", draft)
    assert render(twriters, got) == render(jwriters, want)


def test_not_ported_options_raise(monkeypatch, capsys):
    """What raised before the port took the Oracle now runs as in the JAX
    package: -v traces through the Oracle, and a failed native repair
    falls back to the wavefront engine, in polish and in SNV mode.  The
    repairs that cut at quiet gaps still refuse raw SNV gates."""
    from ntedit_tpu.engine import native_repair as jnative

    from ntedit_tpu_torch.engine import native_repair

    truth, draft = workload(6000, seed=5)
    f = jbloom.BlockedKmerBloomFilter.zeros(1 << 14, 3, K)
    f.insert_seq(truth)
    tf, _ = convert.filter_from_numpy("blocked", f.words, 3, K, device="cpu")
    verbose = TConfig(k=K, hash_num=3, verbose=True)
    # the scalar path traces each trial; sites the batched fixer takes print
    # nothing, in both packages
    got = TPolisher(tf, None, verbose, device="cpu", fast_sites=False).polish_contig("c", draft)
    traced = capsys.readouterr().out
    want = JPolisher(f, None, JConfig(k=K, hash_num=3, verbose=True),
                     fast_sites=False).polish_contig("c", draft)
    assert traced == capsys.readouterr().out and "check_present" in traced
    assert render(twriters, got) == render(jwriters, want)
    snv_cfg = TConfig(k=K, hash_num=3, snv=True)
    with pytest.raises(ValueError, match="quiet gaps"):
        native_repair.polish_contig_segmented(f, None, snv_cfg, "c", draft, np.arange(10))
    with pytest.raises(ValueError, match="quiet gaps"):
        native_repair.polish_contig_pipelined(f, None, snv_cfg, "c", draft, iter(()))
    for mod in (native_repair, jnative):
        for name in ("polish_contig_pipelined", "polish_contig_native",
                     "polish_contig_segmented"):  # with -t > 1 the replay tries it first
            monkeypatch.setattr(mod, name, lambda *a, **kw: None)
    for snv in (False, True):
        want = JPolisher(f, None, JConfig(k=K, hash_num=3, snv=snv)).polish_contig("c", draft)
        got = TPolisher(tf, None, TConfig(k=K, hash_num=3, snv=snv),
                        device="cpu").polish_contig("c", draft)
        assert sub_fields(got) == sub_fields(want) and len(got.subs) > 0
        assert (render_snv(got, want) if snv else render(twriters, got) == render(jwriters, want))
