"""The torch port's Oracle, batched site fixer and wavefront engine
(engine/oracle.py, sitefix.py, wavefront.py) and the Polisher paths that
reach them, on the CPU, against the JAX package on the same seeded
inputs: ``Polisher(engine="wavefront"|"sequential")`` with blocked, plain
and counting filters in polish and SNV mode, the outputs rendered by both
packages' writers; the fallback after a failed native repair in both
modes; a wavefront bail-out going to the sequential engine; ``-v`` stdout
through the Polisher and through the ``engine`` command line at -t 1 and
-t 2; and a selection of the JAX package's own Oracle, wavefront and site
fixer cases run through both packages."""

import io
import os

import numpy as np
import pytest
import torch

from ntedit_tpu.core import bloom as jbloom
from ntedit_tpu.core import nthash_ref as jref
from ntedit_tpu.engine import wavefront as jwave
from ntedit_tpu.engine.config import EngineConfig as JConfig
from ntedit_tpu.engine.oracle import Oracle as JOracle
from ntedit_tpu.engine.polish import Polisher as JPolisher
from ntedit_tpu.io import writers as jwriters
from ntedit_tpu.utils import simulate
from ntedit_tpu_torch import convert
from ntedit_tpu_torch.engine import wavefront as twave
from ntedit_tpu_torch.engine.config import EngineConfig as TConfig
from ntedit_tpu_torch.engine.oracle import Oracle as TOracle
from ntedit_tpu_torch.engine.polish import Polisher as TPolisher
from ntedit_tpu_torch.io import writers as twriters

K = 25
CHUNK = 1 << 15


@pytest.fixture(autouse=True)
def one_thread():
    """torch on one thread for the port's plain device passes: these tests
    run beside other test processes, where the passes' many small parallel
    ops would wait on threads the other processes hold."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


def render(writers, result, snv=False):
    sinks = io.StringIO(), io.StringIO(), io.StringIO()
    writers.write_contig(result, *sinks, {}, snv=snv)
    return tuple(s.getvalue() for s in sinks)


def sub_fields(res):
    return [(s.pos, s.draft_char, s.sub_base, s.num_support, s.altbase1, s.altsupp1,
             s.altbase2, s.altsupp2, s.altbase3, s.altsupp3) for s in res.subs]


def same(got, want, snv=False):
    assert sub_fields(got) == sub_fields(want)
    assert got.edited == want.edited
    assert render(twriters, got, snv) == render(jwriters, want, snv)


def port_filter(jf):
    """The port's host filter holding the JAX filter's bits."""
    if hasattr(jf, "counters"):
        kind, arr = "counting", jf.counters
    elif hasattr(jf, "words"):
        kind, arr = "blocked", jf.words
    else:
        kind, arr = "plain", jf.data
    return convert.filter_from_numpy(kind, arr, jf.hash_num, jf.k, device="cpu")[0]


def workload(length, seed, decorate=True):
    truth = simulate.random_genome(length, seed=seed)
    draft, _ = simulate.inject_errors(truth, sub_rate=2e-3, ins_rate=3e-4, del_rate=3e-4,
                                      seed=seed + 1)
    draft = draft.copy()
    if decorate:
        rng = np.random.default_rng(seed + 2)
        draft[rng.integers(0, len(draft), size=4)] = ord("R")
        draft[len(draft) // 3: len(draft) // 3 + 6] = ord("N")
        draft[len(draft) // 2: len(draft) // 2 + 200] |= 0x20
    return truth, draft


def make_filter(layout, truth):
    if layout == "blocked":
        f = jbloom.BlockedKmerBloomFilter.zeros(1 << 16, 3, K)
        f.insert_seq(truth)
        return f, {}
    if layout == "plain":
        f = jbloom.KmerBloomFilter.zeros(200_003, 3, K)
        f.insert_seq(truth)
        return f, {}
    f = jbloom.KmerCountingBloomFilter8.zeros(600_011, 3, K)
    fh, rh = jref.all_window_hashes(truth, K)
    hashes = jref.extend_hashes_vec(jref.canonical(fh, rh), K, 3)
    for _ in range(3):
        f.insert_hashes(hashes)
    return f, dict(min_threshold=2, max_threshold=254)


def polishers(jf, engine, **cfg_kw):
    cfg = dict(k=K, hash_num=jf.hash_num, **cfg_kw)
    jpol = JPolisher(jf, None, JConfig(**cfg), chunk=CHUNK, engine=engine)
    tpol = TPolisher(port_filter(jf), None, TConfig(**cfg), chunk=CHUNK, device="cpu",
                     engine=engine)
    return jpol, tpol


# ---------------------------------------------------------------------------
# the engines through the Polisher
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("snv", [False, True])
@pytest.mark.parametrize("layout", ["blocked", "plain", "counting"])
@pytest.mark.parametrize("engine", ["wavefront", "sequential"])
def test_engine_matches_jax(engine, layout, snv):
    """SNV mode scans every head in Python: its contigs are shorter."""
    truth, draft = workload(6000 if snv else 20_000, seed=3 + len(layout) + 7 * snv)
    jf, cfg_kw = make_filter(layout, truth)
    jpol, tpol = polishers(jf, engine, snv=snv, **cfg_kw)
    if engine == "sequential":  # the JAX Polisher takes it only without a device
        jpol.engine = "sequential"
    want = jpol.polish_contig("ctg one", draft)
    got = tpol.polish_contig("ctg one", draft)
    same(got, want, snv)
    assert len(got.subs) > 3


FALLBACK_CASES = [("blocked", False, 4), ("plain", False, 4), ("plain", True, 4),
                  ("counting", False, 1), ("counting", True, 1)]


@pytest.mark.parametrize("layout,snv,threads", FALLBACK_CASES)
def test_fallback_matches_jax(monkeypatch, layout, snv, threads):
    """Every native and segmented repair returns None: polish mode goes to
    the wavefront with the gate hint, SNV mode with the device's candidate
    heads when eligible (plain) and every head otherwise (counting)."""
    from ntedit_tpu.engine import native_repair as jnative

    from ntedit_tpu_torch.engine import native_repair

    for mod in (native_repair, jnative):
        for name in ("polish_contig_pipelined", "polish_contig_native",
                     "polish_contig_segmented"):
            monkeypatch.setattr(mod, name, lambda *a, **kw: None)
    heads = []
    real = twave.polish_contig_wavefront
    monkeypatch.setattr(twave, "polish_contig_wavefront",
                        lambda o, h, s, g, **kw: heads.append(len(g)) or real(o, h, s, g, **kw))
    truth, draft = workload(6000 if snv else 20_000, seed=40 + len(layout))
    jf, cfg_kw = make_filter(layout, truth)
    jpol, tpol = polishers(jf, "auto", snv=snv, threads=threads, **cfg_kw)
    same(tpol.polish_contig("c", draft), jpol.polish_contig("c", draft), snv)
    eligible = layout != "counting"
    assert tpol._snv_fast_eligible() == eligible
    assert len(heads) == 1
    if snv and not eligible:
        assert heads[0] == len(draft) - K + 1
    else:
        assert 0 < heads[0] < len(draft) // 4


@pytest.mark.parametrize("snv", [False, True])
def test_bailout_goes_to_the_sequential_engine(monkeypatch, snv):
    """The wavefront engine bails out (forced, after it has edited the
    shared Oracle): the sequential Oracle takes the contig anew, with the
    gate hint, and the result equals the JAX package's sequential engine."""
    calls = []
    real = twave.polish_contig_wavefront

    def bail(*args, **kw):
        real(*args, **kw)
        raise twave.WavefrontBailout("forced")

    monkeypatch.setattr(twave, "polish_contig_wavefront", bail)
    truth, draft = workload(6000, seed=70 + snv)
    jf, _ = make_filter("blocked", truth)
    jpol, tpol = polishers(jf, "wavefront", snv=snv)
    jpol.engine = "sequential"
    real_seq = tpol.oracle.polish_contig
    tpol.oracle.polish_contig = lambda h, s, gate_hint=None: calls.append(
        gate_hint) or real_seq(h, s, gate_hint=gate_hint)
    same(tpol.polish_contig("c", draft), jpol.polish_contig("c", draft), snv)
    assert len(calls) == 1 and calls[0] is not None
    np.testing.assert_array_equal(calls[0], jpol.gate_positions(draft))


# ---------------------------------------------------------------------------
# -v
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("threads", [1, 2])
def test_verbose_polish_matches_jax(capsys, threads):
    """-v through Polisher.polish: each contig's trace after the one before,
    whatever -t; with the scalar site path every trial prints."""
    contigs, truths = [], []
    for i, L in enumerate((5000, 3000)):
        t, d = workload(L, seed=90 + i, decorate=False)
        contigs.append((f"c{i} x", d))
        truths.append(t)
    jf, _ = make_filter("blocked", np.concatenate(truths))
    outs = []
    for pol_cls, cfg_cls, kw in ((JPolisher, JConfig, {}), (TPolisher, TConfig, {"device": "cpu"})):
        filt = jf if pol_cls is JPolisher else port_filter(jf)
        pol = pol_cls(filt, None, cfg_cls(k=K, hash_num=3, verbose=True, threads=threads),
                      fast_sites=False, **kw)
        writers = jwriters if pol_cls is JPolisher else twriters
        rendered = [render(writers, r) for r in pol.polish(iter(contigs))]
        outs.append((capsys.readouterr().out, rendered))
    assert outs[0] == outs[1]
    assert outs[0][0].count("check_present") > 10


def run_cli(module, d, argv):
    cwd = os.getcwd()
    os.chdir(d)
    try:
        module.main(argv)
    finally:
        os.chdir(cwd)


@pytest.mark.parametrize("threads", [1, 2])
def test_verbose_engine_cli_matches_jax(tmp_path, capsys, threads):
    """``engine -v 1``: the parameter block, each contig's header, the
    Oracle's trace and the three output files, as the JAX command line
    gives them (the run's timing line aside)."""
    from ntedit_tpu import cli as jcli

    from ntedit_tpu_torch import cli as tcli

    truths, drafts = [], []
    for i, L in enumerate((4000, 150, 2500)):
        if L > 1000:
            t, d = workload(L, seed=120 + i, decorate=False)
        else:
            t = simulate.random_genome(L, seed=120 + i)
            d = _mutate(t, (L // 2,))
        truths.append(t)
        drafts.append(d)
    jf, _ = make_filter("plain", np.concatenate(truths))
    got = {}
    for name, module, extra in (("jax", jcli, []), ("torch", tcli, ["--device", "cpu"])):
        d = tmp_path / name
        d.mkdir()
        jf.save(str(d / "f.bf"))
        with open(d / "draft.fa", "w") as f:
            for i, s in enumerate(drafts):
                f.write(f">contig{i} test\n{s.tobytes().decode()}\n")
        run_cli(module, d, ["engine", "-r", "f.bf", "-f", "draft.fa", "-b", "out", "-v", "1",
                            "-t", str(threads), "-z", "100", *extra])
        stdout = [l for l in capsys.readouterr().out.splitlines() if not l.startswith("engine: ")]
        files = [(d / f"out{s}").read_text() for s in ("_edited.fa", "_changes.tsv")]
        got[name] = stdout, files
    assert got["torch"] == got["jax"]
    stdout = got["torch"][0]
    assert " -v 1" in stdout and "contig1 test" in stdout and "contig2 test" in stdout


# ---------------------------------------------------------------------------
# the JAX package's own engine cases, through both packages
# ---------------------------------------------------------------------------

def _mutate(truth, positions):
    draft = truth.copy()
    for p in positions:
        draft[p] = ord("A") if truth[p] != ord("A") else ord("C")
    return draft


def _truth_filter(truth):
    return simulate.truth_bf(truth, K)


def case_workload(mode):
    def make():
        wl = simulate.make_workload(length=3000, k=K, seed=80)
        return wl.draft, wl.bf, None, dict(mode=mode)
    return make


def case_clustered(min_gap):
    def make():
        truth = simulate.random_genome(6000, seed=82 + min_gap)
        draft, _ = simulate.inject_errors(truth, sub_rate=6e-3, ins_rate=1.5e-3,
                                          del_rate=1.5e-3, min_gap=min_gap, seed=83 + min_gap)
        return draft, _truth_filter(truth), None, {}
    return make


def case_near_ends():
    truth = simulate.random_genome(900, seed=92)
    return _mutate(truth, (26, len(truth) - 26)), _truth_filter(truth), None, {}


def case_non_acgt():
    truth = simulate.random_genome(4000, seed=93)
    draft = _mutate(truth, (2500,))
    draft[1000:1015] = ord("N")
    draft[2000] = ord("R")
    return draft, _truth_filter(truth), None, {}


def case_lowercase():
    truth = simulate.random_genome(3000, seed=94)
    draft = truth.copy()
    draft[500:600] += 32
    draft[550] = ord("a") if truth[550] != ord("A") else ord("c")
    return draft, _truth_filter(truth), None, {}


def case_mask():
    truth = simulate.random_genome(2500, seed=95)
    draft = _mutate(truth, (1200,))
    bf = jbloom.KmerBloomFilter.zeros(1 << 14, 3, K)
    bf.insert_seq(truth[: 1160])
    bf.insert_seq(truth[1240:])
    return draft, bf, None, dict(mask=True)


def case_snv():
    truth = simulate.random_genome(1500, seed=96)
    bf = _truth_filter(truth)
    bf.insert_seq(_mutate(truth, (700,)))
    return truth, bf, None, dict(snv=True)


def case_cbf_and_reject():
    truth = simulate.random_genome(3000, seed=97)
    draft = _mutate(truth, (700, 1400, 2100))
    cbf = _counting_filter(truth)
    rep = jbloom.KmerBloomFilter.zeros(1 << 12, 3, K)
    rep.insert_seq(truth[1350:1460])
    return draft, cbf, rep, dict(min_threshold=2)


def case_ratio():
    truth = simulate.random_genome(4000, seed=98)
    draft, _ = simulate.inject_errors(truth, sub_rate=3e-3, ins_rate=1e-3, del_rate=1e-3,
                                      seed=99)
    return draft, _truth_filter(truth), None, dict(use_ratio=True, missing_ratio=0.5,
                                                   edit_ratio=0.5)


def case_iupac_blocked():
    truth = simulate.random_genome(3000, seed=101)
    draft = _mutate(truth, (800, 1700))
    draft[1200] = ord("Y")
    draft[2200:2204] = ord("N")
    bf = jbloom.BlockedKmerBloomFilter.zeros(1 << 14, 3, K)
    bf.insert_seq(truth)
    return draft, bf, None, {}


ENGINE_CASES = {
    "workload_m0": case_workload(0), "workload_m1": case_workload(1),
    "workload_m2": case_workload(2), "clustered_5": case_clustered(5),
    "clustered_30": case_clustered(30), "near_ends": case_near_ends,
    "non_acgt": case_non_acgt, "lowercase": case_lowercase, "mask": case_mask,
    "snv": case_snv, "cbf_and_reject": case_cbf_and_reject, "ratio": case_ratio,
    "iupac_blocked": case_iupac_blocked,
}


@pytest.mark.parametrize("engine", ["oracle", "sitefix", "wavefront"])
@pytest.mark.parametrize("case", sorted(ENGINE_CASES))
def test_engine_cases_match_jax(case, engine):
    """The scalar Oracle (test_oracle.py), the Oracle with the batched site
    fixer (test_sitefix.py) and the wavefront over every head with small
    evaluation chunks (test_wavefront.py): the port's result equals the JAX
    package's, a bail-out in one is a bail-out in the other."""
    draft, jf, jrep, cfg_kw = ENGINE_CASES[case]()
    cfg = dict(k=K, hash_num=jf.hash_num, **cfg_kw)
    trep = None if jrep is None else port_filter(jrep)
    fast = engine == "sitefix"
    jo = JOracle(jf, jrep, JConfig(**cfg), fast=fast)
    to = TOracle(port_filter(jf), trep, TConfig(**cfg), fast=fast)
    snv = cfg_kw.get("snv", False)
    if engine == "wavefront":
        heads = np.arange(max(0, len(draft) - K + 1))
        try:
            want = jwave.polish_contig_wavefront(jo, "ctg", bytes(draft), heads, eval_chunk=64)
        except jwave.WavefrontBailout:
            with pytest.raises(twave.WavefrontBailout):
                twave.polish_contig_wavefront(to, "ctg", bytes(draft), heads, eval_chunk=64)
            return
        got = twave.polish_contig_wavefront(to, "ctg", bytes(draft), heads, eval_chunk=64)
    else:
        want = jo.polish_contig("ctg", bytes(draft))
        got = to.polish_contig("ctg", bytes(draft))
    same(got, want, snv)


def _counting_filter(truth, times=4):
    cbf = jbloom.KmerCountingBloomFilter8.zeros(1 << 17, 3, K)
    fh, rh = jref.all_window_hashes(truth, K)
    hashes = jref.extend_hashes_vec(jref.canonical(fh, rh), K, 3)
    for _ in range(times):
        cbf.insert_hashes(hashes)
    return cbf


def test_verbose_oracle_trace_matches_jax(capsys):
    """The Oracle's -v trace of one substitution (test_oracle.py), with a
    counting filter's median coverage too."""
    truth = simulate.random_genome(2000, seed=70)
    draft = _mutate(truth, (1000,))
    outs = []
    for jf in (_truth_filter(truth), _counting_filter(truth)):
        for orc, filt, cfg_cls in ((JOracle, jf, JConfig), (TOracle, port_filter(jf), TConfig)):
            cfg = cfg_cls(k=K, hash_num=3, verbose=True)
            res = orc(filt, None, cfg).polish_contig("ctg", bytes(draft))
            outs.append((capsys.readouterr().out, sub_fields(res)))
    assert outs[0] == outs[1] and outs[2] == outs[3]
    assert "\t\tsub: " in outs[0][0] and "median_coverage" in outs[2][0]
