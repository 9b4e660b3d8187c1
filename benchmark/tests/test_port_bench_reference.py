"""The benchmark's plain reference (frozen copies, imports nothing of the
port) gives the same three outputs as ``ntedit_tpu_torch`` on the CPU, at
tiny sizes, in polish and in SNV mode, over whole contigs and over the
stretches the check compares."""

from __future__ import annotations

import io

import numpy as np
import pytest
import torch

from benchmark import check, inputs
from benchmark.kinds import engine as kind
from benchmark.reference import engine as ref_engine
from benchmark.tests import tiny


def _port_outputs(pool, cfg, traffic, entry):
    from ntedit_tpu_torch.core import bloom
    from ntedit_tpu_torch.engine.polish import Polisher
    from ntedit_tpu_torch.io import writers

    ecfg = kind.engine_config(cfg, traffic)
    pol = Polisher(bloom.BlockedKmerBloomFilter(pool.words, cfg["hash_num"], cfg["k"]), None,
                   ecfg, device="cpu")
    sinks = io.StringIO(), io.StringIO(), io.StringIO()
    for res in pol.polish(iter(entry)):
        writers.write_contig(res, *sinks, None, snv=ecfg.snv)
    return tuple(s.getvalue() for s in sinks)


@pytest.mark.parametrize("cell", tiny.ENGINE)
def test_reference_equals_port_on_whole_contigs(cell):
    s = tiny.spec(cell)
    cfg, traffic = s["config"], s["traffic"]
    pool = kind.make_pool(cfg, traffic, 2**31 + 11, "cpu")
    rcfg = ref_engine.engine_config(cfg["k"], cfg["hash_num"], cfg["engine"], traffic["mode"] == "snv")
    filt = ref_engine.HostFilter(pool.words, cfg["hash_num"])
    for entry in pool.entries:
        port = _port_outputs(pool, cfg, traffic, entry)
        want = ["", "", ""]
        for hdr, seq in entry:
            if len(seq) < rcfg.min_contig_len:
                continue
            for i, text in enumerate(ref_engine.run(hdr, seq.tobytes(), filt, rcfg)):
                want[i] += text
        assert port == tuple(want)
        assert port[1].count("\n") > 5  # rows to compare


@pytest.mark.parametrize("cell", tiny.ENGINE)
def test_stretches_agree_with_port(cell):
    """Every stretch the check picks reads no difference on the port's
    own outputs, and the stretches hold rows."""
    s = tiny.spec(cell)
    cfg, traffic = s["config"], s["traffic"]
    pool = kind.make_pool(cfg, traffic, 5, "cpu")
    done = [(i, _port_outputs(pool, cfg, traffic, e)) for i, e in enumerate(pool.entries)]
    rcfg = ref_engine.engine_config(cfg["k"], cfg["hash_num"], cfg["engine"], traffic["mode"] == "snv")
    filt = ref_engine.HostFilter(pool.words, cfg["hash_num"])
    raw = [[(h, q.tobytes()) for h, q in e] for e in pool.entries]
    compared, on = check.check_jobs(raw, done, inputs.host_rng(5, 5), filt, rcfg, 6, 4000)
    assert all(v == 0 for v in compared.values()), compared
    assert on["stretches"] == 6 and on["rows"] > 0


def test_pick_stretch_skips_records():
    rng = np.random.default_rng(0)
    positions = list(range(0, 10000, 50))  # a row every 50 bases
    for _ in range(20):
        st = check.pick_stretch(20000, positions, rng, 25, 5, 1000)
        q0, c0, e, b = st
        assert not [p for p in positions if q0 <= p < c0]
        assert c0 - q0 == 25 + 5 + 8 and e <= b <= 20000


def test_reference_dense_passes_match_the_spec():
    """The reference's torch window hashes equal the numpy spec's."""
    from benchmark.reference import device, nthash_ref

    seq = np.frombuffer(b"ACGTTGCAnACGGTCAGTRACGTACGATCGATCGGGTACCA", dtype=np.uint8)
    for k in (1, 5, 11):
        fh, rh = device.window_hashes(torch.from_numpy(seq.copy()), k)
        wf, wr = nthash_ref.all_window_hashes(seq, k)
        assert np.array_equal(fh.numpy().view(np.uint64), wf)
        assert np.array_equal(rh.numpy().view(np.uint64), wr)


def test_reference_histogram_equals_port_when_sampling():
    """The reference's histogram against the port's, exact and sampled."""
    from ntedit_tpu_torch.core import bfbuild

    from benchmark.kinds import reads as reads_kind
    from benchmark.reference import build as ref_build

    gen = inputs.generator(9, 1, "cpu")
    truth = inputs.random_bases(20000, gen, "cpu")
    reads = reads_kind.make_reads(truth, {"read_bp": 100, "fragment_bp": 300, "kmers": 300000,
                                          "sub_rate": 0.01}, 25, gen)
    flat = reads.reshape(-1, 100)
    can = ref_build.read_hashes(flat, 25)
    for budget in (1 << 26, 1 << 14, 1 << 11):
        f1, f0, spec = ref_build.histogram(can, sample_budget=budget)
        sep = torch.cat([flat, torch.zeros(flat.shape[0], 1, dtype=torch.uint8)], 1).reshape(-1)
        port = bfbuild.histogram_of([bfbuild.build_kernel.valid_hashes_plain(sep, sep.numel() - 24, 25)],
                                    25, sample_budget=budget)
        assert (f1, f0) == (port.f1, port.f0)
        assert np.array_equal(spec, port.spectrum)
