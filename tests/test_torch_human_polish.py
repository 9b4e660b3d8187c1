"""The benchmark's human polish deployment at -t 8 (``human_polish_k55_t8``
under the ``polish_contigs`` traffic) cut to a CPU test's size as the
benchmark's own tests cut ``human_k55.polish``: a 40 kbp draft slice with a
300 bp N run in 5 contigs and a 60 bp one, a 256 KiB blocked filter at the
cell's fill, ``-t`` kept at 8.  The Polisher's default engine (the gate
stream into the pipelined repair) writes the same ``_edited.fa``,
``_changes.tsv`` and ``_variants.vcf`` bytes as the benchmark's plain
reference (torch and numpy, nothing of the port) on whole contigs, and as
the port's own ``-t 1`` run, on two seeds.

The pipelined repair counts each bucket it hands to its pool as one
``engine.segments``: a stream of gate groups apart by more than the polish
gap, together over the 16,384-gate budget, makes several."""

from __future__ import annotations

import dataclasses
import io

import numpy as np
import pytest

from benchmark import harness
from benchmark.kinds import engine as kind
from benchmark.reference import engine as ref_engine

BUCKET_BUDGET = 16384  # native_repair.polish_contig_pipelined's gates a bucket


def tiny_spec() -> dict:
    s = harness.spec_of("human_polish_k55_t8", "polish_contigs",
                        {"end_to_end": [], "per_layer": []})
    cfg, traffic = s["config"], s["traffic"]
    traffic["pool"] = 2
    cfg.update(contig_bp=[40000], filter_bytes=1 << 18, filter_kmers=150000,
               n_run={"at": 0.4, "bp": 300})
    traffic["check"].update(stretches=4, width=3000)
    traffic["contigs"] = {"count": 5, "sigma": 1.0, "short_bp": [60]}
    return s


def _outputs(pol, entry) -> tuple:
    from ntedit_tpu_torch.io import writers

    sinks = io.StringIO(), io.StringIO(), io.StringIO()
    for res in pol.polish(iter(entry)):
        writers.write_contig(res, *sinks, None, snv=False)
    return tuple(s.getvalue() for s in sinks)


@pytest.mark.parametrize("seed", [2**31 + 13, 5])
def test_pipelined_polish_at_t8_equals_reference_and_t1(seed):
    from ntedit_tpu_torch.core import bloom
    from ntedit_tpu_torch.engine.polish import Polisher
    from ntedit_tpu_torch.utils import profiling

    s = tiny_spec()
    cfg, traffic = s["config"], s["traffic"]
    assert cfg["engine"]["t"] == 8 and traffic["mode"] == "polish"
    pool = kind.make_pool(cfg, traffic, seed, "cpu")
    assert 0.17 < pool.stats["filter_occupancy"] < 0.21  # the cell's 19.1%
    ecfg = kind.engine_config(cfg, traffic)
    host_bf = bloom.BlockedKmerBloomFilter(pool.words, cfg["hash_num"], cfg["k"])
    t8 = Polisher(host_bf, None, ecfg, device="cpu")
    t1 = Polisher(host_bf, None, dataclasses.replace(ecfg, threads=1), device="cpu")
    assert t8.engine == "pipelined"
    rcfg = ref_engine.engine_config(cfg["k"], cfg["hash_num"], cfg["engine"], False)
    filt = ref_engine.HostFilter(pool.words, cfg["hash_num"])
    alts = []  # the changes rows' alternates, over the pool
    for entry in pool.entries:
        assert len(entry) == 6
        short = [hdr for hdr, seq in entry if len(seq) < ecfg.min_contig_len]
        assert len(short) == 1
        with profiling.recording() as rec:
            got = _outputs(t8, entry)
        counters = rec.counters
        assert counters["engine.segments"] >= len(entry) - len(short)
        assert counters.get("engine.segment_fallbacks", 0) == 0  # no bucket overflowed
        want = ["", "", ""]
        for hdr, seq in entry:
            if len(seq) >= ecfg.min_contig_len:
                for i, text in enumerate(ref_engine.run(hdr, seq.tobytes(), filt, rcfg)):
                    want[i] += text
        assert got == tuple(want)
        assert not any(f"{short[0]}\n" in text or f"{short[0]}\t" in text for text in got)
        alts += [line.split("\t")[3] for line in got[1].splitlines()]
        assert got == _outputs(t1, entry)
    # the pool's drafts hold ~4 indels of each kind: the repair's indel trials ran
    assert any(a.startswith("+") for a in alts) and any(a.startswith("-") for a in alts)


def test_pipelined_repair_counts_one_segment_for_each_bucket():
    """Gate groups 400 heads apart, more than the polish gap (174 at k 25),
    7 groups of 39,000 gates in all, streamed in chunks of 4,096 heads: the
    repair hands its pool a bucket at the first group end that fills the
    16,384-gate budget and one with the rest, 3 buckets, each one native
    call (``engine.repair``) and one ``engine.segments``; the output equals
    the whole-contig engine on the same gates."""
    from ntedit_tpu_torch.core import bloom
    from ntedit_tpu_torch.engine import native_repair
    from ntedit_tpu_torch.engine.config import EngineConfig
    from ntedit_tpu_torch.io import writers
    from ntedit_tpu_torch.utils import profiling, simulate

    k, space = 25, 400
    cfg = EngineConfig(k=k, hash_num=3, max_insertions=4, max_deletions=5).validate()
    gap, _ = native_repair._gap_margin(cfg)
    assert space > gap == 174
    sizes = [3000, 7000, 9000, 2000, 12000, 5000, 1000]
    starts = space + np.cumsum([0] + [n + space for n in sizes[:-1]])
    gates = np.concatenate([np.arange(a, a + n) for a, n in zip(starts, sizes)])
    truth = simulate.random_genome(int(gates[-1]) + k + space, seed=31)
    bf = bloom.BlockedKmerBloomFilter.zeros(1 << 16, 3, k)
    bf.insert_seq(truth)
    draft = truth.copy()  # substitutions well inside each group: its heads are gates
    for a, n in zip(starts, sizes):
        for p in range(a + 2 * k, a + n - 4 * k, 500):
            draft[p] = ord("A") if draft[p] != ord("A") else ord("C")
    buckets, acc = 0, 0
    for n in sizes:  # the budget's rule, group by group
        acc += n
        if acc >= BUCKET_BUDGET:
            buckets, acc = buckets + 1, 0
    buckets += acc > 0
    assert buckets == 3

    def feed(chunk=4096):
        n = len(draft) - k + 1
        for lo in range(0, n, chunk):
            hi = min(lo + chunk, n)
            yield hi, gates[(gates >= lo) & (gates < hi)]

    with profiling.recording() as rec:
        got = native_repair.polish_contig_pipelined(bf, None, cfg, "c", draft, feed(), threads=8)
    whole = native_repair.polish_contig_native(bf, None, cfg, "c", draft, gate_hint=gates)
    repairs = [s for s in rec.spans if s.name == "engine.repair"]
    assert rec.counters["engine.segments"] == len(repairs) == buckets
    assert rec.counters["engine.gates"] == len(gates)
    assert "engine.segment_fallbacks" not in rec.counters
    assert len(whole.subs) > 50

    def render(res):
        sinks = io.StringIO(), io.StringIO(), io.StringIO()
        writers.write_contig(res, *sinks, None, snv=False)
        return tuple(s.getvalue() for s in sinks)

    assert got.edited == whole.edited and got.subs == whole.subs
    assert render(got) == render(whole)
