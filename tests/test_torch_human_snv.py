"""The benchmark's human SNV deployment at -t 8 (``human_k55_t8`` under the
``snv`` traffic) cut to a CPU test's size as the benchmark's own tests cut
``human_k55.snv``: a 40 kbp reference slice with a 300 bp N run, a 256 KiB
blocked filter at the cell's fill, ``-t`` kept at 8.  The port's segmented
SNV repair with the device's site rows, in more than one segment, writes
the same ``_changes.tsv`` and ``_variants.vcf`` bytes as the benchmark's
plain reference (torch and numpy, nothing of the port) on whole contigs,
and as the port's own ``-t 1`` run, on two seeds."""

from __future__ import annotations

import dataclasses
import io

import pytest

from benchmark import harness
from benchmark.kinds import engine as kind
from benchmark.reference import engine as ref_engine


def tiny_spec() -> dict:
    s = harness.spec_of("human_k55_t8", "snv", {"end_to_end": [], "per_layer": []})
    cfg, traffic = s["config"], s["traffic"]
    traffic["pool"] = 2
    cfg.update(contig_bp=[40000], filter_bytes=1 << 18, filter_kmers=150000,
               n_run={"at": 0.4, "bp": 300})
    traffic["check"].update(stretches=4, width=3000)
    return s


def _outputs(pol, entry, snv: bool) -> tuple:
    from ntedit_tpu_torch.io import writers

    sinks = io.StringIO(), io.StringIO(), io.StringIO()
    for res in pol.polish(iter(entry)):
        writers.write_contig(res, *sinks, None, snv=snv)
    return tuple(s.getvalue() for s in sinks)


@pytest.mark.parametrize("seed", [2**31 + 11, 7])
def test_segmented_snv_repair_at_t8_equals_reference_and_t1(seed):
    from ntedit_tpu_torch.core import bloom
    from ntedit_tpu_torch.engine.polish import Polisher
    from ntedit_tpu_torch.utils import profiling

    s = tiny_spec()
    cfg, traffic = s["config"], s["traffic"]
    assert cfg["engine"]["t"] == 8 and traffic["mode"] == "snv"
    pool = kind.make_pool(cfg, traffic, seed, "cpu")
    assert 0.17 < pool.stats["filter_occupancy"] < 0.21  # the cell's 19.1%
    ecfg = kind.engine_config(cfg, traffic)
    host_bf = bloom.BlockedKmerBloomFilter(pool.words, cfg["hash_num"], cfg["k"])
    t8 = Polisher(host_bf, None, ecfg, device="cpu")
    t1 = Polisher(host_bf, None, dataclasses.replace(ecfg, threads=1), device="cpu")
    assert t8.site_rows and t8._snv_fast_eligible()
    rcfg = ref_engine.engine_config(cfg["k"], cfg["hash_num"], cfg["engine"], True)
    filt = ref_engine.HostFilter(pool.words, cfg["hash_num"])
    for entry in pool.entries:
        with profiling.recording() as rec:
            got = _outputs(t8, entry, True)
        counters = rec.counters
        assert counters["engine.segments"] >= 2  # the threaded path, not one whole call
        assert counters.get("engine.segment_fallbacks", 0) == 0  # no bucket overflowed
        assert counters["engine.site_rows"] == counters["engine.snv_candidates"] > 0
        want = ["", "", ""]
        for hdr, seq in entry:
            for i, text in enumerate(ref_engine.run(hdr, seq.tobytes(), filt, rcfg)):
                want[i] += text
        assert got[1:] == tuple(want[1:])
        assert got[2].count("\n") > 20  # records of the sample's SNVs
        assert "0/1" in got[2] and "1/1" in got[2]
        assert got == _outputs(t1, entry, True)
