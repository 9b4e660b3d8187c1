"""The torch port's sharded polish (parallel/mesh.py::sharded_polish) in
one rank, on the CPU: byte-equal to the JAX package's sharded polish on its
virtual 8-device CPU mesh and to the port's single sequential polish (the
host-only full scan of the C++ engine, no gate hint), with a blocked, a
plain and a counting filter, in SNV mode (-s 1), and with
NTEDIT_TPU_CAND=1 (the candidate masks of the gates).
The sizes of tests/test_parallel.py: K = 25, 2^16 bits, 20 kbp contigs."""

import io

import numpy as np
import pytest

from ntedit_tpu.core import bloom as jbloom
from ntedit_tpu.core import nthash_ref as jref
from ntedit_tpu.engine.config import EngineConfig as JConfig
from ntedit_tpu.io import writers as jwriters
from ntedit_tpu.parallel import mesh as jmesh
from ntedit_tpu.utils import simulate
from ntedit_tpu_torch import convert
from ntedit_tpu_torch.engine import native_repair
from ntedit_tpu_torch.engine.config import EngineConfig as TConfig
from ntedit_tpu_torch.io import writers as twriters
from ntedit_tpu_torch.parallel import mesh as tmesh

K, H, NBITS = 25, 3, 1 << 16


def render(writers, result) -> tuple:
    sinks = io.StringIO(), io.StringIO(), io.StringIO()
    writers.write_contig(result, *sinks, {})
    return tuple(s.getvalue() for s in sinks)


def case(name):
    """(JAX host filter, its device array, the port's host filter, draft,
    config keywords, chunk)."""
    truth = simulate.random_genome(20_000, seed=60)
    draft, _ = simulate.inject_errors(truth, sub_rate=3e-3, ins_rate=1e-3, del_rate=1e-3,
                                      seed=61)
    draft = draft.copy()
    draft[7000:7003] = ord("N")
    draft[12000] = ord("Y")
    if name == "counting":
        fh, rh = jref.all_window_hashes(truth, K)
        ext = jref.extend_hashes_vec(jref.canonical(fh, rh), K, H)
        jf = jbloom.KmerCountingBloomFilter8.zeros(1 << 15, H, K)
        for _ in range(5):
            jf.insert_hashes(ext)
        draft, _ = simulate.inject_errors(truth, sub_rate=3e-3, seed=91)
        th, _ = convert.filter_from_numpy("counting", jf.counters, H, K, device="cpu")
        return jf, jf.counters, th, draft, dict(min_threshold=3), 2048
    if name == "snv":
        # a reference against a filter of it and a copy with variants
        variant = truth.copy()
        rng = np.random.default_rng(71)
        for pos in rng.integers(100, len(truth) - 100, size=12):
            variant[pos] = b"ACGT"[int(rng.integers(0, 4))]
        jf = jbloom.BlockedKmerBloomFilter.zeros(NBITS // 8, H, K)
        jf.insert_seq(truth)
        jf.insert_seq(variant)
        th, _ = convert.filter_from_numpy("blocked", jf.words, H, K, device="cpu")
        return jf, jf.words, th, truth, dict(snv=True), None
    if name == "plain":
        jf = jbloom.KmerBloomFilter.zeros(NBITS // 8, H, K)
        jf.insert_seq(truth)
        th, _ = convert.filter_from_numpy("plain", jf.data, H, K, device="cpu")
        return jf, jbloom._pack_words(jf.data), th, draft, {}, None
    jf = jbloom.BlockedKmerBloomFilter.zeros(NBITS // 4, H, K)  # blocked, cand
    jf.insert_seq(truth)
    th, _ = convert.filter_from_numpy("blocked", jf.words, H, K, device="cpu")
    return jf, jf.words, th, draft, {}, 2048 if name == "blocked" else None


@pytest.mark.parametrize("name", ["blocked", "plain", "counting", "snv", "cand"])
def test_sharded_polish_matches_jax_and_the_sequential_polish(name, monkeypatch):
    monkeypatch.setenv("NTEDIT_TPU_CAND", "1" if name == "cand" else "0")
    jf, arr, th, draft, kw, chunk = case(name)
    want = jmesh.sharded_polish(jmesh.make_mesh(8), "ctg", draft, jf, arr,
                                JConfig(k=K, hash_num=H, **kw), chunk=chunk)
    cfg = TConfig(k=K, hash_num=H, **kw)
    got = tmesh.sharded_polish(tmesh.make_mesh(device="cpu"), "ctg", draft, th, arr, cfg,
                               chunk=chunk)
    scan = native_repair.polish_contig_native(th, None, cfg, "ctg", draft)
    assert got.edited == scan.edited
    assert render(twriters, got) == render(jwriters, want) == render(twriters, scan)
    assert len(got.subs) >= 10


def test_the_cand_route_hands_the_engine_masks(monkeypatch):
    """With NTEDIT_TPU_CAND=1 the segmented repair gets masks parallel to
    the gates; without it, none."""
    jf, arr, th, draft, kw, _ = case("cand")
    seen = []
    real = native_repair.polish_contig_segmented

    def spy(*args, gate_cand=None, **kwargs):
        seen.append(gate_cand)
        return real(*args, gate_cand=gate_cand, **kwargs)

    monkeypatch.setattr(native_repair, "polish_contig_segmented", spy)
    cfg = TConfig(k=K, hash_num=H)
    m = tmesh.make_mesh(device="cpu")
    monkeypatch.setenv("NTEDIT_TPU_CAND", "1")
    with_masks = tmesh.sharded_polish(m, "ctg", draft, th, arr, cfg)
    assert len(seen) == 1 and seen[0] is not None and (seen[0] != 0xFF).any()
    monkeypatch.setenv("NTEDIT_TPU_CAND", "0")
    without = tmesh.sharded_polish(m, "ctg", draft, th, arr, cfg)
    assert len(seen) == 1  # the pipelined route
    assert render(twriters, with_masks) == render(twriters, without)
