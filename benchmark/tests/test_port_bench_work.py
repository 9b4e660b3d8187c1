"""The roofline's counts (``benchmark/work/``) follow from the inputs
alone: the same inputs give the same count whichever path the port takes
(the binned and the unbinned SNV candidate pass give one count), and the
site rows' verify windows are the windows of the substituted bytes."""

from __future__ import annotations

import numpy as np
import torch

from benchmark import harness, inputs
from benchmark.kinds import engine as kind
from benchmark.reference import device as rd
from benchmark.reference import engine as ref_engine
from benchmark.tests import tiny


def _pool(cell, seed=21):
    s = tiny.spec(cell)
    return s, kind.make_pool(s["config"], s["traffic"], seed, "cpu")


def test_candidate_rows_match_both_port_passes():
    from ntedit_tpu_torch.core import bloom
    from ntedit_tpu_torch.engine import flag
    from ntedit_tpu_torch.ops import gate_kernel, snv_kernel

    s, pool = _pool("human_k55.snv")
    cfg = s["config"]
    seq = pool.entries[0][0][1]
    table = torch.from_numpy(pool.words.view(np.int32))
    rcfg = ref_engine.engine_config(cfg["k"], 3, cfg["engine"], True)
    streamed, _, _ = harness.load_module("work", "snv_site_rows").needs(
        torch.from_numpy(seq), table, cfg["k"], 3, rcfg)
    rows = streamed // 8
    df = bloom.DeviceFilter.from_host(bloom.BlockedKmerBloomFilter(pool.words, 3, cfg["k"]), "cpu")
    n = len(seq) - cfg["k"] + 1
    dev = torch.zeros(gate_kernel.padded_len(n), dtype=torch.uint8)
    dev[: len(seq)] = torch.from_numpy(seq)
    assert snv_kernel.binned(df, n)
    binned = flag.positions_on_device(flag.snv_candidate_words(dev, n, df)).numel()
    plain = flag.positions_on_device(snv_kernel.snv_cand_words_plain(dev, n, df)).numel()
    assert rows == binned == plain > 0


def test_counts_repeat_and_read_only_inputs():
    for cell in tiny.ENGINE:
        s, pool = _pool(cell)
        cfg, traffic = s["config"], s["traffic"]
        table = torch.from_numpy(pool.words.view(np.int32))
        rcfg = ref_engine.engine_config(cfg["k"], 3, cfg["engine"], traffic["mode"] == "snv")
        seq = torch.from_numpy(pool.entries[0][0][1])
        for p in traffic["passes"]:
            needs = harness.load_module("work", p).needs
            a, b = needs(seq, table, cfg["k"], 3, rcfg), needs(seq.clone(), table.clone(), cfg["k"], 3, rcfg)
            assert a[0] == b[0] > 0 and torch.equal(a[1], b[1]) and a[1].numel() > 0


def test_gate_sectors_are_the_distinct_sectors_of_every_valid_window():
    s, pool = _pool("ecoli_k25.polish")
    k = s["config"]["k"]
    seq = pool.entries[0][0][1][:5000]
    from benchmark.reference import nthash_ref

    fh, rh = nthash_ref.all_window_hashes(seq, k)
    can = np.minimum(fh, rh)
    words = pool.words.size
    want = np.unique((can & np.uint64(words - 1)).astype(np.int64) >> 3)
    streamed, sectors, _ = harness.load_module("work", "gate").needs(
        torch.from_numpy(seq), torch.from_numpy(pool.words.view(np.int32)), k, 3, None)
    assert np.array_equal(sectors.numpy(), want)
    assert streamed == len(seq) + (len(seq) - k + 1 + 7) // 8


def test_verify_window_hash_is_the_substituted_windows_hash():
    k = 11
    seq = inputs.random_bases(200, inputs.generator(1, 0, "cpu"), "cpu")
    fh, rh = rd.window_hashes(seq, k)
    ftab, rtab = rd._rotated_tables(k, "cpu")
    h = 50
    p = h + k - 1
    for kk in range(0, k - 1):
        i = k - 2 - kk
        w = h + 1 + kk
        for b in b"ACGT":
            sub = seq.clone()
            sub[p] = b
            wf, wr = rd.window_hashes(sub[w : w + k], k)
            f = fh[w] ^ ftab[i * 256 + seq[p].long()] ^ ftab[i * 256 + b]
            r = rh[w] ^ rtab[i * 256 + seq[p].long()] ^ rtab[i * 256 + b]
            assert int(f) == int(wf[0]) and int(r) == int(wr[0])
