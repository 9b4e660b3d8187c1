"""The plain reference run over one stretch of a contig: the gate hint (or
the SNV candidate heads) from ``device.py``, the Oracle's scan over it,
and the three outputs from the writers, all frozen copies that import
nothing of the port.  The filter is the benchmark's own words."""

from __future__ import annotations

import io

import numpy as np
import torch

from benchmark.reference import device, writers
from benchmark.reference.config import EngineConfig
from benchmark.reference.oracle import Oracle


class HostFilter:
    """The blocked layout over host words (uint32), as the Oracle probes
    it: only the canonical hash (column 0 of the extended hashes) is read.
    ``probe_bits`` < hash_num probes fewer of the k-mer's bits: the
    control's broken guarantee."""

    def __init__(self, words: np.ndarray, hash_num: int, probe_bits: int = 0):
        self.words = words
        self.probe_bits = probe_bits or hash_num
        self.table = torch.from_numpy(words.view(np.int32))

    def contains_base(self, base: np.ndarray) -> np.ndarray:
        nw = self.words.size
        wbits = nw.bit_length() - 1
        widx = (base & np.uint64(nw - 1)).astype(np.int64)
        mask = np.zeros(len(base), dtype=np.uint32)
        for j in range(self.probe_bits):
            off = ((base >> np.uint64(wbits + 5 * j)) & np.uint64(31)).astype(np.uint32)
            mask |= np.uint32(1) << off
        return (self.words[widx] & mask) == mask

    def contains_hashes(self, hashes: np.ndarray) -> np.ndarray:
        h = np.asarray(hashes, dtype=np.uint64)
        return self.contains_base(h[..., 0].reshape(-1)).reshape(h.shape[:-1])


def engine_config(k: int, hash_num: int, engine: dict, snv: bool) -> EngineConfig:
    """The command line's clamps and defaults (``cli._run_engine``)."""
    return EngineConfig(
        k=k, hash_num=hash_num, min_contig_len=engine["z"], max_insertions=engine["i"],
        max_deletions=engine["d"], missing_threshold=engine["x"], edit_threshold=engine["y"],
        jump=engine["j"], snv=snv, threads=1,
    ).validate()


def hint(seq: bytes, filt: HostFilter, cfg: EngineConfig) -> np.ndarray:
    s = torch.from_numpy(np.frombuffer(seq, dtype=np.uint8).copy())
    pass_ = device.snv_candidate_heads if cfg.snv else device.gate_heads
    return pass_(s, filt.table, cfg.k, filt.probe_bits).numpy()


def run(header: str, seq: bytes, filt: HostFilter, cfg: EngineConfig) -> tuple:
    """-> (edited FASTA record, changes rows, variant rows) as text."""
    res = Oracle(filt, None, cfg, fast=True).polish_contig(header, seq, gate_hint=hint(seq, filt, cfg))
    sinks = io.StringIO(), io.StringIO(), io.StringIO()
    writers.write_contig(res, *sinks, None, snv=cfg.snv)
    return tuple(s.getvalue() for s in sinks)
