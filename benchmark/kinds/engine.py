"""Traffic kind ``engine``: a closed loop of polish or SNV jobs through the
port's ``Polisher``, each job's results rendered by the port's writers.

This is the body of ``cli._run_engine`` without its per-job filter load: a
``Polisher`` is made once from the cell's filter, and each job calls
``Polisher.polish(contigs)`` and renders every ``ContigResult`` with
``writers.write_contig`` into memory.  The jobs draw their input from a
pool made in set-up, round robin from an entry drawn from the seed, so no
job repeats its neighbour.

Traffic parameters (``benchmark/traffic/<name>.json``): ``mode`` polish
or snv; ``input`` draft (the config's truth with seeded errors, one pool
entry a draft), reference (one pool entry a reference slice, whose
sample's SNVs the filter holds) or sample_draft (the sample's sequence of
such a slice with the config's errors, cut into the ``contigs`` lengths);
``pool``; ``passes``, the work modules
of ``benchmark/work/`` the job's device work is counted by; ``check``,
how many stretches of how many bases the reference compares.
"""

from __future__ import annotations

import dataclasses
import io
import time
from statistics import NormalDist
from typing import Callable, Optional

import numpy as np
import torch

from benchmark import check, inputs
from benchmark.reference import engine as ref_engine

PEAK_BYTES_PER_S = 3.35e12  # H100 SXM HBM3, NVIDIA's data sheet


@dataclasses.dataclass
class Pool:
    entries: list  # each: [(header, seq np.uint8)]
    words: np.ndarray  # the filter's words, uint32, on the host
    table: Optional[torch.Tensor]  # the same words (int32) on the device, until freed
    stats: dict


def _contig_names(cfg: dict) -> list:
    base = cfg.get("contig_name", "contig")
    return [f"{base}_{i}" for i in range(len(cfg["contig_bp"]))]


def contig_lengths(total: int, spec: dict) -> list:
    """A fixed set of contig lengths summing to ``total``: ``count``
    log-normal quantiles of shape ``sigma``, then the ``short_bp`` ones."""
    n, sigma = spec["count"], spec["sigma"]
    z = np.array([NormalDist().inv_cdf((i + 0.5) / n) for i in range(n)])
    q = np.exp(sigma * z)
    long_total = total - sum(spec["short_bp"])
    lens = np.floor(q / q.sum() * long_total).astype(np.int64)
    lens[-1] += long_total - lens.sum()
    return [int(x) for x in lens] + list(spec["short_bp"])


def cut_contigs(draft: np.ndarray, spec: dict, rng, name: str) -> list:
    """The draft cut into contigs of ``contig_lengths``, in an order drawn
    from ``rng``; the last takes what the draft's indels add or remove."""
    lens = contig_lengths(len(draft), spec)
    order = rng.permutation(len(lens))
    out, at = [], 0
    for j, i in enumerate(order):
        end = len(draft) if j == len(order) - 1 else at + lens[i]
        out.append((f"{name}_c{j}", np.ascontiguousarray(draft[at:end])))
        at = end
    return out


def make_pool(cfg: dict, traffic: dict, seed: int, device) -> Pool:
    """The cell's inputs and filter, made from the seed."""
    k, hash_num = cfg["k"], cfg["hash_num"]
    fill = inputs.FilterFill(cfg["filter_bytes"], hash_num, k, device)
    names = _contig_names(cfg)
    entries = []
    real = 0
    if traffic["input"] == "draft":
        gen = inputs.generator(seed, 1, device)
        truths = [inputs.random_bases(L, gen, device) for L in cfg["contig_bp"]]
        for t in truths:
            real += fill.insert_sequence(t)
        host = [t.cpu().numpy() for t in truths]
        err = cfg["draft_errors"]
        for e in range(traffic["pool"]):
            rng = inputs.host_rng(seed, 100 + e)
            entries.append([(f"{n}_draft{e}", inputs.draft_with_errors(t, rng, **err))
                            for n, t in zip(names, host)])
    elif traffic["input"] in ("reference", "sample_draft"):
        sample = cfg["sample"]
        for e in range(traffic["pool"]):
            gen = inputs.generator(seed, 200 + e, device)
            contigs = []
            for n, L in zip(names, cfg["contig_bp"]):
                ref = inputs.random_bases(L, gen, device)
                gap = cfg.get("n_run")
                if gap:
                    a = int(L * gap["at"])
                    ref[a : a + gap["bp"]] = ord("N")
                hap_a, hap_b = inputs.snv_sample(ref, int(sample["snvs_per_bp"] * L),
                                                 sample["het_share"], gen)
                real += fill.insert_sequence(hap_a)
                fill.insert_sequence(hap_b)
                if traffic["input"] == "reference":
                    contigs.append((f"{n}_{e}", ref.cpu().numpy()))
                    continue
                rng = inputs.host_rng(seed, 400 + e)
                draft = inputs.draft_with_errors(hap_a.cpu().numpy(), rng, **cfg["draft_errors"])
                contigs += cut_contigs(draft, traffic["contigs"], rng, f"{n}_{e}")
            entries.append(contigs)
    else:
        raise ValueError(f"unknown input {traffic['input']!r}")
    stand_ins = max(0, cfg.get("filter_kmers", 0) - real)
    fill.insert_stand_ins(stand_ins, inputs.generator(seed, 3, device))
    occupancy = fill.occupancy()
    table = fill.pack()
    words = table.cpu().numpy().view(np.uint32)
    stats = {"stand_in_kmers": stand_ins, "sequence_kmers": real,
             "filter_occupancy": occupancy}
    return Pool(entries, words, table, stats)


def engine_config(cfg: dict, traffic: dict):
    """The port's EngineConfig, as ``cli._run_engine`` builds it."""
    from ntedit_tpu_torch.engine.config import EngineConfig

    e = cfg["engine"]
    return EngineConfig(
        k=cfg["k"], hash_num=cfg["hash_num"], min_contig_len=e["z"], max_insertions=e["i"],
        max_deletions=e["d"], missing_threshold=e["x"], edit_threshold=e["y"], jump=e["j"],
        snv=traffic["mode"] == "snv", threads=e["t"],
    ).validate()


class Cell:
    """One run's cell: the Polisher, the pool, the jobs."""

    def __init__(self, cfg: dict, traffic: dict, seed: int, device, work: dict,
                 fault: Optional[Callable] = None):
        from ntedit_tpu_torch.core import bloom
        from ntedit_tpu_torch.engine.polish import Polisher

        self.cfg, self.traffic, self.seed = cfg, traffic, seed
        self.snv = traffic["mode"] == "snv"
        t = time.perf_counter()
        self.pool = make_pool(cfg, traffic, seed, device)
        self.pool.stats["make_s"] = time.perf_counter() - t
        self.least_s = None
        if work:  # the traced run only: the roofline's counts, outside the window
            self.least_s = [self._least_s(work, entry) for entry in self.pool.entries]
        self.pool.table = None  # the program gets its own copy
        if torch.device(device).type == "cuda":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        self.ecfg = engine_config(cfg, traffic)
        host_bf = bloom.BlockedKmerBloomFilter(self.pool.words, cfg["hash_num"], cfg["k"])
        t = time.perf_counter()
        self.polisher = Polisher(host_bf, None, self.ecfg, device=device)
        self.pool.stats["polisher_s"] = time.perf_counter() - t
        self.fault = fault
        self.stats = self.pool.stats
        self.start = int(inputs.host_rng(seed, 4).integers(0, traffic["pool"]))
        self.bases = [sum(len(s) for _, s in entry if len(s) >= self.ecfg.min_contig_len)
                      for entry in self.pool.entries]

    def _least_s(self, work: dict, entry: list) -> float:
        """The least time the card needs for one job of ``entry``."""
        k, h = self.cfg["k"], self.cfg["hash_num"]
        ecfg = ref_engine.engine_config(k, h, self.cfg["engine"], self.snv)
        streamed, sectors = 0, []
        for _, seq in entry:
            if len(seq) < ecfg.min_contig_len:
                continue
            dev = torch.from_numpy(seq).to(self.pool.table.device)
            for needs in work.values():
                b, sec, _ops = needs(dev, self.pool.table, k, h, ecfg)
                streamed += b
                sectors.append(sec)
        needed = streamed + 32 * int(torch.unique(torch.cat(sectors)).numel()) if sectors else streamed
        return needed / PEAK_BYTES_PER_S

    def entry(self, job: int) -> int:
        return (self.start + job) % len(self.pool.entries)

    def job(self, job: int, spans) -> tuple:
        """Run one job; -> (pool entry, bases, outputs)."""
        from ntedit_tpu_torch.io import writers

        idx = self.entry(job)
        contigs = self.pool.entries[idx]
        sinks = io.StringIO(), io.StringIO(), io.StringIO()
        sinks[1].write(writers.changes_tsv_header(self.ecfg.k, self.ecfg.jump, False))
        sinks[2].write(writers.vcf_header(f"job{idx}.fa", file_date="20260101"))
        results = self.polisher.polish(iter(contigs))
        while True:
            with spans("wait"):
                res = next(results, None)
            if res is None:
                break
            if self.fault is not None:  # tests: the timed path broken underneath
                res = self.fault(res, contigs)
                if res is None:
                    continue
            with spans("render"):
                writers.write_contig(res, *sinks, None, snv=self.ecfg.snv)
        return idx, self.bases[idx], tuple(s.getvalue() for s in sinks)

    def close(self) -> None:
        """Free the program's state: the check runs after."""
        self.polisher = None
        if torch.cuda.is_available():
            torch.cuda.empty_cache()

    def check(self, done: list) -> dict:
        c = self.traffic["check"]
        k, h = self.cfg["k"], self.cfg["hash_num"]
        rcfg = ref_engine.engine_config(k, h, self.cfg["engine"], self.snv)
        filt = ref_engine.HostFilter(self.pool.words, h)
        pool = [[(hdr, seq.tobytes()) for hdr, seq in entry] for entry in self.pool.entries]
        rng = inputs.host_rng(self.seed, 5)
        return check.check_jobs(pool, done, rng, filt, rcfg, c["stretches"], c["width"])

