"""Traffic kind ``reads``: a closed loop of the whole user pipeline,
``polish --reads`` through the port's command line in-process: the reads
to a histogram, a read filter and a polished draft.

Set-up makes the config's truth genome on the card, and for each pool
entry a read set (paired reads of ``read_bp`` from fragments of
``fragment_bp``, both strands, substitutions at ``sub_rate``; as many
pairs as give ``kmers`` read k-mers) written as two gzip FASTQ files, and
a draft of the truth with the config's errors.  A job runs
``ntedit_tpu_torch.cli.main(["polish", ...])`` in a fresh directory under
the run's temporary directory, whose read files link to the entry's, and
reads back its histogram, filter and three outputs; the directory is
deleted after.  The reference works the histogram and the filter out
again from the reads (``reference/build.py``), compares them with the
files the build wrote, and compares the outputs on stretches with its own
filter (``check.py``).
"""

from __future__ import annotations

import contextlib
import gzip
import io
import os
import shutil
import tempfile
import time
from typing import Callable, Optional

import numpy as np
import torch

from benchmark import check, inputs
from benchmark.kinds import engine as engine_kind
from benchmark.reference import build as ref_build
from benchmark.reference import engine as ref_engine

COMPLEMENT = torch.zeros(256, dtype=torch.uint8)
for _a, _b in zip(b"ACGT", b"TGCA"):
    COMPLEMENT[_a] = _b


def make_reads(truth: torch.Tensor, spec: dict, k: int, gen: torch.Generator) -> torch.Tensor:
    """-> reads uint8 [2, pairs, read_bp] on truth's device: mate 1 from a
    fragment's start, mate 2 the reverse complement of its end."""
    L, frag = spec["read_bp"], spec["fragment_bp"]
    pairs = spec["kmers"] // (2 * (L - k + 1))
    dev = truth.device
    start = torch.randint(0, truth.numel() - frag + 1, (pairs, 1), generator=gen, device=dev)
    offs = torch.arange(L, device=dev)
    m1 = truth[start + offs]
    m2 = COMPLEMENT.to(dev)[truth[start + frag - 1 - offs].long()]
    reads = torch.stack([m1, m2])
    err = torch.rand(reads.shape, generator=gen, device=dev) < spec["sub_rate"]
    code = torch.zeros(256, dtype=torch.int64, device=dev)
    code[inputs.ACGT.to(dev).long()] = torch.arange(4, device=dev)
    shift = torch.randint(1, 4, reads.shape, generator=gen, device=dev)
    wrong = inputs.ACGT.to(dev)[(code[reads.long()] + shift) % 4]
    return torch.where(err, wrong, reads)


def fastq(reads: np.ndarray, mate: int) -> bytes:
    """FASTQ text of reads [n, L]: ``@r<7 digits>/<mate>``, the bases, ``+``,
    quality I."""
    n, L = reads.shape
    head = np.frombuffer(b"@r0000000/%d\n" % mate, dtype=np.uint8)
    rec = np.empty((n, len(head) + L + 3 + L + 1), dtype=np.uint8)
    rec[:, : len(head)] = head
    idx = np.arange(n)
    for p in range(7):
        rec[:, 8 - p] = 48 + (idx // 10**p) % 10
    o = len(head)
    rec[:, o : o + L] = reads
    rec[:, o + L : o + L + 3] = np.frombuffer(b"\n+\n", dtype=np.uint8)
    rec[:, o + L + 3 : o + 2 * L + 3] = ord("I")
    rec[:, -1] = ord("\n")
    return rec.tobytes()


def filter_words(data: bytes) -> tuple:
    """A blocked filter file -> (header text, words uint32)."""
    end = data.index(b"[HEADER_END]\n") + len(b"[HEADER_END]\n")
    return data[:end].decode(), np.frombuffer(data[end:], dtype=np.uint32)


class Cell:
    def __init__(self, cfg: dict, traffic: dict, seed: int, device, work: dict,
                 fault: Optional[Callable] = None):
        self.cfg, self.traffic, self.seed, self.device = cfg, traffic, seed, device
        self.fault = fault
        k = cfg["k"]
        t = time.perf_counter()
        gen = inputs.generator(seed, 1, device)
        truth = inputs.random_bases(cfg["contig_bp"][0], gen, device)
        host = truth.cpu().numpy()
        self.root = tempfile.mkdtemp(prefix="ntedit_bench_")
        self.entries = []
        for e in range(traffic["pool"]):
            d = os.path.join(self.root, f"pool{e}")
            os.makedirs(d)
            reads = make_reads(truth, traffic["reads"], k, inputs.generator(seed, 300 + e, device))
            host_reads = reads.cpu().numpy()
            files = []
            for mate in (1, 2):
                path = os.path.join(d, f"reads_{mate}.fq.gz")
                with open(path, "wb") as f:
                    f.write(gzip.compress(fastq(host_reads[mate - 1], mate), compresslevel=1, mtime=0))
                files.append(path)
            draft = inputs.draft_with_errors(host, inputs.host_rng(seed, 100 + e), **cfg["draft_errors"])
            name = f"{cfg.get('contig_name', 'contig')}_draft{e}"
            draft_path = os.path.join(d, "draft.fa")
            with open(draft_path, "wb") as f:
                f.write(b">" + name.encode() + b"\n" + draft.tobytes() + b"\n")
            self.entries.append({"files": files, "draft": draft_path, "reads": host_reads,
                                 "contigs": [(name, draft)], "read_bp": int(host_reads.size)})
        self.stats = {"make_s": time.perf_counter() - t, "read_pairs": int(host_reads.shape[1])}
        self.least_s = None
        if work:  # the traced run only: the roofline's counts, outside the window
            self.least_s = [self._least_s(work, e) for e in self.entries]
        if torch.device(device).type == "cuda":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        self.start = int(inputs.host_rng(seed, 4).integers(0, traffic["pool"]))

    def _least_s(self, work: dict, entry: dict) -> float:
        dev = self.device
        reads = torch.from_numpy(entry["reads"]).to(dev)
        draft = torch.from_numpy(entry["contigs"][0][1]).to(dev)
        needed = 0
        for needs in work.values():
            streamed, sectors, _ops = needs(reads, draft, self.cfg, self.traffic)
            needed += streamed + 32 * sectors
        return needed / engine_kind.PEAK_BYTES_PER_S

    def entry(self, job: int) -> int:
        return (self.start + job) % len(self.entries)

    def job(self, job: int, spans) -> tuple:
        from ntedit_tpu_torch import cli

        idx = self.entry(job)
        ent = self.entries[idx]
        jobdir = tempfile.mkdtemp(prefix="job", dir=self.root)
        for path in ent["files"]:
            os.symlink(path, os.path.join(jobdir, os.path.basename(path)))
        e = self.cfg["engine"]
        argv = ["polish", "--draft", ent["draft"], "--reads", os.path.join(jobdir, "reads"),
                "-k", str(self.cfg["k"]), "-i", str(e["i"]), "-d", str(e["d"]), "-t", str(e["t"]),
                "-z", str(e["z"]), "-j", str(e["j"]), "-x", str(e["x"]), "-y", str(e["y"]),
                "--force", "-b", os.path.join(jobdir, "out"),
                "--device", "cuda" if torch.device(self.device).type == "cuda" else "cpu"]
        try:
            with spans("cli"), contextlib.redirect_stdout(io.StringIO()):
                cli.main(argv)
            out = []
            prefix = os.path.join(jobdir, f"out_ntedit_k{self.cfg['k']}")
            for suffix in ("_edited.fa", "_changes.tsv", "_variants.vcf"):
                with open(prefix + suffix) as f:
                    out.append(f.read())
            base = os.path.join(jobdir, f"reads_k{self.cfg['k']}")
            with open(base + ".hist") as f:
                out.append(f.read())
            with open(base + ".bf", "rb") as f:
                out.append(f.read())
        finally:
            shutil.rmtree(jobdir, ignore_errors=True)
        if self.fault is not None:  # tests: the timed path broken underneath
            out = self.fault(out, ent)
        return idx, ent["read_bp"], tuple(out)

    def close(self) -> None:
        shutil.rmtree(self.root, ignore_errors=True)
        if torch.cuda.is_available():
            torch.cuda.empty_cache()

    def check(self, done: list) -> tuple:
        k, h = self.cfg["k"], self.cfg["hash_num"]
        rcfg = ref_engine.engine_config(k, h, self.cfg["engine"], False)
        c = self.traffic["check"]
        hist_rows = filter_words_diff = 0
        filters = {}
        first = {}
        for idx, out in done:
            first.setdefault(idx, out)
        for idx, out in first.items():
            ent = self.entries[idx]
            can = ref_build.read_hashes(torch.from_numpy(ent["reads"].reshape(-1, ent["reads"].shape[-1])).to(self.device), k)
            f1, f0, spec = ref_build.histogram(can)
            want_hist = ref_build.histogram_text(f1, f0, spec).splitlines()
            got_hist = out[3].splitlines()
            hist_rows += sum(a != b for a, b in zip(want_hist, got_hist)) + abs(len(want_hist) - len(got_hist))
            words = ref_build.read_filter(can, k, f0, spec, self.traffic["cutoff"], h)
            header, got = filter_words(out[4])
            want_header = (f"[NTPUBlockedKmerBloomFilter_v1]\nbytes = {words.size * 4}\nhash_num = {h}\n"
                           f"k = {k}\nlayout = blocked32\n[HEADER_END]\n")
            if header != want_header or got.size != words.size:
                filter_words_diff += max(words.size, 1)
            else:
                filter_words_diff += int((got != words).sum())
            filters[idx] = ref_engine.HostFilter(words, h)
            del can
        pool = [[(n, s.tobytes()) for n, s in ent["contigs"]] for ent in self.entries]
        rng = inputs.host_rng(self.seed, 5)
        compared, on = check.check_jobs(pool, [(i, o[:3]) for i, o in done], rng, filters, rcfg,
                                        c["stretches"], c["width"])
        compared["differing_repeats"] = sum(1 for i, o in done if o != first[i])
        compared["differing_hist_rows"] = hist_rows
        compared["differing_filter_words"] = filter_words_diff
        return compared, on
