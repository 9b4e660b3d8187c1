"""Command-line interface of the torch port: ``python -m ntedit_tpu_torch``.

The JAX package's four subcommands, on the card unless ``--device cpu``:

* ``polish`` / ``snv`` — run-ntedit's subcommands and the Snakemake
  pipeline's role: reads-prefix expansion, the ntCard-role histogram, the
  ntStat-role Bloom filter (core/bfbuild.py, built on the device), then the
  engine, with file-artifact stage caching (``-n`` dry run, ``-f`` rerun).
* ``engine`` — the ntedit executable's direct CLI (ntedit.cpp:52-97): every
  polish-mode and SNV-mode (-s 1) flag, default and clamp of the JAX
  package's ``engine`` subcommand, k and the hash count read from the
  Bloom-filter header (ntedit.cpp:2439-2448).  The default output prefix
  is the reference's ``<draft>_k<k>_z<z>_r<bf>_i<i>_d<d>_m<m>``
  (ntedit.cpp:2494-2501).
* ``make-genome-bf`` — ntedit_make_genome_bf.

Every subcommand takes ``--spill auto|on|off`` (default auto: on for drafts
above 256 MB): the per-contig record spill of io/spill.py, so that a killed
run resumes where it stopped.  ``-v`` prints each contig's header and the
Oracle's trial lines (those of its scalar site path, as the JAX package
prints them).  With ``NTEDIT_TPU_TRACE=<dir>`` set, the whole subcommand
(its filter stages and the engine) is profiled into one Chrome trace
there, with the program's spans and counters on the same timeline
(utils/profiling.py).
The read-filter build makes the JAX package's device layout (blocked,
power-of-two sizes) on the card and on the CPU.

Multi-host runs (parallel/distributed.py): every process is launched with
``NTEDIT_TPU_COORDINATOR=host:port``, ``NTEDIT_TPU_NUM_PROCESSES=N`` and
``NTEDIT_TPU_PROCESS_ID=i`` (or ``NTEDIT_TPU_DISTRIBUTED=1`` under a
launcher's ``env://`` variables); ``main`` joins the process group once
``--device`` is known.  Each rank polishes its contiguous share of the
contigs and rank 0 writes the merged files in input order.
"""

from __future__ import annotations

import argparse
import dataclasses
import glob
import io
import itertools
import os
import sys
import time
from collections import deque

from ntedit_tpu_torch.utils import profiling

VERSION = "ntedit_tpu_torch 0.1.0 (capabilities of ntEdit v2.1.1)"


# ---------------------------------------------------------------------------
# stage cache (Snakemake role)
# ---------------------------------------------------------------------------

def _stale(output: str, inputs: list[str]) -> bool:
    """True if output is missing or older than any input (Snakemake's
    --rerun-trigger mtime contract, run-ntedit:232-233)."""
    if not os.path.exists(output):
        return True
    out_m = os.path.getmtime(output)
    return any(os.path.exists(i) and os.path.getmtime(i) > out_m for i in inputs)


class Stages:
    def __init__(self, force: bool, dry_run: bool):
        self.force = force
        self.dry_run = dry_run

    def run(self, name: str, outputs: list[str], inputs: list[str], desc: str, fn) -> bool:
        """Run the stage ``name`` (its span ``cli.<name>``) unless its
        outputs are newer than its inputs."""
        need = self.force or any(_stale(o, inputs) for o in outputs)
        if not need:
            print(f"[cached] {desc}", flush=True)
            return False
        if self.dry_run:
            print(f"[would run] {desc}", flush=True)
            return False
        t0 = time.time()
        print(f"[running] {desc}", flush=True)
        with profiling.span(f"cli.{name}"):
            fn()
        print(f"[done {time.time() - t0:.1f}s] {desc}", flush=True)
        return True


def _expand_reads_prefix(prefix: str) -> list[str]:
    """All files in the working directory with the given prefix
    (run-ntedit --reads contract)."""
    exts = (".fq", ".fastq", ".fa", ".fasta", ".fq.gz", ".fastq.gz",
            ".fa.gz", ".fasta.gz")
    hits = sorted(
        p for p in glob.glob(prefix + "*")
        if p.endswith(exts) and os.path.isfile(p)
    )
    if not hits:
        raise SystemExit(f"no read files match prefix '{prefix}'")
    return hits


SPILL_AUTO_BYTES = 256 << 20  # --spill auto spills drafts above this size


def _estimated_draft_bytes(path: str) -> int:
    """Uncompressed draft size estimate for the spill='auto' threshold.
    For .gz read the gzip trailer ISIZE (uncompressed size mod 2^32); when
    it wrapped (smaller than the compressed stream) take 4x the compressed
    size (a typical FASTA gzip ratio)."""
    size = os.path.getsize(path)
    if not path.endswith(".gz"):
        return size
    try:
        with open(path, "rb") as f:
            f.seek(-4, os.SEEK_END)
            isize = int.from_bytes(f.read(4), "little")
    except OSError:
        isize = 0
    return isize if isize >= size else size * 4


def _file_id(path: str | None):
    if path is None:
        return None
    try:
        st = os.stat(path)
        return [path, st.st_size, st.st_mtime]
    except OSError:
        return [path, 0, 0]


def _open_spill(spill: str, prefix: str, cfg, draft_path: str, bf_path: str,
                reject_path: str | None, vcf_path: str | None):
    """The run's ContigSpill, or None: ``spill`` is on, off, or auto (on for
    drafts above SPILL_AUTO_BYTES).  Its manifest holds every engine
    parameter and the identity of every input file."""
    if spill == "off" or (spill == "auto"
                          and _estimated_draft_bytes(draft_path) <= SPILL_AUTO_BYTES):
        return None
    from ntedit_tpu_torch.io.spill import ContigSpill

    return ContigSpill(prefix, {
        "cfg": {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)},
        "draft": _file_id(draft_path), "bf": _file_id(bf_path),
        "reject": _file_id(reject_path), "vcf": _file_id(vcf_path),
    })


def _run_engine(
    bf_path: str,
    draft_path: str,
    prefix: str | None,
    *,
    reject_path: str | None = None,
    vcf_path: str | None = None,
    threads: int = 4,
    z: int = 100,
    i: int = 5,
    d: int = 5,
    x: float = 5.0,
    y: float = 9.0,
    X: float = -1.0,
    Y: float = -1.0,
    j: int = 3,
    m: int = 0,
    s: int = 0,
    a: int = 0,
    v: int = 0,
    p: int = 1,
    q: int = 255,
    device: str = "cuda",
    spill: str = "auto",
    site_rows: bool | None = None,
    engine: str = "auto",
) -> str:
    """``site_rows`` and ``engine`` are Polisher's (the outputs do not
    depend on them, so the command line has no flag for them)."""
    from ntedit_tpu_torch.core import bloom
    from ntedit_tpu_torch.engine.config import EngineConfig
    from ntedit_tpu_torch.engine.polish import Polisher
    from ntedit_tpu_torch.io import fastx, writers

    host_bf = bloom.load_any(bf_path)
    counting = hasattr(host_bf, "counters")
    k = host_bf.k
    if not counting:
        p = 1  # -p forced to 1 for non-counting BF (ntedit.cpp:2453-2458)

    bloomrep = bloom.load_any(reject_path) if reject_path else None
    if bloomrep is not None and bloomrep.k != k:
        raise SystemExit(
            f"secondary BF k ({bloomrep.k}) != primary k ({k})"
        )  # ntedit.cpp:2581-2585

    use_ratio = X != -1 or Y != -1
    if use_ratio:
        X = 0.5 if X == -1 else X
        Y = 0.5 if Y == -1 else Y

    cfg = EngineConfig(
        k=k, hash_num=host_bf.hash_num, min_contig_len=z,
        max_insertions=i, max_deletions=d, missing_threshold=x,
        edit_threshold=y, use_ratio=use_ratio, missing_ratio=max(X, 0.0),
        edit_ratio=max(Y, 0.0), jump=j, mode=m, snv=bool(s), mask=bool(a),
        min_threshold=p, max_threshold=q, verbose=bool(v), threads=max(1, threads),
    ).validate()

    if not prefix:
        db = os.path.basename(draft_path)
        bb = os.path.basename(bf_path)
        prefix = (
            f"{db}_k{k}_z{z}_r{bb}_i{cfg.max_insertions}"
            f"_d{cfg.max_deletions}_m{m}"
        )

    clinvar = writers.read_annotation_vcf(vcf_path) if vcf_path else {}

    from ntedit_tpu_torch.parallel import distributed as dist

    if dist.active():
        _run_engine_multihost(host_bf, bloomrep, cfg, draft_path, prefix, clinvar, device,
                              site_rows, engine)
        return prefix

    print(
        f"running: {writers.PROGRAM}\n -f {os.path.basename(draft_path)}"
        f"\n -k {k}\n -z {z}\n -b {prefix}\n -r {os.path.basename(bf_path)}"
        f"\n -i {cfg.max_insertions}\n -d {cfg.max_deletions}"
        + (f"\n -X {X}\n -Y {Y}" if use_ratio else f"\n -x {x}\n -y {y}")
        + f"\n -j {j}\n -m {m}\n -s {s}\n -a {a}\n -t {threads}\n -v {v}",
        flush=True,
    )
    if counting:
        print(f" -p {p}\n -q {q}", flush=True)

    pol = Polisher(host_bf, bloomrep, cfg, device=device, site_rows=site_rows, engine=engine)
    sp = _open_spill(spill, prefix, cfg, draft_path, bf_path, reject_path, vcf_path)
    # input order of the contigs polish() is given and of those the spill
    # already holds: ("cached", fragments, length) or ("fresh", record id)
    events = deque()

    def contig_stream():
        records = fastx.read_fastx(draft_path)
        for idx in itertools.count():
            with profiling.span("io.draft"):
                rec = next(records, None)
            if rec is None:
                return
            # contigs shorter than -z are read but not polished or emitted
            # (ntedit.cpp:2242)
            if len(rec.seq) < cfg.min_contig_len:
                continue
            key = None
            if sp is not None:
                key = (idx, rec.header, len(rec.seq), sp.crc(rec.seq))
                got = sp.get(*key)
                if got is not None:
                    events.append(("cached", got, len(rec.seq)))
                    continue
            events.append(("fresh", key))
            if v:
                print(rec.header, flush=True)
            yield rec.header, rec.seq

    with open(prefix + "_edited.fa", "w") as dfout, \
         open(prefix + "_changes.tsv", "w") as rfout, \
         open(prefix + "_variants.vcf", "w") as vfout:
        rfout.write(writers.changes_tsv_header(k, j, counting))
        vfout.write(writers.vcf_header(draft_path))
        t0 = time.time()
        total_bases = n_contigs = n_records = 0

        def write_cached():
            nonlocal total_bases, n_contigs, n_records
            while events and events[0][0] == "cached":
                _, frags, length = events.popleft()
                for f, text in zip((dfout, rfout, vfout), frags):
                    f.write(text)
                total_bases += length
                n_contigs += 1
                n_records += frags[1].count("\n")

        # polish() overlaps contigs two-deep with -t > 1 and yields in input
        # order: each result belongs to the first fresh event, whose contig
        # was queued before it was polished, and the spilled contigs ahead
        # of it are written first
        for res in pol.polish(contig_stream()):
            write_cached()
            _, key = events.popleft()
            if sp is not None:
                sinks = io.StringIO(), io.StringIO(), io.StringIO()
                writers.write_contig(res, *sinks, clinvar, snv=cfg.snv)
                frags = tuple(s.getvalue() for s in sinks)
                sp.put(*key, *frags)
                for f, text in zip((dfout, rfout, vfout), frags):
                    f.write(text)
            else:
                writers.write_contig(res, dfout, rfout, vfout, clinvar, snv=cfg.snv)
            total_bases += len(res.contig)
            n_contigs += 1
            n_records += len(res.subs)
        write_cached()
    if sp is not None:
        sp.finalize()
    dt = max(time.time() - t0, 1e-9)
    print(
        f"engine: {n_contigs} contigs, {total_bases:,} bp in {dt:.2f}s "
        f"({total_bases / dt:,.0f} bp/s), {n_records} records",
        flush=True,
    )
    return prefix


def _run_engine_multihost(host_bf, bloomrep, cfg, draft_path: str, prefix: str, clinvar: dict,
                          device: str = "cuda", site_rows: bool | None = None,
                          engine: str = "auto") -> None:
    """Multi-host polish: every process owns a contiguous slice of the
    input contigs (distributed.process_slice), polishes them against its
    own copy of the filter on its own device, renders each contig's three
    output fragments, and rank 0 writes the merged files in input order
    after an allgather of the fragments (distributed.gather_records):
    byte-identical to a single-process run."""
    from ntedit_tpu_torch.engine.polish import Polisher
    from ntedit_tpu_torch.io import fastx, writers
    from ntedit_tpu_torch.parallel import distributed as dist

    n = fastx.count_records(draft_path)
    sl = dist.process_slice(n)
    rank = dist.rank()
    print(f"[rank {rank}/{dist.world_size()}] contigs [{sl.start}, {min(sl.stop, n)}) of {n}",
          flush=True)

    pol = Polisher(host_bf, bloomrep, cfg, device=dist.local_device(device),
                   site_rows=site_rows, engine=engine)
    t0 = time.time()
    total_bases = n_records = 0

    def owned_stream():
        for i, rec in enumerate(fastx.read_fastx(draft_path)):
            if sl.start <= i < sl.stop:
                yield rec.header, rec.seq

    rendered = []
    for res in pol.polish(owned_stream()):
        sinks = io.StringIO(), io.StringIO(), io.StringIO()
        writers.write_contig(res, *sinks, clinvar, snv=cfg.snv)
        rendered.append(tuple(s.getvalue() for s in sinks))
        total_bases += len(res.contig)
        n_records += len(res.subs)
    dt = max(time.time() - t0, 1e-9)
    print(f"[rank {rank}] {len(rendered)} contigs, {total_bases:,} bp in {dt:.2f}s "
          f"({total_bases / dt:,.0f} bp/s), {n_records} records", flush=True)

    # process_slice is contiguous in input order and gather_records
    # concatenates in rank order, so the merge is input order
    parts = dist.gather_records(rendered)
    if rank == 0:
        counting = hasattr(host_bf, "counters")
        with open(prefix + "_edited.fa", "w") as dfout, \
             open(prefix + "_changes.tsv", "w") as rfout, \
             open(prefix + "_variants.vcf", "w") as vfout:
            rfout.write(writers.changes_tsv_header(cfg.k, cfg.jump, counting))
            vfout.write(writers.vcf_header(draft_path))
            for fa, tsv, vcf in parts:
                dfout.write(fa)
                rfout.write(tsv)
                vfout.write(vcf)


def cmd_engine(args) -> None:
    if args.c is not None:
        print(
            "warning: -c has no effect (the v2.1.1 engine overrides the "
            "insertion cap to k*1.5; see FIDELITY.md #7)",
            file=sys.stderr, flush=True,
        )
    _run_engine(
        args.r, args.f, args.b, reject_path=args.e_bf, vcf_path=args.l,
        threads=args.t, z=args.z, i=args.i, d=args.d, x=args.x, y=args.y,
        X=args.X, Y=args.Y, j=args.j, m=args.m, s=args.s, a=args.a, v=args.v, p=args.p,
        q=args.q, device=args.device, spill=args.spill,
    )


# ---------------------------------------------------------------------------
# pipeline stages
# ---------------------------------------------------------------------------

class _LazyBatches:
    """The inputs' bfbuild.DeviceBatches, made when a stage first reads
    them: the histogram and filter stages of one run share their pieces
    on the device, so the files are read once (when the pieces fit)."""

    def __init__(self, paths: list, k: int, device: str):
        self.args = (paths, k, device)
        self.batches = None

    def get(self):
        if self.batches is None:
            from ntedit_tpu_torch.core import bfbuild

            self.batches = bfbuild.device_batches(*self.args)
        return self.batches


def _reads_filter_stages(stages, reads_prefix, k, cutoff, solid, fpr, device, cbf=False):
    """ntcard + ntstat role: histogram + read BF/CBF with stage caching.
    Artifact names match the Snakemake rules (ntedit_run_pipeline.smk:
    155-176, 192-202)."""
    from ntedit_tpu_torch.core import bfbuild

    read_files = _expand_reads_prefix(reads_prefix)
    hist_path = f"{reads_prefix}_k{k}.hist"
    bf_path = f"{reads_prefix}_k{k}" + (".cbf" if cbf else ".bf")
    reads = _LazyBatches(read_files, k, device)

    def make_hist():
        bfbuild.count_histogram(read_files, k, device=device,
                                batches=reads.get()).save(hist_path)

    stages.run("histogram", [hist_path], read_files, f"ntcard-role histogram -> {hist_path}",
               make_hist)

    def make_bf():
        hist = bfbuild.Histogram.load(hist_path, k=k)
        filt, _, used_cutoff = bfbuild.build_read_filter(
            read_files, k, cutoff=cutoff, solid=solid, fpr=fpr,
            counts=cbf, hist=hist, device=device, batches=reads.get(),
        )
        filt.save(bf_path)
        print(f"  cutoff={used_cutoff} bytes={filt.bytes}", flush=True)

    stages.run("filter", [bf_path], read_files + [hist_path],
               f"ntstat-role filter -> {bf_path}", make_bf)
    return bf_path


def cmd_polish(args) -> None:
    if args.cap is not None:
        # the reference unconditionally overrides -c with k*1.5 after the
        # BF loads (ntedit.cpp:2450-2451): accepted, warned, ignored
        print(
            "warning: --cap has no effect (the v2.1.1 engine overrides the "
            "insertion cap to k*1.5; see FIDELITY.md #7)",
            file=sys.stderr, flush=True,
        )
    stages = Stages(args.force, args.dry_run)
    bf_path = _reads_filter_stages(
        stages, args.reads, args.k, args.cutoff, args.solid, args.e, args.device,
        cbf=args.cbf,
    )
    b = args.b + "_" if args.b else ""
    prefix = f"{b}ntedit_k{args.k}"
    draft = args.draft

    def engine():
        _run_engine(
            bf_path, draft, prefix, vcf_path=args.l, threads=args.t,
            z=args.z, i=args.i, d=args.d, x=args.x, y=args.y, X=args.X,
            Y=args.Y, j=args.j, m=args.m, a=args.a, v=int(args.v), p=args.p, q=args.q,
            device=args.device, spill=args.spill,
        )

    stages.run(
        "engine", [prefix + "_edited.fa"], [bf_path, draft],
        f"ntedit polish -> {prefix}_edited.fa", engine,
    )
    if not args.dry_run:
        print("Done ntEdit!", flush=True)


def cmd_snv(args) -> None:
    if bool(args.reads) == bool(args.genome):
        raise SystemExit("Please specify --reads OR --genome")
    reference = args.reference or args.draft
    if not reference:
        raise SystemExit("Please specify --reference")
    stages = Stages(args.force, args.dry_run)

    if args.reads:
        bf_path = _reads_filter_stages(
            stages, args.reads, args.k, args.cutoff, args.solid, args.e, args.device,
        )
        prefix = f"{args.reads}_ntedit_k{args.k}"
    else:
        from ntedit_tpu_torch.core import bfbuild

        genome_prefix = os.path.basename(args.genome[0]).split(".")[0]
        hist_path = f"{genome_prefix}.k{args.k}.hist"
        bf_path = f"{genome_prefix}_k{args.k}.bf"
        genome = _LazyBatches(list(args.genome), args.k, args.device)

        def make_hist():
            bfbuild.count_histogram(args.genome, args.k, device=args.device,
                                    batches=genome.get()).save(hist_path)

        stages.run("histogram", [hist_path], list(args.genome),
                   f"ntcard-role genome histogram -> {hist_path}", make_hist)

        def make_bf():
            hist = bfbuild.Histogram.load(hist_path, k=args.k)
            bf = bfbuild.build_genome_bf(
                args.genome, args.k, num_elements=hist.f0, device=args.device,
                batches=genome.get(),
            )
            bf.save(bf_path)

        stages.run("filter", [bf_path], list(args.genome) + [hist_path],
                   f"genome BF -> {bf_path}", make_bf)
        prefix = f"{genome_prefix}_ntedit_k{args.k}"

    def engine():
        _run_engine(
            bf_path, reference, prefix, vcf_path=args.l, threads=args.t,
            z=args.z, y=args.y, X=args.X, Y=args.Y, j=args.j, s=1, v=int(args.v),
            device=args.device, spill=args.spill,
        )

    stages.run(
        "engine", [prefix + "_variants.vcf"], [bf_path, reference],
        f"ntedit snv -> {prefix}_variants.vcf", engine,
    )
    if not args.dry_run:
        print("Done ntEdit!", flush=True)


def cmd_make_genome_bf(args) -> None:
    from ntedit_tpu_torch.core import bfbuild

    # the genome's pieces stay on the device from the length's pass to the
    # insertion's (when they fit): the genome is read once
    batches = bfbuild.device_batches(args.genome, args.k, args.device)
    if args.num_elements is None and args.bf is None:
        print(f"Genome size (bp): {batches.bases()}", flush=True)
    bf = bfbuild.build_genome_bf(
        args.genome, args.k, fpr=args.fpr, hash_num=args.hashes,
        bf_bytes=args.bf, num_elements=args.num_elements, device=args.device,
        batches=batches,
    )
    bf.save(args.o)
    print(f"Bloom filter saved to {args.o} ({bf.bytes} bytes)", flush=True)


# ---------------------------------------------------------------------------
# argparse wiring
# ---------------------------------------------------------------------------

def _add_device(sp) -> None:
    sp.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where the filter build and the dense passes run [cuda]")


def _add_spill(sp) -> None:
    sp.add_argument("--spill", choices=("auto", "on", "off"), default="auto",
                    help="per-contig record spill for crash-safe resume "
                         "(auto: on for drafts above 256 MB) [auto]")


def _add_common(sp) -> None:
    sp.add_argument("-k", type=int, required=True, help="k-mer size, REQUIRED")
    sp.add_argument("-l", type=str, default=None,
                    help="input VCF with annotated variants (e.g. clinvar.vcf)")
    sp.add_argument("--cutoff", type=int, default=2,
                    help="min k-mer coverage in output BF [2; ignored if --solid]")
    sp.add_argument("--solid", action="store_true",
                    help="keep only solid (non-erroneous) k-mers")
    sp.add_argument("-t", type=int, default=4, help="threads [4]")
    sp.add_argument("-z", type=int, default=100, help="min contig length [100]")
    _add_spill(sp)
    sp.add_argument("-y", type=float, default=9.0, help="k/y present ratio [9.0]")
    sp.add_argument("-j", type=int, default=3, help="k-mer subset stride [3]")
    sp.add_argument("-X", type=float, default=-1.0,
                    help="missing-ratio alternative (0.5 if only -Y given)")
    sp.add_argument("-Y", type=float, default=-1.0,
                    help="present-ratio alternative (0.5 if only -X given)")
    sp.add_argument("-e", type=float, default=0.01,
                    help="false positive rate for the read Bloom filter [0.01]")
    sp.add_argument("-v", action="store_true", help="verbose")
    sp.add_argument("-V", "--version", action="version", version=VERSION)
    sp.add_argument("-n", "--dry-run", action="store_true",
                    help="print the stages that would run")
    sp.add_argument("-f", "--force", action="store_true",
                    help="run all steps regardless of existing outputs")
    _add_device(sp)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="ntedit_tpu_torch",
        description="ntEdit polishing on an NVIDIA GPU (torch port of ntedit_tpu)",
    )
    ap.add_argument("-V", "--version", action="version", version=VERSION)
    sub = ap.add_subparsers(dest="mode")

    pol = sub.add_parser("polish", help="polish a draft assembly")
    pol.add_argument("--draft", required=True,
                     help="draft genome assembly (FASTA/.gz), REQUIRED")
    pol.add_argument("--reads", required=True,
                     help="prefix of reads file(s) in the working directory")
    pol.add_argument("-i", type=int, default=5, choices=range(0, 6),
                     help="max insertion bases to try [5]")
    pol.add_argument("-d", type=int, default=5, choices=range(0, 11),
                     help="max deletion bases to try [5]")
    pol.add_argument("-x", type=float, default=5.0,
                     help="k/x missing ratio [5.0]")
    pol.add_argument("--cap", type=float, default=None,
                     help="insertion cap [k*1.5]")
    pol.add_argument("-m", type=int, default=0, choices=range(0, 3),
                     help="edit mode: 0 first indel / 1 best indel / 2 best overall")
    pol.add_argument("-a", type=int, default=0, choices=range(0, 2),
                     help="soft-mask unfixed missing-kmer positions")
    pol.add_argument("-b", type=str, default="", help="output file prefix")
    pol.add_argument("--cbf", action="store_true",
                     help="use a counting Bloom filter (pipeline ntedit_cbf target)")
    pol.add_argument("-p", type=int, default=1,
                     help="min k-mer coverage threshold (CBF only) [1]")
    pol.add_argument("-q", type=int, default=255,
                     help="max k-mer coverage threshold (CBF only) [255]")
    _add_common(pol)
    pol.set_defaults(func=cmd_polish)

    snv = sub.add_parser("snv", help="call SNVs against a reference")
    snv.add_argument("--reference", help="reference assembly for SNV calling")
    snv.add_argument("--draft", help=argparse.SUPPRESS)
    snv.add_argument("--reads", type=str, default=None,
                     help="prefix of reads file(s) for variant calling")
    snv.add_argument("--genome", nargs="+", default=None,
                     help="genome assembly file(s) for detecting SNV on --reference")
    _add_common(snv)
    snv.set_defaults(func=cmd_snv)

    eng = sub.add_parser(
        "engine", help="run the engine directly on an existing Bloom filter"
    )
    eng.add_argument("-r", required=True, help="Bloom filter (.bf/.cbf), REQUIRED")
    eng.add_argument("-f", required=True, help="draft FASTA(.gz), REQUIRED")
    eng.add_argument("-b", default=None, help="output prefix [auto-composed]")
    eng.add_argument("-e", dest="e_bf", default=None,
                     help="secondary reject Bloom filter (repeat k-mers)")
    eng.add_argument("-t", type=int, default=4)
    eng.add_argument("-z", type=int, default=100)
    eng.add_argument("-i", type=int, default=5)
    eng.add_argument("-d", type=int, default=5)
    eng.add_argument("-x", type=float, default=5.0)
    eng.add_argument("-y", type=float, default=9.0)
    eng.add_argument("-X", type=float, default=-1.0)
    eng.add_argument("-Y", type=float, default=-1.0)
    eng.add_argument("-c", type=float, default=None,
                     help="insertion cap (overridden to k*1.5, as in v2.1.1)")
    eng.add_argument("-j", type=int, default=3)
    eng.add_argument("-m", type=int, default=0, choices=range(0, 3))
    eng.add_argument("-s", type=int, default=0, choices=range(0, 2),
                     help="SNV mode: substitutions only, every site evaluated [0]")
    eng.add_argument("-l", default=None,
                     help="input VCF with annotated variants (e.g. clinvar.vcf)")
    eng.add_argument("-a", type=int, default=0, choices=range(0, 2))
    eng.add_argument("-v", type=int, default=0, choices=range(0, 2),
                     help="verbose: each contig's header and the Oracle's trials [0]")
    eng.add_argument("-p", type=int, default=1)
    eng.add_argument("-q", type=int, default=255)
    _add_spill(eng)
    eng.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                     help="where the dense passes run [cuda]")
    eng.set_defaults(func=cmd_engine)

    mgb = sub.add_parser("make-genome-bf", help="build a Bloom filter from genomes")
    mgb.add_argument("--genome", nargs="+", required=True)
    mgb.add_argument("-k", type=int, required=True)
    mgb.add_argument("--fpr", type=float, default=0.01)
    mgb.add_argument("--hashes", type=int, default=3)
    mgb.add_argument("-o", default="genome_bf.bf")
    mgb.add_argument("--bf", type=int, default=None,
                     help="Bloom filter size in bytes")
    mgb.add_argument("--num_elements", type=int, default=None)
    mgb.add_argument("-t", type=int, default=12, help="accepted; the build runs on the device")
    _add_device(mgb)
    mgb.set_defaults(func=cmd_make_genome_bf)
    return ap


def main(argv=None) -> None:
    ap = build_parser()
    args = ap.parse_args(argv)
    if args.mode is None:
        ap.print_help()
        sys.exit(0)
    from ntedit_tpu_torch.parallel import distributed as dist

    joined = dist.initialize_from_env(args.device)
    try:
        with profiling.trace(device=args.device):  # a Chrome trace when NTEDIT_TPU_TRACE is set
            args.func(args)
    finally:
        if joined:
            dist.shutdown()


if __name__ == "__main__":
    main()
