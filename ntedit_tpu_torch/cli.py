"""Command-line interface of the torch port: ``python -m ntedit_tpu_torch``.

Only the ``engine`` subcommand is ported: the ntedit executable's direct
CLI (ntedit.cpp:52-97), every polish-mode and SNV-mode (-s 1) flag, default
and clamp of the JAX package's ``engine`` subcommand, k and the hash count
read from the
Bloom-filter header (ntedit.cpp:2439-2448).  The default output prefix is
the reference's ``<draft>_k<k>_z<z>_r<bf>_i<i>_d<d>_m<m>``
(ntedit.cpp:2494-2501).  ``--device`` picks the card (default) or the CPU.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

VERSION = "ntedit_tpu_torch 0.1.0 (capabilities of ntEdit v2.1.1)"
NOT_PORTED = "is not ported to the torch package yet (see ROADMAP.md)"


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
    p: int = 1,
    q: int = 255,
    device: str = "cuda",
    site_rows: bool = True,
) -> str:
    """``site_rows`` is Polisher's (SNV mode only; the outputs do not depend
    on it, so the command line has no flag for it)."""
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
        min_threshold=p, max_threshold=q, threads=max(1, threads),
    ).validate()

    if not prefix:
        db = os.path.basename(draft_path)
        bb = os.path.basename(bf_path)
        prefix = (
            f"{db}_k{k}_z{z}_r{bb}_i{cfg.max_insertions}"
            f"_d{cfg.max_deletions}_m{m}"
        )

    clinvar = writers.read_annotation_vcf(vcf_path) if vcf_path else {}

    print(
        f"running: {writers.PROGRAM}\n -f {os.path.basename(draft_path)}"
        f"\n -k {k}\n -z {z}\n -b {prefix}\n -r {os.path.basename(bf_path)}"
        f"\n -i {cfg.max_insertions}\n -d {cfg.max_deletions}"
        + (f"\n -X {X}\n -Y {Y}" if use_ratio else f"\n -x {x}\n -y {y}")
        + f"\n -j {j}\n -m {m}\n -s {s}\n -a {a}\n -t {threads}\n -v 0",
        flush=True,
    )
    if counting:
        print(f" -p {p}\n -q {q}", flush=True)

    pol = Polisher(host_bf, bloomrep, cfg, device=device, site_rows=site_rows)

    def contig_stream():
        # contigs shorter than -z are read but not polished/emitted
        # (ntedit.cpp:2242); polish() applies the filter
        for rec in fastx.read_fastx(draft_path):
            yield rec.header, rec.seq

    with open(prefix + "_edited.fa", "w") as dfout, \
         open(prefix + "_changes.tsv", "w") as rfout, \
         open(prefix + "_variants.vcf", "w") as vfout:
        rfout.write(writers.changes_tsv_header(k, j, counting))
        vfout.write(writers.vcf_header(draft_path))
        t0 = time.time()
        total_bases = n_contigs = n_records = 0
        # polish() overlaps contigs two-deep with -t > 1 and yields in
        # input order
        for res in pol.polish(contig_stream()):
            writers.write_contig(res, dfout, rfout, vfout, clinvar, snv=cfg.snv)
            total_bases += len(res.contig)
            n_contigs += 1
            n_records += len(res.subs)
    dt = max(time.time() - t0, 1e-9)
    print(
        f"engine: {n_contigs} contigs, {total_bases:,} bp in {dt:.2f}s "
        f"({total_bases / dt:,.0f} bp/s), {n_records} records",
        flush=True,
    )
    return prefix


def cmd_engine(args) -> None:
    if args.v:
        raise NotImplementedError(f"verbose tracing (-v 1) {NOT_PORTED}")
    if args.spill != "off":
        raise NotImplementedError(f"the per-contig record spill {NOT_PORTED}")
    if os.environ.get("NTEDIT_TPU_COORDINATOR") or os.environ.get("NTEDIT_TPU_DISTRIBUTED"):
        raise NotImplementedError(f"multi-host polishing {NOT_PORTED}")
    if args.c is not None:
        print(
            "warning: -c has no effect (the v2.1.1 engine overrides the "
            "insertion cap to k*1.5; see FIDELITY.md #7)",
            file=sys.stderr, flush=True,
        )
    _run_engine(
        args.r, args.f, args.b, reject_path=args.e_bf, vcf_path=args.l,
        threads=args.t, z=args.z, i=args.i, d=args.d, x=args.x, y=args.y,
        X=args.X, Y=args.Y, j=args.j, m=args.m, s=args.s, a=args.a, p=args.p, q=args.q,
        device=args.device,
    )


def _not_ported(args) -> None:
    raise NotImplementedError(f"the {args.mode!r} subcommand {NOT_PORTED}")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="ntedit_tpu_torch",
        description="ntEdit polishing on an NVIDIA GPU (torch port of ntedit_tpu)",
    )
    ap.add_argument("-V", "--version", action="version", version=VERSION)
    sub = ap.add_subparsers(dest="mode")

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
                     help="verbose: only 0 is ported")
    eng.add_argument("-p", type=int, default=1)
    eng.add_argument("-q", type=int, default=255)
    eng.add_argument("--spill", choices=("auto", "on", "off"), default="off",
                     help="per-contig record spill: only off is ported")
    eng.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                     help="where the dense passes run [cuda]")
    eng.set_defaults(func=cmd_engine)

    for name in ("polish", "snv", "make-genome-bf"):
        sub.add_parser(name, help="not ported yet (see ROADMAP.md)").set_defaults(
            func=_not_ported)
    return ap


def main(argv=None) -> None:
    ap = build_parser()
    args, rest = ap.parse_known_args(argv)
    if args.mode is None:
        ap.print_help()
        sys.exit(0)
    if rest and args.func is not _not_ported:
        ap.error(f"unrecognized arguments: {' '.join(rest)}")
    args.func(args)


if __name__ == "__main__":
    main()
