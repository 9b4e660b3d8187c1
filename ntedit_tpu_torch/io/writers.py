"""Output writers: _edited.fa, _changes.tsv, _variants.vcf.

A copy of the JAX package's writers (the port keeps its own host code):
the reference writer semantics (ntedit.cpp ``writeEditsToFile`` 925-1213
and the header setup in ``readAndCorrect`` 2154-2211) over the engines'
rope or the Oracle's cell list.  Observable quirks reproduced on purpose:

* insertion rows log ``draft_char = contig[span_start - len(insertion)]``
  (ntedit.cpp:957) and the *previous* span-end+1 as position;
* a trailing insertion run at the end of a contig is emitted to the FASTA
  but never logged to TSV/VCF (no following span node triggers the log);
* deletion rows print the 0-based first deleted coordinate (no +1 — the
  TSV header says bpPosition+1 but deletions do not add 1,
  ntedit.cpp:1201);
* a deletion immediately followed by an insertion logs the deletion row
  first (the peek at ntedit.cpp:1178-1210 fires before the insertion log
  of the next span node);
* SNV-mode no-edit records (sub_base == draft) are suppressed from the TSV
  but emitted to the VCF with the 0/1-vs-1/2 genotype heuristics
  (ntedit.cpp:988-996, 1054-1157);
* input-VCF (ClinVar) annotations are appended to INFO as ``^<info>`` or
  ``^NA`` per looked-up allele key (ntedit.cpp:953-969, 999-1025,
  1070-1153).
"""

from __future__ import annotations

import gzip
import math
import time
from typing import Optional, TextIO

from ntedit_tpu_torch.engine.records import ContigResult, SubRec
from ntedit_tpu_torch.utils import profiling

PROGRAM = "ntEditTPU v0.1.0"


def read_annotation_vcf(path: str) -> dict:
    """vcf_entry_to_map (ntedit.cpp:2261-2274): key = CHROM>REF POS ALT
    (concatenated), value = INFO column.  Handles .gz."""
    out: dict[str, str] = {}
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        for line in f:
            toks = line.rstrip("\n").split("\t")
            if len(toks) >= 8:
                out[f"{toks[0]}>{toks[3]}{toks[1]}{toks[4]}"] = toks[7]
    return out


def changes_tsv_header(k: int, jump: int, counting: bool) -> str:
    """ntedit.cpp:2175-2188."""
    if counting:
        support = "Coverage (max 255)"
        evi = "Coverage"
    else:
        support = f"Support {k}-mer (out of {math.ceil(k / jump):.0f})"
        evi = "Support"
    return (
        "ID\tbpPosition+1\tOriginalBase\tNewBase\t" + support
        + f"\tAlt.Base1\tAlt.{evi}1\tAlt.Base2\tAlt.{evi}2\tAlt.Base3\tAlt.{evi}3\n"
    )


def vcf_header(draft_filename: str, file_date: Optional[str] = None) -> str:
    """ntedit.cpp:2192-2211."""
    if file_date is None:
        file_date = time.strftime("%Y%m%d")
    return (
        "##fileformat=VCFv4.2\n"
        f"##fileDate={file_date}\n"
        f"##source={PROGRAM}\n"
        f"##reference=file:{draft_filename}\n"
        '##FORMAT=<ID=GT,Number=1,Type=String,Description="Genotype">\n'
        '##INFO=<ID=AD,Number=2,Type=Integer,Description="Kmer Depth">\n'
        "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\tINTEGRATION\n"
    )


def _clin(clinvar: dict, key: str) -> str:
    info = clinvar.get(key, "")
    return f"^{info}" if info else "^NA"


class _Runs:
    """The edited sequence as alternating original spans (contiguous
    coordinates) and insertion runs.  From a rope: coordinate-contiguous
    span nodes merge into one run, adjacent inserted cells into one
    insertion run.  From the Oracle's cell list (one [orig, char,
    ins_support, span_support] cell per base): the same runs."""

    def __init__(self, result: ContigResult):
        self.runs = []
        nodes = getattr(result.cells, "nodes", None)
        if nodes is None:
            self._from_cells(result.cells)
            return
        for nd in nodes:
            if nd[0] == "span":
                if (
                    self.runs
                    and self.runs[-1][0] == "span"
                    and self.runs[-1][2] + 1 == nd[1]
                ):
                    prev = self.runs[-1]
                    self.runs[-1] = ("span", prev[1], nd[2], prev[3])
                else:
                    self.runs.append(("span", nd[1], nd[2], nd[3]))
            else:
                cell = nd[1]
                if self.runs and self.runs[-1][0] == "ins":
                    prev = self.runs[-1]
                    self.runs[-1] = (
                        "ins", prev[1] + bytes([cell[1]]), prev[2] + [cell[2]],
                        None,
                    )
                else:
                    self.runs.append(("ins", bytes([cell[1]]), [cell[2]], None))

    def _from_cells(self, cells: list) -> None:
        i = 0
        n = len(cells)
        while i < n:
            if cells[i][0] >= 0:  # span
                s = cells[i][0]
                sup = cells[i][3]
                j = i
                while j + 1 < n and cells[j + 1][0] == cells[j][0] + 1:
                    j += 1
                self.runs.append(("span", s, cells[j][0], sup))
                i = j + 1
            else:
                chars = []
                sups = []
                j = i
                while j < n and cells[j][0] < 0:
                    chars.append(cells[j][1])
                    sups.append(cells[j][2])
                    j += 1
                self.runs.append(("ins", bytes(chars), sups, None))
                i = j


def write_contig(
    result: ContigResult,
    dfout: TextIO,
    rfout: TextIO,
    vfout: TextIO,
    clinvar: Optional[dict] = None,
    snv: bool = False,
) -> None:
    """One contig's edited sequence, TSV rows and VCF rows (span
    ``io.render``)."""
    with profiling.span("io.render"):
        _write_contig(result, dfout, rfout, vfout, clinvar or {}, snv)


def _write_contig(result: ContigResult, dfout: TextIO, rfout: TextIO, vfout: TextIO,
                  clinvar: dict, snv: bool) -> None:
    hdr = result.header
    contig = result.contig
    subs = list(result.subs)
    sub_i = 0
    runs = _Runs(result).runs

    dfout.write(f">{hdr}\n")
    pos = 0
    insertion_bases = bytearray()
    num_support = -1

    for ri, run in enumerate(runs):
        if run[0] == "span":
            _, s, e, span_sup = run
            if insertion_bases:
                ins = insertion_bases.decode()
                draft_char = chr(contig[s - len(ins)])
                insert_str = draft_char + ins
                key = f"{hdr}>{draft_char.upper()}{pos}{insert_str.upper()}"
                info = _clin(clinvar, key)
                rfout.write(f"{hdr}\t{pos}\t{draft_char}\t+{ins}\t{num_support}\n")
                vfout.write(
                    f"{hdr}\t{pos}\t.\t{draft_char}\t{draft_char}{ins}"
                    f"\t.\tPASS\tAD={num_support}{info}\tGT\t1/1\n"
                )
                insertion_bases = bytearray()
                num_support = -1
            while sub_i < len(subs) and subs[sub_i].pos <= e:
                _write_sub(subs[sub_i], hdr, rfout, vfout, clinvar, snv)
                sub_i += 1
            dfout.write(contig[s : e + 1].decode())
            pos = e + 1
        else:
            _, chars, sups, _ = run
            insertion_bases.extend(chars)
            if num_support == -1 and sups:
                num_support = sups[0]
            dfout.write(chars.decode())
        # peek: deletion gap before the next span (ntedit.cpp:1178-1210)
        if ri + 1 < len(runs) and runs[ri + 1][0] == "span":
            nxt = runs[ri + 1]
            if nxt[1] != pos:
                gap = nxt[1] - pos
                deleted = contig[pos : pos + gap].decode()
                delete_str = contig[pos - 1 : pos + gap].decode()
                key = f"{hdr}>{delete_str.upper()}{pos}{chr(contig[pos - 1]).upper()}"
                info = _clin(clinvar, key)
                rfout.write(
                    f"{hdr}\t{pos}\t{chr(contig[pos])}\t-{deleted}\t{nxt[3]}\n"
                )
                vfout.write(
                    f"{hdr}\t{pos}\t.\t{delete_str}\t{chr(contig[pos - 1])}"
                    f"\t.\tPASS\tAD={nxt[3]}{info}\tGT\t1/1\n"
                )
    dfout.write("\n")


def _write_sub(rec: SubRec, hdr: str, rfout, vfout, clinvar: dict, snv: bool) -> None:
    """One substitution record: TSV row + VCF row with genotype heuristics
    (ntedit.cpp:983-1163)."""
    draft = chr(rec.draft_char)
    subc = chr(rec.sub_base)
    # snv_mode_no_edit is TRUE when this is a real edit row (quirky name
    # preserved from the reference, ntedit.cpp:987-990)
    is_edit_row = not (snv and rec.draft_char == rec.sub_base)

    alt_bases = []
    alt_supps = []
    tsv = ""
    if is_edit_row:
        tsv = f"{hdr}\t{rec.pos + 1}\t{draft}\t{subc}\t{rec.num_support}"
    base = subc
    support = str(rec.num_support)
    info = _clin(clinvar, f"{hdr}>{draft.upper()}{rec.pos + 1}{draft.upper()}")
    if is_edit_row:
        info += _clin(clinvar, f"{hdr}>{draft.upper()}{rec.pos + 1}{subc.upper()}")
    for ab, asup in (
        (rec.altbase1, rec.altsupp1),
        (rec.altbase2, rec.altsupp2),
        (rec.altbase3, rec.altsupp3),
    ):
        if asup > 0:
            if is_edit_row:
                tsv += f"\t{chr(ab)}\t{asup}"
            alt_bases.append(chr(ab))
            alt_supps.append(asup)
    if is_edit_row:
        rfout.write(tsv + "\n")

    genotype = "1/1"
    if alt_bases:
        best_supp = 0
        best_base = "1"
        if snv:
            if not is_edit_row:
                # SNV no-edit: ref-supported het vs best alt
                for b, s in zip(alt_bases, alt_supps):
                    if s > best_supp:
                        best_supp, best_base = s, b
                base = best_base
                info += _clin(clinvar, f"{hdr}>{draft.upper()}{rec.pos + 1}{best_base.upper()}")
                support = f"{support},{best_supp}"
                genotype = "0/1"
            else:
                ref = False
                for b, s in zip(alt_bases, alt_supps):
                    # prioritize the reference base over other alts
                    if draft == b:
                        best_supp = s
                        ref = True
                        break
                    if s > best_supp:
                        best_supp, best_base = s, b
                if ref:
                    support = f"{best_supp},{support}"
                    genotype = "0/1"
                else:
                    genotype = "1/2"
                    support = f"{support},{best_supp}"
                    base = f"{base},{best_base}"
                    info += _clin(
                        clinvar, f"{hdr}>{draft.upper()}{rec.pos + 1}{best_base.upper()}"
                    )
        else:
            for b, s in zip(alt_bases, alt_supps):
                if draft == b:
                    continue  # skip ref base in non-snv mode
                if s > best_supp:
                    best_supp, best_base = s, b
            genotype = "1/2"
            support = f"{support},{best_supp}"
            base = f"{base},{best_base}"
            info += _clin(clinvar, f"{hdr}>{draft.upper()}{rec.pos + 1}{best_base.upper()}")

    vfout.write(
        f"{hdr}\t{rec.pos + 1}\t.\t{draft}\t{base}\t.\tPASS\tAD={support}{info}"
        f"\tGT\t{genotype}\n"
    )
