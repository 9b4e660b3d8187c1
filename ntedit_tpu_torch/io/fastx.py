"""FASTA/FASTQ(.gz) streaming readers.

Host-side ingest replacing the reference's native readers: kseq for the
draft (ntedit.cpp:42, lib/kseq.h) and btllib::SeqReader
for reads in the filter tool (src/ntedit_make_genome_bf.cpp:26-29).
Design goals carried over: gzip-aware buffered streaming, name/comment
split at the first whitespace (kseq semantics), multi-line FASTA, case
preserved (README.md:362 — input case is kept except at edits).

``read_fastx`` reads through the batch reader of io/native.py (C++ over
zlib, built at first use), like the JAX package's reader when its library
is built.  ``read_fastx_plain`` is a copy of the JAX package's pure-Python
path: the plain version the tests hold the batch reader to.  Nothing on
the main path uses it.
"""

from __future__ import annotations

import dataclasses
import gzip
import io
from typing import Iterator, Optional

import numpy as np

_GZ_MAGIC = b"\x1f\x8b"
_BLOCK = 1 << 20


@dataclasses.dataclass
class SeqRecord:
    name: str
    comment: str
    seq: np.ndarray            # uint8 ASCII, case preserved
    qual: Optional[bytes] = None

    @property
    def header(self) -> str:
        return f"{self.name} {self.comment}" if self.comment else self.name


def _open_text_stream(path: str) -> io.BufferedReader:
    f = open(path, "rb")
    magic = f.read(2)
    f.seek(0)
    if magic == _GZ_MAGIC:
        return io.BufferedReader(gzip.GzipFile(fileobj=f), buffer_size=_BLOCK)
    return io.BufferedReader(f, buffer_size=_BLOCK)


def _split_header(line: bytes) -> tuple[str, str]:
    body = line[1:].strip()
    sp = -1
    for i, c in enumerate(body):
        if c in (0x20, 0x09):
            sp = i
            break
    if sp < 0:
        return body.decode(), ""
    return body[:sp].decode(), body[sp + 1 :].strip().decode()


def _split_native(hdr: str) -> tuple[str, str]:
    sp = min((i for i in (hdr.find(" "), hdr.find("\t")) if i >= 0), default=-1)
    return (hdr, "") if sp < 0 else (hdr[:sp], hdr[sp + 1:].strip())


def read_fastx(path: str) -> Iterator[SeqRecord]:
    """Yield records from a FASTA or FASTQ file, optionally gzipped,
    through the batch reader (io/native.py).

    Format is auto-detected from the first byte ('>' FASTA, '@' FASTQ),
    like kseq.  Malformed input raises ValueError.  A record's ``seq`` is a
    view into its batch.
    """
    from ntedit_tpu_torch.io import native

    for seq_bytes, offs, hdrs, quals in native.read_batches(path):
        for i, hdr in enumerate(hdrs):
            name, comment = _split_native(hdr)
            qual = None if quals is None else quals[offs[i]: offs[i + 1]].tobytes()
            yield SeqRecord(name, comment, seq_bytes[offs[i]: offs[i + 1]], qual)


def read_fastx_plain(path: str) -> Iterator[SeqRecord]:
    """``read_fastx`` in pure Python, reading lines from a buffered
    (gzip) stream."""
    with _open_text_stream(path) as f:
        first = f.peek(1)[:1]
        if first == b">":
            yield from _read_fasta(f)
        elif first == b"@":
            yield from _read_fastq(f)
        elif not first:
            return
        else:
            raise ValueError(f"{path}: not FASTA/FASTQ (starts with {first!r})")


def _read_fasta(f) -> Iterator[SeqRecord]:
    name = comment = None
    chunks: list[bytes] = []
    for line in f:
        if line.startswith(b">"):
            if name is not None:
                yield SeqRecord(name, comment, _cat(chunks))
            name, comment = _split_header(line)
            chunks = []
        else:
            s = line.strip()
            if s:
                chunks.append(s)
    if name is not None:
        yield SeqRecord(name, comment, _cat(chunks))


def _read_fastq(f) -> Iterator[SeqRecord]:
    while True:
        hdr = f.readline()
        if not hdr:
            return
        if hdr.strip() == b"":
            continue
        if not hdr.startswith(b"@"):
            raise ValueError(f"malformed FASTQ header: {hdr[:40]!r}")
        name, comment = _split_header(hdr)
        seq = f.readline().strip()
        plus = f.readline()
        if not plus.startswith(b"+"):
            raise ValueError("malformed FASTQ: missing '+' line")
        qual = f.readline().strip()
        yield SeqRecord(name, comment, np.frombuffer(seq, dtype=np.uint8), qual)


def _cat(chunks: list[bytes]) -> np.ndarray:
    return np.frombuffer(b"".join(chunks), dtype=np.uint8)


def count_records(path: str) -> int:
    """Number of records in a FASTA/FASTQ(.gz) file, by the batch reader
    without headers: the records ``read_fastx`` yields.  The multi-host
    runtime splits the contigs by it (parallel.distributed.process_slice)."""
    from ntedit_tpu_torch.io import native

    return sum(len(offs) - 1 for _, offs, _, _ in native.read_batches(path, want_headers=False))


def write_fasta(path: str, records) -> None:
    """Write (header, seq) pairs, full sequence on one line (the
    reference's output layout, ntedit.cpp:1168)."""
    with open(path, "w") as f:
        for header, seq in records:
            f.write(f">{header}\n")
            f.write(bytes(seq).decode() + "\n")
