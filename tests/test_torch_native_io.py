"""The torch port's batch reader (io/native.py over csrc/fastx_reader.cpp)
on the CPU: its records against the port's plain reader and the JAX
package's ``read_fastx`` (plain and gzip FASTA and FASTQ, multi-line FASTA,
lowercase and IUPAC bytes, an empty record, headers with tabs, more
records than one batch holds, records larger than one 16 MiB batch or
straddling its end); malformed and truncated input raising, and so does a
failed build; gzip members decoded by csrc/inflate.h against the same
members read by zlib's gzread, on every layout of members, in stretches
under a cap that a member passes and with gzread reading on from a block
over it, a bad CRC, ISIZE or a cut member raising on both paths, the
counters of decoded bytes by inflater, seeded fuzzing of the inflater
against zlib, and a buffer that cannot be mapped; the filter build's pieces
against the old per-record ones, byte for byte; and the one read of the
reads: with the pieces kept on the device each file is opened once, with
a budget of 0 once per pass, and the histogram, the filter and the
counting filter are equal either way and equal to the JAX package's."""

import gzip
import struct
import zlib

import numpy as np
import pytest

from ntedit_tpu_torch.core import bfbuild
from ntedit_tpu_torch.io import fastx, native
from ntedit_tpu_torch.utils import profiling

ACGT = np.frombuffer(b"ACGT", np.uint8)
# the builds' pieces: three of the read files' 180 kB (few torch calls a pass)
SMALL_BATCH = 1 << 16


def records_of(recs):
    return [(r.name, r.comment, bytes(r.seq), None if r.qual is None else bytes(r.qual))
            for r in recs]


def write(path, data: bytes):
    if str(path).endswith(".gz"):
        with gzip.open(path, "wb") as f:
            f.write(data)
    else:
        path.write_bytes(data)
    return str(path)


def fasta_text(rng, n=60, width=None) -> bytes:
    out = []
    for i in range(n):
        s = ACGT[rng.integers(0, 4, size=int(rng.integers(0, 400)))].copy()
        if i % 4 == 1 and len(s) > 20:
            s[5:15] |= 0x20  # lowercase
        if i % 5 == 2 and len(s) > 5:
            s[3] = b"RYSWKMBDHVN"[i % 11]
        body = s.tobytes()
        if width:
            body = b"\n".join(body[j:j + width] for j in range(0, len(body), width))
        comment = f" contig {i}\tlen={len(s)}" if i % 3 else ""
        out.append(f">c{i}{comment}\n".encode() + body + b"\n")
    return b"".join(out)


def fastq_text(rng, n=200) -> bytes:
    out = []
    for i in range(n):
        s = ACGT[rng.integers(0, 4, size=int(rng.integers(1, 160)))].copy()
        if i % 7 == 0:
            s[0] = ord("N")
        q = bytes(33 + rng.integers(0, 40, size=len(s)).astype(np.uint8))
        plus = b"+" if i % 2 else b"+r%d" % i
        out.append(b"@r%d lane%d\n%s\n%s\n%s\n" % (i, i % 3, s.tobytes(), plus, q))
    return b"".join(out)


CORPORA = {
    "fasta": lambda rng: fasta_text(rng),
    "fasta_multiline": lambda rng: fasta_text(rng, width=70),
    "fasta_empty_records": lambda rng: b">a\n>b desc\nACGTNNRYacgt\n>c\n\n>d\nGG\n",
    "fastq": lambda rng: fastq_text(rng),
    "fastq_crlf": lambda rng: fastq_text(rng, 20).replace(b"\n", b"\r\n"),
}


@pytest.mark.parametrize("gz", [False, True])
@pytest.mark.parametrize("corpus", sorted(CORPORA))
def test_reader_matches_plain_and_jax(tmp_path, corpus, gz):
    from ntedit_tpu.io import fastx as jfastx

    data = CORPORA[corpus](np.random.default_rng(len(corpus)))
    path = write(tmp_path / ("x.fa.gz" if gz else "x.fa"), data)
    got = records_of(fastx.read_fastx(path))
    assert got == records_of(fastx.read_fastx_plain(path))
    assert got == records_of(jfastx.read_fastx(path))
    assert len(got) >= 4


def test_more_records_than_one_batch(tmp_path):
    """40,000 reads: more than the 32,768 records of one batch."""
    rng = np.random.default_rng(2)
    path = write(tmp_path / "many.fq.gz", fastq_text(rng, 40_000))
    batches = list(native.read_batches(path, want_headers=False))
    assert len(batches) == 2 and batches[0][2] is None
    assert records_of(fastx.read_fastx(path)) == records_of(fastx.read_fastx_plain(path))


@pytest.mark.parametrize("layout", ["alone", "straddling"])
def test_records_larger_than_a_batch(tmp_path, layout):
    """A 20 MiB record (its own batch, the buffers grown for it) and three
    7 MiB ones (the third does not fit after two: it begins the next
    batch), each between short records: every record is read whole."""
    rng = np.random.default_rng(3)
    sizes = [20 << 20] if layout == "alone" else [7 << 20] * 3
    parts = [b">first\nACGT\n"]
    for i, n in enumerate(sizes):
        seq = ACGT[rng.integers(0, 4, size=n)].tobytes()
        parts.append(b">big%d a long one\n%s\n" % (i, seq))
    parts.append(b">last\nGGGG\n")
    path = write(tmp_path / "big.fa", b"".join(parts))
    got = records_of(fastx.read_fastx(path))
    assert got == records_of(fastx.read_fastx_plain(path))
    assert [len(r[2]) for r in got] == [4, *sizes, 4]
    assert len(list(native.read_batches(path))) == 2


@pytest.mark.parametrize("data,error", [
    (b"hello\nACGT\n", ValueError),
    (b"@r1\nACGT\nIIII\nIIII\n", ValueError),   # no '+' line
    (b"@r1\nACGT\n+\nIII\n", ValueError),       # quality shorter than the sequence
    (b"@r1\nACGT\n", ValueError),               # a record cut short
])
def test_malformed_input_raises(tmp_path, data, error):
    path = write(tmp_path / "bad.fq", data)
    with pytest.raises(error):
        list(fastx.read_fastx(path))


def test_truncated_gzip_and_missing_file_raise(tmp_path):
    whole = gzip.compress(fastq_text(np.random.default_rng(4), 3000))
    path = tmp_path / "cut.fq.gz"
    path.write_bytes(whole[: len(whole) // 2])
    with pytest.raises((OSError, ValueError)):
        list(fastx.read_fastx(str(path)))
    with pytest.raises(OSError, match="cannot open"):
        list(fastx.read_fastx(str(tmp_path / "missing.fa")))


@pytest.mark.parametrize("failure", ["build", "load"])
def test_reader_raises_when_the_library_is_missing(tmp_path, monkeypatch, failure):
    """No silent fallback to the plain reader: a build that fails raises
    with the compiler's output, a library that does not load raises."""
    from ntedit_tpu_torch.utils import build

    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path / "out"))
    monkeypatch.setattr(native, "_lib", None)
    if failure == "build":
        stub = tmp_path / "stub.cpp"
        stub.write_text("this does not compile\n")
        monkeypatch.setattr(native, "SOURCE", str(stub))
        with pytest.raises(RuntimeError, match="stub.cpp"):
            list(fastx.read_fastx(write(tmp_path / "x.fa", b">a\nACGT\n")))
    else:
        stub = tmp_path / "libstub.so"
        stub.write_bytes(b"not a shared library")
        monkeypatch.setattr(native, "build", lambda force=False: str(stub))
        with pytest.raises(OSError):
            list(fastx.read_fastx(write(tmp_path / "x.fa", b">a\nACGT\n")))


# ---------------------------------------------------------------------------
# gzip members decoded whole against the zlib stream
# ---------------------------------------------------------------------------

def deflate_member(data: bytes, level=6, extra: bytes = b"") -> bytes:
    """One gzip member of ``data``; ``extra`` goes in an FEXTRA field."""
    c = zlib.compressobj(level, zlib.DEFLATED, -15)
    body = c.compress(data) + c.flush()
    head = b"\x1f\x8b\x08" + (b"\x04" if extra else b"\x00") + b"\0\0\0\0\0\xff"
    if extra:
        head += struct.pack("<H", len(extra)) + extra
    return head + body + struct.pack("<II", zlib.crc32(data), len(data) & 0xFFFFFFFF)


def bgzf_member(data: bytes) -> bytes:
    """A BGZF block: the "BC" subfield holds the block's size less one."""
    size = len(deflate_member(data, 6, b"BC\x02\x00\x00\x00"))
    return deflate_member(data, 6, b"BC\x02\x00" + struct.pack("<H", size - 1))


def gzip_member(data: bytes, body: bytes) -> bytes:
    """A gzip member of the raw deflate stream ``body`` of ``data``."""
    head = b"\x1f\x8b\x08\x00\0\0\0\0\0\xff"
    return head + body + struct.pack("<II", zlib.crc32(data), len(data) & 0xFFFFFFFF)


def sync_member(data: bytes, cuts, level=6, wbits=-15, mem=8, strategy=0) -> bytes:
    """One member of ``data`` in blocks that end at ``cuts`` (a sync flush
    each: matches still reach across them)."""
    c = zlib.compressobj(level, zlib.DEFLATED, wbits, mem, strategy)
    body = b"".join(c.compress(data[a:b]) + c.flush(zlib.Z_SYNC_FLUSH)
                    for a, b in zip(cuts, cuts[1:]))
    return gzip_member(data, body + c.flush())


def stored_tail_member(data: bytes, head: int) -> bytes:
    """One member: ``data[:head]`` in small blocks, the rest in stored
    blocks of 65,531 bytes (level 0), in one deflate stream."""
    c = zlib.compressobj(6, zlib.DEFLATED, -15)
    body = b"".join(c.compress(data[a:a + 2000]) + c.flush(zlib.Z_SYNC_FLUSH)
                    for a in range(0, head, 2000))
    c = zlib.compressobj(0, zlib.DEFLATED, -15)
    return gzip_member(data, body + c.compress(data[head:]) + c.flush())


def gzip_layout(layout: str, data: bytes) -> bytes:
    half = len(data) // 2
    cut = data.index(b"\n", half) + 1 if layout != "bgzf" else half
    if layout == "one_member":
        return deflate_member(data, 1)
    if layout == "two_members":
        return deflate_member(data[:cut], 1) + deflate_member(data[cut:], 9)
    if layout == "bgzf":  # 64 KiB blocks that cut records anywhere, and the empty last block
        blocks = [bgzf_member(data[i:i + (1 << 16)]) for i in range(0, len(data), 1 << 16)]
        return b"".join(blocks) + bgzf_member(b"")
    if layout == "empty_member":
        return deflate_member(b"") + deflate_member(data[:cut]) + deflate_member(b"") + \
            deflate_member(data[cut:])
    if layout == "zeros_after":
        return deflate_member(data) + b"\0" * 1000
    if layout == "over_cap":  # one member over the cap the test sets, in blocks under it
        return sync_member(data, [*range(0, len(data), 4000), len(data)])
    if layout == "block_over_cap":  # then a member whose stored blocks pass the cap
        return sync_member(data[:cut], [*range(0, cut, 4000), cut]) + \
            stored_tail_member(data[cut:], 30_000)
    raise ValueError(layout)


def read_with(path, cap, monkeypatch):
    """The records, and the decoded bytes by path, with ``WHOLE_CAP`` = cap."""
    monkeypatch.setattr(native, "WHOLE_CAP", cap)
    with profiling.recording() as rec:
        got = records_of(fastx.read_fastx(path))
    return got, (rec.counters.get("io.inflate_whole_bytes", 0),
                 rec.counters.get("io.inflate_stream_bytes", 0))


def big_fastq(rng) -> bytes:
    """~550 kB: a file of several BGZF blocks, CRLF in a share of it, and
    reads of one quality byte (long matches, as in a simulator's files)."""
    text = fastq_text(rng, 3000)
    reads = ACGT[rng.integers(0, 4, size=(2000, 100))]
    flat = b"".join(b"@s%07d/1\n%s\n+\n%s\n" % (i, r.tobytes(), b"I" * 100)
                    for i, r in enumerate(reads))
    return text[:100_000] + text[100_000:140_000].replace(b"\n", b"\r\n") + text[140_000:] + flat


@pytest.mark.parametrize("layout", ["one_member", "two_members", "bgzf", "empty_member",
                                    "zeros_after", "over_cap", "block_over_cap"])
def test_whole_members_match_the_stream(tmp_path, monkeypatch, layout):
    """Every layout of members reads as zlib's stream reads it.  Under a
    cap of 10,000 bytes a member is decoded in stretches of whole blocks;
    from a block that passes the cap, gzread reads on, and what it
    decodes counts as streamed."""
    data = big_fastq(np.random.default_rng(11))
    path = tmp_path / "x.fq.gz"
    path.write_bytes(gzip_layout(layout, data))
    path = str(path)
    want = records_of(fastx.read_fastx_plain(path))
    cap = 10_000 if layout.endswith("over_cap") else native.WHOLE_CAP
    whole, (w_bytes, w_stream) = read_with(path, cap, monkeypatch)
    stream, (s_whole, s_bytes) = read_with(path, 0, monkeypatch)
    assert whole == stream == want and len(want) > 1000
    assert s_whole == 0 and s_bytes == len(data)
    if layout == "block_over_cap":  # the switch at the first stored block
        switch = data.index(b"\n", len(data) // 2) + 1 + 30_000
        assert (w_bytes, w_stream) == (switch, len(data) - switch)
    else:
        assert (w_bytes, w_stream) == (len(data), 0)


@pytest.mark.parametrize("big", ["alone", "straddling"])
def test_whole_member_records_larger_than_a_batch(tmp_path, monkeypatch, big):
    """A multi-line FASTA of a 20 MiB record, or of three 7 MiB ones, in
    two members cut inside a record: whole and streamed, every record whole."""
    rng = np.random.default_rng(12)
    sizes = [20 << 20] if big == "alone" else [7 << 20] * 3
    parts = [b">first\nACGT\n"]
    for i, n in enumerate(sizes):
        seq = ACGT[rng.integers(0, 4, size=n)].tobytes()
        parts.append(b">big%d\n%s\n" % (i, b"\n".join(seq[j:j + 80] for j in range(0, n, 80))))
    parts.append(b">last\nGGGG\n")
    data = b"".join(parts)
    cut = len(data) // 3
    path = tmp_path / "big.fa.gz"
    path.write_bytes(deflate_member(data[:cut], 1) + deflate_member(data[cut:], 1))
    whole, (w_bytes, _) = read_with(str(path), native.WHOLE_CAP, monkeypatch)
    stream, _ = read_with(str(path), 0, monkeypatch)
    assert whole == stream and [len(r[2]) for r in whole] == [4, *sizes, 4]
    assert w_bytes == len(data)


@pytest.mark.parametrize("cap", ["whole", "stream"])
@pytest.mark.parametrize("fault", ["crc", "isize", "cut"])
def test_bad_members_raise_on_both_paths(tmp_path, monkeypatch, fault, cap):
    data = fastq_text(np.random.default_rng(13), 3000)
    second = bytearray(deflate_member(data))
    if fault == "crc":
        second[-8] ^= 1
    elif fault == "isize":
        second[-4] ^= 1
    else:
        second = second[: len(second) // 2]
    path = tmp_path / "bad.fq.gz"
    path.write_bytes(deflate_member(data) + bytes(second))
    monkeypatch.setattr(native, "WHOLE_CAP", native.WHOLE_CAP if cap == "whole" else 0)
    with pytest.raises(OSError):
        list(fastx.read_fastx(str(path)))


@pytest.mark.parametrize("gz", [False, True])
def test_inflate_counters(tmp_path, monkeypatch, gz):
    """All of a gzip file's bytes are decoded whole under the default cap,
    all streamed under a cap of 0; a plain file counts in neither."""
    data = fastq_text(np.random.default_rng(14), 500)
    path = write(tmp_path / ("x.fq.gz" if gz else "x.fq"), data)
    _, default = read_with(path, native.WHOLE_CAP, monkeypatch)
    _, zero = read_with(path, 0, monkeypatch)
    assert default == ((len(data), 0) if gz else (0, 0))
    assert zero == ((0, len(data)) if gz else (0, 0))
    assert "zlib" in native.inflater()


@pytest.mark.parametrize("corpus", sorted(CORPORA))
def test_streamed_reader_matches_on_every_corpus(tmp_path, monkeypatch, corpus):
    """With the whole path off (a cap of 0), as where a member passes the
    cap, every gzip corpus reads as it does whole and as the plain reader
    reads it, and every byte counts as streamed."""
    data = CORPORA[corpus](np.random.default_rng(len(corpus)))
    path = write(tmp_path / "x.fa.gz", data)
    stream, counts = read_with(path, 0, monkeypatch)
    assert stream == records_of(fastx.read_fastx_plain(path))
    assert stream == read_with(path, native.WHOLE_CAP, monkeypatch)[0]
    assert counts == (0, len(data))


def fuzz_records(rng, fq: bool) -> bytes:
    """FASTA or FASTQ whose bytes take every copy of the decoder: random
    bases (literals), runs of one byte (distance 1), periods of 2-40 bytes,
    and repeats of earlier records (long matches)."""
    recs = []
    for i in range(int(rng.integers(1, 60))):
        n, kind = int(rng.integers(1, 3000)), int(rng.integers(0, 4))
        if kind == 0:
            s = ACGT[rng.integers(0, 4, size=n)].tobytes()
        elif kind == 1:
            s = b"ACGT"[int(rng.integers(0, 4))].to_bytes(1, "little") * n
        elif kind == 2:
            s = (ACGT[rng.integers(0, 4, size=int(rng.integers(2, 41)))].tobytes() * n)[:n]
        else:
            s = recs[int(rng.integers(0, len(recs)))][1] if recs else b"N" * n
        recs.append((b"r%d x%d" % (i, kind), s))
    if fq:
        return b"".join(b"@%s\n%s\n+\n%s\n" % (h, s, b"I" * len(s)) for h, s in recs)
    return b"".join(b">%s\n%s\n" % (h, b"\n".join(s[j:j + 61] for j in range(0, len(s), 61)))
                    for h, s in recs)


def outcome(path):
    """What native.read_batches gives: its batches, or the error's class."""
    try:
        return [(bytes(s), o.tolist(), h, None if q is None else bytes(q))
                for s, o, h, q in native.read_batches(path)]
    except (OSError, ValueError) as e:
        return type(e).__name__


STRATEGIES = {"default": zlib.Z_DEFAULT_STRATEGY, "filtered": zlib.Z_FILTERED,
              "huffman_only": zlib.Z_HUFFMAN_ONLY, "rle": zlib.Z_RLE, "fixed": zlib.Z_FIXED}


@pytest.mark.parametrize("strategy", sorted(STRATEGIES))
def test_inflater_fuzz_matches_zlib(tmp_path, monkeypatch, strategy):
    """Seeded fuzzing of csrc/inflate.h against zlib: members at levels 0-9,
    windows of 2^9-2^15 and memory levels 1-9, in blocks of zlib's choice or
    ended by sync flushes; one to three members, bytes after.  Each file
    and 12 random byte, bit and cut mutations of it read under the default
    cap exactly as under a cap of 0 (gzread alone): the same batches or
    the same error.  Under caps of 1-64 KiB (stretches of whole blocks, the
    switch to gzread inside a member) the files read the same, and a
    mutated file raises where gzread raises."""
    rng = np.random.default_rng(sorted(STRATEGIES).index(strategy) + 100)
    path = str(tmp_path / "f.gz")
    mutations = 0
    for _ in range(10):
        members, fq = [], bool(rng.random() < 0.5)
        for _ in range(int(rng.integers(1, 4))):
            data = fuzz_records(rng, fq)
            args = (int(rng.integers(0, 10)), -int(rng.integers(9, 16)),
                    int(rng.integers(1, 10)), STRATEGIES[strategy])
            cuts = [0, *sorted(rng.integers(0, len(data), size=int(rng.integers(0, 30)))),
                    len(data)]
            members.append(sync_member(data, cuts, *args))
        clean = b"".join(members) + [b"", b"\0" * 5, b"junk", b"\x1f"][int(rng.integers(0, 4))]
        for m in range(13):
            f = bytearray(clean)
            if m > 0:
                at = int(rng.integers(0, len(f)))
                kind = m % 3
                if kind == 0:
                    f[at] ^= 1 << int(rng.integers(0, 8))
                elif kind == 1:
                    f[at] = int(rng.integers(0, 256))
                else:
                    del f[at:]
                mutations += 1
            with open(path, "wb") as fh:
                fh.write(f)
            monkeypatch.setattr(native, "WHOLE_CAP", 0)
            want = outcome(path)
            monkeypatch.setattr(native, "WHOLE_CAP", 1 << 30)
            assert outcome(path) == want
            monkeypatch.setattr(native, "WHOLE_CAP", int(rng.integers(1 << 10, 1 << 16)))
            got = outcome(path)
            assert got == want if m == 0 else isinstance(got, str) == isinstance(want, str)
            if m == 0:
                assert not isinstance(want, str)
    assert mutations == 120


def test_reader_reads_on_when_no_buffer_is_had(tmp_path):
    """Where the stretch's buffer cannot be mapped (here an address-space
    limit below the default cap), gzread reads the member instead."""
    import subprocess
    import sys
    data = fastq_text(np.random.default_rng(15), 20_000)
    path = tmp_path / "x.fq.gz"
    path.write_bytes(deflate_member(data, 0))  # ~2.5 MB: room for 1 GiB asked
    prog = (
        "import resource, sys\n"
        "from ntedit_tpu_torch.io import native\n"
        "from ntedit_tpu_torch.utils import profiling\n"
        "native.get_lib()\n"
        "vm = next(int(l.split()[1]) for l in open('/proc/self/status') if l.startswith('VmSize'))\n"
        "limit = vm * 1024 + (256 << 20)\n"
        "resource.setrlimit(resource.RLIMIT_AS, (limit, limit))\n"
        "assert native.whole_cap() > 256 << 20\n"
        "c = {}\n"
        "profiling.count = lambda name, k: c.__setitem__(name, c.get(name, 0) + k)\n"
        "n = sum(len(b[1]) - 1 for b in native.read_batches(sys.argv[1]))\n"
        "print(n, c.get('io.inflate_whole_bytes', 0), c.get('io.inflate_stream_bytes', 0))\n")
    proc = subprocess.run([sys.executable, "-c", prog, str(path)], capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.split() == ["20000", "0", str(len(data))]


# ---------------------------------------------------------------------------
# the filter build's pieces and its one read of the reads
# ---------------------------------------------------------------------------

def old_pieces(paths, k, batch):
    """The per-record joining the build did before the batch reader (its
    records from the plain reader)."""
    step = batch - (k - 1)
    sep = np.zeros(1, np.uint8)
    pend, n = [], 0
    for p in paths:
        for rec in fastx.read_fastx_plain(p):
            pend += (rec.seq, sep)
            n += len(rec.seq) + 1
            if n >= batch:
                buf = np.concatenate(pend)
                s = 0
                while len(buf) - s >= batch:
                    yield buf[s: s + batch]
                    s += step
                pend, n = [buf[s:]], len(buf) - s
    if n >= k:
        yield np.concatenate(pend)


@pytest.fixture(scope="module")
def read_files(tmp_path_factory):
    """Two read files under one prefix (gzip FASTQ and plain FASTA with an
    empty record, N, IUPAC and lowercase bytes) of a 6 kbp genome at about
    30x, with 1% substitutions."""
    from ntedit_tpu_torch.utils import simulate

    d = tmp_path_factory.mktemp("torch_native_io")
    rng = np.random.default_rng(5)
    genome = simulate.random_genome(6000, seed=6)
    reads = []
    for i in range(1800):
        s = int(rng.integers(0, len(genome) - 100))
        r = genome[s: s + 100].copy()
        flip = rng.random(100) < 0.01
        r[flip] = ACGT[rng.integers(0, 4, size=int(flip.sum()))]
        if i % 9 == 0:
            r[int(rng.integers(0, 100))] = ord("N")
        if i % 11 == 0:
            r[10:40] |= 0x20
        if i % 13 == 0:
            r[50] = ord("Y")
        reads.append(r.tobytes())
    fq = b"".join(b"@r%d\n%s\n+\n%s\n" % (i, r, b"I" * len(r)) for i, r in enumerate(reads[:1200]))
    fa = b">e\n\n" + b"".join(b">s%d x\n%s\n" % (i, r) for i, r in enumerate(reads[1200:]))
    return [write(d / "rd_1.fq.gz", fq), write(d / "rd_2.fa", fa)]


@pytest.mark.parametrize("batch", [64, 1000, 9999, bfbuild.BATCH])
def test_pieces_equal_the_per_record_ones(read_files, batch):
    got = list(bfbuild.iter_separated_buffers(read_files, 25, batch))
    want = list(old_pieces(read_files, 25, batch))
    assert len(got) == len(want) > 0
    assert all(np.array_equal(a, b) for a, b in zip(got, want))


def opens_of(paths):
    return [native.read_batches.opens[p] for p in paths]


@pytest.mark.parametrize("counts", [False, True])
def test_one_read_of_the_reads(read_files, counts):
    """The histogram, count and insert passes of one build iterate one
    DeviceBatches: kept, each file is opened once; with budget 0, once per
    pass.  The results are equal either way, and equal to the JAX
    package's host build (the port's plain layout)."""
    from ntedit_tpu.core import bfbuild as jb

    k = 25
    before = opens_of(read_files)
    kept = bfbuild.build_read_filter(read_files, k, counts=counts, layout="plain", device="cpu",
                                     batch=SMALL_BATCH)
    once = opens_of(read_files)
    assert [b - a for a, b in zip(before, once)] == [1, 1]
    reread = bfbuild.build_read_filter(read_files, k, counts=counts, layout="plain",
                                       device="cpu", batch=SMALL_BATCH, budget=0)
    passes = 2 if counts else 3  # histogram, (count,) insert
    assert [b - a for a, b in zip(once, opens_of(read_files))] == [passes, passes]
    jfilt, jhist, jcut = jb.build_read_filter(read_files, k, counts=counts)
    for filt, hist, cutoff in (kept, reread):
        assert (hist.f1, hist.f0, cutoff) == (jhist.f1, jhist.f0, jcut)
        assert np.array_equal(hist.spectrum, jhist.spectrum)
        if counts:
            assert np.array_equal(filt.counters, jfilt.counters)
        else:
            assert np.array_equal(filt.data, jfilt.data)


def test_shared_batches_keep_the_pieces(read_files):
    """One DeviceBatches for the histogram and the blocked build (the CLI's
    two stages): every pass after the first reads the kept pieces, which
    are buffers of their own; the blocked filter equals the one built
    with budget 0."""
    k = 25
    batches = bfbuild.device_batches(read_files, k, "cpu", batch=SMALL_BATCH)
    before = opens_of(read_files)
    with profiling.recording() as rec:
        hist = bfbuild.count_histogram(read_files, k, device="cpu", batches=batches)
        filt, _, _ = bfbuild.build_read_filter(read_files, k, hist=hist, device="cpu",
                                               batches=batches)
    assert [b - a for a, b in zip(before, opens_of(read_files))] == [1, 1]
    read_ns = sum(s.end_ns - s.start_ns for s in rec.spans if s.name == "io.read")
    assert batches.passes == 3 and batches.kept is not None and read_ns > 0
    assert rec.counters["io.read_bases"] == batches.bases()
    ptrs = {seq.data_ptr() for seq, _ in batches.kept}
    assert len(ptrs) == len(batches.kept) > 1
    assert batches.kept_bytes == sum(seq.numel() for seq, _ in batches.kept)
    again, _, _ = bfbuild.build_read_filter(read_files, k, hist=hist, device="cpu",
                                            batch=SMALL_BATCH, budget=0)
    assert np.array_equal(filt.words, again.words)
    over = bfbuild.device_batches(read_files, k, "cpu", batch=SMALL_BATCH,
                                  budget=batches.kept_bytes - 1)
    assert sum(n for _, n in over) == sum(n for _, n in batches.kept) and over.kept is None


def test_genome_filter_reads_its_genome_once(read_files):
    from ntedit_tpu.core import bfbuild as jb

    before = opens_of(read_files)
    got = bfbuild.build_genome_bf(read_files, 25, device="cpu", batch=SMALL_BATCH)
    assert [b - a for a, b in zip(before, opens_of(read_files))] == [1, 1]
    want = jb.build_genome_bf(read_files, 25)
    assert got.bytes == want.bytes and np.array_equal(got.data, want.data)
    batches = bfbuild.device_batches(read_files, 25, "cpu", budget=0)
    assert batches.bases() == sum(len(r.seq) for p in read_files
                                  for r in fastx.read_fastx_plain(p))
