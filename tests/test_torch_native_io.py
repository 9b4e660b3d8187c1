"""The torch port's batch reader (io/native.py over csrc/fastx_reader.cpp)
on the CPU: its records against the port's plain reader and the JAX
package's ``read_fastx`` (plain and gzip FASTA and FASTQ, multi-line FASTA,
lowercase and IUPAC bytes, an empty record, headers with tabs, more
records than one batch holds, records larger than one 16 MiB batch or
straddling its end); malformed and truncated input raising, and so does a
failed build; the filter build's pieces against the old per-record ones,
byte for byte; and the one read of the reads: with the pieces kept on the
device each file is opened once, with a budget of 0 once per pass, and
the histogram, the filter and the counting filter are equal either way
and equal to the JAX package's."""

import gzip

import numpy as np
import pytest
import torch

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
# the filter build's pieces and its one read of the reads
# ---------------------------------------------------------------------------

@pytest.fixture
def one_thread():
    """torch on one thread for the builds' plain passes: these tests run
    beside other test processes, where each pass's many small parallel ops
    would wait on threads the other processes hold."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


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
def test_one_read_of_the_reads(read_files, counts, one_thread):
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


def test_shared_batches_keep_the_pieces(read_files, one_thread):
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


def test_genome_filter_reads_its_genome_once(read_files, one_thread):
    from ntedit_tpu.core import bfbuild as jb

    before = opens_of(read_files)
    got = bfbuild.build_genome_bf(read_files, 25, device="cpu", batch=SMALL_BATCH)
    assert [b - a for a, b in zip(before, opens_of(read_files))] == [1, 1]
    want = jb.build_genome_bf(read_files, 25)
    assert got.bytes == want.bytes and np.array_equal(got.data, want.data)
    batches = bfbuild.device_batches(read_files, 25, "cpu", budget=0)
    assert batches.bases() == sum(len(r.seq) for p in read_files
                                  for r in fastx.read_fastx_plain(p))
