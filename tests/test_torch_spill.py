"""The torch port's per-contig record spill (io/spill.py, cli._run_engine),
on the CPU, as tests/test_spill.py holds the JAX package's: a run killed
mid-way resumes from the spill and writes output byte-identical to an
uninterrupted run; a stale spill (parameter or input drift) is discarded,
not resumed; with -t 4 (two contigs in flight) the spilled run equals the
run without; and ``--spill auto``, the default, spills only drafts above
256 MB (uncompressed, estimated from the gzip trailer)."""

import gzip
import os

import numpy as np
import pytest

from ntedit_tpu_torch import cli
from ntedit_tpu_torch.core import bloom
from ntedit_tpu_torch.engine.polish import Polisher
from ntedit_tpu_torch.io.spill import ContigSpill
from ntedit_tpu_torch.utils import simulate


@pytest.fixture()
def corpus(tmp_path):
    """6-contig draft + truth filter on disk."""
    k = 25
    contigs = []
    bf = bloom.KmerBloomFilter.zeros(1 << 18, 3, k)
    for s in range(6):
        truth = simulate.random_genome(8_000, seed=100 + s)
        draft, _ = simulate.inject_errors(truth, seed=200 + s)
        contigs.append(draft)
        bf.insert_seq(truth)
    draft_path = str(tmp_path / "draft.fa")
    with open(draft_path, "w") as f:
        for i, seq in enumerate(contigs):
            f.write(f">ctg{i} sim\n" + seq.tobytes().decode() + "\n")
    bf_path = str(tmp_path / "truth.bf")
    bf.save(bf_path)
    return draft_path, bf_path


def _outputs(prefix):
    out = {}
    for suffix in ("_edited.fa", "_changes.tsv", "_variants.vcf"):
        with open(prefix + suffix, "rb") as f:
            out[suffix] = f.read()
    return out


def run(bf_path, draft_path, prefix, **kw):
    return cli._run_engine(bf_path, draft_path, prefix, device="cpu", **kw)


def counting_calls(monkeypatch):
    real = Polisher.polish_contig
    polished = []

    def counted(self, header, seq):
        polished.append(header)
        return real(self, header, seq)

    monkeypatch.setattr(Polisher, "polish_contig", counted)
    return polished


def test_kill_and_resume_byte_identical(tmp_path, corpus, monkeypatch):
    draft_path, bf_path = corpus
    monkeypatch.chdir(tmp_path)
    run(bf_path, draft_path, "clean", threads=1, spill="off")
    want = _outputs("clean")

    # interrupted run: die after 3 contigs (a simulated kill)
    real = Polisher.polish_contig
    calls = {"n": 0}

    def dying(self, header, seq):
        if calls["n"] >= 3:
            raise KeyboardInterrupt("simulated kill")
        calls["n"] += 1
        return real(self, header, seq)

    monkeypatch.setattr(Polisher, "polish_contig", dying)
    with pytest.raises(KeyboardInterrupt):
        run(bf_path, draft_path, "out", threads=1, spill="on")
    assert os.path.isdir("out_spill")
    n_spilled = len([n for n in os.listdir("out_spill") if n.endswith(".rec")])
    assert 1 <= n_spilled <= 3

    # resume: only the remaining contigs are polished
    monkeypatch.setattr(Polisher, "polish_contig", real)
    polished = counting_calls(monkeypatch)
    run(bf_path, draft_path, "out", threads=1, spill="on")
    assert len(polished) == 6 - n_spilled
    assert _outputs("out") == want
    assert not os.path.isdir("out_spill")  # removed on success


def test_stale_spill_discarded(tmp_path, corpus, monkeypatch):
    draft_path, bf_path = corpus
    monkeypatch.chdir(tmp_path)
    run(bf_path, draft_path, "a", threads=1, spill="on")
    want = _outputs("a")

    # a spill from a run with other parameters (-x) must not resume into
    # a run with the default -x
    monkeypatch.setenv("NTEDIT_TPU_KEEP_SPILL", "1")
    run(bf_path, draft_path, "a", threads=1, spill="on", x=2.0)
    assert os.path.isdir("a_spill")
    monkeypatch.delenv("NTEDIT_TPU_KEEP_SPILL")

    polished = counting_calls(monkeypatch)
    run(bf_path, draft_path, "a", threads=1, spill="on")
    assert len(polished) == 6  # stale records discarded, all re-polished
    assert _outputs("a") == want


def test_spill_with_threads_matches_spill_off(tmp_path, corpus, monkeypatch):
    """Spill on with -t 4 (two contigs in flight) and a record resumed out of
    the middle still merge in input order, byte-identical to spill off."""
    draft_path, bf_path = corpus
    monkeypatch.chdir(tmp_path)
    run(bf_path, draft_path, "t4off", threads=4, spill="off")
    want = _outputs("t4off")
    monkeypatch.setenv("NTEDIT_TPU_KEEP_SPILL", "1")
    run(bf_path, draft_path, "t4on", threads=4, spill="on")
    assert _outputs("t4on") == want
    monkeypatch.delenv("NTEDIT_TPU_KEEP_SPILL")
    for name in ("00000000.rec", "00000003.rec", "00000004.rec"):
        os.unlink(os.path.join("t4on_spill", name))
    polished = counting_calls(monkeypatch)
    run(bf_path, draft_path, "t4on", threads=4, spill="on")
    assert polished == ["ctg0 sim", "ctg3 sim", "ctg4 sim"]
    assert _outputs("t4on") == want


def test_spill_auto_threshold(tmp_path, corpus, monkeypatch):
    """auto spills above SPILL_AUTO_BYTES of (estimated) uncompressed
    draft; on always, off never.  It is the default of every subcommand."""
    draft_path, bf_path = corpus
    monkeypatch.chdir(tmp_path)
    size = os.path.getsize(draft_path)
    assert cli._estimated_draft_bytes(draft_path) == size
    gz = str(tmp_path / "draft.fa.gz")
    with open(draft_path, "rb") as src, gzip.open(gz, "wb") as dst:
        dst.write(src.read())
    assert cli._estimated_draft_bytes(gz) == size  # the gzip trailer's ISIZE
    cfg = Polisher(bloom.load_any(bf_path), device="cpu").cfg
    args = (cfg, draft_path, bf_path, None, None)
    assert cli._open_spill("auto", "p", *args) is None
    assert cli._open_spill("off", "p", *args) is None
    assert isinstance(cli._open_spill("on", "p", *args), ContigSpill)
    monkeypatch.setattr(cli, "SPILL_AUTO_BYTES", size - 1)
    assert isinstance(cli._open_spill("auto", "q", *args), ContigSpill)
    assert cli._open_spill("auto", "r", cfg, gz, bf_path, None, None) is not None
    parser = cli.build_parser()
    for argv in (["engine", "-r", "x.bf", "-f", "y.fa"],
                 ["polish", "--draft", "y.fa", "--reads", "r", "-k", "25"],
                 ["snv", "--reference", "y.fa", "--genome", "g.fa", "-k", "25"]):
        assert parser.parse_args(argv).spill == "auto"
    # auto above the threshold spills through the CLI, and cleans up after
    polished = counting_calls(monkeypatch)
    cli.main(["engine", "-r", bf_path, "-f", draft_path, "-b", "auto", "-t", "1",
              "--device", "cpu"])
    assert len(polished) == 6 and not os.path.isdir("auto_spill")
    run(bf_path, draft_path, "off", threads=1, spill="off")
    assert _outputs("auto") == _outputs("off")


def test_truncated_record_is_not_resumed(tmp_path):
    sp = ContigSpill(str(tmp_path / "p"), {"x": 1})
    seq = np.frombuffer(b"ACGT" * 10, np.uint8)
    crc = sp.crc(seq)
    sp.put(0, "h", 40, crc, ">h\nACGT\n", "row\n", "")
    assert sp.get(0, "h", 40, crc) == (">h\nACGT\n", "row\n", "")
    assert sp.get(0, "other", 40, crc) is None
    path = os.path.join(sp.dir, "00000000.rec")
    with open(path, "rb") as f:
        data = f.read()
    with open(path, "wb") as f:
        f.write(data[:-3])
    assert sp.get(0, "h", 40, crc) is None
    assert ContigSpill(str(tmp_path / "p"), {"x": 2}).get(0, "h", 40, crc) is None
