"""The torch port's ``engine`` CLI (on the CPU) reproduces the reference
goldens of the demo (demo/runme.sh steps 1-7: default, -m 1, counting
-p 2 -q 254, -a 1, SNV against the read filter and against a genome
filter, and the -l annotation join), byte for byte.  The demo filters are
built with the JAX package's host bfbuild."""

import gzip
import os
import subprocess
import sys

import pytest

DEMO = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "demo")


@pytest.fixture(scope="module")
def demo_dir(tmp_path_factory):
    from ntedit_tpu.core import bfbuild

    d = tmp_path_factory.mktemp("torch_demo")
    subprocess.run([sys.executable, os.path.join(DEMO, "make_demo.py"), str(d)],
                   check=True, capture_output=True)
    reads = [str(d / "demoReads_1.fq.gz")]
    hist = bfbuild.count_histogram(reads, 25)
    for counts, name in ((False, "demoReads_k25.bf"), (True, "demoReads_k25.cbf")):
        filt, _, _ = bfbuild.build_read_filter(reads, 25, cutoff=2, solid=False, fpr=0.01,
                                               counts=counts, hist=hist)
        filt.save(str(d / name))
    # make-genome-bf's defaults (demo step 6)
    bfbuild.build_genome_bf([str(d / "demo_genome.fa")], 25).save(str(d / "demo_genome_k25.bf"))
    return d


def run_engine(d, *args):
    from ntedit_tpu_torch import cli

    cwd = os.getcwd()
    os.chdir(d)
    try:
        cli.main(["engine", "-f", "demo_draft.fa", "--device", "cpu", *args])
    finally:
        os.chdir(cwd)


def read(path):
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        return f.read()


def novcf(data):
    return b"".join(l for l in data.splitlines(True)
                    if not l.startswith((b"##source=", b"##fileDate=")))


def test_default_mode_goldens(demo_dir):
    run_engine(demo_dir, "-r", "demoReads_k25.bf", "-b", "ntedit_k25")
    assert read(str(demo_dir / "ntedit_k25_edited.fa")) == read(
        os.path.join(DEMO, "golden_edited.fa.gz"))
    assert read(str(demo_dir / "ntedit_k25_changes.tsv")) == read(
        os.path.join(DEMO, "golden_changes.tsv"))
    assert novcf(read(str(demo_dir / "ntedit_k25_variants.vcf"))) == read(
        os.path.join(DEMO, "golden_variants.vcf"))


def test_mode1_golden(demo_dir):
    run_engine(demo_dir, "-r", "demoReads_k25.bf", "-b", "mode1", "-t", "1", "-i", "5",
               "-d", "5", "-m", "1")
    assert read(str(demo_dir / "mode1_changes.tsv")) == read(
        os.path.join(DEMO, "golden_mode1_changes.tsv"))


def test_counting_golden(demo_dir):
    run_engine(demo_dir, "-r", "demoReads_k25.cbf", "-b", "cbf", "-t", "1", "-i", "5",
               "-d", "5", "-p", "2", "-q", "254")
    assert read(str(demo_dir / "cbf_changes.tsv")) == read(
        os.path.join(DEMO, "golden_cbf_changes.tsv"))


def test_mask_golden(demo_dir):
    run_engine(demo_dir, "-r", "demoReads_k25.bf", "-b", "mask", "-t", "1", "-i", "5",
               "-d", "5", "-a", "1")
    assert read(str(demo_dir / "mask_edited.fa")) == read(
        os.path.join(DEMO, "golden_mask_edited.fa.gz"))


@pytest.mark.parametrize("bf,golden", [
    ("demoReads_k25.bf", "golden_snv_reads_variants.vcf"),
    ("demo_genome_k25.bf", "golden_snv_genome_variants.vcf"),
])
@pytest.mark.parametrize("threads", ["1", "4"])
def test_snv_goldens(demo_dir, bf, golden, threads):
    """Demo steps 5 and 6 (-t 1 there); -t 4 takes the segmented repair."""
    prefix = f"snv{threads}_{bf.split('_')[0]}"
    run_engine(demo_dir, "-r", bf, "-b", prefix, "-t", threads, "-s", "1")
    assert novcf(read(str(demo_dir / f"{prefix}_variants.vcf"))) == read(
        os.path.join(DEMO, golden))


def test_annotation_golden(demo_dir):
    """Demo step 7: the -l join with a ClinVar-style VCF."""
    run_engine(demo_dir, "-r", "demoReads_k25.bf", "-b", "annot", "-t", "1", "-i", "5",
               "-d", "5", "-l", os.path.join(DEMO, "demo_annot.vcf"))
    out = read(str(demo_dir / "annot_variants.vcf"))
    assert novcf(out) == read(os.path.join(DEMO, "golden_annot_variants.vcf"))
    assert b"CLNSIG=Pathogenic" in out


def test_snv_banner(demo_dir, capsys):
    run_engine(demo_dir, "-r", "demoReads_k25.bf", "-b", "snvb", "-t", "2", "-s", "1")
    out = capsys.readouterr().out
    assert " -s 1\n" in out and " -i 0\n -d 0\n" in out


def test_banner_and_default_prefix(demo_dir, capsys):
    """The JAX package's banner and auto-composed output prefix."""
    run_engine(demo_dir, "-r", "demoReads_k25.bf", "-t", "2")
    out = capsys.readouterr().out
    prefix = "demo_draft.fa_k25_z100_rdemoReads_k25.bf_i5_d5_m0"
    assert out.startswith("running: ntEditTPU v0.1.0\n -f demo_draft.fa\n -k 25\n")
    assert f" -b {prefix}\n" in out and " -s 0\n" in out and " -v 0\n" in out
    for suffix in ("_edited.fa", "_changes.tsv", "_variants.vcf"):
        assert os.path.exists(demo_dir / (prefix + suffix))


@pytest.mark.parametrize("argv", [
    ["engine", "-r", "x.bf", "-f", "y.fa", "-v", "1"],
    ["engine", "-r", "x.bf", "-f", "y.fa", "--spill", "on"],
    ["polish", "--draft", "y.fa", "--reads", "r", "-k", "25"],
    ["snv", "--reference", "y.fa"],
    ["make-genome-bf", "--genome", "y.fa", "-k", "25"],
])
def test_not_ported_raise(argv):
    from ntedit_tpu_torch import cli

    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        cli.main(argv)
