"""The torch port's CLI (on the CPU): the demo's filters built by the port
equal the JAX package's byte for byte, and the ``engine`` subcommand on
them reproduces the reference goldens of the demo (demo/runme.sh steps
1-7: default, -m 1, counting -p 2 -q 254, -a 1, SNV against the read filter
and against a genome filter, and the -l annotation join), byte for byte.
``polish --reads`` and ``snv --genome`` run end to end, with their stage
cache, against the JAX package's CLI with its device build."""

import gzip
import os
import shutil
import subprocess
import sys

import pytest

DEMO = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "demo")
FILTERS = ("demoReads_k25.hist", "demoReads_k25.bf", "demoReads_k25.cbf", "demo_genome_k25.bf")


@pytest.fixture(scope="module")
def demo_dir(tmp_path_factory):
    """The demo inputs, the port's filters under the demo's names and the
    JAX package's host-built ones beside them (``jax_`` prefix)."""
    from ntedit_tpu.core import bfbuild as jb

    from ntedit_tpu_torch.core import bfbuild

    d = tmp_path_factory.mktemp("torch_demo")
    subprocess.run([sys.executable, os.path.join(DEMO, "make_demo.py"), str(d)],
                   check=True, capture_output=True)
    reads = [str(d / "demoReads_1.fq.gz")]
    hist = bfbuild.count_histogram(reads, 25, device="cpu")
    hist.save(str(d / "demoReads_k25.hist"))
    jhist = jb.count_histogram(reads, 25)
    jhist.save(str(d / "jax_demoReads_k25.hist"))
    for counts, name in ((False, "demoReads_k25.bf"), (True, "demoReads_k25.cbf")):
        # the JAX package's host branch: btllib sizes (the goldens' filters)
        filt, _, _ = bfbuild.build_read_filter(reads, 25, cutoff=2, solid=False, fpr=0.01,
                                               counts=counts, hist=hist, layout="plain",
                                               device="cpu")
        filt.save(str(d / name))
        filt, _, _ = jb.build_read_filter(reads, 25, cutoff=2, solid=False, fpr=0.01,
                                          counts=counts, hist=jhist)
        filt.save(str(d / ("jax_" + name)))
    # make-genome-bf's defaults (demo step 6)
    run_cli(d, "make-genome-bf", "--genome", "demo_genome.fa", "-k", "25",
            "-o", "demo_genome_k25.bf", "--device", "cpu")
    jb.build_genome_bf([str(d / "demo_genome.fa")], 25).save(str(d / "jax_demo_genome_k25.bf"))
    return d


def run_cli(d, *argv):
    from ntedit_tpu_torch import cli

    cwd = os.getcwd()
    os.chdir(d)
    try:
        cli.main(list(argv))
    finally:
        os.chdir(cwd)


def run_engine(d, *args):
    run_cli(d, "engine", "-f", "demo_draft.fa", "--device", "cpu", *args)


def read(path):
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        return f.read()


def novcf(data):
    return b"".join(l for l in data.splitlines(True)
                    if not l.startswith((b"##source=", b"##fileDate=")))


@pytest.mark.parametrize("name", FILTERS)
def test_port_builds_the_demo_filters_of_the_jax_package(demo_dir, name):
    """The histogram, the read filter (layout plain: the JAX package's host
    branch), the counting filter and make-genome-bf's filter."""
    assert read(str(demo_dir / name)) == read(str(demo_dir / ("jax_" + name)))


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


@pytest.fixture(scope="module")
def pipeline_dirs(tmp_path_factory):
    """``polish --reads demoReads -k 25`` and ``snv --reference demo_draft.fa
    --genome demo_genome.fa -k 25`` by the port (on the CPU) and by the JAX
    package's CLI with its device build (blocked read filter), each in a
    directory of its own holding the demo inputs."""
    from ntedit_tpu import cli as jcli

    dirs = {}
    for who in ("port", "jax"):
        d = tmp_path_factory.mktemp(f"pipeline_{who}")
        subprocess.run([sys.executable, os.path.join(DEMO, "make_demo.py"), str(d)],
                       check=True, capture_output=True)
        dirs[who] = d
    polish = ["polish", "--draft", "demo_draft.fa", "--reads", "demoReads", "-k", "25"]
    snv = ["snv", "--reference", "demo_draft.fa", "--genome", "demo_genome.fa", "-k", "25"]
    run_cli(dirs["port"], *polish, "--device", "cpu")
    run_cli(dirs["port"], *snv, "--device", "cpu")
    mp = pytest.MonkeyPatch()
    mp.setenv("NTEDIT_TPU_DEVICE_BUILD", "1")
    cwd = os.getcwd()
    os.chdir(dirs["jax"])
    try:
        jcli.main(polish)
        jcli.main(snv)
    finally:
        os.chdir(cwd)
        mp.undo()
    return dirs


@pytest.mark.parametrize("name", [
    "demoReads_k25.hist", "demoReads_k25.bf", "ntedit_k25_edited.fa", "ntedit_k25_changes.tsv",
    "ntedit_k25_variants.vcf", "demo_genome.k25.hist", "demo_genome_k25.bf",
    "demo_genome_ntedit_k25_changes.tsv", "demo_genome_ntedit_k25_variants.vcf"])
def test_pipelines_match_the_jax_cli(pipeline_dirs, name):
    got = read(str(pipeline_dirs["port"] / name))
    want = read(str(pipeline_dirs["jax"] / name))
    if name.endswith(".vcf"):
        got, want = novcf(got), novcf(want)
    assert got == want


def test_pipeline_filter_is_the_device_layout(pipeline_dirs):
    from ntedit_tpu_torch.core import bloom

    bf = bloom.load_any(str(pipeline_dirs["port"] / "demoReads_k25.bf"))
    assert isinstance(bf, bloom.BlockedKmerBloomFilter)
    assert isinstance(bloom.load_any(str(pipeline_dirs["port"] / "demo_genome_k25.bf")),
                      bloom.KmerBloomFilter)


def test_stage_cache_dry_run_and_force(pipeline_dirs, tmp_path, capsys):
    """A rerun finds every artifact fresh; ``-n`` after newer reads lists
    the two filter stages it would run (the engine's inputs are not newer
    yet) and runs none; ``-f`` reruns all three."""
    d = tmp_path / "cache"
    shutil.copytree(pipeline_dirs["port"], d)
    argv = ["polish", "--draft", "demo_draft.fa", "--reads", "demoReads", "-k", "25",
            "--device", "cpu"]
    capsys.readouterr()
    run_cli(d, *argv)
    out = capsys.readouterr().out
    assert out.count("[cached]") == 3 and "[running]" not in out
    bf = d / "demoReads_k25.bf"
    before = (read(str(bf)), os.path.getmtime(bf))
    st = os.stat(d / "demoReads_1.fq.gz")
    os.utime(d / "demoReads_1.fq.gz", (st.st_atime, before[1] + 10))
    run_cli(d, *argv, "-n")
    out = capsys.readouterr().out
    assert out.count("[would run]") == 2 and out.count("[cached]") == 1
    assert "[running]" not in out
    assert "Done ntEdit!" not in out and os.path.getmtime(bf) == before[1]
    run_cli(d, *argv, "-f")
    out = capsys.readouterr().out
    assert out.count("[running]") == 3 and "Done ntEdit!" in out
    assert read(str(bf)) == before[0]
