"""Multi-host runs of the torch port: two real processes on the CPU.

Two processes of ``python -m ntedit_tpu_torch engine --device cpu`` join
one gloo process group (NTEDIT_TPU_COORDINATOR at a free port) and polish
the corpus of tests/test_multihost.py; rank 0's merged _edited.fa,
_changes.tsv and _variants.vcf must equal, byte for byte, a single-process
run of the port and of the JAX package's CLI, in polish mode and with
-s 1.  This runs the whole multi-host data flow: initialize_from_env,
count_records and process_slice, each rank's polish, gather_records, rank
0's writers.  The same for ``polish --reads``, ``snv --reads`` and ``snv
--genome`` with both ranks in one stage directory: every rank builds the
filter stages there, so rank 0's outputs, histogram and filter must equal
the single run's and the JAX CLI's, with no ``*.tmp`` stage file left;
there each rank holds every stage file's rename for a second, so that the
ranks' writes of one stage file overlap.
Also fastx.count_records against the JAX package's on FASTA, FASTQ and
gzip, and on a record larger than the batch reader's batch."""

import glob
import gzip
import os
import shutil
import socket
import subprocess
import sys

import numpy as np
import pytest

from ntedit_tpu.core import bloom as jbloom
from ntedit_tpu.io import fastx as jfastx
from ntedit_tpu.utils import simulate
from ntedit_tpu_torch.io import fastx, native

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 300


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


READ_LEN, COVERAGE = 150, 10


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """Seven contigs with errors (one with N bytes) and a blocked filter of
    their truths (tests/test_multihost.py's); -s 1 calls their errors.
    Beside them the truths as a genome and 10x of 150 bp reads of them
    (0.3% substitutions)."""
    d = tmp_path_factory.mktemp("multihost")
    rng = np.random.default_rng(2)
    bf = jbloom.BlockedKmerBloomFilter.zeros(1 << 18, 3, 25)
    with open(d / "draft.fa", "w") as f, open(d / "genome.fa", "w") as g, \
            open(d / "reads.fa", "w") as r:
        for i in range(7):
            truth = simulate.random_genome(9000 + 257 * i, seed=100 + i)
            draft, _ = simulate.inject_errors(truth, sub_rate=2e-3, ins_rate=2e-4,
                                              del_rate=2e-4, seed=200 + i)
            bf.insert_seq(truth)
            if i == 3:
                draft = draft.copy()
                draft[rng.integers(0, len(draft), size=5)] = ord("N")
            f.write(f">ctg{i} sim\n{draft.tobytes().decode()}\n")
            g.write(f">chr{i}\n{truth.tobytes().decode()}\n")
            for j, at in enumerate(rng.integers(0, len(truth) - READ_LEN,
                                                size=COVERAGE * len(truth) // READ_LEN)):
                read = truth[at : at + READ_LEN].copy()
                sub = rng.random(READ_LEN) < 3e-3
                read[sub] = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, size=sub.sum())]
                r.write(f">r{i}_{j}\n{read.tobytes().decode()}\n")
    bf.save(str(d / "truth.bf"))
    return d


def _env(extra=None) -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"  # two ranks share this host's cores
    env["JAX_PLATFORMS"] = env["NTEDIT_TPU_PLATFORM"] = "cpu"
    env.pop("XLA_FLAGS", None)
    env.update(extra or {})
    return env


def _start(d, argv, extra=None):
    return subprocess.Popen([sys.executable, "-m", *argv], cwd=str(d), env=_env(extra),
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def _rank_env(port: int, rank: int) -> dict:
    return {"NTEDIT_TPU_COORDINATOR": f"127.0.0.1:{port}", "NTEDIT_TPU_NUM_PROCESSES": "2",
            "NTEDIT_TPU_PROCESS_ID": str(rank)}


def _finish(procs) -> list:
    """Each process's output, once all have ended; each must exit 0."""
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=TIMEOUT)[0])
    finally:
        for p in procs:
            p.kill()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log
    return logs


def _run(d, package, prefix, mode, extra=None):
    argv = [package, "engine", "-r", "truth.bf", "-f", "draft.fa", "-b", prefix, "-t", "1",
            "-z", "100", "-s", "1" if mode == "snv" else "0"]
    if package == "ntedit_tpu_torch":
        argv += ["--device", "cpu"]
    return _start(d, argv, extra)


def _outputs(d, prefix) -> dict:
    out = {}
    for suffix in ("_edited.fa", "_changes.tsv", "_variants.vcf"):
        data = (d / (prefix + suffix)).read_bytes()
        if suffix == "_variants.vcf":  # the date line can straddle midnight
            data = b"\n".join(l for l in data.split(b"\n") if not l.startswith(b"##fileDate"))
        out[suffix] = data
    return out


@pytest.mark.parametrize("mode", ["polish", "snv"])
def test_two_process_engine_matches_single_runs(corpus, mode):
    port = _free_port()
    procs = [_run(corpus, "ntedit_tpu_torch", f"multi_{mode}", mode, _rank_env(port, rank))
             for rank in range(2)]
    procs.append(_run(corpus, "ntedit_tpu_torch", f"single_{mode}", mode))
    procs.append(_run(corpus, "ntedit_tpu", f"jax_{mode}", mode))
    logs = _finish(procs)
    assert "[rank 0/2] contigs [0, 4) of 7" in logs[0]
    assert "[rank 1/2] contigs [4, 7) of 7" in logs[1]
    assert "[rank 0] 4 contigs" in logs[0] and "[rank 1] 3 contigs" in logs[1]
    got = _outputs(corpus, f"multi_{mode}")
    assert got == _outputs(corpus, f"single_{mode}")
    assert got == _outputs(corpus, f"jax_{mode}")
    assert got["_changes.tsv"].count(b"\n") > 20


# Starts a module as ``python -m`` does, each rename onto a stage file held
# for a second first: two ranks then write one stage file at once, which a
# temporary name shared by the ranks would not survive.
SLOW_STAGES = """
import os, runpy, sys, time
real = os.replace
def held(src, dst, *args, **kwargs):
    if str(dst).endswith((".hist", ".bf", ".cbf")):
        time.sleep(1.0)
    return real(src, dst, *args, **kwargs)
os.replace = held
sys.argv = sys.argv[1:]
runpy.run_module(sys.argv[0], run_name="__main__", alter_sys=True)
"""

# subcommand: (argv after the package, output prefix, stage files)
PIPELINES = {
    "polish_reads": (["polish", "--draft", "draft.fa", "--reads", "reads", "-k", "25"],
                     "ntedit_k25", ["reads_k25.hist", "reads_k25.bf"]),
    "snv_reads": (["snv", "--reference", "draft.fa", "--reads", "reads", "-k", "25"],
                  "reads_ntedit_k25", ["reads_k25.hist", "reads_k25.bf"]),
    "snv_genome": (["snv", "--reference", "draft.fa", "--genome", "genome.fa", "-k", "25"],
                   "genome_ntedit_k25", ["genome.k25.hist", "genome_k25.bf"]),
}


@pytest.mark.parametrize("pipeline", list(PIPELINES))
def test_two_process_filter_stages_match_single_runs(corpus, tmp_path, pipeline):
    """Both ranks build the filter stages in one directory, then polish or
    call SNVs on their contigs; rank 0's outputs, histogram and filter equal
    a single run's of the port and the JAX CLI's (its device build), each in
    a directory of its own, and no ``*.tmp`` stage file is left."""
    argv, prefix, stages = PIPELINES[pipeline]
    dirs = {}
    for who in ("multi", "single", "jax"):
        dirs[who] = tmp_path / who
        dirs[who].mkdir()
        for name in ("draft.fa", "reads.fa", "genome.fa"):
            shutil.copy(corpus / name, dirs[who] / name)
    port = _free_port()
    torch_argv = ["ntedit_tpu_torch", *argv, "-t", "1", "--device", "cpu"]
    slow = tmp_path / "slow_stages.py"
    slow.write_text(SLOW_STAGES)
    procs = [subprocess.Popen([sys.executable, str(slow), *torch_argv], cwd=str(dirs["multi"]),
                              env=_env(_rank_env(port, rank)), stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for rank in range(2)]
    procs.append(_start(dirs["single"], torch_argv))
    procs.append(_start(dirs["jax"], ["ntedit_tpu", *argv, "-t", "1"],
                        {"NTEDIT_TPU_DEVICE_BUILD": "1"}))
    logs = _finish(procs)
    assert "[rank 0/2] contigs [0, 4) of 7" in logs[0]
    assert "[rank 1/2] contigs [4, 7) of 7" in logs[1]
    got = _outputs(dirs["multi"], prefix)
    assert got == _outputs(dirs["single"], prefix) == _outputs(dirs["jax"], prefix)
    assert got["_variants.vcf"].count(b"\n") > 20
    for name in stages:
        data = (dirs["multi"] / name).read_bytes()
        assert data == (dirs["single"] / name).read_bytes() == (dirs["jax"] / name).read_bytes()
    assert not glob.glob(str(dirs["multi"] / "*.tmp"))


def _records(n, fastq: bool, lengths=None) -> bytes:
    rng = np.random.default_rng(n)
    out = []
    for i in range(n):
        L = lengths[i] if lengths else int(rng.integers(1, 300))
        seq = np.frombuffer(b"ACGTN", np.uint8)[rng.integers(0, 5, size=L)].tobytes()
        if fastq:
            out.append(b"@r%d c\n%s\n+\n%s\n" % (i, seq, b"I" * L))
        else:  # multi-line FASTA
            lines = b"\n".join(seq[j : j + 60] for j in range(0, L, 60))
            out.append(b">r%d c\n%s\n" % (i, lines))
    return b"".join(out)


@pytest.mark.parametrize("name", ["reads.fa", "reads.fq", "reads.fa.gz", "reads.fq.gz"])
def test_count_records_matches_jax(tmp_path, name):
    data = _records(5000, fastq=".fq" in name)
    path = tmp_path / name
    path.write_bytes(gzip.compress(data, 1) if name.endswith(".gz") else data)
    assert fastx.count_records(str(path)) == jfastx.count_records(str(path)) == 5000
    assert fastx.count_records(str(path)) == sum(1 for _ in fastx.read_fastx_plain(str(path)))


def test_count_records_counts_a_record_larger_than_a_batch(tmp_path):
    """The batch reader holds a record larger than its batch whole (the JAX
    package's loses it), so the count is the records the port reads."""
    lengths = [10, native.SEQ_CAP + 1000, 20, 3]
    path = tmp_path / "big.fa"
    path.write_bytes(_records(4, fastq=False, lengths=lengths))
    assert fastx.count_records(str(path)) == 4 == jfastx.count_records(str(path))
    assert [len(r.seq) for r in fastx.read_fastx(str(path))] == lengths
