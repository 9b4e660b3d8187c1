"""Multi-host runs of the torch port: two real processes on the CPU.

Two processes of ``python -m ntedit_tpu_torch engine --device cpu`` join
one gloo process group (NTEDIT_TPU_COORDINATOR at a free port) and polish
the corpus of tests/test_multihost.py; rank 0's merged _edited.fa,
_changes.tsv and _variants.vcf must equal, byte for byte, a single-process
run of the port and of the JAX package's CLI, in polish mode and with
-s 1.  This runs the whole multi-host data flow: initialize_from_env,
count_records and process_slice, each rank's polish, gather_records, rank
0's writers.  Also fastx.count_records against the JAX package's on FASTA,
FASTQ and gzip, and on a record larger than the batch reader's batch."""

import gzip
import os
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


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """Seven contigs with errors (one with N bytes) and a blocked filter of
    their truths (tests/test_multihost.py's); -s 1 calls their errors."""
    d = tmp_path_factory.mktemp("multihost")
    rng = np.random.default_rng(2)
    bf = jbloom.BlockedKmerBloomFilter.zeros(1 << 18, 3, 25)
    with open(d / "draft.fa", "w") as f:
        for i in range(7):
            truth = simulate.random_genome(9000 + 257 * i, seed=100 + i)
            draft, _ = simulate.inject_errors(truth, sub_rate=2e-3, ins_rate=2e-4,
                                              del_rate=2e-4, seed=200 + i)
            bf.insert_seq(truth)
            if i == 3:
                draft = draft.copy()
                draft[rng.integers(0, len(draft), size=5)] = ord("N")
            f.write(f">ctg{i} sim\n{draft.tobytes().decode()}\n")
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


def _run(d, package, prefix, mode, extra=None):
    argv = [sys.executable, "-m", package, "engine", "-r", "truth.bf", "-f", "draft.fa",
            "-b", prefix, "-t", "1", "-z", "100", "-s", "1" if mode == "snv" else "0"]
    if package == "ntedit_tpu_torch":
        argv += ["--device", "cpu"]
    return subprocess.Popen(argv, cwd=str(d), env=_env(extra), stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


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
    procs = [_run(corpus, "ntedit_tpu_torch", f"multi_{mode}", mode, {
        "NTEDIT_TPU_COORDINATOR": f"127.0.0.1:{port}",
        "NTEDIT_TPU_NUM_PROCESSES": "2",
        "NTEDIT_TPU_PROCESS_ID": str(rank),
    }) for rank in range(2)]
    procs.append(_run(corpus, "ntedit_tpu_torch", f"single_{mode}", mode))
    procs.append(_run(corpus, "ntedit_tpu", f"jax_{mode}", mode))
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=TIMEOUT)[0])
    finally:
        for p in procs:
            p.kill()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log
    assert "[rank 0/2] contigs [0, 4) of 7" in logs[0]
    assert "[rank 1/2] contigs [4, 7) of 7" in logs[1]
    assert "[rank 0] 4 contigs" in logs[0] and "[rank 1] 3 contigs" in logs[1]
    got = _outputs(corpus, f"multi_{mode}")
    assert got == _outputs(corpus, f"single_{mode}")
    assert got == _outputs(corpus, f"jax_{mode}")
    assert got["_changes.tsv"].count(b"\n") > 20


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
