"""Guards of the benchmark: what a run imports, a run without a card or
without the program, and cells, configurations, traffic and metrics
found by name from files added alone."""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
FORBIDDEN = {"jax", "jaxlib", "flax", "ntedit_tpu"}


def _python(code: str, cwd: str = ROOT, path: str = ROOT, timeout: int = 600):
    env = dict(os.environ, PYTHONPATH=path, CUDA_VISIBLE_DEVICES="")
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, env=env, capture_output=True,
                          text=True, timeout=timeout)


def _roots(proc) -> set:
    assert proc.returncode == 0, proc.stderr[-3000:]
    return set(json.loads(proc.stdout.strip().splitlines()[-1]))


def test_a_run_of_each_cell_imports_no_jax_nor_the_jax_package():
    code = (
        "import json, sys, time\n"
        "from benchmark import harness\n"
        "from benchmark.tests import tiny\n"
        "for cell in tiny.ALL:\n"
        "    for trace in (False, True):\n"
        "        harness.run_cell(tiny.spec(cell), 3, 0.2, trace, 'cpu', time.perf_counter())\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n"
    )
    roots = _roots(_python(code))
    assert "ntedit_tpu_torch" in roots and not roots & FORBIDDEN


def test_the_reference_imports_nothing_of_the_port():
    code = (
        "import json, sys, importlib, pkgutil\n"
        "import benchmark.reference as r\n"
        "for m in pkgutil.iter_modules(r.__path__):\n"
        "    importlib.import_module('benchmark.reference.' + m.name)\n"
        "import benchmark.check, benchmark.inputs\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n"
    )
    roots = _roots(_python(code))
    assert not roots & (FORBIDDEN | {"ntedit_tpu_torch"})


def _command(cwd: str, path: str):
    env = dict(os.environ, PYTHONPATH=path, CUDA_VISIBLE_DEVICES="")
    return subprocess.run([sys.executable, "benchmark/run.py", "--workload", "ecoli_k25.reads",
                           "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_a_run_without_a_card_fails_and_prints_no_result():
    proc = _command(ROOT, "")
    assert proc.returncode != 0
    assert "{" not in proc.stdout and "CUDA" in proc.stderr


def _bare_checkout(tmp_path) -> str:
    root = tmp_path / "checkout"
    root.mkdir()
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), root)
    shutil.copytree(os.path.join(ROOT, "benchmark"), root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "_cache"))
    return str(root)


def test_a_checkout_without_the_program_fails(tmp_path):
    root = _bare_checkout(tmp_path)
    proc = _command(root, "")
    assert proc.returncode != 0 and "{" not in proc.stdout
    # past the look for a card too: the program is missing
    code = ("import time\nfrom benchmark import harness\nfrom benchmark.tests import tiny\n"
            "print(harness.run_cell(tiny.spec('ecoli_k25.polish'), 3, 0.2, False, 'cpu', time.perf_counter()))\n")
    proc = _python(code, cwd=root, path=root)
    assert proc.returncode != 0 and "ntedit_tpu_torch" in proc.stderr and "{" not in proc.stdout


def test_files_added_alone_are_found(tmp_path):
    """A configuration, a traffic mix and a metric, each a file of its own,
    and entries in BENCHMARK.json: no file of the harness changes."""
    root = _bare_checkout(tmp_path)
    bench = os.path.join(root, "benchmark")
    with open(os.path.join(bench, "configs", "ecoli_k25.json")) as f:
        cfg = json.load(f)
    cfg.update(name="dummy_k21", k=21, contig_bp=[30000], filter_bytes=1 << 16)
    with open(os.path.join(bench, "configs", "dummy_k21.json"), "w") as f:
        json.dump(cfg, f)
    with open(os.path.join(bench, "traffic", "dummy_mix.json"), "w") as f:
        json.dump({"kind": "engine", "mode": "polish", "input": "draft", "pool": 1,
                   "passes": ["gate"], "check": {"stretches": 2, "width": 3000}}, f)
    with open(os.path.join(bench, "metrics", "dummy.jobs.py"), "w") as f:
        f.write("def read(run):\n    return len(run.job_s)\n")
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        spec = json.load(f)
    spec["configs"].append({"name": "dummy_k21", "source": "test", "file": "benchmark/configs/dummy_k21.json",
                            "reduced": [], "why": "test"})
    spec["workloads"].append({"name": "dummy_k21.mix", "config": "dummy_k21", "traffic": "dummy_mix",
                              "chips": 1, "why": "test"})
    spec["end_to_end"].append({"name": "dummy.jobs", "unit": "jobs", "better": "higher", "bound": 0.25,
                               "source": "host_clock", "workloads": ["dummy_k21.mix"]})
    spec["end_to_end"].append({"name": "bp_per_s", "unit": "bp/s", "better": "higher", "bound": 0.25,
                               "source": "host_clock", "workloads": ["dummy_k21.mix"]})
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(spec, f)
    code = ("import json, time\nfrom benchmark import harness\n"
            "s = harness.load_spec('dummy_k21.mix')\n"
            "print(json.dumps(harness.run_cell(s, 3, 0.3, False, 'cpu', time.perf_counter())))\n")
    proc = _python(code, cwd=root, path=f"{root}{os.pathsep}{ROOT}")
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["correct"] and out["metrics"]["dummy.jobs"]["value"] >= 1
    assert "bp_per_s" in out["metrics"] and "read_bp_per_s" not in out["metrics"]


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the benchmark runs the port's kernels on the card")


@pytest.mark.cuda
def test_a_short_run_on_the_card_is_correct(card):
    proc = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "ecoli_k25.reads",
                           "--seed", "4294967311", "--seconds", "2", "--trace", "0"], cwd=ROOT,
                          capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["correct"] and out["device"]["platform"] == "gpu" and out["failed"] == 0
