"""Package rules of the torch port: no JAX and nothing of ntedit_tpu in
it or in chip_smoke.py; the card by default, raising without one; the
kernel wrapper raising, with no launch, when its library cannot be built
or loaded; and, on a card only, the kernel against its plain version."""

import ast
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from ntedit_tpu_torch.core import bloom
from ntedit_tpu_torch.engine.polish import Polisher
from ntedit_tpu_torch.ops import gate_kernel

ROOT = pathlib.Path(__file__).resolve().parent.parent
FORBIDDEN = {"jax", "jaxlib", "ntedit_tpu"}


def port_sources():
    return sorted((ROOT / "ntedit_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def imported_roots(path):
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            roots.add(node.module.split(".")[0])
    return roots


def test_no_jax_or_reference_imports():
    sources = port_sources()
    assert len(sources) > 15
    bad = {str(p.relative_to(ROOT)): sorted(imported_roots(p) & FORBIDDEN) for p in sources}
    assert not {p: r for p, r in bad.items() if r}


def test_import_leaves_jax_out():
    code = ("import sys; import ntedit_tpu_torch, ntedit_tpu_torch.cli, "
            "ntedit_tpu_torch.engine.polish, ntedit_tpu_torch.convert; "
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'ntedit_tpu')))")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, cwd=str(ROOT), check=True)
    assert out.stdout.strip() == "[]"


def small_filter():
    bf = bloom.BlockedKmerBloomFilter.zeros(1 << 12, 3, 25)
    bf.insert_seq(np.frombuffer(b"ACGT" * 100, np.uint8))
    return bf


def test_polisher_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is usable")
    with pytest.raises(RuntimeError, match="CUDA"):
        Polisher(small_filter())
    with pytest.raises(RuntimeError, match="CUDA"):
        Polisher(small_filter(), device="cuda")
    assert Polisher(small_filter(), device="cpu").df.device.type == "cpu"


@pytest.mark.parametrize("failure", ["build", "load"])
def test_wrapper_raises_when_the_library_is_missing(failure, tmp_path, monkeypatch):
    """A tensor that is not on the CPU goes to the kernel or raises: it
    never falls back to the plain version."""
    if failure == "build":
        stub = tmp_path / "stub.cu"
        stub.write_text("this does not compile\n")
        monkeypatch.setattr(gate_kernel, "SOURCE", str(stub))
        monkeypatch.setattr(gate_kernel, "_nvcc", lambda: str(tmp_path / "no-nvcc"))
    else:
        stub = tmp_path / "libstub.so"
        stub.write_bytes(b"not a shared library")
        monkeypatch.setattr(gate_kernel, "build", lambda force=False: str(stub))
    monkeypatch.setattr(gate_kernel, "_lib", None)
    df = bloom.DeviceFilter.from_host(small_filter(), "cpu")
    seq = torch.empty(gate_kernel.padded_len(100), dtype=torch.uint8, device="meta")
    before = gate_kernel.gate_words.launches
    with pytest.raises((RuntimeError, OSError)):
        gate_kernel.gate_words(seq, 100, df)
    assert gate_kernel.gate_words.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("k", [25, 33])
@pytest.mark.parametrize("layout", ["blocked", "plain", "counting"])
def test_kernel_matches_plain_on_the_card(layout, k):
    """k = 33 is the last k whose srol^k stays inside the 33-bit half; n
    runs over a ragged tail, a tile boundary +1 and a short contig."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the gate kernel has no CPU mode")
    from ntedit_tpu_torch.core import nthash_ref as ref

    rng = np.random.default_rng(3)
    truth = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, size=30_000)]
    draft = truth.copy()
    draft[rng.integers(0, len(draft), size=300)] = ord("A")
    draft[rng.integers(0, len(draft), size=30)] = ord("N")
    draft[rng.integers(0, len(draft), size=30)] = ord("Y")
    draft[5000:7000] |= 0x20
    if layout == "blocked":
        hf = bloom.BlockedKmerBloomFilter.zeros(1 << 14, 3, k)
        hf.insert_seq(truth)
    elif layout == "plain":
        hf = bloom.KmerBloomFilter.zeros(90_001, 4, k)
        hf.insert_seq(truth)
    else:
        hf = bloom.KmerCountingBloomFilter8.zeros(200_003, 3, k)
        fh, rh = ref.all_window_hashes(truth, k)
        hf.insert_hashes(ref.extend_hashes_vec(ref.canonical(fh, rh), k, 3))
    df = bloom.DeviceFilter.from_host(hf, "cuda")
    for n in (len(draft) - k + 1, gate_kernel.TILE + 1, 33):
        buf = torch.zeros(gate_kernel.padded_len(n), dtype=torch.uint8)
        buf[: n + k - 1] = torch.from_numpy(draft[: n + k - 1])
        seq = buf.cuda()
        for snv in (False, True):
            for p in (1, 3):
                got = gate_kernel.gate_words(seq, n, df, snv, p)
                want = gate_kernel.gate_words_plain(seq, n, df, snv, p)
                assert torch.equal(got, want), (n, snv, p)
