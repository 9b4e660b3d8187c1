"""Package rules of the torch port: no JAX and nothing of ntedit_tpu in
it or in chip_smoke.py; the card by default, raising without one; every
kernel wrapper raising, with no launch, when its library cannot be built
or loaded; and, on a card only, each kernel against its plain version."""

import ast
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from ntedit_tpu_torch.core import bloom
from ntedit_tpu_torch.engine import flag
from ntedit_tpu_torch.engine.polish import Polisher
from ntedit_tpu_torch.ops import build_kernel, gate_kernel, mesh_kernel, snv_kernel
from ntedit_tpu_torch.utils import simulate

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
    names = {p.name for p in sources}
    assert {"oracle.py", "sitefix.py", "wavefront.py", "native.py", "profiling.py",
            "distributed.py", "mesh.py", "mesh_kernel.py", "check.py"} <= names
    bad = {str(p.relative_to(ROOT)): sorted(imported_roots(p) & FORBIDDEN) for p in sources}
    assert not {p: r for p, r in bad.items() if r}


def test_import_leaves_jax_out():
    code = ("import sys; import ntedit_tpu_torch, ntedit_tpu_torch.cli, "
            "ntedit_tpu_torch.engine.polish, ntedit_tpu_torch.convert, "
            "ntedit_tpu_torch.core.bfbuild, ntedit_tpu_torch.io.spill, "
            "ntedit_tpu_torch.io.native, ntedit_tpu_torch.engine.oracle, "
            "ntedit_tpu_torch.engine.sitefix, ntedit_tpu_torch.engine.wavefront, "
            "ntedit_tpu_torch.utils.profiling, ntedit_tpu_torch.parallel.mesh, "
            "ntedit_tpu_torch.parallel.check; "
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'ntedit_tpu')))")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, cwd=str(ROOT), check=True)
    assert out.stdout.strip() == "[]"


def test_chip_smoke_imports_resolve():
    """Every import of the port in chip_smoke.py, those inside its
    functions included (it imports lazily, so the card would meet a
    dangling one first), names a module and a name that exist."""
    import importlib

    tree = ast.parse((ROOT / "chip_smoke.py").read_text())
    seen = 0
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                if alias.name.split(".")[0] == "ntedit_tpu_torch":
                    importlib.import_module(alias.name)
                    seen += 1
        elif isinstance(node, ast.ImportFrom) and (node.module or "").startswith(
                "ntedit_tpu_torch"):
            module = importlib.import_module(node.module)
            for alias in node.names:
                if not hasattr(module, alias.name):  # a submodule: import it
                    importlib.import_module(f"{node.module}.{alias.name}")
                assert hasattr(module, alias.name), f"{node.module}.{alias.name}"
                seen += 1
    assert seen > 20


# each C source of the port, the wrapper that binds it, and what the
# wrapper binds from a library the source links (the reader's zlib)
C_ENTRIES = [("gate_kernel.cu", "ops/gate_kernel.py", ()),
             ("snv_kernel.cu", "ops/snv_kernel.py", ()),
             ("build_kernel.cu", "ops/build_kernel.py", ()),
             ("mesh_kernel.cu", "ops/mesh_kernel.py", ()),
             ("repair.cpp", "engine/native_repair.py", ()),
             ("fastx_reader.cpp", "io/native.py", ("zlibVersion",))]


@pytest.mark.parametrize("source,wrapper,linked", C_ENTRIES, ids=[c[0] for c in C_ENTRIES])
def test_wrapper_binds_the_sources_c_entries(source, wrapper, linked):
    """The functions a source defines in its extern "C" blocks are exactly
    the entries its wrapper binds (``lib.<entry>``, or a name of a tuple
    that a loop hands to ``getattr(lib, name)``): a binding of an entry
    that is gone fails here, not at load on the card, and a dead entry
    shows."""
    import re

    src = (ROOT / "ntedit_tpu_torch" / "csrc" / source).read_text()
    defined = set()
    for block in re.findall(r'extern "C" \{\n(.*?)\n\}  // extern "C"', src, re.S):
        defined.update(re.findall(r"^(?:const )?\w+\**\s+\**(\w+)\(", block, re.M))
    text = (ROOT / "ntedit_tpu_torch" / wrapper).read_text()
    bound = set(re.findall(r"\blib\.(\w+)", text))
    for var, names in re.findall(r"for (\w+) in \(([^)]*)\):\s*\n\s*getattr\(lib, \1\)", text):
        bound.update(re.findall(r"[\"'](\w+)[\"']", names))
    assert defined
    assert bound - set(linked) == defined


def test_build_digest_covers_every_file_read(tmp_path, monkeypatch):
    """An edited header builds a new library; unchanged files load the
    earlier build."""
    from ntedit_tpu_torch.utils import build

    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path / "out"))
    src, hdr = tmp_path / "a.cu", tmp_path / "a.cuh"
    src.write_text('#include "a.cuh"\n')
    hdr.write_text("// one\n")
    calls = []

    def command(source, out):
        calls.append(source)
        return ["cp", source, out]

    first = build.build_library("x", str(src), command, deps=(str(hdr),))
    built = len([c for c in calls if c])
    assert build.build_library("x", str(src), command, deps=(str(hdr),)) == first
    assert len([c for c in calls if c]) == built  # no second compile
    hdr.write_text("// two\n")
    second = build.build_library("x", str(src), command, deps=(str(hdr),))
    assert second != first and os.path.exists(second)
    assert gate_kernel.HEADER.endswith("nthash.cuh") and os.path.exists(gate_kernel.HEADER)


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


@pytest.mark.parametrize("failure", ["build", "load"])
@pytest.mark.parametrize("wrapper", ["snv_cand_words", "snv_site_rows", "polish_site_rows",
                                     "polish_cand_masks", "snv_cand_bin", "snv_cand_probe"])
def test_snv_wrappers_raise_when_the_library_is_missing(wrapper, failure, tmp_path, monkeypatch):
    if failure == "build":
        stub = tmp_path / "stub.cu"
        stub.write_text("this does not compile\n")
        monkeypatch.setattr(snv_kernel, "SOURCE", str(stub))
        monkeypatch.setattr(gate_kernel, "_nvcc", lambda: str(tmp_path / "no-nvcc"))
    else:
        stub = tmp_path / "libstub.so"
        stub.write_bytes(b"not a shared library")
        monkeypatch.setattr(snv_kernel, "build", lambda force=False: str(stub))
    monkeypatch.setattr(snv_kernel, "_lib", None)
    df = bloom.DeviceFilter.from_host(small_filter(), "cpu")
    seq = torch.empty(gate_kernel.padded_len(100), dtype=torch.uint8, device="meta")
    fn = getattr(snv_kernel, wrapper)
    with pytest.raises((RuntimeError, OSError)):
        heads = torch.empty(3, dtype=torch.int64, device="meta")
        bins = snv_kernel.CandBins(df.modulus, 100, "meta")
        words = torch.empty(4, dtype=torch.int32, device="meta")
        if wrapper == "snv_cand_words":
            fn(seq, 100, df)
        elif wrapper == "snv_cand_bin":
            fn(seq, 100, df, bins, words)
        elif wrapper == "snv_cand_probe":
            bins.n, bins.columns = 100, snv_kernel.CAND_ROUNDS
            fn(bins, df, words)
        elif wrapper == "polish_cand_masks":
            fn(seq, 100, heads, df)
        else:
            fn(seq, 100, heads, df, 3)
    assert fn.launches == 0


@pytest.mark.parametrize("failure", ["build", "load"])
@pytest.mark.parametrize("wrapper", ["kmer_valid_hashes", "kmer_count", "kmer_insert",
                                     "kmer_partition", "kmer_count_apply", "kmer_solid_bits"])
def test_build_wrappers_raise_when_the_library_is_missing(wrapper, failure, tmp_path, monkeypatch):
    if failure == "build":
        stub = tmp_path / "stub.cu"
        stub.write_text("this does not compile\n")
        monkeypatch.setattr(build_kernel, "SOURCE", str(stub))
        monkeypatch.setattr(gate_kernel, "_nvcc", lambda: str(tmp_path / "no-nvcc"))
    else:
        stub = tmp_path / "libstub.so"
        stub.write_bytes(b"not a shared library")
        monkeypatch.setattr(build_kernel, "build", lambda force=False: str(stub))
    monkeypatch.setattr(build_kernel, "_lib", None)
    seq = torch.empty(gate_kernel.padded_len(100), dtype=torch.uint8, device="meta")
    table = torch.empty(1024, dtype=torch.uint8, device="meta")
    words = torch.empty(1024, dtype=torch.int32, device="meta")
    fn = getattr(build_kernel, wrapper)
    with pytest.raises((RuntimeError, OSError)):
        if wrapper == "kmer_valid_hashes":
            fn(seq, 100, 25, 2)
        elif wrapper == "kmer_count":
            fn(seq, 100, 25, 3, table, 1000)
        elif wrapper == "kmer_partition":
            fn(seq, 100, 25, build_kernel.Bins(1000, 3, 100, "meta"))
        elif wrapper == "kmer_count_apply":
            fn(build_kernel.Bins(1000, 3, 100, "meta"), table)
        elif wrapper == "kmer_solid_bits":
            fn(table, 1000, 2)
        else:
            fn(seq, 100, 25, 3, words, "blocked", 1024, words, 1000)
    # kmer_count is no kernel of its own: it launches the partition and the apply
    launched = (build_kernel.kmer_partition, build_kernel.kmer_count_apply) \
        if wrapper == "kmer_count" else (fn,)
    assert all(f.launches == 0 for f in launched)


@pytest.mark.parametrize("failure", ["build", "load"])
@pytest.mark.parametrize("wrapper", ["or_rows", "sat_add_rows"])
def test_mesh_wrappers_raise_when_the_library_is_missing(wrapper, failure, tmp_path,
                                                         monkeypatch):
    if failure == "build":
        stub = tmp_path / "stub.cu"
        stub.write_text("this does not compile\n")
        monkeypatch.setattr(mesh_kernel, "SOURCE", str(stub))
        monkeypatch.setattr(gate_kernel, "_nvcc", lambda: str(tmp_path / "no-nvcc"))
    else:
        stub = tmp_path / "libstub.so"
        stub.write_bytes(b"not a shared library")
        monkeypatch.setattr(mesh_kernel, "build", lambda force=False: str(stub))
    monkeypatch.setattr(mesh_kernel, "_lib", None)
    fn = getattr(mesh_kernel, wrapper)
    dtype = torch.int32 if wrapper == "or_rows" else torch.uint8
    before = fn.launches
    with pytest.raises((RuntimeError, OSError)):
        fn(torch.empty((2, 40), dtype=dtype, device="meta"))
    assert fn.launches == before


def card_draft(rng, length=30_000):
    truth = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, size=length)]
    draft = truth.copy()
    draft[rng.integers(0, len(draft), size=300)] = ord("A")
    draft[rng.integers(0, len(draft), size=30)] = ord("N")
    draft[rng.integers(0, len(draft), size=30)] = ord("Y")
    draft[5000:7000] |= 0x20
    return truth, draft


def snv_filter(layout, truth, k):
    if layout == "blocked":
        hf = bloom.BlockedKmerBloomFilter.zeros(1 << 14, 3, k)
    else:
        hf = bloom.KmerBloomFilter.zeros(90_001, 4, k)
    hf.insert_seq(truth)
    return bloom.DeviceFilter.from_host(hf, "cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("k", [25, 34])
@pytest.mark.parametrize("layout", ["blocked", "plain"])
def test_snv_cand_kernel_matches_plain_on_the_card(layout, k):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the SNV kernels have no CPU mode")
    truth, draft = card_draft(np.random.default_rng(4))
    df = snv_filter(layout, truth, k)
    found = 0
    for n in (len(draft) - k + 1, gate_kernel.TILE + 1, 33):
        buf = torch.zeros(gate_kernel.padded_len(n), dtype=torch.uint8)
        buf[: n + k - 1] = torch.from_numpy(draft[: n + k - 1])
        seq = buf.cuda()
        got = snv_kernel.snv_cand_words(seq, n, df)
        assert torch.equal(got, snv_kernel.snv_cand_words_plain(seq, n, df)), n
        found += int(got.count_nonzero())
    assert found > 0


@pytest.mark.cuda
@pytest.mark.parametrize("k,jump", [(25, 3), (25, 1), (34, 5)])
@pytest.mark.parametrize("layout", ["blocked", "plain"])
def test_snv_site_kernel_matches_plain_on_the_card(layout, k, jump):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the SNV kernels have no CPU mode")
    truth, draft = card_draft(np.random.default_rng(5))
    df = snv_filter(layout, truth, k)
    n = len(draft) - k + 1
    seq = torch.from_numpy(draft).cuda()
    buf = torch.zeros(gate_kernel.padded_len(n), dtype=torch.uint8)
    buf[: len(draft)] = torch.from_numpy(draft)
    cand = flag.positions_on_device(snv_kernel.snv_cand_words(buf.cuda(), n, df))
    cand = torch.cat([cand, torch.tensor([0, n - k - 1, n - k, n - 1], device="cuda")]).unique()
    got = snv_kernel.snv_site_rows(seq, n, cand, df, jump)
    assert torch.equal(got, snv_kernel.snv_site_rows_plain(seq, n, cand, df, jump))
    assert int((got[:, 0] & 1).sum()) > 0 and int((got[:, 0] == 0).sum()) > 0
    # the index lists of simulate.site_lists, one launch each
    for name, heads in simulate.site_lists(n, k, at=8000).items():
        heads = torch.from_numpy(heads).cuda()
        got = snv_kernel.snv_site_rows(seq, n, heads, df, jump)
        assert torch.equal(got, snv_kernel.snv_site_rows_plain(seq, n, heads, df, jump)), name


@pytest.mark.cuda
@pytest.mark.parametrize("k,jump", [(25, 3), (25, 1), (34, 5)])
@pytest.mark.parametrize("layout", ["blocked", "plain"])
def test_polish_kernels_match_plain_on_the_card(layout, k, jump):
    """The polish site rows on a whole list of gates (cluster starts and
    later gates, IUPAC-forced gates, heads at both contig ends) and the
    candidate masks on the same heads, against their plain versions."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the polish kernels have no CPU mode")
    truth, draft = card_draft(np.random.default_rng(6))
    df = snv_filter(layout, truth, k)
    n = len(draft) - k + 1
    seq = torch.from_numpy(draft).cuda()
    buf = torch.zeros(gate_kernel.padded_len(n), dtype=torch.uint8)
    buf[: len(draft)] = torch.from_numpy(draft)
    gates = torch.cat([flag.positions_on_device(gate_kernel.gate_words(buf.cuda(), n, df)),
                       torch.tensor([0, 1, n - k - 1, n - k, n - 1], device="cuda")]).unique()
    rows = snv_kernel.polish_site_rows(seq, n, gates, df, jump)
    assert torch.equal(rows, snv_kernel.polish_site_rows_plain(seq, n, gates, df, jump))
    assert int((rows[:, 0] & 1).sum()) > 0 and int((rows[:, 0] & 32 == 0).sum()) > 0
    for name, heads in simulate.site_lists(n, k, at=8000).items():
        heads = torch.from_numpy(heads).cuda()
        got = snv_kernel.polish_site_rows(seq, n, heads, df, jump)
        assert torch.equal(got, snv_kernel.polish_site_rows_plain(seq, n, heads, df, jump)), name
    masks = snv_kernel.polish_cand_masks(seq, n, gates, df)
    assert torch.equal(masks, snv_kernel.polish_cand_masks_plain(seq, n, gates, df, True))
    assert int((masks == 0xFF).sum()) > 0 and int((masks != 0xFF).sum()) > 0


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


@pytest.mark.cuda
@pytest.mark.parametrize("slice_bits", [23, 9, 4])
@pytest.mark.parametrize("k", [25, 34])
def test_snv_cand_bins_match_plain_on_the_card(k, slice_bits):
    """The binned candidate pass: the bins (count matrix, scan and each
    (slice, block) range as a multiset) and the probed words against the
    plain versions and the candidate kernel's words, with the filter in 1,
    32 and 256 slices."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the SNV kernels have no CPU mode")
    truth, draft = card_draft(np.random.default_rng(6))
    df = snv_filter("blocked", truth, k)
    for n in (len(draft) - k + 1, gate_kernel.TILE + 1, gate_kernel.TILE, 33, 1):
        buf = torch.zeros(gate_kernel.padded_len(n), dtype=torch.uint8)
        buf[: n + k - 1] = torch.from_numpy(draft[: n + k - 1])
        seq = buf.cuda()
        got, want = (snv_kernel.CandBins(df.modulus, n, "cuda", slice_bits) for _ in range(2))
        words = torch.full((-(-n // 32),), -1, dtype=torch.int32, device="cuda")
        plain_words = words.clone()
        snv_kernel.snv_cand_bin(seq, n, df, got, words)
        snv_kernel.snv_cand_bin_plain(seq, n, df, want, plain_words)
        cells = got.cells()
        assert torch.equal(got.counts[:cells], want.counts[:cells]), n
        assert torch.equal(got.ends[:cells], want.ends[:cells]), n
        assert all(torch.equal(a, b) for a, b in zip(snv_kernel.bin_multiset(got),
                                                     snv_kernel.bin_multiset(want))), n
        assert torch.equal(words, plain_words), n  # the forced bits, stored
        snv_kernel.snv_cand_probe(got, df, words)
        snv_kernel.snv_cand_probe_plain(want, df, plain_words)
        assert torch.equal(words, plain_words), n
        assert torch.equal(words, snv_kernel.snv_cand_words_plain(seq, n, df)), n


def reduce_grid():
    """(d, rows int32, rows uint8) on the phase 9 grid of chip_smoke.py at
    a small size: D in {1, 2, 3, 4, 8}; widths 1 to 70 elements (tails of
    1 to 15 bytes past the 16-byte vectors); zero, all-ones and random
    words; counters at 0, 1, 128, 254 and 255 and random, and eight rows of
    40 (320 saturates)."""
    rng = np.random.default_rng(9)
    edges = np.array([0, 1, 128, 254, 255], dtype=np.uint8)
    for d in (1, 2, 3, 4, 8):
        for m in (1, 2, 3, 4, 5, 15, 16, 17, 31, 33, 63, 64, 70):
            words = rng.integers(-2**31, 2**31, size=(d, m)).astype(np.int32)
            words[0, : m // 3] = 0
            words[-1, m // 2 :] = -1
            counts = edges[rng.integers(0, 5, size=(d, m))]
            counts[:, ::4] = rng.integers(0, 256, size=counts[:, ::4].shape)
            yield d, words, counts
        yield d, np.zeros((d, 64), np.int32), np.full((d, 64), 40, dtype=np.uint8)


@pytest.mark.cuda
def test_reduce_kernels_match_plain_on_the_card():
    """or_rows and sat_add_rows against their plain versions, bit for bit,
    on rows whose vectors are 16-byte aligned and on rows of odd strides
    (4- and 1-byte vectors)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the reduce kernels have no CPU mode")
    for d, words, counts in reduce_grid():
        for host, fn, plain in ((words, mesh_kernel.or_rows, mesh_kernel.or_rows_plain),
                                (counts, mesh_kernel.sat_add_rows,
                                 mesh_kernel.sat_add_rows_plain)):
            rows = torch.from_numpy(host).cuda()
            got = fn(rows)
            torch.cuda.synchronize()
            assert torch.equal(got, plain(rows)), (d, host.shape, host.dtype)
            # a view one element in: a row stride and start off the 16 bytes
            wide = torch.from_numpy(np.pad(host, ((0, 0), (1, 0)))).cuda()[:, 1:]
            assert torch.equal(fn(wide), plain(rows)), (d, host.shape, host.dtype)
