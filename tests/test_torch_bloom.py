"""The torch port's DeviceFilter probes against the JAX package's host
filters (contains_hashes / count_hashes), for the blocked, plain
(non-power-of-two) and counting layouts; the size limits; carrying a
filter across with filter_from_numpy; reading the JAX package's files."""

import numpy as np
import pytest
import torch

from ntedit_tpu.core import bloom as jbloom
from ntedit_tpu.core import nthash_ref as ref
from ntedit_tpu_torch import convert
from ntedit_tpu_torch.core import bloom as tbloom
from ntedit_tpu_torch.core import nthash as tnt

BASES = np.frombuffer(b"ACGT", dtype=np.uint8)


def rand_seq(n, seed):
    return BASES[np.random.default_rng(seed).integers(0, 4, size=n)]


def probe_hashes(seq, k, h):
    fh, rh = ref.all_window_hashes(seq, k)
    return ref.extend_hashes_vec(ref.canonical(fh, rh), k, h)


def jax_filter(kind, k, h, truth):
    if kind == "blocked":
        f = jbloom.BlockedKmerBloomFilter.zeros(1 << 12, h, k)
        f.insert_seq(truth)
        return f, f.words
    if kind == "plain":
        f = jbloom.KmerBloomFilter.zeros(4096 + 13, h, k)  # not a power of two
        f.insert_seq(truth)
        return f, f.data
    f = jbloom.KmerCountingBloomFilter8.zeros(4099, h, k)
    hashes = probe_hashes(truth, k, h)
    f.insert_hashes(hashes)
    f.insert_hashes(hashes[:300])
    return f, f.counters


@pytest.mark.parametrize("h", [1, 3, 4])
@pytest.mark.parametrize("kind", ["blocked", "plain", "counting"])
def test_probes_match_jax_host(kind, h):
    k = 21
    truth = rand_seq(1500, seed=h)
    jf, arr = jax_filter(kind, k, h, truth)
    _, df = convert.filter_from_numpy(kind, arr, h, k, device="cpu")
    probe = np.concatenate([truth, rand_seq(1500, seed=10 + h)])
    want_h = probe_hashes(probe, k, h)
    got_h = [tnt.as_int64(want_h[:, j]) for j in range(h)]
    if kind == "counting":
        want = jf.count_hashes(want_h)
        np.testing.assert_array_equal(df.count(got_h).numpy(), want)
        np.testing.assert_array_equal(df.contains(got_h).numpy(), want > 0)
    else:
        want = jf.contains_hashes(want_h)
        np.testing.assert_array_equal(df.contains(got_h).numpy(), want)
        np.testing.assert_array_equal(df.count(got_h).numpy(), want.astype(np.uint8))
    assert want.any() and not want.all()


def test_probes_on_top_bit_hashes():
    """Probe indices of hashes with bit 63 set (the exact 64-bit modulo)."""
    k, h = 25, 4
    truth = rand_seq(2000, seed=5)
    jf, arr = jax_filter("plain", k, h, truth)
    _, df = convert.filter_from_numpy("plain", arr, h, k, device="cpu")
    base = np.random.default_rng(6).integers(0, 1 << 63, size=4000, dtype=np.uint64)
    base |= np.uint64(1 << 63)
    hashes = ref.extend_hashes_vec(base, k, h)
    jf.data[:] = 0xFF
    jf.data[(hashes[:, 1] % np.uint64(jf.bits) >> np.uint64(3)).astype(np.int64)[::2]] = 0
    _, df = convert.filter_from_numpy("plain", jf.data, h, k, device="cpu")
    got = df.contains([tnt.as_int64(hashes[:, j]) for j in range(h)]).numpy()
    np.testing.assert_array_equal(got, jf.contains_hashes(hashes))
    assert got.any() and not got.all()


class _Huge:
    """A host filter whose array reports a size without holding it."""

    def __init__(self, size):
        self.size = size


@pytest.mark.parametrize("case", ["plain", "blocked", "counting"])
def test_size_limits_raise_before_allocating(case, monkeypatch):
    def no_upload(*a, **kw):
        raise AssertionError("allocated before the size check")

    monkeypatch.setattr(tbloom, "_upload", no_upload)
    if case == "plain":
        f = tbloom.KmerBloomFilter.__new__(tbloom.KmerBloomFilter)
        f.data, f.hash_num, f.k = _Huge((1 << 33) + 1), 3, 25
    elif case == "blocked":
        f = tbloom.BlockedKmerBloomFilter.__new__(tbloom.BlockedKmerBloomFilter)
        f.words, f.hash_num, f.k = _Huge(1 << 32), 3, 25
    else:
        f = tbloom.KmerCountingBloomFilter8.__new__(tbloom.KmerCountingBloomFilter8)
        f.counters, f.hash_num, f.k = _Huge((1 << 31) + 1), 3, 25
    with pytest.raises(NotImplementedError):
        tbloom.DeviceFilter.from_host(f, "cpu")


@pytest.mark.parametrize("kind", ["blocked", "plain", "counting"])
def test_filter_from_numpy_round_trip(kind, tmp_path):
    k, h = 25, 3
    jf, arr = jax_filter(kind, k, h, rand_seq(800, seed=9))
    host, df = convert.filter_from_numpy(kind, arr, h, k, device="cpu")
    assert (host.k, host.hash_num, df.k, df.hash_num, df.layout) == (k, h, k, h, kind)
    back = {"blocked": lambda f: f.words, "plain": lambda f: f.data,
            "counting": lambda f: f.counters}[kind](host)
    np.testing.assert_array_equal(back, arr)
    assert back.dtype == arr.dtype
    # the JAX package's file, read by the port's load_any
    path = str(tmp_path / f"f.{kind}")
    jf.save(path)
    loaded = tbloom.load_any(path)
    assert type(loaded).__name__ == type(jf).__name__
    np.testing.assert_array_equal(
        {"blocked": lambda f: f.words, "plain": lambda f: f.data,
         "counting": lambda f: f.counters}[kind](loaded), arr)
    assert (loaded.k, loaded.hash_num) == (k, h)
    # and the port's file, byte for byte the JAX package's
    path2 = str(tmp_path / f"g.{kind}")
    host.save(path2)
    assert open(path, "rb").read() == open(path2, "rb").read()


def test_device_filter_tables():
    k, h = 25, 3
    jf, arr = jax_filter("plain", k, h, rand_seq(500, seed=2))
    _, df = convert.filter_from_numpy("plain", arr, h, k, device="cpu")
    assert df.table.dtype == torch.int32 and df.modulus == jf.bits
    words = df.table.numpy().view("<u4")
    np.testing.assert_array_equal(words.view(np.uint8)[: arr.size], arr)
    jb, warr = jax_filter("blocked", k, h, rand_seq(500, seed=2))
    _, db = convert.filter_from_numpy("blocked", warr, h, k, device="cpu")
    assert db.modulus == warr.size and db.wbits == 10
