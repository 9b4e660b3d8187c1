"""The torch port's plain ntHash2 functions against the JAX package: its
numpy spec (nthash_ref) and its device functions (nthash), bit for bit,
on the same seeded inputs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ntedit_tpu.core import nthash as jnt
from ntedit_tpu.core import nthash_ref as ref
from ntedit_tpu_torch.core import nthash as tnt

BASES = np.frombuffer(b"ACGTacgt", dtype=np.uint8)


def rand_seq(n, seed):
    return BASES[np.random.default_rng(seed).integers(0, 8, size=n)]


def pair_to_u64(pair):
    hi, lo = (np.asarray(x).astype(np.uint64) for x in pair)
    return (hi << np.uint64(32)) | lo


def u64_to_pair(x):
    x = np.asarray(x, dtype=np.uint64)
    return (jnp.asarray((x >> np.uint64(32)).astype(np.uint32)),
            jnp.asarray((x & np.uint64(0xFFFFFFFF)).astype(np.uint32)))


def top_bit_hashes(n, seed):
    """Random uint64 values, every one with bit 63 set."""
    x = np.random.default_rng(seed).integers(0, 1 << 63, size=n, dtype=np.uint64)
    return x | np.uint64(1 << 63)


@pytest.mark.parametrize("k", [17, 25, 40])
def test_window_hashes_match_ref_and_jax(k):
    seq = rand_seq(2600, seed=k)  # heads past the 1023 srol period
    seq[[5, 1500]] = ord("N")
    fh, rh = tnt.window_hashes(torch.from_numpy(seq), k)
    want_f, want_r = ref.all_window_hashes(seq, k)
    np.testing.assert_array_equal(tnt.as_uint64(fh), want_f)
    np.testing.assert_array_equal(tnt.as_uint64(rh), want_r)
    jf, jr = jnt.window_hashes(jnp.asarray(seq), k)
    np.testing.assert_array_equal(tnt.as_uint64(fh), pair_to_u64(jf))
    np.testing.assert_array_equal(tnt.as_uint64(rh), pair_to_u64(jr))
    can = tnt.canonical(fh, rh)
    np.testing.assert_array_equal(tnt.as_uint64(can), np.minimum(want_f, want_r))
    assert (tnt.as_uint64(can) >> np.uint64(63)).any()  # the top bit is exercised


def test_window_hashes_short_sequence():
    fh, rh = tnt.window_hashes(torch.from_numpy(rand_seq(10, seed=3)), 25)
    assert fh.numel() == 0 and rh.numel() == 0


@pytest.mark.parametrize("hash_num", [1, 2, 3, 4])
@pytest.mark.parametrize("k", [17, 25, 40])
def test_extend_matches_ref_and_jax(k, hash_num):
    base = top_bit_hashes(3000, seed=k * 10 + hash_num)
    got = tnt.extend(tnt.as_int64(base), k, hash_num)
    want = ref.extend_hashes_vec(base, k, hash_num)
    jgot = jnt.extend(u64_to_pair(base), k, hash_num)
    for j in range(hash_num):
        np.testing.assert_array_equal(tnt.as_uint64(got[j]), want[:, j])
        np.testing.assert_array_equal(pair_to_u64(jgot[j]), want[:, j])


def test_unsigned_helpers_on_top_bit():
    a = top_bit_hashes(5000, seed=1)
    b = np.random.default_rng(2).integers(0, 1 << 64, size=5000, dtype=np.uint64)
    ta, tb = tnt.as_int64(a), tnt.as_int64(b)
    np.testing.assert_array_equal(tnt.as_uint64(tnt.canonical(ta, tb)), np.minimum(a, b))
    for s in (1, 27, 33, 63):
        np.testing.assert_array_equal(tnt.as_uint64(tnt.shr(ta, s)), a >> np.uint64(s))
    for m in (3, 50_021, (1 << 36) - 5, 1 << 36):
        np.testing.assert_array_equal(tnt.as_uint64(tnt.umod(ta, m)), a % np.uint64(m))
    with np.errstate(over="ignore"):
        want = a * np.uint64(0x90B45D39FB6DA1FA)
    np.testing.assert_array_equal(tnt.as_uint64(ta * tnt._signed(0x90B45D39FB6DA1FA)), want)
    with pytest.raises(ValueError):
        tnt.umod(ta, (1 << 36) + 1)


def test_seeds_match_jax():
    seq = np.arange(256, dtype=np.uint8)
    np.testing.assert_array_equal(tnt.as_uint64(tnt.seed_of(torch.from_numpy(seq))),
                                  pair_to_u64(jnt.seed_of(jnp.asarray(seq))))
    np.testing.assert_array_equal(tnt.as_uint64(tnt.cseed_of(torch.from_numpy(seq))),
                                  pair_to_u64(jnt.cseed_of(jnp.asarray(seq))))
