"""The torch port's mesh programs (ntedit_tpu_torch/parallel/mesh.py) in one
rank, on the CPU, against the JAX package's on its virtual CPU mesh:
tile_contig, the device-local filter builds, the sharded flag, SNV
candidate, confirmation and candidate-mask passes, the sharded gate stream,
the reduce kernels' plain versions, and the single-process identity of the
multi-host helpers.  The sharded polish: test_torch_mesh_polish.py; two
and four ranks over gloo: test_torch_multirank.py.

Where the port deliberately differs from the JAX package (windows holding a
byte that is not ACGT), a test holds the port to the host filter or the
Oracle and shows the JAX result apart."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ntedit_tpu.core import bloom as jbloom
from ntedit_tpu.engine import flag as jflag
from ntedit_tpu.engine.config import EngineConfig as JConfig
from ntedit_tpu.parallel import mesh as jmesh
from ntedit_tpu.utils import simulate
from ntedit_tpu_torch import convert
from ntedit_tpu_torch.core import bloom as tbloom
from ntedit_tpu_torch.core import nthash_ref as tref
from ntedit_tpu_torch.engine import flag as tflag
from ntedit_tpu_torch.engine.config import EngineConfig as TConfig
from ntedit_tpu_torch.ops import mesh_kernel
from ntedit_tpu_torch.parallel import distributed
from ntedit_tpu_torch.parallel import mesh as tmesh

K, H, NBITS = 25, 3, 1 << 16
SLOTS = 1 << 12


@pytest.fixture(scope="module")
def mesh():
    return tmesh.make_mesh(device="cpu")


def plain_filters(truth, k=K):
    """(JAX plain filter, its words, the port's host filter)."""
    jf = jbloom.KmerBloomFilter.zeros(NBITS // 8, H, k)
    jf.insert_seq(truth)
    th, _ = convert.filter_from_numpy("plain", jf.data, H, k, device="cpu")
    return jf, jbloom._pack_words(jf.data), th


def blocked_filters(truth, k=K):
    jf = jbloom.BlockedKmerBloomFilter.zeros(NBITS // 8, H, k)
    jf.insert_seq(truth)
    th, _ = convert.filter_from_numpy("blocked", jf.words, H, k, device="cpu")
    return jf, jf.words, th


def words_of(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy().view(np.uint32)


# ---------------------------------------------------------------------------
# tiling and the filter builds
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("length,chunk,k,multiple", [(5000, 512, 25, 1), (5000, 512, 25, 8),
                                                     (100, 64, 25, 3), (10, 32, 25, 1)])
def test_tile_contig_matches_jax(length, chunk, k, multiple):
    seq = simulate.random_genome(length, seed=length)
    want, wn = jmesh.tile_contig(seq, chunk, k, n_tiles_multiple=multiple)
    got, n = tmesh.tile_contig(seq, chunk, k, n_tiles_multiple=multiple)
    assert n == wn
    np.testing.assert_array_equal(got, want)


def acgt_rows(seed=1, with_n=False):
    genome = simulate.random_genome(2400, seed=seed)
    rows = np.stack([genome[i * 256 : i * 256 + 256 + K - 1] for i in range(8)])
    if with_n:
        rows = rows.copy()
        rows[2, 100] = rows[5, 7] = rows[7, 270] = ord("N")
    return rows


def test_build_bf_words_matches_jax_on_acgt_rows():
    rows = acgt_rows()
    want = np.asarray(jmesh.build_bf_words(jnp.asarray(rows), K, H, NBITS))
    got = words_of(tmesh.build_bf_words(rows, K, H, NBITS, device="cpu"))
    np.testing.assert_array_equal(got, want)
    host = tbloom.KmerBloomFilter.zeros(NBITS // 8, H, K)
    for row in rows:
        host.insert_seq(row)
    np.testing.assert_array_equal(got.view(np.uint8), host.data)


def count_valid_windows(rows, slots):
    """The counters btllib's counting filter holds after inserting every
    ACGT-only window of every row."""
    counts = np.zeros(slots, dtype=np.int64)
    for row in rows:
        fh, rh = tref.all_window_hashes(row, K)
        hashes = tref.extend_hashes_vec(tref.canonical(fh, rh), K, H)
        ok = np.array([set(row[i : i + K].tobytes()) <= set(b"ACGT")
                       for i in range(len(row) - K + 1)])
        np.add.at(counts, (hashes[ok] % np.uint64(slots)).astype(np.int64).reshape(-1), 1)
    return np.minimum(counts, 255).astype(np.uint8)


def test_build_cbf_counts_matches_jax_on_acgt_rows():
    rows = acgt_rows()
    want = np.asarray(jmesh.build_cbf_counts(jnp.asarray(rows), K, H, SLOTS))
    got = tmesh.build_cbf_counts(rows, K, H, SLOTS, device="cpu").numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, count_valid_windows(rows, SLOTS))


def test_builds_skip_windows_with_an_n():
    """A deliberate difference: the JAX builds hash every window, an N's
    too (its hash is deterministic garbage), as the host filter's
    insert_seq does on a whole row; the port skips windows that are not
    ACGT only, as its read-filter build (polish --reads) and btllib do: its
    filter is insert_seq of each row's ACGT runs."""
    rows = acgt_rows(with_n=True)
    runs = tbloom.KmerBloomFilter.zeros(NBITS // 8, H, K)
    whole = tbloom.KmerBloomFilter.zeros(NBITS // 8, H, K)
    for row in rows:
        whole.insert_seq(row)
        for run in row.tobytes().split(b"N"):
            if len(run) >= K:
                runs.insert_seq(np.frombuffer(run, dtype=np.uint8))
    got = words_of(tmesh.build_bf_words(rows, K, H, NBITS, device="cpu"))
    np.testing.assert_array_equal(got.view(np.uint8), runs.data)
    jax_words = np.asarray(jmesh.build_bf_words(jnp.asarray(rows), K, H, NBITS))
    np.testing.assert_array_equal(jax_words.view(np.uint8), whole.data)
    assert not np.array_equal(jax_words, got)
    counts = tmesh.build_cbf_counts(rows, K, H, SLOTS, device="cpu").numpy()
    np.testing.assert_array_equal(counts, count_valid_windows(rows, SLOTS))
    jax_counts = np.asarray(jmesh.build_cbf_counts(jnp.asarray(rows), K, H, SLOTS))
    assert not np.array_equal(jax_counts, counts)


def test_build_checks_its_table_size():
    with pytest.raises(ValueError, match="power of two"):
        tmesh.build_bf_words(acgt_rows(), K, H, 3 << 10, device="cpu")
    with pytest.raises(ValueError, match="power of two"):
        tmesh.build_cbf_counts(acgt_rows(), K, H, 1 << 33, device="cpu")


# ---------------------------------------------------------------------------
# the sharded passes
# ---------------------------------------------------------------------------

def flag_draft(seed, with_n=False):
    truth = simulate.random_genome(4000, seed=seed)
    draft, _ = simulate.inject_errors(truth, sub_rate=3e-3, seed=seed + 1)
    draft = draft.copy()
    if with_n:
        draft[1000:1004] = ord("N")
    return truth, draft


@pytest.mark.parametrize("devices,layout,snv", [(1, "plain", False), (8, "plain", False),
                                                (8, "blocked", False), (1, "blocked", True)])
def test_sharded_flag_matches_jax(mesh, devices, layout, snv):
    truth, draft = flag_draft(3, with_n=True)
    jf, words, _ = (plain_filters if layout == "plain" else blocked_filters)(truth)
    tiles, n = jmesh.tile_contig(draft, 512, K, n_tiles_multiple=8)
    want = np.asarray(jmesh.sharded_flag(jmesh.make_mesh(devices), tiles, words, k=K,
                                         hash_num=H, nbits=NBITS, snv=snv,
                                         blocked=layout == "blocked"))
    got = words_of(tmesh.sharded_flag(mesh, tiles, words, k=K, hash_num=H, nbits=NBITS,
                                      snv=snv, blocked=layout == "blocked"))
    assert got.shape == want.shape == (tiles.shape[0], 512 // 32)
    np.testing.assert_array_equal(tflag.packed_to_positions(got.reshape(-1), n),
                                  jflag.packed_to_positions(want.reshape(-1), n))
    assert len(tflag.packed_to_positions(got.reshape(-1), n)) > 0


def test_sharded_flag_forces_iupac_windows(mesh):
    """A deliberate difference: the port's gate kernel forces the windows
    holding an accepted IUPAC byte, as the JAX package's gate stream does
    on the host (iter_sharded_gate_chunks, flag._exception_hints); its
    ASCII sharded_flag leaves them to the filter."""
    truth, draft = flag_draft(3, with_n=True)
    draft[2000] = ord("R")
    jf, words, _ = plain_filters(truth)
    jf.insert_seq(draft[1950:2050])  # the IUPAC windows' hashes are in the filter
    words = jbloom._pack_words(jf.data)
    tiles, n = jmesh.tile_contig(draft, 512, K, n_tiles_multiple=8)
    got = tflag.packed_to_positions(words_of(tmesh.sharded_flag(
        mesh, tiles, words, k=K, hash_num=H, nbits=NBITS)).reshape(-1), n)
    stream = [g for _, g in jmesh.iter_sharded_gate_chunks(
        jmesh.make_mesh(1), draft, words, JConfig(k=K, hash_num=H), nbits=NBITS, cbytes=0,
        blocked=False, counting=False, chunk=1024)]
    np.testing.assert_array_equal(got, np.concatenate(stream))
    ascii_flag = jflag.packed_to_positions(np.asarray(jmesh.sharded_flag(
        jmesh.make_mesh(1), tiles, words, k=K, hash_num=H, nbits=NBITS)).reshape(-1), n)
    iupac = np.arange(2000 - K + 1, 2001)
    np.testing.assert_array_equal(got, np.union1d(ascii_flag, iupac))
    assert not np.isin(iupac, ascii_flag).any()


def snv_truth(seed=70, length=6000):
    """A reference and a filter that holds it and a copy with variants
    (the JAX package's test_sharded_snv_equals_sequential)."""
    truth = simulate.random_genome(length, seed=seed)
    variant = truth.copy()
    rng = np.random.default_rng(seed + 1)
    for pos in rng.integers(100, length - 100, size=12):
        variant[pos] = b"ACGT"[int(rng.integers(0, 4))]
    jf = jbloom.BlockedKmerBloomFilter.zeros(NBITS // 8, H, K)
    jf.insert_seq(truth)
    jf.insert_seq(variant)
    th, _ = convert.filter_from_numpy("blocked", jf.words, H, K, device="cpu")
    return truth, jf, th


@pytest.mark.parametrize("devices", [1, 8])
def test_sharded_snv_candidates_match_jax(mesh, devices):
    truth, jf, _ = snv_truth()
    tiles, n = jmesh.tile_contig(truth, 512, K, n_tiles_multiple=8)
    want = np.asarray(jmesh.sharded_snv_candidates(jmesh.make_mesh(devices), tiles, jf.words,
                                                   k=K, hash_num=H, nbits=jf.bits,
                                                   blocked=True))
    got = words_of(tmesh.sharded_snv_candidates(mesh, tiles, jf.words, k=K, hash_num=H,
                                                nbits=jf.bits, blocked=True))
    cand = tflag.packed_to_positions(got.reshape(-1), n)
    np.testing.assert_array_equal(cand, jflag.packed_to_positions(want.reshape(-1), n))
    assert len(cand) >= 12


def site_windows(draft, step=7, rows=40):
    return np.stack([draft[i : i + 2 * K] for i in range(0, step * rows, step)])


@pytest.mark.parametrize("devices,layout,jump", [(1, "plain", 3), (8, "plain", 1),
                                                 (8, "blocked", 3)])
def test_sharded_confirm_matches_jax(mesh, devices, layout, jump):
    truth, draft = flag_draft(5)
    draft = draft.copy()
    draft[100:300:9] = ord("A")  # absent k-mers in most windows
    jf, words, _ = (plain_filters if layout == "plain" else blocked_filters)(truth)
    W = site_windows(draft)
    want_miss, want_gate = jmesh.sharded_confirm(jmesh.make_mesh(devices), W, words, k=K,
                                                 jump=jump, hash_num=H, nbits=NBITS,
                                                 blocked=layout == "blocked")
    miss, gate = tmesh.sharded_confirm(mesh, W, words, k=K, jump=jump, hash_num=H,
                                       nbits=NBITS, blocked=layout == "blocked")
    assert miss.dtype == torch.int32 and gate.dtype == torch.bool
    np.testing.assert_array_equal(miss.numpy(), np.asarray(want_miss))
    np.testing.assert_array_equal(gate.numpy(), np.asarray(want_gate))
    assert gate.any() and (miss > 0).any() and not gate.all()


def oracle_count(row, host, jump):
    """The Oracle's subset-missing count of a row (oracle.py _fix_site): the
    strided windows 1..k absent from the filter, stopping at the first
    window that takes in a byte failing isAcceptedBase."""
    miss = 0
    for j in range(1, K + 1):
        win = row[j : j + K]
        if not set(win.tobytes()) <= set(b"ACGTacgt"):
            break
        if (j - 1) % jump == 0 and not host.contains_seq_kmers(win)[0]:
            miss += 1
    return miss


def test_confirm_follows_the_oracle_at_an_n(mesh):
    """A deliberate difference: a window holding an N neither gates nor
    counts as absent in the port (the Oracle stops its count at the N);
    the JAX package hashes it as garbage and counts it."""
    truth, _ = flag_draft(7)
    jf, words, host = plain_filters(truth)
    W = site_windows(truth, step=11, rows=16).copy()
    for r in range(0, 16, 2):
        W[r, K + 3 * r % K] = ord("N")
    miss, gate = tmesh.sharded_confirm(mesh, W, words, k=K, jump=3, hash_num=H, nbits=NBITS)
    assert miss.tolist() == [oracle_count(row, host, 3) for row in W]
    assert not gate.any()  # the truth's windows are all in the filter
    jax_miss, _ = jmesh.sharded_confirm(jmesh.make_mesh(1), W, words, k=K, jump=3,
                                        hash_num=H, nbits=NBITS)
    assert (np.asarray(jax_miss)[::2] > miss.numpy()[::2]).any()
    np.testing.assert_array_equal(np.asarray(jax_miss)[1::2], miss.numpy()[1::2])


@pytest.mark.parametrize("devices", [1, 8])
def test_masks_match_the_jax_planes(mesh, devices):
    """The masks at the gates equal flag.cand_masks_from_planes of the JAX
    package's sharded planes, what its sharded polish takes from them."""
    truth, draft = flag_draft(9, with_n=True)
    draft[2500] = ord("R")
    jf, words, th = blocked_filters(truth)
    tdf = tbloom.DeviceFilter.from_host(th, "cpu")
    gates = tflag.flag_contig_gates(draft, tdf)
    tiles, _ = jmesh.tile_contig(draft, 512, K, n_tiles_multiple=devices)
    pw = np.asarray(jmesh.sharded_polish_cand_planes(jmesh.make_mesh(devices), tiles, words,
                                                     k=K, hash_num=H, nbits=jf.bits,
                                                     blocked=True))
    want = jflag.cand_masks_from_planes(pw.transpose(1, 0, 2).reshape(5, -1), gates)
    got = tmesh.sharded_polish_cand_masks(mesh, draft, gates, words, k=K, hash_num=H,
                                          nbits=jf.bits, blocked=True)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want == 0xFF).any() and (want != 0xFF).any()
    assert tmesh.sharded_polish_cand_masks(mesh, draft, gates[:0], words, k=K, hash_num=H,
                                           nbits=jf.bits, blocked=True).shape == (0,)


def test_gate_stream_matches_jax():
    """The sharded gate stream's frontiers and gates equal the JAX
    package's at one device, exception windows included (an N run removed,
    an IUPAC byte forced), and the port's single-device gate pass."""
    truth = simulate.random_genome(50_000, seed=80)
    draft, _ = simulate.inject_errors(truth, sub_rate=3e-3, seed=81)
    draft = draft.copy()
    draft[5000] = ord("N")
    draft[20000] = ord("R")
    jf, words, th = plain_filters(truth)
    kw = dict(nbits=NBITS, cbytes=0, blocked=False, counting=False, chunk=1024)
    want = list(jmesh.iter_sharded_gate_chunks(jmesh.make_mesh(1), draft, words,
                                               JConfig(k=K, hash_num=H), **kw))
    got = list(tmesh.iter_sharded_gate_chunks(tmesh.make_mesh(device="cpu"), draft, words,
                                              TConfig(k=K, hash_num=H), **kw))
    assert [f for f, _ in got] == [f for f, _ in want]
    np.testing.assert_array_equal(np.concatenate([g for _, g in got]),
                                  np.concatenate([g for _, g in want]))
    np.testing.assert_array_equal(
        np.concatenate([g for _, g in got]),
        tflag.flag_contig_gates(draft, tbloom.DeviceFilter.from_host(th, "cpu")))


# ---------------------------------------------------------------------------
# the collectives in one rank, the reduce's plain versions, the identity
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [0, 1, 5, 37, 4096 + 3])
def test_collectives_of_one_rank_are_the_identity(mesh, n):
    rng = np.random.default_rng(n)
    words = torch.from_numpy(rng.integers(-2**31, 2**31, size=n).astype(np.int32))
    counts = torch.from_numpy(rng.integers(0, 256, size=n).astype(np.uint8))
    assert torch.equal(tmesh.ring_or(words, mesh), words)
    assert torch.equal(tmesh.saturating_add_allreduce(counts, mesh), counts)


def reduce_rows(d, m, seed):
    """int32 words [d, m] (zero, all-ones and random rows) and uint8
    counters [d, m] at 0, 1, 128, 254 and 255 and random."""
    rng = np.random.default_rng(seed)
    words = rng.integers(-2**31, 2**31, size=(d, m)).astype(np.int32)
    words[0, : m // 3] = 0
    words[-1, m // 2 :] = -1
    edges = np.array([0, 1, 128, 254, 255], dtype=np.uint8)
    counts = edges[rng.integers(0, 5, size=(d, m))]
    counts[:, ::3] = rng.integers(0, 256, size=(d, len(range(0, m, 3))))
    return words, counts


@pytest.mark.parametrize("d", [1, 2, 3, 4, 8])
def test_reduce_plain_versions(d):
    for m in (1, 3, 15, 16, 17, 70):
        words, counts = reduce_rows(d, m, seed=d * 100 + m)
        got = mesh_kernel.or_rows(torch.from_numpy(words)).numpy()
        np.testing.assert_array_equal(got, np.bitwise_or.reduce(words, axis=0))
        got = mesh_kernel.sat_add_rows(torch.from_numpy(counts)).numpy()
        np.testing.assert_array_equal(got, np.minimum(counts.astype(np.int64).sum(0), 255))
    forty = torch.full((8, 64), 40, dtype=torch.uint8)  # 8 * 40 = 320 saturates
    assert (mesh_kernel.sat_add_rows(forty[:d]) == min(40 * d, 255)).all()
    with pytest.raises(ValueError):
        mesh_kernel.or_rows(torch.zeros((d, 4), dtype=torch.int64))
    with pytest.raises(ValueError):
        mesh_kernel.sat_add_rows(torch.zeros((0, 4), dtype=torch.uint8))


def test_single_process_identity():
    """Single-process, the multi-host helpers are the identity and the
    mesh is a world of one; initialize does nothing without a
    coordinator."""
    distributed.initialize()
    distributed.initialize_from_env("cpu")
    assert not distributed.active()
    assert distributed.process_slice(10) == slice(0, 10)
    assert distributed.process_slice(0) == slice(0, 0)
    recs = [("ctg1", [1, 2]), ("ctg2", [3])]
    assert distributed.gather_records(recs) == recs
    m = tmesh.make_mesh(device="cpu")
    assert (m.size, m.rank, m.group) == (1, 0, None)
    with pytest.raises(ValueError, match="process group"):
        tmesh.make_mesh(2, device="cpu")
    assert distributed.backend_for("cpu") == "gloo"
    assert distributed.backend_for("cuda") == "cpu:gloo,cuda:nccl"
