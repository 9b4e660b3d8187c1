"""The torch port's mesh programs in two and four ranks over gloo: one
process per rank, spawned on the CPU (python -m
ntedit_tpu_torch.parallel.check, which imports no JAX), meeting at a file
under the test's temporary directory; inputs and results travel as .npz
files.  Every rank must hold the same result, equal to the JAX package's
on its virtual CPU mesh: ring_or and saturating_add_allreduce on sizes
that D and 16 bytes do not divide, sharded_bf_build and sharded_cbf_build
(make_mesh(8)), sharded_flag, iter_sharded_gate_chunks' frontiers and
gates at the same D, and sharded_polish (make_mesh(2)); gather_records
concatenates in rank order; make_mesh(1) holds rank 0 alone."""

import json
import os
import subprocess
import sys
from functools import partial

import numpy as np
import pytest

import jax
from jax.sharding import PartitionSpec as P

from ntedit_tpu.core import bloom as jbloom
from ntedit_tpu.engine.config import EngineConfig as JConfig
from ntedit_tpu.engine.flag import packed_to_positions
from ntedit_tpu.io import writers as jwriters
from ntedit_tpu.parallel import mesh as jmesh
from ntedit_tpu.utils import simulate

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
K, H, NBITS, SLOTS = 25, 3, 1 << 16, 1 << 12
N_OR, N_SAT = 1001, 77  # neither a multiple of D nor of 16 bytes
TIMEOUT = 120


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(3)
    genome = simulate.random_genome(2400, seed=1)
    rows = np.stack([genome[i * 256 : i * 256 + 256 + K - 1] for i in range(8)])
    truth = simulate.random_genome(12_000, seed=62)
    draft, _ = simulate.inject_errors(truth, sub_rate=3e-3, ins_rate=1e-3, del_rate=1e-3,
                                      seed=63)
    draft = draft.copy()
    draft[4000:4004] = ord("N")
    draft[9000] = ord("R")
    jf = jbloom.KmerBloomFilter.zeros(NBITS // 8, H, K)
    jf.insert_seq(truth)
    tiles, n = jmesh.tile_contig(draft, 512, K, n_tiles_multiple=8)
    or_parts = rng.integers(-2**31, 2**31, size=(4, N_OR)).astype(np.int32)
    or_parts[:, :100] = 0
    or_parts[1, 100:200] = -1
    sat_parts = np.array([0, 1, 128, 254, 255], dtype=np.uint8)[rng.integers(0, 5, (4, N_SAT))]
    sat_parts[:, :10] = 40  # four ranks: 160; with more, saturated
    return dict(k=K, hash_num=H, nbits=NBITS, slots=SLOTS, rows=rows, filter_data=jf.data,
                tiles=tiles, n_heads=n, draft=draft, chunk=0, or_parts=or_parts,
                sat_parts=sat_parts), jf


def jax_allreduce(parts, fn):
    """The JAX collective over make_mesh(D), rank r holding row r."""
    mesh = jmesh.make_mesh(parts.shape[0])

    @partial(jmesh.shard_map, mesh=mesh, in_specs=P("d"), out_specs=P(), check_vma=False)
    def step(x):
        return fn(x[0], "d")

    return np.asarray(jax.jit(step)(parts))


def render(result) -> tuple:
    import io

    sinks = io.StringIO(), io.StringIO(), io.StringIO()
    jwriters.write_contig(result, *sinks, {})
    return tuple(s.getvalue() for s in sinks)


@pytest.fixture(scope="module")
def jax_refs(inputs):
    inp, jf = inputs
    words = jbloom._pack_words(jf.data)
    cfg = JConfig(k=K, hash_num=H)
    rows = inp["rows"]
    refs = {
        "bf": np.asarray(jmesh.sharded_bf_build(jmesh.make_mesh(8), rows, K, H, NBITS)),
        "cbf": np.asarray(jmesh.sharded_cbf_build(jmesh.make_mesh(8), rows, K, H, SLOTS)),
        "flag": np.asarray(jmesh.sharded_flag(jmesh.make_mesh(2), inp["tiles"], words, k=K,
                                              hash_num=H, nbits=NBITS)),
        "polish": render(jmesh.sharded_polish(jmesh.make_mesh(2), "ctg", inp["draft"], jf,
                                              words, cfg)),
    }
    for d in (2, 4):
        refs["or", d] = jax_allreduce(inp["or_parts"][:d], jmesh.ring_or)
        refs["sat", d] = jax_allreduce(inp["sat_parts"][:d], jmesh.saturating_add_allreduce)
        chunks = list(jmesh.iter_sharded_gate_chunks(
            jmesh.make_mesh(d), inp["draft"], words, cfg, nbits=NBITS, cbytes=0,
            blocked=False, counting=False))
        refs["frontiers", d] = np.asarray([f for f, _ in chunks])
        refs["gates", d] = np.concatenate([g for _, g in chunks])
    return refs


def run_ranks(tmp_path, inp: dict, world: int) -> list:
    """Spawn ``world`` ranks of the check module on the CPU; their results."""
    np.savez(tmp_path / "in.npz", **inp)
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""),
               OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-m", "ntedit_tpu_torch.parallel.check",
         "--init", f"file://{tmp_path / 'rendezvous'}", "--world", str(world),
         "--rank", str(r), "--inputs", str(tmp_path / "in.npz"),
         "--out", str(tmp_path / f"out{r}.npz"), "--device", "cpu"],
        cwd=str(tmp_path), env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=TIMEOUT)[0])
    finally:
        for p in procs:
            p.kill()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} failed:\n{log}"
    outs = []
    for r in range(world):
        with np.load(tmp_path / f"out{r}.npz") as f:
            outs.append({key: f[key] for key in f.files})
    return outs


def text(arr) -> str:
    return arr.tobytes().decode()


@pytest.mark.parametrize("world", [2, 4])
def test_ranks_match_jax(tmp_path, inputs, jax_refs, world):
    inp = dict(inputs[0])
    n = int(inp.pop("n_heads"))
    outs = run_ranks(tmp_path, inp, world)
    # make_mesh(1): rank 0 alone, every other rank outside it
    assert [int(out.pop("sub_rank")) for out in outs] == [0] + [-1] * (world - 1)
    np.testing.assert_array_equal(outs[0].pop("sub_or"), inp["or_parts"][0])
    for key in outs[0]:  # every rank holds the same result
        for r, out in enumerate(outs[1:], 1):
            np.testing.assert_array_equal(out[key], outs[0][key], err_msg=f"{key}, rank {r}")
    got = outs[0]
    np.testing.assert_array_equal(got["or"], jax_refs["or", world])
    np.testing.assert_array_equal(got["or"], np.bitwise_or.reduce(inp["or_parts"][:world]))
    np.testing.assert_array_equal(got["sat"], jax_refs["sat", world])
    np.testing.assert_array_equal(got["bf"].view(np.uint32), jax_refs["bf"])
    np.testing.assert_array_equal(got["cbf"], jax_refs["cbf"])
    flag = got["flag"].view(np.uint32)
    assert flag.shape == jax_refs["flag"].shape
    # the gates of the JAX package's stream, its exception windows patched
    # (the IUPAC byte's windows forced: its ASCII sharded_flag leaves them,
    # test_torch_mesh.py::test_sharded_flag_forces_iupac_windows)
    np.testing.assert_array_equal(packed_to_positions(flag.reshape(-1), n),
                                  jax_refs["gates", world])
    np.testing.assert_array_equal(got["frontiers"], jax_refs["frontiers", world])
    np.testing.assert_array_equal(got["gates"], jax_refs["gates", world])
    assert (text(got["polish_fa"]), text(got["polish_tsv"]),
            text(got["polish_vcf"])) == jax_refs["polish"]
    assert json.loads(text(got["records"])) == [[r, "r" * r] for r in range(world)]
