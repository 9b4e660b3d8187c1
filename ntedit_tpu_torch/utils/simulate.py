"""Synthetic workloads: seeded genomes, error-injected drafts and filters.

``random_genome`` and ``inject_errors`` are a copy of the JAX package's
generators (the port keeps its own host code).  The reference validates
against an E. coli demo (draft with ~0.001 substitution and ~0.0001 indel
rates, README.md:333); these produce the same *shape* of workload from a
seed, without the network.  ``fill_counts`` and ``chunk_filters`` build the
filters the card's runs time the gate kernel with (chip_smoke.py,
utils/gate_sweep.py).
"""

from __future__ import annotations

import numpy as np

from ntedit_tpu_torch.core import bloom
from ntedit_tpu_torch.core import nthash_ref as ref

BASES = np.frombuffer(b"ACGT", dtype=np.uint8)


def random_genome(length: int, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return BASES[rng.integers(0, 4, size=length)]


def inject_errors(
    truth: np.ndarray,
    sub_rate: float = 1e-3,
    ins_rate: float = 1e-4,
    del_rate: float = 1e-4,
    max_indel: int = 3,
    min_gap: int = 60,
    seed: int = 1,
):
    """Inject isolated errors (>= min_gap apart so each is independently
    correctable — matches the demo's sparse error profile)."""
    rng = np.random.default_rng(seed)
    L = len(truth)
    n_err = int(L * (sub_rate + ins_rate + del_rate))
    if L > 300_000_000:
        # human-scale fast path: rng.choice without replacement permutes
        # all L positions (minutes + a 24 GB arange at 3 Gbp); sampled
        # integers + dedupe give the same isolated-error profile after
        # the min_gap filter below
        pos = np.unique(rng.integers(min_gap, L - min_gap, size=n_err))
    else:
        pos = np.sort(rng.choice(np.arange(min_gap, L - min_gap), size=n_err, replace=False))
    keep = np.concatenate([[True], np.diff(pos) >= min_gap])
    pos = pos[keep]
    kinds = rng.choice(
        ["sub", "ins", "del"],
        size=len(pos),
        p=np.array([sub_rate, ins_rate, del_rate]) / (sub_rate + ins_rate + del_rate),
    )
    out = []
    edits = []
    prev = 0
    for p, kind in zip(pos, kinds):
        out.append(truth[prev:p])
        if kind == "sub":
            wrong = BASES[(np.where(BASES == truth[p])[0][0] + rng.integers(1, 4)) % 4]
            out.append(np.array([wrong], dtype=np.uint8))
            edits.append((int(p), "sub", chr(truth[p]) + ">" + chr(wrong)))
            prev = p + 1
        elif kind == "ins":
            # draft has EXTRA bases -> polisher must delete them
            n = int(rng.integers(1, max_indel + 1))
            extra = BASES[rng.integers(0, 4, size=n)]
            out.append(extra)
            out.append(truth[p : p + 1])
            edits.append((int(p), "extra", extra.tobytes().decode()))
            prev = p + 1
        else:
            # draft MISSES bases -> polisher must insert them
            n = int(rng.integers(1, max_indel + 1))
            edits.append((int(p), "missing", truth[p : p + n].tobytes().decode()))
            prev = p + n
    out.append(truth[prev:])
    return np.concatenate(out), edits


def fill_counts(cbf, seq: np.ndarray, times: int = 1) -> None:
    """Insert every k-mer of ``seq`` into a counting filter ``times`` times."""
    fh, rh = ref.all_window_hashes(seq, cbf.k)
    hashes = ref.extend_hashes_vec(ref.canonical(fh, rh), cbf.k, cbf.hash_num)
    for _ in range(times):
        cbf.insert_hashes(hashes)


def chunk_filters(truth: np.ndarray, k: int, genome: int, seed: int = 34) -> dict:
    """Blocked, plain and counting host filters sized for a ``genome``-base
    assembly (3 hashes, 0.001 FPR; the counting one has a counter per bit
    of the plain one) holding every k-mer of ``truth`` (counted three
    times), plus random bits, or counts of 1-3, in an eighth of the words
    or counters for the occupancy of the rest of the genome."""
    plain_bytes = bloom.bf_size_bytes(genome, 3, 0.001)
    filters = {
        "blocked": bloom.BlockedKmerBloomFilter.zeros(bloom.pow2_size_bytes(genome, 3, 0.001), 3, k),
        "plain": bloom.KmerBloomFilter.zeros(plain_bytes, 3, k),
        "counting": bloom.KmerCountingBloomFilter8.zeros(8 * plain_bytes, 3, k),
    }
    rng = np.random.default_rng(seed)
    for name, hf in filters.items():
        if name == "counting":
            fill_counts(hf, truth, 3)
        else:
            hf.insert_seq(truth)
        arr = hf.words if name == "blocked" else (hf.data if name == "plain" else hf.counters)
        fill = rng.integers(0, arr.size, size=arr.size // 8)
        if name == "counting":
            arr[fill] = np.maximum(arr[fill], rng.integers(1, 4, size=fill.size).astype(np.uint8))
        else:
            arr[fill] |= (1 << rng.integers(0, 8 * arr.itemsize, size=fill.size)).astype(arr.dtype)
    return filters
