"""Synthetic workloads: seeded genomes and error-injected drafts.

A copy of the JAX package's generators (the port keeps its own host code).
The reference validates against an E. coli demo (draft with ~0.001
substitution and ~0.0001 indel rates, README.md:333); these produce the
same *shape* of workload from a seed, without the network.
"""

from __future__ import annotations

import numpy as np

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
