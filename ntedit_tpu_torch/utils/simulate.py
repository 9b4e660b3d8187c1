"""Synthetic workloads: seeded genomes, error-injected drafts and filters.

``random_genome`` and ``inject_errors`` are a copy of the JAX package's
generators (the port keeps its own host code).  The reference validates
against an E. coli demo (draft with ~0.001 substitution and ~0.0001 indel
rates, README.md:333); these produce the same *shape* of workload from a
seed, without the network.  ``decorate`` adds the bytes a draft must
survive, ``polish_genome`` makes the polish workload's truths and drafts,
``snv_genome`` makes the SNV workload (a reference and a copy
with substitutions), and ``fill_counts`` and ``chunk_filters`` build the
filters the card's runs time the gate kernel with (chip_smoke.py).
"""

from __future__ import annotations

import numpy as np

from ntedit_tpu_torch.core import bloom
from ntedit_tpu_torch.core import nthash_ref as ref

BASES = np.frombuffer(b"ACGT", dtype=np.uint8)
IUPAC = np.frombuffer(b"RYSWKMBDHV", dtype=np.uint8)


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


def decorate(draft: np.ndarray, rng, n_runs: int, n_iupac: int, lower: int) -> np.ndarray:
    """Put short N runs, IUPAC bytes and one lowercase stretch into a draft."""
    d = draft.copy()
    L = len(d)
    for p in rng.integers(0, max(1, L - 16), size=n_runs):
        d[p : p + int(rng.integers(1, 13))] = ord("N")
    d[rng.integers(0, L, size=n_iupac)] = IUPAC[rng.integers(0, len(IUPAC), size=n_iupac)]
    if lower:
        a = int(rng.integers(0, max(1, L - lower)))
        d[a : a + lower] |= 0x20
    return d


def polish_genome(lengths, seed: int) -> tuple:
    """(truths, drafts): seeded truth contigs and their drafts
    (inject_errors' defaults plus N runs, IUPAC bytes and a lowercase
    stretch; a contig of 1000 bases or fewer is its own draft)."""
    rng = np.random.default_rng(seed)
    truths, drafts = [], []
    for i, L in enumerate(lengths):
        t = random_genome(L, seed=seed + 2 * i)
        d = t
        if L > 1000:
            d, _ = inject_errors(t, seed=seed + 2 * i + 1)
            d = decorate(d, rng, n_runs=max(1, L // 5_000_000),
                         n_iupac=max(1, L // 1_000_000), lower=min(2000, L // 10))
        truths.append(t)
        drafts.append(d)
    return truths, drafts


def snv_genome(lengths, seed: int):
    """(references, variants, planted): seeded reference contigs with a few
    N runs, IUPAC bytes and a lowercase stretch, and for each a copy of the
    clean reference with substitutions only, about 1 per kbp: the genome
    whose k-mers the filter holds; and the number of substitutions."""
    rng = np.random.default_rng(seed)
    refs, variants, planted = [], [], 0
    for i, L in enumerate(lengths):
        t = random_genome(L, seed=seed + 2 * i)
        v, r = t, t
        if L > 1000:
            v, edits = inject_errors(t, sub_rate=1e-3, ins_rate=0.0, del_rate=0.0,
                                     seed=seed + 2 * i + 1)
            planted += len(edits)
            r = decorate(t, rng, n_runs=max(1, L // 5_000_000), n_iupac=max(1, L // 1_000_000),
                         lower=min(2000, L // 10))
        refs.append(r)
        variants.append(v)
    return refs, variants, planted


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


SITE_LIST_SPAN = 1600  # heads the middle lists of ``site_lists`` span past ``at``


def site_lists(n: int, k: int, at: int) -> dict:
    """Sorted int64 head lists that exercise the site kernels' index logic
    on a contig of ``n`` heads (n + k - 1 bytes); the middle ones lie in
    [at, at + SITE_LIST_SPAN):

    * ``all_starts``: 601 heads 2 or 3 apart, every one a cluster start;
    * ``long_cluster``: a cluster of 300 heads between isolated ones;
    * ``block_edges``: cluster starts at list index 0, 255-258 and 511-514
      (clusters of 255 and 253 heads, each followed by three isolated
      ones, then a cluster of 40): a polish block takes 512 gates, two a
      thread, 256 apart;
    * ``overlapping``: neighbours k to 2k - 1 apart, whose [h, h + 2k)
      overlap (each one a substitution's SNV candidate);
    * ``ends_at``: h + 2k = n, and h + 2k = n + k - 1 (the contig's last
      byte: the last valid row);
    * ``ends_past``: h + 2k = n + 1, and n + k (one byte past the contig)."""
    lists = {
        "all_starts": at + np.concatenate([[0], np.cumsum(np.resize([2, 3], 600))]),
        "long_cluster": np.concatenate([at + np.array([0, 3]), at + 10 + np.arange(300),
                                        at + 320 + np.array([0, 4])]),
        "block_edges": np.concatenate([at + np.arange(255), at + 260 + 3 * np.arange(3),
                                       at + 270 + np.arange(253), at + 526 + 3 * np.arange(3),
                                       at + 540 + np.arange(40)]),
        "overlapping": at + np.cumsum([0, k, k + 1, 2 * k - 1, k]),
        "ends_at": np.array([n - 2 * k, n - k - 1]),
        "ends_past": np.array([n - 2 * k + 1, n - k]),
    }
    return {name: h.astype(np.int64) for name, h in lists.items()}
