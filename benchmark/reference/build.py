"""The reference's read filter, in plain torch int64 on any device: the
ntCard-role histogram and the ntStat-role filter of ``polish --reads``,
worked out again from the reads.

Frozen for the benchmark's plain reference from the semantics of
``ntedit_tpu_torch/core/bfbuild.py`` (``Histogram``, ``SampledHashes``,
``filter_sizes``, ``build_read_filter`` with the blocked layout) and the
plain versions of ``ntedit_tpu_torch/ops/build_kernel.py``, as the
benchmark was written; it imports nothing of the port.

* The histogram counts every valid window (all k bytes ACGT, upper or
  lower case) of every read.  Its distinct count and spectrum are exact
  while at most ``sample_budget`` hashes are kept; beyond, the hashes whose
  splitmix64-mixed key has its top s bits clear are kept, s the smallest
  that fits, and the counts scale by 2^s.
* The filter holds the k-mers whose count-min read (the minimum over
  hash_num saturating byte counters at ``h_j mod slots``) is at least the
  cutoff, in the blocked layout, sized by ``pow2_size_bytes`` for the
  distinct k-mers at or above the cutoff.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from benchmark.reference import device as rd
from benchmark.reference import nthash_ref as ref

MIX1 = 0x9E3779B97F4A7C15
MIX2 = 0xBF58476D1CE4E5B9


def _signed(v: int) -> int:
    v &= (1 << 64) - 1
    return v - (1 << 64) if v >> 63 else v


def extend(base: torch.Tensor, k: int, m: int) -> list:
    """ntHash's multi-hash: h[0] = base, h[i] = t ^ (t >> 27) with
    t = base * (i ^ k * MULTISEED)."""
    out = [base]
    for i in range(1, m):
        t = base * _signed(i ^ (k * int(ref.MULTISEED)))
        out.append(t ^ rd.shr(t, int(ref.MULTISHIFT)))
    return out


def in_slice(h: torch.Tensor, s: int) -> torch.Tensor:
    """The hashes whose splitmix64-mixed key has its top s bits clear."""
    if s == 0:
        return torch.ones_like(h, dtype=torch.bool)
    x = h * _signed(MIX1)
    x = x ^ rd.shr(x, 29)
    x = x * _signed(MIX2)
    x = x ^ rd.shr(x, 32)
    return rd.shr(x, 64 - s) == 0


def bf_size_bytes(n: int, hash_num: int = 3, fpr: float = 0.01) -> int:
    """Broder-Mitzenmacher sizing (ntedit_make_genome_bf.cpp:41-47)."""
    r = -hash_num / math.log(1.0 - math.exp(math.log(fpr) / hash_num))
    return int(math.ceil(n * r)) // 8


def pow2_size_bytes(n: int, hash_num: int = 3, fpr: float = 0.01) -> int:
    b = max(8, bf_size_bytes(n, hash_num, fpr))
    return 1 << (b - 1).bit_length()


def read_hashes(reads: torch.Tensor, k: int) -> torch.Tensor:
    """Canonical hashes (int64) of the valid windows of equal-length reads
    [r, L] (uint8 ASCII), read by read."""
    r, L = reads.shape
    flat = reads.reshape(-1)
    n = flat.numel() - k + 1
    valid, iupac = rd.window_flags(flat, n, k)
    start = torch.arange(n, device=reads.device) % L
    valid &= ~iupac & (start <= L - k)
    fh, rh = rd.window_hashes(flat, k)
    return rd.canonical(fh, rh)[valid]


def histogram(can: torch.Tensor, max_count: int = 255, sample_budget: int = 1 << 26) -> tuple:
    """-> (F1, F0, spectrum np.int64 [max_count + 1])."""
    s = 0
    while int(in_slice(can, s).sum()) > sample_budget:
        s += 1
    kept = can[in_slice(can, s)]
    uniq, counts = torch.unique(kept, return_counts=True)
    spec = torch.bincount(counts.clamp(max=max_count), minlength=max_count + 1).cpu().numpy()
    spec = spec.astype(np.int64) * (1 << s)
    spec[0] = 0
    return int(can.numel()), int(uniq.numel()) * (1 << s), spec


def histogram_text(f1: int, f0: int, spec: np.ndarray) -> str:
    """ntCard's .hist text format."""
    return f"F1\t{f1}\nF0\t{f0}\n" + "".join(f"{i}\t{int(spec[i])}\n" for i in range(1, len(spec)))


def read_filter(can: torch.Tensor, k: int, f0: int, spec: np.ndarray, cutoff: int = 2,
                hash_num: int = 3, fpr: float = 0.01) -> np.ndarray:
    """The blocked read filter's words (uint32): the k-mers whose
    count-min read is at least ``cutoff``."""
    n_solid = max(1, f0 - int(spec[1:cutoff].sum())) if cutoff > 1 else max(1, f0)
    words = pow2_size_bytes(n_solid, hash_num, fpr) * 8 // 32
    if cutoff > 1:
        cbf_slots = bf_size_bytes(f0, hash_num, fpr) * 8
        slots = 1 << max(12, (cbf_slots - 1).bit_length())
        idx = [h & (slots - 1) for h in extend(can, k, hash_num)]
        counters = torch.bincount(torch.cat(idx), minlength=slots).clamp(max=255)
        least = torch.stack([counters[i] for i in idx]).min(0).values
        can = can[least >= cutoff]
    widx, mask = rd.word_and_mask(can, words, hash_num)
    bits = torch.zeros(words * 32, dtype=torch.uint8, device=can.device)
    wbits = words.bit_length() - 1
    for j in range(hash_num):
        bits[widx * 32 + (rd.shr(can, wbits + 5 * j) & 31)] = 1
    lanes = torch.arange(32, dtype=torch.int64, device=can.device)
    packed = (bits.view(-1, 32).long() << lanes).sum(1)
    return packed.cpu().numpy().astype(np.uint32)
