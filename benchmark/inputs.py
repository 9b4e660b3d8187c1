"""The benchmark's inputs, made from the seed: genomes, drafts, sample
variants and the blocked Bloom filters that hold their k-mers.

Everything large is made on the card by a ``torch.Generator`` seeded from
the run's seed, in a few bulk calls; the drafts' indels, a few thousand a
job, are placed on the host by numpy in bulk.  The filters follow the
blocked layout rule of ``reference/device.py`` (the port's
``BlockedKmerBloomFilter``): a k-mer sets hash_num bits of one 32-bit
word.  Stand-in k-mers, which fill a filter to the occupancy of a genome
larger than the slices a cell polishes, are uniform 64-bit hash values
inserted by the same rule: ntHash values are uniform, so the filter's
occupancy, and so its false-positive rate, are those of the whole
genome's filter.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference import device as rd

ACGT = torch.tensor(list(b"ACGT"), dtype=torch.uint8)
SEED_MASK = (1 << 63) - 1


def generator(seed: int, salt: int, device) -> torch.Generator:
    """A generator of its own for each thing a run makes (``salt``), so
    that adding one thing moves no other."""
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 1_000_003 + salt) & SEED_MASK)
    return g


def host_rng(seed: int, salt: int) -> np.random.Generator:
    return np.random.default_rng([int(seed) & SEED_MASK, salt])


def random_bases(n: int, gen: torch.Generator, device) -> torch.Tensor:
    """n uniform ACGT bytes (uint8) on ``device``."""
    idx = torch.randint(0, 4, (n,), generator=gen, device=device)
    return ACGT.to(device)[idx]


def draft_with_errors(truth: np.ndarray, rng: np.random.Generator, sub_rate: float,
                      ins_rate: float, del_rate: float, max_indel: int,
                      min_gap: int) -> np.ndarray:
    """The truth with isolated errors at least ``min_gap`` apart (the
    demo draft's profile; ``utils/simulate.inject_errors``'s model): a
    substitution, extra bases the polisher must delete, or missing bases
    it must insert, each of 1..max_indel bases.  The number of errors is
    fixed by the length and the rates."""
    L = len(truth)
    n_err = int(L * (sub_rate + ins_rate + del_rate))
    # spacing: a uniform composition of the free length, so the errors
    # stay min_gap apart and their count does not depend on the seed
    free = L - 2 * min_gap - n_err * min_gap
    cuts = np.sort(rng.integers(0, max(1, free), size=n_err))
    pos = min_gap + cuts + np.arange(n_err) * min_gap
    kinds = rng.choice(3, size=n_err, p=np.array([sub_rate, ins_rate, del_rate]) / (sub_rate + ins_rate + del_rate))
    lens = rng.integers(1, max_indel + 1, size=n_err)
    shift = rng.integers(1, 4, size=n_err)
    extra = np.frombuffer(b"ACGT", dtype=np.uint8)[rng.integers(0, 4, size=(n_err, max_indel))]
    code = np.full(256, 0, dtype=np.int64)
    code[list(b"ACGT")] = np.arange(4)
    out, prev = [], 0
    for e in range(n_err):
        p = int(pos[e])
        out.append(truth[prev:p])
        if kinds[e] == 0:  # substitution
            out.append(np.frombuffer(b"ACGT", dtype=np.uint8)[[(code[truth[p]] + shift[e]) % 4]])
            prev = p + 1
        elif kinds[e] == 1:  # extra bases in the draft
            out.append(extra[e, : lens[e]])
            out.append(truth[p : p + 1])
            prev = p + 1
        else:  # bases missing from the draft
            prev = p + int(lens[e])
    out.append(truth[prev:])
    return np.ascontiguousarray(np.concatenate(out))


def snv_sample(ref: torch.Tensor, count: int, het_share: float, gen: torch.Generator) -> tuple:
    """Sample SNVs on the ACGT bases of ``ref``: exactly ``count`` distinct
    positions, each with another base, ``het_share`` of them heterozygous.
    -> (haplotype A: the homozygous ones applied, haplotype B: all
    applied), uint8 on ref's device."""
    dev = ref.device
    acgt = (ref == 65) | (ref == 67) | (ref == 71) | (ref == 84)
    eligible = torch.nonzero(acgt).flatten()
    pick = torch.randperm(eligible.numel(), generator=gen, device=dev)[:count]
    pos = eligible[pick]
    code = torch.zeros(256, dtype=torch.int64, device=dev)
    code[ACGT.to(dev).long()] = torch.arange(4, device=dev)
    alt = ACGT.to(dev)[(code[ref[pos].long()] + torch.randint(1, 4, (count,), generator=gen, device=dev)) % 4]
    het = torch.rand(count, generator=gen, device=dev) < het_share
    hap_b = ref.clone()
    hap_b[pos] = alt
    hap_a = ref.clone()
    hap_a[pos[~het]] = alt[~het]
    return hap_a, hap_b


class FilterFill:
    """A blocked filter being filled on the card: one byte a bit, packed
    into 32-bit words at the end (torch has no scatter-OR)."""

    def __init__(self, num_bytes: int, hash_num: int, k: int, device):
        self.words = num_bytes // 4
        if self.words & (self.words - 1):
            raise ValueError("a blocked filter has a power-of-two word count")
        self.hash_num, self.k, self.device = hash_num, k, device
        self.bits = torch.zeros(self.words * 32, dtype=torch.uint8, device=device)

    def insert(self, can: torch.Tensor) -> None:
        """Insert canonical hashes (int64) by the layout rule."""
        wbits = self.words.bit_length() - 1
        base = (can & (self.words - 1)) * 32
        for j in range(self.hash_num):
            self.bits[base + (rd.shr(can, wbits + 5 * j) & 31)] = 1

    def insert_sequence(self, seq: torch.Tensor) -> int:
        """Insert every window of ACGT bytes of ``seq``; -> windows inserted."""
        n = seq.numel() - self.k + 1
        valid, iupac = rd.window_flags(seq, n, self.k)
        fh, rh = rd.window_hashes(seq, self.k)
        can = rd.canonical(fh, rh)[valid & ~iupac]
        self.insert(can)
        return can.numel()

    def insert_stand_ins(self, count: int, gen: torch.Generator, chunk: int = 1 << 27) -> None:
        """Insert ``count`` uniform 64-bit hash values."""
        done = 0
        while done < count:
            m = min(chunk, count - done)
            hi = torch.randint(-(1 << 31), 1 << 31, (m,), generator=gen, device=self.device)
            lo = torch.randint(0, 1 << 32, (m,), generator=gen, device=self.device)
            self.insert((hi << 32) | lo)
            done += m

    def occupancy(self) -> float:
        """The share of the filter's bits set."""
        step = 1 << 28
        ones = sum(int(self.bits[i : i + step].sum(dtype=torch.int64))
                   for i in range(0, self.bits.numel(), step))
        return ones / self.bits.numel()

    def pack(self, chunk_words: int = 1 << 23) -> torch.Tensor:
        """-> the words as int32 (the bit patterns of uint32); frees the
        bit bytes."""
        out = torch.empty(self.words, dtype=torch.int32, device=self.device)
        lanes = torch.arange(32, dtype=torch.int64, device=self.device)
        for w0 in range(0, self.words, chunk_words):
            w1 = min(self.words, w0 + chunk_words)
            b = self.bits[w0 * 32 : w1 * 32].view(-1, 32).long()
            v = (b << lanes).sum(1)
            out[w0:w1] = torch.where(v >= 1 << 31, v - (1 << 32), v).to(torch.int32)
        self.bits = None
        return out
