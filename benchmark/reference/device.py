"""The reference's dense passes in plain torch int64, on any device.

Frozen for the benchmark's plain reference: the window hashes of
``ntedit_tpu_torch/core/nthash.py``, the window classes and the gate rule
of ``ntedit_tpu_torch/ops/gate_kernel.py`` (``gate_words_plain``) and the
SNV candidate rule of ``ntedit_tpu_torch/ops/snv_kernel.py``
(``snv_cand_words_plain``), as the benchmark was written, over the blocked
layout of ``filter.py``.  It imports nothing of the port.  The reference's
Oracle takes the heads these passes return as its gate hint: the polish
gates (a window absent from the filter, or holding an IUPAC byte) and the
SNV candidates (a window some alternate last base of which is in the
filter, or holding an IUPAC byte), both over windows of accepted bytes.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference import nthash_ref as ref
from benchmark.reference.config import ACCEPTED

SROL_PERIOD = ref.SROL_PERIOD
CP_OFF = ref.CP_OFF
SIGN = -(1 << 63)  # int64 bit pattern of 2^63

# byte classes: bit 0 = fails isAcceptedBase, bit 1 = accepted IUPAC
CLASS = np.ones(256, dtype=np.uint8)
for _c in ACCEPTED:
    CLASS[_c] = CLASS[_c | 0x20] = 0 if _c in b"ACGT" else 2

# forward seeds over the case-folded byte (only ACGT/acgt seed); complement
# seeds SEED_TAB[c & 7] for every byte, IUPAC aliasing included
FOLD_SEEDS = np.zeros(256, dtype=np.uint64)
for _c in b"ACGT":
    FOLD_SEEDS[_c] = FOLD_SEEDS[_c | 0x20] = ref.SEED_TAB[_c]
CSEEDS = ref.SEED_TAB[np.arange(256) & CP_OFF]


def as_int64(x: np.ndarray) -> torch.Tensor:
    """numpy uint64 -> int64 tensor with the same bits."""
    return torch.from_numpy(np.ascontiguousarray(x, dtype=np.uint64).view(np.int64))


def shr(x: torch.Tensor, s: int) -> torch.Tensor:
    """Logical right shift of uint64 bits held in int64."""
    if s == 0:
        return x
    return (x >> s) & ((1 << (64 - s)) - 1)


def canonical(fh: torch.Tensor, rh: torch.Tensor) -> torch.Tensor:
    """Unsigned minimum of uint64 bits held in int64."""
    return torch.where((fh ^ SIGN) < (rh ^ SIGN), fh, rh)


def _rotated_tables(k: int, device) -> tuple:
    """[k * 256] tables: F[i, c] = srol^(k-1-i)(seed(c)), R[i, c] =
    srol^i(cseed(c)), computed with the numpy spec."""
    d_f = np.arange(k - 1, -1, -1, dtype=np.int64) % SROL_PERIOD
    d_r = np.arange(k, dtype=np.int64) % SROL_PERIOD
    f = ref.srol_vec(np.broadcast_to(FOLD_SEEDS, (k, 256)), np.broadcast_to(d_f[:, None], (k, 256)))
    r = ref.srol_vec(np.broadcast_to(CSEEDS, (k, 256)), np.broadcast_to(d_r[:, None], (k, 256)))
    return as_int64(f.reshape(-1)).to(device), as_int64(r.reshape(-1)).to(device)


def window_hashes(seq: torch.Tensor, k: int) -> tuple:
    """(fh, rh) int64 [L - k + 1] of every window of ASCII ``seq`` [L]."""
    n = seq.shape[0] - k + 1
    if n <= 0:
        z = torch.zeros(0, dtype=torch.int64, device=seq.device)
        return z, z
    ftab, rtab = _rotated_tables(k, seq.device)
    s = seq.long()
    fh = torch.zeros(n, dtype=torch.int64, device=seq.device)
    rh = torch.zeros(n, dtype=torch.int64, device=seq.device)
    for i in range(k):
        idx = s[i : i + n] + 256 * i
        fh ^= ftab[idx]
        rh ^= rtab[idx]
    return fh, rh


def window_flags(seq: torch.Tensor, n: int, k: int) -> tuple:
    """(valid, has_iupac) bool [n] for the windows of ASCII ``seq``."""
    cls = torch.from_numpy(CLASS).to(seq.device)[seq[: n + k - 1].long()]
    out = []
    for bit in (1, 2):
        c = torch.cumsum((cls & bit != 0).long(), 0)
        c = torch.cat([torch.zeros(1, dtype=torch.int64, device=seq.device), c])
        out.append(c[k : k + n] - c[:n] > 0)
    return ~out[0], out[1]


def word_and_mask(can: torch.Tensor, words: int, hash_num: int) -> tuple:
    """The blocked layout's rule: the word index is the low log2(words)
    bits of the canonical hash, the hash_num bit offsets are the 5-bit
    fields above them.  -> (word index int64, mask int64)."""
    wbits = words.bit_length() - 1
    widx = can & (words - 1)
    mask = torch.zeros_like(can)
    for j in range(hash_num):
        mask |= 1 << (shr(can, wbits + 5 * j) & 31)
    return widx, mask


def contains(table: torch.Tensor, can: torch.Tensor, hash_num: int) -> torch.Tensor:
    """Blocked-filter membership of canonical hashes; ``table`` holds the
    words as int32."""
    widx, mask = word_and_mask(can, table.shape[0], hash_num)
    return (table[widx].long() & mask) == mask


def _last_base_tables(k: int, device) -> tuple:
    """[256] int64 tables of a window's last byte c: its forward seed and
    srol^(k-1) of its complement seed (what it adds to fh and to rh)."""
    last_r = ref.srol_vec(CSEEDS, np.full(256, (k - 1) % SROL_PERIOD, dtype=np.int64))
    return as_int64(FOLD_SEEDS).to(device), as_int64(last_r).to(device)


def alternate_hashes(seq: torch.Tensor, n: int, k: int):
    """Yields (allowed, can) for each base of ACGT: ``can`` [n] the
    canonical hash of every window with its last byte replaced by the
    base, ``allowed`` [n] whether that is an alternate there."""
    s = seq[: n + k - 1]
    fh, rh = window_hashes(s, k)
    tail = s[k - 1 : k - 1 + n].long()
    seed_f, last_r = _last_base_tables(k, seq.device)
    fx, rx = fh ^ seed_f[tail], rh ^ last_r[tail]
    del fh, rh
    for b in b"ACGT":
        yield (tail & 0xDF) != b, canonical(fx ^ seed_f[b], rx ^ last_r[b])


def gate_heads(seq: torch.Tensor, table: torch.Tensor, k: int, hash_num: int) -> torch.Tensor:
    """Polish mode: the heads (int64, ascending) whose window is valid and
    absent from the filter or holds an IUPAC byte."""
    n = seq.shape[0] - k + 1
    if n <= 0:
        return torch.zeros(0, dtype=torch.int64, device=seq.device)
    valid, iupac = window_flags(seq, n, k)
    fh, rh = window_hashes(seq, k)
    gate = iupac | ~contains(table, canonical(fh, rh), hash_num)
    return torch.nonzero(gate & valid).flatten()


def snv_candidate_heads(seq: torch.Tensor, table: torch.Tensor, k: int,
                        hash_num: int) -> torch.Tensor:
    """SNV mode: the heads (int64, ascending) whose window is valid and
    some alternate last base of which is in the filter, or which holds an
    IUPAC byte."""
    n = seq.shape[0] - k + 1
    if n <= 0:
        return torch.zeros(0, dtype=torch.int64, device=seq.device)
    valid, cand = window_flags(seq, n, k)
    for allowed, can in alternate_hashes(seq, n, k):
        cand |= allowed & contains(table, can, hash_num)
    return torch.nonzero(cand & valid).flatten()
