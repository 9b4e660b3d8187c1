"""ntHash2 in plain torch: the window hashes of every head of a sequence,
the canonical minimum and the NTM64 multi-hash extension.

Torch has signed 64-bit integers only, so every hash here is an int64
tensor holding the uint64 value's bits.  Three operations differ from
their unsigned counterparts and are written out:

* a right shift extends the sign, so ``shr`` masks after it;
* ``<``/``min`` compare signed, so ``umin`` flips the sign bit first;
* ``%`` is wrong once bit 63 is set, so ``umod`` runs Horner's rule over
  16-bit limbs (every step stays below 2^52 for divisors below 2^36).

A multiply wraps to the right low 64 bits.  The tests hold every function
against the numpy uint64 spec (nthash_ref) on hashes with bit 63 set.

The window hash is computed directly, ``fh(h) = XOR_i
srol^(k-1-i)(seed(s[h+i]))`` with one [256]-table gather per window
offset i; the CUDA gate kernel rolls it instead, so the two are
independent computations of the same function.
"""

from __future__ import annotations

import numpy as np
import torch

from ntedit_tpu_torch.core import nthash_ref as ref

SROL_PERIOD = ref.SROL_PERIOD
CP_OFF = ref.CP_OFF
SIGN = -(1 << 63)  # int64 bit pattern of 2^63


def as_int64(x: np.ndarray) -> torch.Tensor:
    """numpy uint64 -> int64 tensor with the same bits."""
    return torch.from_numpy(np.ascontiguousarray(x, dtype=np.uint64).view(np.int64))


def as_uint64(t: torch.Tensor) -> np.ndarray:
    """int64 tensor -> numpy uint64 with the same bits."""
    return t.cpu().numpy().view(np.uint64)


def _signed(v: int) -> int:
    """Python uint64 value -> the int64 with the same bits."""
    v &= (1 << 64) - 1
    return v - (1 << 64) if v >> 63 else v


def shr(x: torch.Tensor, s: int) -> torch.Tensor:
    """Logical right shift of uint64 bits held in int64."""
    if s == 0:
        return x
    return (x >> s) & ((1 << (64 - s)) - 1)


def umin(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Unsigned minimum of uint64 bits held in int64."""
    return torch.where((a ^ SIGN) < (b ^ SIGN), a, b)


def umod(x: torch.Tensor, m: int) -> torch.Tensor:
    """Unsigned ``x % m`` for uint64 bits held in int64, 0 < m <= 2^36."""
    if not 0 < m <= 1 << 36:
        raise ValueError(f"umod divisor {m} outside (0, 2^36]")
    r = shr(x, 48) % m
    for s in (32, 16, 0):
        r = ((r << 16) | (shr(x, s) & 0xFFFF)) % m
    return r


# forward seeds: SEED_TAB over the case-folded byte (c & 0xDF), so only
# ACGT/acgt seed; complement seeds: SEED_TAB[c & 7] for every byte,
# IUPAC aliasing included (the JAX package's nthash.seed_of / cseed_of)
_FOLD_SEEDS = np.zeros(256, dtype=np.uint64)
for _c in b"ACGT":
    _FOLD_SEEDS[_c] = _FOLD_SEEDS[_c | 0x20] = ref.SEED_TAB[_c]
_CSEEDS = ref.SEED_TAB[np.arange(256) & CP_OFF]


def seed_of(seq: torch.Tensor) -> torch.Tensor:
    """ASCII bytes -> forward seeds (int64 bits)."""
    return as_int64(_FOLD_SEEDS).to(seq.device)[seq.long()]


def cseed_of(seq: torch.Tensor) -> torch.Tensor:
    """ASCII bytes -> complement seeds (int64 bits)."""
    return as_int64(_CSEEDS).to(seq.device)[seq.long()]


def canonical(fh: torch.Tensor, rh: torch.Tensor) -> torch.Tensor:
    return umin(fh, rh)


def extend(base: torch.Tensor, k: int, m: int) -> list:
    """Canonical hashes -> list of m hash tensors (ntHash NTM64):
    h[0] = base, h[i] = t ^ (t >> 27) with t = base * (i ^ k*MULTISEED)."""
    out = [base]
    for i in range(1, m):
        t = base * _signed(i ^ (k * int(ref.MULTISEED)))
        out.append(t ^ shr(t, int(ref.MULTISHIFT)))
    return out


def _rotated_tables(k: int, device) -> tuple:
    """[k, 256] tables: F[i, c] = srol^(k-1-i)(seed(c)), R[i, c] =
    srol^i(cseed(c)), computed with the numpy spec."""
    d_f = np.arange(k - 1, -1, -1, dtype=np.int64) % SROL_PERIOD
    d_r = np.arange(k, dtype=np.int64) % SROL_PERIOD
    f = ref.srol_vec(np.broadcast_to(_FOLD_SEEDS, (k, 256)), np.broadcast_to(d_f[:, None], (k, 256)))
    r = ref.srol_vec(np.broadcast_to(_CSEEDS, (k, 256)), np.broadcast_to(d_r[:, None], (k, 256)))
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
