"""ntHash2 rolling canonical k-mer hashing — NumPy uint64 reference spec.

Frozen for the benchmark's plain reference: a copy of
``ntedit_tpu_torch/core/nthash_ref.py`` as the benchmark was written, importing
nothing of the port, so that a later change to the port does not
change what the port is held to.

This module is the *mathematical specification* of the hash used throughout
the framework.  It mirrors the semantics of btllib's ntHash2 internals that
the reference engine relies on (ntedit.cpp:403-452), re-derived from the
published ntHash2 algorithm (Kazemi et al., 2022).  It is the algebra of
the hash:

* A 64-bit word is treated as a 33-bit low part (bits 0..32) and a 31-bit
  high part (bits 33..63).  ``srol`` rotates each part left by one within
  itself ("split rotation"; periods 33 and 31, joint period 1023).  This is
  ntHash2's fix for the rotational collisions of plain 64-bit rotation.
* Each base has a 64-bit seed; the forward hash of ``s[0..k-1]`` is
  ``XOR_i srol^(k-1-i)(seed(s[i]))``; the reverse-complement hash is
  ``XOR_i srol^i(cseed(s[i]))`` where ``cseed(c) = SEED_TAB[c & CP_OFF]``
  (the complement-seed aliasing trick: 'A'&7==1 -> SEED_T slot, etc.).
* ``canonical = min(fh, rh)``; ``extend_hashes_vec`` derives the m-1 extra
  Bloom-filter hashes from the canonical one by 64-bit multiply/xor-shift
  mixing (ntHash's published multi-hash recurrence).

This is a copy of the parts of the JAX package's module of the same name
that the port uses (the port keeps its own host code): the constants, the
scalar hashes and their rolling updates (the Oracle, sitefix and the
wavefront engine), the vectorized window hashes and the multi-hash
extension, for the host filter classes and for the rotated-seed tables of
ntedit_tpu_torch.core.nthash.

NOTE: the seed constants below are the published ntHash constants; the
JAX package's tests/test_nthash.py pins them with recorded self-test
vectors.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np

# Published ntHash base seeds (Mohamadi et al. 2016; unchanged in ntHash2).
SEED_A = np.uint64(0x3C8BFBB395C60474)
SEED_C = np.uint64(0x3193C18562A02B4C)
SEED_G = np.uint64(0x20323ED082572324)
SEED_T = np.uint64(0x295549F54BE24456)

# Multi-hash mixing constants (ntHash NTM64).
MULTISEED = np.uint64(0x90B45D39FB6DA1FA)
MULTISHIFT = np.uint64(27)

# Complement-seed offset mask: SEED_TAB[c & CP_OFF] is the seed of the
# complement of c for c in "ACGTacgt" ('A'&7==1 holds SEED_T, 'C'&7==3 holds
# SEED_G, 'T'&7==4 holds SEED_A, 'G'&7==7 holds SEED_C).  Non-ACGT IUPAC
# codes alias quirkily ('Y'&7==1 -> SEED_T) — the reference inherits this
# behaviour from btllib and we reproduce it exactly.
CP_OFF = 0x07

_LOW33 = np.uint64(0x1FFFFFFFF)  # bits 0..32

SPLIT_LOW_BITS = 33
SPLIT_HIGH_BITS = 31
SROL_PERIOD = 33 * 31  # 1023


def _build_seed_tab() -> np.ndarray:
    tab = np.zeros(256, dtype=np.uint64)
    for chars, seed in (("Aa", SEED_A), ("Cc", SEED_C), ("Gg", SEED_G), ("Tt", SEED_T)):
        for ch in chars:
            tab[ord(ch)] = seed
    # complement slots reachable through (c & CP_OFF)
    tab[ord("A") & CP_OFF] = SEED_T  # 1
    tab[ord("C") & CP_OFF] = SEED_G  # 3
    tab[ord("T") & CP_OFF] = SEED_A  # 4
    tab[ord("G") & CP_OFF] = SEED_C  # 7
    return tab


SEED_TAB = _build_seed_tab()


# ---------------------------------------------------------------------------
# Scalar forms: one k-mer at a time (the Oracle, sitefix and the wavefront)
# ---------------------------------------------------------------------------

def srol1(x):
    """Split-rotate-left by one: 33-bit low part and 31-bit high part each
    rotate within themselves."""
    x = np.uint64(x) if np.isscalar(x) or isinstance(x, (int, np.uint64)) else x
    m = ((x & np.uint64(0x8000000000000000)) >> np.uint64(30)) | (
        (x & np.uint64(0x100000000)) >> np.uint64(32)
    )
    return ((x << np.uint64(1)) & np.uint64(0xFFFFFFFDFFFFFFFF)) | m


def srol(x, d: int):
    """srol applied d times, via independent 33/31-bit rotations."""
    x = np.uint64(x) if isinstance(x, int) else x
    d_lo = np.uint64(d % SPLIT_LOW_BITS)
    d_hi = np.uint64(d % SPLIT_HIGH_BITS)
    lo = x & _LOW33
    hi = x >> np.uint64(33)
    lo = ((lo << d_lo) | (lo >> (np.uint64(33) - d_lo))) & _LOW33 if d_lo else lo
    hi = ((hi << d_hi) | (hi >> (np.uint64(31) - d_hi))) & np.uint64(0x7FFFFFFF) if d_hi else hi
    return (hi << np.uint64(33)) | lo


def sror1(x):
    """Inverse of srol1."""
    return srol(x, SROL_PERIOD - 1)


def base_forward_hash(kmer: bytes | np.ndarray, k: int | None = None) -> np.uint64:
    """Forward hash of a k-mer: XOR_i srol^(k-1-i)(seed(s_i))."""
    arr = np.frombuffer(bytes(kmer), dtype=np.uint8) if isinstance(kmer, (bytes, bytearray)) else kmer
    if k is None:
        k = len(arr)
    h = np.uint64(0)
    for i in range(k):
        h = srol1(h) ^ SEED_TAB[arr[i]]
    return h


def base_reverse_hash(kmer: bytes | np.ndarray, k: int | None = None) -> np.uint64:
    """Reverse-complement hash: XOR_i srol^i(cseed(s_i))."""
    arr = np.frombuffer(bytes(kmer), dtype=np.uint8) if isinstance(kmer, (bytes, bytearray)) else kmer
    if k is None:
        k = len(arr)
    h = np.uint64(0)
    for i in range(k - 1, -1, -1):
        h = srol1(h) ^ SEED_TAB[arr[i] & CP_OFF]
    return h


def next_forward_hash(fh, k: int, char_out: int, char_in: int):
    """Roll forward by one base: drop char_out, append char_in."""
    return srol1(fh) ^ srol(SEED_TAB[char_out], k) ^ SEED_TAB[char_in]


def next_reverse_hash(rh, k: int, char_out: int, char_in: int):
    """Roll the reverse-complement hash by one base."""
    return sror1(rh ^ SEED_TAB[char_out & CP_OFF] ^ srol(SEED_TAB[char_in & CP_OFF], k))


def change_last_forward(fh, char_out: int, char_in: int):
    """Replace the LAST base of the window (reference NTMC64_changelast,
    ntedit.cpp:444-445): the last base contributes srol^0(seed)."""
    return fh ^ SEED_TAB[char_out] ^ SEED_TAB[char_in]


def change_last_reverse(rh, k: int, char_out: int, char_in: int):
    """Reverse-side last-base replacement (ntedit.cpp:446-449)."""
    return rh ^ srol(SEED_TAB[char_out & CP_OFF], k - 1) ^ srol(SEED_TAB[char_in & CP_OFF], k - 1)


def extend_hashes(base_hash: np.uint64, k: int, m: int) -> np.ndarray:
    """Derive m hash values from the canonical hash (ntHash NTM64 mixing).

    h[0] is the canonical hash itself; h[i>=1] = mix(base * (i ^ k*MULTISEED)).
    """
    out = np.empty(m, dtype=np.uint64)
    out[0] = base_hash
    for i in range(1, m):
        mult = np.uint64((i ^ (k * int(MULTISEED))) & 0xFFFFFFFFFFFFFFFF)
        t = np.uint64((int(base_hash) * int(mult)) & 0xFFFFFFFFFFFFFFFF)
        t ^= t >> MULTISHIFT
        out[i] = t
    return out


# ---------------------------------------------------------------------------
# Vectorized forms
# ---------------------------------------------------------------------------

def _srol_split(x: np.ndarray, d_lo: np.ndarray, d_hi: np.ndarray) -> np.ndarray:
    """srol with pre-split per-element rotation counts (d_lo = d mod 33,
    d_hi = d mod 31, both uint64).  d==0 needs no guard: lo>>33 and
    hi>>31 are 0 for 33/31-bit values, so the OR degenerates to identity."""
    lo = x & _LOW33
    hi = x >> np.uint64(33)
    lo = ((lo << d_lo) | (lo >> (np.uint64(33) - d_lo))) & _LOW33
    hi = ((hi << d_hi) | (hi >> (np.uint64(31) - d_hi))) & np.uint64(0x7FFFFFFF)
    return (hi << np.uint64(33)) | lo


def srol_vec(x: np.ndarray, d: np.ndarray) -> np.ndarray:
    """Vectorized srol^d_i(x_i) with per-element rotation counts."""
    d_lo = (d % SPLIT_LOW_BITS).astype(np.uint64)
    d_hi = (d % SPLIT_HIGH_BITS).astype(np.uint64)
    return _srol_split(x, d_lo, d_hi)


_SROL_TABS: tuple | None = None


def _seed_rot_tables() -> tuple[np.ndarray, np.ndarray]:
    """F[c, d] = srol^d(seed(c)) and R[c, d] = srol^d(cseed(c)), both
    [256, SROL_PERIOD] (~2 MiB each).  The per-position rolled seed terms
    of the window-hash prefix scans take only these 256x1023 values, so a
    gather replaces the per-element split-rotate (the hot cost of host
    hashing; see profile in the commit that introduced this)."""
    global _SROL_TABS
    if _SROL_TABS is None:
        d = np.arange(SROL_PERIOD, dtype=np.int64)
        F = srol_vec(SEED_TAB[:, None], np.broadcast_to(d, (256, SROL_PERIOD)))
        _SROL_TABS = (F, F[np.arange(256) & CP_OFF])
    return _SROL_TABS


@lru_cache(maxsize=256)
def _win_dists(L: int, k: int):
    """Cached rotation-distance vectors for length-L rows and k-windows."""
    t = np.arange(L, dtype=np.int64)
    h = np.arange(L - k + 1, dtype=np.int64)

    def split(dd):
        return (
            (dd % SPLIT_LOW_BITS).astype(np.uint64),
            (dd % SPLIT_HIGH_BITS).astype(np.uint64),
        )

    return (
        (-t) % SROL_PERIOD,
        t % SROL_PERIOD,
        split((h + k - 1) % SROL_PERIOD),
        split((-h) % SROL_PERIOD),
    )


def canonical(fh: np.ndarray, rh: np.ndarray) -> np.ndarray:
    return np.minimum(fh, rh)


def all_window_hashes(seq: np.ndarray, k: int) -> tuple[np.ndarray, np.ndarray]:
    """(fh, rh) for every window start 0..L-k, via the prefix-XOR-scan
    formulation (the same algebra the TPU dense pass uses):

      fh(h)  = srol^{h+k-1}( PX[h+k] ^ PX[h] ),
      PX[j]  = XOR_{t<j} srol^{-t}(seed(s_t))

    and symmetrically for rh with cseeds and +t rotations:

      rh(h)  = srol^{-h}( PR[h+k] ^ PR[h] ),  PR[j] = XOR_{t<j} srol^{t}(cseed(s_t))
    """
    L = len(seq)
    n = L - k + 1
    if n <= 0:
        return np.empty(0, np.uint64), np.empty(0, np.uint64)
    F, R = _seed_rot_tables()
    neg, pos, (wfl, wfh), (wrl, wrh) = _win_dists(L, k)
    fterms = F[seq, neg]
    rterms = R[seq, pos]
    pf = np.zeros(L + 1, dtype=np.uint64)
    pr = np.zeros(L + 1, dtype=np.uint64)
    np.bitwise_xor.accumulate(fterms, out=pf[1:])
    np.bitwise_xor.accumulate(rterms, out=pr[1:])
    fh = _srol_split(pf[k:] ^ pf[:n], wfl, wfh)
    rh = _srol_split(pr[k:] ^ pr[:n], wrl, wrh)
    return fh, rh


def batch_window_hashes(mat: np.ndarray, k: int) -> tuple[np.ndarray, np.ndarray]:
    """(fh, rh) of every window of every row: mat [R, L] -> [R, L-k+1].

    Same prefix-XOR-scan algebra as all_window_hashes, vectorized over
    rows (used by the vectorized site fixer to hash hundreds of patched
    trial sequences at once)."""
    R, L = mat.shape
    n = L - k + 1
    Ftab, Rtab = _seed_rot_tables()
    neg, pos, (wfl, wfh), (wrl, wrh) = _win_dists(L, k)
    fterms = Ftab[mat, neg]
    rterms = Rtab[mat, pos]
    pf = np.zeros((R, L + 1), dtype=np.uint64)
    pr = np.zeros((R, L + 1), dtype=np.uint64)
    np.bitwise_xor.accumulate(fterms, axis=1, out=pf[:, 1:])
    np.bitwise_xor.accumulate(rterms, axis=1, out=pr[:, 1:])
    fh = _srol_split(pf[:, k:] ^ pf[:, :n], wfl, wfh)
    rh = _srol_split(pr[:, k:] ^ pr[:, :n], wrl, wrh)
    return fh, rh


def extend_hashes_vec(base: np.ndarray, k: int, m: int) -> np.ndarray:
    """[n] canonical hashes -> [n, m] extended hashes."""
    out = np.empty((len(base), m), dtype=np.uint64)
    out[:, 0] = base
    with np.errstate(over="ignore"):
        for i in range(1, m):
            mult = np.uint64((i ^ (k * int(MULTISEED))) & 0xFFFFFFFFFFFFFFFF)
            t = base * mult  # wraps mod 2^64
            t ^= t >> MULTISHIFT
            out[:, i] = t
    return out
