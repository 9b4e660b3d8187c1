"""The SNV and polish site passes: CUDA kernel wrappers and their plain
torch versions.

``snv_cand_words(seq, n, df)`` returns the SNV candidate bitmap of heads
[0, n) of an ASCII sequence as little-endian uint32 words (stored as
int32), bits of heads >= n zero.  With tail byte t = seq[h + k - 1]:

    cand(h) = valid(h) & (has_iupac(h) | some alternate base b != fold(t)
              has contains(window at h with its last base replaced by b))

A head that is no candidate can yield neither a record nor an edit in SNV
mode, so the host engine skips it.  ``valid`` and ``has_iupac`` are the
gate pass's (ops/gate_kernel.py).

``snv_site_rows(seq, n, cand, df, jump)`` returns, for a sorted int64 list
of candidate heads, the uint8 [G, 6] rows the host engine consumes instead
of probing (native/repair.cpp):

* ``row[0]``: bit 0 = row valid; bit 1 + c = contains(window at h with its
  last base replaced by "ACGT"[c]), for all four c;
* ``row[1]``: the number of kk in range(k), kk % jump == 0, whose pristine
  window at head h + 1 + kk is present;
* ``row[2 + c]``: the same count with position h + k - 1 replaced by
  "ACGT"[c] (kk = k - 1 starts past it);

counts saturated at 255.  A row is valid when h <= n - k - 1 and every byte
of [h, h + 2k), all that those windows read, is ACGTacgt; an invalid row is
all zero and the engine probes live.  (The JAX package checks [h, h + 2k - 1)
and so lets through a row whose last stride window, read when jump divides
k - 1, ends in a byte it coded as 'A'; the port's row is zero there.)

``polish_site_rows(seq, n, gates, df, jump)`` is the polish form: for a
chunk's sorted gate heads, one row each, parallel to the gates.  Bit 5 of
``row[0]`` ("device-exact gate") is set where the window [h, h + k) holds
ACGTacgt only, so that the gate is the filter's verdict and not a forced
IUPAC one; the rest of the row is computed at cluster starts (a gate whose
predecessor in the list is not h - 1, and the list's first gate) whose row
is valid, with ``row[1]`` = the number of those stride windows that are
ABSENT (check_missing, the engine's attempt gate), and is zero elsewhere.

``polish_cand_masks(seq, n, gates, df)`` returns one uint8 per gate head
(int64, any order): bit c = contains(window at h with its last base set to
"ACGT"[c]), for all four c, the draft's own base included; 0xFF where
[h, h + k) holds a byte that is not ACGTacgt.  The engine takes the bits as
its first substitution probe at pristine windows.

All take a blocked or a plain filter and raise for a counting one (those
runs go through the gate pass alone).  On a CUDA tensor a wrapper launches
csrc/snv_kernel.cu (built with nvcc at first use) or raises; on a CPU
tensor it runs its plain version.  The kernels replace the JAX package's
XLA programs engine/flag.py::_snv_cand_words_from_codes,
_snv_site_data_from_codes, _polish_site_data_from_codes and
_polish_cand_planes_from_codes with _gather_cand_masks; see the note in
the .cu source.
"""

from __future__ import annotations

import ctypes
import os
import threading

import numpy as np
import torch

from ntedit_tpu_torch.core import nthash as nt
from ntedit_tpu_torch.core import nthash_ref as ref
from ntedit_tpu_torch.ops import gate_kernel
from ntedit_tpu_torch.ops.gate_kernel import HEADER, LAYOUT_CODE, MAX_K, mod_magic, padded_len
from ntedit_tpu_torch.utils.build import build_library

SOURCE = os.path.join(gate_kernel.CSRC, "snv_kernel.cu")
ACGT = b"ACGT"
# loads a thread of the candidate kernel keeps in flight: 3 alternates x
# the heads it hashes per batch (csrc kSnvHeadsBlocked, kSnvHeadsPlain)
CAND_BATCH = {"blocked": 6, "plain": 3}
SITE_BATCH = 5  # the site kernel's: a window's pristine hash and four alternates
MASK_BATCH = 4  # the mask kernel's: the four bases at the site
EXACT_GATE = 32  # polish rows: flags bit 5, "device-exact gate"

# bit 0: fails isAcceptedBase; bit 1: accepted IUPAC (gate_kernel's classes)
_NOT_ACGT = torch.from_numpy((gate_kernel._CLASS != 0).astype(np.uint8))


def _check_filter(df) -> None:
    if df.counting:
        raise ValueError("the SNV kernels take a blocked or a plain filter, not a counting one")
    if not 1 <= df.k <= MAX_K:
        raise ValueError(f"the SNV kernels support 1 <= k <= {MAX_K}, got k={df.k}")


def _contains(df, can: torch.Tensor) -> torch.Tensor:
    return df.contains([can] if df.blocked else nt.extend(can, df.k, df.hash_num))


def _last_base_tables(k: int, device) -> tuple:
    """[256] int64 tables of a window's last byte c: its forward seed and
    srol^(k-1) of its complement seed (what it adds to fh and to rh)."""
    last_r = ref.srol_vec(nt._CSEEDS, np.full(256, (k - 1) % nt.SROL_PERIOD, dtype=np.int64))
    return nt.as_int64(nt._FOLD_SEEDS).to(device), nt.as_int64(last_r).to(device)


def alternate_hashes(seq: torch.Tensor, n: int, k: int):
    """Yields (base, allowed, can) for each base of ACGT: ``can`` [n] the
    canonical hash of every window of ``seq`` with its last byte replaced
    by ``base``, ``allowed`` [n] whether that is an alternate there (the
    window's own last byte, case-folded, differs)."""
    s = seq[: n + k - 1]
    fh, rh = nt.window_hashes(s, k)
    tail = s[k - 1 : k - 1 + n].long()
    seed_f, last_r = _last_base_tables(k, seq.device)
    fx, rx = fh ^ seed_f[tail], rh ^ last_r[tail]
    for b in ACGT:
        yield b, (tail & 0xDF) != b, nt.canonical(fx ^ seed_f[b], rx ^ last_r[b])


def snv_cand_words_plain(seq: torch.Tensor, n: int, df) -> torch.Tensor:
    """The candidate pass in plain torch int64, on any device."""
    _check_filter(df)
    k = df.k
    if n <= 0:
        return torch.zeros(0, dtype=torch.int32, device=seq.device)
    valid, iupac = gate_kernel.window_flags(seq[: n + k - 1], n, k)
    cand = iupac
    for _b, allowed, can in alternate_hashes(seq, n, k):
        cand = cand | (allowed & _contains(df, can))
    return gate_kernel.pack_bits(cand & valid)


def _rotated_hash(win: torch.Tensor, k: int) -> torch.Tensor:
    """Canonical hashes of the [V, k] byte windows ``win``, each hashed from
    its own bytes."""
    ftab, rtab = nt._rotated_tables(k, win.device)
    idx = win.long() + 256 * torch.arange(k, device=win.device)
    fh = torch.zeros(win.shape[0], dtype=torch.int64, device=win.device)
    rh = torch.zeros_like(fh)
    for i in range(k):
        fh ^= ftab[idx[:, i]]
        rh ^= rtab[idx[:, i]]
    return nt.canonical(fh, rh)


def _acgt_windows(seq: torch.Tensor, heads: torch.Tensor, width: int, limit: int) -> tuple:
    """(clean [G] bool, bytes [V, width]): the heads h with h <= limit whose
    bytes [h, h + width) are all ACGTacgt, and those bytes, with int64
    indices throughout."""
    dev = seq.device
    inside = (heads >= 0) & (heads <= limit)
    block = seq[heads[inside][:, None] + torch.arange(width, device=dev)]
    ok = _NOT_ACGT.to(dev)[block.long()].sum(1) == 0
    clean = inside.clone()
    clean[inside] = ok
    return clean, block[ok]


def site_windows(seq: torch.Tensor, n: int, cand: torch.Tensor, k: int, jump: int):
    """(valid [G] bool, windows) for candidate heads ``cand``: ``windows``
    yields (item, c, can) with ``can`` [V] the canonical hashes, for the
    V valid candidates, of the window at head h (item 0) or h + 1 + kk
    (item 1 + kk // jump) with position h + k - 1 set to "ACGT"[c], or
    left as it is when c is -1.  Each window is hashed from its own bytes,
    substituted explicitly."""
    # the k windows past h fit below n
    valid, block = _acgt_windows(seq, cand, 2 * k, n - k - 1)

    def windows():
        for item, off in enumerate([0] + [1 + kk for kk in range(0, k, jump)]):
            win = block[:, off : off + k]
            pos = k - 1 - off  # the site's index in this window; past it when < 0
            pristine = _rotated_hash(win, k)
            yield item, -1, pristine
            for c, b in enumerate(ACGT):
                if pos < 0:
                    yield item, c, pristine
                    continue
                sub = win.clone()
                sub[:, pos] = b
                yield item, c, _rotated_hash(sub, k)

    return valid, windows()


def _site_counts(seq: torch.Tensor, n: int, cand: torch.Tensor, df, jump: int) -> tuple:
    """(valid [G] bool, counts int64 [V, 6]): the unsaturated rows of the
    valid candidates; column 1 counts the present stride windows."""
    valid, windows = site_windows(seq, n, cand, df.k, jump)
    counts = torch.zeros((int(valid.sum()), 6), dtype=torch.int64, device=seq.device)
    counts[:, 0] = 1
    for item, c, can in windows:
        present = _contains(df, can).long()
        if item == 0:
            if c >= 0:
                counts[:, 0] |= present << (1 + c)
        else:
            counts[:, 2 + c if c >= 0 else 1] += present
    return valid, counts


def snv_site_rows_plain(seq: torch.Tensor, n: int, cand: torch.Tensor, df,
                        jump: int) -> torch.Tensor:
    """The SNV site pass in plain torch int64, on any device."""
    _check_filter(df)
    rows = torch.zeros((cand.shape[0], 6), dtype=torch.uint8, device=seq.device)
    if not cand.shape[0]:
        return rows
    valid, counts = _site_counts(seq, n, cand, df, jump)
    rows[valid] = counts.clamp(max=255).to(torch.uint8)
    return rows


def cluster_starts(gates: torch.Tensor) -> torch.Tensor:
    """bool [G]: the gates of a sorted list whose predecessor in it is not
    h - 1, the first one included."""
    start = torch.ones_like(gates, dtype=torch.bool)
    start[1:] = gates[1:] != gates[:-1] + 1
    return start


def polish_site_rows_plain(seq: torch.Tensor, n: int, gates: torch.Tensor, df,
                           jump: int) -> torch.Tensor:
    """The polish site pass in plain torch int64, on any device."""
    _check_filter(df)
    k = df.k
    rows = torch.zeros((gates.shape[0], 6), dtype=torch.uint8, device=seq.device)
    if not gates.shape[0]:
        return rows
    exact, _ = _acgt_windows(seq, gates, k, n - 1)
    start = cluster_starts(gates)
    valid, counts = _site_counts(seq, n, gates[start], df, jump)
    counts[:, 1] = len(range(0, k, jump)) - counts[:, 1]  # absent, not present
    counts[:, 0] |= EXACT_GATE  # a valid row's window is ACGTacgt
    at = torch.nonzero(start).squeeze(1)[valid]
    rows[at] = counts.clamp(max=255).to(torch.uint8)
    rows[:, 0] |= exact.to(torch.uint8) * EXACT_GATE
    return rows


def mask_hashes(seq: torch.Tensor, n: int, gates: torch.Tensor, k: int) -> tuple:
    """(clean [G] bool, hashes): the gates whose window [h, h + k) is
    ACGTacgt only, and for each base c of "ACGT" the canonical hashes [V]
    of their windows with the last byte set to it, each window hashed from
    its own bytes."""
    clean, win = _acgt_windows(seq, gates, k, n - 1)
    hashes = []
    for b in ACGT:
        sub = win.clone()
        sub[:, k - 1] = b
        hashes.append(_rotated_hash(sub, k))
    return clean, hashes


def polish_cand_masks_plain(seq: torch.Tensor, n: int, gates: torch.Tensor, df) -> torch.Tensor:
    """The candidate-mask pass in plain torch int64, on any device."""
    _check_filter(df)
    masks = torch.full((gates.shape[0],), 0xFF, dtype=torch.uint8, device=seq.device)
    if not gates.shape[0]:
        return masks
    clean, hashes = mask_hashes(seq, n, gates, df.k)
    bits = torch.zeros(int(clean.sum()), dtype=torch.int64, device=seq.device)
    for c, can in enumerate(hashes):
        bits |= _contains(df, can).long() << c
    masks[clean] = bits.to(torch.uint8)
    return masks


_lib = None
_lib_lock = threading.Lock()


def build(force: bool = False) -> str:
    """Compile the kernels (once per content of the source and its header);
    returns the .so path."""
    return build_library("snv_kernel", SOURCE, gate_kernel._command, force=force, deps=(HEADER,))


def build_log() -> str:
    """What nvcc printed when it built the library (``-Xptxas -v``)."""
    with open(build() + ".log") as f:
        return f.read()


def open_library(path: str):
    """Load a build of the kernels and declare its C interface.  Raises
    when it cannot be loaded or its tile or halo differ from the gate
    kernel's, whose padded buffer the candidate kernel reads."""
    lib = ctypes.CDLL(path)
    filt = [ctypes.c_void_p, ctypes.c_uint64, ctypes.c_uint64,  # table, modulus, magic
            ctypes.c_int, ctypes.c_int, ctypes.c_int]           # wbits, layout, hash_num
    lib.nts_cand_words.restype = ctypes.c_int
    lib.nts_cand_words.argtypes = [ctypes.c_void_p, ctypes.c_uint64, ctypes.c_int,  # seq, n, k
                                   *filt, ctypes.c_void_p, ctypes.c_void_p]         # out, stream
    lib.nts_site_rows.restype = ctypes.c_int
    lib.nts_site_rows.argtypes = [ctypes.c_void_p, ctypes.c_uint64, ctypes.c_int,   # seq, n, k
                                  ctypes.c_void_p, ctypes.c_uint64,                 # heads, n_heads
                                  *filt, ctypes.c_int, ctypes.c_int,                # jump, polish
                                  ctypes.c_void_p, ctypes.c_void_p]                 # rows, stream
    lib.nts_cand_masks.restype = ctypes.c_int
    lib.nts_cand_masks.argtypes = [ctypes.c_void_p, ctypes.c_uint64, ctypes.c_int,  # seq, n, k
                                   ctypes.c_void_p, ctypes.c_uint64,                # gates, n_gates
                                   *filt, ctypes.c_void_p, ctypes.c_void_p]         # masks, stream
    lib.nts_occupancy.restype = ctypes.c_int
    lib.nts_occupancy.argtypes = [ctypes.c_int]
    for name in ("nts_tile_heads", "nts_halo_bytes"):
        getattr(lib, name).restype = ctypes.c_int
        getattr(lib, name).argtypes = []
    lib.nts_cand_batch.restype = ctypes.c_int
    lib.nts_cand_batch.argtypes = [ctypes.c_int]
    lib.nts_mask_batch.restype = ctypes.c_int
    lib.nts_mask_batch.argtypes = []
    lib.nts_error_string.restype = ctypes.c_char_p
    lib.nts_error_string.argtypes = [ctypes.c_int]
    if (lib.nts_tile_heads(), lib.nts_halo_bytes()) != (gate_kernel.TILE, gate_kernel.HALO):
        raise RuntimeError("SNV kernel tile/halo differ from the wrapper's")
    if any(lib.nts_cand_batch(LAYOUT_CODE[name]) != b for name, b in CAND_BATCH.items()):
        raise RuntimeError("SNV candidate kernel batch differs from the wrapper's")
    if lib.nts_mask_batch() != MASK_BATCH:
        raise RuntimeError("mask kernel batch differs from the wrapper's")
    return lib


def load_library():
    """The kernels' ctypes library, built at first use.  Raises when it
    cannot be built or loaded."""
    global _lib
    with _lib_lock:
        if _lib is None:
            _lib = open_library(build())
        return _lib


def _check_seq(seq: torch.Tensor, df, need: int, aligned: bool) -> None:
    if seq.device.type != "cuda" or df.device != seq.device:
        raise ValueError(f"the SNV kernels need seq and filter on one CUDA device "
                         f"(got {seq.device} and {df.device})")
    if seq.dtype != torch.uint8 or seq.dim() != 1 or not seq.is_contiguous():
        raise ValueError("the SNV kernels need a contiguous 1-D uint8 sequence")
    if seq.numel() < need or (aligned and seq.data_ptr() % 16):
        raise ValueError(f"the SNV kernel needs {need} bytes"
                         + (" from a 16-byte aligned start" if aligned else "")
                         + f" (got {seq.numel()} at {seq.data_ptr() % 16})")


def _filter_args(df) -> tuple:
    return (df.table.data_ptr(), df.modulus, 0 if df.blocked else mod_magic(df.modulus),
            df.wbits if df.blocked else 0, LAYOUT_CODE[df.layout], df.hash_num)


def snv_cand_words(seq: torch.Tensor, n: int, df) -> torch.Tensor:
    """Candidate words of heads [0, n) of ``seq`` (see the module docstring).

    On CUDA, ``seq`` is a uint8 buffer of at least ``padded_len(n)`` bytes
    starting 16-byte aligned (bytes past the contig are ignored); the
    kernel runs on the current stream and the call does not synchronise."""
    if seq.device.type == "cpu":
        return snv_cand_words_plain(seq, n, df)
    lib = load_library()
    _check_filter(df)
    _check_seq(seq, df, padded_len(n), aligned=True)
    out = torch.empty(max(0, -(-n // 32)), dtype=torch.int32, device=seq.device)
    if n <= 0:
        return out
    rc = lib.nts_cand_words(seq.data_ptr(), n, df.k, *_filter_args(df), out.data_ptr(),
                            torch.cuda.current_stream(seq.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"SNV candidate kernel launch failed: {lib.nts_error_string(rc).decode()}")
    with _count_lock:
        snv_cand_words.launches += 1
    return out


def _check_heads(seq: torch.Tensor, heads: torch.Tensor, what: str) -> None:
    if heads.dtype != torch.int64 or heads.dim() != 1 or heads.device != seq.device:
        raise ValueError(f"{what} need a 1-D int64 head list on the sequence's device")


def _site_rows(seq: torch.Tensor, n: int, heads: torch.Tensor, df, jump: int,
               polish: bool) -> torch.Tensor:
    """Launch the site kernel (SNV or polish form) on the current stream."""
    lib = load_library()
    _check_filter(df)
    _check_seq(seq, df, n + df.k - 1, aligned=False)
    heads = heads.contiguous()
    rows = torch.empty((heads.shape[0], 6), dtype=torch.uint8, device=seq.device)
    if not heads.shape[0]:
        return rows
    rc = lib.nts_site_rows(seq.data_ptr(), n, df.k, heads.data_ptr(), heads.shape[0],
                           *_filter_args(df), jump, int(polish), rows.data_ptr(),
                           torch.cuda.current_stream(seq.device).cuda_stream)
    if rc != 0:
        form = "polish site" if polish else "SNV site"
        raise RuntimeError(f"{form} kernel launch failed: {lib.nts_error_string(rc).decode()}")
    return rows


def snv_site_rows(seq: torch.Tensor, n: int, cand: torch.Tensor, df, jump: int) -> torch.Tensor:
    """Site rows uint8 [G, 6] of the candidate heads ``cand`` (int64 [G],
    on ``seq``'s device) of a contig of ``n`` heads; ``seq`` holds its
    n + k - 1 bytes.  On CUDA the kernel runs on the current stream and
    the call does not synchronise."""
    _check_heads(seq, cand, "site rows")
    if jump < 1:
        raise ValueError(f"site rows need jump >= 1, got {jump}")
    if seq.device.type == "cpu":
        return snv_site_rows_plain(seq, n, cand, df, jump)
    rows = _site_rows(seq, n, cand, df, jump, polish=False)
    if cand.shape[0]:
        with _count_lock:
            snv_site_rows.launches += 1
    return rows


def polish_site_rows(seq: torch.Tensor, n: int, gates: torch.Tensor, df, jump: int) -> torch.Tensor:
    """Polish rows uint8 [G, 6], one per gate head of the sorted ``gates``
    (int64 [G], on ``seq``'s device), of a contig of ``n`` heads; ``seq``
    holds its n + k - 1 bytes.  On CUDA the kernel runs on the current
    stream and the call does not synchronise."""
    _check_heads(seq, gates, "polish rows")
    if jump < 1:
        raise ValueError(f"polish rows need jump >= 1, got {jump}")
    if seq.device.type == "cpu":
        return polish_site_rows_plain(seq, n, gates, df, jump)
    rows = _site_rows(seq, n, gates, df, jump, polish=True)
    if gates.shape[0]:
        with _count_lock:
            polish_site_rows.launches += 1
    return rows


def polish_cand_masks(seq: torch.Tensor, n: int, gates: torch.Tensor, df) -> torch.Tensor:
    """Candidate masks uint8 [G] of the gate heads ``gates`` (int64 [G], on
    ``seq``'s device) of a contig of ``n`` heads; ``seq`` holds its
    n + k - 1 bytes.  On CUDA the kernel runs on the current stream and the
    call does not synchronise."""
    _check_heads(seq, gates, "candidate masks")
    if seq.device.type == "cpu":
        return polish_cand_masks_plain(seq, n, gates, df)
    lib = load_library()
    _check_filter(df)
    _check_seq(seq, df, n + df.k - 1, aligned=False)
    gates = gates.contiguous()
    masks = torch.empty(gates.shape[0], dtype=torch.uint8, device=seq.device)
    if not gates.shape[0]:
        return masks
    rc = lib.nts_cand_masks(seq.data_ptr(), n, df.k, gates.data_ptr(), gates.shape[0],
                            *_filter_args(df), masks.data_ptr(),
                            torch.cuda.current_stream(seq.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"candidate mask kernel launch failed: {lib.nts_error_string(rc).decode()}")
    with _count_lock:
        polish_cand_masks.launches += 1
    return masks


_count_lock = threading.Lock()
snv_cand_words.launches = 0  # kernel launches since the last reset
snv_site_rows.launches = 0
polish_site_rows.launches = 0
polish_cand_masks.launches = 0

OCCUPANCY_FORMS = ("cand_plain", "cand_blocked", "site_plain", "site_blocked",
                   "polish_site_plain", "polish_site_blocked", "masks_plain", "masks_blocked")


def occupancy() -> dict:
    """Resident blocks per SM of each kernel form on the current card;
    negative on error."""
    lib = load_library()
    return {name: lib.nts_occupancy(i) for i, name in enumerate(OCCUPANCY_FORMS)}
