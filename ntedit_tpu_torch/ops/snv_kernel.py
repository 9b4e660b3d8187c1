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

With a blocked filter the same words come from the binned pass (``binned``
says when): ``snv_cand_bin(seq, n, df, bins, out)`` stores the forced
bits (valid and IUPAC) into ``out`` and bins every due probe (a valid head
with no IUPAC byte, each of its three alternates) by the slice of the
filter its word lies in, into ``bins`` (a ``CandBins``); then
``snv_cand_probe(bins, df, out)`` probes them slice by slice and ORs each
present one's head into ``out``.

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
k - 1, ends in a byte it coded as 'A'; the port's row is zero there.)  The
kernel gives a row four lanes (SITE_LANES), each hashing its share of the
row's windows in one roll, and makes only the probes the function needs.

``polish_site_rows(seq, n, gates, df, jump)`` is the polish form: for a
chunk's sorted gate heads, one row each, parallel to the gates.  Bit 5 of
``row[0]`` ("device-exact gate") is set where the window [h, h + k) holds
ACGTacgt only, so that the gate is the filter's verdict and not a forced
IUPAC one; the rest of the row is computed at cluster starts (a gate whose
predecessor in the list is not h - 1, and the list's first gate) whose row
is valid, with ``row[1]`` = the number of those stride windows that are
ABSENT (check_missing, the engine's attempt gate), and is zero elsewhere.
On the card a block takes 512 gates: its threads write bit 5, list the
cluster starts with a valid row in shared memory and then compute those
rows as the SNV form does.

``polish_cand_masks(seq, n, gates, df, gated=...)`` returns one uint8 per
head (int64, any order): bit c = contains(window at h with its last base
set to "ACGT"[c]), for all four c, the draft's own base included; 0xFF
where [h, h + k) holds a byte that is not ACGTacgt.  ``gated`` has no
default.  With ``gated=True`` (every caller on a path) the heads are
absence gates of this filter, so the draft's own base (the window's own
k-mer) is absent at an ACGTacgt window: its bit is 0 without a probe,
three probes a gate where ``gated=False`` makes four.  The engine takes
the bits of the alternates as its first substitution probe at pristine
windows.  On the card a thread takes a head.

All take a blocked or a plain filter and raise for a counting one (those
runs go through the gate pass alone).  On a CUDA tensor a wrapper launches
csrc/snv_kernel.cu (built with nvcc at first use) or raises; on a CPU
tensor it runs its plain version.  The kernels replace the JAX package's
XLA programs engine/flag.py::_snv_cand_words_from_codes,
_snv_site_data_from_codes, _polish_site_data_from_codes and
_polish_cand_planes_from_codes with _gather_cand_masks; see the note in
the .cu source.  The binned pass computes the candidate kernel's function.
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
# the site kernel's: pristine and three alternates of two windows (plain: one)
SITE_BATCH = {"blocked": 8, "plain": 4}
SITE_LANES = 4  # lanes it gives an SNV row (csrc kRowLanes)
POLISH_GATES = 512  # gates a block of its polish form takes (csrc kPolishGates)
# the mask kernel's, by ``gated``: the three alternates at an absence gate,
# else the four bases at the site (csrc kMaskProbesGated, kMaskProbes)
MASK_BATCH = {True: 3, False: 4}
EXACT_GATE = 32  # polish rows: flags bit 5, "device-exact gate"
# the binned candidate pass: slices of 2^22 filter words (16 MiB), raised
# until the filter has at most CAND_SLICES of them (utils/snv_sweep.py on
# an H100: the fastest at 256 MiB to 4 GiB); the kernels take up to
# MAX_CAND_SLICES (csrc kMaxCandSlices)
CAND_SLICE_BITS = 22
CAND_SLICES = 64
MAX_CAND_SLICES = 256
PROBE_CHUNK = 1024  # entries per block of its probe kernel (csrc kProbeChunk)
CAND_ROUND_HEADS = 4  # heads a thread of its front end takes per round (csrc kCandRoundHeads)
CAND_ROUNDS = 32 // CAND_ROUND_HEADS
# the density rule (see ``binned``): the binned pass won or tied at 1.31
# probes a sector and above, lost at 0.67 and below (utils/snv_sweep.py)
MIN_PROBES_PER_SECTOR = 1.0
ENTRY_BYTES = 12  # an entry: the alternate's canonical hash (8 B) and its head (4 B)

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


def binned(df, heads: int) -> bool:
    """Whether the candidate words of ``heads`` heads at a time (a group of
    chunks) with the filter ``df`` come from the binned pass (snv_cand_bin,
    snv_cand_probe) rather than snv_cand_words: a blocked filter, and at
    least MIN_PROBES_PER_SECTOR of the group's probes (three a head) per
    32-byte sector of the filter."""
    return df.blocked and 24 * heads >= MIN_PROBES_PER_SECTOR * df.modulus  # words / 8 sectors


class CandBins:
    """The binned candidate pass's scratch, for up to ``heads`` heads at a
    time and a blocked filter of ``words`` words (a power of two): the
    buffers that ``snv_cand_bin`` fills and ``snv_cand_probe`` reads.

    * ``counts``  int32 [slices * columns]: the probes of (slice, column),
      slice-major (a slice is 2^slice_bits words); column b * CAND_ROUNDS +
      r holds round r of block b (blocks of 8192 heads; in round r a
      thread takes its heads [r * w, (r + 1) * w) of its 32, w =
      CAND_ROUND_HEADS);
    * ``ends``    int64, the same shape: its inclusive scan, so slice s's
      bucket is ``[ends[s*columns] - counts[s*columns], ends[s*columns +
      columns - 1])`` and the buckets lie in slice order;
    * ``can``     int64 [3 * heads]: each probe's canonical hash;
    * ``head``    int32 [3 * heads]: its head, relative to the batch's
      first (uint32 bits).

    ``n`` and ``columns`` are those of the batch last binned (0 before
    any).  ``slice_bits`` None takes CAND_SLICE_BITS raised until the
    filter has at most CAND_SLICES slices; a given one is raised until it
    has at most MAX_CAND_SLICES.  The buffers are allocated once, with
    torch.empty: ENTRY_BYTES per probe."""

    def __init__(self, words: int, heads: int, device, slice_bits: int = None):
        if words < 1 or words & (words - 1):
            raise ValueError(f"the binned pass needs a power-of-two word count, got {words}")
        if not 1 <= heads < 1 << 32:
            raise ValueError(f"the binned pass takes 1 to 2^32 - 1 heads at a time, got {heads}")
        wbits = words.bit_length() - 1
        bits = max(CAND_SLICE_BITS, wbits - CAND_SLICES.bit_length() + 1) \
            if slice_bits is None else slice_bits
        if bits < 0:
            raise ValueError(f"slice_bits must be >= 0, got {bits}")
        while (words - 1) >> bits >= MAX_CAND_SLICES:
            bits += 1
        self.words = words
        self.heads = heads
        self.slice_bits = bits
        self.n_slices = ((words - 1) >> bits) + 1
        cells = self.n_slices * -(-heads // gate_kernel.TILE) * CAND_ROUNDS
        self.counts = torch.empty(cells, dtype=torch.int32, device=device)
        self.ends = torch.empty(cells, dtype=torch.int64, device=device)
        self.can = torch.empty(3 * heads, dtype=torch.int64, device=device)
        self.head = torch.empty(3 * heads, dtype=torch.int32, device=device)
        self.n = 0
        self.columns = 0

    @property
    def device(self) -> torch.device:
        return self.can.device

    @property
    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in (self.counts, self.ends, self.can, self.head))

    def cells(self) -> int:
        """Entries of the count matrix of the batch last binned."""
        return self.n_slices * self.columns

    def total(self) -> int:
        """Probes the batch last binned holds (reads the card)."""
        cells = self.cells()
        return int(self.ends[cells - 1]) if cells else 0

    def _start(self, n: int) -> None:
        self.n = max(0, n)
        self.columns = -(-self.n // gate_kernel.TILE) * CAND_ROUNDS

    def cell(self, head: torch.Tensor, can: torch.Tensor) -> torch.Tensor:
        """The (slice, column) cell of each probe (int64 heads and hashes)."""
        column = head // gate_kernel.TILE * CAND_ROUNDS + head % 32 // CAND_ROUND_HEADS
        return ((can & (self.words - 1)) >> self.slice_bits) * self.columns + column


def _check_bins(seq: torch.Tensor, n: int, df, bins: CandBins, out: torch.Tensor) -> None:
    _check_filter(df)
    if not df.blocked or df.modulus != bins.words:
        raise ValueError(f"bins for a blocked filter of {bins.words} words, got a "
                         f"{df.layout} filter of {df.modulus}")
    if n > bins.heads:
        raise ValueError(f"bins hold up to {bins.heads} heads, got {n}")
    if seq.device != bins.device or out.device != bins.device:
        raise ValueError(f"bins on {bins.device}, sequence on {seq.device}, words on {out.device}")
    if out.dtype != torch.int32 or out.dim() != 1 or not out.is_contiguous() \
            or out.numel() < -(-max(0, n) // 32):
        raise ValueError(f"the words need a contiguous int32 tensor of {-(-max(0, n) // 32)}")


def snv_cand_bin_plain(seq: torch.Tensor, n: int, df, bins: CandBins, out: torch.Tensor) -> None:
    """The binned pass's front end in plain torch, on any device: the same
    forced bits, count matrix and scan as the kernel, and each (slice,
    column) range holding the same probes (here alternate by alternate in
    head order; the kernel's order within a range depends on its
    atomics)."""
    _check_bins(seq, n, df, bins, out)
    bins._start(n)
    if n <= 0:
        return
    k = df.k
    valid, iupac = gate_kernel.window_flags(seq[: n + k - 1], n, k)
    out[: -(-n // 32)] = gate_kernel.pack_bits(valid & iupac)
    live = valid & ~iupac
    heads, cans = [], []
    for _b, allowed, can in alternate_hashes(seq, n, k):
        pos = torch.nonzero(live & allowed).squeeze(1)
        heads.append(pos)
        cans.append(can[pos])
    head, can = torch.cat(heads), torch.cat(cans)
    key = bins.cell(head, can)
    cells = bins.cells()
    counts = torch.bincount(key, minlength=cells)
    bins.counts[:cells] = counts.to(torch.int32)
    torch.cumsum(counts, 0, out=bins.ends[:cells])
    order = torch.sort(key, stable=True).indices
    bins.can[: can.numel()] = can[order]
    head = head[order]
    bins.head[: head.numel()] = torch.where(head >= 1 << 31, head - (1 << 32), head).to(torch.int32)


def bin_entries(bins: CandBins) -> tuple:
    """(cell, head, can), int64: the (slice, column) cell, the head and the
    hash of every probe the last front end binned, in entry order."""
    cells = bins.cells()
    total = bins.total()
    ids = torch.arange(cells, device=bins.device)
    cell = torch.repeat_interleave(ids, bins.counts[:cells].long())
    return cell, bins.head[:total].long() & 0xFFFFFFFF, bins.can[:total]


def bin_multiset(bins: CandBins) -> tuple:
    """``bin_entries`` sorted by cell, then head, then hash: equal for two
    binnings exactly when each (slice, column) range holds the same probes."""
    cell, head, can = bin_entries(bins)
    order = torch.sort(can, stable=True).indices
    order = order[torch.sort(head[order], stable=True).indices]
    order = order[torch.sort(cell[order], stable=True).indices]
    return cell[order], head[order], can[order]


def snv_cand_probe_plain(bins: CandBins, df, out: torch.Tensor) -> None:
    """The binned pass's probes in plain torch, on any device: the heads of
    the present probes ORed into ``out``."""
    _cell, head, can = bin_entries(bins)
    if not head.numel():
        return
    present = torch.zeros(bins.n, dtype=torch.bool, device=bins.device)
    present[head[_contains(df, can)]] = True
    nw = -(-bins.n // 32)
    out[:nw] |= gate_kernel.pack_bits(present)


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


def mask_hashes(seq: torch.Tensor, n: int, gates: torch.Tensor, k: int,
                gated: bool) -> tuple:
    """(clean [G] bool, hashes, probed): the gates whose window [h, h + k)
    is ACGTacgt only, and for each base c of "ACGT" the canonical hashes
    [V] of their windows with the last byte set to it, each window hashed
    from its own bytes; ``probed`` [V] bool for each c: whether the kernel
    probes it (all, or with ``gated`` the bases other than the draft's)."""
    clean, win = _acgt_windows(seq, gates, k, n - 1)
    own = win[:, k - 1].long() & 0xDF
    hashes, probed = [], []
    for b in ACGT:
        sub = win.clone()
        sub[:, k - 1] = b
        hashes.append(_rotated_hash(sub, k))
        probed.append(own != b if gated else torch.ones_like(own, dtype=torch.bool))
    return clean, hashes, probed


def polish_cand_masks_plain(seq: torch.Tensor, n: int, gates: torch.Tensor, df,
                            gated: bool) -> torch.Tensor:
    """The candidate-mask pass in plain torch int64, on any device."""
    _check_filter(df)
    masks = torch.full((gates.shape[0],), 0xFF, dtype=torch.uint8, device=seq.device)
    if not gates.shape[0]:
        return masks
    clean, hashes, probed = mask_hashes(seq, n, gates, df.k, gated)
    bits = torch.zeros(int(clean.sum()), dtype=torch.int64, device=seq.device)
    for c, (can, on) in enumerate(zip(hashes, probed)):
        bits |= (_contains(df, can) & on).long() << c
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


def declare_site_rows(lib) -> None:
    """Declare the site kernel's C interface on a build of the kernels."""
    filt = [ctypes.c_void_p, ctypes.c_uint64, ctypes.c_uint64,  # table, modulus, magic
            ctypes.c_int, ctypes.c_int, ctypes.c_int]           # wbits, layout, hash_num
    lib.nts_site_rows.restype = ctypes.c_int
    lib.nts_site_rows.argtypes = [ctypes.c_void_p, ctypes.c_uint64, ctypes.c_int,   # seq, n, k
                                  ctypes.c_void_p, ctypes.c_uint64,                 # heads, n_heads
                                  *filt, ctypes.c_int, ctypes.c_int,                # jump, polish
                                  ctypes.c_void_p, ctypes.c_void_p]                 # rows, stream
    lib.nts_error_string.restype = ctypes.c_char_p
    lib.nts_error_string.argtypes = [ctypes.c_int]


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
    declare_site_rows(lib)
    lib.nts_polish_lanes.restype = ctypes.c_int
    lib.nts_polish_lanes.argtypes = [ctypes.c_uint32]
    lib.nts_cand_masks.restype = ctypes.c_int
    lib.nts_cand_masks.argtypes = [ctypes.c_void_p, ctypes.c_uint64, ctypes.c_int,  # seq, n, k
                                   ctypes.c_void_p, ctypes.c_uint64,                # gates, n_gates
                                   *filt, ctypes.c_int,                             # gated
                                   ctypes.c_void_p, ctypes.c_void_p]                # masks, stream
    u64, ptr, i32 = ctypes.c_uint64, ctypes.c_void_p, ctypes.c_int
    lib.nts_cand_bin.restype = i32
    lib.nts_cand_bin.argtypes = [ptr, u64, i32,                 # seq, n, k
                                 ptr, u64, i32, i32,            # table, words, wbits, hash_num
                                 i32, i32, ptr, ptr,            # slice_bits, slices, counts, ends
                                 ptr, ptr, ptr, i32, ptr]       # can, head, out, scatter, stream
    lib.nts_cand_probe.restype = i32
    lib.nts_cand_probe.argtypes = [ptr, ptr, ptr, u64,          # can, head, total, max_entries
                                   ptr, u64, i32, i32,          # table, words, wbits, hash_num
                                   ptr, ptr]                    # out, stream
    lib.nts_occupancy.restype = ctypes.c_int
    lib.nts_occupancy.argtypes = [ctypes.c_int]
    for name in ("nts_tile_heads", "nts_halo_bytes", "nts_max_cand_slices", "nts_probe_chunk",
                 "nts_cand_rounds"):
        getattr(lib, name).restype = ctypes.c_int
        getattr(lib, name).argtypes = []
    lib.nts_cand_batch.restype = ctypes.c_int
    lib.nts_cand_batch.argtypes = [ctypes.c_int]
    for name in ("nts_site_lanes", "nts_polish_gates"):
        getattr(lib, name).restype = ctypes.c_int
        getattr(lib, name).argtypes = []
    for name in ("nts_site_batch", "nts_mask_batch"):
        getattr(lib, name).restype = ctypes.c_int
        getattr(lib, name).argtypes = [ctypes.c_int]
    if (lib.nts_tile_heads(), lib.nts_halo_bytes()) != (gate_kernel.TILE, gate_kernel.HALO):
        raise RuntimeError("SNV kernel tile/halo differ from the wrapper's")
    if any(lib.nts_cand_batch(LAYOUT_CODE[name]) != b for name, b in CAND_BATCH.items()):
        raise RuntimeError("SNV candidate kernel batch differs from the wrapper's")
    if (lib.nts_site_lanes(), lib.nts_polish_gates()) != (SITE_LANES, POLISH_GATES) or any(
            lib.nts_mask_batch(int(gated)) != b for gated, b in MASK_BATCH.items()) or any(
            lib.nts_site_batch(LAYOUT_CODE[name]) != b for name, b in SITE_BATCH.items()):
        raise RuntimeError("mask or site kernel batch or lanes differ from the wrapper's")
    if (lib.nts_max_cand_slices(), lib.nts_probe_chunk(), lib.nts_cand_rounds()) != (
            MAX_CAND_SLICES, PROBE_CHUNK, CAND_ROUNDS):
        raise RuntimeError("binned candidate pass slices, probe chunk or rounds differ from the "
                           "wrapper's")
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


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def snv_cand_bin(seq: torch.Tensor, n: int, df, bins: CandBins, out: torch.Tensor) -> None:
    """The binned pass's front end for heads [0, n) of ``seq`` and a blocked
    filter (see the module docstring): the forced bits into
    ``out[:ceil(n/32)]`` (stored, not ORed), every due probe into ``bins``:
    the kernel's counting form, the scan of the count matrix
    (torch.cumsum), then its scattering form.  One call is one launch (its
    two forms).  On CUDA, ``seq`` is laid out as for snv_cand_words; the
    kernels run on the current stream and the call does not synchronise."""
    _check_bins(seq, n, df, bins, out)
    if seq.device.type == "cpu":
        return snv_cand_bin_plain(seq, n, df, bins, out)
    lib = load_library()
    _check_seq(seq, df, padded_len(n), aligned=True)
    bins._start(n)
    cells = bins.cells()
    counts, ends = bins.counts[:cells], bins.ends[:cells]
    if n <= 0:
        return None
    args = (seq.data_ptr(), n, df.k, df.table.data_ptr(), df.modulus, df.wbits, df.hash_num,
            bins.slice_bits, bins.n_slices, counts.data_ptr())
    stream = _stream(seq)
    rc = lib.nts_cand_bin(*args, None, None, None, out.data_ptr(), 0, stream)
    if rc == 0:
        torch.cumsum(counts, 0, dtype=torch.int64, out=ends)
        rc = lib.nts_cand_bin(*args, ends.data_ptr(), bins.can.data_ptr(), bins.head.data_ptr(),
                              out.data_ptr(), 1, stream)
    if rc != 0:
        raise RuntimeError(f"SNV candidate bin kernel launch failed: {lib.nts_error_string(rc).decode()}")
    with _count_lock:
        snv_cand_bin.launches += 1
    return None


def snv_cand_probe(bins: CandBins, df, out: torch.Tensor) -> None:
    """The binned pass's probes: every probe the last ``snv_cand_bin`` put
    into ``bins``, slice by slice, ORing the heads of the present ones into
    ``out`` (uint32 bits as int32), in place.  On CUDA the kernel runs on
    the current stream and the call does not synchronise."""
    _check_filter(df)
    if not df.blocked or df.modulus != bins.words or out.device != bins.device:
        raise ValueError("the probes need the blocked filter and the words device of their bins")
    if bins.device.type == "cpu":
        return snv_cand_probe_plain(bins, df, out)
    lib = load_library()
    cells = bins.cells()
    if not cells:
        return None
    total_at = bins.ends.data_ptr() + 8 * (cells - 1)
    rc = lib.nts_cand_probe(bins.can.data_ptr(), bins.head.data_ptr(), total_at, 3 * bins.n,
                            df.table.data_ptr(), df.modulus, df.wbits, df.hash_num,
                            out.data_ptr(), _stream(out))
    if rc != 0:
        raise RuntimeError(f"SNV candidate probe kernel launch failed: {lib.nts_error_string(rc).decode()}")
    with _count_lock:
        snv_cand_probe.launches += 1
    return None


def _check_heads(seq: torch.Tensor, heads: torch.Tensor, what: str) -> None:
    if heads.dtype != torch.int64 or heads.dim() != 1 or heads.device != seq.device:
        raise ValueError(f"{what} need a 1-D int64 head list on the sequence's device")


def polish_lanes(rows: int) -> int:
    """The lanes a block of the polish form gives each of its ``rows``
    listed rows."""
    return load_library().nts_polish_lanes(rows)


def _site_rows(seq: torch.Tensor, n: int, heads: torch.Tensor, df, jump: int,
               polish: bool, lib=None) -> torch.Tensor:
    """Launch the site kernel (SNV or polish form) on the current stream;
    ``lib`` another build of it (declare_site_rows), for timing."""
    lib = lib or load_library()
    _check_filter(df)
    _check_seq(seq, df, n + df.k - 1, aligned=False)
    heads = heads.contiguous()
    rows = torch.empty((heads.shape[0], 6), dtype=torch.uint8, device=seq.device)
    if not heads.shape[0]:
        return rows
    rc = lib.nts_site_rows(seq.data_ptr(), n, df.k, heads.data_ptr(), heads.shape[0],
                           *_filter_args(df), jump, int(polish), rows.data_ptr(), _stream(seq))
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


def polish_cand_masks(seq: torch.Tensor, n: int, gates: torch.Tensor, df, *,
                      gated: bool) -> torch.Tensor:
    """Candidate masks uint8 [G] of the heads ``gates`` (int64 [G], on
    ``seq``'s device) of a contig of ``n`` heads; ``seq`` holds its
    n + k - 1 bytes.  ``gated`` (no default: a caller names its form):
    True where the heads are absence gates of ``df``, as on every path
    (the draft's own base is not probed); False for any heads.  On CUDA
    the kernel runs on the current stream and the call does not
    synchronise; each launch counts in ``launches`` and in
    ``form_launches`` under its form."""
    _check_heads(seq, gates, "candidate masks")
    if seq.device.type == "cpu":
        return polish_cand_masks_plain(seq, n, gates, df, gated)
    lib = load_library()
    _check_filter(df)
    _check_seq(seq, df, n + df.k - 1, aligned=False)
    gates = gates.contiguous()
    masks = torch.empty(gates.shape[0], dtype=torch.uint8, device=seq.device)
    if not gates.shape[0]:
        return masks
    rc = lib.nts_cand_masks(seq.data_ptr(), n, df.k, gates.data_ptr(), gates.shape[0],
                            *_filter_args(df), int(bool(gated)), masks.data_ptr(),
                            torch.cuda.current_stream(seq.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"candidate mask kernel launch failed: {lib.nts_error_string(rc).decode()}")
    with _count_lock:
        polish_cand_masks.launches += 1
        polish_cand_masks.form_launches["gated" if gated else "four_probe"] += 1
    return masks


_count_lock = threading.Lock()
snv_cand_words.launches = 0  # kernel launches since the last reset
snv_cand_bin.launches = 0
snv_cand_probe.launches = 0
snv_site_rows.launches = 0
polish_site_rows.launches = 0
polish_cand_masks.launches = 0
polish_cand_masks.form_launches = {"gated": 0, "four_probe": 0}

OCCUPANCY_FORMS = ("cand_plain", "cand_blocked", "site_plain", "site_blocked",
                   "polish_site_plain", "polish_site_blocked", "masks_plain", "masks_blocked",
                   "cand_bin_count", "cand_bin_scatter", "cand_probe", "masks_gated_plain",
                   "masks_gated_blocked")


def occupancy() -> dict:
    """Resident blocks per SM of each kernel form on the current card;
    negative on error."""
    lib = load_library()
    return {name: lib.nts_occupancy(i) for i, name in enumerate(OCCUPANCY_FORMS)}
