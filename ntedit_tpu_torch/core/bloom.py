"""K-mer Bloom filters: host representation, btllib-compatible file format,
and device-resident probing in torch.

The host classes and the file format are a copy of the JAX package's
``core/bloom.py`` (the port keeps its own host code):

* ``KmerBloomFilter`` — m hash values -> m bit probes into a byte array,
  bit index = ``hash % (bytes * 8)``, little-endian bit order within bytes
  (ntedit.cpp:362-394 uses btllib's contains()).
* ``KmerCountingBloomFilter8`` — ``contains`` returns the *minimum counter*
  across the m probed uint8 slots, slot index = ``hash % bytes``
  (count-min behaviour; reference get_count at ntedit.cpp:373-376).
* ``BlockedKmerBloomFilter`` — all probe bits of a k-mer in one uint32 word.
* File format: plaintext signature header line, ``key = value`` metadata,
  a ``[HEADER_END]`` terminator line, then the raw array.

``DeviceFilter`` holds the filter's array as a torch tensor on a device
and probes it with plain torch integer code (``contains``, ``count``);
the CUDA gate kernel (ntedit_tpu_torch.ops.gate_kernel) reads the same
tensors.
"""

from __future__ import annotations

import dataclasses
import math
import os
from typing import Sequence

import numpy as np
import torch

from ntedit_tpu_torch.core import nthash as nt
from ntedit_tpu_torch.core import nthash_ref as ref
from ntedit_tpu_torch.utils import profiling

KMER_BF_SIGNATURE = "[BTLKmerBloomFilter_v6]"
KMER_CBF_SIGNATURE = "[BTLKmerCountingBloomFilter_v6]"
BF_SIGNATURE = "[BTLBloomFilter_v6]"
BLOCKED_BF_SIGNATURE = "[NTPUBlockedKmerBloomFilter_v1]"
HEADER_END = "[HEADER_END]"


def bf_size_bytes(num_elements: int, num_hashes: int = 3, fpr: float = 0.01) -> int:
    """Broder–Mitzenmacher sizing, identical formula to the reference BF
    filter tool (src/ntedit_make_genome_bf.cpp:41-47):
    m_bits = ceil(n * (-h / ln(1 - e^(ln(fpr)/h)))), returned in bytes."""
    r = -num_hashes / math.log(1.0 - math.exp(math.log(fpr) / num_hashes))
    return int(math.ceil(num_elements * r)) // 8


def pow2_size_bytes(num_elements: int, num_hashes: int = 3, fpr: float = 0.01) -> int:
    """Framework-native sizing: next power of two >= btllib sizing (modulo
    becomes a mask on device; FPR only improves)."""
    b = max(8, bf_size_bytes(num_elements, num_hashes, fpr))
    return 1 << (b - 1).bit_length()


@dataclasses.dataclass
class KmerBloomFilter:
    """Host-side k-mer Bloom filter (presence/absence)."""

    data: np.ndarray  # uint8 byte array
    hash_num: int
    k: int

    @property
    def bytes(self) -> int:
        return self.data.size

    @property
    def bits(self) -> int:
        return self.data.size * 8

    @classmethod
    def zeros(cls, num_bytes: int, hash_num: int, k: int) -> "KmerBloomFilter":
        return cls(np.zeros(num_bytes, dtype=np.uint8), hash_num, k)

    # -- probing (numpy, vectorized; used by the scalar oracle and tests) --
    def contains_hashes(self, hashes: np.ndarray) -> np.ndarray:
        """hashes [n, m] uint64 -> bool [n] (all m bits set)."""
        bits = self.bits
        if bits & (bits - 1) == 0:
            idx = hashes & np.uint64(bits - 1)  # pow2: mask beats u64 modulo
        else:
            idx = hashes % np.uint64(bits)
        byte = (idx >> np.uint64(3)).astype(np.int64)
        mask = np.uint8(1) << (idx & np.uint64(7)).astype(np.uint8)
        return ((self.data[byte] & mask) != 0).all(axis=-1)

    def insert_hashes(self, hashes: np.ndarray) -> None:
        idx = (hashes.reshape(-1) % np.uint64(self.bits))
        byte = (idx >> np.uint64(3)).astype(np.int64)
        mask = (np.uint8(1) << (idx & np.uint64(7)).astype(np.uint8))
        np.bitwise_or.at(self.data, byte, mask)

    def insert_seq(self, seq: bytes | np.ndarray) -> None:
        """Insert every k-mer of seq (btllib KmerBloomFilter::insert(seq))."""
        arr = np.frombuffer(bytes(seq), dtype=np.uint8) if isinstance(seq, (bytes, bytearray)) else seq
        fh, rh = ref.all_window_hashes(arr, self.k)
        if len(fh) == 0:
            return
        base = ref.canonical(fh, rh)
        self.insert_hashes(ref.extend_hashes_vec(base, self.k, self.hash_num))

    def contains_seq_kmers(self, seq: np.ndarray) -> np.ndarray:
        fh, rh = ref.all_window_hashes(seq, self.k)
        base = ref.canonical(fh, rh)
        return self.contains_hashes(ref.extend_hashes_vec(base, self.k, self.hash_num))

    @property
    def pop_count(self) -> int:
        return int(np.unpackbits(self.data).sum())

    @property
    def fpr(self) -> float:
        return (self.pop_count / self.bits) ** self.hash_num

    # -- serialization --
    def save(self, path: str) -> None:
        _save(path, KMER_BF_SIGNATURE, self.data,
              {"bytes": self.bytes, "hash_num": self.hash_num, "k": self.k})

    @classmethod
    def load(cls, path: str) -> "KmerBloomFilter":
        sig, meta, data = _load(path)
        if sig != KMER_BF_SIGNATURE:
            raise ValueError(f"{path}: not a k-mer Bloom filter ({sig})")
        return cls(data, int(meta["hash_num"]), int(meta["k"]))


@dataclasses.dataclass
class KmerCountingBloomFilter8:
    """Host-side 8-bit counting k-mer Bloom filter (count-min)."""

    counters: np.ndarray  # uint8, one counter per byte
    hash_num: int
    k: int

    @property
    def bytes(self) -> int:
        return self.counters.size

    @classmethod
    def zeros(cls, num_bytes: int, hash_num: int, k: int) -> "KmerCountingBloomFilter8":
        return cls(np.zeros(num_bytes, dtype=np.uint8), hash_num, k)

    def count_hashes(self, hashes: np.ndarray) -> np.ndarray:
        """hashes [n, m] -> uint8 [n]: min counter (count-min read)."""
        idx = (hashes % np.uint64(self.bytes)).astype(np.int64)
        return self.counters[idx].min(axis=-1)

    def insert_hashes(self, hashes: np.ndarray) -> None:
        """Saturating increment of every probed slot (btllib CBF semantics:
        all m slots +1 per insert, saturating at 255).  Batch-equivalent:
        per-slot total increments, then one clamped add — same result as
        stepwise saturation because saturation is monotone."""
        idx = (hashes % np.uint64(self.bytes)).astype(np.int64).ravel()
        slots, inc = np.unique(idx, return_counts=True)
        cur = self.counters[slots].astype(np.uint16)
        cur += np.minimum(inc, 255).astype(np.uint16)
        self.counters[slots] = np.minimum(cur, 255).astype(np.uint8)

    def save(self, path: str) -> None:
        _save(path, KMER_CBF_SIGNATURE, self.counters,
              {"bytes": self.bytes, "hash_num": self.hash_num, "k": self.k,
               "counter_bits": 8})

    @classmethod
    def load(cls, path: str) -> "KmerCountingBloomFilter8":
        sig, meta, data = _load(path)
        if sig != KMER_CBF_SIGNATURE:
            raise ValueError(f"{path}: not a counting Bloom filter ({sig})")
        return cls(data, int(meta["hash_num"]), int(meta["k"]))


@dataclasses.dataclass
class BlockedKmerBloomFilter:
    """Framework-native register-blocked k-mer Bloom filter.

    TPU-first design: a standard BF costs ``hash_num`` independent HBM
    gathers per probe (the btllib layout above); on TPU those random
    gathers dominate the dense flag pass.  Here all ``hash_num`` probe bits
    of a k-mer live in ONE uint32 word, so a probe is a single gather plus
    bit tests, and no multi-hash mixing is needed at all: the word index is
    the low bits of the canonical ntHash value and the bit offsets are
    disjoint 5-bit fields of its high bits (the canonical hash has 64 well-
    mixed bits; word+3 offsets consume at most ~37).

    Trade-off vs. the reference's btllib layout: slightly higher FPR at
    equal size (blocked-BF clustering + possible intra-word offset
    collisions) — compensate by sizing with ``pow2_size_bytes`` (the next
    power of two is on average 1.5x the Broder-Mitzenmacher size).  Used
    for framework-built filters; reference ``.bf`` artifacts keep the
    btllib layout for bit-identical interop.
    """

    words: np.ndarray  # uint32 word array, power-of-two length
    hash_num: int
    k: int
    blocked_layout = True  # probe layout marker (see engine fast paths)

    @property
    def bytes(self) -> int:
        return self.words.size * 4

    @property
    def bits(self) -> int:
        return self.words.size * 32

    @classmethod
    def zeros(cls, num_bytes: int, hash_num: int, k: int) -> "BlockedKmerBloomFilter":
        nw = max(1, num_bytes // 4)
        if nw & (nw - 1):
            nw = 1 << (nw - 1).bit_length()
        if hash_num * 5 + nw.bit_length() - 1 > 64:
            raise ValueError("hash_num too large for blocked layout")
        return cls(np.zeros(nw, dtype=np.uint32), hash_num, k)

    def _word_mask(self, base: np.ndarray):
        """canonical hashes [n] uint64 -> (word index [n] int64, probe mask
        [n] uint32)."""
        nw = self.words.size
        wbits = nw.bit_length() - 1
        widx = (base & np.uint64(nw - 1)).astype(np.int64)
        mask = np.zeros(len(base), dtype=np.uint32)
        for j in range(self.hash_num):
            off = ((base >> np.uint64(wbits + 5 * j)) & np.uint64(31)).astype(np.uint32)
            mask |= np.uint32(1) << off
        return widx, mask

    # API compatibility with the btllib-layout classes: the engine hands
    # extended-hash arrays [n, m]; only column 0 (the canonical hash,
    # extend_hashes keeps h[0] = base) is consumed here.
    def contains_hashes(self, hashes: np.ndarray) -> np.ndarray:
        h = np.asarray(hashes, dtype=np.uint64)
        return self.contains_base(h[..., 0].reshape(-1)).reshape(h.shape[:-1])

    def insert_hashes(self, hashes: np.ndarray) -> None:
        h = np.asarray(hashes, dtype=np.uint64)
        self.insert_base(h[..., 0].reshape(-1))

    def contains_base(self, base: np.ndarray) -> np.ndarray:
        widx, mask = self._word_mask(base)
        return (self.words[widx] & mask) == mask

    def insert_base(self, base: np.ndarray) -> None:
        widx, mask = self._word_mask(base)
        np.bitwise_or.at(self.words, widx, mask)

    def insert_seq(self, seq: bytes | np.ndarray) -> None:
        arr = np.frombuffer(bytes(seq), dtype=np.uint8) if isinstance(seq, (bytes, bytearray)) else seq
        fh, rh = ref.all_window_hashes(arr, self.k)
        if len(fh):
            self.insert_base(ref.canonical(fh, rh))

    def contains_seq_kmers(self, seq: np.ndarray) -> np.ndarray:
        fh, rh = ref.all_window_hashes(seq, self.k)
        return self.contains_base(ref.canonical(fh, rh))

    @property
    def pop_count(self) -> int:
        return int(np.unpackbits(self.words.view(np.uint8)).sum())

    @property
    def fpr(self) -> float:
        return (self.pop_count / self.bits) ** self.hash_num

    def save(self, path: str) -> None:
        _save(path, BLOCKED_BF_SIGNATURE, self.words.view(np.uint8).copy(),
              {"bytes": self.bytes, "hash_num": self.hash_num, "k": self.k,
               "layout": "blocked32"})

    @classmethod
    def load(cls, path: str) -> "BlockedKmerBloomFilter":
        sig, meta, data = _load(path)
        if sig != BLOCKED_BF_SIGNATURE:
            raise ValueError(f"{path}: not a blocked k-mer Bloom filter ({sig})")
        return cls(np.array(data).view(np.uint32), int(meta["hash_num"]), int(meta["k"]))


def check_file_signature(path: str, signature: str) -> bool:
    """Mirror of btllib check_file_signature (used at ntedit.cpp:357-360)."""
    try:
        with open(path, "rb") as f:
            first = f.readline().decode("ascii", "replace").strip()
        return first == signature
    except OSError:
        return False


def load_any(path: str):
    """Load a .bf or .cbf by signature sniffing (BFWrapper behaviour,
    ntedit.cpp:355-364), extended with the framework-native blocked
    format (span ``io.load``)."""
    with profiling.span("io.load"):
        if check_file_signature(path, KMER_CBF_SIGNATURE):
            return KmerCountingBloomFilter8.load(path)
        if check_file_signature(path, BLOCKED_BF_SIGNATURE):
            return BlockedKmerBloomFilter.load(path)
        return KmerBloomFilter.load(path)


def _save(path: str, signature: str, data: np.ndarray, meta: dict) -> None:
    # streamed (tofile), not BytesIO-buffered: a 4 GiB human-scale filter
    # must not hold two extra in-memory copies on the way to disk; written
    # under a name of this process's own and renamed, so that ranks saving
    # the same stage file never leave a torn one
    tmp = f"{path}.{os.getpid()}.tmp"
    with profiling.span("io.save"):
        with open(tmp, "wb") as f:
            f.write((signature + "\n").encode())
            for key, val in meta.items():
                f.write(f"{key} = {val}\n".encode())
            f.write((HEADER_END + "\n").encode())
            np.ascontiguousarray(data).tofile(f)
        os.replace(tmp, path)


def _load(path: str):
    with open(path, "rb") as f:
        sig = f.readline().decode().strip()
        meta = {}
        while True:
            line = f.readline()
            if not line:
                raise ValueError(f"{path}: missing {HEADER_END}")
            text = line.decode().strip()
            if text == HEADER_END:
                break
            if "=" in text:
                key, _, val = text.partition("=")
                meta[key.strip()] = val.strip().strip('"')
        data = np.frombuffer(f.read(), dtype=np.uint8)
    nbytes = int(meta.get("bytes", data.size))
    if data.size < nbytes:
        raise ValueError(f"{path}: truncated array ({data.size} < {nbytes})")
    return sig, meta, np.array(data[:nbytes])  # copy -> writable


# ---------------------------------------------------------------------------
# Device-side filter
# ---------------------------------------------------------------------------

BLOCKED, PLAIN, COUNTING = "blocked", "plain", "counting"

# Largest filters one device probes (the JAX package's limits): the plain
# layout's bit index stays below 2^36 (umod's range), the blocked word
# index and the counter index below 2^31.
MAX_PLAIN_BITS = 1 << 36
MAX_BLOCKED_WORDS = 1 << 31
MAX_COUNTERS = 1 << 31


class DeviceFilter:
    """A filter's array as a torch tensor on one device, probed with plain
    torch integer code.

    ``table`` is the bit array as little-endian uint32 words stored as
    int32 (blocked and plain layouts), or the uint8 counters (counting).
    ``modulus`` is what a hash is reduced by: the word count (blocked,
    a power of two), the bit count (plain) or the counter count."""

    def __init__(self, layout: str, table: torch.Tensor, modulus: int,
                 hash_num: int, k: int):
        self.layout = layout
        self.table = table
        self.modulus = modulus
        self.hash_num = hash_num
        self.k = k

    @property
    def blocked(self) -> bool:
        return self.layout == BLOCKED

    @property
    def counting(self) -> bool:
        return self.layout == COUNTING

    @property
    def device(self) -> torch.device:
        return self.table.device

    @property
    def wbits(self) -> int:
        """log2 of the blocked layout's word count."""
        return self.modulus.bit_length() - 1

    @classmethod
    def from_host(cls, bf, device) -> "DeviceFilter":
        """Copy a host filter to ``device``.  The size limits are checked
        before anything is allocated."""
        if isinstance(bf, BlockedKmerBloomFilter):
            nw = bf.words.size
            if nw > MAX_BLOCKED_WORDS:
                raise NotImplementedError("single-device blocked filter limited to 2^31 words")
            if nw & (nw - 1) or bf.hash_num * 5 + nw.bit_length() - 1 > 64:
                raise ValueError("blocked filter needs a power-of-two word count "
                                 "and hash_num * 5 + log2(words) <= 64")
            words = np.ascontiguousarray(bf.words, dtype=np.uint32).view(np.int32)
            return cls(BLOCKED, _upload(words, device), nw, bf.hash_num, bf.k)
        if isinstance(bf, KmerBloomFilter):
            if bf.bits > MAX_PLAIN_BITS:
                raise NotImplementedError("single-device filter limited to 2^36 bits (8 GiB)")
            words = _pack_words(bf.data).view(np.int32)
            return cls(PLAIN, _upload(words, device), bf.bits, bf.hash_num, bf.k)
        if isinstance(bf, KmerCountingBloomFilter8):
            if bf.bytes > MAX_COUNTERS:
                raise NotImplementedError("single-device CBF limited to 2^31 counters")
            counters = np.ascontiguousarray(bf.counters, dtype=np.uint8)
            return cls(COUNTING, _upload(counters, device), bf.bytes,
                       bf.hash_num, bf.k)
        raise TypeError(f"not a k-mer filter: {type(bf).__name__}")

    # -- probing --
    def contains(self, hashes: Sequence[torch.Tensor]) -> torch.Tensor:
        """hashes: m int64 tensors (nthash.extend), each [...] -> bool [...].
        For a counting filter this is count > 0."""
        if self.counting:
            return self.count(hashes) > 0
        if self.blocked:
            return self._contains_blocked(hashes[0])
        ok = None
        for h in hashes[: self.hash_num]:
            idx = nt.umod(h, self.modulus)
            word = self.table[idx >> 5].long() & 0xFFFFFFFF
            got = (word >> (idx & 31)) & 1
            ok = got if ok is None else ok & got
        return ok == 1

    def _contains_blocked(self, base: torch.Tensor) -> torch.Tensor:
        """One word per probe: the word index is the low ``wbits`` bits of
        the canonical hash, the hash_num bit offsets are 5-bit fields
        above them (BlockedKmerBloomFilter layout)."""
        widx = base & (self.modulus - 1)
        mask = torch.zeros_like(base)
        for j in range(self.hash_num):
            mask |= 1 << (nt.shr(base, self.wbits + 5 * j) & 31)
        return (self.table[widx].long() & mask) == mask

    def count(self, hashes: Sequence[torch.Tensor]) -> torch.Tensor:
        """-> uint8 counts [...]: the minimum over the probed counters; 1/0
        presence for a non-counting filter."""
        if not self.counting:
            return self.contains(hashes).to(torch.uint8)
        cnt = None
        for h in hashes[: self.hash_num]:
            got = self.table[nt.umod(h, self.modulus)]
            cnt = got if cnt is None else torch.minimum(cnt, got)
        return cnt


def _upload(arr: np.ndarray, device) -> torch.Tensor:
    """Copy ``arr`` to ``device`` and wait for the copy: the gate kernel
    reads the table from other streams, which do not order after this one."""
    t = torch.from_numpy(arr).to(device)
    if t.device.type == "cuda":
        torch.cuda.synchronize(t.device)
    return t


def _pack_words(data: np.ndarray) -> np.ndarray:
    pad = (-data.size) % 4
    if pad:
        data = np.concatenate([data, np.zeros(pad, dtype=np.uint8)])
    return np.ascontiguousarray(data).view("<u4")
