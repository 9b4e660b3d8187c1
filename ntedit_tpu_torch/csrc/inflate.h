// gzip members (RFC 1952 over RFC 1951) inflated from memory into memory,
// for the batch reader (fastx_reader.cpp).
//
// zlib's inflate is a streaming state machine: it can stop after any bit
// and resume with more input or output, and that costs it a bounds check
// and a state dispatch on nearly every symbol.  Here the compressed file
// is in memory whole and the output goes to one buffer, a stretch of whole
// deflate blocks at a time, so the inner loop checks the two ends once per
// symbol, far from them (the "fast loop"), and only the last bytes before
// either end go through a loop that checks each step.  A block that does
// not fit the room left is decoded again from its start in the next
// stretch, behind the 32 KiB of output its matches may reach.  The fast
// loop refills a 64-bit bit buffer with one unaligned load and decodes a
// length and a distance from it without another refill; a table entry
// holds the code's length and its extra bits' count together, so one
// shift consumes both.  Matches are copied 16 bytes at a time.  A FASTQ
// file at gzip -1 is mostly matches (a read's bases are runs of 3-8 bytes
// seen earlier in the window): 18.6 M matches and 176 k literals in 150 MB.
//
// The decoder accepts what zlib's inflate accepts, or less: it checks the
// header's method, flags and CRC16, refuses over-subscribed and incomplete
// codes as zlib's inflate_table does (an incomplete set only for a single
// code of length 1), distances before the member's start, and a CRC32 or
// ISIZE that does not match.  The caller reads a member it refuses again
// with zlib, whose verdict then stands.

#pragma once

#include <zlib.h>

#include <cstddef>
#include <cstdlib>
#include <cstdint>
#include <cstring>
#include <initializer_list>

namespace ntpu_inflate {

// kOk: the member ended, its CRC32 and ISIZE checked; kMore: whole blocks
// decoded, the next does not fit; kNoRoom: not even the next block fits;
// kBadData: zlib might refuse it.
enum Status { kOk = 0, kBadData = 1, kNoRoom = 2, kMore = 3 };

namespace detail {

constexpr int kLitBits = 11;      // root bits of the literal/length table
constexpr int kDistBits = 8;      // root bits of the distance table
constexpr int kPreBits = 7;       // the code-length code: at most 7 bits
constexpr int kLitTable = 4096;   // root and subtables (zlib's `enough 288 11 15`: 2342)
constexpr int kDistTable = 1024;  // (`enough 32 8 15`: 402)

// A table entry (uint32):
//   bits 0-4    bits it consumes: the code's length, plus its extra bits
//   bit 5       a literal, the byte at bits 16-23
//   bit 6       not a symbol: a subtable (bit 7 clear), the end of the
//               block (bit 7 set), or no code (bits 7 and 13 set)
//   bits 8-12   the code's length, where its extra bits start; of a
//               subtable, its index bits
//   bits 16-31  the base of a length or a distance; a subtable's start
constexpr uint32_t kLit = 0x20;
constexpr uint32_t kExc = 0x40;
constexpr uint32_t kEnd = kExc | 0x80;
constexpr uint32_t kBad = kEnd | 0x2000;

constexpr uint16_t kLenBase[29] = {3,  4,  5,  6,  7,  8,  9,  10, 11,  13,  15,  17,  19,  23, 27,
                                   31, 35, 43, 51, 59, 67, 83, 99, 115, 131, 163, 195, 227, 258};
constexpr uint8_t kLenExtra[29] = {0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 2,
                                   2, 3, 3, 3, 3, 4, 4, 4, 4, 5, 5, 5, 5, 0};
constexpr uint16_t kDistBase[30] = {1,    2,    3,    4,    5,    7,    9,    13,    17,    25,
                                    33,   49,   65,   97,   129,  193,  257,  385,   513,   769,
                                    1025, 1537, 2049, 3073, 4097, 6145, 8193, 12289, 16385, 24577};
constexpr uint8_t kDistExtra[30] = {0, 0, 0, 0, 1, 1, 2, 2,  3,  3,  4,  4,  5,  5,  6,
                                    6, 7, 7, 8, 8, 9, 9, 10, 10, 11, 11, 12, 12, 13, 13};
constexpr uint8_t kPreOrder[19] = {16, 17, 18, 0, 8, 7, 9, 6, 10, 5, 11, 4, 12, 3, 13, 2, 14, 1, 15};

// A symbol's entry before its code is known: kind and base, and the
// extra bits' count in bits 0-4.
inline uint32_t lit_entry(unsigned sym) {
  if (sym < 256) return kLit | sym << 16;
  if (sym == 256) return kEnd;
  if (sym < 286) return kLenExtra[sym - 257] | uint32_t(kLenBase[sym - 257]) << 16;
  return kBad;  // 286 and 287: fixed codes that stand for nothing
}

inline uint32_t dist_entry(unsigned sym) {
  if (sym < 30) return kDistExtra[sym] | uint32_t(kDistBase[sym]) << 16;
  return kBad;
}

inline uint32_t pre_entry(unsigned sym) { return sym << 16; }

inline uint32_t with_code(uint32_t e, int len) {
  return (e & ~0x1Fu) | uint32_t(len) << 8 | ((e & 0x1F) + uint32_t(len));
}

inline unsigned reverse(unsigned code, int len) {
  unsigned r = 0;
  for (int i = 0; i < len; ++i, code >>= 1) r = r << 1 | (code & 1);
  return r;
}

// Fill `table` (root bits, then subtables, at most `size` entries) for
// the code lengths lens[0..n).  `codes` is zlib's CODES type, where an
// incomplete set is refused; elsewhere it is allowed only for a single code
// of length 1.  No lengths at all make a table that refuses every lookup,
// as zlib's does.
template <uint32_t (*Entry)(unsigned)>
bool build(uint32_t* table, int size, int root, const uint8_t* lens, int n, bool codes) {
  uint16_t count[16] = {0};
  for (int s = 0; s < n; ++s) count[lens[s]]++;
  count[0] = 0;
  int max = 15;
  while (max > 0 && count[max] == 0) --max;
  int left = 1;
  for (int len = 1; len <= 15; ++len) {
    left = (left << 1) - count[len];
    if (left < 0) return false;  // over-subscribed
  }
  if (left > 0 && max != 0 && (codes || max != 1)) return false;  // incomplete
  const int rsize = 1 << root;
  if (left > 0)  // incomplete or empty: what no code reaches is refused
    for (int i = 0; i < rsize; ++i) table[i] = kBad;
  uint16_t next[16];  // the next canonical code of each length
  unsigned code = 0;
  for (int len = 1; len <= 15; ++len) {
    code = (code + count[len - 1]) << 1;
    next[len] = static_cast<uint16_t>(code);
  }
  uint16_t sorted[288];  // the symbols in canonical order: by length, then symbol
  uint16_t offs[16];
  offs[1] = 0;
  for (int len = 1; len < 15; ++len) offs[len + 1] = offs[len] + count[len];
  for (int s = 0; s < n; ++s)
    if (lens[s]) sorted[offs[lens[s]]++] = static_cast<uint16_t>(s);
  const int total = offs[15];
  int free = rsize;
  unsigned sub_prefix = ~0u;  // the root bits of the current subtable
  int sub_start = 0, sub_bits = 0;
  for (int i = 0; i < total; ++i) {
    const unsigned s = sorted[i];
    const int len = lens[s];
    const unsigned c = next[len]++;
    if (len <= root) {
      const uint32_t e = with_code(Entry(s), len);
      for (unsigned idx = reverse(c, len); idx < unsigned(rsize); idx += 1u << len) table[idx] = e;
      continue;
    }
    const unsigned prefix = c >> (len - root);  // the code's first root bits
    if (prefix != sub_prefix) {  // a new subtable, sized by its longest code
      sub_prefix = prefix;
      unsigned nx[16];  // the codes that follow in `sorted` share the prefix
      for (int l = 1; l <= 15; ++l) nx[l] = next[l];
      nx[len]--;
      for (int j = i; j < total; ++j) {
        const int lj = lens[sorted[j]];
        if ((nx[lj]++ >> (lj - root)) != prefix) break;
        sub_bits = lj - root;
      }
      sub_start = free;
      free += 1 << sub_bits;
      if (free > size) return false;
      for (int j = 0; j < (1 << sub_bits); ++j) table[sub_start + j] = kBad;
      table[reverse(prefix, root)] =
          kExc | uint32_t(sub_bits) << 8 | uint32_t(sub_start) << 16 | uint32_t(root);
    }
    const int rest = len - root;
    const uint32_t e = with_code(Entry(s), rest);
    for (unsigned idx = reverse(c & ((1u << rest) - 1), rest); idx < (1u << sub_bits);
         idx += 1u << rest)
      table[sub_start + idx] = e;
  }
  return true;
}

struct Fixed {
  uint32_t lit[kLitTable];
  uint32_t dist[kDistTable];
  Fixed() {
    uint8_t lens[288];
    for (int s = 0; s < 288; ++s) lens[s] = s < 144 ? 8 : s < 256 ? 9 : s < 280 ? 7 : 8;
    build<lit_entry>(lit, kLitTable, kLitBits, lens, 288, false);
    for (int s = 0; s < 32; ++s) lens[s] = 5;
    build<dist_entry>(dist, kDistTable, kDistBits, lens, 32, false);
  }
};

inline const Fixed& fixed() {
  static const Fixed f;  // built once (a function's static: thread-safe)
  return f;
}

inline uint64_t load64(const uint8_t* p) {
  uint64_t v;
  memcpy(&v, p, 8);
  return v;  // little-endian hosts (x86-64, aarch64)
}

inline uint16_t le16(const uint8_t* p) { return static_cast<uint16_t>(p[0] | p[1] << 8); }
inline uint32_t le32(const uint8_t* p) {
  return uint32_t(p[0]) | uint32_t(p[1]) << 8 | uint32_t(p[2]) << 16 | uint32_t(p[3]) << 24;
}

// The extra bits of a length or distance entry `e` read from `saved`.
inline uint32_t extra(uint64_t saved, uint32_t e) {
  return static_cast<uint32_t>((saved & ((uint64_t(1) << (e & 31)) - 1)) >> ((e >> 8) & 31));
}

// The deflate stream of one member.
struct Inflater {
  const uint8_t* in = nullptr;
  const uint8_t* in_end = nullptr;
  uint8_t* out_begin = nullptr;  // the earliest byte a match may copy
  uint8_t* out = nullptr;
  uint8_t* out_end = nullptr;
  uint64_t bits = 0;  // `have` valid low bits; above them the next input
  unsigned have = 0;  // bits or zeros, never other bits
  size_t past = 0;    // zero bytes fed past the end of the input
  bool no_room = false;
  uint32_t lit[kLitTable];
  uint32_t dist[kDistTable];

  // 56 to 63 valid bits.  Past the input's end, zero bytes, counted.
  void refill() {
    if (in_end - in >= 8) {
      bits |= load64(in) << have;
      in += (63 - have) >> 3;
      have |= 56;
      return;
    }
    while (have < 56) {
      if (in < in_end)
        bits |= uint64_t(*in++) << have;
      else
        ++past;
      have += 8;
    }
  }
  uint32_t peek(int n) const { return static_cast<uint32_t>(bits & ((uint64_t(1) << n) - 1)); }
  void drop(unsigned n) {
    bits >>= n;
    have -= n;
  }
  uint32_t take(int n) {
    const uint32_t v = peek(n);
    drop(n);
    return v;
  }
  bool full() {
    no_room = true;
    return false;
  }
  // The input position of the next whole byte (the bit buffer's whole
  // bytes handed back), or false when the stream ran past the end.
  bool align() {
    drop(have & 7);
    if (past > have / 8) return false;
    in -= have / 8 - past;
    bits = 0;
    have = 0;
    past = 0;
    return true;
  }

  bool stored() {
    if (!align() || in_end - in < 4) return false;
    const uint32_t len = le16(in), nlen = le16(in + 2);
    in += 4;
    if ((len ^ 0xFFFF) != nlen || size_t(in_end - in) < len) return false;
    if (size_t(out_end - out) < len) return full();
    memcpy(out, in, len);
    in += len;
    out += len;
    return true;
  }

  bool dynamic() {
    refill();
    const int nlen = take(5) + 257, ndist = take(5) + 1, ncode = take(4) + 4;
    if (nlen > 286 || ndist > 30) return false;
    uint8_t lens[288 + 32] = {0};
    for (int i = 0; i < ncode; ++i) {
      if (have < 3) refill();
      lens[kPreOrder[i]] = static_cast<uint8_t>(take(3));
    }
    uint32_t pre[1 << kPreBits];
    if (!build<pre_entry>(pre, 1 << kPreBits, kPreBits, lens, 19, true)) return false;
    for (int i = 0; i < nlen + ndist;) {
      if (have < 14) refill();
      const uint32_t e = pre[peek(kPreBits)];
      if (e & kExc) return false;  // an empty code-length code
      drop(e & 31);
      const unsigned sym = e >> 16;
      if (sym < 16) {
        lens[i++] = static_cast<uint8_t>(sym);
        continue;
      }
      int rep;
      uint8_t val = 0;
      if (sym == 16) {
        if (i == 0) return false;
        val = lens[i - 1];
        rep = 3 + take(2);
      } else if (sym == 17) {
        rep = 3 + take(3);
      } else {
        rep = 11 + take(7);
      }
      if (i + rep > nlen + ndist) return false;
      memset(lens + i, val, rep);
      i += rep;
    }
    if (lens[256] == 0) return false;  // no end of block
    uint8_t dlens[30];
    memcpy(dlens, lens + nlen, ndist);
    memset(lens + nlen, 0, 288 - nlen);
    return build<lit_entry>(lit, kLitTable, kLitBits, lens, 288, false) &&
           build<dist_entry>(dist, kDistTable, kDistBits, dlens, ndist, false);
  }

  // One Huffman-coded block with tables `lt` and `dt`.
  bool block(const uint32_t* lt, const uint32_t* dt) {
    constexpr uint32_t kLitMask = (1u << kLitBits) - 1, kDistMask = (1u << kDistBits) - 1;
    // the fast loop's room: 8 input bytes for a refill; a match of 258
    // bytes and the 16-byte copy's overrun
    uint8_t* const out_fast = out_end - out > 300 ? out_end - 300 : out;
    while (in_end - in >= 16 && out < out_fast) {
      refill();  // 56 bits: a length and a distance with their extra bits take 48
      uint32_t e = lt[bits & kLitMask];
      if (e & kLit) {
        drop(e & 31);
        *out++ = static_cast<uint8_t>(e >> 16);
        e = lt[bits & kLitMask];
        if (e & kLit) {
          drop(e & 31);
          *out++ = static_cast<uint8_t>(e >> 16);
        }
        continue;
      }
      if (e & kExc) {
        if ((e & kEnd) == kEnd) {
          drop(e & 31);
          return (e & kBad) != kBad;
        }
        drop(kLitBits);
        e = lt[(e >> 16) + peek((e >> 8) & 31)];
        if (e & kLit) {
          drop(e & 31);
          *out++ = static_cast<uint8_t>(e >> 16);
          continue;
        }
        if (e & kExc) {
          drop(e & 31);
          return (e & kBad) != kBad;
        }
      }
      uint64_t saved = bits;
      drop(e & 31);
      const unsigned len = (e >> 16) + extra(saved, e);
      uint32_t d = dt[bits & kDistMask];
      if (d & kExc) {
        if ((d & kEnd) == kEnd) return false;
        drop(kDistBits);
        d = dt[(d >> 16) + peek((d >> 8) & 31)];
        if (d & kExc) return false;
      }
      saved = bits;
      drop(d & 31);
      const size_t dist = (d >> 16) + extra(saved, d);
      if (dist > size_t(out - out_begin)) return false;  // before the member's start
      uint8_t* dst = out;
      const uint8_t* src = out - dist;
      out += len;
      if (dist >= 16) {
        memcpy(dst, src, 16);
        memcpy(dst + 16, src + 16, 16);
        for (dst += 32, src += 32; dst < out; dst += 16, src += 16) memcpy(dst, src, 16);
      } else if (dist >= 8) {
        for (; dst < out; dst += 8, src += 8) memcpy(dst, src, 8);
      } else if (dist == 1) {
        const uint64_t v = 0x0101010101010101ull * src[0];
        for (; dst < out; dst += 8) memcpy(dst, &v, 8);
      } else {
        for (; dst < out; ++dst, ++src) *dst = *src;
      }
    }
    // near an end: every step checked
    for (;;) {
      if (past > 8) return false;  // long past the input's end
      refill();
      uint32_t e = lt[bits & kLitMask];
      if ((e & kEnd) == kExc) {  // a subtable
        drop(kLitBits);
        e = lt[(e >> 16) + peek((e >> 8) & 31)];
      }
      if (e & kLit) {
        if (out == out_end) return full();
        drop(e & 31);
        *out++ = static_cast<uint8_t>(e >> 16);
        continue;
      }
      if (e & kExc) {
        drop(e & 31);
        return (e & kBad) != kBad;
      }
      uint64_t saved = bits;
      drop(e & 31);
      const unsigned len = (e >> 16) + extra(saved, e);
      uint32_t d = dt[bits & kDistMask];
      if ((d & kEnd) == kExc) {
        drop(kDistBits);
        d = dt[(d >> 16) + peek((d >> 8) & 31)];
      }
      if (d & kExc) return false;
      saved = bits;
      drop(d & 31);
      const size_t dist = (d >> 16) + extra(saved, d);
      if (dist > size_t(out - out_begin)) return false;
      if (size_t(out_end - out) < len) return full();
      for (unsigned k = 0; k < len; ++k) out[k] = out[k - dist];
      out += len;
    }
  }

  // Whole blocks into out[..out_end): kOk at the last block's end, `in`
  // then at the byte after it; kNoRoom where the next block does not fit,
  // the state then that of its start.
  Status run() {
    for (;;) {
      const uint8_t* const in_at = in;  // the block's start
      uint8_t* const out_at = out;
      const uint64_t bits_at = bits;
      const unsigned have_at = have;
      const size_t past_at = past;
      refill();
      const uint32_t last = take(1), type = take(2);
      bool ok = false;
      if (type == 0)
        ok = stored();
      else if (type == 1)
        ok = block(fixed().lit, fixed().dist);
      else if (type == 2)
        ok = dynamic() && block(lit, dist);
      if (!ok && no_room) {
        in = in_at;
        out = out_at;
        bits = bits_at;
        have = have_at;
        past = past_at;
        no_room = false;
        return kNoRoom;
      }
      if (!ok || past > have / 8) return kBadData;
      if (last) return align() ? kOk : kBadData;
    }
  }
};

// CRC-32 (gzip's) of p[0..n), continuing `crc`.
inline uint32_t crc32_of(uint32_t crc, const uint8_t* p, size_t n) {
  while (n > 0) {  // zlib's crc32 takes 32-bit lengths
    const size_t step = n < (size_t(1) << 30) ? n : size_t(1) << 30;
    crc = static_cast<uint32_t>(::crc32(crc, p, static_cast<uInt>(step)));
    p += step;
    n -= step;
  }
  return crc;
}

}  // namespace detail

// The gzip header at p[0..n): its length, or 0 where zlib might refuse it
// (magic, method, reserved flags, cut short, a wrong CRC16).  *bsize: the
// member's whole length where its extra field holds BGZF's "BC" subfield,
// else 0.
inline size_t gzip_header(const uint8_t* p, size_t n, size_t* bsize) {
  *bsize = 0;
  if (n < 10 || p[0] != 0x1f || p[1] != 0x8b || p[2] != 8 || (p[3] & 0xE0)) return 0;
  const uint8_t flags = p[3];
  size_t h = 10;
  if (flags & 4) {  // FEXTRA: subfields of SI1 SI2 LEN data
    if (n < h + 2) return 0;
    const size_t xlen = detail::le16(p + h);
    h += 2;
    if (n < h + xlen) return 0;
    for (size_t s = h; s + 4 <= h + xlen;) {
      const size_t slen = detail::le16(p + s + 2);
      if (p[s] == 'B' && p[s + 1] == 'C' && slen == 2 && s + 6 <= h + xlen)
        *bsize = size_t(detail::le16(p + s + 4)) + 1;
      s += 4 + slen;
    }
    h += xlen;
  }
  for (const uint8_t f : {uint8_t(8), uint8_t(16)}) {  // FNAME, FCOMMENT: zero-terminated
    if (!(flags & f)) continue;
    const void* z = h < n ? memchr(p + h, 0, n - h) : nullptr;
    if (z == nullptr) return 0;
    h = static_cast<size_t>(static_cast<const uint8_t*>(z) - p) + 1;
  }
  if (flags & 2) {  // FHCRC
    if (n < h + 2 || (detail::crc32_of(0, p, h) & 0xFFFF) != detail::le16(p + h)) return 0;
    h += 2;
  }
  return h;
}

// One gzip member, inflated a stretch of whole blocks at a time.
class Member {
 public:
  // The member at the start of in[0..in_len): false where its header is
  // refused.
  bool begin(const uint8_t* in, size_t in_len) {
    size_t bsize;
    const size_t h = gzip_header(in, in_len, &bsize);
    if (h == 0) return false;
    start_ = in;
    inf_.in = in + h;
    inf_.in_end = in + in_len;
    inf_.bits = inf_.have = inf_.past = 0;
    crc_ = 0;
    total_ = 0;
    return true;
  }

  // The next stretch into out[0..room); out[-hist..0) holds the member's
  // output so far, or at least its last 32 KiB.  *got: the bytes decoded.
  Status next(uint8_t* out, size_t room, size_t hist, size_t* got) {
    inf_.out_begin = out - (hist < total_ ? hist : total_);
    inf_.out = out;
    inf_.out_end = out + room;
    const Status s = inf_.run();
    // the loops write nothing past the room: where they did, the buffer's
    // memory is no longer to be trusted
    if (inf_.out > inf_.out_end) std::abort();
    *got = static_cast<size_t>(inf_.out - out);
    if (s == kBadData || (s == kNoRoom && *got == 0)) return s;
    const uint32_t crc = detail::crc32_of(crc_, out, *got);
    const uint64_t total = total_ + *got;
    if (s == kOk) {
      const uint8_t* t = inf_.in;
      if (inf_.in_end - t < 8 || detail::le32(t) != crc ||
          detail::le32(t + 4) != static_cast<uint32_t>(total))
        return kBadData;
    }
    crc_ = crc;
    total_ = total;
    return s == kOk ? kOk : kMore;
  }

  // After kOk: the member's compressed bytes, trailer included.
  size_t in_used() const { return static_cast<size_t>(inf_.in + 8 - start_); }
  // The output handed out so far (kOk and kMore).
  uint64_t total() const { return total_; }

 private:
  detail::Inflater inf_;
  const uint8_t* start_ = nullptr;
  uint32_t crc_ = 0;
  uint64_t total_ = 0;
};

}  // namespace ntpu_inflate
