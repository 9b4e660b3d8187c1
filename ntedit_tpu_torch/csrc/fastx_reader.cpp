// Batch FASTA/FASTQ(.gz) reader of the torch port (io/native.py).
//
// A copy of the repository's native/fastx_reader.cpp (the reader the JAX
// package binds), with one fault repaired: that reader returns a full
// batch, or -2 for a record larger than the batch buffer, after it has
// already consumed the lines of the record it could not store, so the
// record is lost (a 20 MiB contig is read as no record at all).  Here the
// reader keeps a mark at the start of the record in progress: the decoded
// buffer is never compacted past it, and a record that does not fit
// rewinds to it, so the next call (with larger buffers after -2) reads it
// whole.  The 2-bit encoder of the original is not part of the copy.
//
// It scans decoded bytes with memchr and returns record batches through a
// flat C interface (one concatenated sequence buffer and offset arrays),
// the shape the numpy side wants: per-record Python objects are what make
// a pure-Python reader slow.
//
// Where the decoded bytes come from.  A regular file that starts with the
// gzip magic is mapped, and its members are decoded one at a time by
// inflate.h into the buffer behind the record in progress, where the line
// scanner reads them in place: a member whole where its output fits the cap
// the caller gives, else a stretch of whole deflate blocks of at most the
// cap at a time, the 32 KiB its matches may reach kept behind it.  From a
// member that inflate.h refuses (or whose next block alone passes the cap,
// or for which no buffer can be had) to the file's end, zlib's gzread reads
// on, the bytes of that member already handed out skipped.  Bytes after the
// last member that do not begin another are ignored, as gzread ignores
// them.  Any other file (not gzip, not mappable) is read by gzread, as
// before.  The buffer is mapped memory, never zero-filled by the reader,
// and one is kept for the next reader.
//
// Build: g++ -O3 -shared -fPIC fastx_reader.cpp -lz (io/native.py builds it
// at first use).

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>
#include <zlib.h>

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <mutex>
#include <string>

#include "inflate.h"

namespace {

constexpr size_t kBlock = 1 << 20;
constexpr size_t kWindow = 1 << 15;       // the farthest a deflate match reaches
constexpr size_t kKeep = size_t(1) << 28;  // a buffer that held more is not kept
constexpr size_t kMostRatio = 1032;        // deflate's largest expansion

// Decoded bytes: anonymous mapped memory, its pages touched only as bytes
// are written (huge pages where the kernel gives them).
struct Buffer {
  uint8_t* data = nullptr;
  size_t alloc = 0;
  size_t high = 0;  // the most bytes it held

  void release() {
    if (data != nullptr) munmap(data, alloc);
    data = nullptr;
    alloc = high = 0;
  }
  // Room for `need` bytes, the first `keep` kept.
  bool reserve(size_t need, size_t keep) {
    if (need <= alloc && data != nullptr) return true;
    const size_t n = std::max(need, std::max(alloc * 2, 4 * kBlock));
    void* m = mmap(nullptr, n, PROT_READ | PROT_WRITE, MAP_PRIVATE | MAP_ANONYMOUS | MAP_NORESERVE,
                   -1, 0);
    if (m == MAP_FAILED) return false;
    madvise(m, n, MADV_HUGEPAGE);
    if (keep > 0) memcpy(m, data, keep);
    const size_t h = high;
    release();
    data = static_cast<uint8_t*>(m);
    alloc = n;
    high = h;
    return true;
  }
  // Give back the pages past the first `used` bytes.
  void trim(size_t used) {
    const size_t page = static_cast<size_t>(sysconf(_SC_PAGESIZE));
    const size_t from = (used + page - 1) / page * page;
    if (from < alloc) madvise(data + from, alloc - from, MADV_DONTNEED);
  }
};

std::mutex g_spare_mu;
Buffer g_spare;  // one buffer kept for the next reader (its pages stay mapped)

struct Reader {
  gzFile gz = nullptr;            // gzread's file: not a mapped gzip file, or its rest
  int fd = -1;                    // the mapped file, for gzread to take over
  const uint8_t* map = nullptr;   // a gzip file, mapped
  size_t map_len = 0;
  size_t member = 0;              // where the next member starts in map
  ntpu_inflate::Member inf;       // the member being decoded, while `in_member`
  bool in_member = false;
  size_t cap = 0;                 // the most bytes decoded in one stretch
  uint64_t whole = 0, streamed = 0;  // decoded bytes by inflater
  Buffer b;                       // decoded pending bytes b.data[0..size)
  size_t size = 0;
  size_t pos = 0;                 // consume cursor
  size_t mark = 0;                // start of the record in progress (<= pos)
  bool eof = false;
  int fmt = 0;                    // 0 unknown, '>' fasta, '@' fastq
  std::string err;

  ~Reader() {
    if (gz != nullptr) gzclose(gz);
    if (fd >= 0) close(fd);
    unmap();
    std::lock_guard<std::mutex> lock(g_spare_mu);
    if (g_spare.data == nullptr && b.high <= kKeep) {
      g_spare = b;
      b = Buffer();
    }
    b.release();
  }

  void fail(const std::string& what) {
    err = what;
    eof = true;
  }

  void unmap() {
    if (map != nullptr) munmap(const_cast<uint8_t*>(map), map_len);
    map = nullptr;
  }

  void read_gz() {
    if (!b.reserve(size + kBlock, size)) return fail("out of memory");
    const int n = gzread(gz, b.data + size, kBlock);
    int code = Z_OK;
    const char* msg = n > 0 ? nullptr : gzerror(gz, &code);
    if (n < 0) return fail(std::string("gzread failed: ") + msg);
    if (n == 0) {  // a stream cut short ends gzread as the file's end does
      if (code == Z_BUF_ERROR) return fail("unexpected end of file");
      eof = true;
    }
    size += static_cast<size_t>(n);
    if (!gzdirect(gz)) streamed += static_cast<size_t>(n);
  }

  // gzread reads on from the member at `off`, its first `skip` decoded
  // bytes (handed out already) skipped.
  void to_gzread(size_t off, uint64_t skip) {
    b.trim(size);  // the pages a refused stretch wrote
    unmap();
    in_member = false;
    if (lseek(fd, static_cast<off_t>(off), SEEK_SET) < 0) return fail("lseek failed");
    gz = gzdopen(fd, "rb");
    if (gz == nullptr) return fail("gzdopen failed");
    fd = -1;  // gzclose closes it
    gzbuffer(gz, kBlock);
    if (skip > 0 && gzseek(gz, static_cast<z_off_t>(skip), SEEK_SET) < 0)
      return fail("gzseek failed");
  }

  // The next stretch of the member in progress, or the next member.
  // gzread's rule: another member begins only at the gzip magic, and other
  // bytes after one are ignored.
  void inflate_more() {
    const size_t rest = map_len - member;
    const uint8_t* m = map + member;
    size_t room = std::min(rest < SIZE_MAX / kMostRatio ? rest * kMostRatio : SIZE_MAX, cap);
    if (!in_member) {
      if (rest < 2 || m[0] != 0x1f || m[1] != 0x8b) {
        eof = true;
        return;
      }
      size_t bsize;  // a BGZF block's output is known from its ISIZE
      ntpu_inflate::gzip_header(m, rest, &bsize);
      if (bsize >= 18 && bsize <= rest)
        room = std::min<size_t>(room, ntpu_inflate::detail::le32(m + bsize - 4));
      if (!inf.begin(m, rest)) return to_gzread(member, 0);
      in_member = true;
    }
    if (!b.reserve(size + room, size)) return to_gzread(member, inf.total());
    size_t got;
    const ntpu_inflate::Status st = inf.next(b.data + size, room, size, &got);
    if (st == ntpu_inflate::kOk || st == ntpu_inflate::kMore) {
      size += got;
      whole += got;
    }
    if (st == ntpu_inflate::kOk) {
      member += inf.in_used();
      in_member = false;
    } else if (st != ntpu_inflate::kMore) {
      to_gzread(member, inf.total());
    }
  }

  bool fill() {
    if (eof) return pos < size;
    // compact up to the record in progress, never past it, nor into the
    // window of a member in progress
    const size_t drop = in_member ? std::min(mark, size > kWindow ? size - kWindow : 0) : mark;
    if (drop > 0) {
      memmove(b.data, b.data + drop, size - drop);
      size -= drop;
      pos -= drop;
      mark -= drop;
    }
    const size_t before = size;
    while (!eof && size == before) {  // an empty member gives nothing: go on
      if (gz != nullptr)
        read_gz();
      else
        inflate_more();
    }
    b.high = std::max(b.high, size);
    return size > pos;
  }

  // Return pointer/len of the next full line (without newline); nullptr if
  // no complete line is buffered and the file is exhausted.
  const uint8_t* line(size_t* len) {
    for (;;) {
      const uint8_t* base = b.data + pos;
      size_t avail = size - pos;
      const void* nl = avail > 0 ? memchr(base, '\n', avail) : nullptr;
      if (nl != nullptr) {
        size_t l = static_cast<size_t>(static_cast<const uint8_t*>(nl) - base);
        *len = (l > 0 && base[l - 1] == '\r') ? l - 1 : l;
        pos += l + 1;
        return base;
      }
      if (eof) {
        if (avail == 0) return nullptr;
        *len = avail;  // final unterminated line
        pos += avail;
        return base;
      }
      if (!fill()) {
        if (size == pos) return nullptr;
      }
    }
  }

  // A batch of n records is full: the record in progress is read again
  // by the next call.  -2 when not even one record fits.
  long rewind(long n) {
    pos = mark;
    return n > 0 ? n : -2;
  }

  // Peek the first non-empty byte.
  int peek() {
    for (;;) {
      while (pos < size) {
        uint8_t c = b.data[pos];
        if (c == '\n' || c == '\r') {
          ++pos;
          continue;
        }
        return c;
      }
      if (eof) return -1;
      if (!fill() && pos >= size) return -1;
    }
  }
};

}  // namespace

extern "C" {

// Open `path`; `cap` is the most bytes of a gzip member decoded in one
// stretch (0: gzread reads every member).
void* ntpu_fastx_open(const char* path, long cap) {
  int fd = open(path, O_RDONLY | O_CLOEXEC);
  if (fd < 0) return nullptr;
  auto* r = new Reader();
  r->cap = cap > 0 ? static_cast<size_t>(cap) : 0;
  {
    std::lock_guard<std::mutex> lock(g_spare_mu);
    std::swap(r->b, g_spare);
  }
  struct stat st;
  uint8_t magic[2];
  if (r->cap > 0 && fstat(fd, &st) == 0 && S_ISREG(st.st_mode) && st.st_size >= 2 &&
      pread(fd, magic, 2, 0) == 2 && magic[0] == 0x1f && magic[1] == 0x8b) {
    void* m = mmap(nullptr, static_cast<size_t>(st.st_size), PROT_READ, MAP_PRIVATE, fd, 0);
    if (m != MAP_FAILED) {
      madvise(m, static_cast<size_t>(st.st_size), MADV_SEQUENTIAL);
      r->fd = fd;
      r->map = static_cast<const uint8_t*>(m);
      r->map_len = static_cast<size_t>(st.st_size);
      return r;
    }
  }
  r->gz = gzdopen(fd, "rb");
  if (r->gz == nullptr) {
    close(fd);
    delete r;
    return nullptr;
  }
  gzbuffer(r->gz, kBlock);
  return r;
}

void ntpu_fastx_close(void* h) { delete static_cast<Reader*>(h); }

// The decoded bytes so far by inflater: out[0] inflate.h's, out[1]
// gzread's from gzip members (a file gzread copies counts in neither).
void ntpu_fastx_inflated(void* h, unsigned long long* out) {
  auto* r = static_cast<Reader*>(h);
  out[0] = r->whole;
  out[1] = r->streamed;
}

// Read up to max_rec records.  Sequence bytes are concatenated into
// seq_buf (capacity seq_cap) with seq_offs[0..n] boundaries; headers
// (name + ' ' + comment, kseq whitespace split preserved verbatim after
// the tag byte) go to hdr_buf/hdr_offs likewise; FASTQ qualities land in
// qual_buf at the same offsets as the sequence (equal lengths enforced).
// Returns the number of records delivered; 0 on EOF; -1 on malformed
// input; -2 if a single record exceeds the buffer capacity (caller
// retries with bigger buffers: the record is read again, whole).
// *is_fastq is set to 1 for FASTQ.
long ntpu_fastx_next(void* h, uint8_t* seq_buf, long seq_cap, long* seq_offs,
                     uint8_t* hdr_buf, long hdr_cap, long* hdr_offs,
                     uint8_t* qual_buf, int* is_fastq, long max_rec) {
  auto* r = static_cast<Reader*>(h);
  if (r->fmt == 0) {
    int c = r->peek();
    if (c < 0) return 0;
    if (c != '>' && c != '@') return -1;
    r->fmt = c;
  }
  *is_fastq = r->fmt == '@' ? 1 : 0;
  long n = 0;
  long sw = 0, hw = 0;  // write cursors
  seq_offs[0] = 0;
  hdr_offs[0] = 0;
  while (n < max_rec) {
    int c = r->peek();
    if (c < 0) break;
    r->mark = r->pos;  // a record that does not fit rewinds here
    size_t len = 0;
    const uint8_t* l = r->line(&len);
    if (l == nullptr) break;
    if (l[0] != r->fmt) return -1;
    if (hw + static_cast<long>(len) - 1 > hdr_cap) return r->rewind(n);
    memcpy(hdr_buf + hw, l + 1, len - 1);
    hw += static_cast<long>(len) - 1;

    long seq_start = sw;
    if (r->fmt == '>') {
      for (;;) {
        int nx = r->peek();
        if (nx < 0 || nx == '>') break;
        l = r->line(&len);
        if (l == nullptr) break;
        if (sw + static_cast<long>(len) > seq_cap) return r->rewind(n);
        memcpy(seq_buf + sw, l, len);
        sw += static_cast<long>(len);
      }
    } else {
      l = r->line(&len);  // sequence line (single-line FASTQ)
      if (l == nullptr) return -1;
      if (sw + static_cast<long>(len) > seq_cap) return r->rewind(n);
      memcpy(seq_buf + sw, l, len);
      sw += static_cast<long>(len);
      long seq_len = sw - seq_offs[n];
      l = r->line(&len);  // '+'
      if (l == nullptr || l[0] != '+') return -1;
      l = r->line(&len);  // quality
      if (l == nullptr || static_cast<long>(len) != seq_len) return -1;
      memcpy(qual_buf + seq_offs[n], l, len);
    }
    ++n;
    seq_offs[n] = sw;
    hdr_offs[n] = hw;
    (void)seq_start;
  }
  return n;
}

const char* ntpu_fastx_error(void* h) {
  auto* r = static_cast<Reader*>(h);
  return r->err.c_str();
}

}  // extern "C"
