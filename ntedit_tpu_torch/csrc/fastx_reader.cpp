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
// It scans decompressed blocks with memchr and returns record batches
// through a flat C interface (one concatenated sequence buffer and offset
// arrays), the shape the numpy side wants: per-record Python objects are
// what make a pure-Python reader slow.
//
// Build: g++ -O3 -shared -fPIC fastx_reader.cpp -lz (io/native.py builds it
// at first use).

#include <zlib.h>

#include <cstdint>
#include <cstring>
#include <string>
#include <vector>

namespace {

constexpr size_t kBlock = 1 << 20;

struct Reader {
  gzFile gz = nullptr;
  std::vector<uint8_t> buf;   // decoded pending bytes
  size_t pos = 0;             // consume cursor into buf
  size_t mark = 0;            // start of the record in progress (<= pos)
  bool eof = false;
  int fmt = 0;                // 0 unknown, '>' fasta, '@' fastq
  std::string err;

  bool fill() {
    if (eof) return pos < buf.size();
    if (mark > 0) {  // compact up to the record in progress, never past it
      buf.erase(buf.begin(), buf.begin() + static_cast<long>(mark));
      pos -= mark;
      mark = 0;
    }
    size_t old = buf.size();
    buf.resize(old + kBlock);
    int n = gzread(gz, buf.data() + old, kBlock);
    if (n < 0) {
      err = "gzread failed";
      eof = true;
      buf.resize(old);
      return false;
    }
    buf.resize(old + static_cast<size_t>(n));
    if (n == 0) eof = true;
    return buf.size() > pos;
  }

  // Return pointer/len of the next full line (without newline); nullptr if
  // no complete line is buffered and the file is exhausted.
  const uint8_t* line(size_t* len) {
    for (;;) {
      const uint8_t* base = buf.data() + pos;
      size_t avail = buf.size() - pos;
      const void* nl = memchr(base, '\n', avail);
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
        if (buf.size() == pos) return nullptr;
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
      while (pos < buf.size()) {
        uint8_t c = buf[pos];
        if (c == '\n' || c == '\r') {
          ++pos;
          continue;
        }
        return c;
      }
      if (eof) return -1;
      if (!fill() && pos >= buf.size()) return -1;
    }
  }
};

}  // namespace

extern "C" {

void* ntpu_fastx_open(const char* path) {
  gzFile gz = gzopen(path, "rb");
  if (gz == nullptr) return nullptr;
  gzbuffer(gz, kBlock);
  auto* r = new Reader();
  r->gz = gz;
  return r;
}

void ntpu_fastx_close(void* h) {
  auto* r = static_cast<Reader*>(h);
  if (r != nullptr) {
    if (r->gz != nullptr) gzclose(r->gz);
    delete r;
  }
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
