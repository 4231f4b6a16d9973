// kthost — native host runtime for kmertools_jax.
//
// Device-side analog of the reference's Rust host stack: the sequence
// reader (ktio/src/seq.rs), the batch assembly that feeds the device
// (the Arc<Mutex<Sequences>> work queue of composition/src/oligo.rs:192-226
// re-imagined as fixed-shape padded batches), and the fixed-width text
// emitters ({:.6} formatting, composition/src/oligo.rs:134).
//
// Exposed as a C ABI consumed via ctypes (no pybind11 in this image).
// Python owns nothing here: the batcher owns its bucket buffers and
// hands out pointers that stay valid until the next kt_batcher_next
// call on the same handle.
//
// Build: g++ -O3 -shared -fPIC kthost.cpp -o libkthost.so -lz

#include <fcntl.h>
#include <unistd.h>
#include <zlib.h>

#include <algorithm>
#include <atomic>
#include <cctype>
#include <charconv>
#include <condition_variable>
#include <deque>
#include <functional>
#include <mutex>
#include <utility>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <cstdlib>
#include <string>
#include <thread>
#include <vector>

namespace {

// ---------------------------------------------------------------------------
// Byte source: raw unbuffered read() for plain files (zlib's
// "transparent" mode costs an extra internal buffer + memcpy per byte,
// ~15% of the parse wall), gzread only when the magic bytes say gzip,
// gzdopen for stdin (not seekable; transparent mode handles both).
// ---------------------------------------------------------------------------
struct ByteSource {
  gzFile gz = nullptr;
  int fd = -1;
  char pre[2];  // magic bytes already consumed from a plain file
  int pre_n = 0, pre_pos = 0;
  int64_t limit = -1;  // bytes remaining of a [start, end) range; -1 = all
  ~ByteSource() {
    if (gz) gzclose(gz);
    else if (fd >= 0) close(fd);
  }
  long read(char *buf, size_t n) {
    if (gz) return gzread(gz, buf, (unsigned)n);
    if (limit >= 0 && (int64_t)n > limit) n = (size_t)limit;
    if (n == 0) return 0;
    size_t off = 0;
    while (pre_pos < pre_n && off < n) buf[off++] = pre[pre_pos++];
    if (off < n) {
      ssize_t r = ::read(fd, buf + off, n - off);
      if (r < 0) return off ? (long)off : -1;
      off += (size_t)r;
    }
    if (limit >= 0) limit -= (int64_t)off;
    return (long)off;
  }
};

// [start, end) byte-range source over a PLAIN file (multi-host shards:
// boundaries are record starts by construction, parallel/dataflow.py
// split_file — gzip is never byte-splittable, so no magic sniff here).
ByteSource *open_source_range(const char *path, int64_t start, int64_t end) {
  ByteSource *s = new ByteSource();
  int fd = open(path, O_RDONLY);
  if (fd < 0) { delete s; return nullptr; }
  if (start > 0 && lseek(fd, start, SEEK_SET) < 0) {
    close(fd); delete s; return nullptr;
  }
  s->fd = fd;
  s->limit = end > start ? end - start : 0;
  return s;
}

ByteSource *open_source(const char *path) {
  ByteSource *s = new ByteSource();
  if (strcmp(path, "-") == 0) {
    s->gz = gzdopen(0, "rb");  // stdin
    if (!s->gz) { delete s; return nullptr; }
    return s;
  }
  int fd = open(path, O_RDONLY);
  if (fd < 0) { delete s; return nullptr; }
  if (lseek(fd, 0, SEEK_CUR) < 0) {
    // not seekable (FIFO / process substitution): magic bytes can't be
    // un-read and gzopen(path) would block on a second writer — hand
    // the fd to zlib's transparent reader, which handles both gzip and
    // plain bytes (the pre-round-3 behavior for every input)
    s->gz = gzdopen(fd, "rb");
    if (!s->gz) { close(fd); delete s; return nullptr; }
    return s;
  }
  ssize_t m = ::read(fd, s->pre, 2);
  if (m == 2 && s->pre[0] == 0x1f && (unsigned char)s->pre[1] == 0x8b) {
    close(fd);
    s->gz = gzopen(path, "rb");
    if (!s->gz) { delete s; return nullptr; }
    return s;
  }
  s->fd = fd;
  s->pre_n = m > 0 ? (int)m : 0;
  return s;
}

// ---------------------------------------------------------------------------
// Buffered line reader over a ByteSource. Lines come out as zero-copy
// views into the read buffer (the overwhelmingly common case); a line
// spanning a buffer refill is assembled in spill storage and the view
// points there. A view stays valid until the next next_line_v call.
// ---------------------------------------------------------------------------
struct LineView {
  const char *p = nullptr;
  size_t n = 0;
};

class LineReader {
 public:
  explicit LineReader(ByteSource *f)
      : f_(f), buf_(1 << 20), pos_(0), end_(0), eof_(false) {}
  ~LineReader() { delete f_; }

  // Next line (without \n / \r\n) as a view. Returns false at EOF with
  // no bytes read.
  bool next_line_v(LineView &v) {
    if (pos_ >= end_ && !refill()) return false;
    const char *base = buf_.data() + pos_;
    size_t avail = end_ - pos_;
    const char *nl = (const char *)memchr(base, '\n', avail);
    if (nl) {
      size_t n = (size_t)(nl - base);
      pos_ += n + 1;
      if (n && base[n - 1] == '\r') n--;
      v.p = base;
      v.n = n;
      return true;
    }
    // line spans the buffer end: assemble in spill storage
    spill_.assign(base, avail);
    pos_ = end_;
    for (;;) {
      if (!refill()) break;
      const char *b2 = buf_.data();
      const char *nl2 = (const char *)memchr(b2, '\n', end_);
      if (nl2) {
        size_t n = (size_t)(nl2 - b2);
        spill_.append(b2, n);
        pos_ = n + 1;
        break;
      }
      spill_.append(b2, end_);
      pos_ = end_;
    }
    if (!spill_.empty() && spill_.back() == '\r') spill_.pop_back();
    v.p = spill_.data();
    v.n = spill_.size();
    return true;
  }

 private:
  bool refill() {
    if (eof_) return false;
    long n = f_->read(buf_.data(), buf_.size());
    if (n <= 0) {
      eof_ = true;
      return false;
    }
    pos_ = 0;
    end_ = (size_t)n;
    return true;
  }

  ByteSource *f_;
  std::vector<char> buf_;
  std::string spill_;
  size_t pos_, end_;
  bool eof_;
};

// Base LUT: A/a=0 C/c=1 G/g=2 T/t/U/u=3, else 4 (kmer/src/kmer.rs:6-15).
struct Nt4 {
  uint8_t t[256];
  Nt4() {
    memset(t, 4, sizeof(t));
    t[(int)'A'] = t[(int)'a'] = 0;
    t[(int)'C'] = t[(int)'c'] = 1;
    t[(int)'G'] = t[(int)'g'] = 2;
    t[(int)'T'] = t[(int)'t'] = 3;
    t[(int)'U'] = t[(int)'u'] = 3;
  }
};
const Nt4 NT4;

// ASCII -> 2-bit codes (4 = ambiguous). AVX2 path: the 10 valid bytes
// (ACGTU, both cases) have distinct LOW NIBBLES (A=1 C=3 T=4 U=5 G=7),
// so two pshufb lookups give (candidate code, expected uppercase char)
// and one case-folded compare validates — any other byte falls to 4,
// byte-identical to the scalar LUT for all 256 inputs (pinned by
// tests/test_native_batcher.py). ~10x the scalar LUT (which measured
// 2.4 GB/s single-thread; the branch-free arithmetic form g++ fails to
// vectorise was 3x slower still).
#ifdef __AVX2__
#include <immintrin.h>
inline void translate(const char *src, uint8_t *dst, size_t n) {
  const __m256i lo_mask = _mm256_set1_epi8(0x0F);
  // low nibble -> code (4 = ambiguous)
  const __m256i codetab = _mm256_setr_epi8(
      4, 0, 4, 1, 3, 3, 4, 2, 4, 4, 4, 4, 4, 4, 4, 4,
      4, 0, 4, 1, 3, 3, 4, 2, 4, 4, 4, 4, 4, 4, 4, 4);
  // low nibble -> the (unique) uppercase ASCII char that maps there
  const __m256i exptab = _mm256_setr_epi8(
      0, 'A', 0, 'C', 'T', 'U', 0, 'G', 0, 0, 0, 0, 0, 0, 0, 0,
      0, 'A', 0, 'C', 'T', 'U', 0, 'G', 0, 0, 0, 0, 0, 0, 0, 0);
  const __m256i fold = _mm256_set1_epi8((char)0xDF);  // clears the case bit
  const __m256i four = _mm256_set1_epi8(4);
  size_t i = 0;
  for (; i + 32 <= n; i += 32) {
    __m256i c = _mm256_loadu_si256((const __m256i *)(src + i));
    __m256i lo = _mm256_and_si256(c, lo_mask);
    __m256i code = _mm256_shuffle_epi8(codetab, lo);
    __m256i exp = _mm256_shuffle_epi8(exptab, lo);
    __m256i ok = _mm256_cmpeq_epi8(_mm256_and_si256(c, fold), exp);
    _mm256_storeu_si256((__m256i *)(dst + i),
                        _mm256_blendv_epi8(four, code, ok));
  }
  for (; i < n; i++) dst[i] = NT4.t[(uint8_t)src[i]];
}
#else
inline void translate(const char *src, uint8_t *dst, size_t n) {
  for (size_t i = 0; i < n; i++) dst[i] = NT4.t[(uint8_t)src[i]];
}
#endif



// ---------------------------------------------------------------------------
// FASTX record parser (ktio/src/seq.rs:100-131 semantics).
// ---------------------------------------------------------------------------
struct Record {
  std::string id;           // first whitespace token of the header
  std::vector<uint8_t> codes;  // 2-bit codes, 4 = ambiguous
};

// Two-phase stepper so callers can translate the (overwhelmingly
// common) single seq line straight from the read buffer into its final
// destination, skipping every intermediate copy:
//   begin()        -> rec.id set, first seq line returned as a view
//   then, fasta:  fasta_done() true = record ended at that line;
//                 else fasta_rest() appends the remaining lines
//        fastq:  fastq_finish() consumes '+' + quality; false =
//                 truncated record (dropped, seq.rs:100-131 semantics)
class FastxParser {
 public:
  // fmt_hint: 0 = sniff from the first line ('>' = FASTA), 1 = FASTA,
  // 2 = FASTQ. The hint carries the reference's extension-based
  // detection (ktio/src/seq.rs:30-41) — content sniffing alone
  // misreads a FASTA file with junk pre-header lines.
  explicit FastxParser(ByteSource *f, int fmt_hint = 0)
      : rd_(f),
        fmt_(fmt_hint == 1 ? FMT_FASTA
                           : (fmt_hint == 2 ? FMT_FASTQ : FMT_UNKNOWN)),
        have_line_(false) {}

  bool is_fasta() const { return fmt_ == FMT_FASTA; }

  // false = EOF (no further record). The view stays valid until the
  // next parser call; callers consume (translate) it before probing.
  bool begin(Record &rec, LineView &sv) {
    if (fmt_ == FMT_UNKNOWN) {
      if (!peek_line()) return false;
      fmt_ = (cur_.n > 0 && cur_.p[0] == '>') ? FMT_FASTA : FMT_FASTQ;
    }
    if (fmt_ == FMT_FASTA) {
      // skip junk pre-header lines; consume the header
      for (;;) {
        if (!get_line()) return false;
        if (cur_.n > 0 && cur_.p[0] == '>') break;
      }
      set_id(rec, cur_, 1);
      if (!get_line()) {  // header at EOF: empty record
        sv.p = nullptr;
        sv.n = 0;
        return true;
      }
      if (cur_.n > 0 && cur_.p[0] == '>') {  // empty record; keep header
        have_line_ = true;
        sv.p = nullptr;
        sv.n = 0;
        return true;
      }
      sv = cur_;
      return true;
    }
    for (;;) {
      if (!get_line()) return false;
      if (cur_.n > 0) break;  // skip blank lines (fastx.py:117-118)
    }
    set_id(rec, cur_, 1);
    if (!get_line()) return false;  // EOF mid-record: drop
    sv = cur_;
    return true;
  }

  // FASTA: true when the record ended at the line begin() returned
  // (next line is a header, or EOF). The peeked line is retained.
  bool fasta_done() {
    if (!peek_line()) return true;
    return cur_.n > 0 && cur_.p[0] == '>';
  }

  // FASTA: consume the remaining seq lines of the current record,
  // translating into *codes and/or counting into *bases.
  void fasta_rest(std::vector<uint8_t> *codes, int64_t *bases = nullptr) {
    for (;;) {
      if (!peek_line()) return;
      if (cur_.n > 0 && cur_.p[0] == '>') return;  // leave peeked
      get_line();
      if (codes) {
        size_t base = codes->size();
        codes->resize(base + cur_.n);
        translate(cur_.p, codes->data() + base, cur_.n);
      }
      if (bases) *bases += (int64_t)cur_.n;
    }
  }

  bool fastq_finish() { return get_line() && get_line(); }

  // Whole-record convenience (compat path).
  bool next(Record &rec) {
    LineView sv;
    if (!begin(rec, sv)) return false;
    rec.codes.resize(sv.n);
    translate(sv.p, rec.codes.data(), sv.n);
    if (fmt_ == FMT_FASTA) {
      if (!fasta_done()) fasta_rest(&rec.codes);
      return true;
    }
    return fastq_finish();
  }

  // Stats step: record length without any translation (the seq_stats
  // pre-pass reads the whole file just to count, ktio/src/seq.rs:69-94).
  bool stat_next(int64_t &len) {
    LineView sv;
    if (!begin(scratch_, sv)) return false;
    len = (int64_t)sv.n;
    if (fmt_ == FMT_FASTA) {
      if (!fasta_done()) fasta_rest(nullptr, &len);
      return true;
    }
    return fastq_finish();
  }

 private:
  enum Fmt { FMT_UNKNOWN, FMT_FASTA, FMT_FASTQ };

  bool peek_line() {
    if (have_line_) return true;
    have_line_ = rd_.next_line_v(cur_);
    return have_line_;
  }
  bool get_line() {
    if (have_line_) {
      have_line_ = false;
      return true;
    }
    return rd_.next_line_v(cur_);
  }

  static void set_id(Record &rec, const LineView &h, size_t skip) {
    size_t s = skip < h.n ? skip : h.n, e = s;
    while (e < h.n && !isspace((unsigned char)h.p[e])) e++;
    rec.id.assign(h.p + s, e - s);
  }

  LineReader rd_;
  Fmt fmt_;
  bool have_line_;
  LineView cur_;
  Record scratch_;
};

// ---------------------------------------------------------------------------
// Bucketed batcher (io/batch.py:87-167 semantics, native).
// ---------------------------------------------------------------------------
struct Bucket {
  int64_t width = 0, rows = 0, fill = 0;
  std::vector<uint8_t> codes;     // rows*width, pad = 4
  std::vector<int32_t> lengths;   // rows
  std::vector<int64_t> read_idx;  // rows, -1 = padding row
  std::vector<int64_t> row_start; // rows
  std::vector<uint8_t> last_row;  // rows (bool)
  // ids for reads whose FIRST row landed in this bucket
  std::vector<char> ids_blob;     // NUL-separated id strings
  std::vector<int64_t> id_ridx;   // read index per id
  std::vector<int64_t> id_rlen;   // full read length per id

  void init(int64_t w, int64_t r) {
    width = w;
    rows = r;
    codes.assign((size_t)(w * r), 4);
    lengths.assign((size_t)r, 0);
    read_idx.assign((size_t)r, -1);
    row_start.assign((size_t)r, 0);
    last_row.assign((size_t)r, 0);
    fill = 0;
  }
  void reset() {
    memset(codes.data(), 4, codes.size());
    memset(lengths.data(), 0, lengths.size() * sizeof(int32_t));
    for (auto &v : read_idx) v = -1;
    memset(row_start.data(), 0, row_start.size() * sizeof(int64_t));
    memset(last_row.data(), 0, last_row.size());
    ids_blob.clear();
    id_ridx.clear();
    id_rlen.clear();
    fill = 0;
  }
};

struct Batcher {
  FastxParser parser;
  std::vector<Bucket> buckets;  // sorted by width asc
  int64_t overlap = 0;
  int64_t next_ridx = 0;
  int last_emitted = -1;  // bucket index handed to Python last call
  int flush_cursor = 0;   // EOF flush progress
  bool parser_done = false;
  Record scratch_;  // reusable record for the slow (materialised) paths
  // mid-record resume state for split long reads
  Record pending;
  int64_t pending_pos = 0;
  bool pending_active = false;
  int64_t pending_ridx = 0;
  bool pending_first = false;

  explicit Batcher(ByteSource *f, int fmt_hint = 0) : parser(f, fmt_hint) {}

  Bucket &maxb() { return buckets.back(); }

  // Commits row b.fill of bucket bi whose codes are ALREADY in place
  // (translated straight into the row buffer by the zero-copy path).
  // Returns bucket index if it filled, else -1.
  int commit_row(int bi, int64_t n, int64_t ridx, int64_t start, bool last,
                 const std::string *id, int64_t rlen) {
    Bucket &b = buckets[(size_t)bi];
    int64_t i = b.fill;
    b.lengths[(size_t)i] = (int32_t)n;
    b.read_idx[(size_t)i] = ridx;
    b.row_start[(size_t)i] = start;
    b.last_row[(size_t)i] = last ? 1 : 0;
    if (id) {
      b.ids_blob.insert(b.ids_blob.end(), id->begin(), id->end());
      b.ids_blob.push_back('\0');
      b.id_ridx.push_back(ridx);
      b.id_rlen.push_back(rlen);
    }
    b.fill++;
    return b.fill == b.rows ? bi : -1;
  }

  // Places one row from materialised codes.
  int put_row(int bi, const uint8_t *chunk, int64_t n, int64_t ridx,
              int64_t start, bool last, const std::string *id, int64_t rlen) {
    Bucket &b = buckets[(size_t)bi];
    memcpy(b.codes.data() + (size_t)(b.fill * b.width), chunk, (size_t)n);
    return commit_row(bi, n, ridx, start, last, id, rlen);
  }

  // Advances the pending split read; returns filled bucket index or -1
  // when the record is fully consumed.
  int advance_pending() {
    int bi = (int)buckets.size() - 1;
    int64_t max_w = buckets[(size_t)bi].width;
    int64_t stride = max_w - overlap;
    int64_t L = (int64_t)pending.codes.size();
    while (pending_active) {
      int64_t start = pending_pos;
      int64_t end = start + max_w < L ? start + max_w : L;
      bool last = end >= L;
      const std::string *id = pending_first ? &pending.id : nullptr;
      pending_first = false;
      if (last) {
        pending_active = false;
      } else {
        pending_pos = start + stride;
      }
      int filled = put_row(bi, pending.codes.data() + start, end - start,
                           pending_ridx, start, last, id, L);
      if (filled >= 0) return filled;
    }
    return -1;
  }

  // Places a fully-materialised record (multi-line / long-read paths).
  int place_record(Record &rec) {
    int64_t L = (int64_t)rec.codes.size();
    int64_t ridx = next_ridx++;
    if (L <= maxb().width) {
      int bi = 0;
      while (buckets[(size_t)bi].width < L) bi++;
      return put_row(bi, rec.codes.data(), L, ridx, 0, true, &rec.id, L);
    }
    pending.id = rec.id;
    pending.codes.swap(rec.codes);
    pending_pos = 0;
    pending_active = true;
    pending_ridx = ridx;
    pending_first = true;
    return advance_pending();
  }

  // Parses and places records until a bucket fills (returns its index),
  // or EOF (returns -1). Fast path: a record whose sequence is a single
  // line (the normal FASTA/FASTQ shape) translates ASCII->codes straight
  // from the reader's buffer into its bucket row — no intermediate
  // Record, no string copies. Multi-line FASTA reclaims the translated
  // prefix and finishes via the record path.
  int pump() {
    if (pending_active) {
      int r = advance_pending();
      if (r >= 0) return r;
    }
    while (!parser_done) {
      LineView sv;
      if (!parser.begin(scratch_, sv)) {
        parser_done = true;
        break;
      }
      int64_t L = (int64_t)sv.n;
      if (L <= maxb().width) {
        int bi = 0;
        while (buckets[(size_t)bi].width < L) bi++;
        Bucket &b = buckets[(size_t)bi];
        uint8_t *row = b.codes.data() + (size_t)(b.fill * b.width);
        translate(sv.p, row, (size_t)L);
        if (parser.is_fasta()) {
          if (!parser.fasta_done()) {
            // multi-line record: reclaim the translated prefix, restore
            // the row's padding, finish via the record path
            scratch_.codes.assign(row, row + L);
            memset(row, 4, (size_t)L);
            parser.fasta_rest(&scratch_.codes);
            int r = place_record(scratch_);
            if (r >= 0) return r;
            continue;
          }
        } else if (!parser.fastq_finish()) {
          // truncated fastq record: dropped (seq.rs:100-131 semantics)
          memset(row, 4, (size_t)L);
          parser_done = true;
          break;
        }
        int filled =
            commit_row(bi, L, next_ridx++, 0, true, &scratch_.id, L);
        if (filled >= 0) return filled;
      } else {
        // long single-line record: one translate, then row splitting
        scratch_.codes.resize((size_t)L);
        translate(sv.p, scratch_.codes.data(), (size_t)L);
        if (parser.is_fasta()) {
          if (!parser.fasta_done()) parser.fasta_rest(&scratch_.codes);
        } else if (!parser.fastq_finish()) {
          parser_done = true;
          break;
        }
        int r = place_record(scratch_);
        if (r >= 0) return r;
      }
    }
    return -1;
  }

  // Returns next ready bucket index, or -1 when fully drained.
  int next() {
    if (last_emitted >= 0) {
      buckets[(size_t)last_emitted].reset();
      last_emitted = -1;
    }
    if (!parser_done) {
      int r = pump();
      if (r >= 0) {
        last_emitted = r;
        return r;
      }
    }
    // EOF: flush partial buckets in width order (io/batch.py:163-167)
    while (flush_cursor < (int)buckets.size()) {
      int bi = flush_cursor++;
      if (buckets[(size_t)bi].fill > 0) {
        last_emitted = bi;
        return bi;
      }
    }
    return -1;
  }
};

// Parse-ahead wrapper. A dedicated thread runs the sequential Batcher
// and hands completed buckets through a bounded queue, so the Python
// producer packs/uploads bucket N while bucket N+1 parses — the two
// stages of the producer overlap instead of alternating. Completed
// buckets are swapped out whole (vector moves, no copies) and their
// buffers recycle through a per-width-class spare pool; the yielded
// bucket stays valid until the next kt_batcher_next call, exactly the
// sequential contract.
struct ThreadedBatcher {
  Batcher inner;  // touched only by the parse thread after start()
  std::thread th;
  std::mutex mu;
  std::condition_variable cv_ready, cv_free;
  std::deque<std::pair<int, Bucket>> ready;  // (width class, bucket)
  std::vector<std::vector<Bucket>> spare;    // recycled, per class
  std::pair<int, Bucket> out;                // yielded to the consumer
  bool out_valid = false;
  bool done = false, quit = false;

  ThreadedBatcher(ByteSource *f, int fmt_hint) : inner(f, fmt_hint) {}

  void start() {
    spare.resize(inner.buckets.size());
    th = std::thread([this] { run(); });
  }

  void run() {
    for (;;) {
      const int bi = inner.next();
      if (bi < 0) break;
      Bucket filled;
      {
        std::unique_lock<std::mutex> lk(mu);
        cv_free.wait(lk, [&] { return ready.size() < 2 || quit; });
        if (quit) return;
        auto &pool = spare[(size_t)bi];
        if (!pool.empty()) {
          filled = std::move(pool.back());
          pool.pop_back();
        }
      }
      Bucket &src = inner.buckets[(size_t)bi];
      if (filled.width != src.width || filled.rows != src.rows)
        filled.init(src.width, src.rows);
      // src takes the (dirty) recycled buffers; inner.next() resets
      // them at the start of its next call (last_emitted == bi)
      std::swap(filled, src);
      {
        std::lock_guard<std::mutex> lk(mu);
        ready.emplace_back(bi, std::move(filled));
      }
      cv_ready.notify_one();
    }
    {
      std::lock_guard<std::mutex> lk(mu);
      done = true;
    }
    cv_ready.notify_one();
  }

  int next() {
    std::unique_lock<std::mutex> lk(mu);
    if (out_valid) {
      spare[(size_t)out.first].push_back(std::move(out.second));
      out_valid = false;
      cv_free.notify_one();
    }
    cv_ready.wait(lk, [&] { return !ready.empty() || done; });
    if (ready.empty()) return -1;
    out = std::move(ready.front());
    ready.pop_front();
    out_valid = true;
    return out.first;
  }

  Bucket &current() { return out.second; }

  ~ThreadedBatcher() {
    {
      std::lock_guard<std::mutex> lk(mu);
      quit = true;
    }
    cv_free.notify_one();
    if (th.joinable()) th.join();
  }
};

}  // namespace

// ---------------------------------------------------------------------------
// C ABI
// ---------------------------------------------------------------------------
extern "C" {

// ABI version probe: bound by the ctypes loader so a stale wheel-shipped
// .so (missing the symbol, or older signatures) is rejected instead of
// called with a mismatched argument list.
int kt_abi_version(void) { return 7; }

// fmt_hint: 0 = sniff from the first line, 1 = FASTA, 2 = FASTQ
// (extension-based detection lives in Python, ktio/src/seq.rs:30-41).
static void *batcher_from_source(ByteSource *f, int64_t overlap,
                                 const int64_t *widths, int n_widths,
                                 int64_t target_codes, int fmt_hint) {
  ThreadedBatcher *b = new ThreadedBatcher(f, fmt_hint);
  b->inner.overlap = overlap;
  b->inner.buckets.resize((size_t)n_widths);
  for (int i = 0; i < n_widths; i++) {
    int64_t w = widths[i];
    // multiple of 8 so the mesh DP path (workloads/common.py:
    // data_parallel_rows) can row-shard every full bucket
    int64_t rows = (target_codes / w) & ~int64_t(7);
    if (rows < 8) rows = 8;
    b->inner.buckets[(size_t)i].init(w, rows);
  }
  b->start();
  return b;
}

void *kt_batcher_open(const char *path, int64_t overlap,
                      const int64_t *widths, int n_widths,
                      int64_t target_codes, int fmt_hint) {
  ByteSource *f = open_source(path);
  if (!f) return nullptr;
  return batcher_from_source(f, overlap, widths, n_widths, target_codes,
                             fmt_hint);
}

// Byte-range variant for multi-host shards (plain files only; read
// numbering is range-local, matching parallel/dataflow.shard_sequences).
void *kt_batcher_open_range(const char *path, int64_t overlap,
                            const int64_t *widths, int n_widths,
                            int64_t target_codes, int fmt_hint,
                            int64_t start, int64_t end) {
  ByteSource *f = open_source_range(path, start, end);
  if (!f) return nullptr;
  return batcher_from_source(f, overlap, widths, n_widths, target_codes,
                             fmt_hint);
}

void kt_batcher_close(void *h) { delete (ThreadedBatcher *)h; }

// Returns the bucket index of the next ready batch, or -1 when done.
// The yielded bucket (read via kt_bucket_shape/kt_bucket_data, which
// ignore their index argument) stays valid until the next call.
int kt_batcher_next(void *h) { return ((ThreadedBatcher *)h)->next(); }

void kt_bucket_shape(void *h, int bi, int64_t *rows, int64_t *width,
                     int64_t *fill) {
  (void)bi;  // the yielded bucket is the handle's current() slot
  Bucket &b = ((ThreadedBatcher *)h)->current();
  *rows = b.rows;
  *width = b.width;
  *fill = b.fill;
}

void kt_bucket_data(void *h, int bi, uint8_t **codes, int32_t **lengths,
                    int64_t **read_idx, int64_t **row_start,
                    uint8_t **last_row, char **ids_blob, int64_t *ids_blob_len,
                    int64_t **id_ridx, int64_t **id_rlen, int64_t *n_ids) {
  (void)bi;
  Bucket &b = ((ThreadedBatcher *)h)->current();
  *codes = b.codes.data();
  *lengths = b.lengths.data();
  *read_idx = b.read_idx.data();
  *row_start = b.row_start.data();
  *last_row = b.last_row.data();
  *ids_blob = b.ids_blob.data();
  *ids_blob_len = (int64_t)b.ids_blob.size();
  *id_ridx = b.id_ridx.data();
  *id_rlen = b.id_rlen.data();
  *n_ids = (int64_t)b.id_ridx.size();
}

// seq_stats pre-pass (ktio/src/seq.rs:69-94). Returns 0 on success.
int kt_seq_stats(const char *path, int64_t *n_reads, int64_t *n_bases,
                 int fmt_hint) {
  ByteSource *f = open_source(path);
  if (!f) return 1;
  FastxParser p(f, fmt_hint);
  int64_t reads = 0, bases = 0, len = 0;
  while (p.stat_next(len)) {
    reads++;
    bases += len;
  }
  *n_reads = reads;
  *n_bases = bases;
  return 0;
}

// ---------------------------------------------------------------------------
// {:.6} fixed formatter (composition/src/oligo.rs:134). Values must lie in
// [0, 1] so every cell is exactly 8 chars ("d.dddddd"). Returns bytes
// written, or -1 if any value formatted to a different width (caller
// falls back to the Python path).
// ---------------------------------------------------------------------------
int64_t kt_format_fixed6(const double *vals, int64_t nrows, int64_t ncols,
                         char delim, char *out) {
  // open-address cache keyed on the f64 bit pattern: batches have few
  // distinct count/total ratios, so snprintf runs ~once per unique value
  enum { CACHE = 1 << 12 };
  static thread_local uint64_t keys[CACHE];
  static thread_local char reps[CACHE][8];
  static thread_local bool used[CACHE];
  memset(used, 0, sizeof(used));
  int64_t cache_fill = 0;

  char *p = out;
  for (int64_t r = 0; r < nrows; r++) {
    for (int64_t c = 0; c < ncols; c++) {
      double v = vals[r * ncols + c];
      uint64_t bits;
      memcpy(&bits, &v, 8);
      uint64_t slot = (bits * 0x9E3779B97F4A7C15ull) >> 52;  // 12-bit hash
      while (used[slot] && keys[slot] != bits) slot = (slot + 1) & (CACHE - 1);
      if (!used[slot]) {
        char tmp[32];
        int n = snprintf(tmp, sizeof(tmp), "%.6f", v);
        if (n != 8) return -1;
        if (cache_fill < CACHE - 1) {  // keep >=1 empty slot: probe terminates
          used[slot] = true;
          keys[slot] = bits;
          memcpy(reps[slot], tmp, 8);
          cache_fill++;
        }
        memcpy(p, tmp, 8);
        p += 8;
        *p++ = (c + 1 == ncols) ? '\n' : delim;
        continue;
      }
      memcpy(p, reps[slot], 8);
      p += 8;
      *p++ = (c + 1 == ncols) ? '\n' : delim;
    }
  }
  return p - out;
}

// Fused normalise+format for the oligo hot path: per-row counts are
// still int16/int32 exactly as fetched from the device, so no f64
// intermediates are materialised. Value formatted is the f64 quotient
// count / max(1, total) — identical to the reference's normalisation
// (composition/src/oligo.rs:255-257) followed by {:.6}. Cache is keyed
// on the (total, count) pair; a slab has few distinct pairs.
int64_t kt_emit_oligo_norm(const int16_t *counts, const int32_t *totals,
                           int64_t nrows, int64_t ncols, char delim,
                           char *out) {
  enum { CACHE = 1 << 12 };
  static thread_local uint32_t keys[CACHE];
  static thread_local char reps[CACHE][8];
  static thread_local bool used[CACHE];
  memset(used, 0, sizeof(used));
  int64_t cache_fill = 0;

  char *p = out;
  for (int64_t r = 0; r < nrows; r++) {
    int32_t t = totals[r];
    double tdiv = (double)(t < 1 ? 1 : t);  // exact / , NOT *1/t: rounding
    if (t > 0x7FFF) return -1;  // pair key would overflow: caller falls back
    uint32_t tkey = (uint32_t)(t < 1 ? 1 : t) << 16;
    const int16_t *row = counts + r * ncols;
    for (int64_t c = 0; c < ncols; c++) {
      uint32_t key = tkey | (uint16_t)row[c];
      uint32_t slot = (key * 2654435761u) >> 20;  // 12-bit hash
      while (used[slot] && keys[slot] != key) slot = (slot + 1) & (CACHE - 1);
      if (!used[slot]) {
        char tmp[32];
        int n = snprintf(tmp, sizeof(tmp), "%.6f", (double)row[c] / tdiv);
        if (n != 8) return -1;
        if (cache_fill < CACHE - 1) {
          used[slot] = true;
          keys[slot] = key;
          memcpy(reps[slot], tmp, 8);
          cache_fill++;
        }
        memcpy(p, tmp, 8);
      } else {
        memcpy(p, reps[slot], 8);
      }
      p += 8;
      *p++ = (c + 1 == ncols) ? '\n' : delim;
    }
  }
  return p - out;
}

// Raw integer rows straight from device int16 counts (unnormalised path).
int64_t kt_format_counts_i16(const int16_t *vals, int64_t nrows, int64_t ncols,
                             char delim, char *out) {
  char *p = out;
  for (int64_t r = 0; r < nrows; r++) {
    for (int64_t c = 0; c < ncols; c++) {
      p += sprintf(p, "%d", (int)vals[r * ncols + c]);
      *p++ = (c + 1 == ncols) ? '\n' : delim;
    }
  }
  return p - out;
}

// Raw integer count rows (Rust `{}` on whole f64s, oligo.rs:136).
// Returns bytes written (caller sizes out as nrows*ncols*21).
int64_t kt_format_counts(const double *vals, int64_t nrows, int64_t ncols,
                         char delim, char *out) {
  char *p = out;
  for (int64_t r = 0; r < nrows; r++) {
    for (int64_t c = 0; c < ncols; c++) {
      long long v = (long long)vals[r * ncols + c];
      p += sprintf(p, "%lld", v);
      *p++ = (c + 1 == ncols) ? '\n' : delim;
    }
  }
  return p - out;
}

// Fast u64 -> decimal (sprintf is ~5x slower and dominates counter
// merge output at tens of millions of lines).
static inline char *itoa_u64(uint64_t v, char *p) {
  char tmp[20];
  int n = 0;
  do {
    tmp[n++] = (char)('0' + (v % 10));
    v /= 10;
  } while (v);
  while (n) *p++ = tmp[--n];
  return p;
}

// kmer\tcount TSV lines (counter spill/merge, counter/src/lib.rs:151-167).
int64_t kt_format_u64_tsv(const uint64_t *keys, const uint64_t *vals,
                          int64_t n, char *out) {
  char *p = out;
  for (int64_t i = 0; i < n; i++) {
    p = itoa_u64(keys[i], p);
    *p++ = '\t';
    p = itoa_u64(vals[i], p);
    *p++ = '\n';
  }
  return p - out;
}

// Parse `u64\tu64\n` TSV bytes into two arrays (counter merge reading
// spill files back, counter/src/lib.rs:195-210). Returns row count.
int64_t kt_parse_u64_tsv(const char *buf, int64_t len, uint64_t *keys,
                         uint64_t *vals) {
  const char *p = buf, *end = buf + len;
  int64_t n = 0;
  while (p < end) {
    while (p < end && (*p == '\n' || *p == '\r')) p++;
    if (p >= end) break;
    uint64_t k = 0;
    while (p < end && *p >= '0' && *p <= '9') k = k * 10 + (uint64_t)(*p++ - '0');
    while (p < end && (*p == '\t' || *p == ' ')) p++;
    uint64_t v = 0;
    while (p < end && *p >= '0' && *p <= '9') v = v * 10 + (uint64_t)(*p++ - '0');
    keys[n] = k;
    vals[n] = v;
    n++;
    while (p < end && *p != '\n') p++;
  }
  return n;
}

// ACGT-keyed TSV lines (counter merge --acgt, counter/src/lib.rs:224-228).
int64_t kt_format_acgt_tsv(const uint64_t *keys, const uint64_t *vals,
                           int64_t n, int k, char *out) {
  static const char B[4] = {'A', 'C', 'G', 'T'};
  char *p = out;
  for (int64_t i = 0; i < n; i++) {
    uint64_t kv = keys[i];
    for (int j = k - 1; j >= 0; j--) {
      p[j] = B[kv & 3];
      kv >>= 2;
    }
    p += k;
    *p++ = '\t';
    p = itoa_u64(vals[i], p);
    *p++ = '\n';
  }
  return p - out;
}

// ---------------------------------------------------------------------------
// Rust `{}` f64 Display: shortest round-trip decimal, ALWAYS positional
// (never scientific), integral values drop the ".0"
// (utils/fmt.rust_f64_repr semantics, composition/src/cgr.rs:99 output).
// std::to_chars gives the shortest digits; we re-expand any exponent form.
// ---------------------------------------------------------------------------
static char *fmt_f64_rust(double v, char *p) {
  if (v != v) {
    memcpy(p, "NaN", 3);
    return p + 3;
  }
  if (std::isinf(v)) {
    if (v < 0) *p++ = '-';
    memcpy(p, "inf", 3);
    return p + 3;
  }
  if (v > -9.2e18 && v < 9.2e18 && v == (double)(long long)v) {
    long long i = (long long)v;
    if (i == 0 && std::signbit(v)) {
      *p++ = '-';
      *p++ = '0';
      return p;
    }
    if (i < 0) {
      *p++ = '-';
      i = -i;
    }
    return itoa_u64((uint64_t)i, p);
  }
  char tmp[64];
  auto res = std::to_chars(tmp, tmp + sizeof(tmp) - 1, v);
  int64_t n = res.ptr - tmp;
  tmp[n] = '\0';  // to_chars does not terminate; strtol below needs it
  // find exponent marker
  int64_t epos = -1;
  for (int64_t i = 0; i < n; i++) {
    if (tmp[i] == 'e') {
      epos = i;
      break;
    }
  }
  if (epos < 0) {
    memcpy(p, tmp, (size_t)n);
    return p + n;
  }
  // mantissa: [sign]d[.ddd], exponent after 'e'
  int64_t mstart = 0;
  if (tmp[0] == '-') {
    *p++ = '-';
    mstart = 1;
  }
  char digits[32];
  int64_t nd = 0;
  for (int64_t i = mstart; i < epos; i++) {
    if (tmp[i] != '.') digits[nd++] = tmp[i];
  }
  int exp = (int)strtol(tmp + epos + 1, nullptr, 10);
  // value = 0.digits * 10^(exp+1) with digits[0] the leading digit:
  // point sits after the first digit, so shift = exp
  if (exp >= 0) {
    int64_t int_digits = exp + 1;
    if (int_digits >= nd) {
      memcpy(p, digits, (size_t)nd);
      p += nd;
      for (int64_t i = nd; i < int_digits; i++) *p++ = '0';
    } else {
      memcpy(p, digits, (size_t)int_digits);
      p += int_digits;
      *p++ = '.';
      memcpy(p, digits + int_digits, (size_t)(nd - int_digits));
      p += nd - int_digits;
    }
  } else {
    *p++ = '0';
    *p++ = '.';
    for (int i = 0; i < -exp - 1; i++) *p++ = '0';
    memcpy(p, digits, (size_t)nd);
    p += nd;
  }
  return p;
}

extern "C" {

// CGR point lines: per row, "(x,y) (x,y) ... (x,y)\n" over lens[r]
// points (composition/src/cgr.rs:86-123 output). xs/ys are (nrows,
// stride) row-major. Returns bytes written, or -1 if `cap` would
// overflow (caller retries with a larger buffer).
int64_t kt_format_cgr(const double *xs, const double *ys,
                      const int32_t *lens, int64_t nrows, int64_t stride,
                      char *out, int64_t cap) {
  char *p = out;
  char *end = out + cap;
  for (int64_t r = 0; r < nrows; r++) {
    const double *xr = xs + r * stride;
    const double *yr = ys + r * stride;
    int32_t L = lens[r];
    for (int32_t i = 0; i < L; i++) {
      if (end - p < 1400) return -1;  // worst-case denormal expansion
      if (i) *p++ = ' ';
      *p++ = '(';
      p = fmt_f64_rust(xr[i], p);
      *p++ = ',';
      p = fmt_f64_rust(yr[i], p);
      *p++ = ')';
    }
    if (end - p < 1) return -1;
    *p++ = '\n';
  }
  return p - out;
}

// s2m minimiser lines (misc/src/minimisers.rs:87-160):
// "id\tACGT:s-e\t...\tACGT:s-e\t\n" — the reference tab-joins a
// trailing "\n" element, so a tab precedes the newline. Records of read
// r live at [offs[r], offs[r+1]); ids are a NUL-separated blob indexed
// by id_off. Returns bytes written or -1 on cap overflow.
int64_t kt_format_s2m(const uint64_t *vals, const int64_t *starts,
                      const int64_t *ends, const int64_t *offs,
                      const char *ids_blob, const int64_t *id_off,
                      int64_t n_reads, int msize, char *out, int64_t cap) {
  static const char B[4] = {'A', 'C', 'G', 'T'};
  char *p = out;
  char *end = out + cap;
  for (int64_t r = 0; r < n_reads; r++) {
    const char *id = ids_blob + id_off[r];
    size_t idlen = strlen(id);
    if (end - p < (int64_t)idlen + 4) return -1;
    memcpy(p, id, idlen);
    p += idlen;
    for (int64_t i = offs[r]; i < offs[r + 1]; i++) {
      if (end - p < msize + 48) return -1;
      *p++ = '\t';
      uint64_t kv = vals[i];
      for (int j = msize - 1; j >= 0; j--) {
        p[j] = B[kv & 3];
        kv >>= 2;
      }
      p += msize;
      *p++ = ':';
      p = itoa_u64((uint64_t)starts[i], p);
      *p++ = '-';
      p = itoa_u64((uint64_t)ends[i], p);
    }
    *p++ = '\t';
    *p++ = '\n';
  }
  return p - out;
}

// m2s minimiser-group lines (misc/src/minimisers.rs:11-85 output):
// `ACGT\t[("id", s, e), ("id", s, e)]\n` — one line per distinct
// minimiser, records in read order within the group. Group g's key is
// vals[g] and its records live at [bounds[g], bounds[g+1]); rid_of
// maps a record to its read, ids are a NUL-separated blob indexed by
// id_off. Returns bytes written or -1 on cap overflow.
int64_t kt_format_m2s(const uint64_t *vals, const int64_t *bounds,
                      const int64_t *starts, const int64_t *ends,
                      const int64_t *rid_of, const char *ids_blob,
                      const int64_t *id_off, int64_t n_groups, int msize,
                      char *out, int64_t cap) {
  static const char B[4] = {'A', 'C', 'G', 'T'};
  char *p = out;
  char *end = out + cap;
  for (int64_t g = 0; g < n_groups; g++) {
    if (end - p < msize + 3) return -1;
    uint64_t kv = vals[g];
    for (int j = msize - 1; j >= 0; j--) {
      p[j] = B[kv & 3];
      kv >>= 2;
    }
    p += msize;
    *p++ = '\t';
    *p++ = '[';
    for (int64_t i = bounds[g]; i < bounds[g + 1]; i++) {
      const char *id = ids_blob + id_off[rid_of[i]];
      size_t idlen = strlen(id);
      if (end - p < (int64_t)idlen + 56) return -1;
      if (i != bounds[g]) {
        *p++ = ',';
        *p++ = ' ';
      }
      *p++ = '(';
      *p++ = '"';
      memcpy(p, id, idlen);
      p += idlen;
      *p++ = '"';
      *p++ = ',';
      *p++ = ' ';
      p = itoa_u64((uint64_t)starts[i], p);
      *p++ = ',';
      *p++ = ' ';
      p = itoa_u64((uint64_t)ends[i], p);
      *p++ = ')';
    }
    if (end - p < 2) return -1;
    *p++ = ']';
    *p++ = '\n';
  }
  return p - out;
}

// Oligo-CGR lines: per row, "(x,y,freq) (x,y,freq) ... (x,y,freq)\n"
// (composition/src/oligocgr.rs:82-119). The "(x,y," prefixes are fixed
// per column (NUL-separated blob); freq renders via fmt_f64_rust with a
// bit-pattern cache (few distinct count/total ratios per slab).
int64_t kt_format_oligocgr(const char *prefix_blob, const int32_t *prefix_off,
                           int64_t ncols, const double *freqs, int64_t nrows,
                           char *out, int64_t cap) {
  enum { CACHE = 1 << 12 };
  static thread_local uint64_t keys[CACHE];
  static thread_local char reps[CACHE][40];
  static thread_local uint8_t replen[CACHE];
  static thread_local bool used[CACHE];
  memset(used, 0, sizeof(used));
  int64_t cache_fill = 0;

  char *p = out;
  char *end = out + cap;
  for (int64_t r = 0; r < nrows; r++) {
    const double *row = freqs + r * ncols;
    for (int64_t c = 0; c < ncols; c++) {
      if (end - p < 1500) return -1;
      if (c) *p++ = ' ';
      const char *pref = prefix_blob + prefix_off[c];
      while (*pref) *p++ = *pref++;
      double v = row[c];
      uint64_t bits;
      memcpy(&bits, &v, 8);
      uint64_t slot = (bits * 0x9E3779B97F4A7C15ull) >> 52;
      while (used[slot] && keys[slot] != bits) slot = (slot + 1) & (CACHE - 1);
      if (used[slot]) {
        memcpy(p, reps[slot], replen[slot]);
        p += replen[slot];
      } else {
        char *q = fmt_f64_rust(v, p);
        int64_t n = q - p;
        if (n <= 40 && cache_fill < CACHE - 1) {
          used[slot] = true;
          keys[slot] = bits;
          memcpy(reps[slot], p, (size_t)n);
          replen[slot] = (uint8_t)n;
          cache_fill++;
        }
        p = q;
      }
      *p++ = ')';
    }
    *p++ = '\n';
  }
  return p - out;
}

// ---- 2-bit code packing ---------------------------------------------------
// (R, W) u8 codes (0..3 valid, 4 = ambiguous/padding) ->
//   packed (R, W/4): base j of each quad in bits 2j..2j+1
//   validbits (R, W/8): bit j of each octet = code < 4
// The host half of ops/encode.py:unpack_planes; W is always a multiple
// of 8. `lengths` (may be null) gives each row's real code count; the
// return value is the number of ambiguous codes found INSIDE those
// lengths (-1 on bad width, rows*W/4 + ambig semantics below). When it
// is 0 the valid plane is fully implied by the lengths and callers can
// upload (packed, lengths) instead of (packed, validbits) — exactly
// 2 bits/base on the wire (ops/encode.py:unpack_packed).
// Returns: -1 on width%8, else the ambiguous-code count (>= 0).
#ifdef __AVX2__
// One row, 32 codes per step: valid mask via movemask (bit i = code i,
// np.packbits little order), 2-bit pack via maddubs(1,4) + madd(1,16)
// horizontal combines. Returns the row's ambiguous-within-len count.
static int64_t pack_row_avx2(const uint8_t *c, int64_t width, int64_t len,
                             uint8_t *p, uint8_t *v) {
  const __m256i hi_mask = _mm256_set1_epi8((char)0xFC);
  const __m256i zero = _mm256_setzero_si256();
  const __m256i three = _mm256_set1_epi8(3);
  const __m256i mul14 = _mm256_set1_epi16(0x0401);   // bytes (1, 4)
  const __m256i mul116 = _mm256_set1_epi32(0x00100001);  // i16s (1, 16)
  // per 128-bit lane: gather dword low bytes 0,4,8,12 into bytes 0..3
  const __m256i gather = _mm256_setr_epi8(
      0, 4, 8, 12, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1,
      0, 4, 8, 12, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1);
  int64_t ambig = 0;
  for (int64_t base = 0; base < width; base += 32) {
    __m256i x = _mm256_loadu_si256((const __m256i *)(c + base));
    __m256i ok = _mm256_cmpeq_epi8(_mm256_and_si256(x, hi_mask), zero);
    uint32_t mask = (uint32_t)_mm256_movemask_epi8(ok);
    memcpy(v + base / 8, &mask, 4);
    if (mask != 0xFFFFFFFFu && base < len) {
      uint32_t inv = ~mask;
      int64_t in_row = len - base;
      if (in_row < 32) inv &= (1u << in_row) - 1;
      ambig += __builtin_popcount(inv);
    }
    __m256i m = _mm256_and_si256(x, three);
    __m256i t16 = _mm256_maddubs_epi16(m, mul14);
    __m256i t32 = _mm256_madd_epi16(t16, mul116);
    __m256i by = _mm256_shuffle_epi8(t32, gather);
    uint32_t lo = (uint32_t)_mm_cvtsi128_si32(_mm256_castsi256_si128(by));
    uint32_t hi = (uint32_t)_mm_cvtsi128_si32(
        _mm256_extracti128_si256(by, 1));
    memcpy(p + base / 4, &lo, 4);
    memcpy(p + base / 4 + 4, &hi, 4);
  }
  return ambig;
}
#endif

// ---- persistent per-calling-thread worker pool ---------------------------
// The per-batch kernels (plane pack, oligo/cov histograms, the counter
// engine) used to spawn + join T std::threads per call — ~2400 thread
// creations per bench run, measured as 10-20% of kernel wall lost to
// scheduling. Each CALLING thread owns a lazily-grown persistent pool
// (thread_local in kt_parallel), so concurrent pipeline stages (the
// producer's pack, a sink's histogram) keep independent workers and a
// call costs two condition-variable hops instead of T thread spawns.

class LocalPool {
 public:
  ~LocalPool() {
    {
      std::lock_guard<std::mutex> lk(m_);
      stop_ = true;
      gen_++;
    }
    cv_.notify_all();
    for (auto &t : th_) t.join();
  }

  // Run fn(r0, r1) over [0, n) in T contiguous chunks. The calling
  // thread works too, so only T-1 workers are woken.
  void run(int T, int64_t n,
           const std::function<void(int64_t, int64_t)> &fn) {
    if (n <= 0) return;
    if ((int64_t)T > n) T = (int)n;
    if (T <= 1) {
      fn(0, n);
      return;
    }
    Job job;
    job.fn = &fn;
    job.n = n;
    job.chunk = (n + T - 1) / T;
    job.pending.store(
        (int)((n + job.chunk - 1) / job.chunk), std::memory_order_relaxed);
    ensure(T - 1);
    {
      std::lock_guard<std::mutex> lk(m_);
      job_ = &job;
      gen_++;
    }
    cv_.notify_all();
    grab(&job);
    // the job struct lives on this stack frame: wait until every chunk
    // ran AND no worker still holds the pointer before returning
    std::unique_lock<std::mutex> lk(m_);
    done_cv_.wait(lk, [&] {
      return job.pending.load(std::memory_order_acquire) == 0 &&
             job.holders.load(std::memory_order_acquire) == 0;
    });
    job_ = nullptr;
  }

 private:
  struct Job {
    const std::function<void(int64_t, int64_t)> *fn;
    int64_t n = 0, chunk = 1;
    std::atomic<int64_t> next{0};
    std::atomic<int> pending{0};
    std::atomic<int> holders{0};
  };

  void ensure(int nw) {
    while ((int)th_.size() < nw)
      th_.emplace_back([this] { worker(); });
  }

  void grab(Job *j) {
    for (;;) {
      const int64_t i = j->next.fetch_add(1, std::memory_order_relaxed);
      const int64_t r0 = i * j->chunk;
      if (r0 >= j->n) return;
      const int64_t r1 = r0 + j->chunk < j->n ? r0 + j->chunk : j->n;
      (*j->fn)(r0, r1);
      if (j->pending.fetch_sub(1, std::memory_order_acq_rel) == 1) {
        std::lock_guard<std::mutex> lk(m_);
        done_cv_.notify_all();
      }
    }
  }

  void worker() {
    uint64_t seen = 0;
    for (;;) {
      Job *j = nullptr;
      {
        std::unique_lock<std::mutex> lk(m_);
        cv_.wait(lk, [&] { return gen_ != seen; });
        seen = gen_;
        if (stop_) return;
        j = job_;
        if (j) j->holders.fetch_add(1, std::memory_order_acq_rel);
      }
      if (!j) continue;
      grab(j);
      if (j->holders.fetch_sub(1, std::memory_order_acq_rel) == 1) {
        std::lock_guard<std::mutex> lk(m_);
        done_cv_.notify_all();
      }
    }
  }

  std::mutex m_;
  std::condition_variable cv_, done_cv_;
  std::vector<std::thread> th_;
  Job *job_ = nullptr;
  uint64_t gen_ = 0;
  bool stop_ = false;
};

// Chunked parallel-for on the calling thread's persistent pool.
static void kt_parallel(int T, int64_t n,
                        const std::function<void(int64_t, int64_t)> &fn) {
  static thread_local LocalPool pool;
  pool.run(T, n, fn);
}

static int64_t kt_pack_planes_serial(const uint8_t *codes, int64_t rows,
                                     int64_t width, const int32_t *lengths,
                                     uint8_t *packed, uint8_t *validbits) {
  const int64_t wq = width / 4, wb = width / 8;
  int64_t ambig = 0;
#ifdef __AVX2__
  if (width % 32 == 0) {
    for (int64_t r = 0; r < rows; r++) {
      ambig += pack_row_avx2(
          codes + r * width, width,
          lengths ? (int64_t)lengths[r] : width,
          packed + r * wq, validbits + r * wb);
    }
    return ambig;
  }
#endif
  for (int64_t r = 0; r < rows; r++) {
    const uint8_t *c = codes + r * width;
    uint8_t *p = packed + r * wq;
    uint8_t *v = validbits + r * wb;
    const int64_t len = lengths ? (int64_t)lengths[r] : width;
    for (int64_t i = 0; i < wb; i++) {
      const uint8_t *q = c + i * 8;
      uint8_t m0 = 0, m1 = 0, vb = 0;
      for (int j = 0; j < 4; j++) {
        uint8_t a = q[j], b = q[4 + j];
        m0 |= (uint8_t)((a & 3) << (2 * j));
        m1 |= (uint8_t)((b & 3) << (2 * j));
        vb |= (uint8_t)(((a < 4) ? 1 : 0) << j);
        vb |= (uint8_t)(((b < 4) ? 1 : 0) << (4 + j));
      }
      p[2 * i] = m0;
      p[2 * i + 1] = m1;
      v[i] = vb;
      if (vb != 0xFF) {
        // count ambiguous codes before this row's length
        const int64_t base = i * 8;
        for (int j = 0; j < 8; j++)
          if (base + j < len && q[j] >= 4) ambig++;
      }
    }
  }
  return ambig;
}

int64_t kt_pack_planes(const uint8_t *codes, int64_t rows, int64_t width,
                       const int32_t *lengths,
                       uint8_t *packed, uint8_t *validbits) {
  if (width % 8) return -1;
  // The pack runs on the pipeline's producer thread (the zero-copy
  // bucket buffers are only valid until the next batcher call, so it
  // cannot defer to a sink thread); for large batches split the rows
  // across helpers so the producer stage keeps pace with the ~1 Gb/s
  // parse. Row outputs are disjoint; per-thread ambig counts sum.
  const int64_t total = rows * width;
  int T = (int)(total / (1 << 20));
  const int hw = (int)std::thread::hardware_concurrency();
  if (T > 4) T = 4;
  if (hw > 0 && T > hw) T = hw;
  if (T > 1 && rows > 1) {
    std::atomic<int64_t> ambig{0};
    kt_parallel(T, rows, [&](int64_t r0, int64_t r1) {
      ambig.fetch_add(
          kt_pack_planes_serial(
              codes + r0 * width, r1 - r0, width,
              lengths ? lengths + r0 : nullptr,
              packed + r0 * (width / 4), validbits + r0 * (width / 8)),
          std::memory_order_relaxed);
    });
    return ambig.load();
  }
  return kt_pack_planes_serial(codes, rows, width, lengths, packed,
                               validbits);
}

// ---- native per-read oligo histogram (heterogeneous CPU sink) -------------
// Rolling 2-bit encoder + per-read k-mer count, the reference's hot loop
// (kmer/src/kmer.rs:80-106 + composition/src/oligo.rs:240-254) as a
// multithreaded host kernel. In the heterogeneous scheduler this is one
// sink beside the XLA device programs (workloads/common.py): batches
// route to whichever silicon is free. Operates on the packed planes the
// batcher already produces (2 bits/base + valid bits); ambiguous bases
// reset the window exactly like the device path's prefix-AND. k <= 7
// (composition range), counts fit int16 (row width <= 8192).
//   slot_table: 4^k canonical-slot remap (kmer/src/kmer.rs:54-73), or
//   null for raw forward-strand mode (nbins = 4^k).
// Returns 0, or -1 on bad arguments.
int kt_oligo_hist(const uint8_t *packed, const uint8_t *validbits,
                  int64_t rows, int64_t width, int32_t k,
                  const int32_t *slot_table, int32_t nbins,
                  int16_t *counts, int32_t *totals, int32_t nthreads,
                  int64_t cnt_stride) {
  // cnt_stride: elements between row starts of `counts` (>= nbins) —
  // callers pass nbins + 1 to write counts straight into the fused
  // [counts | total] layout and skip a ~4.5 MB copy per batch
  if (cnt_stride < nbins) cnt_stride = nbins;
  if (width % 8 || k < 1 || k > 15) return -1;
  const int64_t wq = width / 4, wb = width / 8;
  const uint32_t mask = (1u << (2 * k)) - 1;
  const int rcshift = 2 * (k - 1);

  // Window LUT (k <= 7): in the 2-bit planes a k-mer starting at base j
  // IS bits [2j, 2j+2k) of the packed row (earliest base in the LOW
  // bits — pair-reversed relative to the rolling id). Precomputing
  // window -> final bin (canonical min + slot remap folded in) turns
  // the per-base rolling encode + cmov + gather into one unaligned
  // load + one L1 lookup. 4^7 int16 = 32 KB worst case.
  std::vector<int16_t> lut;
  if (k <= 7) {
    lut.resize((size_t)1 << (2 * k));
    for (uint32_t w = 0; w < (uint32_t)lut.size(); w++) {
      uint32_t f = 0, rr = 0;
      for (int j = 0; j < k; j++) {  // same recurrence as the hot loop
        const uint32_t c = (w >> (2 * j)) & 3u;
        f = ((f << 2) | c) & mask;
        rr = (rr >> 2) | ((3u - c) << rcshift);
      }
      const uint32_t id = slot_table ? (f < rr ? f : rr) : f;
      lut[w] = (int16_t)(slot_table ? (uint32_t)slot_table[id] : id);
    }
  }
  const int16_t *lutp = lut.empty() ? nullptr : lut.data();

  // Striped accumulators (see the fast8 loop): 4 independent count
  // arrays break the load-inc-store dependency chain when nearby
  // windows hit the same bin (repetitive sequence is the worst case:
  // a homopolymer serialises every increment through one address).
  // Only worth it when the row is long enough to amortise the
  // zero+merge (4*nbins halfwords) and the stripes stay L1-resident.
  const bool use_stripes = lutp && nbins <= 2048;
  auto work = [&](int64_t r0, int64_t r1) {
    std::vector<int16_t> stripe_buf(use_stripes ? 4 * (size_t)nbins : 0);
    for (int64_t r = r0; r < r1; r++) {
      const uint8_t *p = packed + r * wq;
      const uint8_t *v = validbits + r * wb;
      int16_t *cnt = counts + r * cnt_stride;
      memset(cnt, 0, (size_t)nbins * sizeof(int16_t));
      if (lutp) {
        // ambiguity-free row? (valid plane = contiguous low-bit run)
        int64_t full = 0;
        while (full < wb && v[full] == 0xFF) full++;
        int64_t len = full * 8;
        bool clean = true;
        if (full < wb) {
          const uint8_t b = v[full];
          if (b & (uint8_t)(b + 1)) {
            clean = false;  // hole inside the byte
          } else {
            len += __builtin_popcount((unsigned)b);
            for (int64_t t = full + 1; t < wb && clean; t++)
              if (v[t]) clean = false;
          }
        }
        if (clean) {
          const int64_t nk = len - k + 1;
          if (nk <= 0) {
            totals[r] = 0;
            continue;
          }
          // 8 positions per u64 load (j stays a multiple of 8, so the
          // 8 window shifts are the constants 0,2,...,14 — bits
          // 2j..2j+14+2k < 2j+64 for k <= 7): one load + 8 L1 lookups
          // + 8 increments per 8 codes, ~2.5x the one-u32-per-position
          // form. Safe region: byte j/4 + 7 <= wq - 1.
          const int64_t fast8 = nk < 4 * wq - 28 ? nk : 4 * wq - 28;
          int64_t j = 0;
          if (use_stripes && nk >= 8 * (int64_t)nbins) {
            int16_t *s0 = stripe_buf.data(), *s1 = s0 + nbins,
                    *s2 = s1 + nbins, *s3 = s2 + nbins;
            memset(s0, 0, 4 * (size_t)nbins * sizeof(int16_t));
            for (; j + 8 <= fast8; j += 8) {
              uint64_t w;
              memcpy(&w, p + (j >> 2), 8);
              s0[lutp[(uint32_t)(w >> 0) & mask]]++;
              s1[lutp[(uint32_t)(w >> 2) & mask]]++;
              s2[lutp[(uint32_t)(w >> 4) & mask]]++;
              s3[lutp[(uint32_t)(w >> 6) & mask]]++;
              s0[lutp[(uint32_t)(w >> 8) & mask]]++;
              s1[lutp[(uint32_t)(w >> 10) & mask]]++;
              s2[lutp[(uint32_t)(w >> 12) & mask]]++;
              s3[lutp[(uint32_t)(w >> 14) & mask]]++;
            }
            for (int32_t b = 0; b < nbins; b++)
              cnt[b] = (int16_t)(s0[b] + s1[b] + s2[b] + s3[b]);
          } else {
            // non-striped fallback: the same 8-wide loop accumulating
            // straight into cnt. Structurally either-or with the
            // striped loop above (after it drains, j is already past
            // fast8 - 7) — keep shift constants in sync across both.
            for (; j + 8 <= fast8; j += 8) {
              uint64_t w;
              memcpy(&w, p + (j >> 2), 8);
              cnt[lutp[(uint32_t)(w >> 0) & mask]]++;
              cnt[lutp[(uint32_t)(w >> 2) & mask]]++;
              cnt[lutp[(uint32_t)(w >> 4) & mask]]++;
              cnt[lutp[(uint32_t)(w >> 6) & mask]]++;
              cnt[lutp[(uint32_t)(w >> 8) & mask]]++;
              cnt[lutp[(uint32_t)(w >> 10) & mask]]++;
              cnt[lutp[(uint32_t)(w >> 12) & mask]]++;
              cnt[lutp[(uint32_t)(w >> 14) & mask]]++;
            }
          }
          // safe region for whole-u32 loads: byte j/4 + 3 <= wq - 1
          const int64_t fast_end =
              nk < 4 * wq - 12 ? nk : 4 * wq - 12;
          for (; j < fast_end; j++) {
            uint32_t w;
            memcpy(&w, p + (j >> 2), 4);
            cnt[lutp[(w >> (2 * (j & 3))) & mask]]++;
          }
          for (; j < nk; j++) {  // tail: byte-bounded gather
            uint32_t w = 0;
            const int64_t b0 = j >> 2;
            for (int t = 0; t < 4 && b0 + t < wq; t++)
              w |= (uint32_t)p[b0 + t] << (8 * t);
            cnt[lutp[(w >> (2 * (j & 3))) & mask]]++;
          }
          totals[r] = (int32_t)nk;
          continue;
        }
      }
      uint32_t fwd = 0, rc = 0;
      int run = 0;
      int32_t tot = 0;
      for (int64_t i = 0; i < wb; i++) {
        const uint8_t vb = v[i];
        if (vb == 0) {  // fully invalid octet (padding / N run)
          run = 0;
          continue;
        }
        const uint32_t two =
            (uint32_t)p[2 * i] | ((uint32_t)p[2 * i + 1] << 8);
        if (vb == 0xFF) {
          for (int j = 0; j < 8; j++) {
            const uint32_t c = (two >> (2 * j)) & 3u;
            fwd = ((fwd << 2) | c) & mask;
            rc = (rc >> 2) | ((3u - c) << rcshift);
            if (++run >= k) {
              const uint32_t id =
                  slot_table ? (fwd < rc ? fwd : rc) : fwd;
              cnt[slot_table ? (uint32_t)slot_table[id] : id]++;
              tot++;
            }
          }
        } else {
          for (int j = 0; j < 8; j++) {
            if (!((vb >> j) & 1)) {
              run = 0;
              continue;
            }
            const uint32_t c = (two >> (2 * j)) & 3u;
            fwd = ((fwd << 2) | c) & mask;
            rc = (rc >> 2) | ((3u - c) << rcshift);
            if (++run >= k) {
              const uint32_t id =
                  slot_table ? (fwd < rc ? fwd : rc) : fwd;
              cnt[slot_table ? (uint32_t)slot_table[id] : id]++;
              tot++;
            }
          }
        }
      }
      totals[r] = tot;
    }
  };

  int T = nthreads > 0 ? nthreads : 1;
  kt_parallel(T, rows, work);
  return 0;
}

// ---- native out-of-core counting engine (heterogeneous ctr sink) ----------
// The reference's count hot loop — rolling canonical encode + sharded
// concurrent map upsert (counter/src/lib.rs:104-143) — as a host engine
// beside the device accumulator (workloads/counter.py). The k-mer space
// splits into S internal shards with S a multiple of n_parts and
// shard = kmer % S, so partition p (= kmer % n_parts, lib.rs:127) is
// exactly the union of shards s with s % n_parts == p. Each batch runs
// two phases: T threads bucket canonical k-mers by shard (radix pass,
// no contention), then T threads upsert disjoint shard stripes into
// open-addressed maps (one owner per shard — lock-free by structure,
// the scc-map analog). Drains return one partition at a time, sorted,
// and reset the shards; Python writes the reference spill TSVs.

struct KtCtrShard {
  std::vector<uint64_t> keys;  // EMPTY = ~0ull
  std::vector<uint32_t> vals;
  size_t n = 0;

  void reset(size_t cap) {
    keys.assign(cap, ~0ull);
    vals.assign(cap, 0);
    n = 0;
  }

  static inline uint64_t mix(uint64_t x) {  // splitmix64 finalizer
    x += 0x9e3779b97f4a7c15ull;
    x = (x ^ (x >> 30)) * 0xbf58476d1ce4e5b9ull;
    x = (x ^ (x >> 27)) * 0x94d049bb133111ebull;
    return x ^ (x >> 31);
  }

  void rehash(size_t cap) {
    std::vector<uint64_t> ok = std::move(keys);
    std::vector<uint32_t> ov = std::move(vals);
    keys.assign(cap, ~0ull);
    vals.assign(cap, 0);
    const size_t mask = cap - 1;
    for (size_t i = 0; i < ok.size(); i++) {
      if (ok[i] == ~0ull) continue;
      size_t h = mix(ok[i]) & mask;
      while (keys[h] != ~0ull) h = (h + 1) & mask;
      keys[h] = ok[i];
      vals[h] = ov[i];
    }
  }

  inline void upsert(uint64_t k) {
    const size_t mask = keys.size() - 1;
    size_t h = mix(k) & mask;
    for (;;) {
      if (keys[h] == k) {
        vals[h]++;
        return;
      }
      if (keys[h] == ~0ull) {
        keys[h] = k;
        vals[h] = 1;
        if (++n * 4 >= keys.size() * 3) rehash(keys.size() * 2);
        return;
      }
      h = (h + 1) & mask;
    }
  }
};

struct KtCtr {
  int k;
  int64_t n_parts;
  int64_t S;  // internal shards, multiple of n_parts
  int T;
  std::vector<KtCtrShard> shards;
  // per-thread per-shard bucket storage, reused across batches
  std::vector<std::vector<std::vector<uint64_t>>> buckets;
  // freeze(): per-partition sorted extracts awaiting drain
  std::vector<std::vector<std::pair<uint64_t, uint32_t>>> staged;
};

void *kt_ctr_new(int32_t k, int64_t n_parts, int32_t nthreads) {
  if (k < 1 || k > 31 || n_parts < 1) return nullptr;
  KtCtr *c = new KtCtr();
  c->k = k;
  c->n_parts = n_parts;
  c->T = nthreads > 0 ? nthreads : 1;
  const int64_t want = 4 * (int64_t)c->T;
  c->S = n_parts * ((want + n_parts - 1) / n_parts);
  c->shards.resize((size_t)c->S);
  for (auto &s : c->shards) s.reset(1024);
  c->buckets.resize((size_t)c->T);
  for (auto &b : c->buckets) b.resize((size_t)c->S);
  return c;
}

void kt_ctr_free(void *h) { delete (KtCtr *)h; }

// One batch of packed planes (2 bits/base + valid bits, row width a
// multiple of 8). Returns total unique k-mers across shards, or -1.
int64_t kt_ctr_add(void *h, const uint8_t *packed, const uint8_t *validbits,
                   int64_t rows, int64_t width) {
  KtCtr *c = (KtCtr *)h;
  if (!c || width % 8) return -1;
  const int64_t wq = width / 4, wb = width / 8;
  const int k = c->k;
  const uint64_t mask =
      (k == 32) ? ~0ull : ((1ull << (2 * k)) - 1ull);
  const int rcshift = 2 * (k - 1);
  const int64_t S = c->S;
  int T = c->T;
  if (T > rows) T = (int)(rows > 0 ? rows : 1);

  // phase 1: bucket canonical k-mers by shard (per-thread, no sharing)
  auto scan = [&](int t, int64_t r0, int64_t r1) {
    auto &buck = c->buckets[(size_t)t];
    for (auto &v : buck) v.clear();
    for (int64_t r = r0; r < r1; r++) {
      const uint8_t *p = packed + r * wq;
      const uint8_t *v = validbits + r * wb;
      uint64_t fwd = 0, rc = 0;
      int run = 0;
      for (int64_t i = 0; i < wb; i++) {
        const uint8_t vb = v[i];
        if (vb == 0) {  // fully invalid octet (padding / N run)
          run = 0;
          continue;
        }
        const uint32_t two =
            (uint32_t)p[2 * i] | ((uint32_t)p[2 * i + 1] << 8);
        if (vb == 0xFF) {  // clean octet (the common case): no per-bit
          for (int j = 0; j < 8; j++) {  // valid branch in the loop
            const uint64_t b = (two >> (2 * j)) & 3u;
            fwd = ((fwd << 2) | b) & mask;
            rc = (rc >> 2) | ((3ull - b) << rcshift);
            if (++run >= k) {
              const uint64_t can = fwd < rc ? fwd : rc;
              buck[(size_t)(can % (uint64_t)S)].push_back(can);
            }
          }
          continue;
        }
        for (int j = 0; j < 8; j++) {
          if (!((vb >> j) & 1)) {
            run = 0;
            continue;
          }
          const uint64_t b = (two >> (2 * j)) & 3u;
          fwd = ((fwd << 2) | b) & mask;
          rc = (rc >> 2) | ((3ull - b) << rcshift);
          if (++run >= k) {
            const uint64_t can = fwd < rc ? fwd : rc;
            buck[(size_t)(can % (uint64_t)S)].push_back(can);
          }
        }
      }
    }
  };
  {
    const int64_t chunk = rows > 0 ? (rows + T - 1) / T : 1;
    const int nch = (int)((rows + chunk - 1) / chunk);
    // bucket slot = chunk index (r0 / chunk): same one-slot-per-worker
    // layout as the former one-thread-per-range spawn
    kt_parallel(T, rows, [&](int64_t r0, int64_t r1) {
      scan((int)(r0 / chunk), r0, r1);
    });
    for (int t = nch; t < c->T; t++)
      for (auto &v : c->buckets[(size_t)t]) v.clear();
  }

  // phase 2: upsert disjoint shard stripes (one owner thread per shard).
  // The upserts are DRAM-latency-bound (each probes a random slot of a
  // table far bigger than L2); prefetching the slot PF items ahead
  // overlaps ~8 misses. Addresses recompute per item, so a rehash mid-
  // stream only wastes a few prefetches, never reads stale pointers.
  auto fold = [&](int64_t s0, int64_t s1) {
    constexpr size_t PF = 8;
    for (int64_t s = s0; s < s1; s++) {
      KtCtrShard &sh = c->shards[(size_t)s];
      for (int t = 0; t < c->T; t++) {
        const auto &vec = c->buckets[(size_t)t][(size_t)s];
        const size_t nn = vec.size();
        for (size_t i = 0; i < nn; i++) {
          if (i + PF < nn) {
            const size_t mask = sh.keys.size() - 1;
            const size_t hp = KtCtrShard::mix(vec[i + PF]) & mask;
            __builtin_prefetch(&sh.keys[hp], 1, 1);
            __builtin_prefetch(&sh.vals[hp], 1, 1);
          }
          sh.upsert(vec[i]);
        }
      }
    }
  };
  kt_parallel(T, S, fold);

  int64_t uniq = 0;
  for (auto &s : c->shards) uniq += (int64_t)s.n;
  return uniq;
}

// ---- native coverage histogram (heterogeneous cov sink) -------------------
// Rolling canonical encode + sorted-table lower-bound join + abundance
// binning (coverage/src/lib.rs:165-184: bin = min(count / bin_size,
// bin_count - 1), absent k-mers count 0 and land in bin 0). One
// int16 histogram row + int32 total per read; same fused layout as the
// device program (workloads/coverage.py:_coverage_batch). k <= 31.
// Shared implementation: `bo` (may be null) is a bucket index over the
// sorted table — bo[b] = first table position whose key >> bshift >= b,
// length 2^bb + 1. A whole-table lower_bound costs ~log2(13M) = 24
// probes, most of them DRAM misses; bucketing by the top bits confines
// each search to ~nt/2^bb keys — 2-3 touched cache lines.
static int kt_cov_hist_impl(
    const uint8_t *packed, const uint8_t *validbits,
    int64_t rows, int64_t width, int32_t k,
    const uint64_t *tkeys, const int32_t *tcnts, int64_t nt,
    const uint32_t *bo, int bb,
    int32_t bin_size, int32_t bin_count,
    int16_t *counts, int32_t *totals, int32_t nthreads,
    int64_t cnt_stride) {
  if (cnt_stride < bin_count) cnt_stride = bin_count;
  if (width % 8 || k < 1 || k > 31 || bin_size < 1 || bin_count < 1)
    return -1;
  const int64_t wq = width / 4, wb = width / 8;
  const uint64_t mask = (1ull << (2 * k)) - 1ull;
  const int rcshift = 2 * (k - 1);
  const int bshift = 2 * k - bb;

  auto work = [&](int64_t r0, int64_t r1) {
    // two passes per row: extract the canonical k-mers (cheap,
    // register-resident), then look them up with the table fetch
    // software-prefetched PF iterations ahead — the join is
    // DRAM-latency-bound, and prefetching overlaps ~8 misses.
    std::vector<uint64_t> kbuf;
    constexpr int PF = 8;
    for (int64_t r = r0; r < r1; r++) {
      const uint8_t *p = packed + r * wq;
      const uint8_t *v = validbits + r * wb;
      int16_t *cnt = counts + r * cnt_stride;
      memset(cnt, 0, (size_t)bin_count * sizeof(int16_t));
      if ((int64_t)kbuf.size() < width) kbuf.resize((size_t)width);
      uint64_t fwd = 0, rc = 0;
      int run = 0;
      int64_t nq = 0;
      for (int64_t i = 0; i < wb; i++) {
        const uint8_t vb = v[i];
        if (vb == 0) {
          run = 0;
          continue;
        }
        const uint32_t two =
            (uint32_t)p[2 * i] | ((uint32_t)p[2 * i + 1] << 8);
        for (int j = 0; j < 8; j++) {
          if (!((vb >> j) & 1)) {
            run = 0;
            continue;
          }
          const uint64_t b = (two >> (2 * j)) & 3u;
          fwd = ((fwd << 2) | b) & mask;
          rc = (rc >> 2) | ((3ull - b) << rcshift);
          if (++run >= k) kbuf[(size_t)nq++] = fwd < rc ? fwd : rc;
        }
      }
      for (int64_t q = 0; q < nq; q++) {
        if (bo) {
          // two-stage pipeline: warm the index entry 2*PF ahead so
          // that by q+PF it reads without stalling, then use it to
          // prefetch that search's first (deepest-missing) probe —
          // the bucket midpoint in tkeys.
          if (q + 2 * PF < nq)
            __builtin_prefetch(
                &bo[(size_t)(kbuf[(size_t)(q + 2 * PF)] >> bshift)], 0, 1);
          if (q + PF < nq) {
            const size_t fb = (size_t)(kbuf[(size_t)(q + PF)] >> bshift);
            const uint32_t flo = bo[fb], fhi = bo[fb + 1];
            if (fhi > flo)
              __builtin_prefetch(&tkeys[flo + ((fhi - flo) >> 1)], 0, 1);
          }
        }
        const uint64_t can = kbuf[(size_t)q];
        const uint64_t *b_lo = tkeys, *b_hi = tkeys + nt;
        if (bo) {
          const size_t bkt = (size_t)(can >> bshift);
          b_lo = tkeys + bo[bkt];
          b_hi = tkeys + bo[bkt + 1];
        }
        const uint64_t *lo = std::lower_bound(b_lo, b_hi, can);
        int32_t c = 0;
        if (lo != b_hi && *lo == can) c = tcnts[lo - tkeys];
        int32_t bin = c / bin_size;
        if (bin >= bin_count) bin = bin_count - 1;
        cnt[bin]++;
      }
      totals[r] = (int32_t)nq;
    }
  };

  int T = nthreads > 0 ? nthreads : 1;
  kt_parallel(T, rows, work);
  return 0;
}

int kt_cov_hist(const uint8_t *packed, const uint8_t *validbits,
                int64_t rows, int64_t width, int32_t k,
                const uint64_t *tkeys, const int32_t *tcnts, int64_t nt,
                int32_t bin_size, int32_t bin_count,
                int16_t *counts, int32_t *totals, int32_t nthreads) {
  if (k < 1 || k > 31) return -1;
  // self-contained variant: builds the bucket index per call (counting
  // pass + prefix sum, O(nt)). Callers joining many batches against
  // one table should build the index once and use kt_cov_hist_idx.
  const int bb = 2 * k < 18 ? 2 * k : 18;
  const int bshift = 2 * k - bb;
  const size_t nbk = (size_t)1 << bb;
  std::vector<uint32_t> boff;
  if (nt >= 0 && (uint64_t)nt <= 0xFFFFFFFFull) {
    boff.assign(nbk + 2, 0);
    for (int64_t i = 0; i < nt; i++) boff[(size_t)(tkeys[i] >> bshift) + 1]++;
    for (size_t b = 1; b <= nbk + 1; b++) boff[b] += boff[b - 1];
  }
  return kt_cov_hist_impl(packed, validbits, rows, width, k, tkeys, tcnts,
                          nt, boff.empty() ? nullptr : boff.data(), bb,
                          bin_size, bin_count, counts, totals, nthreads,
                          bin_count);
}

// Caller-built index variant: `boff` has 2^bb + 1 entries, boff[b] =
// first table position with key >> (2k - bb) >= b (numpy: searchsorted
// of the bucket boundaries) — built once per count table instead of
// once per batch.
int kt_cov_hist_idx(const uint8_t *packed, const uint8_t *validbits,
                    int64_t rows, int64_t width, int32_t k,
                    const uint64_t *tkeys, const int32_t *tcnts, int64_t nt,
                    const uint32_t *boff, int32_t bb,
                    int32_t bin_size, int32_t bin_count,
                    int16_t *counts, int32_t *totals, int32_t nthreads,
                    int64_t cnt_stride) {
  if (k < 1 || k > 31 || bb < 0 || bb > 2 * k) return -1;
  return kt_cov_hist_impl(packed, validbits, rows, width, k, tkeys, tcnts,
                          nt, boff, (int)bb, bin_size, bin_count, counts,
                          totals, nthreads, cnt_stride);
}

// ---- native minimiser scanner (heterogeneous min sink) --------------------
// The reference's sequential minimiser state machine
// (kmer/src/minimiser.rs:61-175 — buffer of W = w-m+1 canonical m-mer
// minima, emission when the active minimiser changes, ambiguity flush,
// final-partial-window emit) run per row, rows parallel over threads.
// wsize == 0 means window = whole read (misc/src/minimisers.rs:44-48):
// per row the machine runs with w_eff = len. Operates on packed planes;
// records land at caller-provided per-row offsets (capacity len+2 per
// row — one emission advances pos, so counts are bounded by len+1).
// Returns 0, or -1 on bad arguments.
int kt_min_batch(const uint8_t *packed, const uint8_t *validbits,
                 int64_t rows, int64_t width, const int32_t *lens,
                 int32_t msize, int32_t wsize, int32_t nthreads,
                 const int64_t *offs, uint64_t *vals, int64_t *starts,
                 int64_t *ends, int64_t *row_counts) {
  if (width % 8 || msize < 1 || msize > 31 || wsize < 0) return -1;
  const int64_t wq = width / 4, wb = width / 8;
  const uint64_t m_mask = (1ull << (2 * msize)) - 1ull;
  const int m_shift = 2 * (msize - 1);
  const uint64_t U64MAX = ~0ull;

  auto work = [&](int64_t r0, int64_t r1) {
    std::vector<uint64_t> buf;
    for (int64_t row = r0; row < r1; row++) {
      const uint8_t *p = packed + row * wq;
      const uint8_t *v = validbits + row * wb;
      const int64_t n = lens[row];
      uint64_t *o_val = vals + offs[row];
      int64_t *o_st = starts + offs[row];
      int64_t *o_en = ends + offs[row];
      const int64_t cap = offs[row + 1] - offs[row];
      int64_t cnt = 0;
      const int64_t w_eff = wsize > 0 ? wsize : n;
      const int64_t W = w_eff - msize + 1;
      row_counts[row] = 0;
      if (W <= 0 || n < msize) continue;
      if ((int64_t)buf.size() < W) buf.resize((size_t)W);
      int64_t bn = 0, bhead = 0, buff_pos = 0;
      uint64_t m_active = U64MAX, f = 0, r = 0;
      int64_t run = 0, m_window_start = 0, pos = 0;
      auto emit = [&](uint64_t val, int64_t s, int64_t e) {
        if (cnt < cap) {
          o_val[cnt] = val & m_mask;
          o_st[cnt] = s;
          o_en[cnt] = e;
        }
        cnt++;
      };
      while (pos < n) {
        const int c = ((v[pos >> 3] >> (pos & 7)) & 1)
                          ? (int)((p[pos >> 2] >> (2 * (pos & 3))) & 3)
                          : 4;
        if (c < 4) {
          f = ((f << 2) | (uint64_t)c) & m_mask;
          r = (r >> 2) | ((uint64_t)(3 - c) << m_shift);
          run++;
        } else {  // ambiguity flush (minimiser.rs:81-102)
          const bool should_return = bn == W;
          const uint64_t pv = m_active;
          const int64_t ps = m_window_start, pe = pos;
          buff_pos = 0;
          m_active = U64MAX;
          f = r = 0;
          run = 0;
          m_window_start = pos + 1;
          bn = 0;
          bhead = 0;
          pos++;
          if (should_return) emit(pv, ps, pe);
          continue;
        }
        if (run < msize) {
          pos++;
          continue;
        }
        run--;
        const uint64_t mmin = f < r ? f : r;
        if (bn == W) {
          // pop front + append back: new element lands on the old head
          buf[(size_t)bhead] = mmin;
          bhead = (bhead + 1) % W;
          if (buff_pos == 0) {  // evicted the active min: recompute
            uint64_t new_min = U64MAX;
            for (int64_t j = 0; j < W; j++) {
              const uint64_t x = buf[(size_t)((bhead + j) % W)];
              if (x < new_min) {
                buff_pos = j;
                new_min = x;
              }
            }
            if (new_min != m_active) {
              const uint64_t pv = m_active;
              const int64_t ps = m_window_start, pe = pos;
              m_active = new_min;
              m_window_start = pos - w_eff + 1;
              pos++;
              emit(pv, ps, pe);
              continue;
            }
          } else if (mmin < m_active) {
            const uint64_t pv = m_active;
            const int64_t ps = m_window_start, pe = pos;
            m_active = mmin;
            buff_pos = W - 1;
            m_window_start = pos - w_eff + 1;
            pos++;
            emit(pv, ps, pe);
            continue;
          } else {
            buff_pos--;
          }
        } else {
          buf[(size_t)((bhead + bn) % W)] = mmin;
          bn++;
        }
        if (m_active == U64MAX && bn == W) {
          for (int64_t j = 0; j < W; j++) {
            const uint64_t x = buf[(size_t)((bhead + j) % W)];
            if (x < m_active) {
              buff_pos = j;
              m_active = x;
            }
          }
        }
        if (pos == n - 1) {  // final window (minimiser.rs:168-171)
          pos++;
          emit(m_active, m_window_start, n);
          continue;
        }
        pos++;
      }
      row_counts[row] = cnt <= cap ? cnt : -1;  // -1: capacity bug guard
    }
  };

  int T = nthreads > 0 ? nthreads : 1;
  kt_parallel(T, rows, work);
  return 0;
}

// LSD radix sort of (key, count) pairs on the low `bits` key bits.
// The keys here are hash-map extracts — uniformly spread — where
// std::sort pays ~log2(n) cache-missing passes; 11-bit LSD digits make
// ceil(bits/11) sequential passes instead (the dominant drain cost in
// cold processes, where every comparison-sort probe faults a page).
static void kt_radix_sort_kv(std::vector<std::pair<uint64_t, uint32_t>> &a,
                             int bits) {
  const int RB = 11;
  const size_t NB = (size_t)1 << RB;
  const size_t n = a.size();
  if (n < (size_t)1 << 12) {  // small partitions: std::sort wins
    std::sort(a.begin(), a.end());
    return;
  }
  std::vector<std::pair<uint64_t, uint32_t>> tmp(n);
  std::vector<size_t> cnt(NB);
  const int passes = (bits + RB - 1) / RB;
  for (int pass = 0; pass < passes; pass++) {
    const int sh = pass * RB;
    std::fill(cnt.begin(), cnt.end(), 0);
    for (size_t i = 0; i < n; i++) cnt[(a[i].first >> sh) & (NB - 1)]++;
    size_t sum = 0;
    for (size_t b = 0; b < NB; b++) {
      const size_t v = cnt[b];
      cnt[b] = sum;
      sum += v;
    }
    for (size_t i = 0; i < n; i++)
      tmp[cnt[(a[i].first >> sh) & (NB - 1)]++] = a[i];
    a.swap(tmp);
  }
}

// P-way merge of ascending-sorted (keys, counts) u64 arrays into one
// sorted pair (keys across parts are disjoint — counter partitions by
// `kmer % n_parts` — so no equal-key handling is needed). Linear head
// scan per output: P is the partition count (~threads), so P compares
// per element beat a heap's branchy log P for the sizes in play.
int kt_merge_sorted_kv(const uint64_t **keys, const uint64_t **cnts,
                       const int64_t *lens, int64_t nparts,
                       uint64_t *okeys, uint64_t *ocnts) {
  if (nparts < 1) return 0;
  std::vector<int64_t> pos((size_t)nparts, 0);
  int64_t total = 0;
  for (int64_t p = 0; p < nparts; p++) total += lens[p];
  for (int64_t i = 0; i < total; i++) {
    int best = -1;
    uint64_t bk = ~0ull;
    for (int64_t p = 0; p < nparts; p++) {
      if (pos[(size_t)p] < lens[p]) {
        const uint64_t k = keys[p][pos[(size_t)p]];
        if (best < 0 || k < bk) {
          bk = k;
          best = (int)p;
        }
      }
    }
    okeys[i] = bk;
    ocnts[i] = cnts[best][pos[(size_t)best]];
    pos[(size_t)best]++;
  }
  return 0;
}

// P-way merge of ascending-sorted (keys, counts) u64 arrays with
// DUPLICATE-KEY SUMMING (the counter merge phase: one partition's
// chunk spills all carry the same key space). Streaming single pass:
// peak memory = inputs + output, vs the concatenate+argsort fallback's
// ~4x (measured: a 2.4 Gbase merge OOM-killed a 128 GB host before
// this). Returns entries written to okeys/ocnts (caller caps at
// sum(lens)).
int64_t kt_merge_sum_kv(const uint64_t **keys, const uint64_t **cnts,
                        const int64_t *lens, int64_t nparts,
                        uint64_t *okeys, uint64_t *ocnts) {
  if (nparts < 1) return 0;
  std::vector<int64_t> pos((size_t)nparts, 0);
  int64_t w = -1;
  auto put = [&](uint64_t k, uint64_t c) {
    if (w >= 0 && okeys[w] == k) {
      ocnts[w] += c;
    } else {
      w++;
      okeys[w] = k;
      ocnts[w] = c;
    }
  };
  if (nparts <= 8) {
    // few inputs: a branchy linear head scan beats heap bookkeeping
    for (;;) {
      int best = -1;
      uint64_t bk = ~0ull;
      for (int64_t p = 0; p < nparts; p++) {
        if (pos[(size_t)p] < lens[p]) {
          const uint64_t k = keys[p][pos[(size_t)p]];
          if (best < 0 || k < bk) {
            bk = k;
            best = (int)p;
          }
        }
      }
      if (best < 0) return w + 1;
      put(bk, cnts[best][pos[(size_t)best]]);
      pos[(size_t)best]++;
    }
  }
  // many inputs (chunk counts scale with corpus size): binary min-heap
  // of (key, part) -> log P per row instead of P. Sum order over equal
  // keys doesn't matter (commutative), output identical either way.
  std::vector<std::pair<uint64_t, int>> heap;
  heap.reserve((size_t)nparts);
  auto cmp = [](const std::pair<uint64_t, int> &a,
                const std::pair<uint64_t, int> &b) {
    return a.first > b.first;  // min-heap
  };
  for (int64_t p = 0; p < nparts; p++)
    if (lens[p] > 0) heap.emplace_back(keys[p][0], (int)p);
  std::make_heap(heap.begin(), heap.end(), cmp);
  while (!heap.empty()) {
    std::pop_heap(heap.begin(), heap.end(), cmp);
    auto [k, p] = heap.back();
    heap.pop_back();
    put(k, cnts[p][pos[(size_t)p]]);
    if (++pos[(size_t)p] < lens[p]) {
      heap.emplace_back(keys[p][pos[(size_t)p]], p);
      std::push_heap(heap.begin(), heap.end(), cmp);
    }
  }
  return w + 1;
}

// Stable LSD-radix argsort of u64 keys whose values fit `bits` bits
// (11-bit digits). numpy's introsort argsort on 11M minimiser values
// measured 1.6 s; this runs at memory speed (~0.2 s) and is stable,
// which the m2s output contract relies on (records arrive in
// (read, start) order; a stable sort by value realises the full
// (value, read, start) order).
int kt_radix_argsort_u64(const uint64_t *keys, int64_t n, int32_t bits,
                         int64_t *out) {
  if (n < 0 || bits < 1 || bits > 64) return -1;
  if (n == 0) return 0;
  std::vector<std::pair<uint64_t, int64_t>> a((size_t)n), tmp((size_t)n);
  for (int64_t i = 0; i < n; i++) a[(size_t)i] = {keys[i], i};
  const int RB = 11;
  const size_t NB = (size_t)1 << RB;
  std::vector<size_t> cnt(NB);
  const int passes = (bits + RB - 1) / RB;
  for (int pass = 0; pass < passes; pass++) {
    const int sh = pass * RB;
    std::fill(cnt.begin(), cnt.end(), 0);
    for (int64_t i = 0; i < n; i++)
      cnt[(a[(size_t)i].first >> sh) & (NB - 1)]++;
    size_t sum = 0;
    for (size_t b = 0; b < NB; b++) {
      const size_t v = cnt[b];
      cnt[b] = sum;
      sum += v;
    }
    for (int64_t i = 0; i < n; i++)
      tmp[cnt[(a[(size_t)i].first >> sh) & (NB - 1)]++] = a[(size_t)i];
    a.swap(tmp);
  }
  for (int64_t i = 0; i < n; i++) out[i] = a[(size_t)i].second;
  return 0;
}

// Extract + sort every partition in parallel, resetting the shards.
// kt_ctr_part_len / kt_ctr_drain_part then read the staged results.
void kt_ctr_freeze(void *h, int32_t nthreads) {
  KtCtr *c = (KtCtr *)h;
  if (!c) return;
  c->staged.assign((size_t)c->n_parts, {});
  int T = nthreads > 0 ? nthreads : c->T;
  if ((int64_t)T > c->n_parts) T = (int)c->n_parts;
  auto work = [&](int64_t p0, int64_t p1) {
    for (int64_t p = p0; p < p1; p++) {
      auto &items = c->staged[(size_t)p];
      size_t total = 0;
      for (int64_t s = p; s < c->S; s += c->n_parts)
        total += c->shards[(size_t)s].n;
      items.resize(total);  // one allocation; growth would re-copy
      size_t w = 0;
      for (int64_t s = p; s < c->S; s += c->n_parts) {
        KtCtrShard &sh = c->shards[(size_t)s];
        for (size_t i = 0; i < sh.keys.size(); i++)
          if (sh.keys[i] != ~0ull)
            items[w++] = {sh.keys[i], sh.vals[i]};
        sh.reset(1024);
      }
      kt_radix_sort_kv(items, 2 * c->k);
    }
  };
  kt_parallel(T, c->n_parts, work);
}

int64_t kt_ctr_part_len(void *h, int64_t part) {
  KtCtr *c = (KtCtr *)h;
  if (!c || part < 0 || part >= c->n_parts) return -1;
  if (!c->staged.empty())
    return (int64_t)c->staged[(size_t)part].size();
  int64_t n = 0;
  for (int64_t s = part; s < c->S; s += c->n_parts)
    n += (int64_t)c->shards[(size_t)s].n;
  return n;
}

// Drain partition `part` sorted ascending into keys/counts (length from
// kt_ctr_part_len) and reset its shards. Returns entries written.
int64_t kt_ctr_drain_part(void *h, int64_t part, uint64_t *keys,
                          uint64_t *counts) {
  KtCtr *c = (KtCtr *)h;
  if (!c || part < 0 || part >= c->n_parts) return -1;
  std::vector<std::pair<uint64_t, uint32_t>> local;
  std::vector<std::pair<uint64_t, uint32_t>> *items = &local;
  if (!c->staged.empty()) {
    items = &c->staged[(size_t)part];
  } else {
    for (int64_t s = part; s < c->S; s += c->n_parts) {
      KtCtrShard &sh = c->shards[(size_t)s];
      for (size_t i = 0; i < sh.keys.size(); i++)
        if (sh.keys[i] != ~0ull) local.emplace_back(sh.keys[i], sh.vals[i]);
      sh.reset(1024);
    }
    kt_radix_sort_kv(local, 2 * c->k);
  }
  const int64_t n = (int64_t)items->size();
  for (int64_t i = 0; i < n; i++) {
    keys[i] = (*items)[i].first;
    counts[i] = (uint64_t)(*items)[i].second;
  }
  if (!c->staged.empty()) {
    c->staged[(size_t)part].clear();
    c->staged[(size_t)part].shrink_to_fit();
    if (part == c->n_parts - 1) c->staged.clear();
  }
  return n;
}

}  // extern "C"

}  // outer extern "C"
