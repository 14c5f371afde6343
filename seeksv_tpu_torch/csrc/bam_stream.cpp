// The streamed BAM decoder of seeksv_tpu_torch (io/native.py,
// iter_bam_chunks_native).
//
// It yields the slabs, the columns and the error messages of
// csrc/seeksv_native.cpp's seeksv_bam_open / seeksv_bam_next2, which stay
// the JAX package's reader, but it keeps its memory and its threads for
// the life of the stream:
//
//   - n_threads workers, made when the stream opens and joined when it
//     closes, read the file in 16 MB compressed windows (the reference's
//     reads, so that a bad block fails the same window) and inflate each
//     window's BGZF blocks in pieces of ~4 MB, ahead of the record walk,
//     until the pieces that the walk holds and those ahead come to about
//     one slab's bytes (always one window ahead);
//   - a piece inflates into a buffer of its own that is reused for later
//     pieces: never value-initialised, sized from the blocks' ISIZE
//     fields, and handed back as soon as the slab that holds it is
//     filled.  A record that straddles pieces is copied whole into a
//     small buffer;
//   - one sequential walk on the caller's thread finds the records and
//     their cigar / seq / qname offsets; the caller and the idle workers
//     then fill the columns as fill_records does, and beside them each
//     record's CIGAR summary (its first and last op and length, and its
//     reference span with and without X), which the reference does not
//     write;
//   - a slab's columns go into a buffer set from a pool.  The caller hands
//     the set back with seeksv_torch_bam_release when the last view of it
//     is gone; a set handed back after the stream closed is freed.
//
// Built into the same library as csrc/seeksv_native.cpp
// (seeksv_tpu_torch/_build.py:build_native), with the same flags.

#include <algorithm>
#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <deque>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

#include <sys/mman.h>
#include <zlib.h>
#ifdef USE_LIBDEFLATE
#include <libdeflate.h>
#endif

namespace {

// ---- BGZF framing, inflate and record fields, as csrc/seeksv_native.cpp
// has them (its helpers are internal to that file).

struct Block {
  size_t comp_off;   // offset of deflate payload within the read
  size_t comp_len;   // payload length (without header/footer)
  size_t out_off;    // offset in the read's decompressed bytes
  size_t out_len;    // ISIZE
};

// Scans complete BGZF blocks in [buf, buf+n); stops at a trailing partial
// block.  *consumed = bytes of complete blocks.  Returns false on a
// malformed (non-BGZF) header at a block boundary.
bool scan_bgzf_prefix(const uint8_t* buf, size_t n, std::vector<Block>* out,
                      size_t* total_out, size_t* consumed) {
  size_t off = 0;
  size_t out_off = 0;
  while (off + 18 <= n) {
    if (buf[off] != 0x1f || buf[off + 1] != 0x8b) return false;
    uint8_t flg = buf[off + 3];
    size_t p = off + 10;
    size_t bsize = 0;
    if (flg & 4) {  // FEXTRA
      uint16_t xlen;
      memcpy(&xlen, buf + p, 2);
      size_t xend = p + 2 + xlen;
      if (xend > n) break;  // header incomplete: wait for more bytes
      p += 2;
      while (p + 4 <= xend) {
        uint8_t si1 = buf[p], si2 = buf[p + 1];
        uint16_t slen;
        memcpy(&slen, buf + p + 2, 2);
        if (si1 == 'B' && si2 == 'C' && slen == 2) {
          uint16_t bs;
          memcpy(&bs, buf + p + 4, 2);
          bsize = (size_t)bs + 1;
        }
        p += 4 + slen;
      }
      p = xend;
    }
    if (bsize == 0) return false;  // not BGZF
    size_t data_off = p;
    size_t block_end = off + bsize;
    if (block_end > n) break;  // partial block at tail
    if (block_end < data_off + 8) return false;
    uint32_t isize;
    memcpy(&isize, buf + block_end - 4, 4);
    out->push_back({data_off, block_end - data_off - 8, out_off, isize});
    out_off += isize;
    off = block_end;
  }
  *total_out = out_off;
  *consumed = off;
  return true;
}

#ifdef USE_LIBDEFLATE
bool inflate_block(const uint8_t* src, size_t src_len, uint8_t* dst,
                   size_t dst_len, libdeflate_decompressor* d) {
  if (dst_len == 0) return true;
  size_t actual = 0;
  return libdeflate_deflate_decompress(d, src, src_len, dst, dst_len,
                                       &actual) == LIBDEFLATE_SUCCESS &&
         actual == dst_len;
}

struct InflateCtx {
  libdeflate_decompressor* d;
  InflateCtx() : d(libdeflate_alloc_decompressor()) {}
  ~InflateCtx() { libdeflate_free_decompressor(d); }
};
#else
bool inflate_block(const uint8_t* src, size_t src_len, uint8_t* dst,
                   size_t dst_len, void* /*ctx*/ = nullptr) {
  z_stream zs;
  memset(&zs, 0, sizeof(zs));
  if (inflateInit2(&zs, -15) != Z_OK) return false;
  zs.next_in = const_cast<uint8_t*>(src);
  zs.avail_in = (uInt)src_len;
  zs.next_out = dst;
  zs.avail_out = (uInt)dst_len;
  int ret = inflate(&zs, Z_FINISH);
  inflateEnd(&zs);
  return ret == Z_STREAM_END || (ret == Z_OK && zs.avail_out == 0) ||
         (dst_len == 0 && ret == Z_BUF_ERROR);
}

struct InflateCtx {
  void* d = nullptr;
};
#endif

const char kNt16[17] = "=ACMGRSVTWYHKDBN";

// byte -> two unpacked ASCII bases (little-endian: low byte = high nibble,
// i.e. the first base in BAM 4-bit packing)
struct PairLut {
  uint16_t v[256];
  PairLut() {
    for (int b = 0; b < 256; b++)
      v[b] = (uint16_t)((uint8_t)kNt16[b >> 4] |
                        ((uint16_t)(uint8_t)kNt16[b & 0xF] << 8));
  }
};
const PairLut kPairLut;

int32_t aux_xc(const uint8_t* a, const uint8_t* end) {
  int32_t xc = 0;
  const uint8_t* p = a;
  while (p + 3 <= end) {
    uint8_t t0 = p[0], t1 = p[1], typ = p[2];
    p += 3;
    int64_t val = 0;
    size_t sz = 0;
    bool is_int = false;
    switch (typ) {
      case 'A': sz = 1; break;
      case 'c': val = *(const int8_t*)p; sz = 1; is_int = true; break;
      case 'C': val = *p; sz = 1; is_int = true; break;
      case 's': { int16_t v; memcpy(&v, p, 2); val = v; sz = 2; is_int = true; } break;
      case 'S': { uint16_t v; memcpy(&v, p, 2); val = v; sz = 2; is_int = true; } break;
      case 'i': { int32_t v; memcpy(&v, p, 4); val = v; sz = 4; is_int = true; } break;
      case 'I': { uint32_t v; memcpy(&v, p, 4); val = (int64_t)v; sz = 4; is_int = true; } break;
      case 'f': sz = 4; break;
      case 'Z':
      case 'H': {
        const uint8_t* q = p;
        while (q < end && *q) q++;
        sz = (size_t)(q - p) + 1;
      } break;
      case 'B': {
        if (p + 5 > end) return xc;
        uint8_t sub = p[0];
        int32_t cnt;
        memcpy(&cnt, p + 1, 4);
        size_t esz = (sub == 'c' || sub == 'C') ? 1
                     : (sub == 's' || sub == 'S') ? 2 : 4;
        sz = 5 + (size_t)cnt * esz;
      } break;
      default:
        return xc;
    }
    if (is_int && t0 == 'X' && t1 == 'C') xc = (int32_t)val;
    p += sz;
  }
  return xc;
}

// ---- the stream

// The layout of csrc/seeksv_native.cpp's BamSoA (io/native.py _BamSoA),
// then each record's CIGAR summary, which only this decoder writes
// (io/native.py _TorchSoA).
struct SoA {
  int64_t n;
  int32_t* flag;
  int32_t* tid;
  int32_t* pos;
  int32_t* mapq;
  int32_t* mtid;
  int32_t* mpos;
  int32_t* isize;
  int32_t* l_qseq;
  int32_t* xc;
  int64_t* cig_off;
  uint32_t* cig;
  int64_t n_cig_total;
  int64_t* seq_off;
  uint8_t* seq;
  uint8_t* qual;
  int64_t n_seq_total;
  int64_t* qname_off;
  uint8_t* qnames;
  int64_t n_qname_total;
  int32_t n_refs;
  int32_t* ref_lens;
  uint8_t* ref_names;
  int64_t ref_names_len;
  int64_t* rec_off;   // null: a streamed slab has no stream offsets
  int64_t body_off;
  char error[256];
  int32_t* first_op;   // op of the first CIGAR word; -1: no CIGAR
  int32_t* last_op;
  int32_t* first_len;  // length of the first CIGAR word; 0: no CIGAR
  int32_t* last_len;
  int32_t* span_nox;   // M/D/N/= lengths summed
  int32_t* span_x;     // M/D/N/=/X lengths summed (bam_calend)
};

// A buffer of T that only grows, never value-initialised: a mapping of
// its own, so that it goes back to the kernel when the stream closes.
// (From malloc, the buffers that the workers and the decode thread free
// stay in their threads' arenas, and the next stream's new threads take
// other arenas: the process's resident memory grew with every scan.)
template <class T>
struct Arr {
  T* p = nullptr;
  size_t cap = 0;
  Arr() = default;
  Arr(const Arr&) = delete;
  Arr& operator=(const Arr&) = delete;
  ~Arr() { unmap(); }
  // room for n elements (a little more when it grows, so that a slightly
  // larger slab does not grow it again); keeps the first `keep`
  bool fit(size_t n, size_t keep = 0) {
    if (n <= cap) return true;
    size_t c = n + n / 8 + 1;
    void* q = mmap(nullptr, c * sizeof(T), PROT_READ | PROT_WRITE,
                   MAP_PRIVATE | MAP_ANONYMOUS, -1, 0);
    if (q == MAP_FAILED) return false;
    if (keep) memcpy(q, p, keep * sizeof(T));
    unmap();
    p = (T*)q;
    cap = c;
    return true;
  }
  void unmap() {
    if (p) munmap(p, cap * sizeof(T));
    p = nullptr;
    cap = 0;
  }
};

struct Pool;

// One slab's columns.  `soa` comes first: the caller's handle is its
// address.
struct Set {
  SoA soa;
  Pool* pool = nullptr;
  Arr<int32_t> i32[15];   // flag tid pos mapq mtid mpos isize l_qseq xc,
                          // first_op last_op first_len last_len span_nox
                          // span_x
  Arr<int64_t> off[3];    // cig_off seq_off qname_off
  Arr<uint32_t> cig;
  Arr<uint8_t> seq, qual, qnames;
  Arr<int32_t> ref_lens;
  Arr<uint8_t> ref_names;
};

// The sets of one stream.  It outlives the stream while a set is out.
struct Pool {
  std::mutex mu;
  std::vector<Set*> idle;
  int64_t out = 0;
  bool closed = false;
};

// One 16 MB read of the file: its bytes, until its pieces are inflated.
struct Read {
  Arr<uint8_t> comp;       // the previous read's partial block + the read
  std::vector<Block> blocks;
  int pieces_left = 0;     // pieces not yet inflated (under Stream::mu)
  bool last = false;       // this read reached the end of the file
  bool failed = false;
  char error[256];
};

// What the walk takes in file order: a piece of a read (consecutive
// blocks, about kPieceBytes inflated into a buffer of its own), or a
// read's failure.
struct Piece {
  Read* read = nullptr;
  Arr<uint8_t> data;       // the inflated bytes
  size_t len = 0;
  size_t lo = 0, hi = 0;   // its blocks in read->blocks
  bool ready = false;      // inflated
  bool first = false;      // the read's first piece
  size_t pieces = 0;       // on the first piece: the read's pieces
  bool last = false;       // the end of the file follows
  bool failed = false;
  char error[256];
};

struct FillJob {
  const uint8_t* const* recs;
  SoA* out;
  int64_t n;
  int lazy;
  std::atomic<int64_t> next{0};
};

constexpr size_t kReadWindow = 16u << 20;  // compressed bytes a read
constexpr size_t kPieceBytes = 4u << 20;   // inflated bytes a piece
constexpr int64_t kFillGrain = 4096;       // records a fill claim

struct Stream {
  FILE* f = nullptr;
  int n_threads = 1;
  Pool* pool = nullptr;
  int32_t n_refs = 0;
  std::vector<int32_t> ref_lens;
  std::string ref_names;  // '\0'-joined

  // shared with the workers, under mu
  std::mutex mu;
  std::condition_variable work_cv, done_cv;
  std::vector<std::thread> workers;
  std::deque<Piece*> tasks;    // pieces to inflate; a read where null
  bool stopping = false;
  std::deque<Piece*> ahead;    // pieces read, not taken by the walk
  std::vector<Piece*> spare;
  std::vector<Read*> spare_reads;
  std::vector<Read*> reads;     // every read buffer, for stop()
  Read* next_read = nullptr;    // the read queued or running
  bool read_end = false;        // the last read was made, or one failed
  size_t held_bytes = 0, ahead_bytes = 0;
  size_t budget = kPieceBytes;  // bytes held + ahead before a read waits
  FillJob* job = nullptr;
  int helpers_queued = 0, helpers_active = 0;

  // the read task's own (reads run one at a time)
  std::vector<uint8_t> carry;   // the partial block after the last read

  // the walk's own (the caller's thread)
  Piece* cur = nullptr;
  size_t off = 0;
  std::vector<Piece*> held;    // pieces the slab's records lie in, cur
                                // last (changed under mu)
  bool at_eof = false;          // the walk took the piece the end follows
  bool failed = false;
  char error[256] = {0};
  std::vector<uint8_t> part;    // a record begun in earlier pieces
  std::vector<std::vector<uint8_t>> joined;  // this slab's straddling records
  Arr<const uint8_t*> recs;     // the slab's records
  int64_t last_n = 1 << 16;     // records of the last slab: the offsets' size
  uint64_t seen_recs = 0, seen_rec_bytes = 0;
  int64_t slabs = 0, recycled = 0, windows = 0, windows_ready = 0;
};

Piece* spare_piece(Stream* s) {
  Piece* w;
  if (s->spare.empty()) {
    w = new Piece();
  } else {
    w = s->spare.back();
    s->spare.pop_back();
  }
  w->len = w->lo = w->hi = w->pieces = 0;
  w->ready = w->first = w->last = w->failed = false;
  w->error[0] = 0;
  return w;
}

// Schedules the next read while the bytes held by the walk and read ahead
// are under the budget, and always where nothing is ahead, so that the
// walk can go on.  Under s->mu.
void maybe_read(Stream* s) {
  if (s->next_read || s->read_end || s->stopping) return;
  if (!s->ahead.empty() && s->held_bytes + s->ahead_bytes >= s->budget)
    return;
  if (s->spare_reads.empty()) {
    s->next_read = new Read();
    s->reads.push_back(s->next_read);
  } else {
    s->next_read = s->spare_reads.back();
    s->spare_reads.pop_back();
  }
  s->tasks.push_back(nullptr);
  s->work_cv.notify_one();
}

// Reads r: the carried partial block, then up to kReadWindow bytes, and
// finds its complete blocks.  Errors as the reference's BamStream::pump.
// Runs outside the lock, one at a time.
void read_window(Stream* s, Read* r) {
  size_t carried = s->carry.size();
  r->blocks.clear();
  r->last = r->failed = false;
  if (!r->comp.fit(carried + kReadWindow)) {
    snprintf(r->error, sizeof(r->error), "out of memory");
    r->failed = r->last = true;
    return;
  }
  if (carried) memcpy(r->comp.p, s->carry.data(), carried);
  size_t got = fread(r->comp.p + carried, 1, kReadWindow, s->f);
  size_t n = carried + got;
  r->last = got < kReadWindow;
  size_t total = 0, consumed = 0;
  if (!scan_bgzf_prefix(r->comp.p, n, &r->blocks, &total, &consumed)) {
    snprintf(r->error, sizeof(r->error), "not a BGZF file");
    r->failed = r->last = true;
    return;
  }
  if (r->last && consumed != n) {
    snprintf(r->error, sizeof(r->error), "truncated BGZF block at EOF");
    r->failed = true;
    return;
  }
  s->carry.assign(r->comp.p + consumed, r->comp.p + n);
}

// Under s->mu, after read_window: cuts the read into pieces, queues their
// inflates and puts them ahead of the walk; a failed read becomes a
// failed piece, and a read of no blocks an empty one.
void after_read(Stream* s, Read* r) {
  s->next_read = nullptr;
  if (r->last) s->read_end = true;
  size_t nb = r->failed ? 0 : r->blocks.size();
  size_t lo = 0;
  Piece* first = nullptr;
  do {
    Piece* w = spare_piece(s);
    w->read = r;
    if (!first) first = w;
    w->first = w == first;
    first->pieces++;
    w->lo = lo;
    while (lo < nb && (lo == w->lo || w->len < kPieceBytes))
      w->len += r->blocks[lo++].out_len;
    w->hi = lo;
    w->last = r->last && lo == nb;
    if (!w->data.fit(w->len)) {
      snprintf(r->error, sizeof(r->error), "out of memory");
      r->failed = true;
    }
    if (r->failed) {
      w->failed = w->last = w->ready = true;
      snprintf(w->error, sizeof(w->error), "%s", r->error);
      s->read_end = true;
      lo = nb;
    } else if (w->hi == w->lo) {
      w->ready = true;
    } else {
      r->pieces_left++;
      s->tasks.push_back(w);
    }
    s->ahead.push_back(w);
    s->ahead_bytes += w->len;
  } while (lo < nb);
  if (r->pieces_left == 0) s->spare_reads.push_back(r);
  s->work_cv.notify_all();
  s->done_cv.notify_all();
  maybe_read(s);
}

// Inflates piece w.  A block that fails is inflated again into zeroed
// bytes: what the reference's zero-initialised buffer holds.
void inflate_piece(Piece* w, InflateCtx& ctx) {
  const Read* r = w->read;
  size_t base = r->blocks[w->lo].out_off;
  for (size_t i = w->lo; i < w->hi; i++) {
    const Block& b = r->blocks[i];
    uint8_t* dst = w->data.p + (b.out_off - base);
    const uint8_t* src = r->comp.p + b.comp_off;
    if (!inflate_block(src, b.comp_len, dst, b.out_len, ctx.d)) {
      memset(dst, 0, b.out_len);
      inflate_block(src, b.comp_len, dst, b.out_len, ctx.d);
    }
  }
}

void fill_rows(const FillJob* j, int64_t lo, int64_t hi) {
  SoA* out = j->out;
  for (int64_t i = lo; i < hi; i++) {
    const uint8_t* r = j->recs[i];
    int32_t bs;
    memcpy(&bs, r, 4);
    const uint8_t* rend = r + 4 + bs;
    const uint8_t* q = r + 4;
    int32_t tid, pos2, l_seq, mtid, mpos, tlen;
    memcpy(&tid, q, 4);
    memcpy(&pos2, q + 4, 4);
    uint8_t l_read_name = q[8];
    uint8_t mapq = q[9];
    uint16_t n_cigar, flag;
    memcpy(&n_cigar, q + 12, 2);
    memcpy(&flag, q + 14, 2);
    memcpy(&l_seq, q + 16, 4);
    memcpy(&mtid, q + 20, 4);
    memcpy(&mpos, q + 24, 4);
    memcpy(&tlen, q + 28, 4);
    out->flag[i] = flag;
    out->tid[i] = tid;
    out->pos[i] = pos2;
    out->mapq[i] = mapq;
    out->mtid[i] = mtid;
    out->mpos[i] = mpos;
    out->isize[i] = tlen;
    out->l_qseq[i] = l_seq;
    const uint8_t* body = q + 32;
    // lazy mode also skips qname copies for fully-mapped-pair records:
    // the streaming consumers read qnames only to pair unmapped mates
    if (!j->lazy || (flag & 0xC) != 0)
      memcpy(out->qnames + out->qname_off[i], body, l_read_name - 1);
    body += l_read_name;
    memcpy(out->cig + out->cig_off[i], body, 4 * (size_t)n_cigar);
    // the CIGAR summary, so that no consumer walks the CIGARs again
    int32_t first_op = -1, last_op = -1, first_len = 0, last_len = 0;
    int64_t span_nox = 0, span_x = 0;
    for (uint16_t k = 0; k < n_cigar; k++) {
      uint32_t c;
      memcpy(&c, body + 4 * (size_t)k, 4);
      const uint32_t op = c & 0xF, len = c >> 4;
      if (k == 0) {
        first_op = (int32_t)op;
        first_len = (int32_t)len;
      }
      last_op = (int32_t)op;
      last_len = (int32_t)len;
      if (op == 0 || op == 2 || op == 3 || op == 7)  // M D N =
        span_nox += len;
      else if (op == 8)  // X
        span_x += len;
    }
    out->first_op[i] = first_op;
    out->last_op[i] = last_op;
    out->first_len[i] = first_len;
    out->last_len[i] = last_len;
    out->span_nox[i] = (int32_t)span_nox;
    out->span_x[i] = (int32_t)(span_nox + span_x);
    bool need_seq = true;
    if (j->lazy)  // unmapped or mate-unmapped, or a soft clip at an end
      need_seq = (flag & 0xC) != 0 || first_op == 4 || last_op == 4;
    body += 4 * (size_t)n_cigar;
    if (need_seq) {
      uint8_t* sdst = out->seq + out->seq_off[i];
      const int32_t half = l_seq >> 1;
      for (int32_t k = 0; k < half; k++)
        memcpy(sdst + 2 * k, &kPairLut.v[body[k]], 2);
      if (l_seq & 1) sdst[l_seq - 1] = (uint8_t)kNt16[body[half] >> 4];
      memcpy(out->qual + out->seq_off[i], body + (l_seq + 1) / 2,
             (size_t)l_seq);
    }
    body += (l_seq + 1) / 2 + l_seq;
    out->xc[i] = (body < rend) ? aux_xc(body, rend) : 0;
  }
}

void fill_part(FillJob* j) {
  for (;;) {
    int64_t lo = j->next.fetch_add(kFillGrain);
    if (lo >= j->n) return;
    fill_rows(j, lo, std::min(lo + kFillGrain, j->n));
  }
}

void worker(Stream* s) {
  InflateCtx ctx;
  std::unique_lock<std::mutex> lk(s->mu);
  for (;;) {
    s->work_cv.wait(lk, [s] {
      return s->stopping || s->helpers_queued > 0 || !s->tasks.empty();
    });
    if (s->helpers_queued > 0) {  // the caller's fill comes first
      s->helpers_queued--;
      s->helpers_active++;
      FillJob* j = s->job;
      lk.unlock();
      fill_part(j);
      lk.lock();
      if (--s->helpers_active == 0) s->done_cv.notify_all();
      continue;
    }
    if (s->stopping) return;
    Piece* w = s->tasks.front();
    s->tasks.pop_front();
    if (w == nullptr) {
      Read* r = s->next_read;
      lk.unlock();
      read_window(s, r);
      lk.lock();
      after_read(s, r);
      continue;
    }
    lk.unlock();
    inflate_piece(w, ctx);
    lk.lock();
    w->ready = true;
    if (--w->read->pieces_left == 0) s->spare_reads.push_back(w->read);
    s->done_cv.notify_all();
  }
}

// Makes the next piece in file order the walk's current one, once it is
// inflated.  False, with s->error set, where its read failed.
bool take(Stream* s) {
  std::unique_lock<std::mutex> lk(s->mu);
  maybe_read(s);
  s->done_cv.wait(lk, [s] { return !s->ahead.empty(); });
  Piece* w = s->ahead.front();
  if (w->first) {
    // a 16 MB window of the file: ready where all its pieces are
    s->windows++;
    s->windows_ready += std::all_of(
        s->ahead.begin(), s->ahead.begin() + (ptrdiff_t)w->pieces,
        [](const Piece* p) { return p->ready; });
  }
  s->done_cv.wait(lk, [w] { return w->ready; });
  s->ahead.pop_front();
  s->ahead_bytes -= w->len;
  if (w->failed) {
    snprintf(s->error, sizeof(s->error), "%s", w->error);
    s->failed = true;
    s->spare.push_back(w);
    return false;
  }
  s->held.push_back(w);
  s->held_bytes += w->len;
  maybe_read(s);
  lk.unlock();
  if (w->last) s->at_eof = true;
  s->cur = w;
  s->off = 0;
  return true;
}

// Hands back the pieces that hold none of the unparsed bytes.
void drop_held(Stream* s) {
  std::lock_guard<std::mutex> g(s->mu);
  for (Piece* w : s->held)
    if (w != s->cur) s->spare.push_back(w);
  s->held.clear();
  s->held_bytes = 0;
  if (s->cur) {
    s->held.push_back(s->cur);
    s->held_bytes = s->cur->len;
  }
  maybe_read(s);
}

// The bytes held + ahead before a read waits: one slab's, from the bytes
// a record that the stream has seen (the last read's pieces may pass it).
void set_budget(Stream* s, int64_t max_records) {
  double slab = (double)max_records * s->seen_rec_bytes / s->seen_recs;
  std::lock_guard<std::mutex> g(s->mu);
  s->budget = slab < kPieceBytes ? kPieceBytes : (size_t)slab;
}

Set* acquire(Stream* s, bool* fresh) {
  Set* set = nullptr;
  {
    std::lock_guard<std::mutex> g(s->pool->mu);
    s->pool->out++;
    if (!s->pool->idle.empty()) {
      set = s->pool->idle.back();
      s->pool->idle.pop_back();
    }
  }
  *fresh = set == nullptr;
  if (set == nullptr) {
    set = new Set();
    set->pool = s->pool;
    set->ref_lens.fit(s->ref_lens.size() + 1);
    memcpy(set->ref_lens.p, s->ref_lens.data(), 4 * s->ref_lens.size());
    set->ref_names.fit(s->ref_names.size() + 1);
    memcpy(set->ref_names.p, s->ref_names.data(), s->ref_names.size());
  }
  memset(&set->soa, 0, sizeof(SoA));
  set->soa.n_refs = s->n_refs;
  set->soa.ref_lens = set->ref_lens.p;
  set->soa.ref_names = set->ref_names.p;
  set->soa.ref_names_len = (int64_t)s->ref_names.size();
  return set;
}

SoA* fail(Set* set, const char* msg) {
  set->soa.n = 0;
  snprintf(set->soa.error, sizeof(set->soa.error), "%s", msg);
  return &set->soa;
}

void stop(Stream* s) {
  {
    std::lock_guard<std::mutex> g(s->mu);
    s->stopping = true;
  }
  s->work_cv.notify_all();
  for (auto& t : s->workers) t.join();
  if (s->f) fclose(s->f);
  for (Piece* w : s->held) delete w;
  for (Piece* w : s->ahead) delete w;
  for (Piece* w : s->spare) delete w;
  for (Read* r : s->reads) delete r;
  bool last;
  {
    std::lock_guard<std::mutex> g(s->pool->mu);
    s->pool->closed = true;
    for (Set* set : s->pool->idle) delete set;
    s->pool->idle.clear();
    last = s->pool->out == 0;
  }
  if (last) delete s->pool;
  delete s;
}

}  // namespace

extern "C" {

// Opens path and decodes its header; null, with err256 set, on failure
// (the reference's messages).  n_threads < 1: one a core.
void* seeksv_torch_bam_open(const char* path, int n_threads, char* err256) {
  err256[0] = 0;
  FILE* f = fopen(path, "rb");
  if (!f) {
    snprintf(err256, 256, "cannot open file");
    return nullptr;
  }
  Stream* s = new Stream();
  s->f = f;
  if (n_threads < 1) n_threads = (int)std::thread::hardware_concurrency();
  s->n_threads = n_threads < 1 ? 1 : n_threads;
  s->pool = new Pool();
  for (int i = 0; i < s->n_threads; i++)
    s->workers.emplace_back(worker, s);
  // the header's bytes, copied out of the pieces as the parse needs them
  std::vector<uint8_t> hdr;
  auto have = [&](size_t need) {
    while (hdr.size() < need) {
      size_t avail = s->cur ? s->cur->len - s->off : 0;
      if (avail) {
        size_t k = std::min(need - hdr.size(), avail);
        hdr.insert(hdr.end(), s->cur->data.p + s->off,
                   s->cur->data.p + s->off + k);
        s->off += k;
      } else if (s->at_eof || !take(s)) {
        return false;
      }
    }
    return true;
  };
  const char* msg = nullptr;
  if (!have(12) || memcmp(hdr.data(), "BAM\1", 4) != 0) {
    msg = s->failed ? s->error : "bad BAM magic";
  } else {
    int32_t l_text;
    memcpy(&l_text, hdr.data() + 4, 4);
    size_t off = 8 + (size_t)l_text;
    if (!have(off + 4)) {
      msg = "";
    } else {
      memcpy(&s->n_refs, hdr.data() + off, 4);
      off += 4;
      for (int i = 0; i < s->n_refs && !msg; i++) {
        if (!have(off + 4)) {
          msg = "";
          break;
        }
        int32_t l_name;
        memcpy(&l_name, hdr.data() + off, 4);
        off += 4;
        if (!have(off + (size_t)l_name + 4)) {
          msg = "";
          break;
        }
        s->ref_names.append((const char*)hdr.data() + off, (size_t)l_name);
        off += (size_t)l_name;
        int32_t l_ref;
        memcpy(&l_ref, hdr.data() + off, 4);
        s->ref_lens.push_back(l_ref);
        off += 4;
      }
    }
    if (msg) msg = s->failed ? s->error : "truncated BAM header";
  }
  if (msg) {
    snprintf(err256, 256, "%s", msg);
    stop(s);
    return nullptr;
  }
  drop_held(s);
  return s;
}

// The next slab of up to max_records records, as seeksv_bam_next2 gives
// it; n == 0 at the end of the file, with error set on failure.
// decode_flags bit0: lazy seq/qual (fill_records').  Every result is
// handed back with seeksv_torch_bam_release.
SoA* seeksv_torch_bam_next(void* h, int64_t max_records,
                           int32_t decode_flags) {
  Stream* s = (Stream*)h;
  bool fresh;
  Set* set = acquire(s, &fresh);
  if (s->failed) return fail(set, s->error);
  s->joined.clear();
  int64_t n = 0, co = 0, so = 0, qo = 0;
  uint64_t bytes = 0;
  Arr<int64_t>* offs = set->off;
  auto grow = [&](size_t want) {
    for (int k = 0; k < 3; k++)
      if (!offs[k].fit(want, (size_t)n)) return false;
    return s->recs.fit(want, (size_t)n);
  };
  if (!grow((size_t)std::min<int64_t>(std::max<int64_t>(max_records, 0),
                                      s->last_n) + 1))
    return fail(set, "out of memory");
  // one pass: each record's place and its cigar / seq / qname offsets
  auto add = [&](const uint8_t* r) {
    if ((size_t)n + 2 > std::min(offs[0].cap, s->recs.cap) &&
        !grow(2 * (size_t)n + 2))
      return false;
    int32_t bs;
    memcpy(&bs, r, 4);
    uint8_t l_read_name = r[4 + 8];
    uint16_t n_cigar;
    memcpy(&n_cigar, r + 4 + 12, 2);
    int32_t l_seq;
    memcpy(&l_seq, r + 4 + 16, 4);
    offs[0].p[n] = co;
    offs[1].p[n] = so;
    offs[2].p[n] = qo;
    co += n_cigar;
    so += l_seq;
    qo += l_read_name - 1;
    bytes += 4 + (uint64_t)bs;
    s->recs.p[n] = r;
    n++;
    return true;
  };
  while (n < max_records) {
    const uint8_t* base = s->cur ? s->cur->data.p : nullptr;
    size_t len = s->cur ? s->cur->len : 0;
    if (!s->part.empty()) {
      // a record that began in an earlier piece: complete it from this one
      std::vector<uint8_t>& p = s->part;
      size_t k = p.size() < 4 ? std::min(4 - p.size(), len - s->off) : 0;
      p.insert(p.end(), base + s->off, base + s->off + k);
      s->off += k;
      if (p.size() >= 4) {
        int32_t bs;
        memcpy(&bs, p.data(), 4);
        if (bs < 32) return fail(set, "corrupt BAM record");
        size_t need = 4 + (size_t)bs;
        k = std::min(need - p.size(), len - s->off);
        p.insert(p.end(), base + s->off, base + s->off + k);
        s->off += k;
        if (p.size() == need) {
          s->joined.push_back(std::move(p));
          p.clear();
          if (!add(s->joined.back().data())) return fail(set, "out of memory");
          continue;
        }
      }
    } else {
      while (n < max_records && s->off + 4 <= len) {
        int32_t bs;
        memcpy(&bs, base + s->off, 4);
        if (bs < 32) return fail(set, "corrupt BAM record");
        if (s->off + 4 + (size_t)bs > len) break;
        if (!add(base + s->off)) return fail(set, "out of memory");
        s->off += 4 + (size_t)bs;
      }
      if (n >= max_records) break;
      if (s->at_eof) break;
      // the rest of this piece begins a record that the next completes
      s->part.assign(base + s->off, base + len);
      s->off = len;
    }
    if (s->at_eof) break;
    if (!take(s)) return fail(set, s->error);
  }
  if (s->at_eof && n == 0 &&
      (!s->part.empty() || (s->cur && s->off < s->cur->len)))
    return fail(set, "truncated BAM record at EOF");
  offs[0].p[n] = co;
  offs[1].p[n] = so;
  offs[2].p[n] = qo;
  size_t rows = n ? (size_t)n : 1;
  for (auto& a : set->i32)
    if (!a.fit(rows)) return fail(set, "out of memory");
  if (!set->cig.fit(co ? (size_t)co : 1) || !set->seq.fit(so ? (size_t)so : 1) ||
      !set->qual.fit(so ? (size_t)so : 1) ||
      !set->qnames.fit(qo ? (size_t)qo : 1))
    return fail(set, "out of memory");
  SoA* out = &set->soa;
  out->n = n;
  out->flag = set->i32[0].p;
  out->tid = set->i32[1].p;
  out->pos = set->i32[2].p;
  out->mapq = set->i32[3].p;
  out->mtid = set->i32[4].p;
  out->mpos = set->i32[5].p;
  out->isize = set->i32[6].p;
  out->l_qseq = set->i32[7].p;
  out->xc = set->i32[8].p;
  out->first_op = set->i32[9].p;
  out->last_op = set->i32[10].p;
  out->first_len = set->i32[11].p;
  out->last_len = set->i32[12].p;
  out->span_nox = set->i32[13].p;
  out->span_x = set->i32[14].p;
  out->cig_off = offs[0].p;
  out->seq_off = offs[1].p;
  out->qname_off = offs[2].p;
  out->cig = set->cig.p;
  out->seq = set->seq.p;
  out->qual = set->qual.p;
  out->qnames = set->qnames.p;
  out->n_cig_total = co;
  out->n_seq_total = so;
  out->n_qname_total = qo;
  if (n) {
    // the columns: the caller and the workers that are free
    FillJob job;
    job.recs = s->recs.p;
    job.out = out;
    job.n = n;
    job.lazy = decode_flags & 1;
    int64_t claims = (n + kFillGrain - 1) / kFillGrain;
    {
      std::lock_guard<std::mutex> g(s->mu);
      s->job = &job;
      s->helpers_queued = (int)std::min<int64_t>(s->n_threads, claims - 1);
    }
    s->work_cv.notify_all();
    fill_part(&job);
    {
      std::unique_lock<std::mutex> lk(s->mu);
      s->helpers_queued = 0;
      s->done_cv.wait(lk, [s] { return s->helpers_active == 0; });
      s->job = nullptr;
    }
    s->slabs++;
    s->recycled += !fresh;
    s->last_n = n;
    s->seen_recs += (uint64_t)n;
    s->seen_rec_bytes += bytes;
    set_budget(s, max_records);
  }
  drop_held(s);
  return out;
}

// Hands a slab's set back to its stream's pool (freed where the stream
// has closed).
void seeksv_torch_bam_release(SoA* h) {
  if (!h) return;
  Set* set = reinterpret_cast<Set*>(h);
  Pool* p = set->pool;
  bool last;
  {
    std::lock_guard<std::mutex> g(p->mu);
    p->out--;
    if (!p->closed) {
      p->idle.push_back(set);
      return;
    }
    last = p->out == 0;
  }
  delete set;
  if (last) delete p;
}

// The stream's counts: slabs, slabs whose set an earlier slab had handed
// back, 16 MB windows the walk reached, and those of them whose pieces
// were all inflated by then.
void seeksv_torch_bam_counts(void* h, int64_t* out4) {
  Stream* s = (Stream*)h;
  out4[0] = s->slabs;
  out4[1] = s->recycled;
  std::lock_guard<std::mutex> g(s->mu);
  out4[2] = s->windows;
  out4[3] = s->windows_ready;
}

void seeksv_torch_bam_close(void* h) {
  if (h) stop((Stream*)h);
}

}  // extern "C"
