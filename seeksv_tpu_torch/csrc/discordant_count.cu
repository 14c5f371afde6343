// Windowed discordant-read-pair count per junction (K6).
//
// Replaces: seeksv_tpu/ops/jax_kernels.py:discordant_count_batch, an XLA
// program on the TPU: each junction's window [lo, min(hi, lo +
// window_cap)) over the coordinate-sorted record columns is gathered into
// a [J, window_cap] tile and reduced (FindDiscordantReadPairs,
// getsv.cpp:990-1120; host form pipeline/getsv.py:DiscordantCounter).
//
// Per record of the window: base_ok, end > beg, mate on the junction's
// down chromosome, then the junction's case (0 = +/+, 1 = -/+, 2 = +/-)
// tests the orientation and the insert size; +/+ on one chromosome with
// up > down and period + 2 l <= max_ins is the tandem-duplication form,
// whose modular insert-size loop (getsv.cpp:1081-1091) is the closed
// form ins + k0 * period <= max_ins, k0 = max(0, ceil((min_ins - ins) /
// period)).  A case code outside 0..2 counts nothing.  Indices past the
// record range clamp to it, as the reference's gather does.
//
// Layout (ops/discordant.py):
// - the records are the uploaded columns, read where they lie: pos, end,
//   mpos int64; lq, mtid int32; fwd, mfwd, base_ok uint8.
// - the junctions are one tensor jun [8, J] int64, a row per field, packed
//   on the host where the junctions are built (pack_junctions: eight
//   contiguous copies) and uploaded once: lo, hi, beg, up_pos, down_pos,
//   min_ins, max_ins, and a word holding down_tid (low 32 bits), the case
//   code (2 bits; 3 for a code outside 0..2) and same_tid (bit 34).
// Positions are int64 (the host counter's width; the TPU ran int32).  The
// ceiling is written for a signed numerator: C++ division truncates
// toward zero where JAX's // floors.
//
// What bounds it on the H100: the bytes of the records the windows hold,
// once each (neighbouring windows barely overlap: the flagship's 6,038
// windows visit 881,358 records, 880,529 distinct): 13 bytes a record for
// the tests every junction makes first (base_ok, end, mtid), 22 more for
// a record that passes them.  A call is a few MB, so the kernel is a few
// microseconds and what limits the call as the pipeline makes it is its
// host side: the uploads and the wrapper's checks (PERF.md, Findings).
//
// What the design does about it: a warp per junction, lanes striding over
// the window two records a step; both records' three head values are
// loaded together, then both tails where the heads passed (the first
// kernel loaded a record's values test by test, each load waiting on the
// one before).  The junctions are one tensor, so the pipeline uploads one
// tensor for them and the wrapper checks nine tensors (the first kernel's:
// ten uploads, 18 checks).  Designs built and timed on the card before this
// one and left out (PERF.md, Findings): a block of 8 warps loading its
// windows' union into shared memory (no faster: the windows barely
// overlap and L2 serves what they share); the records packed on the card
// into one 32-byte row each by a second kernel (the count faster, but the
// packing cost more than it saved, each record being read about once a
// call); all eight values of a record loaded before any test (as fast
// warm, more bytes cold).  An empty window (lo >= hi), a case code
// outside 0..2 and R = 0 count 0.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr long long kCross = 5;   // kCrossLength, getsv.cpp:15
constexpr int kWarps = 8;         // junctions a block, a warp each
constexpr int kThreads = 32 * kWarps;
constexpr int kNone = 3;          // case code that counts nothing
constexpr unsigned kFull = 0xffffffffu;

struct Columns {
  const long long *pos, *end, *mpos;
  const int *lq, *mtid;
  const uint8_t *fwd, *mfwd, *base_ok;
};

struct Record {
  long long p, e, mp;
  int ln, mt;
  uint8_t fw, mf, ok;
};

struct Junction {
  long long lo, n, beg, up, dn, mini, maxi, period, step;
  int dtid, code;
  bool stid;
};

__device__ __forceinline__ long long ceil_div(long long a, long long b) {
  // b >= 1
  return a >= 0 ? (a + b - 1) / b : -((-a) / b);
}

__device__ __forceinline__ long long clamp_index(long long i, long long R) {
  return i < 0 ? 0 : (i >= R ? R - 1 : i);
}

// junction j's fields, field k at jun[k * nj + j]
__device__ __forceinline__ Junction load_junction(const long long* jun,
                                                  long long nj, long long j,
                                                  long long R,
                                                  long long window_cap) {
  Junction J;
  J.lo = jun[j];
  long long n = jun[nj + j] - J.lo;
  if (n > window_cap) n = window_cap;
  J.beg = jun[2 * nj + j];
  J.up = jun[3 * nj + j];
  J.dn = jun[4 * nj + j];
  J.mini = jun[5 * nj + j];
  J.maxi = jun[6 * nj + j];
  const long long meta = jun[7 * nj + j];
  J.dtid = (int)(unsigned)(meta & 0xffffffffLL);
  J.code = (int)((meta >> 32) & 3);
  J.stid = ((meta >> 34) & 1) != 0;
  J.n = (R > 0 && J.code != kNone && n > 0) ? n : 0;
  J.period = J.up - J.dn + 1;
  J.step = J.period > 1 ? J.period : 1;
  return J;
}

// the three values of record i that every junction tests first
__device__ __forceinline__ void load_head(const Columns& c, long long i,
                                          Record& r) {
  r.ok = __ldg(c.base_ok + i);
  r.e = __ldg(c.end + i);
  r.mt = __ldg(c.mtid + i);
}

// the other five, read only for a record that passed the first tests
__device__ __forceinline__ void load_tail(const Columns& c, long long i,
                                          Record& r) {
  r.p = __ldg(c.pos + i);
  r.mp = __ldg(c.mpos + i);
  r.ln = __ldg(c.lq + i);
  r.fw = __ldg(c.fwd + i);
  r.mf = __ldg(c.mfwd + i);
}

__device__ __forceinline__ bool head_passes(const Junction& J,
                                            const Record& r) {
  return r.ok && r.mt == J.dtid && r.e > J.beg;
}

// the rest of the tests, on a record whose head passed
__device__ __forceinline__ int hit(const Junction& J, const Record& r) {
  // the orientation as a case: 0 forward read / reverse mate, 1 both
  // reverse, 2 both forward, 3 (reverse read, forward mate) none
  const int o = (r.fw ? 0 : 1) + (r.mf ? 2 : 0);
  if (o != J.code) return 0;
  const long long p = r.p, mp = r.mp, ln = r.ln;
  if (J.code == 0) {
    if (p + ln > J.up + kCross || mp + 1 < J.dn - kCross) return 0;
    const long long ins = J.up - p + mp + ln - J.dn + 1;
    if (J.stid && J.up > J.dn && J.period + 2 * ln <= J.maxi) {
      long long k0 = ceil_div(J.mini - ins, J.step);
      if (k0 < 0) k0 = 0;
      return ins + k0 * J.period <= J.maxi;
    }
    return J.mini <= ins && ins <= J.maxi;
  }
  if (J.code == 1) {
    const long long ins = p + 1 - J.up + 1 + mp + ln - J.dn + 1;
    return mp + 1 >= J.dn - kCross && J.mini <= ins && ins <= J.maxi;
  }
  const long long ins = J.up - p + J.dn - (mp + ln) + 1;
  return p + ln <= J.up + kCross && mp + ln <= J.dn + kCross &&
         J.mini <= ins && ins <= J.maxi;
}

__global__ void __launch_bounds__(kThreads) discordant_count_kernel(
    Columns c, long long R, const long long* __restrict__ jun, int J,
    long long window_cap, int* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int j = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (j >= J) return;   // warp-uniform
  const Junction w = load_junction(jun, J, j, R, window_cap);
  int cnt = 0;
  // two records a lane a step: both heads' loads in flight together, then
  // both tails' where the heads passed
  long long v = lane;
  for (; v + 32 < w.n; v += 64) {
    const long long ia = clamp_index(w.lo + v, R);
    const long long ib = clamp_index(w.lo + v + 32, R);
    Record a, b;
    load_head(c, ia, a);
    load_head(c, ib, b);
    const bool pa = head_passes(w, a), pb = head_passes(w, b);
    if (pa) load_tail(c, ia, a);
    if (pb) load_tail(c, ib, b);
    cnt += (pa ? hit(w, a) : 0) + (pb ? hit(w, b) : 0);
  }
  if (v < w.n) {
    const long long i = clamp_index(w.lo + v, R);
    Record a;
    load_head(c, i, a);
    if (head_passes(w, a)) {
      load_tail(c, i, a);
      cnt += hit(w, a);
    }
  }
  for (int o = 16; o > 0; o >>= 1) cnt += __shfl_xor_sync(kFull, cnt, o);
  if (lane == 0) out[j] = cnt;
}

}  // namespace

// Record columns [R]: pos, end, mpos int64; lq, mtid int32; fwd, mfwd,
// base_ok uint8 (0 / 1).  jun [8, J] int64 as the header says.  Writes
// out [J] int32.
extern "C" int seeksv_discordant_count(
    const long long* pos, const long long* end, const int* lq,
    const long long* mpos, const int* mtid, const uint8_t* fwd,
    const uint8_t* mfwd, const uint8_t* base_ok, long long R,
    const long long* jun, int J, long long window_cap, int* out,
    void* stream) {
  if (J <= 0) return 0;
  if (R < 0 || window_cap < 0) return static_cast<int>(cudaErrorInvalidValue);
  const Columns c{pos, end, mpos, lq, mtid, fwd, mfwd, base_ok};
  const unsigned blocks = (unsigned)((J + kWarps - 1) / kWarps);
  discordant_count_kernel<<<blocks, kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      c, R, jun, J, window_cap, out);
  return static_cast<int>(cudaGetLastError());
}
