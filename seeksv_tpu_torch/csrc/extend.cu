// Anchored affine-gap extension (ksw_extend semantics), in two entries
// that share one recurrence:
//
// - resident: the query is nibble-packed and the target is read straight
//   from the nibble-packed genome kept on the card;
// - windows: the query and target windows are [B, LQ] / [B, LT] uint8
//   code tensors already on the card (the device front-end gathers them).
//
// Replaces: seeksv_tpu/ops/pallas_sw.py:_extend_kernel (the Pallas TPU
// kernel), entered through pallas_extend_batch_resident, together with
// its _unpack_nibbles and _gather_ref_windows, which on the TPU build a
// [B, LT] window tensor in HBM before the kernel runs (resident), and
// through pallas_extend_batch, which pads the batch to 128 lanes, a TPU
// layout and not semantics (windows).
//
// What bounds it on the H100: integer operations.  A job is qlen x rows
// cells (rows: until tlen or z-drop ends it) that need nine int32
// instructions each at the least, a fused add + max counted as one (two
// more on the rows that raise the best, for the first-occurrence argmax),
// and device memory traffic is tiny (the query once, one target
// code per row, 5 ints out), so the least time is the cells' operations
// over the card's 132 SMs x 64 int32 lanes.  What stands between a kernel
// and that bound is (a) cells that do not exist (a block sized to the
// batch's bucket LQ computes LQ cells a row whatever the job's qlen),
// (b) per-row overhead that is not cell work (barriers, scans over shared
// memory, serial reductions) on a chain of up to LT dependent rows, and
// (c) instructions per cell.
//
// What the design does about it:
// - One warp per job, and the cells a lane holds (C = 4, 8, 16 or 32) come
//   from the job's own qlen: jobs are binned by qlen on the device
//   (ops/extend.py:plan_bins: qlen <= 128, 256, 512, 1024), each bin is
//   one launch of the kernel compiled for its C, and inside a bin the jobs
//   are ordered by falling qlen x tlen so that the longest start first.
//   Every block finds its job through that order and writes its results
//   at the job's own index.  A query longer than 1024 runs in the widest
//   shape in several passes a row, its H and E rows kept in shared
//   memory between passes.
// - No block barrier and no shared array on the row chain: H, E and the
//   packed query live in registers, the row's exclusive prefix max is a
//   per-lane scan plus five shuffles, the row's best and its first
//   occurrence are two warp reductions (redux.sync), the latter only on
//   rows that improve the best.  18,000 independent jobs are far more
//   than the warps the card holds at once, so other jobs hide a row's
//   latency.
// - DPX (__viaddmax_s32) for the max(a + b, c) chains: E, max(diag, E),
//   both prefix-max scans.
// - Loads: a lane fetches the target codes of 32 rows at once (one
//   coalesced load every 32 rows) and the row's code is broadcast by
//   shuffle; the query is read once, 8 nibble codes a register.  The
//   resident target code comes straight from the nibble-packed genome
//   (code 4 off the genome), so no window tensor is ever built.
// - Cells past qlen are computed only up to the end of the lane's C
//   cells and masked out of the row's best; nothing flows from them into
//   a cell that exists (the recurrence reads left, up and up-left).
// A job stops as soon as it is inactive (i >= tlen or z-dropped); the
// reference freezes it instead, which gives the same result because
// inactivity never ends.  A job with tlen = 0 or qlen = 0 (most slots of a
// device-front-end chunk) writes its result and leaves at once.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMatch = 1;
constexpr int kMismatch = 4;
constexpr int kGapOpen = 6;
constexpr int kGapExt = 1;
constexpr int kAmbig = -1;
constexpr int kNegInf = -0x10000000;  // pallas_sw.NEG_INF
constexpr int kZdrop = 100;
constexpr int kBig = 0x7FFFFFFF;
constexpr unsigned kFull = 0xFFFFFFFFu;
// The bins' upper query lengths, 32 lanes x C cells each; a longer query
// runs in the widest shape in several passes.  ops/extend.py's BIN_EDGES
// must say the same (it asks seeksv_extend_bin_edge).
constexpr int kEdges[] = {128, 256, 512, 1024};
constexpr int kBins = sizeof(kEdges) / sizeof(kEdges[0]) + 1;
constexpr int kWidest = kEdges[kBins - 2] / 32;  // cells a lane, widest shape
static_assert(kBins == 5 && kEdges[0] == 32 * 4 && kEdges[1] == 32 * 8 &&
                  kEdges[2] == 32 * 16 && kEdges[3] == 32 * 32,
              "launch() instantiates C = 4, 8, 16, 32");
static_assert(kGapExt == 1, "the lane-relative prefix max assumes 1");

// Where a job's codes come from.  Resident: q is the nibble-packed query
// [B, ceil(LQ/2)], t the nibble-packed genome of n_codes codes, and
// tstart the genome index of the window's first element in scan order
// (reverse: left extensions walk backwards).  Windows: q is [B, LQ] and t
// is [B, LT], one code per byte; tstart, n_codes and reverse are unused.
template <bool kWindows>
struct Codes {
  const uint8_t* q;
  const uint8_t* t;
  const int* tstart;
  long long n_codes;
  int LQ, LT, reverse;

  // The 8 query codes from 0-based cell c0 (a multiple of 4; of 8 unless
  // only 4 are asked for) of job b as nibbles, cell c0 lowest; code 4
  // past LQ.  n = 4 fills the low half only.
  __device__ __forceinline__ uint32_t query8(int b, int c0, int n) const {
    if (c0 >= LQ) return 0x44444444u;
    if constexpr (kWindows) {
      const uint8_t* p = q + (size_t)b * LQ + c0;
      uint32_t w = 0;
      for (int k = 0; k < n; ++k) {
        const uint32_t c = (c0 + k < LQ) ? p[k] : 4u;
        w |= (c > 3u ? 4u : c) << (4 * k);
      }
      return w;
    } else {
      const uint8_t* p = q + (size_t)b * ((LQ + 1) >> 1) + (c0 >> 1);
      if (n == 4) return *reinterpret_cast<const uint16_t*>(p);
      return *reinterpret_cast<const uint32_t*>(p);
    }
  }

  // target code at 0-based row i of job b (the caller keeps i < LT)
  __device__ __forceinline__ int target(int b, int i) const {
    if constexpr (kWindows) return t[(size_t)b * LT + i];
    const long long start = tstart[b];
    const long long pos = reverse ? start - i : start + i;
    if (pos < 0 || pos >= n_codes) return 4;
    const uint8_t byte = t[pos >> 1];
    return (pos & 1) ? (byte >> 4) : (byte & 0xF);
  }
};

// One warp (one block of 32 threads) per job.  Block x of the launch for
// bin `which` takes the job order[seg[which] + x] if that slot is below
// seg[which + 1], else leaves.  Lane l of pass p owns the C query cells
// j = (p * 32 + l) * C + 1 .. + C (1-based).  kMulti: the job's cells
// take several passes a row (qlen > 32 * C) and H, E and the query words
// of the passes live in dynamic shared memory, [pass][k][lane].
template <int C, bool kWindows, bool kMulti>
__global__ void __launch_bounds__(32)
extend_kernel(Codes<kWindows> src, const int* __restrict__ qlen,
              const int* __restrict__ tlen, const int* __restrict__ h0,
              const int* __restrict__ order, const int* __restrict__ seg,
              int which, int B, int* __restrict__ out) {
  constexpr int W = (C + 7) / 8;  // query words a lane
  extern __shared__ int smem[];

  const int slot = seg[which] + blockIdx.x;
  if (slot >= seg[which + 1]) return;
  const int b = order[slot];
  const int lane = threadIdx.x;
  // A qlen past the bucket LQ has LQ cells and no cell "qlen": its gscore
  // stays NEG_INF, as in the plain version.
  const bool past_lq = qlen[b] > src.LQ;
  const int m = min(qlen[b], src.LQ);
  const int tl = tlen[b];
  const int hz = h0[b];
  const int nrow = min(tl, src.LT);
  if (nrow <= 0 || m <= 0) {
    // no target row: the initial state is final.  No query cell: the
    // first row's best is NEG_INF, which z-drops, and H at "qlen" is
    // column 0 of that row.
    if (lane == 0) {
      const bool row = nrow > 0 && hz - kGapOpen - kGapExt > kNegInf;
      out[b] = hz;
      out[B + b] = 0;
      out[2 * B + b] = 0;
      out[3 * B + b] = row ? hz - kGapOpen - kGapExt : kNegInf;
      out[4 * B + b] = row ? 1 : 0;
    }
    return;
  }
  const int npass = kMulti ? (m + 32 * C - 1) / (32 * C) : 1;
  const int lane_m = ((m - 1) % (32 * C)) / C;  // lane of cell m, last pass
  int* const hs = smem;                     // [npass][C][32]
  int* const es = hs + npass * C * 32;      // [npass][C][32]
  uint32_t* const qs = reinterpret_cast<uint32_t*>(es + npass * C * 32);

  int h[C], e[C];
  uint32_t qw[W];
  for (int p = 0; p < npass; ++p) {
    const int jb = (p * 32 + lane) * C;  // cell k of the lane is j = jb+1+k
#pragma unroll
    for (int w = 0; w < W; ++w) qw[w] = src.query8(b, jb + 8 * w, C < 8 ? C : 8);
#pragma unroll
    for (int k = 0; k < C; ++k) {
      const int j = jb + 1 + k;
      const int row0 = hz - kGapOpen - j * kGapExt;
      h[k] = (row0 >= 0 && j <= m) ? row0 : kNegInf;
      e[k] = kNegInf;
    }
    if constexpr (kMulti) {
#pragma unroll
      for (int k = 0; k < C; ++k) {
        hs[(p * C + k) * 32 + lane] = h[k];
        es[(p * C + k) * 32 + lane] = e[k];
      }
#pragma unroll
      for (int w = 0; w < W; ++w) qs[(p * W + w) * 32 + lane] = qw[w];
    }
  }

  int h_first = hz;  // H[i-1][0] seen from row i
  int best = hz, qle = 0, tle = 0, gscore = kNegInf, gtle = 0;
  int tvec = 4;
  for (int i = 0; i < nrow; ++i) {
    if ((i & 31) == 0) tvec = (i + lane < nrow) ? src.target(b, i + lane) : 4;
    const int tc = __shfl_sync(kFull, tvec, i & 31);
    const int tcm = tc > 3 ? 99 : tc;  // an ambiguous target matches nothing
    const int mis = tc > 3 ? kAmbig : -kMismatch;

    int carry = kNegInf;   // prefix max of g + j over the passes before
    int diag_in = h_first; // H[i-1][j-1] for the pass's first cell
    int rb = kNegInf, ra = kBig, hq = kNegInf;
    for (int p = 0; p < npass; ++p) {
      const int jb = (p * 32 + lane) * C;
      if constexpr (kMulti) {
#pragma unroll
        for (int k = 0; k < C; ++k) {
          h[k] = hs[(p * C + k) * 32 + lane];
          e[k] = es[(p * C + k) * 32 + lane];
        }
#pragma unroll
        for (int w = 0; w < W; ++w) qw[w] = qs[(p * W + w) * 32 + lane];
      }
      int prev = __shfl_up_sync(kFull, h[C - 1], 1);
      if (lane == 0) prev = diag_in;
      if constexpr (kMulti) diag_in = __shfl_sync(kFull, h[C - 1], 31);

      // g = max(diag, E) into h[k]; run = max over the lane of g + k
      int run = kNegInf;
#pragma unroll
      for (int k = 0; k < C; ++k) {
        const int qc = (qw[k >> 3] >> (4 * (k & 7))) & 0xF;
        const int s = (qc == tcm) ? kMatch : (qc > 3 ? kAmbig : mis);
        const int ec = __viaddmax_s32(h[k], -kGapOpen, e[k]) - kGapExt;
        const int g = __viaddmax_s32(prev, s, ec);
        prev = h[k];
        e[k] = ec;
        h[k] = g;
        run = __viaddmax_s32(g, k, run);
      }
      // exclusive prefix max of g + j across the lanes (and the passes)
      int incl = run + jb + 1;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        // a lane below o gets its own value back: max leaves it as it is
        incl = max(incl, __shfl_up_sync(kFull, incl, o));
      }
      int excl = __shfl_up_sync(kFull, incl, 1);
      if (lane == 0) excl = kNegInf;
      excl = max(excl, carry);
      if constexpr (kMulti) carry = max(carry, __shfl_sync(kFull, incl, 31));

      // H = max(g, F), F from the prefix max; the lane's best over the
      // cells that exist (k < nv), first occurrence
      int run2 = excl - (jb + 1);
      const int nv = m - jb;
      int rbc = kNegInf, rak = 0;
#pragma unroll
      for (int k = 0; k < C; ++k) {
        const int f = run2 - (kGapOpen + k);
        const int hr = max(h[k], f);
        run2 = __viaddmax_s32(h[k], k, run2);
        h[k] = hr;
        const bool valid = k < nv;
        const int hm = valid ? hr : kNegInf;
        hq = valid ? hr : hq;
        const bool keep = rbc >= hm;  // strict: first occurrence
        rbc = max(rbc, hm);
        rak = keep ? rak : k;
      }
      if (rbc > rb) {  // passes hold ascending j
        rb = rbc;
        ra = jb + 1 + rak;
      }
      if constexpr (kMulti) {
#pragma unroll
        for (int k = 0; k < C; ++k) {
          hs[(p * C + k) * 32 + lane] = h[k];
          es[(p * C + k) * 32 + lane] = e[k];
        }
      }
    }

    const int row_best = __reduce_max_sync(kFull, rb);
    const int h_at_qlen = __shfl_sync(kFull, hq, lane_m);
    if (row_best > best) {
      best = row_best;
      qle = __reduce_min_sync(kFull, rb == row_best ? ra : kBig);
      tle = i + 1;
    }
    if (h_at_qlen > gscore && !past_lq) {
      gscore = h_at_qlen;
      gtle = i + 1;
    }
    h_first = hz - kGapOpen - (i + 1) * kGapExt;
    if (row_best < best - kZdrop) break;  // z-drop: the job is frozen
  }
  if (lane == 0) {
    out[b] = best;
    out[B + b] = qle;
    out[2 * B + b] = tle;
    out[3 * B + b] = gscore;
    out[4 * B + b] = gtle;
  }
}

template <int C, bool kWindows, bool kMulti>
cudaError_t launch_bin(Codes<kWindows> src, const int* qlen, const int* tlen,
                       const int* h0, const int* order, const int* seg,
                       int which, int B, int* out, cudaStream_t stream) {
  size_t shared = 0;
  if (kMulti) {
    // H, E and the query words of every pass of the longest query
    const int npass = (src.LQ + 32 * C - 1) / (32 * C);
    shared = (size_t)npass * 32 * (2 * C + (C + 7) / 8) * sizeof(int);
    const cudaError_t rc = cudaFuncSetAttribute(
        extend_kernel<C, kWindows, kMulti>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shared);
    if (rc != cudaSuccess) return rc;
  }
  extend_kernel<C, kWindows, kMulti><<<B, 32, shared, stream>>>(
      src, qlen, tlen, h0, order, seg, which, B, out);
  return cudaGetLastError();
}

// One launch per bin that a query of the bucket LQ can fall into, widest
// first (order holds the bins in that order: seg[0] is the bin of queries
// past 1024, seg[4] the bin of qlen <= 128).
template <bool kWindows>
cudaError_t launch(Codes<kWindows> src, const int* qlen, const int* tlen,
                   const int* h0, const int* order, const int* seg, int B,
                   int* out, cudaStream_t stream) {
  cudaError_t rc = cudaSuccess;
  if (src.LQ > kEdges[3])
    rc = launch_bin<kWidest, kWindows, true>(src, qlen, tlen, h0, order, seg,
                                             0, B, out, stream);
  if (rc == cudaSuccess && src.LQ > kEdges[2])
    rc = launch_bin<32, kWindows, false>(src, qlen, tlen, h0, order, seg, 1,
                                         B, out, stream);
  if (rc == cudaSuccess && src.LQ > kEdges[1])
    rc = launch_bin<16, kWindows, false>(src, qlen, tlen, h0, order, seg, 2,
                                         B, out, stream);
  if (rc == cudaSuccess && src.LQ > kEdges[0])
    rc = launch_bin<8, kWindows, false>(src, qlen, tlen, h0, order, seg, 3,
                                        B, out, stream);
  if (rc == cudaSuccess)
    rc = launch_bin<4, kWindows, false>(src, qlen, tlen, h0, order, seg, 4, B,
                                        out, stream);
  return rc;
}

}  // namespace

// The number of bins `order` and `seg` (kBins + 1 offsets) must describe.
extern "C" int seeksv_extend_bins() { return kBins; }

// The upper query length of bin i (0 the narrowest), -1 for the last bin
// (longer queries) and out of range.
extern "C" int seeksv_extend_bin_edge(int i) {
  return (i >= 0 && i < kBins - 1) ? kEdges[i] : -1;
}

extern "C" int seeksv_extend_resident(const uint8_t* q4, const int* qlen,
                                      const int* tstart, const int* tlen,
                                      const int* h0, const uint8_t* refp,
                                      long long n_codes, int B, int LQ,
                                      int LT, int reverse, const int* order,
                                      const int* seg, int* out,
                                      void* stream) {
  if (B == 0) return 0;
  const Codes<false> src{q4, refp, tstart, n_codes, LQ, LT, reverse};
  return static_cast<int>(launch(src, qlen, tlen, h0, order, seg, B, out,
                                 static_cast<cudaStream_t>(stream)));
}

extern "C" int seeksv_extend_windows(const uint8_t* q, const int* qlen,
                                     const uint8_t* t, const int* tlen,
                                     const int* h0, int B, int LQ, int LT,
                                     const int* order, const int* seg,
                                     int* out, void* stream) {
  if (B == 0) return 0;
  const Codes<true> src{q, t, nullptr, 0, LQ, LT, 0};
  return static_cast<int>(launch(src, qlen, tlen, h0, order, seg, B, out,
                                 static_cast<cudaStream_t>(stream)));
}

extern "C" const char* seeksv_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
