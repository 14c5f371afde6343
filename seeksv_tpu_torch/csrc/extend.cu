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
// What bounds it on the H100: latency of the row recurrence.  Each job
// walks up to LT target rows in order, and every row needs an exact
// prefix max over the query cells plus a first-occurrence argmax, so a
// row is two block-wide barriers deep.  Device memory traffic is tiny
// (the query once, one target byte per row, 5 ints out).
//
// What the design does about it: one block per job, so the 132 SMs run
// many independent jobs at once and hide each other's barrier latency.
// The C query cells of a thread and their H/E values live in registers
// (C = 4 at LQ 1024: 256 threads); the row's exclusive prefix max is a
// per-thread scan, a warp-shuffle scan and a scan over at most 32 warp
// totals in shared memory.  The resident target code is read straight
// from the nibble-packed genome (code 4 off the genome), so no window
// tensor is ever built.  A job stops as soon as it is inactive (i >= tlen
// or z-dropped); the reference freezes it instead, which gives the same
// result because inactivity never ends.  A job with tlen = 0 (most slots
// of a device-front-end chunk) leaves before its first barrier.
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

__device__ __forceinline__ int sub_score(int qc, int tc) {
  return (qc > 3 || tc > 3) ? kAmbig : (qc == tc ? kMatch : -kMismatch);
}

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

  // query code at 1-based cell j of job b
  __device__ __forceinline__ int query(int b, int j) const {
    if constexpr (kWindows) return q[(size_t)b * LQ + (j - 1)];
    const uint8_t byte = q[(size_t)b * ((LQ + 1) >> 1) + ((j - 1) >> 1)];
    return ((j - 1) & 1) ? (byte >> 4) : (byte & 0xF);
  }

  // target code at 0-based row i of job b
  __device__ __forceinline__ int target(int b, int i) const {
    if constexpr (kWindows) return t[(size_t)b * LT + i];
    const long long start = tstart[b];
    const long long pos = reverse ? start - i : start + i;
    if (pos < 0 || pos >= n_codes) return 4;
    const uint8_t byte = t[pos >> 1];
    return (pos & 1) ? (byte >> 4) : (byte & 0xF);
  }
};

// blockDim.x = LQ / C threads (a multiple of 32, at most 1024); thread t
// owns query cells j = t*C + 1 .. t*C + C (1-based).
template <int C, bool kWindows>
__global__ void extend_kernel(Codes<kWindows> src,
                              const int* __restrict__ qlen,
                              const int* __restrict__ tlen,
                              const int* __restrict__ h0, int B,
                              int* __restrict__ out) {
  __shared__ int s_bound[32];  // last H of each warp, previous row
  __shared__ int s_tot[32];    // warp totals of the prefix-max input
  __shared__ int s_best[32];
  __shared__ int s_arg[32];
  __shared__ int s_hq;         // H at j == qlen

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  const int m = qlen[b];
  const int tl = tlen[b];
  const int hz = h0[b];
  const int j0 = tid * C + 1;
  if (tl <= 0 || src.LT <= 0) {  // no target row: the initial state is final
    if (tid == 0) {
      out[b] = hz;
      out[B + b] = 0;
      out[2 * B + b] = 0;
      out[3 * B + b] = kNegInf;
      out[4 * B + b] = 0;
    }
    return;  // uniform across the block: before any barrier
  }

  int qc[C], h[C], e[C], g[C], u_inc[C];
#pragma unroll
  for (int k = 0; k < C; ++k) {
    const int j = j0 + k;
    qc[k] = src.query(b, j);
    const int row0 = hz - kGapOpen - j * kGapExt;
    h[k] = (row0 >= 0 && j <= m) ? row0 : kNegInf;
    e[k] = kNegInf;
  }
  int h_first = hz;  // H[i-1][0] seen from row i
  int best = hz, qle = 0, tle = 0, gscore = kNegInf, gtle = 0;
  if (lane == 31) s_bound[warp] = h[C - 1];
  __syncthreads();

  for (int i = 0; i < src.LT && i < tl; ++i) {
    const int tc = src.target(b, i);
    // H[i-1][j-1] for the first cell: the left neighbour's last cell
    int left = __shfl_up_sync(kFull, h[C - 1], 1);
    if (lane == 0) left = (warp == 0) ? h_first : s_bound[warp - 1];

    int prev_h = left;
    int run = kNegInf;
#pragma unroll
    for (int k = 0; k < C; ++k) {
      const int j = j0 + k;
      const int diag = prev_h + sub_score(qc[k], tc);
      prev_h = h[k];
      const int ec = max(h[k] - kGapOpen, e[k]) - kGapExt;
      e[k] = ec;
      g[k] = max(diag, ec);
      run = max(run, g[k] + j * kGapExt);
      u_inc[k] = run;
    }
    // exclusive prefix max of the thread totals across the block
    int incl = run;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int v = __shfl_up_sync(kFull, incl, o);
      if (lane >= o) incl = max(incl, v);
    }
    int carry = __shfl_up_sync(kFull, incl, 1);
    if (lane == 0) carry = kNegInf;
    if (lane == 31) s_tot[warp] = incl;
    __syncthreads();
    for (int w = 0; w < warp; ++w) carry = max(carry, s_tot[w]);

    int rb = kNegInf, ra = kBig;
#pragma unroll
    for (int k = 0; k < C; ++k) {
      const int j = j0 + k;
      const int pref = (k == 0) ? carry : max(carry, u_inc[k - 1]);
      const int f = pref - kGapOpen - j * kGapExt;
      const bool valid = j <= m;
      const int hr = valid ? max(g[k], f) : kNegInf;
      h[k] = hr;
      if (!valid) e[k] = kNegInf;
      if (hr > rb) {  // strict: first occurrence within the thread
        rb = hr;
        ra = j;
      }
      if (j == m) s_hq = hr;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const int ob = __shfl_down_sync(kFull, rb, o);
      const int oa = __shfl_down_sync(kFull, ra, o);
      if (ob > rb || (ob == rb && oa < ra)) {
        rb = ob;
        ra = oa;
      }
    }
    if (lane == 0) {
      s_best[warp] = rb;
      s_arg[warp] = ra;
    }
    if (lane == 31) s_bound[warp] = h[C - 1];
    __syncthreads();

    int row_best = s_best[0], row_arg = s_arg[0];
    for (int w = 1; w < nwarps; ++w) {
      if (s_best[w] > row_best) {  // warps hold ascending j
        row_best = s_best[w];
        row_arg = s_arg[w];
      }
    }
    const int h0_col = hz - kGapOpen - (i + 1) * kGapExt;
    const int h_at_qlen = (m == 0) ? h0_col : s_hq;
    if (row_best > best) {
      best = row_best;
      qle = row_arg;
      tle = i + 1;
    }
    if (h_at_qlen > gscore) {
      gscore = h_at_qlen;
      gtle = i + 1;
    }
    h_first = h0_col;
    if (row_best < best - kZdrop) break;  // z-drop: the job is frozen
  }
  if (tid == 0) {
    out[b] = best;
    out[B + b] = qle;
    out[2 * B + b] = tle;
    out[3 * B + b] = gscore;
    out[4 * B + b] = gtle;
  }
}

template <int C, bool kWindows>
cudaError_t launch_c(Codes<kWindows> src, const int* qlen, const int* tlen,
                     const int* h0, int B, int* out, cudaStream_t stream) {
  extend_kernel<C, kWindows><<<B, src.LQ / C, 0, stream>>>(src, qlen, tlen,
                                                            h0, B, out);
  return cudaGetLastError();
}

// Cells per thread for a query bucket LQ: the smallest power of two that
// keeps the block at <= 256 threads (<= 1024 for very long queries) with
// a whole number of warps.  0 when no such choice exists.
int cells_per_thread(int LQ) {
  for (int limit = 256; limit <= 1024; limit *= 4) {
    for (int c = 1; c <= 16; c *= 2) {
      if (LQ % (32 * c) == 0 && LQ / c <= limit) return c;
    }
  }
  return 0;
}

template <bool kWindows>
cudaError_t launch(Codes<kWindows> src, const int* qlen, const int* tlen,
                   const int* h0, int B, int* out, cudaStream_t stream) {
  switch (cells_per_thread(src.LQ)) {
    case 1: return launch_c<1>(src, qlen, tlen, h0, B, out, stream);
    case 2: return launch_c<2>(src, qlen, tlen, h0, B, out, stream);
    case 4: return launch_c<4>(src, qlen, tlen, h0, B, out, stream);
    case 8: return launch_c<8>(src, qlen, tlen, h0, B, out, stream);
    case 16: return launch_c<16>(src, qlen, tlen, h0, B, out, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int seeksv_extend_cells_per_thread(int LQ) {
  return cells_per_thread(LQ);
}

extern "C" int seeksv_extend_resident(const uint8_t* q4, const int* qlen,
                                      const int* tstart, const int* tlen,
                                      const int* h0, const uint8_t* refp,
                                      long long n_codes, int B, int LQ,
                                      int LT, int reverse, int* out,
                                      void* stream) {
  if (B == 0) return 0;
  const Codes<false> src{q4, refp, tstart, n_codes, LQ, LT, reverse};
  return static_cast<int>(launch(src, qlen, tlen, h0, B, out,
                                 static_cast<cudaStream_t>(stream)));
}

extern "C" int seeksv_extend_windows(const uint8_t* q, const int* qlen,
                                     const uint8_t* t, const int* tlen,
                                     const int* h0, int B, int LQ, int LT,
                                     int* out, void* stream) {
  if (B == 0) return 0;
  const Codes<true> src{q, t, nullptr, 0, LQ, LT, 0};
  return static_cast<int>(launch(src, qlen, tlen, h0, B, out,
                                 static_cast<cudaStream_t>(stream)));
}

extern "C" const char* seeksv_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
