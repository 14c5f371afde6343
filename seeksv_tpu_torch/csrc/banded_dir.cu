// Banded global affine DP with per-cell direction bytes (the finalize
// stage's score + traceback bits).
//
// Replaces: seeksv_tpu/ops/global_device.py:_banded_dir_kernel (the
// Pallas TPU kernel, launched by pallas_banded_direction) and build_t2,
// the dlo-shifted target panel that kernel reads: here each thread reads
// its target code straight from t [B, LT] with the shift and masks.
//
// Semantics are those of the reference exactly: band j - i in [dlo, dhi]
// with band column c = j - i - dlo, NEG_INF = -0x40000000 (the direction
// bits compare deep negatives for equality), direction bits DM 1, DE 2,
// DF 4, ERUN 8, FRUN 16, the terminal score H[m][n] captured at row m,
// band column c_end.
//
// What bounds it on the H100: the row recurrence's latency (an exclusive
// prefix max across the band per row, two block barriers deep) and, for
// long queries, the direction bytes written: B * m * K bytes.
//
// What the design does about it: one block per job with K threads, one
// per band column, so H and F of the previous row stay in registers and
// the up-neighbour comes from a warp shuffle (shared memory only across
// warp edges).  The direction layout is job-major [B, LQ, K] uint8, so a
// warp writes 32 consecutive bytes per row.  The kernel stops at row m:
// rows m+1..LQ of a job's direction block are left unwritten (the
// traceback never reads them).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMatch = 1;
constexpr int kMismatch = 4;
constexpr int kGapOpen = 6;
constexpr int kGapExt = 1;
constexpr int kAmbig = -1;
constexpr int kNegInf = -0x40000000;  // global_device.NEG_INF
constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kDM = 1, kDE = 2, kDF = 4, kERUN = 8, kFRUN = 16;

template <int K>
__global__ void banded_dir_kernel(const uint8_t* __restrict__ q,
                                  const uint8_t* __restrict__ t,
                                  const int* __restrict__ dlo_,
                                  const int* __restrict__ m_,
                                  const int* __restrict__ n_, int LQ, int LT,
                                  int* __restrict__ score,
                                  uint8_t* __restrict__ dirs) {
  constexpr int NW = K / 32;
  __shared__ int s_h[2][NW];  // lane-0 H/F of each warp, by row parity
  __shared__ int s_f[2][NW];
  __shared__ int s_tot[NW];   // warp totals of the E-scan input
  __shared__ int s_em[NW];    // lane-31 E of each warp, this row
  __shared__ int s_score;

  const int b = blockIdx.x;
  const int c = threadIdx.x;
  const int lane = c & 31;
  const int warp = c >> 5;
  const int dlo = dlo_[b];
  const int m = m_[b];
  const int n = n_[b];
  const int w = min(0, n - m) - dlo;
  const int k_real = abs(n - m) + 2 * w + 1;
  const int c_end = (n - m) - dlo;
  const bool in_band = c < k_real;

  const int jz = dlo + c;
  int h = (jz == 0) ? 0
                    : ((jz >= 1 && jz <= n && in_band)
                           ? -kGapOpen - jz * kGapExt
                           : kNegInf);
  int f = kNegInf;
  if (c == 0) s_score = (m == 0 && n == 0) ? 0 : kNegInf;
  if (lane == 0) {
    s_h[0][warp] = h;
    s_f[0][warp] = f;
  }
  __syncthreads();

  const uint8_t* qb = q + (size_t)b * LQ;
  const uint8_t* tb = t + (size_t)b * LT;
  uint8_t* db = dirs + (size_t)b * LQ * K;
  for (int i = 1; i <= m; ++i) {
    const int par = (i - 1) & 1;
    const int qi = qb[i - 1];
    const int j = i + dlo + c;
    const int tc = (j >= 1 && j <= n && j <= LT) ? tb[j - 1] : 4;
    const int sub = (qi > 3 || tc > 3) ? kAmbig
                                       : (qi == tc ? kMatch : -kMismatch);
    const int diag = h + sub;  // (i-1, j-1): same band column
    int hup = __shfl_down_sync(kFull, h, 1);  // (i-1, j): column c+1
    int fup = __shfl_down_sync(kFull, f, 1);
    if (lane == 31) {
      hup = (warp + 1 < NW) ? s_h[par][warp + 1] : kNegInf;
      fup = (warp + 1 < NW) ? s_f[par][warp + 1] : kNegInf;
    }
    const int fv = max(hup - kGapOpen, fup) - kGapExt;
    const int g = max(diag, fv);
    const bool computed = j >= 1 && j <= n && in_band;
    const bool bnd = j == 0 && in_band;
    const int bval = -kGapOpen - i * kGapExt;
    const int u = computed ? g + j * kGapExt : (bnd ? bval : kNegInf);

    int incl = u;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int v = __shfl_up_sync(kFull, incl, o);
      if (lane >= o) incl = max(incl, v);
    }
    int m2 = __shfl_up_sync(kFull, incl, 1);
    if (lane == 0) m2 = kNegInf;
    if (lane == 31) s_tot[warp] = incl;
    __syncthreads();
#pragma unroll
    for (int w2 = 0; w2 < NW; ++w2) {
      if (w2 < warp) m2 = max(m2, s_tot[w2]);
    }
    const int e = m2 - kGapOpen - j * kGapExt;
    int hn = max(g, e);
    hn = computed ? hn : (bnd ? bval : kNegInf);
    const int fm = computed ? fv : (bnd ? bval : kNegInf);
    const int em = computed ? e : kNegInf;
    if (lane == 31) s_em[warp] = em;
    if (lane == 0) {
      s_h[par ^ 1][warp] = hn;
      s_f[par ^ 1][warp] = fm;
    }
    __syncthreads();
    int eprev = __shfl_up_sync(kFull, em, 1);  // (i, j-1): column c-1
    if (lane == 0) eprev = (warp > 0) ? s_em[warp - 1] : kNegInf;

    int d = 0;
    if (computed && hn == diag) d |= kDM;
    if (computed && hn == em) d |= kDE;
    if ((computed && hn == fm) || bnd) d |= kDF;
    if (computed && j - 1 >= 1 && em == eprev - kGapExt) d |= kERUN;
    if ((computed || bnd) && i > 1 && fm == fup - kGapExt) d |= kFRUN;
    db[(size_t)(i - 1) * K + c] = static_cast<uint8_t>(d);
    if (i == m) {
      if (c == c_end) s_score = hn;
      if (c == 0 && (c_end < 0 || c_end >= K)) s_score = kNegInf;
    }
    h = hn;
    f = fm;
  }
  __syncthreads();
  if (c == 0) score[b] = s_score;
}

template <int K>
cudaError_t launch(const uint8_t* q, const uint8_t* t, const int* dlo,
                   const int* m, const int* n, int B, int LQ, int LT,
                   int* score, uint8_t* dirs, cudaStream_t stream) {
  banded_dir_kernel<K><<<B, K, 0, stream>>>(q, t, dlo, m, n, LQ, LT, score,
                                            dirs);
  return cudaGetLastError();
}

}  // namespace

extern "C" int seeksv_banded_dir(const uint8_t* q, const uint8_t* t,
                                 const int* dlo, const int* m, const int* n,
                                 int B, int LQ, int LT, int K, int* score,
                                 uint8_t* dirs, void* stream) {
  if (B == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (K) {
    case 128: return launch<128>(q, t, dlo, m, n, B, LQ, LT, score, dirs, s);
    case 256: return launch<256>(q, t, dlo, m, n, B, LQ, LT, score, dirs, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
