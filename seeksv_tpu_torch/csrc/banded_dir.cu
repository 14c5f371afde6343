// Banded global affine DP with per-cell direction bytes (the finalize
// stage's score + traceback bits), K2.
//
// Replaces: seeksv_tpu/ops/global_device.py:_banded_dir_kernel (the
// Pallas TPU kernel, launched by pallas_banded_direction) and build_t2,
// the dlo-shifted target panel that kernel reads: here a warp reads its
// target codes straight from t [B, LT] with the shift and masks.
//
// Semantics are those of the reference exactly: band j - i in [dlo, dhi]
// with band column c = j - i - dlo, NEG_INF = -0x40000000 (the direction
// bits compare deep negatives for equality, so E, F and H are the same
// integers as the plain version's everywhere), direction bits DM 1, DE 2,
// DF 4, ERUN 8, FRUN 16, the terminal score H[m][n] captured at row m,
// band column c_end.  Rows 1..m of a job's [LQ, K] direction block are
// written whole (zeros past the band's k_real columns); rows past m are
// left unwritten (the traceback never reads them).
//
// What bounds it on the H100: integer operations, about twenty a cell of
// the band (substitution, diagonal, F, the prefix max's step, E, H, five
// flag compares and their packing), on the int32 pipe, which runs at
// half the rate of the card's float pipe; the direction bytes are the only
// traffic that matters and need less time than the cells.  What stands
// between a kernel and that bound is (a) columns that are not in the band
// (a job's band has k_real = |n - m| + 2w + 1 columns, often far fewer
// than K), (b) per-row overhead that is not cell work on a chain of m
// dependent rows (barriers, exchanges through shared memory, byte loads
// and byte stores), and (c) instructions per cell.
//
// What the design does about it:
// - One warp per job, four jobs a block, and the columns a lane holds
//   (CPL = 2 or 4 at K = 128; 5, 6 or 8 at K = 256) come from the job's
//   own k_real: jobs are binned by k_real on the device
//   (ops/global_device.py:plan_band_bins), each bin is one launch of the
//   kernel compiled for its CPL, and inside a bin the jobs are ordered
//   longest m first.  A warp finds its job through that order and writes
//   at the job's own index.  The launches follow one another on the
//   caller's stream, widest bin first; a bin without jobs is a grid of
//   warps that leave at once.
// - No block barrier and no shared memory on the row chain: H and F of
//   the previous row live in registers, CPL consecutive columns a lane.
//   The up-neighbour (i-1, c+1) and E of (i, c-1) are in the lane except
//   at its edge (one shuffle each); the row's exclusive prefix max is a
//   serial scan in the lane plus five shuffles of the lanes' totals.
// - Instructions: DPX (__viaddmax_s32) for max(hup - open, fup) - ext; the
//   substitution scores of a row are four signed bytes of one register
//   (by target code), fetched for 32 rows at once, broadcast by shuffle,
//   and one PRMT picks the scores of four columns by their code nibbles.
//   Only a job's first rows (up to row 1 - dlo) can hold the boundary cell
//   j = 0, a cell with j < 1 or the cell j = 1; they run a row body with
//   every mask, and all later rows one whose only mask is the band's right
//   edge.  The terminal score is read from the registers after the last
//   row, not tested for in every cell.
// - Loads: the lane's CPL target codes are nibbles of one register that
//   slides by one column a row: the code that enters comes from the next
//   lane by shuffle, and the last lane's from a register filled every 32
//   rows by one coalesced load.
// - Stores: a lane's CPL direction bytes go out as one 2-, 4- or 8-byte
//   store (three 2-byte stores at CPL 6, five bytes at CPL 5), so a warp
//   writes its row as one contiguous run; the zeros past the bin's
//   columns are word stores of the first lanes.
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
constexpr int kWarps = 4;  // jobs a block
// The bins' upper k_real, 32 lanes x CPL columns each, narrowest first;
// ops/global_device.py's BAND_EDGES must say the same (it asks
// seeksv_banded_bin_edge).  A band of w = 64 has at least 129 columns,
// so K = 256 starts at 160.
constexpr int kEdges128[] = {64, 128};
constexpr int kEdges256[] = {160, 192, 256};
static_assert(kGapExt == 1, "u = g + j assumes an extension cost of 1");

// The lane's CPL direction bytes of one row, at p = row + lane * CPL.
template <int CPL>
__device__ __forceinline__ void store_dirs(uint8_t* p, const uint32_t (&d)[CPL]) {
  if constexpr (CPL == 2) {
    *reinterpret_cast<uint16_t*>(p) = (uint16_t)(d[0] | (d[1] << 8));
  } else if constexpr (CPL == 4) {
    *reinterpret_cast<uint32_t*>(p) =
        d[0] | (d[1] << 8) | (d[2] << 16) | (d[3] << 24);
  } else if constexpr (CPL == 8) {
    uint2 v;
    v.x = d[0] | (d[1] << 8) | (d[2] << 16) | (d[3] << 24);
    v.y = d[4] | (d[5] << 8) | (d[6] << 16) | (d[7] << 24);
    *reinterpret_cast<uint2*>(p) = v;
  } else if constexpr (CPL == 6) {
    uint16_t* p2 = reinterpret_cast<uint16_t*>(p);
    p2[0] = (uint16_t)(d[0] | (d[1] << 8));
    p2[1] = (uint16_t)(d[2] | (d[3] << 8));
    p2[2] = (uint16_t)(d[4] | (d[5] << 8));
  } else {
#pragma unroll
    for (int k = 0; k < CPL; ++k) p[k] = (uint8_t)d[k];
  }
}

// Byte k of w, sign-extended (one PRMT: selector nibble k copies the
// byte, k | 8 replicates its sign).
template <int k>
__device__ __forceinline__ int signed_byte(uint32_t w) {
  constexpr uint32_t sel = k | ((k | 8) << 4) | ((k | 8) << 8) | ((k | 8) << 12);
  uint32_t d;
  asm("prmt.b32 %0, %1, %2, %3;" : "=r"(d) : "r"(w), "r"(0u), "r"(sel));
  return (int)d;
}

// The substitution scores of a row by target code 0..3, a signed byte
// each: +1 on the query's own code and -4 on the other three, -1 everywhere
// when the query code is ambiguous.
__device__ __forceinline__ uint32_t score_lut(int qi) {
  static_assert(kMatch == 1 && kMismatch == 4 && kAmbig == -1, "lut bytes");
  return qi > 3 ? 0xFFFFFFFFu
                : ((0xFCFCFCFCu & ~(0xFFu << (8 * qi))) | (1u << (8 * qi)));
}

// One DP row i of a job for the lane that owns the band columns c0 ..
// c0 + CPL - 1: h and f hold row i - 1 on entry and row i on return, tw
// the lane's target codes of row i (a nibble a column), lut the row's
// substitution scores (score_lut of its query code); the lane's direction
// bytes are stored at `row` + c0.  kHead: the
// row may hold the boundary cell j = 0, cells with j < 1, the cell j = 1
// or be row 1; every later row has none of these, and its masks are the
// band's right edge alone.
template <int K, int CPL, bool kHead>
__device__ __forceinline__ void dp_row(const int i, const int lane,
                                       const int c0, const int dlo,
                                       const int n, const int kb,
                                       const uint32_t lut, const uint32_t tw,
                                       int (&h)[CPL], int (&f)[CPL],
                                       uint8_t* __restrict__ row) {
  constexpr int NC = 32 * CPL;    // columns the warp computes
  constexpr int TAIL = K - NC;    // zero bytes a row past them
  // one PRMT picks the scores of the lane's columns by their code nibbles;
  // an ambiguous target (code 4) takes byte 4 of the pair, -1
  uint32_t sw0, sw1 = 0;
  asm("prmt.b32 %0, %1, %2, %3;"
      : "=r"(sw0) : "r"(lut), "r"(0xFFFFFFFFu), "r"(tw & 0xFFFFu));
  if constexpr (CPL > 4)
    asm("prmt.b32 %0, %1, %2, %3;"
        : "=r"(sw1) : "r"(lut), "r"(0xFFFFFFFFu), "r"(tw >> 16));

  int hup_edge = __shfl_down_sync(kFull, h[0], 1);  // (i-1, c+1)
  int fup_edge = __shfl_down_sync(kFull, f[0], 1);
  if (lane == 31) {
    hup_edge = kNegInf;
    fup_edge = kNegInf;
  }
  const int jb = i + dlo + c0;  // j of the lane's first column
  // computed cells: 1 <= j <= n inside the band; the boundary cell j = 0
  const int klo = 1 - jb;                 // k >= klo  <=>  j >= 1
  const int khi = min(n - jb + 1, kb);    // k <  khi  <=>  j <= n, in band
  const int bval = -kGapOpen - i * kGapExt;
  const int ebase = -kGapOpen - jb * kGapExt;

  int g[CPL], fv[CPL], dg[CPL], ex[CPL], fdn[CPL];
  bool cm[CPL], bnd[CPL];
  int run = kNegInf;  // max of u over the lane's columns before k
#pragma unroll
  for (int k = 0; k < CPL; ++k) {
    int sub;
    if (k == 0) sub = signed_byte<0>(sw0);
    else if (k == 1) sub = signed_byte<1>(sw0);
    else if (k == 2) sub = signed_byte<2>(sw0);
    else if (k == 3) sub = signed_byte<3>(sw0);
    else if (k == 4) sub = signed_byte<0>(sw1);
    else if (k == 5) sub = signed_byte<1>(sw1);
    else if (k == 6) sub = signed_byte<2>(sw1);
    else sub = signed_byte<3>(sw1);
    dg[k] = h[k] + sub;  // (i-1, j-1): same band column
    const int hup = (k + 1 < CPL) ? h[k + 1] : hup_edge;
    const int fup = (k + 1 < CPL) ? f[k + 1] : fup_edge;
    fdn[k] = fup - kGapExt;
    // max(hup - open, fup) - ext
    fv[k] = __viaddmax_s32(hup, -kGapOpen - kGapExt, fdn[k]);
    g[k] = max(dg[k], fv[k]);
    cm[k] = kHead ? (k >= klo && k < khi) : (k < khi);
    bnd[k] = kHead && k == -jb && k < kb;
    const int u = cm[k] ? g[k] + (jb + k) * kGapExt
                        : (bnd[k] ? bval : kNegInf);
    ex[k] = run;
    run = max(run, u);
  }
  // exclusive prefix max of u across the lanes
  int incl = run;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    // a lane below o gets its own value back: max leaves it as it is
    incl = max(incl, __shfl_up_sync(kFull, incl, o));
  }
  int excl = __shfl_up_sync(kFull, incl, 1);
  if (lane == 0) excl = kNegInf;

  uint32_t d[CPL];
  int em_prev = kNegInf;  // E of (i, c-1); the lane's first is fixed below
  int em_first = kNegInf;
#pragma unroll
  for (int k = 0; k < CPL; ++k) {
    const int edge = bnd[k] ? bval : kNegInf;
    const int e = max(excl, ex[k]) + (ebase - k * kGapExt);
    const int hn = cm[k] ? max(g[k], e) : edge;
    const int fm = cm[k] ? fv[k] : edge;
    const int em = cm[k] ? e : kNegInf;
    uint32_t dd = 0;
    if (cm[k] && hn == dg[k]) dd |= kDM;
    if (cm[k] && hn == em) dd |= kDE;
    if ((cm[k] && hn == fm) || bnd[k]) dd |= kDF;
    if (k > 0 && cm[k] && (!kHead || jb + k - 1 >= 1) &&
        em == em_prev - kGapExt)
      dd |= kERUN;
    if ((cm[k] || bnd[k]) && (!kHead || i > 1) && fm == fdn[k]) dd |= kFRUN;
    d[k] = dd;
    if (k == 0) em_first = em;
    em_prev = em;
    h[k] = hn;
    f[k] = fm;
  }
  {
    // the lane's first column takes E of (i, c-1) from the lane before
    int eprev = __shfl_up_sync(kFull, em_prev, 1);
    if (lane == 0) eprev = kNegInf;
    if (cm[0] && (!kHead || jb - 1 >= 1) && em_first == eprev - kGapExt)
      d[0] |= kERUN;
  }
  store_dirs<CPL>(row + c0, d);
  if (TAIL > 0 && lane < TAIL / 4)
    reinterpret_cast<uint32_t*>(row + NC)[lane] = 0u;
}

// One warp per job.  Warp x of the launch for bin `which` takes the job
// order[seg[which] + x] if that slot is below seg[which + 1], else
// leaves.  Lane l owns the band columns c = l * CPL .. l * CPL + CPL - 1;
// the bin guarantees k_real <= 32 * CPL, so every column past them is
// outside the band.  Asked for at least four blocks a multiprocessor, the
// compiler keeps every CPL within 80 registers and spills nothing (left to
// itself it spills 8 bytes at CPL 8).
template <int K, int CPL>
__global__ void __launch_bounds__(kWarps * 32, 4)
banded_dir_kernel(const uint8_t* __restrict__ q,
                  const uint8_t* __restrict__ t,
                  const int* __restrict__ dlo_, const int* __restrict__ m_,
                  const int* __restrict__ n_, const int* __restrict__ order,
                  const int* __restrict__ seg, int which, int LQ, int LT,
                  int* __restrict__ score, uint8_t* __restrict__ dirs) {
  constexpr int NC = 32 * CPL;
  static_assert(NC <= K && (K - NC) % 4 == 0 && NC % 4 == 0 && CPL <= 8, "");
  const int lane = threadIdx.x & 31;
  const int slot = seg[which] + blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (slot >= seg[which + 1]) return;
  const int b = order[slot];
  const int dlo = dlo_[b];
  const int m = m_[b];
  const int n = n_[b];
  const int w = min(0, n - m) - dlo;
  const int k_real = abs(n - m) + 2 * w + 1;
  const int c_end = (n - m) - dlo;
  const int c0 = lane * CPL;
  const int rows = min(m, LQ);
  const int nt = min(n, LT);  // target codes that exist: j in [1, nt]
  // columns of the lane inside the band: k < kb
  const int kb = k_real - c0;

  const uint8_t* qb = q + (size_t)b * LQ;
  const uint8_t* tb = t + (size_t)b * LT;
  uint8_t* db = dirs + (size_t)b * LQ * K;

  int h[CPL], f[CPL];
  uint32_t tw = 0;  // the lane's target codes of the row, a nibble each
#pragma unroll
  for (int k = 0; k < CPL; ++k) {
    const int jz = dlo + c0 + k;
    h[k] = (jz == 0) ? 0
                     : ((jz >= 1 && jz <= n && k < kb)
                            ? -kGapOpen - jz * kGapExt
                            : kNegInf);
    f[k] = kNegInf;
    const int j1 = jz + 1;
    const uint32_t code = (j1 >= 1 && j1 <= nt) ? min((int)tb[j1 - 1], 4) : 4;
    tw |= code << (4 * k);
  }

  // rows up to head_end may hold a cell with j <= 1 (or are row 1)
  const int head_end = min(rows, max(1, 1 - dlo));
  uint32_t qv = 0xFFFFFFFFu;
  int tv = 4;
  for (int i = 1; i <= rows; ++i) {
    const int r = (i - 1) & 31;
    if (r == 0) {
      // the substitution scores of rows i .. i + 31 by their query codes,
      // and the target codes that enter the warp's last column at rows
      // i + 1 .. i + 32
      const int qi_idx = i - 1 + lane;
      qv = score_lut(qi_idx < rows ? min((int)qb[qi_idx], 4) : 4);
      const int jj = i + 1 + lane + dlo + NC - 1;
      tv = (jj >= 1 && jj <= nt) ? min((int)tb[jj - 1], 4) : 4;
    }
    const uint32_t lut = __shfl_sync(kFull, qv, r);
    const int fresh = __shfl_sync(kFull, tv, r);
    uint8_t* row = db + (size_t)(i - 1) * K;
    if (i <= head_end)
      dp_row<K, CPL, true>(i, lane, c0, dlo, n, kb, lut, tw, h, f, row);
    else
      dp_row<K, CPL, false>(i, lane, c0, dlo, n, kb, lut, tw, h, f, row);

    // slide the target codes by one column for the next row
    int incoming = __shfl_down_sync(kFull, (int)(tw & 0xF), 1);
    if (lane == 31) incoming = fresh;
    tw = (tw >> 4) | ((uint32_t)incoming << (4 * (CPL - 1)));
  }

  // the terminal score: H[m][n] at band column c_end of row m
  if (m == 0) {
    if (lane == 0) score[b] = (n == 0) ? 0 : kNegInf;
  } else if (m <= LQ && c_end >= 0 && c_end < NC) {
    if (lane == c_end / CPL) {
      int sc = kNegInf;
#pragma unroll
      for (int k = 0; k < CPL; ++k)
        if (c0 + k == c_end) sc = h[k];
      score[b] = sc;
    }
  } else if (lane == 0) {
    score[b] = kNegInf;
  }
}

template <int K, int CPL>
cudaError_t launch_bin(const uint8_t* q, const uint8_t* t, const int* dlo,
                       const int* m, const int* n, const int* order,
                       const int* seg, int which, int B, int LQ, int LT,
                       int* score, uint8_t* dirs, cudaStream_t stream) {
  banded_dir_kernel<K, CPL>
      <<<(B + kWarps - 1) / kWarps, kWarps * 32, 0, stream>>>(
          q, t, dlo, m, n, order, seg, which, LQ, LT, score, dirs);
  return cudaGetLastError();
}

}  // namespace

// The number of k_real bins of band width K (0: K has no launch shape).
extern "C" int seeksv_banded_bins(int K) {
  if (K == 128) return sizeof(kEdges128) / sizeof(int);
  if (K == 256) return sizeof(kEdges256) / sizeof(int);
  return 0;
}

// The upper k_real of bin i of band width K (0 the narrowest), -1 out of
// range.
extern "C" int seeksv_banded_bin_edge(int K, int i) {
  if (i < 0 || i >= seeksv_banded_bins(K)) return -1;
  return K == 128 ? kEdges128[i] : kEdges256[i];
}

// q [B, LQ], t [B, LT] uint8 codes; dlo, m, n [B] int32; order [B] int32
// the jobs by bin, widest bin first, and seg [bins + 1] int32 the bins'
// offsets into it (plan_band_bins).  Writes score [B] int32 and rows
// 1..m of dirs [B, LQ, K] uint8.  One launch per bin on `stream`, widest
// bin first.
extern "C" int seeksv_banded_dir(const uint8_t* q, const uint8_t* t,
                                 const int* dlo, const int* m, const int* n,
                                 int B, int LQ, int LT, int K,
                                 const int* order, const int* seg, int* score,
                                 uint8_t* dirs, void* stream) {
  if (B == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t rc;
#define SEEKSV_BIN(KK, CPL, WHICH)                                           \
  rc = launch_bin<KK, CPL>(q, t, dlo, m, n, order, seg, WHICH, B, LQ, LT,   \
                           score, dirs, s);                                  \
  if (rc != cudaSuccess) return static_cast<int>(rc);
  if (K == 128) {
    static_assert(kEdges128[1] == 32 * 4 && kEdges128[0] == 32 * 2, "");
    SEEKSV_BIN(128, 4, 0)
    SEEKSV_BIN(128, 2, 1)
  } else if (K == 256) {
    static_assert(kEdges256[2] == 32 * 8 && kEdges256[1] == 32 * 6 &&
                      kEdges256[0] == 32 * 5, "");
    SEEKSV_BIN(256, 8, 0)
    SEEKSV_BIN(256, 6, 1)
    SEEKSV_BIN(256, 5, 2)
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
#undef SEEKSV_BIN
  return 0;
}
