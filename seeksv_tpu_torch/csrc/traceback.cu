// Traceback walk over the banded direction bytes, run-length encoded.
//
// Replaces: seeksv_tpu/ops/global_device.py:traceback_rle_packed (an XLA
// lax.scan on the TPU, with _walk_step and _rle_tail).  Each job walks
// from (m, n) to (0, 0) in the C++ ladder's preference order: in H mode
// M if DM, else D (continued as a D run while ERUN holds) if DE, else I
// (continued while FRUN holds) if DF, else the value-escape fallbacks;
// row i = 0 and column j = 0 reduce to pure D or I runs.
//
// The walk has no step budget: every step lowers i + j, so it always
// reaches (0, 0) within m + n steps.  A walk whose runs exceed RUNS_CAP
// stops and reports RUNS_CAP + 1 (overflow: the job goes back to the
// host), with its run slots zeroed.
//
// What bounds it on the H100: latency.  A step reads the byte of its
// (row, band column) and the next step's address depends on it.  A
// job's direction block is LQ x K bytes (a chunk of 4,096 jobs at K 256
// is 1 GiB, far past the 50 MB L2), and a diagonal step reads the byte K
// bytes back, a new sector, so a walk that loads byte by byte pays one
// device-memory round trip a step: about m + n of them for the longest
// walk of a call, however many walks run beside it.  The bytes a walk
// needs are few: one 32-byte sector per row it visits.
//
// What the design does about it: it uses the walk's geometry.  A step
// lowers the row by at most one and moves the band column c = j - i - dlo
// by at most one (M keeps c, I raises it, D lowers it).
//  - One warp walks one job.  Its lanes fetch a window of the coming rows
//    in one batch of independent loads: 128 rows (four a lane), of each
//    the 32-byte aligned sector that holds c, into the warp's slice of
//    shared memory.  One round trip then serves up to 128 rows; the walk
//    fetches a new window only when it leaves this one (past its last
//    row, or across the sector's edge after a gap).  Width: one sector
//    a row moves the fewest bytes (a row's bytes arrive in 32-byte
//    sectors however few are used), and a path leaves it only at an
//    indel that crosses the edge; a wider window would move two sectors
//    a row on every M run to save that rare refetch.
//  - The walk reads the window from shared memory, every lane the same
//    state (no broadcast needed), and takes a run of steps at once where
//    the run's path is known before its bytes are read: an M run in H
//    mode stays in column c (row i-1-l for lane l), a D run in E mode in
//    row i-1 (column c-l), an I run in F mode on the diagonal (row i-1-l,
//    column c+l).  Each lane tests its step's byte, a ballot gives the
//    run's length, up to 32 steps in one go; the step that ends a run,
//    and every step outside the band, is taken one at a time exactly as
//    the scalar walk takes it.
//  - A walk's runs stay in shared memory (64 x 2 int32) and are written
//    once, in forward order, with the tail zeroed.  A job with m = n = 0
//    costs a warp that writes its zeros and exits.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRunsCap = 64;  // global_device.RUNS_CAP
constexpr int kDM = 1, kDE = 2, kDF = 4, kERUN = 8, kFRUN = 16;
constexpr int kWarps = 4;                      // walks a block
constexpr int kRowsPerLane = 4;
constexpr int kWinRows = 32 * kRowsPerLane;    // rows of a window
constexpr int kWinCols = 32;                   // one sector of a row
constexpr int kRowBytes = 36;                  // 9 words: lanes' rows on distinct banks

struct WarpSlice {
  uint8_t win[kWinRows * kRowBytes];
  int run_len[kRunsCap];
  int run_op[kRunsCap];
};

// Rows i0 - 1 down to i0 - kWinRows (those >= 0) of the job's block,
// columns [wc0, wc0 + 32), into the warp's window; lane l fetches rows
// i0 - 1 - l - 32q.  All loads are issued before the first store.
template <int K>
__device__ __forceinline__ void fetch(uint8_t* win, const uint8_t* db, int i0,
                                      int wc0, int lane) {
  __syncwarp();  // the old window's last reads are done
  uint4 v[kRowsPerLane][2];
#pragma unroll
  for (int q = 0; q < kRowsPerLane; ++q) {
    const int row = i0 - 1 - lane - 32 * q;
    if (row >= 0) {
      const uint4* p =
          reinterpret_cast<const uint4*>(db + (size_t)row * K + wc0);
      v[q][0] = __ldg(p);
      v[q][1] = __ldg(p + 1);
    }
  }
#pragma unroll
  for (int q = 0; q < kRowsPerLane; ++q) {
    const int row = i0 - 1 - lane - 32 * q;
    if (row >= 0) {
      uint32_t* w =
          reinterpret_cast<uint32_t*>(win + (lane + 32 * q) * kRowBytes);
      w[0] = v[q][0].x; w[1] = v[q][0].y; w[2] = v[q][0].z; w[3] = v[q][0].w;
      w[4] = v[q][1].x; w[5] = v[q][1].y; w[6] = v[q][1].z; w[7] = v[q][1].w;
    }
  }
  __syncwarp();
}

template <int K>
__global__ void __launch_bounds__(kWarps * 32)
traceback_kernel(const uint8_t* __restrict__ dirs, const int* __restrict__ m_,
                 const int* __restrict__ n_, const int* __restrict__ dlo_,
                 int B, int LQ, int* __restrict__ runs_len,
                 int* __restrict__ runs_op, int* __restrict__ n_runs) {
  __shared__ __align__(16) WarpSlice slices[kWarps];
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (b >= B) return;
  WarpSlice& s = slices[threadIdx.x >> 5];
  int i = m_[b];
  int j = n_[b];
  const int dlo = dlo_[b];
  const uint8_t* db = dirs + (size_t)b * LQ * K;

  int i0 = 0, wc0 = 0;   // the window: rows i0 - 1 down, columns wc0 + [0, 32)
  int mode = 0;          // 0 H, 1 inside a D run (E), 2 inside an I run (F)
  int nr = 0, cur_op = -1, cur_len = 0;
  bool over = false;
  // adds len steps of op to the runs; false when a new run finds the
  // RUNS_CAP slots full (overflow)
  auto add = [&](int op, int len) -> bool {
    if (op == cur_op) {
      cur_len += len;
      return true;
    }
    if (cur_op >= 0) {
      if (nr == kRunsCap) return false;
      if (lane == 0) {
        s.run_len[nr] = cur_len;
        s.run_op[nr] = cur_op;
      }
      ++nr;
    }
    cur_op = op;
    cur_len = len;
    return true;
  };

  while (i > 0 || j > 0) {
    // along row 0 or column 0 (outside any mode that forces the other
    // op) every remaining step is D, resp. I
    if (i == 0 && mode != 2) {
      over = !add(2, j);
      j = 0;
      mode = 0;
      break;
    }
    if (j == 0 && mode != 1) {
      over = !add(1, i);
      i = 0;
      mode = 0;
      break;
    }
    const int c = j - i - dlo;
    const bool banded = i >= 1 && c >= 0 && c < K;
    if (banded) {
      if (i > i0 || i0 - i >= kWinRows || (unsigned)(c - wc0) >= kWinCols) {
        i0 = i;
        wc0 = c & ~(kWinCols - 1);
        fetch<K>(s.win, db, i0, wc0, lane);
      }
      // a run in the current mode: lane l tests the byte of step l
      int ii = i, jj = j, cc = c;
      if (mode == 0) {
        ii -= lane;
        jj -= lane;
      } else if (mode == 1) {
        cc -= lane;
      } else {
        ii -= lane;
        cc += lane;
      }
      bool go = ii >= 1 && i0 - ii < kWinRows &&
                (unsigned)(cc - wc0) < kWinCols;
      const int dl = go ? s.win[(i0 - ii) * kRowBytes + (cc - wc0)] : 0;
      if (mode == 0)        // M (by DM, or by the fallback) and H again
        go = go && jj >= 1 && ((dl & kDM) || !(dl & (kDE | kDF)));
      else if (mode == 1)   // D, and the E run goes on
        go = go && (dl & kERUN);
      else                  // I, and the F run goes on
        go = go && (dl & kFRUN);
      const unsigned ball = __ballot_sync(0xffffffffu, go);
      const int r = ball == 0xffffffffu ? 32 : __ffs(~ball) - 1;
      if (r > 0) {
        const int op = mode == 0 ? 0 : (mode == 1 ? 2 : 1);
        if (op != 2) i -= r;
        if (op != 1) j -= r;
        if (!add(op, r)) {
          over = true;
          break;
        }
        continue;
      }
    }
    // one step, as the scalar walk takes it
    const int d = banded ? s.win[(i0 - i) * kRowBytes + (c - wc0)] : 0;
    int op;  // 0 M, 1 I, 2 D
    if (mode == 1) {
      op = 2;
    } else if (mode == 2) {
      op = 1;
    } else if (i > 0 && j > 0 && (d & kDM)) {
      op = 0;
    } else if (j > 0 && (d & kDE)) {
      op = 2;
    } else if (i > 0 && (d & kDF)) {
      op = 1;
    } else if (i > 0 && j > 0) {
      op = 0;
    } else if (j > 0) {
      op = 2;
    } else {
      op = 1;
    }
    const bool from_h = mode == 0;
    if (op == 2 && (d & kERUN) && (mode == 1 || from_h)) {
      mode = 1;
    } else if (op == 1 && (d & kFRUN) && (mode == 2 || from_h)) {
      mode = 2;
    } else {
      mode = 0;
    }
    if (op != 2) --i;
    if (op != 1) --j;
    if (!add(op, 1)) {
      over = true;
      break;
    }
  }
  if (!over && cur_op >= 0) {
    if (nr == kRunsCap) {
      over = true;
    } else {
      if (lane == 0) {
        s.run_len[nr] = cur_len;
        s.run_op[nr] = cur_op;
      }
      ++nr;
    }
  }
  if (!over && (i != 0 || j != 0)) over = true;  // cannot happen; be safe
  __syncwarp();
  int* rl = runs_len + (size_t)b * kRunsCap;
  int* ro = runs_op + (size_t)b * kRunsCap;
  for (int k = lane; k < kRunsCap; k += 32) {
    const bool keep = !over && k < nr;   // forward order: walk order reversed
    rl[k] = keep ? s.run_len[nr - 1 - k] : 0;
    ro[k] = keep ? s.run_op[nr - 1 - k] : 0;
  }
  if (lane == 0) n_runs[b] = over ? kRunsCap + 1 : nr;
}

template <int K>
cudaError_t launch(const uint8_t* dirs, const int* m, const int* n,
                   const int* dlo, int B, int LQ, int* runs_len, int* runs_op,
                   int* n_runs, cudaStream_t stream) {
  traceback_kernel<K><<<(B + kWarps - 1) / kWarps, kWarps * 32, 0, stream>>>(
      dirs, m, n, dlo, B, LQ, runs_len, runs_op, n_runs);
  return cudaGetLastError();
}

}  // namespace

// dirs [B, LQ, K] uint8 (16-byte aligned: the window's loads are 16-byte
// vectors), m, n, dlo [B] int32; writes runs_len, runs_op [B, 64] and
// n_runs [B] int32.
extern "C" int seeksv_traceback(const uint8_t* dirs, const int* m,
                                const int* n, const int* dlo, int B, int LQ,
                                int K, int* runs_len, int* runs_op,
                                int* n_runs, void* stream) {
  if (B == 0) return 0;
  if (reinterpret_cast<uintptr_t>(dirs) % 16)
    return static_cast<int>(cudaErrorMisalignedAddress);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (K) {
    case 128: return launch<128>(dirs, m, n, dlo, B, LQ, runs_len, runs_op, n_runs, s);
    case 256: return launch<256>(dirs, m, n, dlo, B, LQ, runs_len, runs_op, n_runs, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
