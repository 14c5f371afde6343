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
// host), with its run slots zeroed.  Runs are emitted in walk (reverse)
// order and flipped in place at the end.
//
// What bounds it on the H100: the dependent chain of byte loads, one
// per step (each load's address depends on the previous step), so a walk
// is latency-bound at up to m + n steps.
//
// What the design does about it: one thread per job, so all walks of a
// chunk advance at once and the card overlaps their loads; the direction
// block of a job is job-major, so the consecutive rows a diagonal run
// reads sit K bytes apart and mostly hit L2.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRunsCap = 64;  // global_device.RUNS_CAP
constexpr int kDM = 1, kDE = 2, kDF = 4, kERUN = 8, kFRUN = 16;

template <int K>
__global__ void traceback_kernel(const uint8_t* __restrict__ dirs,
                                 const int* __restrict__ m_,
                                 const int* __restrict__ n_,
                                 const int* __restrict__ dlo_, int B, int LQ,
                                 int* __restrict__ runs_len,
                                 int* __restrict__ runs_op,
                                 int* __restrict__ n_runs) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  int i = m_[b];
  int j = n_[b];
  const int dlo = dlo_[b];
  const uint8_t* db = dirs + (size_t)b * LQ * K;
  int* rl = runs_len + (size_t)b * kRunsCap;
  int* ro = runs_op + (size_t)b * kRunsCap;

  int mode = 0;  // 0 H, 1 inside a D run (E), 2 inside an I run (F)
  int nr = 0, cur_op = -1, cur_len = 0;
  bool over = false;
  while (i > 0 || j > 0) {
    const int c = j - i - dlo;
    const int d = (i >= 1 && c >= 0 && c < K) ? db[(size_t)(i - 1) * K + c]
                                               : 0;
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
    if (op == cur_op) {
      ++cur_len;
    } else {
      if (cur_op >= 0) {
        if (nr == kRunsCap) {
          over = true;
          break;
        }
        rl[nr] = cur_len;
        ro[nr] = cur_op;
        ++nr;
      }
      cur_op = op;
      cur_len = 1;
    }
  }
  if (!over && cur_op >= 0) {
    if (nr == kRunsCap) {
      over = true;
    } else {
      rl[nr] = cur_len;
      ro[nr] = cur_op;
      ++nr;
    }
  }
  if (!over && (i != 0 || j != 0)) over = true;  // cannot happen; be safe
  if (over) {
    for (int k = 0; k < kRunsCap; ++k) {
      rl[k] = 0;
      ro[k] = 0;
    }
    n_runs[b] = kRunsCap + 1;
    return;
  }
  for (int k = 0; k < nr / 2; ++k) {  // walk order -> forward order
    const int a = rl[k], o = ro[k];
    rl[k] = rl[nr - 1 - k];
    ro[k] = ro[nr - 1 - k];
    rl[nr - 1 - k] = a;
    ro[nr - 1 - k] = o;
  }
  for (int k = nr; k < kRunsCap; ++k) {
    rl[k] = 0;
    ro[k] = 0;
  }
  n_runs[b] = nr;
}

template <int K>
cudaError_t launch(const uint8_t* dirs, const int* m, const int* n,
                   const int* dlo, int B, int LQ, int* runs_len, int* runs_op,
                   int* n_runs, cudaStream_t stream) {
  const int threads = 128;
  traceback_kernel<K><<<(B + threads - 1) / threads, threads, 0, stream>>>(
      dirs, m, n, dlo, B, LQ, runs_len, runs_op, n_runs);
  return cudaGetLastError();
}

}  // namespace

extern "C" int seeksv_traceback(const uint8_t* dirs, const int* m,
                                const int* n, const int* dlo, int B, int LQ,
                                int K, int* runs_len, int* runs_op,
                                int* n_runs, void* stream) {
  if (B == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (K) {
    case 128: return launch<128>(dirs, m, n, dlo, B, LQ, runs_len, runs_op, n_runs, s);
    case 256: return launch<256>(dirs, m, n, dlo, B, LQ, runs_len, runs_op, n_runs, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
