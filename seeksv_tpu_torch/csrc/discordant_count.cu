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
// period)).  A case code outside 0..2 counts nothing.
//
// Positions are int64 (the host counter's width; the TPU ran int32).
// The ceiling is written for a signed numerator: C++ division truncates
// toward zero where JAX's // floors.
//
// What bounds it on the H100: scattered loads of ~50 bytes per record;
// windows are a few hundred records, so the whole call is a few MB.
//
// What the design does about it: one warp per junction, lanes striding
// over the window (neighbouring lanes read neighbouring records), a warp
// shuffle sums the count.  An empty window (lo >= hi) counts 0.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr long long kCross = 5;   // kCrossLength, getsv.cpp:15

__device__ __forceinline__ long long ceil_div(long long a, long long b) {
  // b >= 1
  return a >= 0 ? (a + b - 1) / b : -((-a) / b);
}

__global__ void discordant_count_kernel(
    const long long* __restrict__ pos, const long long* __restrict__ end,
    const int* __restrict__ lq, const long long* __restrict__ mpos,
    const int* __restrict__ mtid, const uint8_t* __restrict__ fwd,
    const uint8_t* __restrict__ mfwd, const uint8_t* __restrict__ base_ok,
    long long R, const long long* __restrict__ lo,
    const long long* __restrict__ hi, const long long* __restrict__ beg,
    const long long* __restrict__ up_pos,
    const long long* __restrict__ down_pos,
    const int* __restrict__ down_tid, const uint8_t* __restrict__ same_tid,
    const int* __restrict__ case_code, const long long* __restrict__ min_ins,
    const long long* __restrict__ max_ins, int J, long long window_cap,
    int* __restrict__ out) {
  const long long j =
      ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (j >= J) return;   // warp-uniform
  const long long l = lo[j];
  long long n = hi[j] - l;
  if (n > window_cap) n = window_cap;
  const int code = case_code[j];
  const long long up = up_pos[j], dn = down_pos[j], b = beg[j];
  const long long mini = min_ins[j], maxi = max_ins[j];
  const int dtid = down_tid[j];
  const bool stid = same_tid[j] != 0;
  const long long period = up - dn + 1;
  const long long step = period > 1 ? period : 1;
  int cnt = 0;
  if (R > 0 && code >= 0 && code <= 2) {
    for (long long w = lane; w < n; w += 32) {
      long long i = l + w;
      i = i < 0 ? 0 : (i >= R ? R - 1 : i);   // the reference's clamp
      if (!base_ok[i] || end[i] <= b || mtid[i] != dtid) continue;
      const long long p = pos[i], mp = mpos[i], ln = lq[i];
      const bool fw = fwd[i] != 0, mf = mfwd[i] != 0;
      bool hit;
      if (code == 0) {
        const long long ins = up - p + mp + ln - dn + 1;
        hit = (p + ln <= up + kCross) && (mp + 1 >= dn - kCross) && fw && !mf;
        if (stid && up > dn && period + 2 * ln <= maxi) {
          long long k0 = ceil_div(mini - ins, step);
          if (k0 < 0) k0 = 0;
          hit = hit && ins + k0 * period <= maxi;
        } else {
          hit = hit && mini <= ins && ins <= maxi;
        }
      } else if (code == 1) {
        const long long ins = p + 1 - up + 1 + mp + ln - dn + 1;
        hit = !fw && !mf && (mp + 1 >= dn - kCross) && mini <= ins &&
              ins <= maxi;
      } else {
        const long long ins = up - p + dn - (mp + ln) + 1;
        hit = fw && mf && (p + ln <= up + kCross) &&
              (mp + ln <= dn + kCross) && mini <= ins && ins <= maxi;
      }
      cnt += hit;
    }
  }
  for (int o = 16; o > 0; o >>= 1) cnt += __shfl_xor_sync(0xffffffffu, cnt, o);
  if (lane == 0) out[j] = cnt;
}

}  // namespace

// Record columns [R]: pos, end, mpos int64; lq, mtid int32; fwd, mfwd,
// base_ok uint8.  Junction columns [J]: lo, hi, beg, up_pos, down_pos,
// min_ins, max_ins int64; down_tid, case_code int32; same_tid uint8.
// Writes out [J] int32.
extern "C" int seeksv_discordant_count(
    const long long* pos, const long long* end, const int* lq,
    const long long* mpos, const int* mtid, const uint8_t* fwd,
    const uint8_t* mfwd, const uint8_t* base_ok, long long R,
    const long long* lo, const long long* hi, const long long* beg,
    const long long* up_pos, const long long* down_pos, const int* down_tid,
    const uint8_t* same_tid, const int* case_code, const long long* min_ins,
    const long long* max_ins, int J, long long window_cap, int* out,
    void* stream) {
  if (J <= 0) return 0;
  if (R < 0 || window_cap < 0) return static_cast<int>(cudaErrorInvalidValue);
  const int threads = 256;   // 8 junctions per block
  const unsigned blocks = (unsigned)(((long long)J * 32 + threads - 1) / threads);
  discordant_count_kernel<<<blocks, threads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      pos, end, lq, mpos, mtid, fwd, mfwd, base_ok, R, lo, hi, beg, up_pos,
      down_pos, down_tid, same_tid, case_code, min_ins, max_ins, J,
      window_cap, out);
  return static_cast<int>(cudaGetLastError());
}
