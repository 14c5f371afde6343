// Greedy first-match consensus of getclip's breakpoint groups (K5).
//
// Replaces: seeksv_tpu/ops/consensus_scan.py:consensus_scan_groups, an
// XLA program on the TPU (a lax.scan over a group's reads, vmapped over
// groups, carrying every slot's left and right sequence).
//
// Semantics (v1.2.0 getclip, pipeline/getclip.py): the reads of a group,
// in order, probe the live slots; the first slot whose left side matches
// the read's over their common suffix, and whose right side matches over
// their common prefix, each at >= num/den (matches * den >= n * num,
// n > 0), takes the read: support + 1, and each side is replaced by the
// read's when the read's is strictly longer.  Otherwise the read opens a
// new slot, or, with max_slots slots open, sets the group's overflow flag
// and merges nowhere.
//
// What bounds it on the H100: the dependent chain of a group's reads.
// Each read compares bytes against every live slot (loads, no FLOPs), and
// the next read cannot start before the first match is known.
//
// What the design does about it:
// - One block per group; groups are independent and fill the SMs.
// - No slot sequences are carried: a side is replaced wholesale, so slot
//   s's left side is the input row seq_l[src_l[s]].  The slot state is
//   (src_l, src_r, support) in the output arrays; a slot's lengths are
//   the input lengths of its sources.  max_slots = G costs no memory.
// - Warps take slots (slot w, w + warps, ...), lanes take positions
//   (neighbouring lanes read neighbouring bytes), and a warp shuffle sums
//   the matches; the first matching slot is a shared atomicMin.  A warp
//   stops at its own first match (its later slots cannot be first).
// - Thread 0 applies the read; two barriers per read.
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ int warp_sum(int v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__global__ void consensus_scan_kernel(
    const uint8_t* __restrict__ seq_l, const int* __restrict__ len_l, int LL,
    const uint8_t* __restrict__ seq_r, const int* __restrict__ len_r, int LR,
    const int* __restrict__ n_reads, int G, int S, long long num,
    long long den, int* support, int* n_slots, int* slot_of,
    uint8_t* overflow, int* src_l, int* src_r) {
  const int k = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n_warps = blockDim.x >> 5;
  const size_t gk = (size_t)k * G;
  const uint8_t* sl = seq_l + gk * LL;
  const uint8_t* sr = seq_r + gk * LR;
  const int* ll = len_l + gk;
  const int* lr = len_r + gk;
  int* sup = support + (size_t)k * S;
  int* srl = src_l + (size_t)k * S;
  int* srr = src_r + (size_t)k * S;
  int* slot = slot_of + gk;

  __shared__ int s_n;       // live slots
  __shared__ int s_first;   // first matching slot of the current read
  __shared__ int s_over;
  for (int s = tid; s < S; s += blockDim.x) {
    sup[s] = 0;
    srl[s] = -1;
    srr[s] = -1;
  }
  for (int g = tid; g < G; g += blockDim.x) slot[g] = -1;
  if (tid == 0) {
    s_n = 0;
    s_over = 0;
  }
  int n = n_reads[k];
  if (n > G) n = G;
  __syncthreads();

  for (int g = 0; g < n; ++g) {
    if (tid == 0) s_first = INT_MAX;
    __syncthreads();
    const int live = s_n;
    const int rl = ll[g];
    const int rr = lr[g];
    const uint8_t* ql = sl + (size_t)g * LL;
    const uint8_t* qr = sr + (size_t)g * LR;
    for (int s = warp; s < live; s += n_warps) {
      // left sides are right-aligned in LL: compare the common suffix
      const int a = srl[s];
      const int nl = min(ll[a], rl);
      const uint8_t* pl = sl + (size_t)a * LL;
      int m = 0;
      for (int p = LL - 1 - lane; p >= LL - nl; p -= 32) m += pl[p] == ql[p];
      m = warp_sum(m);
      if (nl <= 0 || (long long)m * den < (long long)nl * num) continue;
      // right sides are left-aligned in LR: compare the common prefix
      const int b = srr[s];
      const int nr = min(lr[b], rr);
      const uint8_t* pr = sr + (size_t)b * LR;
      m = 0;
      for (int p = lane; p < nr; p += 32) m += pr[p] == qr[p];
      m = warp_sum(m);
      if (nr <= 0 || (long long)m * den < (long long)nr * num) continue;
      if (lane == 0) atomicMin(&s_first, s);
      break;
    }
    __syncthreads();
    if (tid == 0) {
      const int t = s_first;
      if (t != INT_MAX) {
        sup[t] += 1;
        if (rl > ll[srl[t]]) srl[t] = g;
        if (rr > lr[srr[t]]) srr[t] = g;
        slot[g] = t;
      } else if (s_n < S) {
        const int t2 = s_n++;
        sup[t2] = 1;
        srl[t2] = g;
        srr[t2] = g;
        slot[g] = t2;
      } else {
        s_over = 1;
      }
    }
    __syncthreads();
  }
  if (tid == 0) {
    n_slots[k] = s_n;
    overflow[k] = (uint8_t)s_over;
  }
}

}  // namespace

// seq_l [NG, G, LL] uint8 right-aligned, len_l [NG, G] int32; seq_r
// [NG, G, LR] uint8 left-aligned, len_r [NG, G] int32; n_reads [NG] int32.
// Writes support, src_l, src_r [NG, S] int32 (-1: no source), n_slots
// [NG] int32, slot_of [NG, G] int32 (-1: not merged), overflow [NG] uint8.
extern "C" int seeksv_consensus_scan(const uint8_t* seq_l, const int* len_l,
                                     int LL, const uint8_t* seq_r,
                                     const int* len_r, int LR,
                                     const int* n_reads, int NG, int G, int S,
                                     long long num, long long den,
                                     int* support, int* n_slots, int* slot_of,
                                     uint8_t* overflow, int* src_l,
                                     int* src_r, void* stream) {
  if (NG <= 0) return 0;
  if (G < 0 || S < 1 || LL < 1 || LR < 1 || den < 1 || num < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  consensus_scan_kernel<<<NG, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      seq_l, len_l, LL, seq_r, len_r, LR, n_reads, G, S, num, den, support,
      n_slots, slot_of, overflow, src_l, src_r);
  return static_cast<int>(cudaGetLastError());
}
