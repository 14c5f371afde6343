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
// What bounds it on the H100: the bytes of the live sides (the suffix
// len_l of each left row, the prefix len_r of each right row; the padding
// of the [NG, G, L] tensors is never needed) and, inside a group, the
// dependent chain of its reads: the next read cannot start before the
// first match of this one is known.  What stands between a kernel and the
// bound is the latency of that chain (every step a round trip to device
// memory when the slot state lives there), idle lanes and barriers where a
// whole block waits on a group whose live slots are one or two, and too
// few groups in flight to hide the distance to the bytes.
//
// What the design does about it:
// - No slot sequences are carried: a side is replaced wholesale, so slot
//   s's left side is the input row seq_l[src_l[s]].  The slot state is
//   (src_l, src_r, support); it lives in shared memory beside the group's
//   len_l / len_r for the whole group and is written to the output arrays
//   once at the end.
// - A warp per group, four groups a block, __syncwarp only, in one launch.
//   A call has thousands of groups and a group few live slots, so warps
//   running whole groups side by side keep the card busier than blocks
//   waiting on barriers.  The kernel is persistent: a warp walks the
//   groups in the order of ops/consensus_scan.py:plan_groups (falling
//   live bytes) with the grid's stride, so the largest groups start at
//   once.  A group of one read takes no compare.
// - The sides are compared where they lie, in the input rows: each read is
//   compared against one or two slots, so its bytes are needed about that
//   often, and the warps of the other groups (the registers allow 24 a
//   multiprocessor) hide the distance.  Staging a group's live bytes into
//   shared memory first (16-byte cp.async frames) was built and measured:
//   at 6 to 45 reads of about 1 KB a side it costs the warps in flight and
//   was slower, so it is not here.
// - Compares read four bytes a lane a step; a word's differing bytes are
//   marked in four operations, and the marks of four words share one
//   __popc.  The two sides of a compare have different phases (a row
//   starts at a multiple of LL, 999 at the flagship's shape), so one is
//   read as aligned words and the other as two aligned words joined by a
//   funnel shift; the at most three bytes before the first whole word and
//   after the last are compared one a lane, and the steps in which every
//   lane has a word run without a predicate.  A read's two sides are
//   compared side by side, their loads in flight together; what limits
//   the kernel is then the int32 operations a compared word costs.
// - A group too long for its lengths and slot state to fit the warp's
//   shared memory (kStateCap) keeps them in device memory (the slot state
//   in the output arrays), in the same loop.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarps = 4;  // groups a block, a warp each
// the most shared memory a warp takes for a group's lengths and slot state:
// four warps' worth stays inside the 48 KB a block has without opting in
constexpr int kStateCap = 12 * 1024;

struct Args {
  const uint8_t* seq_l;
  const int* len_l;
  int LL;
  const uint8_t* seq_r;
  const int* len_r;
  int LR;
  const int* n_reads;
  int G, S;
  long long num, den;
  int* support;
  int* n_slots;
  int* slot_of;
  uint8_t* overflow;
  int* src_l;
  int* src_r;
  const int* order;
};

// A stored length cut to its row: [0, cap].
__device__ __forceinline__ int length_at(const int* len, int i, int cap) {
  return max(0, min(len[i], cap));
}

// 0x80 in every byte in which the words x and y differ.
__device__ __forceinline__ uint32_t differing_bytes(uint32_t x, uint32_t y) {
  const uint32_t d = x ^ y;
  return (((d & 0x7F7F7F7Fu) + 0x7F7F7F7Fu) | d) & 0x80808080u;
}

// One compare of n > 0 positions, a[p] against b[p].  The positions before
// b's first aligned word and after its last whole one (at most three each)
// are compared byte by byte, one a lane.  The whole words between are read
// from b aligned, four positions a lane a step, and from a as the aligned
// word under the same positions joined to the next by a funnel shift (a's
// offset from b's word grid is the same at every step; on the grid the
// word itself).  Every word read holds at least one byte of the compared
// range.
struct Compare {
  const uint8_t* fa;  // the aligned word under a's first whole-word position
  const uint8_t* b1;  // b's first aligned word
  int oa;             // a's offset from b's word grid
  int nfull;          // whole words of b
  int edge;           // the lane's share of the bytes compared one by one

  __device__ __forceinline__ Compare(const uint8_t* a, const uint8_t* b,
                                     int n, int lane) {
    const int head = min(n, (int)(-reinterpret_cast<uintptr_t>(b) & 3));
    const int tail = (n - head) & 3;
    nfull = (n - head) >> 2;
    edge = 0;
    if (lane < head + tail) {
      const int p = lane < head ? lane : n - tail + (lane - head);
      edge = a[p] == b[p];
    }
    b1 = b + head;
    oa = (int)(reinterpret_cast<uintptr_t>(a + head) & 3);
    fa = a + head - oa;
  }
};

constexpr int kBatch = 4;  // words a lane loads before it compares any

// The lane's words of kBatch steps from word `base` on.  kWhole: every
// lane has a word at every step; else a lane past the last word gets words
// that differ in every byte.  kShift: a is off b's grid.
template <bool kWhole, bool kShift>
__device__ __forceinline__ void load_words(const Compare& c, int base,
                                           int lane, uint32_t (&bw)[kBatch],
                                           uint32_t (&aw)[kBatch]) {
  uint32_t lo[kBatch], hi[kBatch];
#pragma unroll
  for (int u = 0; u < kBatch; ++u) {
    const int t = base + 32 * u + lane;
    const bool on = kWhole || t < c.nfull;
    bw[u] = on ? *reinterpret_cast<const uint32_t*>(c.b1 + 4 * t) : 0u;
    lo[u] = on ? *reinterpret_cast<const uint32_t*>(c.fa + 4 * t) : ~0u;
    if (kShift)
      hi[u] = on ? *reinterpret_cast<const uint32_t*>(c.fa + 4 * t + 4) : ~0u;
  }
#pragma unroll
  for (int u = 0; u < kBatch; ++u)
    aw[u] = kShift ? __funnelshift_r(lo[u], hi[u], 8 * c.oa) : lo[u];
}

// The equal bytes among the lane's loaded words: the marks of the four
// words' differing bytes share one register, a bit apart, and one __popc.
__device__ __forceinline__ int count_words(const uint32_t (&bw)[kBatch],
                                           const uint32_t (&aw)[kBatch]) {
  static_assert(kBatch == 4, "four marks a byte");
  const uint32_t marks = differing_bytes(aw[0], bw[0]) |
                         (differing_bytes(aw[1], bw[1]) >> 1) |
                         (differing_bytes(aw[2], bw[2]) >> 2) |
                         (differing_bytes(aw[3], bw[3]) >> 3);
  return 4 * kBatch - __popc(marks);
}

// The lane's shares of the equal positions of two compares, made side by
// side: the words of both, kBatch steps of each, are loaded before any is
// compared, so that their latencies overlap.  The steps in which every lane
// has a word of both run without a predicate.
template <bool kShiftX, bool kShiftY>
__device__ __forceinline__ void count_eq2(const Compare& x, const Compare& y,
                                          int lane, int& mx, int& my) {
  constexpr int kStep = 32 * kBatch;
  mx = x.edge;
  my = y.edge;
  uint32_t xb[kBatch], xa[kBatch], yb[kBatch], ya[kBatch];
  const int whole = min(x.nfull, y.nfull) / kStep * kStep;
  int base = 0;
  for (; base < whole; base += kStep) {
    load_words<true, kShiftX>(x, base, lane, xb, xa);
    load_words<true, kShiftY>(y, base, lane, yb, ya);
    mx += count_words(xb, xa);
    my += count_words(yb, ya);
  }
  const int nfull = max(x.nfull, y.nfull);
  for (; base < nfull; base += kStep) {
    load_words<false, kShiftX>(x, base, lane, xb, xa);
    load_words<false, kShiftY>(y, base, lane, yb, ya);
    mx += count_words(xb, xa);
    my += count_words(yb, ya);
  }
}

// count_eq2 by whether each compare's a lies on b's word grid.
__device__ __forceinline__ void count_eq2(const Compare& x, const Compare& y,
                                          int lane, int& mx, int& my) {
  if (x.oa) {
    if (y.oa) count_eq2<true, true>(x, y, lane, mx, my);
    else count_eq2<true, false>(x, y, lane, mx, my);
  } else {
    if (y.oa) count_eq2<false, true>(x, y, lane, mx, my);
    else count_eq2<false, false>(x, y, lane, mx, my);
  }
}

// A warp walks the groups order[its index], + the number of warps, ...
// state_bytes: the bytes of dynamic shared memory a warp has.
__global__ void __launch_bounds__(kWarps * 32)
consensus_kernel(Args A, int NG, int state_bytes) {
  extern __shared__ __align__(16) uint8_t dyn[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int* const mem = reinterpret_cast<int*>(dyn + (size_t)warp * state_bytes);
  const int warps = (int)gridDim.x * kWarps;
  const int G = A.G, S = A.S, LL = A.LL, LR = A.LR;
  const long long num = A.num, den = A.den;

  for (int slot = (int)blockIdx.x * kWarps + warp; slot < NG; slot += warps) {
    const int k = A.order[slot];
    const size_t gk = (size_t)k * G;
    const uint8_t* sl = A.seq_l + gk * LL;
    const uint8_t* sr = A.seq_r + gk * LR;
    const int* gll = A.len_l + gk;
    const int* glr = A.len_r + gk;
    int* o_sup = A.support + (size_t)k * S;
    int* o_srl = A.src_l + (size_t)k * S;
    int* o_srr = A.src_r + (size_t)k * S;
    int* o_slot = A.slot_of + gk;
    const int n = max(0, min(A.n_reads[k], G));

    if (n <= 1) {
      // no read, or one that opens slot 0: nothing to compare
      for (int s = lane; s < S; s += 32) {
        o_sup[s] = s < n ? 1 : 0;
        o_srl[s] = s < n ? 0 : -1;
        o_srr[s] = s < n ? 0 : -1;
      }
      for (int g = lane; g < G; g += 32) o_slot[g] = g < n ? 0 : -1;
      if (lane == 0) {
        A.n_slots[k] = n;
        A.overflow[k] = 0;
      }
      continue;
    }

    // the warp's shared memory: len_l, len_r [n each], then the slot state
    // src_l, src_r, support [min(S, n) each]; in device memory (the state
    // in the output arrays) when they do not fit
    const int Sc = min(S, n);
    const bool on_chip = (2 * n + 3 * Sc) * 4 <= state_bytes;
    const int* ll = gll;
    const int* lr = glr;
    int* srl = o_srl;
    int* srr = o_srr;
    int* sup = o_sup;
    if (on_chip) {
      int* const s_ll = mem;
      int* const s_lr = s_ll + n;
      for (int g = lane; g < n; g += 32) {
        s_ll[g] = gll[g];
        s_lr[g] = glr[g];
      }
      ll = s_ll;
      lr = s_lr;
      srl = s_lr + n;
      srr = srl + Sc;
      sup = srr + Sc;
    }
    for (int g = n + lane; g < G; g += 32) o_slot[g] = -1;
    __syncwarp();

    int live = 0;
    bool over = false;
    for (int g = 0; g < n; ++g) {
      const int rl = length_at(ll, g, LL);
      const int rr = length_at(lr, g, LR);
      // first live byte of the read's left side, first of its right side
      const uint8_t* ql = sl + (size_t)g * LL + (LL - rl);
      const uint8_t* qr = sr + (size_t)g * LR;
      int first = -1;
      for (int s = 0; s < live; ++s) {
        // left sides are right-aligned: compare the common suffix; right
        // sides are left-aligned: compare the common prefix
        const int a = srl[s];
        const int b = srr[s];
        const int la = length_at(ll, a, LL);
        const int nl = min(la, rl);
        const int nr = min(length_at(lr, b, LR), rr);
        if (nl <= 0 || nr <= 0) continue;
        const uint8_t* pa = sl + (size_t)a * LL + (LL - la);
        const uint8_t* pb = sr + (size_t)b * LR;
        const Compare left(pa + (la - nl), ql + (rl - nl), nl, lane);
        const Compare right(pb, qr, nr, lane);
        int ml, mr;
        count_eq2(left, right, lane, ml, mr);
        ml = __reduce_add_sync(kFull, ml);
        mr = __reduce_add_sync(kFull, mr);
        if ((long long)ml * den < (long long)nl * num ||
            (long long)mr * den < (long long)nr * num)
          continue;
        first = s;
        break;
      }
      // every lane holds the same first and live; lane 0 writes the state
      const bool opens = first < 0 && live < S;
      if (lane == 0) {
        if (first >= 0) {
          sup[first] += 1;
          if (rl > length_at(ll, srl[first], LL)) srl[first] = g;
          if (rr > length_at(lr, srr[first], LR)) srr[first] = g;
          o_slot[g] = first;
        } else if (opens) {
          sup[live] = 1;
          srl[live] = g;
          srr[live] = g;
          o_slot[g] = live;
        } else {
          o_slot[g] = -1;
        }
      }
      if (opens) ++live;
      over |= first < 0 && !opens;
      __syncwarp();
    }

    for (int s = lane; s < S; s += 32) {
      const bool on = s < live;
      const int v0 = on ? sup[s] : 0;
      const int v1 = on ? srl[s] : -1;
      const int v2 = on ? srr[s] : -1;
      o_sup[s] = v0;
      o_srl[s] = v1;
      o_srr[s] = v2;
    }
    if (lane == 0) {
      A.n_slots[k] = live;
      A.overflow[k] = (uint8_t)over;
    }
    __syncwarp();  // before the next group takes the warp's shared memory
  }
}

}  // namespace

// seq_l [NG, G, LL] uint8 right-aligned, len_l [NG, G] int32; seq_r
// [NG, G, LR] uint8 left-aligned, len_r [NG, G] int32; n_reads [NG] int32.
// order [NG] int32: the groups in the order the warps take them
// (plan_groups).  Writes support, src_l, src_r [NG, S] int32 (-1: no
// source), n_slots [NG] int32, slot_of [NG, G] int32 (-1: not merged),
// overflow [NG] uint8.  One launch.
extern "C" int seeksv_consensus_scan(const uint8_t* seq_l, const int* len_l,
                                     int LL, const uint8_t* seq_r,
                                     const int* len_r, int LR,
                                     const int* n_reads, int NG, int G, int S,
                                     long long num, long long den,
                                     const int* order, int* support,
                                     int* n_slots, int* slot_of,
                                     uint8_t* overflow, int* src_l,
                                     int* src_r, void* stream) {
  if (NG <= 0) return 0;
  if (G < 0 || S < 1 || LL < 1 || LR < 1 || den < 1 || num < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int device = 0, sms = 0;
  cudaError_t rc = cudaGetDevice(&device);
  if (rc == cudaSuccess)
    rc = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  const Args A{seq_l, len_l, LL, seq_r, len_r, LR, n_reads, G, S, num, den,
               support, n_slots, slot_of, overflow, src_l, src_r, order};
  // a warp's shared memory: what a full group's lengths and state take
  const long long full = (2LL * G + 3LL * min(S, G)) * 4;
  const int state_bytes = (int)min((full + 15) & ~15LL, (long long)kStateCap);
  const int block_bytes = kWarps * state_bytes;
  // the blocks the card holds at once: the order's largest groups all
  // start together and every warp walks on with the same stride
  int resident = 0;
  rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &resident, consensus_kernel, kWarps * 32, block_bytes);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  const int grid = min((NG + kWarps - 1) / kWarps, sms * max(resident, 1));
  consensus_kernel<<<grid, kWarps * 32, block_bytes, s>>>(A, NG, state_bytes);
  return static_cast<int>(cudaGetLastError());
}
