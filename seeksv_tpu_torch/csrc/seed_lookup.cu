// K-mer table lookup of the device seeder: for every (read, offset) of a
// padded read matrix, the rolling 2k-bit hash of its k codes and its
// [lo, lo + cnt) range in the sorted k-mer table.
//
// Replaces: the hash and lookup steps of seeksv_tpu/ops/seed_device.py:
// _seed_core (:71-89), an XLA program on the TPU, whose bounded binary
// search _bounded_search_jax (:40) is a lax.while_loop on any(lo < hi):
// in eager PyTorch every iteration of that loop would be a host sync.
//
// What bounds it on the H100: dependent loads.  Each k-mer reads k codes
// of its read (neighbouring threads read neighbouring bytes), two entries
// of the prefix table and then walks two binary searches of about
// log2(bucket) dependent key loads each.  There are no FLOPs to speak of.
//
// What the design does about it: one thread per (read, offset), so the
// ~1e6 k-mers of a chunk give enough independent searches in flight to
// hide the load latency; each thread loops only as long as its own
// bucket needs.  Keys are the table's unsigned 16- or 32-bit residuals
// (template), read at their stored width.
//
// Out-of-range reads are clamped exactly as the reference's gathers are
// (JAX clamps silently; CUDA would read garbage): a hash that contains a
// code 4 can exceed the prefix table, so its bucket index is clamped to
// the table's last entry, and mid to the last key.  Such a k-mer is
// masked out of cnt, and its lo is what the clamped reference gives.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <typename Key>
__global__ void seed_lookup_kernel(const uint8_t* __restrict__ mat,
                                   const long long* __restrict__ lens,
                                   long long n_kmers, int LP, int k, int nk,
                                   const Key* __restrict__ keys,
                                   long long n_keys,
                                   const long long* __restrict__ prefix_tab,
                                   long long tab_size, int shift, int max_occ,
                                   long long* __restrict__ lo_out,
                                   long long* __restrict__ cnt_out) {
  const long long g = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= n_kmers) return;
  const long long r = g / nk;
  const int off = (int)(g - r * nk);
  const uint8_t* codes = mat + r * LP + off;
  long long h = 0;
  bool ok = off + k <= lens[r];
  for (int j = 0; j < k; ++j) {
    const int c = codes[j];
    h = (h << 2) | c;
    ok = ok && c < 4;
  }
  long long p = h >> shift;
  if (p > tab_size - 1) p = tab_size - 1;
  const long long b_lo = prefix_tab[p];
  const long long b_hi = prefix_tab[p + 1 < tab_size ? p + 1 : tab_size - 1];
  const long long q_low = h & ((1LL << shift) - 1);
  const long long cap = n_keys > 0 ? n_keys - 1 : 0;
  // leftmost key >= q_low in [b_lo, b_hi)
  long long lo = b_lo, hi = b_hi;
  while (lo < hi) {
    const long long mid = (lo + hi) >> 1;
    if ((long long)keys[mid < cap ? mid : cap] < q_low) lo = mid + 1;
    else hi = mid;
  }
  const long long left = lo;
  // first key > q_low in [left, b_hi)
  hi = b_hi;
  while (lo < hi) {
    const long long mid = (lo + hi) >> 1;
    if ((long long)keys[mid < cap ? mid : cap] <= q_low) lo = mid + 1;
    else hi = mid;
  }
  const long long cnt = lo - left;
  lo_out[g] = left;
  cnt_out[g] = (ok && cnt > 0 && cnt <= max_occ) ? cnt : 0;
}

}  // namespace

// mat [N, LP] uint8 codes (4 = ambiguous or padding), lens [N] int64;
// keys [n_keys] unsigned residuals of key_bits (16 or 32) bits; prefix_tab
// [tab_size] int64.  Writes lo and cnt, int64 [N * nk], nk = LP - k + 1.
extern "C" int seeksv_seed_lookup(const uint8_t* mat, const long long* lens,
                                  int N, int LP, int k, const void* keys,
                                  long long n_keys, int key_bits,
                                  const long long* prefix_tab,
                                  long long tab_size, int shift, int max_occ,
                                  long long* lo_out, long long* cnt_out,
                                  void* stream) {
  const int nk = LP - k + 1;
  if (N <= 0 || nk <= 0) return 0;
  if (tab_size < 1 || k < 1 || 2 * k > 62 || shift < 0 || shift > 62)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long n_kmers = (long long)N * nk;
  const int threads = 256;
  const unsigned blocks = (unsigned)((n_kmers + threads - 1) / threads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (key_bits == 16) {
    seed_lookup_kernel<uint16_t><<<blocks, threads, 0, s>>>(
        mat, lens, n_kmers, LP, k, nk, static_cast<const uint16_t*>(keys),
        n_keys, prefix_tab, tab_size, shift, max_occ, lo_out, cnt_out);
  } else if (key_bits == 32) {
    seed_lookup_kernel<uint32_t><<<blocks, threads, 0, s>>>(
        mat, lens, n_kmers, LP, k, nk, static_cast<const uint32_t*>(keys),
        n_keys, prefix_tab, tab_size, shift, max_occ, lo_out, cnt_out);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
