// K3 sorted_intersect_mask: mask[i] = keys[i] in cands, both sorted.
//
// Replaces the TPU kernel repro/kernels/columnar_ops.py:_intersect_kernel
// (host wrapper _intersect_pallas), whose rolled loop compares every key
// block against each of the m candidates in f32: O(n * m) compares and
// exact only below 2**24.  Here every compare is in the promoted dtype
// (int64 or float64), as the exact x64 searchsorted does (_intersect_core).
// With an exclusive cumsum the bitmap is the LSM merge rank
// (sorted_merge_take).
//
// Bound: memory for the streamed keys and candidates (8n + 8m bytes in, n
// out).  The first design ran one independent binary search per key
// straight from global memory: 16 dependent L1/L2 loads a key at m =
// 2**16, ten times the bound.  This one tiles the sorted keys:
//   - a CTA owns a tile of K3_TILE keys, K3_PER_THREAD a thread, strided
//     by the block so every load and store is coalesced (1,024 keys, two
//     a thread: the fastest of five tilings at the merge shape,
//     scripts/probes/intersect_variants.py);
//   - the tile's candidate window must hold lb(k) for every key k of the
//     tile, so it spans the brackets of lb(first key) and lb(last key).
//     A block-wide search narrows both by K3_THREADS probes a round.  The
//     first round's probes sit at fixed places (every m / K3_THREADS-th
//     candidate), so they load together with the tile's keys; further
//     rounds run only while the window exceeds the stage (none at the
//     merge shape, where the first round leaves ~500 candidates);
//   - the window comes into shared memory in coalesced chunks of
//     K3_STAGE candidates, and every key finds the last candidate <= it
//     there (a hit where that candidate is the key), the thread's
//     K3_PER_THREAD searches interleaved and halving a range of one width
//     for all, so a step is a load, a compare and a select.  A window
//     wider than the stage (candidates that are no subset of the keys, as
//     PK bitmaps give them) is walked chunk by chunk in the same loop;
//   - a key outside [first, last] (keys that are not sorted) is searched
//     over all of cands from global memory after the loop, so the mask is
//     exact for any key order.
// Lanes at or past n (pow2 padding) are written false.
#include "common.cuh"

#ifndef K3_THREADS
#define K3_THREADS 512
#endif
#ifndef K3_PER_THREAD
#define K3_PER_THREAD 2
#endif
#ifndef K3_STAGE
#define K3_STAGE 4096
#endif
constexpr int K3_TILE = K3_THREADS * K3_PER_THREAD;

// One round of the block-wide search: [a, b] holds the lower bound (first
// i with !(c[i] < x)); probes a + t*s for t < n held c < x and the one at
// t = n failed or left [a, b), so the answer lies between them.
__device__ __forceinline__ void narrow(int64_t& a, int64_t& b, int64_t s,
                                       int n) {
  if (a < b) {
    const int64_t hi = a + n * s < b ? a + n * s : b;
    a = n ? a + (n - 1) * s + 1 : a;
    b = n ? hi : a;
  }
}

template <typename T>
__global__ void __launch_bounds__(K3_THREADS)
sorted_intersect_tile_kernel(const T* __restrict__ keys, int64_t n,
                             const T* __restrict__ cands, int64_t m,
                             uint8_t* __restrict__ out, int64_t n_out) {
  __shared__ T win[K3_STAGE];
  const int64_t t0 = static_cast<int64_t>(blockIdx.x) * K3_TILE;
  if (t0 >= n) {                          // a tile of padding lanes only
    for (int64_t i = t0 + threadIdx.x; i < t0 + K3_TILE && i < n_out;
         i += K3_THREADS)
      out[i] = 0;
    return;
  }
  const int64_t t_end = t0 + K3_TILE < n ? t0 + K3_TILE : n;
  // the first round's probes sit at fixed places: load them with the keys
  const int64_t s = (m + K3_THREADS - 1) / K3_THREADS;
  const int64_t ip = threadIdx.x * s;
  const T probe = ip < m ? cands[ip] : T(0);
  T k[K3_PER_THREAD];
#pragma unroll
  for (int j = 0; j < K3_PER_THREAD; ++j) {
    const int64_t i = t0 + threadIdx.x + j * K3_THREADS;
    k[j] = i < t_end ? keys[i] : T(0);
  }
  const T lo = keys[t0], hi = keys[t_end - 1];
  // the window [a0, b1] holds lb(k) for every lo <= k <= hi: narrow the
  // brackets of lb(lo) and lb(hi) until it fits the stage or both close
  int64_t a0 = 0, b0 = m, a1 = 0, b1 = m;
  int n0 = __syncthreads_count(ip < m && probe < lo);
  int n1 = __syncthreads_count(ip < m && probe < hi);
  narrow(a0, b0, s, n0);
  narrow(a1, b1, s, n1);
  while ((b1 < m ? b1 + 1 : m) - a0 > K3_STAGE && (a0 < b0 || a1 < b1)) {
    const int64_t s0 = (b0 - a0 + K3_THREADS - 1) / K3_THREADS;
    const int64_t s1 = (b1 - a1 + K3_THREADS - 1) / K3_THREADS;
    const int64_t i0 = a0 + threadIdx.x * s0, i1 = a1 + threadIdx.x * s1;
    n0 = __syncthreads_count(i0 < b0 && cands[i0] < lo);
    n1 = __syncthreads_count(i1 < b1 && cands[i1] < hi);
    narrow(a0, b0, s0, n0);
    narrow(a1, b1, s1, n1);
  }
  const int64_t L = a0;
  int64_t H = b1 < m ? b1 + 1 : m;
  if (H < L) H = L;                       // lo > hi: keys not sorted
  bool cov[K3_PER_THREAD], hit[K3_PER_THREAD];
#pragma unroll
  for (int j = 0; j < K3_PER_THREAD; ++j) {
    const int64_t i = t0 + threadIdx.x + j * K3_THREADS;
    // lo <= k <= hi puts lb(k) inside [L, H]
    cov[j] = i < t_end && lo <= k[j] && k[j] <= hi;
    hit[j] = false;
  }
  for (int64_t cs = L; cs < H; cs += K3_STAGE) {
    const int len = static_cast<int>(H - cs < K3_STAGE ? H - cs : K3_STAGE);
    __syncthreads();                      // the last chunk's reads are done
#pragma unroll 4
    for (int i = threadIdx.x; i < len; i += K3_THREADS)
      win[i] = cands[cs + i];
    __syncthreads();
#ifdef K3_PROBE_NO_SEARCH               // scripts/probes: the window alone
#pragma unroll
    for (int j = 0; j < K3_PER_THREAD; ++j)
      hit[j] = hit[j] || (cov[j] && win[threadIdx.x % len] == k[j]);
#else
    // the last candidate <= k in the chunk, halving a range whose width
    // is the same for every thread: a load, a compare and a select a step
    int at[K3_PER_THREAD];
#pragma unroll
    for (int j = 0; j < K3_PER_THREAD; ++j) at[j] = 0;
#ifdef K3_PROBE_STEPS                   // scripts/probes: the first steps
    for (int w = len, c = 0; w > 1 && c < K3_PROBE_STEPS; ++c) {
#else
    for (int w = len; w > 1;) {
#endif
      const int half = w >> 1;
      T v[K3_PER_THREAD];
#pragma unroll
      for (int j = 0; j < K3_PER_THREAD; ++j) v[j] = win[at[j] + half];
#pragma unroll
      for (int j = 0; j < K3_PER_THREAD; ++j)
        at[j] = v[j] <= k[j] ? at[j] + half : at[j];
      w -= half;
    }
#pragma unroll
    for (int j = 0; j < K3_PER_THREAD; ++j)
      hit[j] = hit[j] || (cov[j] && win[at[j]] == k[j]);
#endif
  }
#pragma unroll
  for (int j = 0; j < K3_PER_THREAD; ++j) {
    const int64_t i = t0 + threadIdx.x + j * K3_THREADS;
    if (i < t_end && !cov[j]) {           // exact search from global memory
      int64_t a = 0, b = m;
      while (a < b) {
        const int64_t mid = a + ((b - a) >> 1);
        if (cands[mid] < k[j]) a = mid + 1; else b = mid;
      }
      hit[j] = a < m && cands[a] == k[j];
    }
    if (i < n_out) out[i] = static_cast<uint8_t>(hit[j]);
  }
}

// keys: n real keys (n_out >= n output lanes), cands: m sorted candidates,
// both int64 (is_f64 == 0) or float64 (is_f64 == 1) on the device.
extern "C" int rt_sorted_intersect(const void* keys, int64_t n,
                                   const void* cands, int64_t m, int is_f64,
                                   uint8_t* out, int64_t n_out,
                                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t tiles = (n_out + K3_TILE - 1) / K3_TILE;
  const int blocks = static_cast<int>(tiles > 0 ? tiles : 1);
  if (is_f64)
    sorted_intersect_tile_kernel<double><<<blocks, K3_THREADS, 0, s>>>(
        static_cast<const double*>(keys), n,
        static_cast<const double*>(cands), m, out, n_out);
  else
    sorted_intersect_tile_kernel<int64_t><<<blocks, K3_THREADS, 0, s>>>(
        static_cast<const int64_t*>(keys), n,
        static_cast<const int64_t*>(cands), m, out, n_out);
  return static_cast<int>(cudaGetLastError());
}
