// K6 set_intersect_counts: |A_p ∩ B_p| per pair p of dictionary-coded
// sets.
//
// Replaces the TPU kernel repro/kernels/fuzzy_ops.py:_inter_kernel (host
// wrapper _inter_pallas), which compares every a element against the
// whole b row in f32 (a static unroll over S1, O(S1 * S2) compares per
// pair, exact only for codes below 2**24).  Here each live a element
// (j < alens[p]) lower-bounds itself in the pair's sorted b row, in int64,
// as the reference's exact searchsorted core (_inter_core) does: O(S1 log
// S2) per pair, exact at every code width.  The a rows need not be sorted.
// The b rows are padded with INT64_MAX, which keeps them sorted.
//
// Bound: memory.  A pair reads its live a elements, its b row and its
// length, and writes 8 bytes.  The first design ran one warp per pair,
// searching b from global memory: ~7 dependent loads a search, three
// rounds of them at S1 = 67 with most lanes idle in the third, so it
// waited on latency at 3.1x its bound.  This one batches pairs:
//   - a CTA owns B consecutive pairs (chosen on the host: B * S1 fills a
//     round of K6_THREADS * K6_ITEMS items, the b rows fit K6_STAGE_BYTES,
//     and small P still spreads over the SMs; even when B >= 2, so every
//     batch starts on an even pair).  Many such CTAs share an SM, and one's
//     copies run while another counts;
//   - the batch's b rows, one contiguous span, come into shared memory by
//     16-byte cp.async.  A span that does not start on 16 bytes (an odd
//     pair with an odd S2, or an offset view) peels its first element into
//     an 8-byte copy and lands one element into its buffer, so both sides
//     of every 16-byte copy are aligned; an odd tail peels its last;
//   - while that copy is in flight every thread loads its flat (pair, j)
//     items of the batch's a span, coalesced, each only where j <
//     alens[pair], so a dead tail costs no bytes and no lane sits idle at
//     S1 = 67;
//   - each item finds the last code <= x in its b row in shared memory,
//     and it is a hit where that code is x.  The thread's K6_ITEMS
//     searches run interleaved, halving a range whose width is the same
//     for every lane, so a step is a load, a compare and a select with no
//     bound check (a guarded lower bound, its loads issued one at a time,
//     cost ~3 µs a step at the FuzzyJoin shape against ~2-2.5 now,
//     scripts/probes/intersect_variants.py).  A warp's items are
//     consecutive, so its hits fold into one shared atomic per pair it
//     touches (a segmented ballot), and the batch's counts are written
//     once.
// A b row wider than K6_STAGE_MAX_BYTES is searched from global memory by
// the same code (B = 1, nothing staged).
#include "common.cuh"

#ifndef K6_THREADS
#define K6_THREADS 256
#endif
#ifndef K6_ITEMS
#define K6_ITEMS 4
#endif
#ifndef K6_STAGE_BYTES
#define K6_STAGE_BYTES (32 * 1024)
#endif
#define K6_STAGE_MAX_BYTES (200 * 1024)
#define K6_ROUND (K6_THREADS * K6_ITEMS)

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
}

__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d),
               "l"(src));
}

// Copy n int64 from src into the 16-byte-aligned buffer buf and return
// where the span starts there: one element in when src is 8 mod 16, so
// that both sides of every 16-byte copy are aligned.  The head element
// is then peeled into an 8-byte copy, and so is an odd tail.
__device__ __forceinline__ int64_t* stage_span(int64_t* buf,
                                               const int64_t* src,
                                               int64_t n) {
  const int head = (reinterpret_cast<uintptr_t>(src) & 15) ? 1 : 0;
  int64_t* dst = buf + head;
  if (n <= head) {
    if (n == 1 && threadIdx.x == 0) cp_async8(dst, src);
  } else {
    if (head && threadIdx.x == 0) cp_async8(dst, src);
    const int64_t body = (n - head) >> 1;
    for (int64_t c = threadIdx.x; c < body; c += K6_THREADS)
      cp_async16(dst + head + 2 * c, src + head + 2 * c);
    if (((n - head) & 1) && threadIdx.x == 0)
      cp_async8(dst + n - 1, src + n - 1);
  }
  asm volatile("cp.async.commit_group;\n" ::);
  return dst;
}

template <bool STAGED>
__global__ void __launch_bounds__(K6_THREADS)
set_intersect_batch_kernel(const int64_t* __restrict__ a,
                           const int64_t* __restrict__ alens, int s1,
                           const int64_t* __restrict__ b, int s2,
                           int64_t P, int B, int64_t* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char k6_smem[];
  const int64_t p0 = static_cast<int64_t>(blockIdx.x) * B;
  const int nb = static_cast<int>(P - p0 < B ? P - p0 : B);
  int* cnt = reinterpret_cast<int*>(k6_smem);           // [B], then b rows
  const int64_t* rows = b + p0 * s2;     // row r of the batch at r * s2
  if (STAGED)
    rows = stage_span(reinterpret_cast<int64_t*>(k6_smem + ((4 * B + 15)
                                                            & ~15)),
                      rows, static_cast<int64_t>(nb) * s2);
  for (int i = threadIdx.x; i < nb; i += K6_THREADS) cnt[i] = 0;

#ifdef K6_PROBE_NO_COUNT                // scripts/probes: the copies alone
  const int items = 0;
#else
  const int items = nb * s1;
#endif
  const int lane = threadIdx.x & 31;
  const int w = s1 > 0 ? s1 : 1;          // s1 == 0: no items, no division
  const int q = K6_THREADS / w, r = K6_THREADS % w;   // item stride
  const int64_t* arow = a + p0 * s1;
  for (int base = 0;; base += K6_ROUND) {
    const int i0 = base + threadIdx.x;
    int pair = i0 / w, j = i0 - pair * w;
    int pr[K6_ITEMS];
    int64_t x[K6_ITEMS];
    bool live[K6_ITEMS];
#pragma unroll
    for (int k = 0; k < K6_ITEMS; ++k) {
      const int i = i0 + k * K6_THREADS;
      pr[k] = pair;
      live[k] = i < items && j < alens[p0 + pair];
      x[k] = live[k] ? arow[i] : 0;
      j += r;
      pair += q;
      if (j >= w) { j -= w; ++pair; }
    }
    if (base == 0) {                      // the b span has landed
      if (STAGED) asm volatile("cp.async.wait_group 0;\n" ::: "memory");
      __syncthreads();
    }
    // each item finds the last code <= x in its row (row 0 for a dead
    // item, so every load is in bounds): halving a range whose width is
    // the same for every lane, with no bound check and one compare a step
    const int64_t* row[K6_ITEMS];
    int at[K6_ITEMS];
#pragma unroll
    for (int k = 0; k < K6_ITEMS; ++k) {
      row[k] = rows + static_cast<int64_t>(live[k] ? pr[k] : 0) * s2;
      at[k] = 0;
    }
#ifdef K6_PROBE_STEPS                   // scripts/probes: the first steps
    for (int n = s2, c = 0; n > 1 && c < K6_PROBE_STEPS; ++c) {
#else
    for (int n = s2; n > 1;) {
#endif
      const int half = n >> 1;
      int64_t v[K6_ITEMS];
#pragma unroll
      for (int k = 0; k < K6_ITEMS; ++k) v[k] = row[k][at[k] + half];
#pragma unroll
      for (int k = 0; k < K6_ITEMS; ++k)
        at[k] = v[k] <= x[k] ? at[k] + half : at[k];
      n -= half;
    }
    bool hit[K6_ITEMS];
#pragma unroll
    for (int k = 0; k < K6_ITEMS; ++k)
      hit[k] = live[k] && s2 > 0 && row[k][at[k]] == x[k];
#pragma unroll
    for (int k = 0; k < K6_ITEMS; ++k) {
      // the warp's 32 items are consecutive: each run of one pair starts
      // at a lane whose left neighbour holds another pair, and that lane
      // adds the run's hits
      const unsigned hits = __ballot_sync(0xffffffffu, hit[k]);
      const int left = __shfl_up_sync(0xffffffffu, pr[k], 1);
      const bool start = lane == 0 || left != pr[k];
      const unsigned starts = __ballot_sync(0xffffffffu, start);
      if (start) {
        const unsigned later = lane == 31 ? 0u : starts >> (lane + 1);
        const int end = later ? lane + __ffs(later) : 32;   // run's end
        const unsigned run = (end == 32 ? 0xffffffffu : (1u << end) - 1u)
                             & (0xffffffffu << lane);
        const int c = __popc(hits & run);
        if (c) atomicAdd(&cnt[pr[k]], c);
      }
    }
    if (base + K6_ROUND >= items) break;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < nb; i += K6_THREADS) out[p0 + i] = cnt[i];
}

// a: int64 [P, s1] (row p live below alens[p]); b: int64 [P, s2] sorted,
// padded with INT64_MAX; out: int64 [P].
extern "C" int rt_set_intersect(const int64_t* a, const int64_t* alens,
                                int64_t s1, const int64_t* b, int64_t s2,
                                int64_t P, int64_t* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (P <= 0) return 0;
  if (s1 < 0 || s2 < 0 || s1 > (1 << 24) || s2 > (1 << 24))
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t row_bytes = 8 * s2;
  const bool staged = row_bytes <= K6_STAGE_MAX_BYTES;
  // pairs a batch: a round of items, the stage, and two CTAs an SM
  int64_t B = s1 > 0 ? K6_ROUND / s1 : K6_ROUND;
  if (staged && row_bytes > 0) {
    const int64_t fit = K6_STAGE_BYTES / row_bytes;
    B = B < fit ? B : fit;
  }
  const int64_t spread = (P + 2 * 132 - 1) / (2 * 132);
  B = B < spread ? B : spread;
  if (B >= 2) B &= ~int64_t(1);
  if (B < 1) B = 1;
  size_t smem = (4 * B + 15) & ~size_t(15);
  if (staged) smem += static_cast<size_t>(B * s2 + 1) * 8;
  auto kernel = staged ? set_intersect_batch_kernel<true>
                       : set_intersect_batch_kernel<false>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kernel<<<static_cast<unsigned>((P + B - 1) / B), K6_THREADS, smem, s>>>(
      a, alens, static_cast<int>(s1), b, static_cast<int>(s2), P,
      static_cast<int>(B), out);
  return static_cast<int>(cudaGetLastError());
}
