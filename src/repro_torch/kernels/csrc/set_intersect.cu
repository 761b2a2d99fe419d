// K6 set_intersect_counts: |A_p ∩ B_p| per pair p of dictionary-coded
// sets.
//
// Replaces the TPU kernel repro/kernels/fuzzy_ops.py:_inter_kernel (host
// wrapper _inter_pallas), which compares every a element against the
// whole b row in f32 (a static unroll over S1, O(S1 * S2) compares per
// pair, exact only for codes below 2**24).  Here each live a element
// (j < alens[p]) runs a lower-bound binary search in the pair's sorted b
// row, in int64, as the reference's exact searchsorted core
// (_inter_core) does: O(S1 log S2) per pair, exact at every code width.
// The b rows are padded with INT64_MAX, which keeps them sorted and
// matches no code.
//
// Bound: memory.  A pair reads its two rows (8 * (S1 + S2) bytes) plus
// its length and writes 8 bytes, against S1 * log2(S2) compares.  Design:
// one warp per pair.  Lane l searches a elements l, l + 32, ..., so the
// warp reads the a row in coalesced 256-byte steps and its 32 searches
// probe one b row together, which L1 then serves; the warp folds its
// counts with shuffles.  (The first version ran one thread per pair: each
// thread walked its own rows, the loads were strided across the warp, and
// it took twice the time of the batched torch.searchsorted.)
#include "common.cuh"

__global__ void set_intersect_kernel(const int64_t* a, const int64_t* alens,
                                     int64_t s1, const int64_t* b,
                                     int64_t s2, int64_t P, int64_t* out) {
  const int lane = threadIdx.x & 31;
  const int64_t warp = (static_cast<int64_t>(blockIdx.x) * blockDim.x +
                        threadIdx.x) >> 5;
  const int64_t nwarps = (static_cast<int64_t>(gridDim.x) * blockDim.x) >> 5;
  for (int64_t p = warp; p < P; p += nwarps) {   // uniform within a warp
    const int64_t* ar = a + p * s1;
    const int64_t* br = b + p * s2;
    const int64_t n = alens[p] < s1 ? alens[p] : s1;
    long long count = 0;
    for (int64_t j = lane; j < n; j += 32) {
      const int64_t x = ar[j];
      int64_t lo = 0, hi = s2;
      while (lo < hi) {
        const int64_t mid = lo + ((hi - lo) >> 1);
        if (br[mid] < x) lo = mid + 1; else hi = mid;
      }
      count += lo < s2 && br[lo] == x;
    }
    for (int off = 16; off > 0; off >>= 1)
      count += __shfl_down_sync(0xffffffffu, count, off);
    if (lane == 0) out[p] = count;
  }
}

// a: int64 [P, s1] (row p live below alens[p]); b: int64 [P, s2] sorted,
// padded with INT64_MAX; out: int64 [P].
extern "C" int rt_set_intersect(const int64_t* a, const int64_t* alens,
                                int64_t s1, const int64_t* b, int64_t s2,
                                int64_t P, int64_t* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int threads = 256;                      // 8 pairs per block
  set_intersect_kernel<<<grid_for(P * 32, threads, 132 * 16), threads, 0,
                         s>>>(a, alens, s1, b, s2, P, out);
  return static_cast<int>(cudaGetLastError());
}
