// A7 bitset_intersect_counts: popcount(bits[ai[p]] & bits[bi[p]]) per
// pair p, over the [R, W] vocabulary bitsets of a FuzzyJoin's records.
//
// Replaces the jit core repro/kernels/fuzzy_ops.py:_popcount_inter_core,
// where XLA gathers both rows, ANDs them and row-reduces
// population_count.  Here one warp takes one pair: lane w reads words w,
// w + 32, ... of both gathered rows (for the usual W <= 32, one coalesced
// 128-byte load per row), ANDs them, counts bits with __popc, and the
// warp folds its 32 partial counts with shuffles into one int64.  The
// gather is fused: the rows are read straight from the pooled record
// matrix, never materialized.
//
// Bound: memory.  A pair reads 8 * W bytes of bitsets plus 16 bytes of
// indices and writes 8 bytes; the popcounts are one instruction a word.
// Records recur across pairs, so L2 serves many of the row reads.
#include "common.cuh"

__global__ void bitset_intersect_kernel(const uint32_t* bits, int64_t W,
                                        const int64_t* ai,
                                        const int64_t* bi, int64_t P,
                                        int64_t* out) {
  const int lane = threadIdx.x & 31;
  const int64_t warp = (static_cast<int64_t>(blockIdx.x) * blockDim.x +
                        threadIdx.x) >> 5;
  const int64_t nwarps = (static_cast<int64_t>(gridDim.x) * blockDim.x) >> 5;
  for (int64_t p = warp; p < P; p += nwarps) {   // uniform within a warp
    const uint32_t* x = bits + ai[p] * W;
    const uint32_t* y = bits + bi[p] * W;
    long long c = 0;
    for (int64_t w = lane; w < W; w += 32) c += __popc(x[w] & y[w]);
    for (int off = 16; off > 0; off >>= 1)
      c += __shfl_down_sync(0xffffffffu, c, off);
    if (lane == 0) out[p] = c;
  }
}

// bits: [R, W] 32-bit words (int32 tensors on the PyTorch side, the same
// bits); ai, bi: int64 [P] row indices below R; out: int64 [P].
extern "C" int rt_bitset_intersect(const uint32_t* bits, int64_t W,
                                   const int64_t* ai, const int64_t* bi,
                                   int64_t P, int64_t* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int threads = 256;                      // 8 pairs per block
  bitset_intersect_kernel<<<grid_for(P * 32, threads, 132 * 16), threads, 0,
                            s>>>(bits, W, ai, bi, P, out);
  return static_cast<int>(cudaGetLastError());
}
