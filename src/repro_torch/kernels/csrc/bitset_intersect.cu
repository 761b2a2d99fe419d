// A7 bitset_intersect_counts: popcount(bits[ai[p]] & bits[bi[p]]) per
// pair p, over the [R, W] vocabulary bitsets of a FuzzyJoin's records.
//
// Replaces the jit core repro/kernels/fuzzy_ops.py:_popcount_inter_core,
// where XLA gathers both rows, ANDs them and row-reduces
// population_count.  The gather is fused: the rows are read straight from
// the pooled record matrix, never materialized.
//
// Bound: memory.  A pair reads 8 * W bytes of bitsets plus 16 bytes of
// indices and writes 8 bytes; the popcounts are one instruction a word.
// Records recur across pairs, so the compulsory bytes are the matrix once
// plus the indices and counts, while the row gathers move 8 * W bytes a
// pair through the caches (64 MB at 2**18 pairs of W = 32).  Design:
// a group of G lanes takes a pair, lane j of the group the row chunks j,
// j + G, ... (16-byte vectors where W is a multiple of 4 and the matrix
// is 16-byte aligned, else words); at W = 32, eight lanes read a 128-byte
// row as one line.  A warp takes 32 consecutive pairs at a time: one
// coalesced load of their 32 index pairs (started an iteration ahead),
// shuffled to the groups, then
// every row load of the G rounds of 32 / G pairs in flight before any count,
// then a reduce-scatter over the group (G - 1 shuffles) leaves each lane
// one pair's count, and the 32 counts are one coalesced store.  A block
// takes a contiguous range of pairs and the kernel uses no shared memory,
// so the rows of a FuzzyJoin's candidate order (a record's pairs in a
// run, its partners within its cluster: ~120 distinct rows in 512 pairs
// of the clustered join) are served from L1.  Staging a block's row span
// in shared memory does not pay there: that span averages ~1,500 of the
// 3,500 rows, since the pairs come in string order (both counts from
// scripts/probes/k1_a7_floor.py --spans).  One wave of as many
// blocks as the SMs hold: one or two blocks an SM ran slower
// (scripts/probes/k1_a7_floor.py).  Row indices are taken as 32-bit, so
// the matrix has fewer than 2**31 rows (popcount_cuda refuses more).
#include "common.cuh"

#define A7_THREADS 256

__device__ __forceinline__ uint32_t and_popc(uint4 a, uint4 b) {
  return __popc(a.x & b.x) + __popc(a.y & b.y) + __popc(a.z & b.z) +
         __popc(a.w & b.w);
}
__device__ __forceinline__ uint32_t and_popc(uint32_t a, uint32_t b) {
  return __popc(a & b);
}

// G lanes a pair; CPL > 0: each lane takes exactly CPL chunks of a row
// (chunks == G * CPL), CPL == 0: any number of chunks.  V is the chunk:
// uint4 (4 words) or uint32_t (1 word).  A block takes the pairs
// [blockIdx.x * per_block, + per_block) below P.
template <int G, int CPL, typename V>
__global__ void __launch_bounds__(A7_THREADS)
bitset_intersect_kernel(const V* __restrict__ bits, int64_t chunks,
                        const int64_t* __restrict__ ai,
                        const int64_t* __restrict__ bi, int64_t P,
                        int64_t per_block, int64_t* __restrict__ out) {
  constexpr int PR = 32 / G;                    // pairs a round
  const int lane = threadIdx.x & 31, g = lane / G, j = lane % G;
  const int64_t begin = static_cast<int64_t>(blockIdx.x) * per_block;
  const int64_t end = begin + per_block < P ? begin + per_block : P;
  // row indices below R < 2**31: one 32-bit shuffle each; a warp's next
  // 32 index pairs load while it counts the current ones
  const long long* ia = reinterpret_cast<const long long*>(ai);
  const long long* ib = reinterpret_cast<const long long*>(bi);
  int64_t p0 = begin + (threadIdx.x & ~31);     // uniform within a warp
  int na = p0 + lane < end ? static_cast<int>(__ldg(ia + p0 + lane)) : 0;
  int nb = p0 + lane < end ? static_cast<int>(__ldg(ib + p0 + lane)) : 0;
  for (; p0 < end; p0 += A7_THREADS) {
    const int ra = na, rb = nb;
    const int64_t pn = p0 + A7_THREADS + lane;
    na = pn < end ? static_cast<int>(__ldg(ia + pn)) : 0;
    nb = pn < end ? static_cast<int>(__ldg(ib + pn)) : 0;
#ifdef A7_PROBE_INDEX_ONLY       // scripts/probes: the index loads and stores
    if (p0 + lane < end) out[p0 + lane] = ra + rb;
#else
    uint32_t c[G];
#pragma unroll
    for (int q = 0; q < G; ++q) {               // pair q * PR + g
      const V* x = bits + static_cast<int64_t>(
          __shfl_sync(0xffffffffu, ra, q * PR + g)) * chunks;
      const V* y = bits + static_cast<int64_t>(
          __shfl_sync(0xffffffffu, rb, q * PR + g)) * chunks;
      uint32_t s = 0;
      if constexpr (CPL > 0) {
#pragma unroll
        for (int i = 0; i < CPL; ++i)
          s += and_popc(__ldg(x + j + G * i), __ldg(y + j + G * i));
      } else {
        for (int64_t i = j; i < chunks; i += G)
          s += and_popc(__ldg(x + i), __ldg(y + i));
      }
      c[q] = s;
    }
    // reduce-scatter: at step h a lane keeps the half of its pairs whose
    // bit h matches its own j and adds its partner's (lane ^ h) share of
    // them; c[0] ends as the count of pair j * PR + g
#pragma unroll
    for (int h = G / 2; h > 0; h >>= 1) {
      const bool up = j & h;
#pragma unroll
      for (int t = 0; t < h; ++t) {
        const uint32_t send = up ? c[t] : c[t + h];
        const uint32_t keep = up ? c[t + h] : c[t];
        c[t] = keep + __shfl_xor_sync(0xffffffffu, send, h);
      }
    }
    const int64_t q = p0 + j * PR + g;
    if (q < end) out[q] = c[0];
#endif
  }
}

template <int G, int CPL, typename V>
static int launch(const void* bits, int64_t chunks, const int64_t* ai,
                  const int64_t* bi, int64_t P, int64_t* out,
                  cudaStream_t s) {
  auto kern = bitset_intersect_kernel<G, CPL, V>;
  static int resident = 0;            // blocks an SM holds, found once
  if (resident == 0) {
    int b = 0;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&b, kern, A7_THREADS, 0);
    resident = b > 0 ? b : 1;
  }
  // one wave of blocks, each a contiguous range of whole warp runs
  const int64_t runs = (P + 31) / 32;
  int64_t blocks = 132 * static_cast<int64_t>(resident);
  if (blocks * (A7_THREADS / 32) > runs)
    blocks = (runs + A7_THREADS / 32 - 1) / (A7_THREADS / 32);
  if (blocks < 1) blocks = 1;
  const int64_t per_block = (runs + blocks - 1) / blocks * 32;
  kern<<<static_cast<int>(blocks), A7_THREADS, 0, s>>>(
      static_cast<const V*>(bits), chunks, ai, bi, P, per_block, out);
  return static_cast<int>(cudaGetLastError());
}

// bits: [R, W] 32-bit words (int32 tensors on the PyTorch side, the same
// bits); ai, bi: int64 [P] row indices below R; out: int64 [P].
extern "C" int rt_bitset_intersect(const uint32_t* bits, int64_t W,
                                   const int64_t* ai, const int64_t* bi,
                                   int64_t P, int64_t* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (P <= 0) return static_cast<int>(cudaGetLastError());
  // the widths the FuzzyJoins give (W = 32: one 16-byte chunk a lane;
  // W = 1: one word a pair) are unrolled, any other takes a loop
  if (W % 4 == 0 && (reinterpret_cast<uintptr_t>(bits) & 15) == 0) {
    if (W == 32) return launch<8, 1, uint4>(bits, 8, ai, bi, P, out, s);
    return launch<8, 0, uint4>(bits, W / 4, ai, bi, P, out, s);
  }
  if (W == 1) return launch<1, 1, uint32_t>(bits, 1, ai, bi, P, out, s);
  return launch<8, 0, uint32_t>(bits, W, ai, bi, P, out, s);
}
