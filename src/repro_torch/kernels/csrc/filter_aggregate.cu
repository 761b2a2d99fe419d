// K2 fused_filter_aggregate: K1's conjunctive mask fused with count and,
// per aggregate column, valid-count / sum / min / max in one pass.
//
// Replaces the TPU kernel repro/kernels/columnar_ops.py:_agg_kernel (host
// wrapper _agg_pallas), which accumulates f32 partials across a
// sequential row-block grid in one (8, 128) VMEM tile.  On the H100 the
// blocks run in parallel and in no order, so the reduction is two
// launches: every block writes its partials to a [blocks, W] scratch
// (W = 1 + 4M slots), then one block per slot folds that slot's partials
// in a fixed tree (thread t takes blocks t, t + 256, ... in order, then
// the same warp-shuffle and warp fold as the first pass).  Sums are int64
// or float64 in the column's own type (the exact x64 path, _agg_core); no
// floating-point atomics are used and every fold order is fixed by n, so
// a float64 sum comes out bit-identical on every run at a given n.
// min/max propagate NaN as jnp.min / jnp.max do.
//
// Bound: memory.  Each row reads (9K + 9M) bytes and the arithmetic is a
// few compares and adds.  Design: one thread per row, grid-stride, with
// the per-thread accumulators in registers (the column loop is unrolled
// to MAX_COLS with a guard, so the arrays never spill to local memory),
// then a warp-shuffle tree and a fold over the block's warps.
#include "common.cuh"

enum { OP_ADD_I = 0, OP_ADD_F = 1, OP_MIN_I = 2, OP_MIN_F = 3,
       OP_MAX_I = 4, OP_MAX_F = 5 };

#define MAX_SLOTS (1 + 4 * MAX_COLS)
#define THREADS 256

__device__ __forceinline__ int slot_op(const ColTable& a, int s) {
  if (s == 0) return OP_ADD_I;                 // survivor count
  const int j = (s - 1) >> 2, f = (s - 1) & 3;
  const bool fl = a.c[j].dtype == DT_F64;
  switch (f) {
    case 0: return OP_ADD_I;                   // valid survivors
    case 1: return fl ? OP_ADD_F : OP_ADD_I;   // sum
    case 2: return fl ? OP_MIN_F : OP_MIN_I;
    default: return fl ? OP_MAX_F : OP_MAX_I;
  }
}

__device__ __forceinline__ int64_t ident(int op) {
  switch (op) {
    case OP_MIN_I: return INT64_MAX;
    case OP_MAX_I: return INT64_MIN;
    case OP_MIN_F: return 0x7ff0000000000000LL;              // +inf bits
    case OP_MAX_F: return static_cast<int64_t>(0xfff0000000000000ULL);
    default: return 0;                                    // 0 and 0.0
  }
}

__device__ __forceinline__ int64_t combine(int op, int64_t a, int64_t b) {
  switch (op) {
    case OP_ADD_I:   // two's-complement wrap, like an int64 jnp.sum
      return static_cast<int64_t>(static_cast<uint64_t>(a) +
                                  static_cast<uint64_t>(b));
    case OP_ADD_F:
      return __double_as_longlong(__longlong_as_double(a) +
                                  __longlong_as_double(b));
    case OP_MIN_I: return b < a ? b : a;
    case OP_MAX_I: return b > a ? b : a;
    case OP_MIN_F: {
      const double x = __longlong_as_double(a), y = __longlong_as_double(b);
      if (isnan(x)) return a;
      if (isnan(y)) return b;
      return y < x ? b : a;
    }
    default: {  // OP_MAX_F
      const double x = __longlong_as_double(a), y = __longlong_as_double(b);
      if (isnan(x)) return a;
      if (isnan(y)) return b;
      return y > x ? b : a;
    }
  }
}

__device__ __forceinline__ int64_t load_bits(const ColDesc& d, int64_t i) {
  if (d.dtype == DT_I32)
    return static_cast<int64_t>(static_cast<const int32_t*>(d.data)[i]);
  return static_cast<const int64_t*>(d.data)[i];   // int64 or f64 bits
}

// Fixed-order block fold of one slot: warp-shuffle tree, then warp 0's
// lanes fold the eight warp results in warp order.  Result in thread 0.
__device__ __forceinline__ int64_t block_fold(int op, int64_t v,
                                              int64_t* sh) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int off = 16; off > 0; off >>= 1)
    v = combine(op, v, static_cast<int64_t>(__shfl_down_sync(
                           0xffffffffu, static_cast<long long>(v), off)));
  if (lane == 0) sh[warp] = v;
  __syncthreads();
  int64_t r = sh[0];
  if (threadIdx.x == 0)
    for (int w = 1; w < THREADS / 32; ++w) r = combine(op, r, sh[w]);
  __syncthreads();
  return r;
}

__global__ void __launch_bounds__(THREADS)
agg_partial_kernel(ColTable p, ColTable a, int64_t n, int64_t* part) {
  const int W = 1 + 4 * a.n;
  int64_t acc[MAX_SLOTS];
#pragma unroll
  for (int s = 0; s < MAX_SLOTS; ++s)
    acc[s] = ident(slot_op(a, s < W ? s : 0));

  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       i < n; i += stride) {
    if (!row_ok(p, i)) continue;
    acc[0] += 1;
#pragma unroll
    for (int j = 0; j < MAX_COLS; ++j) {
      if (j < a.n && a.c[j].valid[i]) {
        const int64_t x = load_bits(a.c[j], i);
        acc[1 + 4 * j] += 1;
        acc[2 + 4 * j] = combine(slot_op(a, 2 + 4 * j), acc[2 + 4 * j], x);
        acc[3 + 4 * j] = combine(slot_op(a, 3 + 4 * j), acc[3 + 4 * j], x);
        acc[4 + 4 * j] = combine(slot_op(a, 4 + 4 * j), acc[4 + 4 * j], x);
      }
    }
  }

  __shared__ int64_t sh[THREADS / 32];
#pragma unroll
  for (int s = 0; s < MAX_SLOTS; ++s) {
    if (s < W) {
      const int64_t r = block_fold(slot_op(a, s), acc[s], sh);
      if (threadIdx.x == 0)
        part[static_cast<int64_t>(blockIdx.x) * W + s] = r;
    }
  }
}

// Fold the [blocks, W] partials: block s of the grid folds slot s, thread
// t taking blocks t, t + THREADS, ... in order.  Slot 0 goes to out[0],
// column j's four slots to out[1 + 4 * (col_base + j) ...].
__global__ void __launch_bounds__(THREADS)
agg_final_kernel(ColTable a, const int64_t* part, int blocks, int col_base,
                 int64_t* out) {
  const int W = 1 + 4 * a.n;
  const int s = blockIdx.x;
  const int op = slot_op(a, s);
  int64_t v = ident(op);
  for (int b = threadIdx.x; b < blocks; b += THREADS)
    v = combine(op, v, part[static_cast<int64_t>(b) * W + s]);
  __shared__ int64_t sh[THREADS / 32];
  const int64_t r = block_fold(op, v, sh);
  if (threadIdx.x == 0) out[s == 0 ? 0 : s + 4 * col_base] = r;
}

// preds: k <= MAX_COLS predicate descriptors; aggs: m aggregate columns
// (any number, folded MAX_COLS at a time).  part: int64[blocks, 1 + 4 *
// MAX_COLS] scratch; out: int64[1 + 4m], float slots as raw f64 bits.
extern "C" int rt_filter_aggregate(const ColDesc* preds, int k,
                                   const ColDesc* aggs, int m, int64_t n,
                                   int blocks, int64_t* part, int64_t* out,
                                   void* stream) {
  if (k > MAX_COLS) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  ColTable p;
  p.n = k;
  for (int j = 0; j < k; ++j) p.c[j] = preds[j];
  int g = 0;
  do {
    ColTable a;
    a.n = m - g < MAX_COLS ? m - g : MAX_COLS;
    for (int j = 0; j < a.n; ++j) a.c[j] = aggs[g + j];
    agg_partial_kernel<<<blocks, THREADS, 0, s>>>(p, a, n, part);
    agg_final_kernel<<<1 + 4 * a.n, THREADS, 0, s>>>(a, part, blocks, g,
                                                     out);
    g += MAX_COLS;
  } while (g < m);
  return static_cast<int>(cudaGetLastError());
}
