// K2 fused_filter_aggregate: K1's conjunctive mask fused with count and,
// per aggregate column, valid-count / sum / min / max in one pass.
//
// Replaces the TPU kernel repro/kernels/columnar_ops.py:_agg_kernel (host
// wrapper _agg_pallas), which accumulates f32 partials across a
// sequential row-block grid in one (8, 128) VMEM tile.  On the H100 the
// blocks run in parallel and in no order; here one launch does the pass
// and the cross-block fold (one launch per MAX_COLS aggregate columns):
// every block writes its partial row to a cached [W, MAX_BLOCKS] scratch
// (W = 1 + 4M slots), fences, and takes a ticket; the block that takes
// the last ticket folds all partials in block order (warp w folds slots
// w, w + 8, ...: lane l takes blocks l, l + 32, ... in order, then a
// fixed shuffle tree) and resets the ticket for the next launch on the
// stream.  Sums are int64 or float64 in the column's own type (the exact
// x64 path, _agg_core); no floating-point atomics are used.  A float64
// sum folds in the reference's own order, so it equals the reference's
// bits: XLA's CPU backend sums a pow2-padded vector in windows of 32
// consecutive values, each left to right from 0.0, then the window sums
// the same way, level by level (kernels/columnar_ops.py:tree_sum, the
// plain version).  Here each block iteration covers 2,048 rows: the warps
// stage their masked values in shared memory (a window a row of 33
// doubles, so 32 readers hit 32 banks), 64 threads sum the 64 windows, two
// threads the two 1,024-row nodes, which go to a per-column node array;
// the last block folds the nodes 32 at a time up to the root.  Padding
// adds +0.0, which changes no partial, so the root is the same at any
// pow2 n.  min/max propagate NaN as jnp.min / jnp.max do.
//
// Bound: memory.  Each row reads (9K + 9M) bytes (int32 codes 5) and the
// arithmetic is a few compares and adds.  Design: a warp takes runs of 256
// rows, lane i rows 64 k + 2 i + e (k < 4, e < 2), so each of a column's 4
// loads a lane issues is a coalesced warp access: int64 / float64 data as
// 16-byte vectors (2 rows), int32 codes as 8 bytes, validity as 2 bytes.
// (A lane of 16 consecutive rows, one 16-byte validity vector, made every
// data load touch 32 lines and ran 5x the bound.)  A column's 4 loads are
// issued together: with at most 2 aggregates every column's loads go out
// before any is evaluated, else the next column's before this one is, so
// two columns are in flight per thread.  The predicate is evaluated
// branch-free into a 16-bit row mask; each column's dtype is resolved once
// a run, not per row; the kernel is templated on the number of aggregate
// columns NA so only the 1 + 4 NA live accumulators occupy registers.  A
// run that ends past n, or a call with an operand not 16-byte aligned,
// loads the same rows one by one.
#include "common.cuh"

enum { OP_ADD_I = 0, OP_ADD_F = 1, OP_MIN_I = 2, OP_MIN_F = 3,
       OP_MAX_I = 4, OP_MAX_F = 5 };

#define THREADS 256
#define RUN 8                     // rows a thread takes at a time
#define WRUN (32 * RUN)           // rows a warp takes at a time
#define MAX_BLOCKS 264            // scratch columns (agg_blocks' cap)
#define TREE_W 32                 // the reference's float64 sum window
#define CHUNK (THREADS / 32 * WRUN)       // rows of one block iteration
#define CHUNK_WIN (CHUNK / TREE_W)        // its windows
#define NODE_ROWS (TREE_W * TREE_W)       // rows of a node (two a chunk)

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

__device__ __forceinline__ int64_t add_i(int64_t a, int64_t b) {
  // two's-complement wrap, like an int64 jnp.sum
  return static_cast<int64_t>(static_cast<uint64_t>(a) +
                              static_cast<uint64_t>(b));
}
// NaN-propagating min / max of float64 bit patterns (the first NaN wins),
// as selects
__device__ __forceinline__ int64_t min_f(int64_t a, int64_t b) {
  const double x = __longlong_as_double(a), y = __longlong_as_double(b);
  return x != x ? a : y != y ? b : y < x ? b : a;
}
__device__ __forceinline__ int64_t max_f(int64_t a, int64_t b) {
  const double x = __longlong_as_double(a), y = __longlong_as_double(b);
  return x != x ? a : y != y ? b : y > x ? b : a;
}

template <int OP>
__device__ __forceinline__ int64_t comb(int64_t a, int64_t b) {
  if constexpr (OP == OP_ADD_I) return add_i(a, b);
  else if constexpr (OP == OP_ADD_F)
    return __double_as_longlong(__longlong_as_double(a) +
                                __longlong_as_double(b));
  else if constexpr (OP == OP_MIN_I) return b < a ? b : a;
  else if constexpr (OP == OP_MAX_I) return b > a ? b : a;
  else if constexpr (OP == OP_MIN_F) return min_f(a, b);
  else return max_f(a, b);
}

// Fixed-order warp fold of one slot; the result in lane 0.
template <int OP>
__device__ __forceinline__ int64_t warp_fold_t(int64_t v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = comb<OP>(v, static_cast<int64_t>(__shfl_down_sync(
                        0xffffffffu, static_cast<long long>(v), off)));
  return v;
}

// Fold n <= MAXN values x[0], x[stride], ... in order (one thread), all
// read before the first is folded; l2: read past L1 (other blocks' data)
template <int OP, int MAXN>
__device__ __forceinline__ int64_t seq_fold(const int64_t* x, int n,
                                            int stride, bool l2) {
  int64_t v[MAXN];
#pragma unroll
  for (int i = 0; i < MAXN; ++i)
    if (i < n) v[i] = l2 ? __ldcg(x + i * stride) : x[i * stride];
  int64_t r = v[0];
#pragma unroll
  for (int i = 1; i < MAXN; ++i)
    if (i < n) r = comb<OP>(r, v[i]);
  return r;
}

// the op resolved once, outside the fold
template <int MAXN>
__device__ __forceinline__ int64_t ordered_fold(int op, const int64_t* x,
                                                int n, int stride, bool l2) {
  switch (op) {
    case OP_ADD_I: return seq_fold<OP_ADD_I, MAXN>(x, n, stride, l2);
    case OP_ADD_F: return seq_fold<OP_ADD_F, MAXN>(x, n, stride, l2);
    case OP_MIN_I: return seq_fold<OP_MIN_I, MAXN>(x, n, stride, l2);
    case OP_MAX_I: return seq_fold<OP_MAX_I, MAXN>(x, n, stride, l2);
    case OP_MIN_F: return seq_fold<OP_MIN_F, MAXN>(x, n, stride, l2);
    default: return seq_fold<OP_MAX_F, MAXN>(x, n, stride, l2);
  }
}
__device__ __forceinline__ int64_t warp_fold(int op, int64_t v) {
  switch (op) {
    case OP_ADD_I: return warp_fold_t<OP_ADD_I>(v);
    case OP_ADD_F: return warp_fold_t<OP_ADD_F>(v);
    case OP_MIN_I: return warp_fold_t<OP_MIN_I>(v);
    case OP_MAX_I: return warp_fold_t<OP_MAX_I>(v);
    case OP_MIN_F: return warp_fold_t<OP_MIN_F>(v);
    default: return warp_fold_t<OP_MAX_F>(v);
  }
}

// One column's rows of a lane's run (common.cuh's RowRun: rows
// 64 k + 2 i + e of the warp's 256, loaded by load_run, tested by
// pred_bits)
using Run = RowRun<RUN>;

// Fold the rows of `sel` into one column's (count, sum, min, max), as
// selects: a row outside `sel` adds 0 and meets the min/max identities
__device__ __forceinline__ void agg_run(const ColDesc& c, const Run& r,
                                        uint32_t sel, int64_t* acc) {
  sel &= valid_bits(r);
  acc[0] += __popc(sel);
  if (c.dtype == DT_F64) {      // the sum folds in tree order (tree_step)
#pragma unroll
    for (int i = 0; i < RUN; ++i) {
      const bool ok = (sel >> i) & 1u;
      acc[2] = min_f(acc[2], ok ? r.x[i] : ident(OP_MIN_F));
      acc[3] = max_f(acc[3], ok ? r.x[i] : ident(OP_MAX_F));
    }
  } else {
#pragma unroll
    for (int i = 0; i < RUN; ++i) {
      const bool ok = (sel >> i) & 1u;
      acc[1] = add_i(acc[1], ok ? r.x[i] : 0);
      acc[2] = ok && r.x[i] < acc[2] ? r.x[i] : acc[2];
      acc[3] = ok && r.x[i] > acc[3] ? r.x[i] : acc[3];
    }
  }
}

// One block iteration's float64 values of one column, a window a row
// (padded to 33 doubles: the 32 window readers hit 32 banks), and the
// window sums
struct TreeSmem {
  double win[CHUNK_WIN][TREE_W + 1];
  double wsum[CHUNK_WIN];
};

// Stage a float64 column's masked values of the block's chunk (rows of
// `sel` keep theirs, the rest add +0.0), sum its windows and its two
// nodes, each left to right from 0.0, and store the nodes below n_nodes
// at nodes[node0], nodes[node0 + 1].  Every thread of the block calls it.
__device__ __forceinline__ void tree_step(const Run& r, uint32_t sel,
                                          TreeSmem& ts, int warp, int lane,
                                          double* nodes, int64_t node0,
                                          int64_t n_nodes) {
#ifdef K2_PROBE_NO_TREE              // scripts/probes: no staged windows
  return;
#endif
  sel &= valid_bits(r);
  __syncthreads();                   // the previous step's readers are done
#pragma unroll
  for (int b = 0; b < RUN; ++b) {
    const int row = warp * WRUN + 64 * (b >> 1) + 2 * lane + (b & 1);
    ts.win[row / TREE_W][row % TREE_W] =
        (sel >> b) & 1u ? __longlong_as_double(r.x[b]) : 0.0;
  }
  __syncthreads();
  if (threadIdx.x < CHUNK_WIN) {
    double s = 0.0;
#pragma unroll
    for (int q = 0; q < TREE_W; ++q) s += ts.win[threadIdx.x][q];
    ts.wsum[threadIdx.x] = s;
  }
  __syncthreads();
  if (threadIdx.x < CHUNK / NODE_ROWS && node0 + threadIdx.x < n_nodes) {
    double s = 0.0;
#pragma unroll
    for (int q = 0; q < TREE_W; ++q) s += ts.wsum[threadIdx.x * TREE_W + q];
    nodes[node0 + threadIdx.x] = s;
  }
}

// One launch: every block folds its runs and writes its partial row
// part[s * MAX_BLOCKS + block]; the last block to finish folds them all
// into out (slot 0 to out[0], aggregate column j's four slots to
// out[1 + 4 * (col_base + j) ...]); a float64 column j's 1,024-row node
// sums go to nodes[j * node_stride ...], whose tail holds the upper levels.
template <int NA>
__global__ void __launch_bounds__(THREADS)
agg_kernel(ColTable p, ColTable a, int64_t n, int vec, int64_t* part,
           unsigned int* ticket, int col_base, int64_t* out, double* nodes,
           int64_t node_stride) {
  __shared__ TreeSmem ts;
  constexpr int W = 1 + 4 * NA;
  int64_t cnt = 0;
  int64_t acc[NA > 0 ? NA : 1][4];
#pragma unroll
  for (int j = 0; j < NA; ++j) {
    const bool fl = a.c[j].dtype == DT_F64;
    acc[j][0] = 0;
    acc[j][1] = 0;
    acc[j][2] = ident(fl ? OP_MIN_F : OP_MIN_I);
    acc[j][3] = ident(fl ? OP_MAX_F : OP_MAX_I);
  }
  const int k = p.n;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t wruns = (n + WRUN - 1) / WRUN;
  const int64_t n_nodes = (n + NODE_ROWS - 1) / NODE_ROWS;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * (THREADS / 32);
  // every warp of a block runs the same iterations (tree_step syncs the
  // block); a warp whose run lies past n loads nothing and masks all rows
  for (int64_t wr0 = static_cast<int64_t>(blockIdx.x) * (THREADS / 32);
       wr0 < wruns; wr0 += stride) {
    const int64_t wr = wr0 + warp;
    const int64_t node0 = wr0 * WRUN / NODE_ROWS;
    const int64_t base = wr * WRUN + 2 * lane;   // the lane's first row
    const bool fast = vec && wr * WRUN + WRUN <= n;
    uint32_t mask = 0;
#pragma unroll
    for (int b = 0; b < RUN; ++b)
      mask |= static_cast<uint32_t>(base + 64 * (b >> 1) + (b & 1) < n) << b;
    if constexpr (NA <= 2) {
      // every column in flight at once: the aggregates first, then the
      // predicates two at a time (pb[c & 1])
      Run ab[NA > 0 ? NA : 1], pb[2];
#pragma unroll
      for (int j = 0; j < NA; ++j) load_run(a.c[j], base, n, fast, ab[j]);
      if (k > 0) load_run(p.c[0], base, n, fast, pb[0]);
#pragma unroll
      for (int c = 0; c < MAX_COLS; ++c) {
        if (c < k) {
          if (c + 1 < k)
            load_run(p.c[c + 1], base, n, fast, pb[(c + 1) & 1]);
          mask &= pred_bits(p.c[c], pb[c & 1]);
        }
      }
      cnt += __popc(mask);
#pragma unroll
      for (int j = 0; j < NA; ++j) {
        agg_run(a.c[j], ab[j], mask, acc[j]);
        if (a.c[j].dtype == DT_F64)
          tree_step(ab[j], mask, ts, warp, lane, nodes + j * node_stride,
                    node0, n_nodes);
      }
    } else {
      // predicate c's run sits in pb[c & 1], aggregate j's in ab[j & 1]
      // (both unrolled, so no run is copied); each column's successor is
      // issued before the column is evaluated
      Run pb[2], ab[2];
      if (k > 0) load_run(p.c[0], base, n, fast, pb[0]);
      else load_run(a.c[0], base, n, fast, ab[0]);
#pragma unroll
      for (int c = 0; c < MAX_COLS; ++c) {
        if (c < k) {
          if (c + 1 < k)
            load_run(p.c[c + 1], base, n, fast, pb[(c + 1) & 1]);
          else
            load_run(a.c[0], base, n, fast, ab[0]);
          mask &= pred_bits(p.c[c], pb[c & 1]);
        }
      }
      cnt += __popc(mask);
#pragma unroll
      for (int j = 0; j < NA; ++j) {
        if (j + 1 < NA)
          load_run(a.c[j + 1], base, n, fast, ab[(j + 1) & 1]);
        agg_run(a.c[j], ab[j & 1], mask, acc[j]);
        if (a.c[j].dtype == DT_F64)
          tree_step(ab[j & 1], mask, ts, warp, lane,
                    nodes + j * node_stride, node0, n_nodes);
      }
    }
  }

  // block fold: a shuffle tree a slot, then the warps in order
  __shared__ int64_t sh[THREADS / 32][W];
  __shared__ bool last;
  // a column's four slots in one branch on its type, so their shuffle
  // trees interleave
  {
    const int64_t r = warp_fold_t<OP_ADD_I>(cnt);
    if (lane == 0) sh[warp][0] = r;
  }
#pragma unroll
  for (int j = 0; j < NA; ++j) {
    int64_t r[4];
    r[0] = warp_fold_t<OP_ADD_I>(acc[j][0]);
    if (a.c[j].dtype == DT_F64) {
      r[1] = warp_fold_t<OP_ADD_F>(acc[j][1]);
      r[2] = warp_fold_t<OP_MIN_F>(acc[j][2]);
      r[3] = warp_fold_t<OP_MAX_F>(acc[j][3]);
    } else {
      r[1] = warp_fold_t<OP_ADD_I>(acc[j][1]);
      r[2] = warp_fold_t<OP_MIN_I>(acc[j][2]);
      r[3] = warp_fold_t<OP_MAX_I>(acc[j][3]);
    }
    if (lane == 0)
      for (int f = 0; f < 4; ++f) sh[warp][1 + 4 * j + f] = r[f];
  }
  __syncthreads();
  if (threadIdx.x < W) {
    const int s = threadIdx.x;
    part[static_cast<int64_t>(s) * MAX_BLOCKS + blockIdx.x] =
        ordered_fold<THREADS / 32>(slot_op(a, s), &sh[0][s], THREADS / 32,
                                   W, false);
    // the partial (and threads 0 and 1's node sums) visible before the
    // ticket
    __threadfence();
  }
  __syncthreads();
  if (threadIdx.x == 0)
    last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!last) return;

  // the last block: fold every block's partials in block order (lane l
  // takes blocks l, l + 32, ... in order, then the warp's tree)
  __threadfence();
  const int nb = static_cast<int>(gridDim.x);
  for (int s = warp; s < W; s += THREADS / 32) {
    const int op = slot_op(a, s);
    if (op == OP_ADD_F) continue;          // float64 sums: the node tree
    const int mine = lane < nb ? (nb - lane + 31) / 32 : 0;
    int64_t v = mine ? ordered_fold<(MAX_BLOCKS + 31) / 32>(
                           op, part + static_cast<int64_t>(s) * MAX_BLOCKS +
                                   lane, mine, 32, true)
                     : ident(op);
    v = warp_fold(op, v);
    if (lane == 0) out[s == 0 ? 0 : s + 4 * col_base] = v;
  }
  // float64 sums: fold the nodes 32 at a time, left to right from 0.0 (a
  // missing child adds +0.0), level by level into the node array's tail
#pragma unroll 1
  for (int j = 0; j < NA; ++j) {
#ifdef K2_PROBE_NO_TAIL              // scripts/probes: no node fold
    break;
#endif
    if (a.c[j].dtype != DT_F64) continue;
    const double* src = nodes + j * node_stride;
    double* dst = nodes + j * node_stride + n_nodes;
    for (int64_t len = n_nodes; len > 1;) {
      const int64_t parents = (len + TREE_W - 1) / TREE_W;
      for (int64_t q0 = threadIdx.x; q0 < parents; q0 += THREADS) {
        double v[TREE_W];              // every child in flight, then the adds
#pragma unroll
        for (int q = 0; q < TREE_W; ++q) {
          const int64_t i = q0 * TREE_W + q;
          v[q] = i < len ? __ldcg(src + i) : 0.0;
        }
        double s = 0.0;
#pragma unroll
        for (int q = 0; q < TREE_W; ++q) s += v[q];
        dst[q0] = s;
      }
      __syncthreads();               // the level is visible to the block
      src = dst;
      dst += parents;
      len = parents;
    }
    if (threadIdx.x == 0)
      out[2 + 4 * (col_base + j)] = __double_as_longlong(__ldcg(src));
  }
  if (threadIdx.x == 0) *ticket = 0u;   // ready for the next launch
}

template <int NA>
static void launch_na(const ColTable& p, const ColTable& a, int64_t n,
                      int vec, int blocks, int64_t* part,
                      unsigned int* ticket, int col_base, int64_t* out,
                      double* nodes, int64_t node_stride, cudaStream_t s) {
  agg_kernel<NA><<<blocks, THREADS, 0, s>>>(p, a, n, vec, part, ticket,
                                            col_base, out, nodes,
                                            node_stride);
}

// preds: k <= MAX_COLS predicate descriptors; aggs: m aggregate columns
// (any number, one launch per MAX_COLS).  blocks <= MAX_BLOCKS; part:
// int64[1 + 4 MAX_COLS, MAX_BLOCKS] scratch and ticket: one uint32, 0 between
// launches (the kernel leaves it 0), both private to the stream; vec: every
// operand 16-byte aligned; nodes: float64[MAX_COLS * node_stride]
// scratch, node_stride at least ceil(n / 1024) plus the upper levels
// (tree_node_stride in kernels/columnar_ops.py).  out: int64[1 + 4m],
// float slots as raw f64 bits.
extern "C" int rt_filter_aggregate(const ColDesc* preds, int k,
                                   const ColDesc* aggs, int m, int64_t n,
                                   int blocks, int vec, int64_t* part,
                                   unsigned int* ticket, int64_t* out,
                                   double* nodes, int64_t node_stride,
                                   void* stream) {
  if (k > MAX_COLS || blocks < 1 || blocks > MAX_BLOCKS)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  ColTable p;
  p.n = k;
  for (int j = 0; j < k; ++j) p.c[j] = preds[j];
  int g = 0;
  do {
    ColTable a;
    a.n = m - g < MAX_COLS ? m - g : MAX_COLS;
    for (int j = 0; j < a.n; ++j) a.c[j] = aggs[g + j];
    switch (a.n) {
      case 0: launch_na<0>(p, a, n, vec, blocks, part, ticket, g, out,
                        nodes, node_stride, s);
        break;
      case 1: launch_na<1>(p, a, n, vec, blocks, part, ticket, g, out,
                        nodes, node_stride, s);
        break;
      case 2: launch_na<2>(p, a, n, vec, blocks, part, ticket, g, out,
                        nodes, node_stride, s);
        break;
      case 3: launch_na<3>(p, a, n, vec, blocks, part, ticket, g, out,
                        nodes, node_stride, s);
        break;
      case 4: launch_na<4>(p, a, n, vec, blocks, part, ticket, g, out,
                        nodes, node_stride, s);
        break;
      case 5: launch_na<5>(p, a, n, vec, blocks, part, ticket, g, out,
                        nodes, node_stride, s);
        break;
      case 6: launch_na<6>(p, a, n, vec, blocks, part, ticket, g, out,
                        nodes, node_stride, s);
        break;
      case 7: launch_na<7>(p, a, n, vec, blocks, part, ticket, g, out,
                        nodes, node_stride, s);
        break;
      default: launch_na<8>(p, a, n, vec, blocks, part, ticket, g, out,
                        nodes, node_stride, s);
    }
    g += MAX_COLS;
  } while (g < m);
  return static_cast<int>(cudaGetLastError());
}
