#pragma once
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

// the partials' rows a stacked row: 3 counts (A6) and 4 slots a column
#define PART_SLOTS (3 + 4 * MAX_COLS)

// slots 0 .. NC - 1 are counts (K2: the survivors; A6: n_cand, n_found,
// n_valid), then four a column
template <int NC>
__device__ __forceinline__ int slot_op(const ColTable& a, int s) {
  if (s < NC) return OP_ADD_I;                 // survivor counts
  const int j = (s - NC) >> 2, f = (s - NC) & 3;
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

// A float64 sum's bits as written out: a NaN as the canonical quiet NaN.
// Which input NaN an add of two NaNs keeps turns on the operand order the
// compiler chose, which differs between kernels that add the same values
// in the same order (ptxas commutes adds), so only the NaN itself is kept.
__device__ __forceinline__ int64_t sum_bits(double s) {
  return s != s ? static_cast<int64_t>(0x7ff8000000000000LL)
                : __double_as_longlong(s);
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

// The reference's order for a masked float64 sum over a padded length of
// exactly 32 under K >= 1 predicate columns (kernels/columnar_ops.py:
// sum32, whose sum32_unroll gives U): value i goes to accumulator
// (i / 4) mod U, lane i mod 4, in order; then acc1 + acc0, acc2 + that,
// acc3 + that; then (l0 + l2) + (l1 + l3).
template <int U>
__device__ __forceinline__ double sum32_t(const double* w) {
  double acc[U][4];
#pragma unroll
  for (int a = 0; a < U; ++a)
#pragma unroll
    for (int l = 0; l < 4; ++l) acc[a][l] = 0.0;
#pragma unroll
  for (int i = 0; i < TREE_W; ++i) acc[(i / 4) % U][i % 4] += w[i];
  double v[4];
#pragma unroll
  for (int l = 0; l < 4; ++l) v[l] = acc[0][l];
#pragma unroll
  for (int a = 1; a < U; ++a)
#pragma unroll
    for (int l = 0; l < 4; ++l) v[l] = acc[a][l] + v[l];
  return (v[0] + v[2]) + (v[1] + v[3]);
}
static __device__ __noinline__ double sum32(const double* w, int u) {
  switch (u) {
    case 1: return sum32_t<1>(w);
    case 2: return sum32_t<2>(w);
    default: return sum32_t<4>(w);
  }
}

// Stage a float64 column's masked values of the block's chunk (rows of
// `sel` keep theirs, the rest add +0.0), sum its windows and its two
// nodes, each left to right from 0.0, and store the nodes below n_nodes
// at nodes[node0], nodes[node0 + 1].  Every thread of the block calls it.
// u32 > 0 (the loop K2 at n = 32): window 0, the whole column, sums in
// sum32's order instead.
__device__ __forceinline__ void tree_step(const Run& r, uint32_t sel,
                                          TreeSmem& ts, int warp, int lane,
                                          double* nodes, int64_t node0,
                                          int64_t n_nodes, int u32 = 0) {
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
    if (u32 > 0 && threadIdx.x == 0) {
      s = sum32(ts.win[0], u32);
    } else {
#pragma unroll
      for (int q = 0; q < TREE_W; ++q) s += ts.win[threadIdx.x][q];
    }
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

// The row axis and A6's chain prefix.  With ROWS, row r (the grid's y
// index) reads rows r * n ... of every column and its predicate bounds
// from bounds, and has its own partials, ticket, node array and out row;
// without, the launch is the loop path's one row with the descriptors'
// bounds.  With nf > 0 (A6) a row's lane i is a candidate where it is
// live (i < n_live[r]) and field 0's occurrence flag at the slot idx[r,
// i] holds this dispatch's stamp; it is found where every field's does,
// and the predicates AND in after that.
struct RowArgs {
  const int64_t* bounds;   // [R, k, 2] bound bits (ROWS)
  uint8_t* mask;           // [R, n] survivors out, or null
  const uint8_t* flags;    // [R, nf, total] occurrence stamps (A6)
  const int64_t* idx;      // [R, n] live-selection slots (A6)
  const int64_t* n_live;   // [R] (A6)
  int64_t total;           // slots a field (A6)
  int nf;                  // range fields (0: K2)
  int stamp;               // the dispatch's flag stamp, 1 .. 255 (A6)
  int rows_vec;            // rows past the first keep vector alignment
  int sum32;               // the loop K2 at n = 32: sum32's U (0: windows)
};

// A6: a run's candidate and found bits from the lane's rows (live below
// n_live, each row's slot gathered from every field's flags, set where
// they hold the stamp; a slot outside [0, total) clamps, as an XLA gather
// does)
__device__ __forceinline__ void chain_bits(const RowArgs& ra, int64_t r,
                                           int64_t lrow0, int64_t n,
                                           int64_t n_live, bool fast,
                                           uint32_t& cand, uint32_t& found) {
  int64_t slot[RUN];
  const int64_t* ix = ra.idx + r * n + lrow0;
  if (fast) {
#pragma unroll
    for (int k = 0; k < RUN / 2; ++k) {
      const uint4 w = __ldg(reinterpret_cast<const uint4*>(ix + 64 * k));
      slot[2 * k] = lo_hi(w.x, w.y);
      slot[2 * k + 1] = lo_hi(w.z, w.w);
    }
  } else {
#pragma unroll
    for (int b = 0; b < RUN; ++b) {
      const int64_t l = lrow0 + 64 * (b >> 1) + (b & 1);
      slot[b] = l < n ? ix[64 * (b >> 1) + (b & 1)] : 0;
    }
  }
  uint32_t live = 0;
#pragma unroll
  for (int b = 0; b < RUN; ++b) {
    live |= static_cast<uint32_t>(lrow0 + 64 * (b >> 1) + (b & 1) < n_live)
            << b;
    slot[b] = slot[b] < 0 ? 0 : slot[b] >= ra.total ? ra.total - 1 : slot[b];
  }
  uint32_t acc = live;
#pragma unroll 1
  for (int f = 0; f < ra.nf; ++f) {
    const uint8_t* fl = ra.flags + (r * ra.nf + f) * ra.total;
    uint32_t bits = 0;
#pragma unroll
    for (int b = 0; b < RUN; ++b)
      bits |= static_cast<uint32_t>(fl[slot[b]] == ra.stamp) << b;
    acc &= bits;
    if (f == 0) cand = acc;
  }
  found = acc;
}

// Store a run's mask bits as bytes (two rows a 2-byte store on a full,
// aligned run)
__device__ __forceinline__ void store_mask(uint8_t* out, int64_t base,
                                           int64_t end, bool vec,
                                           uint32_t mask) {
  if (vec) {
    unsigned short* o = reinterpret_cast<unsigned short*>(out + base);
#pragma unroll
    for (int q = 0; q < RUN / 2; ++q)
      o[32 * q] = static_cast<unsigned short>(((mask >> (2 * q)) & 1u) |
                                              (((mask >> (2 * q + 1)) & 1u)
                                               << 8));
    return;
  }
#pragma unroll
  for (int b = 0; b < RUN; ++b) {
    const int64_t row = base + 64 * (b >> 1) + (b & 1);
    if (row < end) out[row] = static_cast<uint8_t>((mask >> b) & 1u);
  }
}

// One launch: every block folds its runs and writes its partial row
// part[s * MAX_BLOCKS + block]; the last block to finish folds them all
// into out (the NC counts to out[0 ..], aggregate column j's four slots
// to out[NC + 4 * (col_base + j) ...]); a float64 column j's 1,024-row node
// sums go to nodes[j * node_stride ...], whose tail holds the upper levels.
// With ROWS each of these is row r's own: part + r * PART_SLOTS *
// MAX_BLOCKS, ticket + r, nodes + r * MAX_COLS * node_stride, out + r *
// out_w.  CHAIN: A6's second pass (NC = 3), else K2 (NC = 1).
template <int NA, bool CHAIN, bool ROWS>
__global__ void __launch_bounds__(THREADS)
agg_kernel(ColTable p, ColTable a, int64_t n, int vec, int64_t* part,
           unsigned int* ticket, int col_base, int64_t* out, int64_t out_w,
           double* nodes, int64_t node_stride, RowArgs ra) {
  constexpr int NC = CHAIN ? 3 : 1;
  __shared__ TreeSmem ts;
  __shared__ int64_t s_lo[MAX_COLS], s_hi[MAX_COLS];
  constexpr int W = NC + 4 * NA;
  const int64_t r = ROWS ? blockIdx.y : 0;
  part += r * PART_SLOTS * MAX_BLOCKS;
  ticket += r;
  nodes += r * MAX_COLS * node_stride;
  out += r * out_w;
  if constexpr (ROWS) stage_bounds(p, ra.bounds, 2 * p.n, s_lo, s_hi);
  int64_t n_live = 0;
  if constexpr (CHAIN) n_live = ra.n_live[r];
  int64_t cnt = 0, cnt_c = 0, cnt_f = 0;
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
  const int64_t roff = r * n, end = roff + n;
  const bool vec_ok = vec && (r == 0 || ra.rows_vec);
  const int64_t wruns = (n + WRUN - 1) / WRUN;
  const int64_t n_nodes = (n + NODE_ROWS - 1) / NODE_ROWS;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * (THREADS / 32);
  const int u32 = !CHAIN && !ROWS && n == TREE_W ? ra.sum32 : 0;
  if constexpr (ROWS) __syncthreads();   // the staged bounds
  // every warp of a block runs the same iterations (tree_step syncs the
  // block); a warp whose run lies past n loads nothing and masks all rows
  for (int64_t wr0 = static_cast<int64_t>(blockIdx.x) * (THREADS / 32);
       wr0 < wruns; wr0 += stride) {
    const int64_t wr = wr0 + warp;
    const int64_t node0 = wr0 * WRUN / NODE_ROWS;
    const int64_t lbase = wr * WRUN + 2 * lane;  // the lane's first row
    const int64_t base = roff + lbase;           // ... of the stacked rows
    const bool fast = vec_ok && wr * WRUN + WRUN <= n;
    uint32_t mask = 0;
#pragma unroll
    for (int b = 0; b < RUN; ++b)
      mask |= static_cast<uint32_t>(lbase + 64 * (b >> 1) + (b & 1) < n)
              << b;
    if constexpr (CHAIN) {
      uint32_t cand = 0, found = 0;
      chain_bits(ra, r, lbase, n, n_live, fast, cand, found);
      cand &= mask;
      found &= mask;
      cnt_c += __popc(cand);
      cnt_f += __popc(found);
      mask = found;
    }
    if constexpr (NA <= 2) {
      // every column in flight at once: the aggregates first, then the
      // predicates two at a time (pb[c & 1])
      Run ab[NA > 0 ? NA : 1], pb[2];
#pragma unroll
      for (int j = 0; j < NA; ++j) load_run(a.c[j], base, end, fast, ab[j]);
      if (k > 0) load_run(p.c[0], base, end, fast, pb[0]);
#pragma unroll
      for (int c = 0; c < MAX_COLS; ++c) {
        if (c < k) {
          if (c + 1 < k)
            load_run(p.c[c + 1], base, end, fast, pb[(c + 1) & 1]);
          mask &= pred_bits(p.c[c], pb[c & 1],
                            bound_lo<ROWS>(p.c[c], s_lo, c),
                            bound_hi<ROWS>(p.c[c], s_hi, c));
        }
      }
      cnt += __popc(mask);
      if (ra.mask != nullptr) store_mask(ra.mask, base, end, fast, mask);
#pragma unroll
      for (int j = 0; j < NA; ++j) {
        agg_run(a.c[j], ab[j], mask, acc[j]);
        if (a.c[j].dtype == DT_F64)
          tree_step(ab[j], mask, ts, warp, lane, nodes + j * node_stride,
                    node0, n_nodes, u32);
      }
    } else {
      // predicate c's run sits in pb[c & 1], aggregate j's in ab[j & 1]
      // (both unrolled, so no run is copied); each column's successor is
      // issued before the column is evaluated
      Run pb[2], ab[2];
      if (k > 0) load_run(p.c[0], base, end, fast, pb[0]);
      else load_run(a.c[0], base, end, fast, ab[0]);
#pragma unroll
      for (int c = 0; c < MAX_COLS; ++c) {
        if (c < k) {
          if (c + 1 < k)
            load_run(p.c[c + 1], base, end, fast, pb[(c + 1) & 1]);
          else
            load_run(a.c[0], base, end, fast, ab[0]);
          mask &= pred_bits(p.c[c], pb[c & 1],
                            bound_lo<ROWS>(p.c[c], s_lo, c),
                            bound_hi<ROWS>(p.c[c], s_hi, c));
        }
      }
      cnt += __popc(mask);
      if (ra.mask != nullptr) store_mask(ra.mask, base, end, fast, mask);
#pragma unroll
      for (int j = 0; j < NA; ++j) {
        if (j + 1 < NA)
          load_run(a.c[j + 1], base, end, fast, ab[(j + 1) & 1]);
        agg_run(a.c[j], ab[j & 1], mask, acc[j]);
        if (a.c[j].dtype == DT_F64)
          tree_step(ab[j & 1], mask, ts, warp, lane,
                    nodes + j * node_stride, node0, n_nodes, u32);
      }
    }
  }

  // block fold: a shuffle tree a slot, then the warps in order
  __shared__ int64_t sh[THREADS / 32][W];
  __shared__ bool last;
  {
    const int64_t c0 = warp_fold_t<OP_ADD_I>(CHAIN ? cnt_c : cnt);
    if (lane == 0) sh[warp][0] = c0;
    if constexpr (CHAIN) {
      const int64_t c1 = warp_fold_t<OP_ADD_I>(cnt_f);
      const int64_t c2 = warp_fold_t<OP_ADD_I>(cnt);
      if (lane == 0) {
        sh[warp][1] = c1;
        sh[warp][2] = c2;
      }
    }
  }
  // a column's four slots in one branch on its type, so their shuffle
  // trees interleave
#pragma unroll
  for (int j = 0; j < NA; ++j) {
    int64_t v[4];
    v[0] = warp_fold_t<OP_ADD_I>(acc[j][0]);
    if (a.c[j].dtype == DT_F64) {
      v[1] = warp_fold_t<OP_ADD_F>(acc[j][1]);
      v[2] = warp_fold_t<OP_MIN_F>(acc[j][2]);
      v[3] = warp_fold_t<OP_MAX_F>(acc[j][3]);
    } else {
      v[1] = warp_fold_t<OP_ADD_I>(acc[j][1]);
      v[2] = warp_fold_t<OP_MIN_I>(acc[j][2]);
      v[3] = warp_fold_t<OP_MAX_I>(acc[j][3]);
    }
    if (lane == 0)
      for (int f = 0; f < 4; ++f) sh[warp][NC + 4 * j + f] = v[f];
  }
  __syncthreads();
  if (threadIdx.x < W) {
    const int s = threadIdx.x;
    part[static_cast<int64_t>(s) * MAX_BLOCKS + blockIdx.x] =
        ordered_fold<THREADS / 32>(slot_op<NC>(a, s), &sh[0][s],
                                   THREADS / 32, W, false);
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
    const int op = slot_op<NC>(a, s);
    if (op == OP_ADD_F) continue;          // float64 sums: the node tree
    const int mine = lane < nb ? (nb - lane + 31) / 32 : 0;
    int64_t v = mine ? ordered_fold<(MAX_BLOCKS + 31) / 32>(
                           op, part + static_cast<int64_t>(s) * MAX_BLOCKS +
                                   lane, mine, 32, true)
                     : ident(op);
    v = warp_fold(op, v);
    if (lane == 0) out[s < NC ? s : s + 4 * col_base] = v;
  }
  // float64 sums: fold the nodes 32 at a time, left to right from 0.0 (a
  // missing child adds +0.0), level by level into the node array's tail
#pragma unroll 1
  for (int j = 0; j < NA; ++j) {
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
      out[NC + 1 + 4 * (col_base + j)] = sum_bits(__ldcg(src));
  }
  if (threadIdx.x == 0) *ticket = 0u;   // ready for the next launch
}

// Launch agg_kernel<NA, CHAIN, ROWS> over m aggregate columns (one launch
// per MAX_COLS; each writes the counts and, when asked, the mask) on a
// grid of blocks x rows
template <bool CHAIN, bool ROWS>
static int launch_agg(const ColTable& p, const ColDesc* aggs, int m,
                      int64_t n, int rows, int blocks, int vec,
                      int64_t* part, unsigned int* ticket, int64_t* out,
                      int64_t out_w, double* nodes, int64_t node_stride,
                      const RowArgs& ra, cudaStream_t s) {
  if (p.n > MAX_COLS || blocks < 1 || blocks > MAX_BLOCKS || rows < 1 ||
      rows > 65535 || (!ROWS && rows > 1) ||
      (ROWS && p.n > 0 && ra.bounds == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(blocks, rows);
  int g = 0;
  do {
    ColTable a;
    a.n = m - g < MAX_COLS ? m - g : MAX_COLS;
    for (int j = 0; j < a.n; ++j) a.c[j] = aggs[g + j];
#define K2_LAUNCH(NA)                                                     \
  agg_kernel<NA, CHAIN, ROWS><<<grid, THREADS, 0, s>>>(                    \
      p, a, n, vec, part, ticket, g, out, out_w, nodes, node_stride, ra)
    switch (a.n) {
      case 0: K2_LAUNCH(0); break;
      case 1: K2_LAUNCH(1); break;
      case 2: K2_LAUNCH(2); break;
      case 3: K2_LAUNCH(3); break;
      case 4: K2_LAUNCH(4); break;
      case 5: K2_LAUNCH(5); break;
      case 6: K2_LAUNCH(6); break;
      case 7: K2_LAUNCH(7); break;
      default: K2_LAUNCH(8);
    }
#undef K2_LAUNCH
    g += MAX_COLS;
  } while (g < m);
  return static_cast<int>(cudaGetLastError());
}
