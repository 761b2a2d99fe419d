// A6 fused_index_chain: a secondary-index chain (probe -> bitmap AND ->
// live gather -> validate ranges -> aggregate) as one dispatch, for one
// partition (the loop path) or every partition row of the stacked
// partition runtime at once.
//
// Replaces the reference's jit core repro/columnar/plancache.py:_chain_math
// (jit _chain_core; stacked: repro/runtime/spmd.py:_chain_fn).  There, per
// range field, every posting lane in [a, b) of each tier scatters
// pos + off into an int32 occurrence count over the storage concat (other
// lanes into a sentinel slot), the count > 0 bitmap is gathered through the
// live-selection index, masked by lane < n_live and ANDed over the fields;
// the validate ranges AND in as column compares and the aggregate tail
// reduces the survivors (count, sum, min, max a column).
//
// Two passes, both with a row axis (a partition row of the stacked
// operands; the loop path is one row):
//  1. chain_scatter_kernel: only "count > 0" is read, so each storage slot
//     is a byte flag set without atomics (every writer stores 1).  A block
//     takes one (row, tier) and strides over the lanes in [a, b) only, so
//     padding and out-of-slice lanes are never read (the reference's
//     sentinel slot is not needed).  The flags are zeroed by one memset
//     before it.
//  2. agg_kernel<NA, true, true> (agg_kernel.cuh, K2's kernel with A6's chain
//     prefix): per lane of a row, cand = flag of field 0 at idx & lane <
//     n_live, found = cand & every other field's flag, then the predicates
//     AND in, in the reference's order; n_cand, n_found and n_valid are
//     int64 counts, and each aggregate column's count / sum / min / max
//     fold exactly as K2 folds them (float64 sums in tree_sum's order, so
//     the bits equal the reference's per row).  It writes the mask.
//
// Bound: memory.  Pass 1 reads each in-slice posting position once (8 B)
// and stores a byte flag; pass 2 reads a live lane's slot (8 B), one flag
// byte a field, the predicate and aggregate columns ((9K + 9M) B), and
// writes one mask byte.  Launches a dispatch: a memset, the scatter, and
// one pass-2 launch per 8 aggregate columns (one in mask mode).
#include "agg_kernel.cuh"

#define A6_THREADS 256
#define A6_MAX_TIERS 32

// The tiers of every range field, row 0's positions of each (a stacked
// [R, width] array; int32 or int64, the postings' own dtype)
struct TierTable {
  const void* pos[A6_MAX_TIERS];
  int64_t width[A6_MAX_TIERS];
  int field[A6_MAX_TIERS];
  int is32[A6_MAX_TIERS];
  int nt;
};

// grid (x, rows, tiers): block (x, r, t) strides over tier t's lanes
// [a, b) of row r; abo: int64[rows, n_tiers_all, 3] (a, b, off) with
// tier index t0 + t
__global__ void __launch_bounds__(A6_THREADS)
chain_scatter_kernel(TierTable tt, const int64_t* abo, int n_tiers_all,
                     int t0, uint8_t* flags, int nf, int64_t total) {
  const int t = blockIdx.z;
  const int64_t r = blockIdx.y;
  const int64_t* q = abo + (r * n_tiers_all + t0 + t) * 3;
  const int64_t w = tt.width[t];
  const int64_t a = q[0] < 0 ? 0 : q[0];
  const int64_t b = q[1] > w ? w : q[1];
  const int64_t off = q[2];
  uint8_t* fl = flags + (r * nf + tt.field[t]) * total;
  const int64_t step = static_cast<int64_t>(gridDim.x) * A6_THREADS;
  if (tt.is32[t]) {
    const int32_t* pos = static_cast<const int32_t*>(tt.pos[t]) + r * w;
    for (int64_t i = a + static_cast<int64_t>(blockIdx.x) * A6_THREADS +
                      threadIdx.x;
         i < b;
         i += step) {
      const int64_t s = static_cast<int64_t>(__ldg(pos + i)) + off;
      if (s >= 0 && s < total) fl[s] = 1;
    }
  } else {
    const int64_t* pos = static_cast<const int64_t*>(tt.pos[t]) + r * w;
    for (int64_t i = a + static_cast<int64_t>(blockIdx.x) * A6_THREADS +
                      threadIdx.x;
         i < b;
         i += step) {
      const int64_t s = __ldg(pos + i) + off;
      if (s >= 0 && s < total) fl[s] = 1;
    }
  }
}

// Pass 1.  pos, width, field, is32: nt tiers (every field's, in order);
// abo: int64[rows, nt, 3] on the device; flags: uint8[rows, nf, total],
// zeroed here; max_len: the longest [a, b) slice (sizes the grid).
extern "C" int rt_chain_scatter(const void* const* pos, const int64_t* width,
                                const int* field, const int* is32, int nt,
                                const int64_t* abo, int rows, uint8_t* flags,
                                int nf, int64_t total, int64_t max_len,
                                void* stream) {
  if (rows < 1 || rows > 65535 || nf < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaMemsetAsync(flags, 0, static_cast<size_t>(rows) * nf * total, s);
  const int64_t per = (max_len + A6_THREADS - 1) / A6_THREADS;
  for (int g = 0; g < nt; g += A6_MAX_TIERS) {
    TierTable tt;
    tt.nt = nt - g < A6_MAX_TIERS ? nt - g : A6_MAX_TIERS;
    for (int t = 0; t < tt.nt; ++t) {
      tt.pos[t] = pos[g + t];
      tt.width[t] = width[g + t];
      tt.field[t] = field[g + t];
      tt.is32[t] = is32[g + t];
    }
    if (max_len <= 0) continue;
    const int gx = static_cast<int>(per < 1024 ? per : 1024);
    const dim3 grid(gx, rows, tt.nt);
    chain_scatter_kernel<<<grid, A6_THREADS, 0, s>>>(tt, abo, nt, g, flags,
                                                     nf, total);
  }
  return static_cast<int>(cudaGetLastError());
}

// Pass 2.  preds: k <= MAX_COLS predicate descriptors and aggs: m aggregate
// columns, row 0's operands of stacked [rows, n] arrays (n = live_p2);
// bounds: int64[rows, k, 2] bound bits on the device; idx: int64[rows, n]
// live-selection slots; n_live: int64[rows]; flags as pass 1 left them;
// scratch as rt_filter_aggregate_rows takes it; out: int64[rows, 3 + 4m]
// (n_cand, n_found, n_valid, then count / sum / min / max a column, float
// slots as raw f64 bits); mask: bool[rows, n].
extern "C" int rt_chain_aggregate(const ColDesc* preds, int k,
                                  const ColDesc* aggs, int m, int64_t n,
                                  int rows, int blocks, int vec,
                                  int64_t* part, unsigned int* ticket,
                                  int64_t* out, double* nodes,
                                  int64_t node_stride, const int64_t* bounds,
                                  const uint8_t* flags, int nf,
                                  int64_t total, const int64_t* idx,
                                  const int64_t* n_live, uint8_t* mask,
                                  void* stream) {
  if (k > MAX_COLS || nf < 1) return static_cast<int>(cudaErrorInvalidValue);
  ColTable p;
  p.n = k;
  for (int j = 0; j < k; ++j) p.c[j] = preds[j];
  RowArgs ra = {};
  ra.bounds = bounds;
  ra.mask = mask;
  ra.flags = flags;
  ra.idx = idx;
  ra.n_live = n_live;
  ra.total = total;
  ra.nf = nf;
  ra.rows_vec = n % 16 == 0;
  return launch_agg<true, true>(p, aggs, m, n, rows, blocks, vec, part,
                                ticket, out, 3 + 4 * m, nodes, node_stride,
                                ra, static_cast<cudaStream_t>(stream));
}
