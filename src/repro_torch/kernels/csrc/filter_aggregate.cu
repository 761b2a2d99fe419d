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
//
// The kernel lives in agg_kernel.cuh, which A6 (fused_chain.cu) shares.
// Its grid's y axis is the row axis of the partition runtime's stacked K2
// (repro/runtime/spmd.py:_agg_fn): row r reduces rows r * n ... of every
// column against its own bounds into its own partials, ticket, node array
// and out row, and writes its mask when asked; the loop path is the
// one-row case.
#include "agg_kernel.cuh"

// preds: k <= MAX_COLS predicate descriptors; aggs: m aggregate columns
// (any number, one launch per MAX_COLS), row 0's operands of a stacked
// [rows, n] set.  blocks <= MAX_BLOCKS a row; part:
// int64[rows, PART_SLOTS, MAX_BLOCKS] scratch and ticket: uint32[rows], 0
// between launches (the kernel leaves them 0), both private to the stream;
// vec: every operand 16-byte aligned; nodes: float64[rows, MAX_COLS,
// node_stride] scratch, node_stride at least ceil(n / 1024) plus the upper
// levels (tree_node_stride in kernels/columnar_ops.py); bounds: null or
// int64[rows, k, 2] bound bits on the device (null: one row, the
// descriptors' bounds); mask: null or bool[rows, n].
// out: int64[rows, 1 + 4m], float slots as raw f64 bits.
extern "C" int rt_filter_aggregate_rows(const ColDesc* preds, int k,
                                        const ColDesc* aggs, int m,
                                        int64_t n, int rows, int blocks,
                                        int vec, int64_t* part,
                                        unsigned int* ticket, int64_t* out,
                                        double* nodes, int64_t node_stride,
                                        const int64_t* bounds, uint8_t* mask,
                                        void* stream) {
  if (k > MAX_COLS) return static_cast<int>(cudaErrorInvalidValue);
  ColTable p;
  p.n = k;
  for (int j = 0; j < k; ++j) p.c[j] = preds[j];
  RowArgs ra = {};
  ra.bounds = bounds;
  ra.mask = mask;
  ra.rows_vec = n % 16 == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bounds == nullptr && mask == nullptr)   // the loop path's one row
    return launch_agg<false, false>(p, aggs, m, n, rows, blocks, vec, part,
                                    ticket, out, 1 + 4 * m, nodes,
                                    node_stride, ra, s);
  return launch_agg<false, true>(p, aggs, m, n, rows, blocks, vec, part,
                                 ticket, out, 1 + 4 * m, nodes, node_stride,
                                 ra, s);
}

// The loop path's K2: one row, the descriptors' bounds, no mask.
extern "C" int rt_filter_aggregate(const ColDesc* preds, int k,
                                   const ColDesc* aggs, int m, int64_t n,
                                   int blocks, int vec, int64_t* part,
                                   unsigned int* ticket, int64_t* out,
                                   double* nodes, int64_t node_stride,
                                   void* stream) {
  return rt_filter_aggregate_rows(preds, k, aggs, m, n, 1, blocks, vec, part,
                                  ticket, out, nodes, node_stride, nullptr,
                                  nullptr, stream);
}
