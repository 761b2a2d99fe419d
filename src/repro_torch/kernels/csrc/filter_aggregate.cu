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
// pow2 n.  At a padded length of exactly 32 the reference sums in another
// order, four lanes of U accumulators (LLVM's vectorizer on XLA:CPU's
// 32-trip loop; U from the number of predicate columns the reference saw,
// kernels/columnar_ops.py:sum32_unroll): the loop K2 takes it there, one
// block whose thread 0 sums the one window that way (agg_kernel.cuh:
// sum32); the stacked K2 keeps the windows, as the reference's vmapped
// reduce does.  min/max propagate NaN as jnp.min / jnp.max do.
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
// Its grid's y axis is a row axis: row r reduces rows r * n ... of every
// column against its own bounds into its own partials, ticket, node array
// and out row, and writes its mask when asked; the loop path is the
// one-row case.  The partition runtime's stacked K2 (repro/runtime/
// spmd.py:_agg_fn) takes that row axis only for operands it cannot stream
// by TMA; rows_agg_kernel below is its design.
#include "agg_kernel.cuh"
#include "model_common.cuh"      // mbarriers, allow_smem

// ---------------------------------------------------------------------------
// Stacked K2, second design (rows_agg_kernel): the partition runtime's
// stacked K2 (repro/runtime/spmd.py:_agg_fn) over [R, n] operands whose
// rows and columns are all 16-byte aligned (n a multiple of 16); other
// shapes take agg_kernel<NA, false, true>, the first design.  Both give the
// same bits: every slot folds in the loop kernel's order.
//
// Bound: memory, 9 bytes a row a column read and the mask's byte written.
// The first design runs a block a 2,048-row chunk (1,024 blocks at R = 4,
// n = 2^19: four waves), loads a chunk, then sums its float64 windows and
// folds with no load in flight, and leaves each row's last block 256
// partials and 512 node sums to fold.
// Here a row's grid is G blocks (G R about two blocks an SM: one wave),
// block g taking logical blocks [g per, (g + 1) per) of the loop kernel's
// agg_blocks(n), each with that logical block's chunks b, b + nb, ...
// A producer warp streams the block's (chunk, column) items by TMA bulk
// copies (cp.async.bulk: a column's 2,048 values and validity bytes) into
// a ring of RING slots in shared memory, each completing on its "full"
// mbarrier; eight consumer warps read their rows of each item from the
// slot (the loop kernel's lane layout: rows 256 w + 64 k + 2 i + e of the
// chunk) and free it on its "empty" mbarrier.  The consumer warps never
// wait for one another but through the ring: a warp at most RING items
// ahead of the slowest (so NBUF = RING + 2 chunks of shared buffers
// suffice below).  Folds, all in the loop kernel's order:
//   - counts, int64 sums, mins and maxes: a register per thread over the
//     whole range, one partial a grid block (any order gives the bits);
//   - float64 min / max (NaN-first; which NaN, which of -0.0 / +0.0 turns
//     on the order): each warp's shuffle tree of a logical block into
//     shared memory, and the last warp to get there folds the eight in
//     warp order into the partial of that logical block; each row's last
//     block folds those as the loop kernel's last block does;
//   - float64 sums (the reference's windows): each warp sums its eight
//     32-row windows of a chunk left to right from 0.0 into shared memory,
//     and the last of the four warps of a 1,024-row node sums the node's
//     32 windows; then a ticket a chunk on its group of 32 nodes: the
//     block whose chunk completes a group folds it into the level above,
//     and so on up (a ticket a group at each level), so the block that
//     completes the top group writes the sum (a NaN as the canonical NaN,
//     agg_kernel.cuh:sum_bits, as the loop kernel writes it).
// At R = 4, n = 2^19 on an H100 80GB HBM3 at 700 W it runs in ~37 us
// against the first design's ~46 (PERF.md section 6); a bare stream of its
// items through the ring takes ~29 us there, under the L2 write flush its
// timing uses.
// ---------------------------------------------------------------------------

#define RING 4                               // slots of a block's ring
#define ROWS_BPS 2                           // blocks an SM the grid takes
#define CWARPS (THREADS / 32)                // consumer warps
#define ROWS_THREADS (THREADS + 32)          // ... and the producer warp
#define SLOT_DATA (CHUNK * 8)                // a chunk's values (8 bytes)
#define SLOT_BYTES (SLOT_DATA + CHUNK)       // ... and validity bytes
#define GROUP_CHUNKS (TREE_W * NODE_ROWS / CHUNK)   // chunks of 32 nodes
#define NBUF (RING + 2)                      // chunks of window sums kept
#define WWIN (WRUN / TREE_W)                 // a warp's windows a chunk
#define STG_BYTES (CWARPS * WWIN * (TREE_W + 1) * 8)

// dynamic shared memory of a block with nf float64 aggregate columns: the
// ring, the warps' window staging, NBUF chunks' window sums a column, and
// NBUF logical blocks' warp min / max partials a column
static inline int rows_smem(int nf) {
  return RING * SLOT_BYTES + STG_BYTES + NBUF * nf * CHUNK_WIN * 8 +
         NBUF * CWARPS * 2 * nf * 8;
}

struct RowsArgs {
  int64_t n;               // lanes a row
  const int64_t* bounds;   // [R, k, 2] bound bits
  uint8_t* mask;           // [R, n] survivors out
  int64_t* part;           // [R, PART_SLOTS, MAX_BLOCKS]
  unsigned int* ticket;    // [R], 0 between launches
  unsigned int* gticket;   // [R, gstride], 0 between launches
  int64_t gstride;         // >= the groups of every level above the nodes
  double* nodes;           // [R, MAX_COLS, node_stride]
  int64_t node_stride;
  int64_t* out;            // [R, out_w]
  int64_t out_w;
  int col_base;            // the launch's first aggregate column
  int per;                 // logical blocks a grid block
};

// one contiguous global -> shared copy by the TMA unit, completing `bytes`
// on `bar` (16-byte aligned, a multiple of 16 bytes); the lines it brings
// into L2 go first (each is read once), so the stream evicts its own lines
// rather than what L2 held before
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  uint64_t pol;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n"
               : "=l"(pol));
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".L2::cache_hint [%0], [%1], %2, [%3], %4;\n"
      :: "r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar)),
         "l"(pol)
      : "memory");
}

// The block's items in order: logical blocks b0 .. b1 - 1, each's chunks
// b, b + nb, ... below T, each chunk's predicate columns then aggregate
// columns.  The producer keeps a cursor that issues them into the ring.
struct Cursor {
  int64_t c;               // chunk
  int b, col;              // logical block, column
};

__device__ __forceinline__ bool issue(const ColTable& p, const ColTable& a,
                                      int ncol, int64_t T, int nb, int b1,
                                      int64_t roff, int64_t n, Cursor& q,
                                      unsigned char* slot, uint64_t* bar) {
  if (q.b >= b1) return false;
  const int k = p.n;
  const ColDesc& c = q.col < k ? p.c[q.col] : a.c[q.col - k];
  const int64_t row0 = q.c * CHUNK;
  const int64_t rows = n - row0 < CHUNK ? n - row0 : CHUNK;
  const int es = c.dtype == DT_I32 ? 4 : 8;
  const uint32_t db = static_cast<uint32_t>(rows * es);
  mbar_arrive_expect_tx(bar, db + static_cast<uint32_t>(rows));
  bulk_load(slot, static_cast<const unsigned char*>(c.data) +
                      (roff + row0) * es, db, bar);
  bulk_load(slot + SLOT_DATA, c.valid + roff + row0,
            static_cast<uint32_t>(rows), bar);
  if (++q.col == ncol) {
    q.col = 0;
    q.c += nb;
    if (q.c >= T) q.c = ++q.b;
  }
  return true;
}

// A lane's run of one column from a slot (the loop kernel's row layout)
__device__ __forceinline__ void slot_run(const unsigned char* slot,
                                         int dtype, int warp, int lane,
                                         Run& r) {
  const int row = warp * WRUN + 2 * lane;
  const unsigned short* v =
      reinterpret_cast<const unsigned short*>(slot + SLOT_DATA);
#pragma unroll
  for (int k = 0; k < RUN / 2; ++k) r.v[k] = v[(row + 64 * k) >> 1];
  if (dtype == DT_I32) {
    const uint2* d = reinterpret_cast<const uint2*>(slot);
#pragma unroll
    for (int k = 0; k < RUN / 2; ++k) {
      const uint2 w = d[(row + 64 * k) >> 1];
      r.x[2 * k] = static_cast<int32_t>(w.x);
      r.x[2 * k + 1] = static_cast<int32_t>(w.y);
    }
  } else {
    const uint4* d = reinterpret_cast<const uint4*>(slot);
#pragma unroll
    for (int k = 0; k < RUN / 2; ++k) {
      const uint4 w = d[(row + 64 * k) >> 1];
      r.x[2 * k] = lo_hi(w.x, w.y);
      r.x[2 * k + 1] = lo_hi(w.z, w.w);
    }
  }
}

// A consumer warp: wait for item `item`, read the lane's run of it, and
// free its slot (the warp's arrival on the slot's "empty" mbarrier)
__device__ __forceinline__ void consume(const unsigned char* ring,
                                        uint64_t* full, uint64_t* empty,
                                        uint32_t& item, int dtype, int warp,
                                        int lane, Run& run) {
  const int s = item % RING;
  mbar_wait(&full[s], (item / RING) & 1u);
  slot_run(ring + s * SLOT_BYTES, dtype, warp, lane, run);
  __syncwarp();
  if (lane == 0) mbar_arrive(&empty[s]);
  ++item;
}

// A warp's float64 windows of chunk c (rows of `sel` keep their values,
// the rest add +0.0): its eight 32-row windows summed left to right from
// 0.0 into wsum[8 warp ...]; the last of the node's four warps (counted in
// ncnt[h]) sums the node's 32 window sums the same way into node[2 c + h]
__device__ __forceinline__ void window_step(const Run& r, uint32_t sel,
                                            double (*stg)[TREE_W + 1],
                                            double* wsum, int* ncnt,
                                            double* node, int64_t c,
                                            int64_t n_nodes, int warp,
                                            int lane) {
  sel &= valid_bits(r);
#pragma unroll
  for (int b = 0; b < RUN; ++b) {
    const int row = 64 * (b >> 1) + 2 * lane + (b & 1);
    stg[row / TREE_W][row % TREE_W] =
        (sel >> b) & 1u ? __longlong_as_double(r.x[b]) : 0.0;
  }
  __syncwarp();
  if (lane < WWIN) {
    double s = 0.0;
#pragma unroll
    for (int q = 0; q < TREE_W; ++q) s += stg[lane][q];
    wsum[WWIN * warp + lane] = s;
  }
  __syncwarp();
  if (lane == 0) {
    const int h = warp / (CWARPS / 2);
    __threadfence_block();
    if (atomicAdd(&ncnt[h], 1) == CWARPS / 2 - 1) {
      __threadfence_block();
      double v[TREE_W];
#pragma unroll
      for (int q = 0; q < TREE_W; ++q) v[q] = wsum[TREE_W * h + q];
      double s = 0.0;
#pragma unroll
      for (int q = 0; q < TREE_W; ++q) s += v[q];
      if (2 * c + h < n_nodes) node[2 * c + h] = s;
      ncnt[h] = 0;
    }
  }
}

// Group g of the nodes (level 0) is complete: fold it, left to right from
// 0.0 (a missing node adds +0.0), into level 1 at nodes[n_nodes + g], for
// every float64 column; then take the ticket of its group in the level
// above, and go on up while this thread completes the groups.  The level
// of one node is the sum: written to out, not to the node array (whose
// stride, tree_node_stride, holds no level above a single node).
template <int NA>
__device__ void fold_up(const ColTable& a, int64_t g, int64_t n_nodes,
                        double* nodes, int64_t node_stride,
                        unsigned int* gticket, int64_t* out, int col_base) {
  int64_t below = 0, len = n_nodes, tstart = 0;
  for (;;) {
    __threadfence();
    const int64_t above = below + len;
    const int64_t n_above = (len + TREE_W - 1) / TREE_W;
#pragma unroll 1
    for (int j = 0; j < NA; ++j) {
      if (a.c[j].dtype != DT_F64) continue;
      const double* src = nodes + j * node_stride + below + g * TREE_W;
      double v[TREE_W];
#pragma unroll
      for (int q = 0; q < TREE_W; ++q)
        v[q] = g * TREE_W + q < len ? __ldcg(src + q) : 0.0;
      double s = 0.0;
#pragma unroll
      for (int q = 0; q < TREE_W; ++q) s += v[q];
      if (n_above == 1)
        out[1 + 4 * (col_base + j) + 1] = sum_bits(s);
      else
        nodes[j * node_stride + above + g] = s;
    }
    if (n_above == 1) return;
    __threadfence();
    tstart += n_above;
    const int64_t g2 = g / TREE_W;
    const int64_t left = n_above - g2 * TREE_W;
    const unsigned int want =
        static_cast<unsigned int>(left < TREE_W ? left : TREE_W);
    if (atomicAdd(gticket + tstart + g2, 1u) != want - 1) return;
    gticket[tstart + g2] = 0u;             // ready for the next launch
    below = above;
    len = n_above;
    g = g2;
  }
}

template <int NA>
__global__ void __launch_bounds__(ROWS_THREADS, ROWS_BPS)
rows_agg_kernel(ColTable p, ColTable a, RowsArgs ra) {
  constexpr int NC = 1;
  constexpr int W = NC + 4 * NA;
  extern __shared__ __align__(128) unsigned char dsm[];
  __shared__ __align__(8) uint64_t full[RING], empty[RING];
  __shared__ int ncnt[NBUF][MAX_COLS][2];
  __shared__ int mcnt[NBUF];
  __shared__ int64_t s_lo[MAX_COLS], s_hi[MAX_COLS];
  __shared__ int64_t sh[CWARPS][W];
  __shared__ bool last;
  const int64_t r = blockIdx.y;
  const int64_t n = ra.n, roff = r * n;
  int64_t* part = ra.part + r * PART_SLOTS * MAX_BLOCKS;
  unsigned int* ticket = ra.ticket + r;
  unsigned int* gticket = ra.gticket + r * ra.gstride;
  double* nodes = ra.nodes + r * MAX_COLS * ra.node_stride;
  int64_t* out = ra.out + r * ra.out_w;
  const int k = p.n, ncol = k + NA;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t T = (n + CHUNK - 1) / CHUNK;
  const int nb = static_cast<int>(T < MAX_BLOCKS ? T : MAX_BLOCKS);
  const int b0 = blockIdx.x * ra.per;
  const int b1 = b0 + ra.per < nb ? b0 + ra.per : nb;
  const int64_t n_nodes = (n + NODE_ROWS - 1) / NODE_ROWS;
  int nf = 0;
#pragma unroll
  for (int j = 0; j < NA; ++j) nf += a.c[j].dtype == DT_F64;
  unsigned char* ring = dsm;
  double (*stg)[WWIN][TREE_W + 1] = reinterpret_cast<
      double (*)[WWIN][TREE_W + 1]>(dsm + RING * SLOT_BYTES);
  double* wbuf = reinterpret_cast<double*>(dsm + RING * SLOT_BYTES +
                                           STG_BYTES);     // [NBUF][nf][64]
  int64_t* mmbuf = reinterpret_cast<int64_t*>(
      wbuf + NBUF * nf * CHUNK_WIN);            // [NBUF][CWARPS][2 nf]

  stage_bounds(p, ra.bounds, 2 * k, s_lo, s_hi);
  for (int i = threadIdx.x; i < NBUF * MAX_COLS * 2; i += ROWS_THREADS)
    (&ncnt[0][0][0])[i] = 0;
  if (threadIdx.x < NBUF) mcnt[threadIdx.x] = 0;
  if (threadIdx.x == 0) {
#pragma unroll 1
    for (int s = 0; s < RING; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CWARPS);
    }
    mbar_fence_init();
  }
  __syncthreads();

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
  if (warp == CWARPS) {
    // the producer: item i into slot i % RING once every consumer warp
    // has freed the slot's item i - RING
    if (lane == 0 && ncol > 0) {
      Cursor q = {b0, b0, 0};
#pragma unroll 1
      for (uint32_t i = 0;; ++i) {
        const int s = i % RING;
        if (i >= RING) mbar_wait(&empty[s], ((i / RING) - 1) & 1u);
        if (!issue(p, a, ncol, T, nb, b1, roff, n, q,
                   ring + s * SLOT_BYTES, &full[s]))
          break;
      }
    }
    __syncwarp();
  } else {
    uint32_t item = 0;                      // items consumed
    // the shared buffers of a chunk and of a logical block go by their
    // place in the block's sequence, which the ring keeps every warp
    // within RING items of
    int cseq = 0;
#pragma unroll 1
    for (int b = b0; b < b1; ++b) {
#pragma unroll 1
      for (int64_t c = b; c < T; c += nb) {
        const int64_t lbase = c * CHUNK + warp * WRUN + 2 * lane;
        const bool whole = c * CHUNK + CHUNK <= n;
        uint32_t mask = 0;
#pragma unroll
        for (int e = 0; e < RUN; ++e)
          mask |= static_cast<uint32_t>(lbase + 64 * (e >> 1) + (e & 1) < n)
                  << e;
#pragma unroll
        for (int col = 0; col < MAX_COLS; ++col) {
          if (col < k) {
            Run pr;
            consume(ring, full, empty, item, p.c[col].dtype, warp, lane,
                    pr);
            mask &= pred_bits(p.c[col], pr, s_lo[col], s_hi[col]);
          }
        }
        cnt += __popc(mask);
        store_mask(ra.mask, roff + lbase, roff + n, whole, mask);
        const int cb = cseq++ % NBUF;
        int fj = 0;
#pragma unroll
        for (int j = 0; j < NA; ++j) {
          Run ar;
          consume(ring, full, empty, item, a.c[j].dtype, warp, lane, ar);
          agg_run(a.c[j], ar, mask, acc[j]);
          if (a.c[j].dtype == DT_F64) {
            window_step(ar, mask, stg[warp],
                        wbuf + (cb * nf + fj) * CHUNK_WIN, ncnt[cb][fj],
                        nodes + j * ra.node_stride, c, n_nodes, warp, lane);
            ++fj;
          }
        }
      }
      // logical block b's float64 min / max: the warp's shuffle tree into
      // mmbuf, then the last warp folds the eight in warp order, as the
      // loop kernel's block b does
      if (nf > 0) {
        const int mb = (b - b0) % NBUF;
        int64_t* mm = mmbuf + static_cast<int64_t>(mb) * CWARPS * 2 * nf;
        int fj = 0;
#pragma unroll
        for (int j = 0; j < NA; ++j) {
          if (a.c[j].dtype != DT_F64) continue;
          const int64_t mn = warp_fold_t<OP_MIN_F>(acc[j][2]);
          const int64_t mx = warp_fold_t<OP_MAX_F>(acc[j][3]);
          if (lane == 0) {
            mm[warp * 2 * nf + 2 * fj] = mn;
            mm[warp * 2 * nf + 2 * fj + 1] = mx;
          }
          acc[j][2] = ident(OP_MIN_F);
          acc[j][3] = ident(OP_MAX_F);
          ++fj;
        }
        __syncwarp();
        int lastw = 0;
        if (lane == 0) {
          __threadfence_block();
          lastw = atomicAdd(&mcnt[mb], 1) == CWARPS - 1;
        }
        if (__shfl_sync(0xffffffffu, lastw, 0)) {
          __threadfence_block();
          if (lane < 2 * nf) {
            int col = 0, seen = 0;
#pragma unroll
            for (int j = 0; j < NA; ++j) {
              if (a.c[j].dtype != DT_F64) continue;
              if (seen++ == lane / 2) col = j;
            }
            const int op = lane & 1 ? OP_MAX_F : OP_MIN_F;
            part[static_cast<int64_t>(NC + 4 * col + 2 + (lane & 1)) *
                     MAX_BLOCKS + b] =
                ordered_fold<CWARPS>(op, mm + lane, CWARPS, 2 * nf, false);
          }
          __syncwarp();
          if (lane == 0) mcnt[mb] = 0;
        }
      }
    }
  }
  __syncthreads();

  // the other slots: one partial a grid block (order-free)
  if (warp < CWARPS) {
    const int64_t c0 = warp_fold_t<OP_ADD_I>(cnt);
    if (lane == 0) sh[warp][0] = c0;
#pragma unroll
    for (int j = 0; j < NA; ++j) {
      int64_t v[4];
      v[0] = warp_fold_t<OP_ADD_I>(acc[j][0]);
      if (a.c[j].dtype != DT_F64) {
        v[1] = warp_fold_t<OP_ADD_I>(acc[j][1]);
        v[2] = warp_fold_t<OP_MIN_I>(acc[j][2]);
        v[3] = warp_fold_t<OP_MAX_I>(acc[j][3]);
      }
      if (lane == 0) {
        sh[warp][NC + 4 * j] = v[0];
        if (a.c[j].dtype != DT_F64)
          for (int f = 1; f < 4; ++f) sh[warp][NC + 4 * j + f] = v[f];
      }
    }
  }
  __syncthreads();
  if (threadIdx.x < W) {
    const int s = threadIdx.x, op = slot_op<NC>(a, s);
    if (op != OP_ADD_F && op != OP_MIN_F && op != OP_MAX_F)
      part[static_cast<int64_t>(s) * MAX_BLOCKS + blockIdx.x] =
          ordered_fold<CWARPS>(op, &sh[0][s], CWARPS, W, false);
  }
  // partials and node sums visible before the tickets
  __threadfence();
  __syncthreads();
  if (nf > 0 && warp < CWARPS) {
    // a ticket a chunk on its group of 32 nodes; the thread whose chunk
    // completes a group folds it, and on up (fold_up)
    for (int b = b0 + warp; b < b1; b += CWARPS) {
      for (int64_t c = b + static_cast<int64_t>(lane) * nb; c < T;
           c += 32 * static_cast<int64_t>(nb)) {
        const int64_t g = c / GROUP_CHUNKS;
        const int64_t left = T - g * GROUP_CHUNKS;
        const unsigned int want =
            static_cast<unsigned int>(left < GROUP_CHUNKS ? left
                                                          : GROUP_CHUNKS);
        if (atomicAdd(gticket + g, 1u) != want - 1) continue;
        gticket[g] = 0u;                    // ready for the next launch
        fold_up<NA>(a, g, n_nodes, nodes, ra.node_stride, gticket, out,
                    ra.col_base);
      }
    }
  }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!last) return;

  // the row's last block: the per-block slots over the G grid blocks, the
  // float64 min / max over the nb logical blocks (lane l folds l, l + 32,
  // ... in order, then the warp's tree, as the loop kernel's last block)
  __threadfence();
  const int G = static_cast<int>(gridDim.x);
  for (int s = warp; s < W; s += ROWS_THREADS / 32) {
    const int op = slot_op<NC>(a, s);
    if (op == OP_ADD_F) continue;          // the sums: fold_up
    const int cnt_p = op == OP_MIN_F || op == OP_MAX_F ? nb : G;
    const int mine = lane < cnt_p ? (cnt_p - lane + 31) / 32 : 0;
    int64_t v = mine ? ordered_fold<(MAX_BLOCKS + 31) / 32>(
                           op, part + static_cast<int64_t>(s) * MAX_BLOCKS +
                                   lane, mine, 32, true)
                     : ident(op);
    v = warp_fold(op, v);
    if (lane == 0) out[s < NC ? s : s + 4 * ra.col_base] = v;
  }
  if (threadIdx.x == 0) *ticket = 0u;
}

// Launch rows_agg_kernel<NA> over m aggregate columns (one launch per
// MAX_COLS) on a grid of G x rows, G R about ROWS_BPS blocks an SM (one
// where two do not fit in shared memory)
static int launch_rows(const ColTable& p, const ColDesc* aggs, int m,
                       RowsArgs ra, int rows, cudaStream_t s) {
  int dev = 0, sms = 132;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int64_t T = (ra.n + CHUNK - 1) / CHUNK;
  const int nb = static_cast<int>(T < MAX_BLOCKS ? T : MAX_BLOCKS);
  static int caps[MAX_COLS + 1] = {};
  int g = 0;
  do {
    ColTable a;
    a.n = m - g < MAX_COLS ? m - g : MAX_COLS;
    int nf = 0;
    for (int j = 0; j < a.n; ++j) {
      a.c[j] = aggs[g + j];
      nf += a.c[j].dtype == DT_F64;
    }
    const int smem = rows_smem(nf);
    const int bps = 2 * (smem + 8 * 1024) <= 227 * 1024 ? ROWS_BPS : 1;
    const int64_t per = (static_cast<int64_t>(nb) * rows + sms * bps - 1) /
                        (sms * bps);
    ra.per = static_cast<int>(per < 1 ? 1 : per);
    ra.col_base = g;
    const dim3 grid((nb + ra.per - 1) / ra.per, rows);
    cudaError_t e = cudaSuccess;
#define K2S_LAUNCH(NA)                                                   \
  if (caps[NA] == 0) caps[NA] = 48 * 1024;                               \
  e = allow_smem(rows_agg_kernel<NA>, smem, &caps[NA]);                  \
  if (e == cudaSuccess)                                                  \
    rows_agg_kernel<NA><<<grid, ROWS_THREADS, smem, s>>>(p, a, ra)
    switch (a.n) {
      case 0: K2S_LAUNCH(0); break;
      case 1: K2S_LAUNCH(1); break;
      case 2: K2S_LAUNCH(2); break;
      case 3: K2S_LAUNCH(3); break;
      case 4: K2S_LAUNCH(4); break;
      case 5: K2S_LAUNCH(5); break;
      case 6: K2S_LAUNCH(6); break;
      case 7: K2S_LAUNCH(7); break;
      default: K2S_LAUNCH(8);
    }
#undef K2S_LAUNCH
    if (e != cudaSuccess) return static_cast<int>(e);
    g += MAX_COLS;
  } while (g < m);
  return static_cast<int>(cudaGetLastError());
}

// preds: k <= MAX_COLS predicate descriptors; aggs: m aggregate columns
// (any number, one launch per MAX_COLS), row 0's operands of a stacked
// [rows, n] set.  blocks <= MAX_BLOCKS a row (the first design's grid);
// part: int64[rows, PART_SLOTS, MAX_BLOCKS] scratch, ticket: uint32[rows]
// and gticket: uint32[rows, gstride] (gstride >= the groups of every
// level above the nodes: tree_node_stride will do), 0
// between launches (the kernels leave them 0), all private to the stream;
// vec: every operand 16-byte aligned; nodes: float64[rows, MAX_COLS,
// node_stride] scratch, node_stride at least ceil(n / 1024) plus the upper
// levels (tree_node_stride in kernels/columnar_ops.py); bounds:
// int64[rows, k, 2] bound bits on the device; mask: bool[rows, n].
// out: int64[rows, 1 + 4m], float slots as raw f64 bits.  Aligned
// operands with n a multiple of 16 take rows_agg_kernel, others the
// first design.
extern "C" int rt_filter_aggregate_rows(const ColDesc* preds, int k,
                                        const ColDesc* aggs, int m,
                                        int64_t n, int rows, int blocks,
                                        int vec, int64_t* part,
                                        unsigned int* ticket,
                                        unsigned int* gticket,
                                        int64_t gstride, int64_t* out,
                                        double* nodes, int64_t node_stride,
                                        const int64_t* bounds, uint8_t* mask,
                                        void* stream) {
  int64_t groups = 0;                      // tickets of every level
  for (int64_t len = (n + NODE_ROWS - 1) / NODE_ROWS;;) {
    len = (len + TREE_W - 1) / TREE_W;
    groups += len;
    if (len <= 1) break;
  }
  if (k > MAX_COLS || rows < 1 || rows > 65535 || n < 1 ||
      (k > 0 && bounds == nullptr) || mask == nullptr || gstride < groups)
    return static_cast<int>(cudaErrorInvalidValue);
  ColTable p;
  p.n = k;
  for (int j = 0; j < k; ++j) p.c[j] = preds[j];
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!vec || n % 16 != 0) {
    RowArgs ra = {};
    ra.bounds = bounds;
    ra.mask = mask;
    ra.rows_vec = n % 16 == 0;
    return launch_agg<false, true>(p, aggs, m, n, rows, blocks, vec, part,
                                   ticket, out, 1 + 4 * m, nodes,
                                   node_stride, ra, s);
  }
  RowsArgs ra = {};
  ra.n = n;
  ra.bounds = bounds;
  ra.mask = mask;
  ra.part = part;
  ra.ticket = ticket;
  ra.gticket = gticket;
  ra.gstride = gstride;
  ra.nodes = nodes;
  ra.node_stride = node_stride;
  ra.out = out;
  ra.out_w = 1 + 4 * m;
  return launch_rows(p, aggs, m, ra, rows, s);
}

// The loop path's K2: one row, the descriptors' bounds, no mask; sum32:
// at n = 32, the U of the reference's order (sum32_unroll of the
// predicate columns before any were folded), else 0.
extern "C" int rt_filter_aggregate(const ColDesc* preds, int k,
                                   const ColDesc* aggs, int m, int64_t n,
                                   int blocks, int vec, int64_t* part,
                                   unsigned int* ticket, int64_t* out,
                                   double* nodes, int64_t node_stride,
                                   int sum32, void* stream) {
  if (k > MAX_COLS || sum32 < 0 || sum32 > 4 || sum32 == 3)
    return static_cast<int>(cudaErrorInvalidValue);
  ColTable p;
  p.n = k;
  for (int j = 0; j < k; ++j) p.c[j] = preds[j];
  RowArgs ra = {};
  ra.sum32 = sum32;
  return launch_agg<false, false>(p, aggs, m, n, 1, blocks, vec, part,
                                  ticket, out, 1 + 4 * m, nodes, node_stride,
                                  ra, static_cast<cudaStream_t>(stream));
}
