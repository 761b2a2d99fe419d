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
// Two launches with a row axis (a partition row of the stacked operands;
// the loop path is one row), through one C entry (rt_chain):
//  1. chain_scatter_kernel: only "count > 0" is read, so each storage slot
//     is a byte flag set without atomics: every writer stores the
//     dispatch's stamp, 1 .. 255.  The flags live in a buffer the wrapper
//     keeps per device and stream (chain_ops._flag_buffer) and are zeroed
//     only when the buffer is new or the stamp wraps after 255 dispatches
//     (a memset in rt_chain then): since that memset every byte is 0 or an
//     earlier dispatch's stamp, so a slot reads as set only if a lane of
//     this dispatch wrote it.  A block takes one (row, tier) and strides
//     over the lanes in [a, b) only, one a thread, so padding and
//     out-of-slice lanes are never read (the reference's sentinel slot
//     is not needed).  In mask mode its first block also zeroes the
//     counts pass 2 adds into.
//  2. Per lane of a row, cand = field 0's flag at idx holds the stamp &
//     lane < n_live, found = cand & every other field's, then the
//     predicates AND in, in the reference's order; it writes the mask.
//     - Mask mode (no aggregate column): chain_mask_kernel, one wave of
//       resident blocks over every row's logical blocks (below), launched
//       as a programmatic dependent of the scatter (its blocks start
//       while the scatter's last ones run and wait for the stamps).  It
//       only counts n_cand, n_found and n_valid, int64 wrap-adds whose
//       bits do not depend on the order, so it keeps no partials, ticket
//       or fold: a block adds its counts to the row's out with one 64-bit
//       atomic add a slot.
//     - Aggregate mode: agg_kernel<NA, true, true> (agg_kernel.cuh, K2's
//       kernel with A6's chain prefix, a block row a partition row)
//       folds the counts and each column's count / sum / min / max
//       exactly as K2 folds them (float64 sums in tree_sum's order, so
//       the bits equal the reference's per row).  It keeps K2's grid:
//       on one wave of blocks, each folding its logical blocks in turn,
//       it measured slower (PERF.md §6).
//
// Bound: memory.  Pass 1 reads each in-slice posting position once (8 B)
// and stores a byte flag; pass 2 reads a live lane's slot (8 B), one flag
// byte a field, the predicate and aggregate columns ((9K + 9M) B), and
// writes one mask byte.  Launches a dispatch: the scatter and one pass-2
// launch per 8 aggregate columns (one in mask mode), and a memset on the
// dispatches that zero the flags (the first on a stream, and one in 255).
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

// Programmatic dependent launch (sm_90): the launch after this one on the
// stream may start once every block of this one has called
// launch_dependents; its wait returns once this grid has finished and
// its writes are visible to it.
__device__ __forceinline__ void pdl_launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
}
__device__ __forceinline__ void pdl_wait() {
  asm volatile("griddepcontrol.wait;" ::: "memory");
}

// grid (x, rows, tiers): block (x, r, t) strides over tier t's lanes
// [a, b) of row r, one a thread, and stores the stamp at each lane's
// slot; abo: int64[rows, n_tiers_all, 3] (a, b, off) with tier index t0
// + t; zero: null or n_zero int64 counts to clear (block (0, 0, 0))
__global__ void __launch_bounds__(A6_THREADS)
chain_scatter_kernel(TierTable tt, const int64_t* abo, int n_tiers_all,
                     int t0, uint8_t* flags, int nf, int64_t total,
                     int stamp, int64_t* zero, int64_t n_zero) {
  pdl_launch_dependents();              // mask mode's pass 2 may start
  if (zero != nullptr && blockIdx.x == 0 && blockIdx.y == 0 &&
      blockIdx.z == 0)
    for (int64_t i = threadIdx.x; i < n_zero; i += A6_THREADS) zero[i] = 0;
  const int t = blockIdx.z;
  if (t >= tt.nt) return;
  const int64_t r = blockIdx.y;
  const int64_t* q = abo + (r * n_tiers_all + t0 + t) * 3;
  const int64_t w = tt.width[t];
  const int64_t a = q[0] < 0 ? 0 : q[0];
  const int64_t b = q[1] > w ? w : q[1];
  const int64_t off = q[2];
  uint8_t* fl = flags + (r * nf + tt.field[t]) * total;
  const uint8_t st = static_cast<uint8_t>(stamp);
  const int64_t step = static_cast<int64_t>(gridDim.x) * A6_THREADS;
  if (tt.is32[t]) {
    const int32_t* pos = static_cast<const int32_t*>(tt.pos[t]) + r * w;
    for (int64_t i = a + static_cast<int64_t>(blockIdx.x) * A6_THREADS +
                      threadIdx.x;
         i < b;
         i += step) {
      const int64_t s = static_cast<int64_t>(__ldg(pos + i)) + off;
      if (s >= 0 && s < total) fl[s] = st;
    }
  } else {
    const int64_t* pos = static_cast<const int64_t*>(tt.pos[t]) + r * w;
    for (int64_t i = a + static_cast<int64_t>(blockIdx.x) * A6_THREADS +
                      threadIdx.x;
         i < b;
         i += step) {
      const int64_t s = __ldg(pos + i) + off;
      if (s >= 0 && s < total) fl[s] = st;
    }
  }
}

#define A6_ROW_STAGE 64       // rows whose bounds a mask-mode block holds

// Pass 2 in mask mode: a grid of at most the resident blocks, block c
// taking the logical blocks L = c * per ... (c + 1) * per - 1 of the R *
// nblk (per = ceil(R * nblk / grid)), L = r * nblk + b; logical block (r,
// b) scans the warp runs block b of a one-row agg_kernel launch scans on
// row r (b * 8 + warp, then every nblk * 8).  A block adds its counts to
// a row once, after its last logical block of that row.  Rows [rb, rb +
// A6_ROW_STAGE)'s bounds and n_live sit in shared memory.
__global__ void __launch_bounds__(THREADS)
chain_mask_kernel(ColTable p, int64_t n, int vec, int rows, int nblk,
                  int64_t* out, RowArgs ra) {
  __shared__ int64_t s_b[A6_ROW_STAGE * 2 * MAX_COLS];
  __shared__ int64_t s_nl[A6_ROW_STAGE];
  __shared__ int64_t sh[THREADS / 32][3];
  const int k = p.n;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t wruns = (n + WRUN - 1) / WRUN;
  const int n_l = rows * nblk;
  const int per = (n_l + static_cast<int>(gridDim.x) - 1) /
                  static_cast<int>(gridDim.x);
  const int L0 = static_cast<int>(blockIdx.x) * per;
  const int L1 = L0 + per < n_l ? L0 + per : n_l;
  const int64_t step = static_cast<int64_t>(nblk) * (THREADS / 32);
  int rb = -A6_ROW_STAGE;
  pdl_wait();                            // the stamps and the zeroed out
  int64_t cnt = 0, cnt_c = 0, cnt_f = 0;
  for (int L = L0; L < L1; ++L) {
    const int r = L / nblk, b = L % nblk;
    if (r >= rb + A6_ROW_STAGE) {        // the next rows' bounds
      __syncthreads();
      rb = r;
      const int nr = rows - rb < A6_ROW_STAGE ? rows - rb : A6_ROW_STAGE;
      for (int i = threadIdx.x; i < nr * 2 * k; i += THREADS)
        s_b[i] = ra.bounds[static_cast<int64_t>(rb) * 2 * k + i];
      for (int i = threadIdx.x; i < nr; i += THREADS)
        s_nl[i] = ra.n_live[rb + i];
      __syncthreads();
    }
    const int64_t* br = s_b + (r - rb) * 2 * k;
    const int64_t roff = static_cast<int64_t>(r) * n, end = roff + n;
    const bool vec_ok = vec && (r == 0 || ra.rows_vec);
    for (int64_t wr = static_cast<int64_t>(b) * (THREADS / 32) + warp;
         wr < wruns; wr += step) {
      const int64_t lbase = wr * WRUN + 2 * lane;  // the lane's first row
      const int64_t base = roff + lbase;           // ... of the stacked rows
      const bool fast = vec_ok && wr * WRUN + WRUN <= n;
      uint32_t mask = 0;
#pragma unroll
      for (int q = 0; q < RUN; ++q)
        mask |= static_cast<uint32_t>(lbase + 64 * (q >> 1) + (q & 1) < n)
                << q;
      uint32_t cand = 0, found = 0;
      chain_bits(ra, r, lbase, n, s_nl[r - rb], fast, cand, found);
      cand &= mask;
      found &= mask;
      cnt_c += __popc(cand);
      cnt_f += __popc(found);
      mask = found;
      Run pb[2];
      if (k > 0) load_run(p.c[0], base, end, fast, pb[0]);
#pragma unroll
      for (int c = 0; c < MAX_COLS; ++c) {
        if (c < k) {
          if (c + 1 < k)
            load_run(p.c[c + 1], base, end, fast, pb[(c + 1) & 1]);
          mask &= pred_bits(p.c[c], pb[c & 1], br[2 * c], br[2 * c + 1]);
        }
      }
      cnt += __popc(mask);
      store_mask(ra.mask, base, end, fast, mask);
    }
    if (L + 1 == L1 || (L + 1) % nblk == 0) {   // the row's counts out
      const int64_t c3[3] = {cnt_c, cnt_f, cnt};
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        const int64_t v = warp_fold_t<OP_ADD_I>(c3[i]);
        if (lane == 0) sh[warp][i] = v;
      }
      __syncthreads();
      if (threadIdx.x < 3) {
        uint64_t v = 0;
#pragma unroll
        for (int w = 0; w < THREADS / 32; ++w)
          v += static_cast<uint64_t>(sh[w][threadIdx.x]);
        atomicAdd(reinterpret_cast<unsigned long long*>(out + 3 * r +
                                                        threadIdx.x),
                  static_cast<unsigned long long>(v));
      }
      __syncthreads();                   // sh read before it is reused
      cnt = cnt_c = cnt_f = 0;
    }
  }
}

// chain_mask_kernel on at most the resident blocks (found once:
// occupancy x SMs), a programmatic dependent of the scatter
static int launch_chain_mask(const ColTable& p, int64_t n, int vec,
                             int rows, int nblk, int64_t* out,
                             const RowArgs& ra, cudaStream_t s) {
  if (nblk < 1 || nblk > MAX_BLOCKS || (p.n > 0 && ra.bounds == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  static int wave = 0;
  if (wave == 0) {
    int per_sm = 0, dev = 0, sms = 0;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, chain_mask_kernel,
                                                  THREADS, 0);
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    wave = (per_sm > 0 ? per_sm : 1) * (sms > 0 ? sms : 1);
  }
  // per = ceil(items / wave) logical blocks a block, on ceil(items / per)
  // blocks
  const int64_t items = static_cast<int64_t>(rows) * nblk;
  const int64_t per = (items + wave - 1) / wave;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>((items + per - 1) / per));
  cfg.blockDim = dim3(THREADS);
  cfg.stream = s;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return static_cast<int>(cudaLaunchKernelEx(&cfg, chain_mask_kernel, p, n,
                                             vec, rows, nblk, out, ra));
}

// One dispatch.  pos, width, field, is32: nt tiers (every field's, in
// order); abo: int64[rows, nt, 3] on the device; max_len: the longest [a,
// b) slice (sizes the grid); flags: uint8[rows, nf, total] of the pooled
// buffer, whose first clear_bytes (0: none) are zeroed first; stamp: 1 ..
// 255, not used since the buffer was last zeroed.  preds: k <= MAX_COLS
// predicate descriptors and aggs: m aggregate columns, row 0's operands of
// stacked [rows, n] arrays (n = live_p2); bounds: int64[rows, k, 2] bound
// bits on the device; idx: int64[rows, n] live-selection slots; n_live:
// int64[rows]; blocks: agg_blocks(n); part, ticket, nodes, node_stride:
// the scratch rt_filter_aggregate_rows takes; out: int64[rows, 3 + 4m]
// (n_cand, n_found, n_valid, then count / sum / min / max a column, float
// slots as raw f64 bits); mask: bool[rows, n].
extern "C" int rt_chain(const void* const* pos, const int64_t* width,
                        const int* field, const int* is32, int nt,
                        const int64_t* abo, int64_t max_len, uint8_t* flags,
                        int64_t clear_bytes, int stamp, int nf,
                        int64_t total, const ColDesc* preds, int k,
                        const ColDesc* aggs, int m, int64_t n, int rows,
                        int blocks, int vec, const int64_t* bounds,
                        const int64_t* idx, const int64_t* n_live,
                        int64_t* part, unsigned int* ticket, double* nodes,
                        int64_t node_stride, int64_t* out, uint8_t* mask,
                        void* stream) {
  if (rows < 1 || rows > 65535 || nf < 1 || k > MAX_COLS || stamp < 1 ||
      stamp > 255)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (clear_bytes > 0) cudaMemsetAsync(flags, 0, clear_bytes, s);
  const int64_t per = (max_len + A6_THREADS - 1) / A6_THREADS;
  const int gx = static_cast<int>(per < 1 ? 1 : per < 1024 ? per : 1024);
  int g = 0;
  do {
    TierTable tt;
    tt.nt = nt - g < A6_MAX_TIERS ? nt - g : A6_MAX_TIERS;
    for (int t = 0; t < tt.nt; ++t) {
      tt.pos[t] = pos[g + t];
      tt.width[t] = width[g + t];
      tt.field[t] = field[g + t];
      tt.is32[t] = is32[g + t];
    }
    const dim3 grid(gx, rows, tt.nt > 0 ? tt.nt : 1);
    chain_scatter_kernel<<<grid, A6_THREADS, 0, s>>>(
        tt, abo, nt, g, flags, nf, total, stamp,
        g == 0 && m == 0 ? out : nullptr, 3 * static_cast<int64_t>(rows));
    g += A6_MAX_TIERS;
  } while (g < nt);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
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
  ra.stamp = stamp;
  ra.rows_vec = n % 16 == 0;
  if (m == 0) return launch_chain_mask(p, n, vec, rows, blocks, out, ra, s);
  return launch_agg<true, true>(p, aggs, m, n, rows, blocks, vec, part,
                                ticket, out, 3 + 4 * m, nodes, node_stride,
                                ra, s);
}
