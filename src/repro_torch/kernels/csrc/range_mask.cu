// K1 range_mask: conjunctive [lo, hi] + validity mask over K columns.
//
// Replaces the TPU kernel repro/kernels/columnar_ops.py:_mask_kernel
// (host wrapper _mask_pallas).  The TPU version stacks the K columns into
// one [K8, N] f32 operand, which loses exactness for int64 values beyond
// 2**24; here every column is read in its own dtype (int64, float64 or
// int32 dictionary codes) and compared against bounds cast to that dtype
// on the host, matching the exact x64 path (_mask_core).
//
// Bound: memory.  Each row reads 8 (or 4) value bytes plus one validity
// byte per column and writes one mask byte, (9K + 1) bytes a row, against
// a handful of compares.  Design: one pass that streams every column once
// with its loads in flight together.  A warp takes runs of 32 K1_RUN rows,
// lane i rows 64 k + 2 i + e (common.cuh's RowRun), so every load and
// store is a coalesced warp access: values as 16-byte vectors (int32
// codes 8 bytes), validity and the mask as 2 bytes.  With K <= 2 (the
// kernel is templated on it) every load of every column is in flight
// before any compare, ~0.5 µs faster at the path's shapes than the
// generic loop; beyond, each column's successor is loading before the
// column is tested.  A column's dtype is resolved once a run and the
// conjunction is branch-free (a row bit is valid & x >= lo & x <= hi, so
// NaN and invalid rows fail).  The grid is about one wave of runs (256
// blocks at 2**19 rows; 8 rows a lane ran ~0.1 µs faster than 16 and 32
// at the path's shapes, scripts/probes/k1_a7_floor.py).  At 2**19 rows
// K1 is within a few tenths of a µs of a bare stream of the same bytes
// (stream_floor.cu there).  A run that ends past n, or a column whose
// operands are not aligned for vectors (any contiguous view is taken),
// loads its rows one by one; the mask of such a run is stored bytewise.
// The descriptor table rides in the kernel's parameter bank and nothing is
// allocated.
//
// The grid's y axis is the row axis of the partition runtime's stacked K1
// (repro/runtime/spmd.py:_mask_fn, ROWS true): row r masks rows r * n ...
// of every column against its own bounds (common.cuh's stage_bounds),
// which the block stages in shared memory.  The loop path's launch is
// ROWS false: one row, the descriptors' bounds, nothing staged.
#include "common.cuh"

#define K1_RUN 8                  // rows a lane takes at a time
#define K1_THREADS 256
#define K1_WRUN (32 * K1_RUN)     // rows a warp takes at a time

using KRun = RowRun<K1_RUN>;

// KC = 1, 2: that many columns, all in flight; KC = 0: any t.n <= MAX_COLS,
// two in flight.  accumulate: AND the mask into out (a later pass of more
// than MAX_COLS predicates).  ROWS: bounds, bstride are the rows' bounds;
// rows_vec: rows past the first keep the vector alignment (n a multiple
// of 16).
template <int KC, bool ROWS>
__global__ void __launch_bounds__(K1_THREADS)
range_mask_kernel(ColTable t, int64_t n, uint8_t* out, int accumulate,
                  const int64_t* bounds, int bstride, int rows_vec) {
  __shared__ int64_t s_lo[MAX_COLS], s_hi[MAX_COLS];
  if constexpr (ROWS) {
    stage_bounds(t, bounds, bstride, s_lo, s_hi);
    __syncthreads();
  }
  const int lane = threadIdx.x & 31;
  // the row's first row of the stacked operands
  const int64_t roff = ROWS ? static_cast<int64_t>(blockIdx.y) * n : 0;
  const int64_t end = roff + n;
  const bool vec_ok = !ROWS || blockIdx.y == 0 || rows_vec;
  const bool out_vec = vec_ok && (reinterpret_cast<uintptr_t>(out) & 1) == 0;
  const int64_t wruns = (n + K1_WRUN - 1) / K1_WRUN;
  const int64_t nwarps = static_cast<int64_t>(gridDim.x) * (K1_THREADS / 32);
  for (int64_t wr = static_cast<int64_t>(blockIdx.x) * (K1_THREADS / 32) +
                    (threadIdx.x >> 5);
       wr < wruns; wr += nwarps) {
    // the lane's first row (of the stacked operands)
    const int64_t base = roff + wr * K1_WRUN + 2 * lane;
    const bool full = vec_ok && wr * K1_WRUN + K1_WRUN <= n;
    uint32_t mask = 0;
#pragma unroll
    for (int b = 0; b < K1_RUN; ++b)
      mask |= static_cast<uint32_t>(base + 64 * (b >> 1) + (b & 1) < end)
              << b;
#ifndef K1_PROBE_NO_LOADS        // scripts/probes: the stores alone
    if constexpr (KC > 0) {
      KRun r[KC];
#pragma unroll
      for (int j = 0; j < KC; ++j)
        load_run(t.c[j], base, end, full && col_aligned(t.c[j]), r[j]);
#pragma unroll
      for (int j = 0; j < KC; ++j)
        mask &= pred_bits(t.c[j], r[j], bound_lo<ROWS>(t.c[j], s_lo, j),
                          bound_hi<ROWS>(t.c[j], s_hi, j));
    } else {
      // column c's run sits in r[c & 1] (unrolled, so no run is copied)
      KRun r[2];
      load_run(t.c[0], base, end, full && col_aligned(t.c[0]), r[0]);
#pragma unroll
      for (int c = 0; c < MAX_COLS; ++c) {
        if (c < t.n) {
          if (c + 1 < t.n)
            load_run(t.c[c + 1], base, end,
                     full && col_aligned(t.c[c + 1]), r[(c + 1) & 1]);
          mask &= pred_bits(t.c[c], r[c & 1],
                            bound_lo<ROWS>(t.c[c], s_lo, c),
                            bound_hi<ROWS>(t.c[c], s_hi, c));
        }
      }
    }
#endif
    if (full && out_vec) {
      unsigned short* o = reinterpret_cast<unsigned short*>(out + base);
      if (accumulate) {
        uint32_t old = 0;
#pragma unroll
        for (int q = 0; q < K1_RUN / 4; ++q)
          old |= nib(static_cast<uint32_t>(o[64 * q]) |
                     (static_cast<uint32_t>(o[64 * q + 32]) << 16)) << (4 * q);
        mask &= old;
      }
#pragma unroll
      for (int q = 0; q < K1_RUN / 2; ++q)
        o[32 * q] = static_cast<unsigned short>(((mask >> (2 * q)) & 1u) |
                                                (((mask >> (2 * q + 1)) & 1u)
                                                 << 8));
    } else {
#pragma unroll
      for (int b = 0; b < K1_RUN; ++b) {
        const int64_t row = base + 64 * (b >> 1) + (b & 1);
        if (row < end) {
          const bool m = (mask >> b) & 1u;
          out[row] = static_cast<uint8_t>(accumulate ? (out[row] != 0 && m)
                                                     : m);
        }
      }
    }
  }
}

template <bool ROWS>
static void launch_k1(const ColTable& t, dim3 grid, int64_t n, uint8_t* out,
                      int acc, const int64_t* b, int bstride, int rows_vec,
                      cudaStream_t s) {
  if (t.n == 1)
    range_mask_kernel<1, ROWS><<<grid, K1_THREADS, 0, s>>>(
        t, n, out, acc, b, bstride, rows_vec);
  else if (t.n == 2)
    range_mask_kernel<2, ROWS><<<grid, K1_THREADS, 0, s>>>(
        t, n, out, acc, b, bstride, rows_vec);
  else
    range_mask_kernel<0, ROWS><<<grid, K1_THREADS, 0, s>>>(
        t, n, out, acc, b, bstride, rows_vec);
}

// cols: host array of k descriptors (row 0's operands); out: bool[rows, n]
// on the device; bounds: null (one row, the descriptors' bounds) or
// int64[rows, k, 2] on the device, each row's lo / hi bits a column.  More
// than MAX_COLS predicates run as several passes ANDed into out.  The grid
// is about one wave of runs over all rows.
extern "C" int rt_range_mask_rows(const ColDesc* cols, int k, int64_t n,
                                  int rows, const int64_t* bounds,
                                  uint8_t* out, void* stream) {
  if (rows < 1 || rows > 65535 || (rows > 1 && bounds == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t wruns = (n + K1_WRUN - 1) / K1_WRUN;
  const int per_row = (132 * 8 + rows - 1) / rows;
  const dim3 grid(grid_for(wruns, K1_THREADS / 32, per_row), rows);
  const int rows_vec = n % 16 == 0;
  for (int g = 0; g < k; g += MAX_COLS) {
    ColTable t;
    t.n = k - g < MAX_COLS ? k - g : MAX_COLS;
    for (int j = 0; j < t.n; ++j) t.c[j] = cols[g + j];
    const int acc = g > 0;
    if (bounds != nullptr)
      launch_k1<true>(t, grid, n, out, acc, bounds + 2 * g, 2 * k, rows_vec,
                      s);
    else
      launch_k1<false>(t, grid, n, out, acc, nullptr, 0, rows_vec, s);
  }
  return static_cast<int>(cudaGetLastError());
}

// The loop path's K1: one row with the descriptors' bounds.
extern "C" int rt_range_mask(const ColDesc* cols, int k, int64_t n,
                             uint8_t* out, void* stream) {
  return rt_range_mask_rows(cols, k, n, 1, nullptr, out, stream);
}

extern "C" const char* rt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
