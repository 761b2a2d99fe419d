// Shared descriptors and row-run loads for the columnar kernels (K1, K2
// and A6's second pass).
// The descriptor layouts are mirrored by ctypes structures in
// kernels/columnar_ops.py: change both.
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

enum { DT_I64 = 0, DT_F64 = 1, DT_I32 = 2 };

// One column operand: values in their own dtype (int64 / float64 / int32
// dictionary codes), a byte-per-row validity bitmap, and for predicate
// columns the [lo, hi] bounds already cast to the column's dtype on the
// host (the reference's _prep_bounds).
struct ColDesc {
  const void* data;
  const uint8_t* valid;
  int64_t lo_i, hi_i;
  double lo_f, hi_f;
  int32_t dtype;
  int32_t pad_;
};

#define MAX_COLS 8

// Passed by value as a kernel parameter (constant bank): no device
// allocation for the descriptor table.
struct ColTable {
  ColDesc c[MAX_COLS];
  int n;
};

static inline int grid_for(int64_t n, int threads, int max_blocks) {
  int64_t b = (n + threads - 1) / threads;
  if (b < 1) b = 1;
  return static_cast<int>(b < max_blocks ? b : max_blocks);
}

// A lane's run of R rows of one column: a warp takes 32 R consecutive rows
// and lane i rows 64 k + 2 i + e (k < R / 2, e < 2), so each of the lane's
// R / 2 loads of a column is one coalesced warp access: int64 / float64
// data as 16-byte vectors (2 rows), int32 codes as 8 bytes, validity as 2
// bytes.  (A lane of 16 consecutive rows, one 16-byte validity vector,
// made every data load touch 32 lines and ran K2 at 5x its bound.)  Row
// 64 k + e of the lane is bit 2 k + e; its two validity bytes are v[k],
// the values x[2 k + e] as int64 (int64, float64 bits, or int32 codes
// widened).
template <int R>
struct RowRun {
  uint32_t v[R / 2];
  int64_t x[R];
};

// 4 validity bytes -> 4 bits (byte i nonzero -> bit i)
__device__ __forceinline__ uint32_t nib(uint32_t w) {
  const uint32_t nz = (((w & 0x7f7f7f7fu) + 0x7f7f7f7fu) | w) & 0x80808080u;
  return ((nz >> 7) * 0x01020408u) >> 24;
}
// v[2 q] and v[2 q + 1] hold the bytes of bits 4 q .. 4 q + 3
template <int R>
__device__ __forceinline__ uint32_t valid_bits(const RowRun<R>& r) {
  uint32_t bits = 0;
#pragma unroll
  for (int q = 0; q < R / 4; ++q)
    bits |= nib(r.v[2 * q] | (r.v[2 * q + 1] << 16)) << (4 * q);
  return bits;
}

__device__ __forceinline__ int64_t lo_hi(uint32_t lo, uint32_t hi) {
  return static_cast<int64_t>(static_cast<uint64_t>(lo) |
                              (static_cast<uint64_t>(hi) << 32));
}

// Whether a column's run loads can be vectors: the validity bytes 2-byte
// aligned and the data 16-byte (int32 codes 8-byte) aligned at an even row.
__device__ __forceinline__ bool col_aligned(const ColDesc& c) {
  const uintptr_t d = reinterpret_cast<uintptr_t>(c.data);
  const uintptr_t v = reinterpret_cast<uintptr_t>(c.valid);
  return (v & 1) == 0 && (d & (c.dtype == DT_I32 ? 7 : 15)) == 0;
}

// Start the loads of column c's rows of the lane's run (its first row
// `base`, rows base + 64 k + e); `vec`: the whole run lies below n and the
// column's operands are aligned for vectors (col_aligned), else the rows
// below n load one by one.
template <int R>
__device__ __forceinline__ void load_run(const ColDesc& c, int64_t base,
                                         int64_t n, bool vec, RowRun<R>& r) {
  if (vec) {
#pragma unroll
    for (int k = 0; k < R / 2; ++k)
      r.v[k] = __ldg(reinterpret_cast<const unsigned short*>(
          c.valid + base + 64 * k));
    if (c.dtype == DT_I32) {
#pragma unroll
      for (int k = 0; k < R / 2; ++k) {
        const uint2 w = __ldg(reinterpret_cast<const uint2*>(
            static_cast<const int32_t*>(c.data) + base + 64 * k));
        r.x[2 * k] = static_cast<int32_t>(w.x);
        r.x[2 * k + 1] = static_cast<int32_t>(w.y);
      }
    } else {
#pragma unroll
      for (int k = 0; k < R / 2; ++k) {
        const uint4 w = __ldg(reinterpret_cast<const uint4*>(
            static_cast<const int64_t*>(c.data) + base + 64 * k));
        r.x[2 * k] = lo_hi(w.x, w.y);
        r.x[2 * k + 1] = lo_hi(w.z, w.w);
      }
    }
    return;
  }
#pragma unroll
  for (int k = 0; k < R / 2; ++k) {
    r.v[k] = 0u;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int64_t row = base + 64 * k + e;
      const bool in = row < n;
      r.v[k] |= (in ? static_cast<uint32_t>(c.valid[row]) : 0u) << (8 * e);
      r.x[2 * k + e] = !in ? 0
          : c.dtype == DT_I32
              ? static_cast<int64_t>(static_cast<const int32_t*>(c.data)[row])
              : static_cast<const int64_t*>(c.data)[row];
    }
  }
}

// Rows of the run that are valid and inside [lo, hi] (NaN fails both
// compares, as in x64 jnp); lo and hi are the bounds' bits (float64 bounds
// as their raw bits), the column's dtype is resolved once a run
template <int R>
__device__ __forceinline__ uint32_t pred_bits(const ColDesc& c,
                                              const RowRun<R>& r,
                                              int64_t lo, int64_t hi) {
  uint32_t in = 0;
  if (c.dtype == DT_F64) {
    const double lf = __longlong_as_double(lo), hf = __longlong_as_double(hi);
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const double x = __longlong_as_double(r.x[i]);
      in |= static_cast<uint32_t>(x >= lf && x <= hf) << i;
    }
  } else {
#pragma unroll
    for (int i = 0; i < R; ++i)
      in |= static_cast<uint32_t>(r.x[i] >= lo && r.x[i] <= hi) << i;
  }
  return in & valid_bits(r);
}

// The row axis of the columnar kernels (K1, K2 and A6's second pass): the
// grid's y index is a row of a stacked [R, n] operand set, row r's
// operands start r * n rows into every column, and its predicate bounds
// are bounds[r * bstride + 2 j], [... + 1] (bits).  Threads below t.n
// stage them in shared memory (the caller syncs).  The loop path's
// one-row launches (ROWS false below) read the descriptors' own bounds.
__device__ __forceinline__ void stage_bounds(const ColTable& t,
                                             const int64_t* bounds,
                                             int bstride, int64_t* s_lo,
                                             int64_t* s_hi) {
  const int j = threadIdx.x;
  if (j < t.n) {
    const int64_t* b = bounds + static_cast<int64_t>(blockIdx.y) * bstride;
    s_lo[j] = b[2 * j];
    s_hi[j] = b[2 * j + 1];
  }
}

// Predicate j's bounds as bits: the row's staged ones, or the descriptor's
template <bool ROWS>
__device__ __forceinline__ int64_t bound_lo(const ColDesc& c,
                                            const int64_t* s_lo, int j) {
  if constexpr (ROWS) return s_lo[j];
  else return c.dtype == DT_F64 ? __double_as_longlong(c.lo_f) : c.lo_i;
}
template <bool ROWS>
__device__ __forceinline__ int64_t bound_hi(const ColDesc& c,
                                            const int64_t* s_hi, int j) {
  if constexpr (ROWS) return s_hi[j];
  else return c.dtype == DT_F64 ? __double_as_longlong(c.hi_f) : c.hi_i;
}
