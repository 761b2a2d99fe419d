// Shared descriptors for the columnar kernels (K1, K2).  The layouts are
// mirrored by ctypes structures in kernels/columnar_ops.py: change both.
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

__device__ __forceinline__ bool pred_ok(const ColDesc& d, int64_t i) {
  if (!d.valid[i]) return false;
  if (d.dtype == DT_F64) {
    const double x = static_cast<const double*>(d.data)[i];
    return x >= d.lo_f && x <= d.hi_f;  // NaN fails both, as in x64 jnp
  }
  const int64_t x = d.dtype == DT_I32
      ? static_cast<int64_t>(static_cast<const int32_t*>(d.data)[i])
      : static_cast<const int64_t*>(d.data)[i];
  return x >= d.lo_i && x <= d.hi_i;
}

__device__ __forceinline__ bool row_ok(const ColTable& t, int64_t i) {
  for (int j = 0; j < t.n; ++j)
    if (!pred_ok(t.c[j], i)) return false;
  return true;
}

static inline int grid_for(int64_t n, int threads, int max_blocks) {
  int64_t b = (n + threads - 1) / threads;
  if (b < 1) b = 1;
  return static_cast<int>(b < max_blocks ? b : max_blocks);
}
