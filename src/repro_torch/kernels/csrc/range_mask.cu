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
// a handful of compares.  Design: one thread per row, grid-stride, so
// neighbouring threads read neighbouring addresses of every column
// (coalesced); the descriptor table rides in the kernel's parameter bank,
// so no operand is staged through shared memory and nothing is allocated.
#include "common.cuh"

__global__ void range_mask_kernel(ColTable t, int64_t n, uint8_t* out,
                                  int accumulate) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       i < n; i += stride) {
    const bool m = row_ok(t, i);
    out[i] = accumulate ? static_cast<uint8_t>(out[i] && m)
                        : static_cast<uint8_t>(m);
  }
}

// cols: host array of k descriptors; out: bool[n] on the device.  More
// than MAX_COLS predicates run as several passes ANDed into out.
extern "C" int rt_range_mask(const ColDesc* cols, int k, int64_t n,
                             uint8_t* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int threads = 256;
  const int blocks = grid_for(n, threads, 132 * 16);
  for (int g = 0; g < k; g += MAX_COLS) {
    ColTable t;
    t.n = k - g < MAX_COLS ? k - g : MAX_COLS;
    for (int j = 0; j < t.n; ++j) t.c[j] = cols[g + j];
    range_mask_kernel<<<blocks, threads, 0, s>>>(t, n, out, g > 0);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* rt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
