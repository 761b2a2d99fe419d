// K3 sorted_intersect_mask: mask[i] = keys[i] in cands, both sorted.
//
// Replaces the TPU kernel repro/kernels/columnar_ops.py:_intersect_kernel
// (host wrapper _intersect_pallas), whose rolled loop compares every key
// block against each of the m candidates in f32: O(n * m) compares and
// exact only below 2**24.  Here each thread takes one key and runs a
// lower-bound binary search over the sorted candidates in the promoted
// dtype (int64 or float64), as the exact x64 searchsorted does
// (_intersect_core): O(n log m).  With an exclusive cumsum the bitmap is
// the LSM merge rank (sorted_merge_take).
//
// Bound: memory for the streamed keys (8n bytes in, n out); the binary
// search's dependent loads hit the candidate array, whose top levels stay
// in L1/L2 across the threads of a block.  Design: one thread per key,
// grid-stride; lanes at or past n (pow2 padding) are written false.
#include "common.cuh"

template <typename T>
__global__ void intersect_kernel(const T* keys, int64_t n, const T* cands,
                                 int64_t m, uint8_t* out, int64_t n_out) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       i < n_out; i += stride) {
    if (i >= n) { out[i] = 0; continue; }
    const T k = keys[i];
    int64_t lo = 0, hi = m;
    while (lo < hi) {
      const int64_t mid = lo + ((hi - lo) >> 1);
      if (cands[mid] < k) lo = mid + 1; else hi = mid;
    }
    out[i] = static_cast<uint8_t>(lo < m && cands[lo] == k);
  }
}

// keys: n real keys (n_out >= n output lanes), cands: m sorted candidates,
// both int64 (is_f64 == 0) or float64 (is_f64 == 1) on the device.
extern "C" int rt_sorted_intersect(const void* keys, int64_t n,
                                   const void* cands, int64_t m, int is_f64,
                                   uint8_t* out, int64_t n_out,
                                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int threads = 256;
  const int blocks = grid_for(n_out, threads, 132 * 16);
  if (is_f64)
    intersect_kernel<double><<<blocks, threads, 0, s>>>(
        static_cast<const double*>(keys), n,
        static_cast<const double*>(cands), m, out, n_out);
  else
    intersect_kernel<int64_t><<<blocks, threads, 0, s>>>(
        static_cast<const int64_t*>(keys), n,
        static_cast<const int64_t*>(cands), m, out, n_out);
  return static_cast<int>(cudaGetLastError());
}
