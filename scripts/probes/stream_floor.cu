// The floor of a kernel that must move K1's bytes: a stream that reads
// n_in 16-byte words, neighbouring threads on neighbouring words and
// eight loads a thread in flight, folds them with XOR and writes n_out
// 16-byte words, with no other work.  Built and timed by
// scripts/probes/k1_a7_floor.py beside K1 on the same byte counts.
#include <cuda_runtime.h>
#include <stdint.h>

__global__ void stream_kernel(const uint4* in, int64_t n_in, uint4* out,
                              int64_t n_out) {
  const int64_t nt = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  uint4 acc = make_uint4(0u, 0u, 0u, 0u);
  for (int64_t i0 = tid; i0 < n_in; i0 += 8 * nt) {
    uint4 v[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int64_t i = i0 + u * nt;
      v[u] = i < n_in ? __ldg(in + i) : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      acc.x ^= v[u].x;
      acc.y ^= v[u].y;
      acc.z ^= v[u].z;
      acc.w ^= v[u].w;
    }
  }
  for (int64_t i = tid; i < n_out; i += nt) out[i] = acc;
}

extern "C" int rt_stream(const void* in, int64_t n_in, void* out,
                         int64_t n_out, int blocks, int threads,
                         void* stream) {
  stream_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(in), n_in, static_cast<uint4*>(out), n_out);
  return static_cast<int>(cudaGetLastError());
}
