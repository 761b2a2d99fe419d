// The card's rate for the warp-level tensor-core MMAs K8 uses:
// mma.sync m16n8k8 .tf32 and m16n8k16 .bf16, 8 independent accumulators a
// warp, 8 warps a block, 1, 2 and 4 blocks an SM.  Prints TFLOP/s.
// Build and run with scripts/probes/run.sh.
#include <cuda_runtime.h>
#include <stdint.h>

#include <cstdio>

template <int KIND>
__global__ void __launch_bounds__(256) bench(float* out, int iters) {
  float d[8][4] = {};
  const uint32_t a[4] = {threadIdx.x, threadIdx.x * 3u, 7u, 9u};
  const uint32_t b0 = 5u, b1 = 11u;
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (KIND == 0)
        asm volatile(
            "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
            "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
            : "+f"(d[j][0]), "+f"(d[j][1]), "+f"(d[j][2]), "+f"(d[j][3])
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
      else
        asm volatile(
            "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
            "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
            : "+f"(d[j][0]), "+f"(d[j][1]), "+f"(d[j][2]), "+f"(d[j][3])
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
    }
  }
  float s = 0.f;
  for (int j = 0; j < 8; ++j)
    for (int i = 0; i < 4; ++i) s += d[j][i];
  out[blockIdx.x * 256 + threadIdx.x] = s;
}

int main() {
  int sms = 0;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, 0);
  float* out;
  cudaMalloc(&out, sizeof(float) * sms * 4 * 256);
  cudaEvent_t e0, e1;
  cudaEventCreate(&e0);
  cudaEventCreate(&e1);
  const int iters = 4096;
  for (int kind = 0; kind < 2; ++kind)
    for (int bps = 1; bps <= 4; bps *= 2) {
      const int blocks = sms * bps;
      float ms = 0.f;
      for (int rep = 0; rep < 2; ++rep) {      // the first run warms up
        cudaEventRecord(e0);
        if (kind == 0) bench<0><<<blocks, 256>>>(out, iters);
        else bench<1><<<blocks, 256>>>(out, iters);
        cudaEventRecord(e1);
        cudaEventSynchronize(e1);
        cudaEventElapsedTime(&ms, e0, e1);
      }
      const double flops = 2.0 * 16 * 8 * (kind == 0 ? 8 : 16) * 8.0 *
                           iters * blocks * 8;
      printf("mma_rate %s blocks/SM %d: %.3f ms, %.1f TFLOP/s\n",
             kind == 0 ? "tf32 m16n8k8" : "bf16 m16n8k16", bps, ms,
             flops / ms / 1e9);
    }
  const cudaError_t e = cudaGetLastError();
  printf("mma_rate: %s\n", cudaGetErrorString(e));
  return e == cudaSuccess ? 0 : 1;
}
