// Checks that K8's integer rounding to TF32 ((bits + 0x1000) & 0xffffe000,
// csrc/flash_attention.cu:tf32) equals cvt.rna.tf32.f32 on every float
// bit pattern but NaNs.  Prints the number of mismatches; exits 1 on any.
// Build and run with scripts/probes/run.sh.
#include <cuda_runtime.h>
#include <stdint.h>

#include <cstdio>

__global__ void compare(unsigned long long* bad) {
  const uint64_t stride = uint64_t(gridDim.x) * blockDim.x;
  unsigned long long n = 0;
  for (uint64_t i = blockIdx.x * uint64_t(blockDim.x) + threadIdx.x;
       i < (1ull << 32); i += stride) {
    const uint32_t u = uint32_t(i);
    uint32_t r;
    asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(__uint_as_float(u)));
    const bool nan = (u & 0x7f800000u) == 0x7f800000u && (u & 0x7fffffu);
    n += !nan && r != ((u + 0x1000u) & 0xffffe000u);
  }
  atomicAdd(bad, n);
}

int main() {
  unsigned long long* d;
  unsigned long long h = 0;
  cudaMalloc(&d, sizeof h);
  cudaMemcpy(d, &h, sizeof h, cudaMemcpyHostToDevice);
  compare<<<132 * 8, 256>>>(d);
  cudaMemcpy(&h, d, sizeof h, cudaMemcpyDeviceToHost);
  const cudaError_t e = cudaGetLastError();
  printf("tf32_round: %llu mismatches against cvt.rna.tf32 over 2^32 "
         "patterns (%s)\n", h, cudaGetErrorString(e));
  return h == 0 && e == cudaSuccess ? 0 : 1;
}
