// K7 rmsnorm: out[r] = x[r] * rsqrt(mean(x[r]^2) + eps) * w, row by row,
// accumulated in float32, written in x's type (float32 or bfloat16; w may
// be either).
//
// Replaces the TPU kernel repro/kernels/rmsnorm.py:_kernel (host wrapper
// rmsnorm), which normalizes a [block_rows, d] VMEM tile per grid step.
// On the H100 one block of 256 threads takes one row at a time
// (grid-stride over rows, so any N works and nothing is padded).  Each
// thread loads its share of the row as 16-byte vectors, all issued before
// any is used, keeps them in registers (up to 8 vectors: d <= 8192 in
// float32, 16384 in bfloat16) and sums their squares; the block folds the
// 256 partials in a fixed order (a warp butterfly, then the 8 warp sums in
// order); the same registers are then scaled and stored, so x is read
// once.  A row that does not fit the registers, or a d that is not a
// multiple of the vector width, takes the scalar kernel below (two passes,
// the second from L1/L2).  Fold orders depend only on d, so a row's result
// is the same on every run.
//
// Bound: memory.  One read of x, one write of out and one read of w per
// launch; 3 flops an element.  With only N = 8 rows (a decode step) 8
// blocks run and the launch is latency-bound.
#include "model_common.cuh"

namespace {
constexpr int NT = 256, MAXV = 8;

__device__ __forceinline__ float block_sum(float ss, float* warp_sums) {
  for (int off = 16; off > 0; off >>= 1)
    ss += __shfl_xor_sync(0xffffffffu, ss, off);
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = ss;
  __syncthreads();
  float t = 0.f;
#pragma unroll
  for (int i = 0; i < NT / 32; ++i) t += warp_sums[i];
  __syncthreads();                       // warp_sums is reused next row
  return t;
}
}  // namespace

template <typename T, typename W>
__global__ void __launch_bounds__(NT) rmsnorm_vec_kernel(
    const T* __restrict__ x, const W* __restrict__ w, T* __restrict__ out,
    int64_t N, int64_t d, float eps) {
  constexpr int VW = 16 / sizeof(T);
  __shared__ float warp_sums[NT / 32];
  const int tid = threadIdx.x;
  const int nv = static_cast<int>(d / VW);
  for (int64_t row = blockIdx.x; row < N; row += gridDim.x) {
    const uint4* xr = reinterpret_cast<const uint4*>(x + row * d);
    uint4 r[MAXV];
#pragma unroll
    for (int p = 0; p < MAXV; ++p) {
      const int vi = tid + p * NT;
      if (vi < nv) r[p] = xr[vi];
    }
    float ss = 0.f;
#pragma unroll
    for (int p = 0; p < MAXV; ++p) {
      if (tid + p * NT < nv) {
        float f[VW];
        unpack(r[p], f, T());
#pragma unroll
        for (int j = 0; j < VW; ++j) ss = fmaf(f[j], f[j], ss);
      }
    }
    const float inv =
        1.f / sqrtf(block_sum(ss, warp_sums) / static_cast<float>(d) + eps);
    uint4* orow = reinterpret_cast<uint4*>(out + row * d);
#pragma unroll
    for (int p = 0; p < MAXV; ++p) {
      const int vi = tid + p * NT;
      if (vi < nv) {
        float f[VW];
        unpack(r[p], f, T());
#pragma unroll
        for (int j = 0; j < VW; ++j) f[j] = f[j] * inv * ld(w, vi * VW + j);
        orow[vi] = pack(f, T());
      }
    }
  }
}

template <typename T, typename W>
__global__ void __launch_bounds__(NT) rmsnorm_kernel(
    const T* __restrict__ x, const W* __restrict__ w, T* __restrict__ out,
    int64_t N, int64_t d, float eps) {
  __shared__ float warp_sums[NT / 32];
  const int tid = threadIdx.x;
  for (int64_t row = blockIdx.x; row < N; row += gridDim.x) {
    const T* xr = x + row * d;
    float ss = 0.f;
    for (int64_t j = tid; j < d; j += NT) {
      const float v = ld(xr, j);
      ss = fmaf(v, v, ss);
    }
    const float inv =
        1.f / sqrtf(block_sum(ss, warp_sums) / static_cast<float>(d) + eps);
    T* orow = out + row * d;
    for (int64_t j = tid; j < d; j += NT)
      st(orow, j, ld(xr, j) * inv * ld(w, j));
  }
}

template <typename T, typename W>
static int launch(const void* x, const void* w, void* out, int64_t N,
                  int64_t d, float eps, cudaStream_t s) {
  constexpr int VW = 16 / sizeof(T);
  const int grid = static_cast<int>(N < 132 * 16 ? N : 132 * 16);
  const bool vec = d % VW == 0 && d / VW <= NT * MAXV &&
                   reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  if (grid > 0 && vec)
    rmsnorm_vec_kernel<T, W><<<grid, NT, 0, s>>>(
        static_cast<const T*>(x), static_cast<const W*>(w),
        static_cast<T*>(out), N, d, eps);
  else if (grid > 0)
    rmsnorm_kernel<T, W><<<grid, NT, 0, s>>>(
        static_cast<const T*>(x), static_cast<const W*>(w),
        static_cast<T*>(out), N, d, eps);
  return static_cast<int>(cudaGetLastError());
}

// x, out: [N, d] contiguous of type xdt; w: [d] of type wdt.
extern "C" int rt_rmsnorm(const void* x, int xdt, const void* w, int wdt,
                          void* out, int64_t N, int64_t d, float eps,
                          void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (xdt == MT_F32 && wdt == MT_F32)
    return launch<float, float>(x, w, out, N, d, eps, s);
  if (xdt == MT_F32 && wdt == MT_BF16)
    return launch<float, __nv_bfloat16>(x, w, out, N, d, eps, s);
  if (xdt == MT_BF16 && wdt == MT_F32)
    return launch<__nv_bfloat16, float>(x, w, out, N, d, eps, s);
  if (xdt == MT_BF16 && wdt == MT_BF16)
    return launch<__nv_bfloat16, __nv_bfloat16>(x, w, out, N, d, eps, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
