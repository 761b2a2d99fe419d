// K7 rmsnorm: out[r] = x[r] * rsqrt(mean(x[r]^2) + eps) * w, row by row,
// accumulated in float32, written in x's type (float32 or bfloat16; w may
// be either).
//
// Replaces the TPU kernel repro/kernels/rmsnorm.py:_kernel (host wrapper
// rmsnorm), which normalizes a [block_rows, d] VMEM tile per grid step.
// Two designs on the H100, chosen by the wrapper (rmsnorm.py:cluster_size):
//
// * Many rows (N > 66 = 132 SMs / 2, the prefill's [4096, 8192]): one
//   block of 256 threads takes one row at a time (grid-stride over rows,
//   so any N works and nothing is padded).  Each thread loads its share of
//   the row as 16-byte vectors, all issued before any is used, keeps them
//   in registers (up to 8 vectors: d <= 8192 in float32, 16384 in
//   bfloat16) and sums their squares; the block folds the 256 partials in
//   a fixed order (a warp butterfly, then the 8 warp sums in order); the
//   same registers are then scaled and stored, so x is read once.  A row
//   that does not fit the registers, or a d that is not a multiple of the
//   vector width, takes the scalar kernel (two passes, the second from
//   L1/L2).
// * Few rows (N <= 66, a decode step's [8, 8192]): one thread-block
//   CLUSTER of C CTAs per row, C = 8 (portable) where the row's 16-byte
//   vectors split evenly into 8 slices, else 4 or 2; a row that splits
//   into none of them takes the designs above.  Rank r loads slice r of
//   the row (d / C values: 1,024 float32 at d = 8192, one vector a thread)
//   and the same slice of w into registers, all loads in flight at once,
//   folds its sum of squares as above, and pushes it into slot r of every
//   rank's shared memory through distributed shared memory (DSMEM), once
//   a cluster barrier arrived at on entry shows every rank has started;
//   after a second cluster barrier each rank adds the C slots in rank
//   order, so every rank computes the same inverse norm, then scales and
//   stores its slice.  No rank reads another's memory, so none waits at
//   the end.  64 CTAs on 64 SMs instead of 8.
//
// Fold orders depend only on (d, C), so a row's result is the same on
// every run.
//
// Bound: memory.  One read of x, one write of out and one read of w per
// launch; 3 flops an element: 80.1 us at [4096, 8192] float32, 0.166 us at
// [8, 8192], where a launch and one trip to memory cost more than the
// bound (PERF.md).  Clusters of 16 (non-portable) and blocks of 64 or 128
// threads were no faster at [8, 8192], so C stays at 8 and blocks at 256.
#include <cooperative_groups.h>

#include "model_common.cuh"

namespace cg = cooperative_groups;

namespace {
constexpr int NT = 256, MAXV = 8, MAX_CLUSTER = 8;

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

// One row per cluster of C CTAs; rank r normalizes the row's slice r of
// d / C values (nv 16-byte vectors, at most NT * MV).
template <typename T, typename W, int MV>
__global__ void __launch_bounds__(NT) rmsnorm_cluster_kernel(
    const T* __restrict__ x, const W* __restrict__ w, T* __restrict__ out,
    int64_t d, int C, float eps) {
  constexpr int VW = 16 / sizeof(T);
  __shared__ float warp_sums[NT / 32];
  __shared__ float parts[MAX_CLUSTER];   // rank r's partial in parts[r]
  cluster_arrive_relaxed();              // this CTA has started
  const int tid = threadIdx.x;
  const int64_t row = blockIdx.x / C;
  const int rank = blockIdx.x % C;
  const int nv = static_cast<int>(d / VW / C);
  const int64_t v0 = static_cast<int64_t>(rank) * nv;
  const uint4* xr = reinterpret_cast<const uint4*>(x + row * d) + v0;
  // the slice of x and of w, all loads in flight before any is used
  uint4 r[MV];
  float wv[MV][VW];
#pragma unroll
  for (int p = 0; p < MV; ++p) {
    const int vi = tid + p * NT;
    if (vi < nv) {
      r[p] = xr[vi];
#pragma unroll
      for (int j = 0; j < VW; ++j) wv[p][j] = ld(w, (v0 + vi) * VW + j);
    }
  }
  float ss = 0.f;
#pragma unroll
  for (int p = 0; p < MV; ++p) {
    if (tid + p * NT < nv) {
      float f[VW];
      unpack(r[p], f, T());
#pragma unroll
      for (int j = 0; j < VW; ++j) ss = fmaf(f[j], f[j], ss);
    }
  }
  const float t = block_sum(ss, warp_sums);
  // every rank has started, so its `parts` may be written: push this
  // rank's partial into every rank's shared memory through DSMEM
  cluster_wait();
  if (tid < C)
    *cg::this_cluster().map_shared_rank(&parts[rank], tid) = t;
  cluster_arrive();                      // release the pushes ...
  cluster_wait();                        // ... and see every rank's
  float total = 0.f;
  for (int i = 0; i < C; ++i) total += parts[i];   // in rank order
  const float inv = 1.f / sqrtf(total / static_cast<float>(d) + eps);
  uint4* orow = reinterpret_cast<uint4*>(out + row * d) + v0;
#pragma unroll
  for (int p = 0; p < MV; ++p) {
    const int vi = tid + p * NT;
    if (vi < nv) {
      float f[VW];
      unpack(r[p], f, T());
#pragma unroll
      for (int j = 0; j < VW; ++j) f[j] = f[j] * inv * wv[p][j];
      orow[vi] = pack(f, T());
    }
  }
}

template <typename T, typename W>
static int launch(const void* x, const void* w, void* out, int64_t N,
                  int64_t d, float eps, int C, cudaStream_t s) {
  constexpr int VW = 16 / sizeof(T);
  const bool aligned = reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(out) % 16 == 0;
  if (C > 1) {
    // the wrapper's cluster_size chose C; a C the row does not split into
    // is refused, not replaced
    if (!aligned || C > MAX_CLUSTER || d % (VW * C) != 0 ||
        d / VW / C > NT * MAXV)
      return static_cast<int>(cudaErrorInvalidValue);
    if (N > 0) {
      auto kernel = d / VW / C <= NT ? rmsnorm_cluster_kernel<T, W, 1>
                                     : rmsnorm_cluster_kernel<T, W, MAXV>;
      cudaError_t e = launch_clusters(
          kernel, static_cast<int>(N * C), NT, 0, C, s,
          static_cast<const T*>(x), static_cast<const W*>(w),
          static_cast<T*>(out), d, C, eps);
      if (e != cudaSuccess) return static_cast<int>(e);
    }
    return static_cast<int>(cudaGetLastError());
  }
  const int grid = static_cast<int>(N < 132 * 16 ? N : 132 * 16);
  const bool vec = d % VW == 0 && d / VW <= NT * MAXV && aligned;
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

// x, out: [N, d] contiguous of type xdt; w: [d] of type wdt.  C > 1: one
// cluster of C CTAs a row; C = 1: the one-row-per-block kernels.
extern "C" int rt_rmsnorm(const void* x, int xdt, const void* w, int wdt,
                          void* out, int64_t N, int64_t d, float eps, int C,
                          void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (C < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (xdt == MT_F32 && wdt == MT_F32)
    return launch<float, float>(x, w, out, N, d, eps, C, s);
  if (xdt == MT_F32 && wdt == MT_BF16)
    return launch<float, __nv_bfloat16>(x, w, out, N, d, eps, C, s);
  if (xdt == MT_BF16 && wdt == MT_F32)
    return launch<__nv_bfloat16, float>(x, w, out, N, d, eps, C, s);
  if (xdt == MT_BF16 && wdt == MT_BF16)
    return launch<__nv_bfloat16, __nv_bfloat16>(x, w, out, N, d, eps, C, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
