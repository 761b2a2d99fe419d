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

// ---------------------------------------------------------------------------
// K7 backward: given x [N, d], w [d] and the output's gradient g [N, d],
//   dx = rstd (w g - xh mean(w g xh)),  xh = x rstd,
//   dw = sum over rows of g xh,
// rstd recomputed per row.  No TPU kernel of its own: the reference
// differentiates its rmsnorm (repro/models/layers.py:rms_norm, :164) with
// XLA's autodiff of the plain formula, and has no pallas_call for it.
//
// Bound: memory.  x and g read once, dx written once (w, dw and the
// partials are small): 403 MB at [4096, 8192] float32, 0.12 ms at
// 3.35 TB/s.
//
// rmsnorm_bwd_vec_kernel (rows 16-byte aligned, d a multiple of the vector
// width, at most 256 x 32 / VW vectors a row: d <= 8192): P blocks of 256
// threads (P = min(N, 264), two an SM), block p taking rows p, p + P, ...
// in order, w staged once in shared memory as float32.  Thread t owns
// vectors t, t + 256, ... of every row: it loads its x and g vectors with
// 16-byte loads, all in flight before any is used, keeps them in registers
// while the block folds sum(x^2) and sum(w g x) in a fixed order (a warp
// butterfly, then the 8 warp sums in order; one barrier a row, the warp
// sums double-buffered by row parity), then writes dx from the same
// registers and adds g xh to its dw partials, which stay in registers
// because the thread owns the same columns on every row.  So x and g are
// read once from device memory, and 32 KB of shared memory a block leaves
// room for two blocks an SM with all their vectors in flight.  The first
// design read each row twice with scalar loads and kept a block's dw row
// in shared memory (up to 192 KB: one block an SM); it stays as the route
// for rows the vector kernel cannot take (rmsnorm_bwd_kernel).
//
// Each block's dw partials go to scratch [P, d]; rmsnorm_dw_kernel adds
// the P partials of a column in a fixed order (8 strided groups in order
// of p, then the 8 group sums in order).  Every sum's order depends only
// on (N, d), so the result is the same on every run; no atomics.
// ---------------------------------------------------------------------------
namespace {
constexpr int BWD_BLOCKS = 264;
constexpr int BWD_VEC_FLOATS = 32;       // x (and dw) floats a thread a row

// a and b folded over the block: a warp butterfly, then the NT / 32 warp
// sums in order.  Every thread gets the block's sums; warp_sums holds
// 2 NT / 32 floats, and is free once every thread has passed the next
// call's barrier.
__device__ __forceinline__ void block_sum2(float& a, float& b,
                                           float* warp_sums) {
  for (int off = 16; off > 0; off >>= 1) {
    a += __shfl_xor_sync(0xffffffffu, a, off);
    b += __shfl_xor_sync(0xffffffffu, b, off);
  }
  if ((threadIdx.x & 31) == 0) {
    warp_sums[threadIdx.x >> 5] = a;
    warp_sums[NT / 32 + (threadIdx.x >> 5)] = b;
  }
  __syncthreads();
  float ta = 0.f, tb = 0.f;
#pragma unroll
  for (int i = 0; i < NT / 32; ++i) {
    ta += warp_sums[i];
    tb += warp_sums[NT / 32 + i];
  }
  a = ta;
  b = tb;
}
}  // namespace

// MV: 16-byte vectors a thread a row (nv <= NT MV)
template <typename T, typename W, int MV>
__global__ void __launch_bounds__(NT, 2) rmsnorm_bwd_vec_kernel(
    const T* __restrict__ x, const W* __restrict__ w,
    const T* __restrict__ g, T* __restrict__ dx, float* __restrict__ part,
    int64_t N, int64_t d, float eps) {
  constexpr int VW = 16 / sizeof(T);
  extern __shared__ float4 w_s[];        // w as float32, d values
  __shared__ float warp_sums[2][2 * NT / 32];
  const int tid = threadIdx.x;
  const int nv = static_cast<int>(d / VW);
  float* wf = reinterpret_cast<float*>(w_s);
  for (int64_t j = tid; j < d; j += NT) wf[j] = ld(w, j);
  __syncthreads();
  float dwp[MV][VW];
#pragma unroll
  for (int p = 0; p < MV; ++p)
#pragma unroll
    for (int e = 0; e < VW; ++e) dwp[p][e] = 0.f;
  const float inv_d = 1.f / static_cast<float>(d);
  int parity = 0;
  for (int64_t row = blockIdx.x; row < N; row += gridDim.x, parity ^= 1) {
    const uint4* xr = reinterpret_cast<const uint4*>(x + row * d);
    const uint4* gr = reinterpret_cast<const uint4*>(g + row * d);
    uint4 xv[MV], gv[MV];
#pragma unroll
    for (int p = 0; p < MV; ++p) {
      const int vi = tid + p * NT;
      if (vi < nv) {
        xv[p] = xr[vi];
        gv[p] = gr[vi];
      }
    }
    float ss = 0.f, dot = 0.f;
#pragma unroll
    for (int p = 0; p < MV; ++p) {
      const int vi = tid + p * NT;
      if (vi < nv) {
        float xf[VW], gf[VW], wv[VW];
        unpack(xv[p], xf, T());
        unpack(gv[p], gf, T());
#pragma unroll
        for (int k = 0; k < VW / 4; ++k)
          unpack(reinterpret_cast<const uint4*>(w_s)[vi * (VW / 4) + k],
                 wv + 4 * k, 0.f);
#pragma unroll
        for (int e = 0; e < VW; ++e) {
          ss = fmaf(xf[e], xf[e], ss);
          dot = fmaf(wv[e] * gf[e], xf[e], dot);
        }
      }
    }
    block_sum2(ss, dot, warp_sums[parity]);
    const float r = 1.f / sqrtf(ss * inv_d + eps);
    const float c = dot * r * inv_d;     // mean(w g xh)
    uint4* dr = reinterpret_cast<uint4*>(dx + row * d);
#pragma unroll
    for (int p = 0; p < MV; ++p) {
      const int vi = tid + p * NT;
      if (vi < nv) {
        float xf[VW], gf[VW], wv[VW], f[VW];
        unpack(xv[p], xf, T());
        unpack(gv[p], gf, T());
#pragma unroll
        for (int k = 0; k < VW / 4; ++k)
          unpack(reinterpret_cast<const uint4*>(w_s)[vi * (VW / 4) + k],
                 wv + 4 * k, 0.f);
#pragma unroll
        for (int e = 0; e < VW; ++e) {
          const float xh = xf[e] * r;
          f[e] = r * (wv[e] * gf[e] - xh * c);
          dwp[p][e] = fmaf(gf[e], xh, dwp[p][e]);
        }
        dr[vi] = pack(f, T());
      }
    }
  }
  float* pr = part + static_cast<int64_t>(blockIdx.x) * d;
#pragma unroll
  for (int p = 0; p < MV; ++p) {
    const int vi = tid + p * NT;
    if (vi < nv) {
#pragma unroll
      for (int k = 0; k < VW / 4; ++k)
        reinterpret_cast<uint4*>(pr)[vi * (VW / 4) + k] =
            pack(dwp[p] + 4 * k, 0.f);
    }
  }
}

// The first design, for rows the vector kernel cannot take: a block's dw
// row (d floats) in shared memory, where thread t owns columns t, t + 256,
// ...; each row read twice with scalar loads (the second from L1/L2).
template <typename T, typename W>
__global__ void __launch_bounds__(NT) rmsnorm_bwd_kernel(
    const T* __restrict__ x, const W* __restrict__ w,
    const T* __restrict__ g, T* __restrict__ dx, float* __restrict__ part,
    int64_t N, int64_t d, float eps) {
  extern __shared__ float dw_row[];      // d floats
  __shared__ float warp_sums[2][2 * NT / 32];
  const int tid = threadIdx.x;
  for (int64_t j = tid; j < d; j += NT) dw_row[j] = 0.f;
  const float inv_d = 1.f / static_cast<float>(d);
  int parity = 0;
  for (int64_t row = blockIdx.x; row < N; row += gridDim.x, parity ^= 1) {
    const T* xr = x + row * d;
    const T* gr = g + row * d;
    float ss = 0.f, dot = 0.f;
    for (int64_t j = tid; j < d; j += NT) {
      const float xv = ld(xr, j);
      ss = fmaf(xv, xv, ss);
      dot = fmaf(ld(w, j) * ld(gr, j), xv, dot);
    }
    block_sum2(ss, dot, warp_sums[parity]);
    const float r = 1.f / sqrtf(ss * inv_d + eps);
    const float c = dot * r * inv_d;     // mean(w g xh)
    T* dr = dx + row * d;
    for (int64_t j = tid; j < d; j += NT) {
      const float xh = ld(xr, j) * r;
      const float gv = ld(gr, j);
      st(dr, j, r * (ld(w, j) * gv - xh * c));
      dw_row[j] = fmaf(gv, xh, dw_row[j]);
    }
  }
  float* pr = part + static_cast<int64_t>(blockIdx.x) * d;
  for (int64_t j = tid; j < d; j += NT) pr[j] = dw_row[j];
}

// dw[j] = sum over p < P of part[p, j]: a block takes 32 columns; warp q
// adds p = q, q + 8, ... in order, then warp 0 the 8 warp sums in order
template <typename W>
__global__ void __launch_bounds__(256) rmsnorm_dw_kernel(
    const float* __restrict__ part, W* __restrict__ dw, int P, int64_t d) {
  __shared__ float sums[8][32];
  const int lane = threadIdx.x & 31, q = threadIdx.x >> 5;
  const int64_t j = static_cast<int64_t>(blockIdx.x) * 32 + lane;
  float s = 0.f;
  if (j < d) {
#pragma unroll 4
    for (int p = q; p < P; p += 8) s += part[static_cast<int64_t>(p) * d + j];
  }
  sums[q][lane] = s;
  __syncthreads();
  if (q == 0 && j < d) {
    float t = 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) t += sums[i][lane];
    st(dw, j, t);
  }
}

extern "C" int rt_rmsnorm_bwd_blocks(int64_t N);

template <typename T, typename W, int MV>
static cudaError_t launch_bwd_vec(const void* x, const void* w,
                                  const void* g, void* dx, float* part,
                                  int P, int64_t N, int64_t d, float eps,
                                  cudaStream_t s) {
  rmsnorm_bwd_vec_kernel<T, W, MV><<<P, NT, d * sizeof(float), s>>>(
      static_cast<const T*>(x), static_cast<const W*>(w),
      static_cast<const T*>(g), static_cast<T*>(dx), part, N, d, eps);
  return cudaGetLastError();
}

template <typename T, typename W>
static int launch_bwd(const void* x, const void* w, const void* g, void* dx,
                      void* dw, float* part, int64_t N, int64_t d, float eps,
                      cudaStream_t s) {
  constexpr int VW = 16 / sizeof(T), MAXMV = BWD_VEC_FLOATS / VW;
  const int P = rt_rmsnorm_bwd_blocks(N);
  const bool aligned = reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(g) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(dx) % 16 == 0;
  const int64_t nv = d / VW;
  cudaError_t e = cudaSuccess;
  if (P > 0 && aligned && d % VW == 0 && nv <= NT * MAXMV) {
    if (nv <= NT)
      e = launch_bwd_vec<T, W, 1>(x, w, g, dx, part, P, N, d, eps, s);
    else if (nv <= 2 * NT)
      e = launch_bwd_vec<T, W, 2>(x, w, g, dx, part, P, N, d, eps, s);
    else if (nv <= 4 * NT || MAXMV == 4)
      e = launch_bwd_vec<T, W, 4>(x, w, g, dx, part, P, N, d, eps, s);
    else
      e = launch_bwd_vec<T, W, MAXMV>(x, w, g, dx, part, P, N, d, eps, s);
  } else if (P > 0) {
    static int cap = 48 * 1024;
    const int bytes = static_cast<int>(d * sizeof(float));
    e = allow_smem(rmsnorm_bwd_kernel<T, W>, bytes, &cap);
    if (e == cudaSuccess)
      rmsnorm_bwd_kernel<T, W><<<P, NT, bytes, s>>>(
          static_cast<const T*>(x), static_cast<const W*>(w),
          static_cast<const T*>(g), static_cast<T*>(dx), part, N, d, eps);
  }
  if (e != cudaSuccess) return static_cast<int>(e);
  const int blocks = static_cast<int>((d + 31) / 32);
  if (P > 0)
    rmsnorm_dw_kernel<W><<<blocks, 256, 0, s>>>(part, static_cast<W*>(dw), P,
                                                d);
  else
    cudaMemsetAsync(dw, 0, d * sizeof(W), s);
  return static_cast<int>(cudaGetLastError());
}

// The number of row blocks of K7's backward for N rows: the rows of the
// scratch `part` the caller allocates ([blocks, d] float32).
extern "C" int rt_rmsnorm_bwd_blocks(int64_t N) {
  return static_cast<int>(N < BWD_BLOCKS ? N : BWD_BLOCKS);
}

// x, g, dx: [N, d] contiguous of type xdt; w, dw: [d] of type wdt; part:
// float32 scratch of rt_rmsnorm_bwd_blocks(N) x d (16-byte aligned).  Rows
// 16-byte aligned with d a multiple of the vector width (4 float32, 8
// bfloat16) and d <= 8192 take the vector kernel, the rest the first
// design.
extern "C" int rt_rmsnorm_bwd(const void* x, int xdt, const void* w, int wdt,
                              const void* g, void* dx, void* dw, float* part,
                              int64_t N, int64_t d, float eps,
                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d < 1 || d > 48 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  if (xdt == MT_F32 && wdt == MT_F32)
    return launch_bwd<float, float>(x, w, g, dx, dw, part, N, d, eps, s);
  if (xdt == MT_F32 && wdt == MT_BF16)
    return launch_bwd<float, __nv_bfloat16>(x, w, g, dx, dw, part, N, d,
                                            eps, s);
  if (xdt == MT_BF16 && wdt == MT_F32)
    return launch_bwd<__nv_bfloat16, float>(x, w, g, dx, dw, part, N, d,
                                            eps, s);
  if (xdt == MT_BF16 && wdt == MT_BF16)
    return launch_bwd<__nv_bfloat16, __nv_bfloat16>(x, w, g, dx, dw, part,
                                                    N, d, eps, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
