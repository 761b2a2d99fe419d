// Shared helpers of the model-stack kernels (K7 rmsnorm, K8 flash
// attention, K9 LSM decode attention): element loads and stores in the
// operand's own type, always computing in float32.  The dtype codes are
// mirrored by _DTYPES in kernels/rmsnorm.py, flash_attention.py and
// lsm_decode_attention.py: change them together.
#pragma once
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

enum { MT_F32 = 0, MT_BF16 = 1 };

// the reference's NEG_INF (kernels/ref.py): a finite "minus infinity", so
// exp(NEG_INF - m) is 0 for any real m and never NaN
#define NEG_INF_F (-1e30f)

__device__ __forceinline__ float ld(const float* p, int64_t i) {
  return p[i];
}
__device__ __forceinline__ float ld(const __nv_bfloat16* p, int64_t i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ void st(float* p, int64_t i, float x) {
  p[i] = x;
}
// round to nearest even, as torch's .to(torch.bfloat16)
__device__ __forceinline__ void st(__nv_bfloat16* p, int64_t i, float x) {
  p[i] = __float2bfloat16_rn(x);
}

// 16-byte vectors (uint4) of 4 float32 or 8 bfloat16 values, unpacked to
// and packed from float32; the last argument only selects the type.  A
// bfloat16 is the high half of a float32, so no conversion is rounded on
// the way in; packing rounds to nearest even.
__device__ __forceinline__ void unpack(const uint4& r, float* f, float) {
  f[0] = __uint_as_float(r.x);
  f[1] = __uint_as_float(r.y);
  f[2] = __uint_as_float(r.z);
  f[3] = __uint_as_float(r.w);
}
__device__ __forceinline__ void unpack(const uint4& r, float* f,
                                       __nv_bfloat16) {
  const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}
__device__ __forceinline__ uint4 pack(const float* f, float) {
  return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                    __float_as_uint(f[2]), __float_as_uint(f[3]));
}
__device__ __forceinline__ uint4 pack(const float* f, __nv_bfloat16) {
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
    w[i] = *reinterpret_cast<const uint32_t*>(&h);
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// Raise a kernel's dynamic shared-memory cap when a launch needs more
// than the cap already set (*cap starts at the default 48 KB).
template <typename K>
static inline cudaError_t allow_smem(K kernel, int bytes, int* cap) {
  if (bytes <= *cap) return cudaSuccess;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e == cudaSuccess) *cap = bytes;
  return e;
}
