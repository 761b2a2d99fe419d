// Float32 products on Hopper's tensor cores at float32 accuracy, shared by
// K8's forward (flash_attention.cu) and backward (flash_attention_bwd.cu):
// 3xTF32 splits, warpgroup MMAs (wgmma .tf32) with operands in 128-byte
// swizzled shared-memory rows, and the TMA tensor maps that fill them.
//
// 3xTF32: x = hi + lo with hi = rna_tf32(x) and lo = rna_tf32(x - hi);
// a.b ~ lo.hi + hi.lo + hi.hi accumulated in float32, small terms first
// (1xTF32 keeps ~3 digits).  wgmma .tf32 takes only K-major operands from
// shared memory (the transpose flags exist for 16-bit types only), so an
// operand whose contraction runs along rows is laid out transposed by the
// kernel that splits it.
//
// Operand layout: column blocks of 32 float32 per row (128 bytes), rows 128
// bytes apart, 16-byte chunk c of row r at c ^ (r % 8) (the TMA's
// SWIZZLE_128B), 8-row atoms 1024 bytes apart; k-step kk (8 values, 32
// bytes) of a K-major operand starts at block kk / 4, byte 32 (kk % 4).
#pragma once
#include "model_common.cuh"

namespace {
constexpr int SPAN = 128;           // bytes of a swizzled row (SWIZZLE_128B)

// byte offset of 16-byte chunk c of row r in a swizzled column block
__device__ __forceinline__ int swz(int r, int c) {
  return r * SPAN + ((c ^ (r & 7)) << 4);
}

// cvt.rna.tf32.f32 (round to nearest, ties away from zero, to 10 mantissa
// bits) as two integer operations: add half a TF32 ulp to the magnitude's
// bits and clear the 13 low ones.  Bit for bit the same as the cvt on
// every non-NaN float (scripts/probes/tf32_round.cu), and faster: the cvt
// issues at a lower rate (PERF.md).
__device__ __forceinline__ uint32_t tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32(x);
  lo = tf32(x - __uint_as_float(hi));
}
// 4 float32 split into TF32 hi and lo
__device__ __forceinline__ void split4(const uint4& x, uint4& hi, uint4& lo) {
  split(__uint_as_float(x.x), hi.x, lo.x);
  split(__uint_as_float(x.y), hi.y, lo.y);
  split(__uint_as_float(x.z), hi.z, lo.z);
  split(__uint_as_float(x.w), hi.w, lo.w);
}

// wgmma descriptor of a K-major operand in 128-byte swizzled rows, 8-row
// atoms 1024 bytes apart (the TMA's SWIZZLE_128B layout)
__device__ __forceinline__ uint64_t sw128(const unsigned char* p) {
  return static_cast<uint64_t>((smem_u32(p) & 0x3FFFFu) >> 4) |
         (1ull << 16) | (64ull << 32) | (1ull << 62);
}
__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// shared-memory stores made visible to the wgmma (async proxy) reads
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// keep a register (an in-flight wgmma operand) where it is until here
__device__ __forceinline__ void pin(float& x) {
  asm volatile("" : "+f"(x) :: "memory");
}
__device__ __forceinline__ void pin(uint32_t& x) {
  asm volatile("" : "+r"(x) :: "memory");
}

// d (+)= A B: m64n32k8 .tf32, A and B in shared memory (descriptors);
// accumulate 0 overwrites d
__device__ __forceinline__ void wgmma_ss_n32(float* d, uint64_t da, uint64_t db,
                                             int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, %16, %17, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(accumulate));
}
// d += A B: m64n8k8 .tf32, A in registers (4 a thread), B in shared memory
__device__ __forceinline__ void wgmma_rs_n8(float* d, const uint32_t* a,
                                            uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, %8, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
// d += A B: m64n16k8 .tf32, A in registers (4 a thread), B in shared
// memory
__device__ __forceinline__ void wgmma_rs_n16(float* d, const uint32_t* a,
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
// d += A B: m64n32k8 .tf32, A in registers (4 a thread), B in shared
// memory
__device__ __forceinline__ void wgmma_rs_n32(float* d, const uint32_t* a,
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
// d += A B: m64n64k8 .tf32, A in registers (4 a thread), B in shared
// memory
__device__ __forceinline__ void wgmma_rs_n64(float* d, const uint32_t* a,
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
// d += A B: m64n128k8 .tf32, A in registers (4 a thread), B in shared
// memory
__device__ __forceinline__ void wgmma_rs_n128(float* d, const uint32_t* a,
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int N>
__device__ __forceinline__ void wgmma_rs(float* d, const uint32_t* a,
                                         uint64_t db) {
  if constexpr (N == 8) wgmma_rs_n8(d, a, db);
  else if constexpr (N == 16) wgmma_rs_n16(d, a, db);
  else if constexpr (N == 32) wgmma_rs_n32(d, a, db);
  else if constexpr (N == 64) wgmma_rs_n64(d, a, db);
  else wgmma_rs_n128(d, a, db);
}

// One TMA load of a 5-d box at coordinates (c0..c4, innermost first),
// completing its bytes on the mbarrier.
__device__ __forceinline__ void tma_load_5d(void* dst, const CUtensorMap* map,
                                            int c0, int c1, int c2, int c3,
                                            int c4, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.5d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5, %6}], [%7];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(c4), "r"(smem_u32(bar))
      : "memory");
}

// Tensor map of a [B, S, NH, hd] view (element strides st = {batch, row,
// head}, unit along hd) with rows [0, n): dims hd, then row, head and
// batch ordered by stride (extent-1 dims last, packed), boxes of one 128-
// byte column block of `rows` rows, 128-byte swizzle; rows at or past n
// are zero-filled.  *perm names the coordinate each of map dims 1..3 takes
// (0 row, 1 head, 2 batch), two bits each.  whole: a fifth dim, hd's
// 128-byte column blocks, so that one load (tma_load_5d, coordinates
// 0, ..., 0) brings all of them, block after block: `rows` rows of one,
// then of the next, as separate loads of each block would lay them out.
cudaError_t kv_map(const void* ptr, int dt, int hd, int n, int NH, int B,
                   const int64_t* st, int rows, CUtensorMap* out, int* perm,
                   bool whole = false) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorSymbolNotFound;
  const int64_t esz = dt == MT_F32 ? 4 : 2;
  struct Dim {
    int64_t ext, stride;
    int id;
  } d[3] = {{n, st[1] * esz, 0}, {NH, st[2] * esz, 1}, {B, st[0] * esz, 2}};
  for (int i = 0; i < 3; ++i)            // insertion sort, 3 entries
    for (int k = i; k > 0; --k) {
      const Dim& a = d[k - 1];
      const Dim& c = d[k];
      const bool swap = (a.ext == 1) != (c.ext == 1)
          ? a.ext == 1 : a.ext != 1 && c.stride < a.stride;
      if (!swap) break;
      const Dim tmp = d[k - 1];
      d[k - 1] = d[k];
      d[k] = tmp;
    }
  for (int i = 0; i < 3; ++i) {
    if (d[i].ext == 1)
      d[i].stride = i == 0 ? (hd * esz + 15) / 16 * 16
                           : d[i - 1].stride * d[i - 1].ext;
    if (d[i].stride % 16 != 0 || d[i].stride <= 0)
      return cudaErrorInvalidValue;
  }
  const int64_t span = SPAN / esz;                 // elements a block row
  const int64_t nb = (hd + span - 1) / span;
  if (whole && hd > span && hd % span != 0) return cudaErrorInvalidValue;
  const cuuint64_t dims[5] = {static_cast<cuuint64_t>(whole && hd > span
                                                          ? span : hd),
                              static_cast<cuuint64_t>(d[0].ext),
                              static_cast<cuuint64_t>(d[1].ext),
                              static_cast<cuuint64_t>(d[2].ext),
                              static_cast<cuuint64_t>(nb)};
  const cuuint64_t strides[4] = {static_cast<cuuint64_t>(d[0].stride),
                                 static_cast<cuuint64_t>(d[1].stride),
                                 static_cast<cuuint64_t>(d[2].stride),
                                 static_cast<cuuint64_t>(SPAN)};
  const cuuint32_t box[5] = {static_cast<cuuint32_t>(span),
                             d[0].id == 0 ? rows : 1u,
                             d[1].id == 0 ? rows : 1u,
                             d[2].id == 0 ? rows : 1u,
                             static_cast<cuuint32_t>(nb)};
  const cuuint32_t unit[5] = {1, 1, 1, 1, 1};
  const CUresult r = encode(
      out, dt == MT_F32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                        : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
      whole ? 5 : 4, const_cast<void*>(ptr), dims, strides, box, unit,
      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) return cudaErrorInvalidValue;
  *perm = d[0].id | (d[1].id << 2) | (d[2].id << 4);
  return cudaSuccess;
}
}  // namespace
