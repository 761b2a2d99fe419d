// The partition runtime's collectives on one card: the hash exchange and
// the partial-aggregate merges of repro/runtime/spmd.py.
//
// Exchange (replaces spmd.py:_exchange_fn, an all_to_all per column plane
// through runtime/collectives.partition_by): source partition i's rows
// bound for partition j sit in block (i, j) of a [p, p, cap] send plane;
// the all-to-all delivers them as block (j, i) of the receive plane.  The
// partitions here are lanes of one card, so the all-to-all is a swap of
// the planes' first two axes, recv[j, i, :] = send[i, j, :], done for every
// plane (each column's data and validity, of any element size) in one
// launch: the host packs the planes into one buffer, a block takes one
// (plane, i, j) block and copies its cap * elem bytes, as 16-byte vectors
// where the block's bytes allow it.  Bound: memory, each byte read and
// written once.
//
// Merges (replace spmd.py:_merge_fn, a local reduce then psum / pmin /
// pmax over the mesh): a [R, M] array of per-partition partials, R padded
// to the lanes with the operation's identity, reduces over its rows to
// [M].  A thread takes a column and folds its rows left to right from row
// 0, which is numpy's order for a reduction over axis 0 (the reference's
// test holds the merge to np.sum / np.min / np.max); float min / max
// propagate NaN.  Bound: memory.
#include <cuda_runtime.h>
#include <stdint.h>

#define X_THREADS 256
#define M_THREADS 256

// meta: int64[n_planes, 3] (byte offset of the plane, bytes of a block,
// bytes of the alignment gap after the plane, which block 0 zeroes)
__global__ void __launch_bounds__(X_THREADS)
exchange_kernel(const uint8_t* send, uint8_t* recv, const int64_t* meta,
                int p) {
  const int64_t q = blockIdx.y;
  const int64_t off = meta[3 * q], blk = meta[3 * q + 1];
  const int64_t nblk = static_cast<int64_t>(p) * p;
  if (blockIdx.x == 0)
    for (int64_t e = threadIdx.x; e < meta[3 * q + 2]; e += X_THREADS)
      recv[off + nblk * blk + e] = 0;
  for (int64_t b = blockIdx.x; b < nblk; b += gridDim.x) {
    const int64_t i = b / p, j = b % p;
    const uint8_t* src = send + off + (i * p + j) * blk;
    uint8_t* dst = recv + off + (j * p + i) * blk;
    const bool vec = blk % 16 == 0 &&
        (reinterpret_cast<uintptr_t>(src) & 15) == 0 &&
        (reinterpret_cast<uintptr_t>(dst) & 15) == 0;
    if (vec) {
      const uint4* s4 = reinterpret_cast<const uint4*>(src);
      uint4* d4 = reinterpret_cast<uint4*>(dst);
      for (int64_t e = threadIdx.x; e < blk / 16; e += X_THREADS)
        d4[e] = __ldg(s4 + e);
    } else {
      for (int64_t e = threadIdx.x; e < blk; e += X_THREADS)
        dst[e] = src[e];
    }
  }
}

// send, recv: the packed planes on the device; meta: int64[n_planes, 3]
// on the device; p: partitions (each plane is [p, p] blocks)
extern "C" int rt_exchange_planes(const uint8_t* send, uint8_t* recv,
                                  const int64_t* meta, int n_planes, int p,
                                  void* stream) {
  if (n_planes < 1 || n_planes > 65535 || p < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t nblk = static_cast<int64_t>(p) * p;
  const dim3 grid(static_cast<unsigned>(nblk < 1024 ? nblk : 1024),
                  n_planes);
  exchange_kernel<<<grid, X_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      send, recv, meta, p);
  return static_cast<int>(cudaGetLastError());
}

enum { MERGE_SUM = 0, MERGE_MIN = 1, MERGE_MAX = 2 };

// float and double (the integer types are specialized below): min / max
// give the first NaN, as np.minimum / np.maximum give NaN
template <typename T>
__device__ __forceinline__ T merge_op(int op, T a, T b) {
  if (op == MERGE_SUM) return a + b;
  if (a != a) return a;
  if (b != b) return b;
  if (op == MERGE_MIN) return b < a ? b : a;
  return b > a ? b : a;
}

// int64 sums wrap as numpy's do
template <>
__device__ __forceinline__ int64_t merge_op<int64_t>(int op, int64_t a,
                                                     int64_t b) {
  if (op == MERGE_SUM)
    return static_cast<int64_t>(static_cast<uint64_t>(a) +
                                static_cast<uint64_t>(b));
  if (op == MERGE_MIN) return b < a ? b : a;
  return b > a ? b : a;
}
template <>
__device__ __forceinline__ int32_t merge_op<int32_t>(int op, int32_t a,
                                                     int32_t b) {
  if (op == MERGE_SUM)
    return static_cast<int32_t>(static_cast<uint32_t>(a) +
                                static_cast<uint32_t>(b));
  if (op == MERGE_MIN) return b < a ? b : a;
  return b > a ? b : a;
}

template <typename T>
__global__ void __launch_bounds__(M_THREADS)
merge_kernel(const T* x, int64_t rows, int64_t m, int op, T* out) {
  const int64_t c = static_cast<int64_t>(blockIdx.x) * M_THREADS +
                    threadIdx.x;
  if (c >= m) return;
  T acc = x[c];
  for (int64_t r = 1; r < rows; ++r) acc = merge_op<T>(op, acc, x[r * m + c]);
  out[c] = acc;
}

enum { MT_I64 = 0, MT_F64 = 1, MT_I32 = 2, MT_F32 = 3 };

// x: [rows, m] of dtype (MT_*) on the device; out: [m]; op: MERGE_*
extern "C" int rt_merge_rows(const void* x, int64_t rows, int64_t m,
                             int dtype, int op, void* out, void* stream) {
  if (rows < 1 || m < 1 || op < 0 || op > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned blocks = static_cast<unsigned>((m + M_THREADS - 1) /
                                                M_THREADS);
  switch (dtype) {
    case MT_I64:
      merge_kernel<int64_t><<<blocks, M_THREADS, 0, s>>>(
          static_cast<const int64_t*>(x), rows, m, op,
          static_cast<int64_t*>(out));
      break;
    case MT_F64:
      merge_kernel<double><<<blocks, M_THREADS, 0, s>>>(
          static_cast<const double*>(x), rows, m, op,
          static_cast<double*>(out));
      break;
    case MT_I32:
      merge_kernel<int32_t><<<blocks, M_THREADS, 0, s>>>(
          static_cast<const int32_t*>(x), rows, m, op,
          static_cast<int32_t*>(out));
      break;
    case MT_F32:
      merge_kernel<float><<<blocks, M_THREADS, 0, s>>>(
          static_cast<const float*>(x), rows, m, op,
          static_cast<float*>(out));
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
