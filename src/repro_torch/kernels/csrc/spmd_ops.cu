// The partition runtime's collectives on one card: the hash exchange and
// the partial-aggregate merges of repro/runtime/spmd.py.
//
// Exchange (replaces spmd.py:_exchange_fn, an all_to_all per column plane
// through runtime/collectives.partition_by): destination j receives, from
// each source partition i in turn, i's rows whose partition id is j, in
// their order.  The host sends the sources' rows as they are, back to back
// (source-major), one region a column's data and one its validity, and
// either the partition key (one int64 or bool column, every row valid:
// hashed here) or int32 partition ids it computed (any other key).  On one
// card the exchange is then a stable counting partition of the
// concatenated rows into p buckets: a stable sort by partition id of a
// source-major concatenation is dest-major and source-major within, the
// order the function defines.  A block takes a tile of one source, its
// warps consecutive runs of XW_ROWS rows of it.  Three launches:
//  1. xch_hist_kernel: each warp counts its rows a bucket (a shared-memory
//     counter a bucket, __match_any_sync grouping the lanes of one id),
//     and the block sums its warps into hist[bucket, tile].
//  2. xch_scan_kernel (one block): the exclusive scan of hist in (bucket,
//     tile) order, the first slot of each (bucket, tile) in the output;
//     the [p, p] counts fall out as differences of the scan at the
//     sources' first tiles.
//  3. xch_scatter_kernel: each warp counts its rows again, the block turns
//     the counts into each warp's first slot a bucket, and each warp then
//     ranks its rows in order (__match_any_sync, a running slot a bucket)
//     and moves every column's data and validity to its final slot: a
//     lane loads rows 2 l and 2 l + 1 as one 16-byte vector (validity and
//     bool data as 2 bytes) where 64 rows are whole and start at an even
//     row, else a row at a time; both 64-row groups of a warp's run are
//     loaded before either is stored.
// The partition id is storage/dataset.hash_partition_array's: the key as
// uint64 times 11400714819323198485 (wrapping), >> 40, % p.  Bound:
// memory; the key read, every column's data and validity read and written.
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

#include <type_traits>

#define M_THREADS 256
#define X_SCAN_THREADS 1024
#define XG 2                          // 64-row groups a warp's run
#define XW_ROWS (64 * XG)             // rows a warp takes of its tile

// key kinds: an int64 or a bool (byte) column hashed here, or int32 ids
enum { XK_I64 = 0, XK_U8 = 1, XK_PID = 2 };

struct XchArgs {
  const int64_t* src_rows;  // [p + 1] first row of each source
  const int64_t* tile0;     // [p + 1] first tile of each source
  const int64_t* coltab;    // [ncols, 3] element size, data and validity
                            // offsets in the column area
  const uint8_t* in;        // the sent column area
  uint8_t* out;             // the received column area (same offsets)
  int64_t* counts;          // [p, p] rows from source i to destination j
  int32_t* hist;            // [p, ntiles]
  int64_t* offs;            // [p * ntiles + 1]
  int64_t n, ntiles, key_off;
  int p, ncols, key_kind;
};

__device__ __forceinline__ int xch_pid(const XchArgs& a, int64_t row) {
  if (a.key_kind == XK_PID)
    return reinterpret_cast<const int32_t*>(a.in + a.key_off)[row];
  const uint64_t k = a.key_kind == XK_I64
      ? static_cast<uint64_t>(
            reinterpret_cast<const int64_t*>(a.in + a.key_off)[row])
      : static_cast<uint64_t>(a.in[a.key_off + row]);
  return static_cast<int>(((k * 11400714819323198485ull) >> 40) %
                          static_cast<uint64_t>(a.p));
}

// The warp's rows [r0, r1) of the block's tile: the last source whose
// first tile is <= the block's owns it (empty sources own no tile)
__device__ __forceinline__ void xch_rows(const XchArgs& a, int warp,
                                         int64_t& r0, int64_t& r1) {
  const int64_t t = blockIdx.x;
  int lo = 0, hi = a.p;
  while (hi - lo > 1) {
    const int mid = (lo + hi) >> 1;
    if (a.tile0[mid] <= t) lo = mid;
    else hi = mid;
  }
  const int64_t tile_rows = static_cast<int64_t>(blockDim.x >> 5) * XW_ROWS;
  const int64_t end = a.src_rows[lo + 1];
  r0 = a.src_rows[lo] + (t - a.tile0[lo]) * tile_rows + warp * XW_ROWS;
  r0 = r0 < end ? r0 : end;
  r1 = r0 + XW_ROWS < end ? r0 + XW_ROWS : end;
}

// cnt[b] += the warp's rows a bucket (lanes past r1 count in bucket p)
__device__ __forceinline__ void xch_count(const XchArgs& a, int64_t r0,
                                          int64_t r1, int lane,
                                          int64_t* cnt) {
  int q[2 * XG];
#pragma unroll
  for (int e = 0; e < 2 * XG; ++e) {
    const int64_t row = r0 + 32 * e + lane;
    q[e] = row < r1 ? xch_pid(a, row) : a.p;
  }
#pragma unroll
  for (int e = 0; e < 2 * XG; ++e) {
    const unsigned m = __match_any_sync(0xffffffffu, q[e]);
    if (lane == __ffs(m) - 1) cnt[q[e]] += __popc(m);
    __syncwarp();
  }
}

// The block's warps' counts, [warps][p + 1] in shared memory, zeroed and
// filled (the caller syncs)
__device__ __forceinline__ void xch_block_counts(const XchArgs& a,
                                                 int64_t* cnt, int64_t& r0,
                                                 int64_t& r1) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int i = threadIdx.x; i < static_cast<int>(blockDim.x >> 5) * (a.p + 1);
       i += blockDim.x)
    cnt[i] = 0;
  __syncthreads();
  xch_rows(a, warp, r0, r1);
  xch_count(a, r0, r1, lane, cnt + warp * (a.p + 1));
}

__global__ void xch_hist_kernel(XchArgs a) {
  extern __shared__ int64_t xs_cnt[];          // [warps][p + 1]
  int64_t r0, r1;
  xch_block_counts(a, xs_cnt, r0, r1);
  __syncthreads();
  const int warps = blockDim.x >> 5;
  for (int b = threadIdx.x; b < a.p; b += blockDim.x) {
    int64_t s = 0;
    for (int w = 0; w < warps; ++w) s += xs_cnt[w * (a.p + 1) + b];
    a.hist[static_cast<int64_t>(b) * a.ntiles + blockIdx.x] =
        static_cast<int32_t>(s);
  }
}

// Exclusive scan of v over the block's threads (in order); *total gets
// the sum of all
__device__ __forceinline__ int64_t block_scan(int64_t v, int64_t* total) {
  __shared__ int64_t ws[X_SCAN_THREADS / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  int64_t x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int64_t y = __shfl_up_sync(0xffffffffu,
                                     static_cast<long long>(x), o);
    if (lane >= o) x += y;
  }
  if (lane == 31) ws[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int64_t w = lane < nw ? ws[lane] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int64_t y = __shfl_up_sync(0xffffffffu,
                                       static_cast<long long>(w), o);
      if (lane >= o) w += y;
    }
    if (lane < nw) ws[lane] = w;
  }
  __syncthreads();
  const int64_t before = warp > 0 ? ws[warp - 1] : 0;
  *total = ws[nw - 1];
  __syncthreads();                       // ws read before it is reused
  return before + x - v;
}

// One block: offs = the exclusive scan of hist, 4 entries a thread a
// round, then offs[p * ntiles] = n and the counts
__global__ void __launch_bounds__(X_SCAN_THREADS)
xch_scan_kernel(XchArgs a) {
  const int64_t L = static_cast<int64_t>(a.p) * a.ntiles;
  int64_t base = 0;
  for (int64_t r = 0; r < L; r += 4 * X_SCAN_THREADS) {
    const int64_t i0 = r + 4 * static_cast<int64_t>(threadIdx.x);
    int64_t v[4], s = 0;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      v[e] = i0 + e < L ? a.hist[i0 + e] : 0;
      s += v[e];
    }
    int64_t total;
    int64_t run = base + block_scan(s, &total);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (i0 + e < L) a.offs[i0 + e] = run;
      run += v[e];
    }
    base += total;
  }
  if (threadIdx.x == 0) a.offs[L] = base;
  __syncthreads();                       // offs visible to the block
  // rows from source i to j: the scan across i's tiles of bucket j
  for (int64_t q = threadIdx.x; q < static_cast<int64_t>(a.p) * a.p;
       q += blockDim.x) {
    const int64_t i = q / a.p, j = q % a.p;
    a.counts[q] = a.offs[j * a.ntiles + a.tile0[i + 1]] -
                  a.offs[j * a.ntiles + a.tile0[i]];
  }
}

// Move one column region of element size ES (8 or 1) for the warp's XG
// groups of 64 rows from g0: group e's rows g + lane, g + 32 + lane to
// slots dst[e][0], dst[e][1] (a row at a time), or (pair[e]) rows
// g + 2 lane, g + 2 lane + 1 to d0[e], d1[e] from one vector load; every
// group's loads are issued before its stores
template <int ES>
__device__ __forceinline__ void xch_move(const uint8_t* src, uint8_t* dst,
                                         int64_t g0, int64_t r1, int lane,
                                         const bool* pair,
                                         const int64_t (*dsts)[2],
                                         const int64_t* d0,
                                         const int64_t* d1) {
  using T = typename std::conditional<ES == 8, int64_t, uint8_t>::type;
  const T* s = reinterpret_cast<const T*>(src);
  T* o = reinterpret_cast<T*>(dst);
  T v[XG][2];
#pragma unroll
  for (int e = 0; e < XG; ++e) {
    const int64_t g = g0 + 64 * e;
    if (pair[e]) {
      if constexpr (ES == 8) {
        const uint4 w = __ldg(reinterpret_cast<const uint4*>(s + g +
                                                            2 * lane));
        v[e][0] = static_cast<int64_t>(static_cast<uint64_t>(w.x) |
                                       (static_cast<uint64_t>(w.y) << 32));
        v[e][1] = static_cast<int64_t>(static_cast<uint64_t>(w.z) |
                                       (static_cast<uint64_t>(w.w) << 32));
      } else {
        const unsigned short w =
            __ldg(reinterpret_cast<const unsigned short*>(s + g + 2 * lane));
        v[e][0] = static_cast<uint8_t>(w & 0xff);
        v[e][1] = static_cast<uint8_t>(w >> 8);
      }
    } else {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int64_t row = g + 32 * h + lane;
        v[e][h] = row < r1 ? s[row] : T(0);
      }
    }
  }
#pragma unroll
  for (int e = 0; e < XG; ++e) {
    if (pair[e]) {
      o[d0[e]] = v[e][0];
      o[d1[e]] = v[e][1];
    } else {
#pragma unroll
      for (int h = 0; h < 2; ++h)
        if (g0 + 64 * e + 32 * h + lane < r1) o[dsts[e][h]] = v[e][h];
    }
  }
}

__global__ void xch_scatter_kernel(XchArgs a) {
  extern __shared__ int64_t xs_pos[];          // [warps][p + 1]
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  int64_t r0, r1;
  xch_block_counts(a, xs_pos, r0, r1);
  __syncthreads();
  // each warp's first slot a bucket: the tile's, then the earlier warps'
  for (int b = threadIdx.x; b < a.p; b += blockDim.x) {
    int64_t run = a.offs[static_cast<int64_t>(b) * a.ntiles + blockIdx.x];
    for (int w = 0; w < warps; ++w) {
      const int64_t c = xs_pos[w * (a.p + 1) + b];
      xs_pos[w * (a.p + 1) + b] = run;
      run += c;
    }
  }
  __syncthreads();
  if (r0 >= r1) return;
  int64_t* pos = xs_pos + warp * (a.p + 1);
  const unsigned lt = (1u << lane) - 1u;
  int64_t dst[XG][2];
  int q[XG][2];
#pragma unroll
  for (int e = 0; e < XG; ++e)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int64_t row = r0 + 64 * e + 32 * h + lane;
      q[e][h] = row < r1 ? xch_pid(a, row) : a.p;
    }
#pragma unroll
  for (int e = 0; e < XG; ++e)
#pragma unroll
    for (int h = 0; h < 2; ++h) {        // rows in order: the stable rank
      const unsigned m = __match_any_sync(0xffffffffu, q[e][h]);
      dst[e][h] = pos[q[e][h]] + __popc(m & lt);
      __syncwarp();
      if (lane == __ffs(m) - 1) pos[q[e][h]] += __popc(m);
      __syncwarp();
    }
  // warp-uniform: a group's 64 rows whole and 16-byte aligned (the column
  // regions are, and int64 row g is where g is even)
  bool pair[XG];
  int64_t d0[XG], d1[XG];
  const int s0 = (2 * lane) & 31, s1 = (2 * lane + 1) & 31;
#pragma unroll
  for (int e = 0; e < XG; ++e) {
    const int64_t g = r0 + 64 * e;
    pair[e] = g + 64 <= r1 && (g & 1) == 0;
    const long long e0 = dst[e][0], e1 = dst[e][1];
    const int64_t a0 = __shfl_sync(0xffffffffu, e0, s0);
    const int64_t b0 = __shfl_sync(0xffffffffu, e1, s0);
    const int64_t a1 = __shfl_sync(0xffffffffu, e0, s1);
    const int64_t b1 = __shfl_sync(0xffffffffu, e1, s1);
    d0[e] = lane < 16 ? a0 : b0;         // slots of rows 2 l, 2 l + 1
    d1[e] = lane < 16 ? a1 : b1;
  }
  for (int c = 0; c < a.ncols; ++c) {
    const int64_t doff = a.coltab[3 * c + 1], voff = a.coltab[3 * c + 2];
    if (a.coltab[3 * c] == 8)
      xch_move<8>(a.in + doff, a.out + doff, r0, r1, lane, pair, dst, d0,
                  d1);
    else
      xch_move<1>(a.in + doff, a.out + doff, r0, r1, lane, pair, dst, d0,
                  d1);
    xch_move<1>(a.in + voff, a.out + voff, r0, r1, lane, pair, dst, d0, d1);
  }
}

// send: the header (int64: src_rows[p + 1], tile0[p + 1], the column
// table [ncols, 3]) then, at head, the column area; key_off: the key
// column's data, or the int32 ids, in the column area; recv: the counts
// [p, p] (int64) then, at recv_head, the received column area; hist:
// int32[p * ntiles], offs: int64[p * ntiles + 1] scratch; warps: warps a
// block (a tile is warps * XW_ROWS rows of one source; each warp holds
// p + 1 int64 counters in shared memory, at most 48 KB a block)
extern "C" int rt_exchange(const uint8_t* send, int64_t head, int p,
                           int64_t n, int ncols, int key_kind,
                           int64_t key_off, int64_t ntiles, int warps,
                           uint8_t* recv, int64_t recv_head, int32_t* hist,
                           int64_t* offs, void* stream) {
  const size_t smem = static_cast<size_t>(warps) * (p + 1) * 8;
  if (p < 1 || n < 1 || ncols < 1 || ntiles < 1 || ntiles > 0x7fffffff ||
      warps < 1 || warps > 32 || key_kind < 0 || key_kind > 2 ||
      smem > 48 * 1024)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t* h = reinterpret_cast<const int64_t*>(send);
  XchArgs a;
  a.src_rows = h;
  a.tile0 = h + p + 1;
  a.coltab = h + 2 * (p + 1);
  a.in = send + head;
  a.out = recv + recv_head;
  a.counts = reinterpret_cast<int64_t*>(recv);
  a.hist = hist;
  a.offs = offs;
  a.n = n;
  a.ntiles = ntiles;
  a.key_off = key_off;
  a.p = p;
  a.ncols = ncols;
  a.key_kind = key_kind;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned blocks = static_cast<unsigned>(ntiles);
  xch_hist_kernel<<<blocks, 32 * warps, smem, s>>>(a);
  xch_scan_kernel<<<1, X_SCAN_THREADS, 0, s>>>(a);
  xch_scatter_kernel<<<blocks, 32 * warps, smem, s>>>(a);
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
