// Floors for K4's sorted kernel and K5: kernels with their grids and
// memory traffic at the fuzzy path's shapes and none of their logic
// (built and timed by scripts/probes/fuzzy_floor.py).
#include <cuda_runtime.h>
#include <stdint.h>

// K4's grid (a CTA of 512 threads a 256-row tile): each CTA writes its
// tile of zeros with 16-byte stores
__global__ void __launch_bounds__(512) k4_store(uint8_t* out) {
  if (threadIdx.x < 16)
    reinterpret_cast<uint4*>(out + 256 * blockIdx.x)[threadIdx.x] =
        make_uint4(0, 0, 0, 0);
}

// K4's grid reading `per` consecutive int64 a CTA, 16 a lane in flight,
// then the store
__global__ void __launch_bounds__(512) k4_loads(const int64_t* pos,
                                                int64_t m, int64_t per,
                                                uint8_t* out) {
  __shared__ int acc;
  if (threadIdx.x == 0) acc = 0;
  __syncthreads();
  const int64_t a = blockIdx.x * per, b = a + per < m ? a + per : m;
  int64_t s = 0;
  for (int64_t i0 = a + threadIdx.x; i0 < b; i0 += 512 * 16) {
    int64_t p[16];
#pragma unroll
    for (int u = 0; u < 16; ++u) {
      const int64_t i = i0 + 512 * u;
      p[u] = i < b ? __ldg(pos + i) : 0;
    }
#pragma unroll
    for (int u = 0; u < 16; ++u) s += p[u];
  }
  atomicAdd(&acc, static_cast<int>(s & 1));
  __syncthreads();
  if (threadIdx.x < 16)
    reinterpret_cast<uint4*>(out + 256 * blockIdx.x)[threadIdx.x] =
        make_uint4(acc, 0, 0, 0);
}

// k4_loads plus K4's shared-memory counts and its mask phase; with
// `table`, each warp first reads a descriptor of a 96-entry table in the
// kernel parameters at a warp-dependent index, as K4 reads its segments
struct FloorSeg { const int64_t* pos; int64_t count, offset, first;
                  double slope; };
struct FloorTable { const FloorSeg* ext; int64_t n, n_out; int nseg, t;
                    FloorSeg seg[96]; };

__global__ void __launch_bounds__(512) k4_counts(
    const __grid_constant__ FloorTable tb, const int64_t* pos, int64_t m,
    int64_t per, int table, uint8_t* out) {
  __shared__ int cnt[256];
  __shared__ __align__(16) uint8_t s_out[256];
  if (threadIdx.x < 256) cnt[threadIdx.x] = 0;
  __syncthreads();
  int64_t shift = 0;
  if (table) {
    const FloorSeg s = tb.seg[(threadIdx.x >> 5) % tb.nseg];
    shift = s.offset + static_cast<int64_t>(s.slope * 0.0) + (s.pos != pos);
  }
  const int64_t a = blockIdx.x * per + shift;
  const int64_t b = a + per < m ? a + per : m;
  for (int64_t i0 = a + threadIdx.x; i0 < b; i0 += 512 * 16) {
    int64_t p[16];
#pragma unroll
    for (int u = 0; u < 16; ++u) {
      const int64_t i = i0 + 512 * u;
      p[u] = i < b ? __ldg(pos + i) : -1;
    }
#pragma unroll
    for (int u = 0; u < 16; ++u)
      if (p[u] >= 0) atomicAdd(cnt + (p[u] & 255), 1);
  }
  __syncthreads();
  if (threadIdx.x < 256) s_out[threadIdx.x] = cnt[threadIdx.x] >= 13;
  __syncthreads();
  if (threadIdx.x < 16)
    reinterpret_cast<uint4*>(out + 256 * blockIdx.x)[threadIdx.x] =
        reinterpret_cast<const uint4*>(s_out)[threadIdx.x];
}

// K5's grid (a thread a candidate, 256 a block): the length only
__global__ void __launch_bounds__(256) k5_lens(const int64_t* lens,
                                               int64_t B, int64_t* out) {
  const int64_t b = static_cast<int64_t>(blockIdx.x) * 256 + threadIdx.x;
  if (b < B) out[b] = lens[b];
}

// ... and the row's code points up to the length, as 16-byte vectors
__global__ void __launch_bounds__(256) k5_rows(const int32_t* cand,
                                               const int64_t* lens,
                                               int64_t B, int64_t lp,
                                               int64_t* out) {
  const int64_t b = static_cast<int64_t>(blockIdx.x) * 256 + threadIdx.x;
  if (b >= B) return;
  const int64_t len = lens[b] < lp ? lens[b] : lp;
  const int4* s4 = reinterpret_cast<const int4*>(cand + b * lp);
  int64_t s = 0;
  for (int64_t i0 = 0; i0 < len; i0 += 32) {
    int4 v[8];
#pragma unroll
    for (int u = 0; u < 8; ++u)
      v[u] = i0 + 4 * u < len ? __ldg(s4 + i0 / 4 + u) : make_int4(0, 0, 0, 0);
#pragma unroll
    for (int u = 0; u < 8; ++u) s += v[u].x + v[u].y + v[u].z + v[u].w;
  }
  out[b] = s;
}

// ... the same rows loaded by the warp together: the 32 rows' needed
// 16-byte units back to back (lanes on neighbouring units of a row), then
// each lane reads its own row from shared memory (units swizzled by row)
__global__ void __launch_bounds__(256) k5_rows_warp(const int32_t* cand,
                                                    const int64_t* lens,
                                                    int64_t B, int64_t lp,
                                                    int64_t* out) {
  __shared__ int4 buf[8][32][8];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int64_t b0 = static_cast<int64_t>(blockIdx.x) * 256 + 32 * warp;
  const int64_t b = b0 + lane;
  int64_t len = b < B ? lens[b] : 0;
  len = len < lp ? len : lp;
  int need = static_cast<int>((len + 3) / 4);
  need = need < 8 ? need : 8;
  int jw = need;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    jw = max(jw, __shfl_xor_sync(0xffffffffu, jw, o));
  for (int q = 0; q < jw; ++q) {
    const int u = q * 32 + lane, r = u / jw, j = u % jw;
    if (b0 + r < B)
      buf[warp][r][j ^ (r & 7)] = __ldg(reinterpret_cast<const int4*>(
          cand + (b0 + r) * lp) + j);
  }
  __syncwarp();
  int64_t s = 0;
  for (int j = 0; j < need; ++j) {
    const int4 v = buf[warp][lane][j ^ (lane & 7)];
    s += v.x + v.y + v.z + v.w;
  }
  if (b < B) out[b] = s;
}

extern "C" int probe_k5_rows_warp(const int32_t* cand, const int64_t* lens,
                                  int64_t B, int64_t lp, int64_t* out,
                                  void* st) {
  k5_rows_warp<<<static_cast<unsigned>((B + 255) / 256), 256, 0,
                 static_cast<cudaStream_t>(st)>>>(cand, lens, B, lp, out);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int probe_k4_store(uint8_t* out, int64_t n_out, void* st) {
  k4_store<<<static_cast<unsigned>(n_out / 256), 512, 0,
             static_cast<cudaStream_t>(st)>>>(out);
  return static_cast<int>(cudaGetLastError());
}
extern "C" int probe_k4_loads(const int64_t* pos, int64_t m, int64_t tiles,
                              uint8_t* out, void* st) {
  k4_loads<<<static_cast<unsigned>(tiles), 512, 0,
             static_cast<cudaStream_t>(st)>>>(pos, m, (m + tiles - 1) / tiles,
                                              out);
  return static_cast<int>(cudaGetLastError());
}
extern "C" int probe_k4_counts(const int64_t* pos, int64_t m,
                               int64_t tiles, int table, uint8_t* out,
                               void* st) {
  FloorTable tb = {};
  tb.nseg = 16;
  for (int j = 0; j < 96; ++j) tb.seg[j].pos = pos;
  k4_counts<<<static_cast<unsigned>(tiles), 512, 0,
              static_cast<cudaStream_t>(st)>>>(tb, pos, m,
                                               (m + tiles - 1) / tiles,
                                               table, out);
  return static_cast<int>(cudaGetLastError());
}
extern "C" int probe_k5_lens(const int64_t* lens, int64_t B, int64_t* out,
                             void* st) {
  k5_lens<<<static_cast<unsigned>((B + 255) / 256), 256, 0,
            static_cast<cudaStream_t>(st)>>>(lens, B, out);
  return static_cast<int>(cudaGetLastError());
}
extern "C" int probe_k5_rows(const int32_t* cand, const int64_t* lens,
                             int64_t B, int64_t lp, int64_t* out, void* st) {
  k5_rows<<<static_cast<unsigned>((B + 255) / 256), 256, 0,
            static_cast<cudaStream_t>(st)>>>(cand, lens, B, lp, out);
  return static_cast<int>(cudaGetLastError());
}
