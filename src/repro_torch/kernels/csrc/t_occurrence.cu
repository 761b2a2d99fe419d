// K4 t_occurrence_mask: rows whose posting-position hit count reaches T.
//
// Replaces the TPU kernel repro/kernels/fuzzy_ops.py:_tocc_kernel (host
// wrapper _tocc_pallas), an O(n * m) compare loop over f32 row ids.
// Positions arrive as segments of device-resident posting arrays (pointer,
// start, count, row offset), so an index probe over resident postings
// ships nothing host -> device.  Two kernels:
//
// tocc_sorted_kernel, T > 1 over segments whose positions are sorted (the
// ngram probe's gram postings: csr_from_pairs groups a component's
// positions by gram with a stable sort).  One launch, and no count array
// in device memory: a CTA owns a tile of TOCC_ROWS rows and counts their
// hits in shared memory.  Each segment's part of the tile is found with no
// search: the host hands over the segment's first position and its slope
// (positions a row), so the index of a row is interpolated, and a window
// around it, three standard deviations of a uniform sample's rank wide,
// holds the tile's positions.  A warp lays out the windows of 32 segments
// at a time (a lane a segment, a scan of their chunk counts) and the CTA's
// warps take chunks of TOCC_CHUNK positions in turn (20 loads a lane in
// flight); each position adds a shared-memory atomic (one outside the tile
// goes to its lane's spare slot, so no atomic waits on a branch).  A
// window shows by its first and last position whether it reached past
// the tile's edges; one that did not is queued and its missing part
// counted exactly after the main loop (a binary search by the whole warp,
// 129 samples a round), so a skewed segment costs time but never a row.
// Then the CTA writes its tile of the mask, zero padding up to n_out
// included, with 16-byte stores.  The segment table travels in the kernel
// parameters (TOCC_PARAM_SEGS segments; a longer table is copied to the
// device by the caller) and is staged into shared memory first, a word a
// thread, so each lane's read of its own segment is a shared-memory load.
//
// tocc_scatter_kernel, T = 1 (every secondary-index candidate bitmap) and
// T > 1 over segments not known to be sorted: one thread per position; at
// T = 1 a hit stores true directly, at T > 1 an int32 count array of n + 1
// entries takes integer atomicAdds and a second pass writes count >= T.
//
// Bound: memory.  8 bytes read per position and n_out bytes of mask
// written.  The sorted kernel reads a position once plus the windows'
// margins; at the fuzzy path's shape (586,319 positions, 4.7 MB) it is
// latency that is left: a kernel that only streams the same positions
// with the same grid, counts them and writes the mask takes 3.4x the
// bound (scripts/probes/fuzzy_floor.py).
#include "common.cuh"

// ---------------------------------------------------------------------------
// T > 1, sorted segments
// ---------------------------------------------------------------------------

// (each #ifndef lets scripts/probes build another tiling)
#ifndef TOCC_ROWS
#define TOCC_ROWS 512         // rows a CTA owns
#endif
#ifndef TOCC_THREADS
#define TOCC_THREADS 512
#endif
#ifndef TOCC_MIN_BLOCKS
#define TOCC_MIN_BLOCKS 1     // CTAs an SM must hold (caps the registers)
#endif
#define TOCC_PARAM_SEGS 96    // segments in the parameters (_TOCC_PARAM_SEGS)
#ifndef TOCC_CHUNK
#define TOCC_CHUNK 640        // positions a warp loads at once (20 a lane):
                              // a tile of a segment in every row, margins too
#endif
#define TOCC_UNROLL 8         // loads a lane has in flight past a window
#define TOCC_MISSES 64        // windows that missed rows a CTA can list
#define PROBE 4               // samples a lane loads per edge and round
#define PROBE_K (32 * PROBE)

struct SortedSeg {          // mirrored by SortedSeg in kernels/fuzzy_ops.py
  const int64_t* pos;       // the slice's first position
  int64_t count;
  int64_t offset;           // row = position + offset
  int64_t first;            // pos[0]
  double slope;             // (count - 1) / (pos[count - 1] - pos[0]), or 0
};

// Well under the 4 KB of kernel parameters every toolkit takes
struct SortedTable {
  const SortedSeg* ext;     // all nseg segments on the device, or null: seg
  int64_t n, n_out;
  int nseg, threshold;
  SortedSeg seg[TOCC_PARAM_SEGS];
};

// The number of s.pos[0 .. count) below x and below y, found by the whole
// warp (every lane returns both).  A round loads up to 128 samples an edge,
// 4 a lane, both edges' loads in flight together; the samples below the
// edge are a prefix (the positions are sorted), so one ballot count places
// the edge between two samples.  Round 0 samples the window of 128 around
// the interpolated index; a bracket of at most 128 is read whole (exact);
// a wider one is sampled evenly (129 pieces).
__device__ __forceinline__ void warp_edges(const SortedSeg& s, int64_t x,
                                           int64_t y, int64_t& rx,
                                           int64_t& ry) {
  const int lane = threadIdx.x & 31;
  const int64_t tgt[2] = {x, y};
  int64_t lo[2] = {0, 0}, hi[2] = {s.count, s.count}, w0[2];
  bool win[2] = {true, true};
#pragma unroll
  for (int t = 0; t < 2; ++t) {
    double g = static_cast<double>(tgt[t] - s.first) * s.slope;
    g = fmin(fmax(g, 0.0), static_cast<double>(s.count));
    const int64_t c = static_cast<int64_t>(g) - PROBE_K / 2;
    const int64_t top = s.count - PROBE_K > 0 ? s.count - PROBE_K : 0;
    w0[t] = c < 0 ? 0 : c > top ? top : c;
  }
  while (lo[0] < hi[0] || lo[1] < hi[1]) {
    int64_t k[2], v[2][PROBE];
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      if (!win[t] && hi[t] - lo[t] <= PROBE_K) {
        win[t] = true;
        w0[t] = lo[t];
      }
      k[t] = lo[t] >= hi[t] ? 0
             : win[t] ? (hi[t] - w0[t] < PROBE_K ? hi[t] - w0[t] : PROBE_K)
             : PROBE_K;
#pragma unroll
      for (int q = 0; q < PROBE; ++q) {
        const int i = lane + 32 * q;
        const int64_t at = win[t] ? w0[t] + i
                                  : lo[t] + (i + 1) * (hi[t] - lo[t]) /
                                                (PROBE_K + 1);
        v[t][q] = i < k[t] ? __ldg(s.pos + at) : 0;
      }
    }
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      if (k[t] == 0) continue;
      int c = 0;
#pragma unroll
      for (int q = 0; q < PROBE; ++q)
        c += __popc(__ballot_sync(0xffffffffu, lane + 32 * q < k[t] &&
                                                   v[t][q] < tgt[t]));
      // sample i sits at w0 + i (window) or lo + (i + 1) span / 129
      const int64_t span = hi[t] - lo[t];
      const int64_t below = c == 0 ? lo[t]
          : (win[t] ? w0[t] + c - 1 : lo[t] + c * span / (PROBE_K + 1)) + 1;
      const int64_t above = c == k[t] ? hi[t]
          : win[t] ? w0[t] + c : lo[t] + (c + 1) * span / (PROBE_K + 1);
      lo[t] = below;
      hi[t] = above;
      win[t] = false;
    }
  }
  rx = lo[0];
  ry = lo[1];
}

// Where a tile's rows should fall in a sorted segment: the indices of
// rows x and y by the segment's slope, widened by three standard
// deviations of the rank of a value among `count` positions drawn
// uniformly (a quarter of count at the middle, times 1 - density without
// replacement), plus 8.
__device__ __forceinline__ void tile_window(const SortedSeg& s, int64_t x,
                                            int64_t y, int64_t& wa,
                                            int64_t& wb) {
  const double cnt = static_cast<double>(s.count);
  const double f = s.slope <= 1.0 ? 1.0 - s.slope : 1.0;
  const double margin = 8.0 + 1.5 * sqrt(cnt * f);
  const double ga = static_cast<double>(x - s.first) * s.slope - margin;
  const double gb = static_cast<double>(y - s.first) * s.slope + margin;
  wa = static_cast<int64_t>(floor(fmin(fmax(ga, 0.0), cnt)));
  wb = static_cast<int64_t>(ceil(fmin(fmax(gb, 0.0), cnt)));
}

// Shared-memory atomics for the in-tile hits of pos[i], i in [a, b) (tile
// row = pos + off), by the lanes of one warp.
__device__ __forceinline__ void warp_count(const int64_t* pos, int64_t a,
                                           int64_t b, int64_t off,
                                           int* cnt) {
  const int lane = threadIdx.x & 31;
  for (int64_t i0 = a + lane; i0 < b; i0 += 32 * TOCC_UNROLL) {
    int64_t p[TOCC_UNROLL];
#pragma unroll
    for (int u = 0; u < TOCC_UNROLL; ++u) {
      const int64_t i = i0 + 32 * u;
      p[u] = i < b ? __ldg(pos + i) + off : -1;
    }
#pragma unroll
    for (int u = 0; u < TOCC_UNROLL; ++u)
      if (static_cast<uint64_t>(p[u]) < TOCC_ROWS) atomicAdd(cnt + p[u], 1);
  }
}

// Count what a window [wa, wb) of segment s left out of the tile [row0,
// row1): the exact range's part below wa (lo_side) and above wb
// (hi_side), by one warp.
__device__ __forceinline__ void count_missed(const SortedSeg& s,
                                             int64_t row0, int64_t row1,
                                             int64_t wa, int64_t wb,
                                             bool lo_side, bool hi_side,
                                             int* cnt) {
  int64_t lo, hi;
  warp_edges(s, row0 - s.offset, row1 - s.offset, lo, hi);
  const int64_t off = s.offset - row0;
  if (lo_side) warp_count(s.pos, lo, hi < wa ? hi : wa, off, cnt);
  if (hi_side) warp_count(s.pos, lo > wb ? lo : wb, hi, off, cnt);
}

__global__ void __launch_bounds__(TOCC_THREADS, TOCC_MIN_BLOCKS)
tocc_sorted_kernel(const __grid_constant__ SortedTable t, uint8_t* out) {
  constexpr int NW = TOCC_THREADS / 32;
  __shared__ int cnt[TOCC_ROWS + 32];      // + a spare slot a lane
  __shared__ __align__(16) uint8_t s_out[TOCC_ROWS];
  __shared__ SortedSeg s_seg[TOCC_PARAM_SEGS];
  // windows that missed rows, counted after the main loop (a call or the
  // exact search inside it would cost the loop registers): segment and
  // sides, window edges; past TOCC_MISSES the tile is counted exactly
  __shared__ int s_nmiss;
  __shared__ int s_miss[TOCC_MISSES];
  __shared__ int64_t s_miss_w[TOCC_MISSES][2];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * TOCC_ROWS;
  const int64_t row1 = row0 + TOCC_ROWS < t.n ? row0 + TOCC_ROWS : t.n;
  const int64_t rows = row1 - row0;
  for (int i = threadIdx.x; i < TOCC_ROWS + 32; i += TOCC_THREADS)
    cnt[i] = 0;
  if (threadIdx.x == 0) s_nmiss = 0;
  // the parameters' table goes to shared memory, a word a thread
  if (!t.ext) {
    const uint64_t* src = reinterpret_cast<const uint64_t*>(t.seg);
    uint64_t* dst = reinterpret_cast<uint64_t*>(s_seg);
    const int words = t.nseg * static_cast<int>(sizeof(SortedSeg) / 8);
    for (int i = threadIdx.x; i < words; i += TOCC_THREADS) dst[i] = src[i];
  }
  __syncthreads();
  // Every warp lays the tile's windows of 32 segments at a time end to
  // end (a lane a segment, a warp scan of their chunk counts) and takes
  // the chunks c = warp, warp + NW, ...; a tile past n only writes zeros.
  int64_t base = 0;                  // chunks of the earlier groups
  for (int g0 = 0; rows > 0 && g0 < t.nseg; g0 += 32) {
    const int j = g0 + lane;
    SortedSeg s = {};
    int64_t wa = 0, wb = 0;
    if (j < t.nseg) {
      s = t.ext ? t.ext[j] : s_seg[j];
      tile_window(s, row0 - s.offset, row1 - s.offset, wa, wb);
    }
    const int64_t nch = (wb - wa + TOCC_CHUNK - 1) / TOCC_CHUNK;
    int64_t incl = nch;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int64_t up = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += up;
    }
    const int64_t total = __shfl_sync(0xffffffffu, incl, 31);
    // this warp's first chunk of the group: global index = warp (mod NW)
    for (int64_t c = ((warp - base) % NW + NW) % NW; c < total; c += NW) {
      // the segment (lane) whose chunks hold chunk c, and its window
      const int src = __ffs(__ballot_sync(0xffffffffu,
                                          incl - nch <= c && c < incl)) - 1;
      const int64_t first = __shfl_sync(0xffffffffu, incl - nch, src);
      const int64_t* pos = reinterpret_cast<const int64_t*>(__shfl_sync(
          0xffffffffu,
          static_cast<unsigned long long>(reinterpret_cast<uintptr_t>(s.pos)),
          src));
      const int64_t off = __shfl_sync(0xffffffffu, s.offset, src) - row0;
      const int64_t cwa = __shfl_sync(0xffffffffu, wa, src);
      const int64_t cwb = __shfl_sync(0xffffffffu, wb, src);
      const int64_t count = __shfl_sync(0xffffffffu, s.count, src);
      const int64_t ca = cwa + (c - first) * TOCC_CHUNK;
      // the chunk's length, and where its window's first and last
      // position sit in it (-1: elsewhere, or at the segment's ends)
      const int len = static_cast<int>(
          cwb - ca < TOCC_CHUNK ? cwb - ca : TOCC_CHUNK);
      const int k_lo = ca == cwa && cwa > 0 ? 0 : -1;
      const int k_hi = cwb - ca <= TOCC_CHUNK && cwb < count
          ? static_cast<int>(cwb - ca) - 1 : -1;
      const int64_t* cp = pos + ca;
      int64_t p[TOCC_CHUNK / 32];
#pragma unroll
      for (int u = 0; u < TOCC_CHUNK / 32; ++u) {
        const int k = lane + 32 * u;
        p[u] = k < len ? __ldg(cp + k) + off : -1;
      }
      // the window must start below the tile's first row and end past
      // its last (or at the segment's ends): its first and last position
      // show whether it does.  A position outside the tile (or past the
      // chunk) counts into its lane's spare slot, so no atomic waits on a
      // branch and no two lanes of a warp meet on one address.
      bool miss_lo = false, miss_hi = false;
#pragma unroll
      for (int u = 0; u < TOCC_CHUNK / 32; ++u) {
        const int k = lane + 32 * u;
        miss_lo |= k == k_lo && p[u] >= 0;
        miss_hi |= k == k_hi && p[u] < rows;
        atomicAdd(cnt + (static_cast<uint64_t>(p[u]) < TOCC_ROWS
                         ? static_cast<int>(p[u]) : TOCC_ROWS + lane), 1);
      }
      miss_lo = __any_sync(0xffffffffu, miss_lo);
      miss_hi = __any_sync(0xffffffffu, miss_hi);
#ifdef TOCC_PROBE_NO_MISSES          // scripts/probes: no miss queue
      miss_lo = miss_hi = false;
#endif
      if ((miss_lo || miss_hi) && lane == 0) {
        const int q = atomicAdd(&s_nmiss, 1);
        if (q < TOCC_MISSES) {
          s_miss[q] = ((g0 + src) << 2) | (miss_lo ? 1 : 0) | (miss_hi ? 2 : 0);
          s_miss_w[q][0] = cwa;
          s_miss_w[q][1] = cwb;
        }
      }
    }
    base += total;
  }
  __syncthreads();
  if (s_nmiss > TOCC_MISSES) {
    // too many misses to list: count the tile exactly from scratch
    for (int i = threadIdx.x; i < TOCC_ROWS; i += TOCC_THREADS) cnt[i] = 0;
    __syncthreads();
    for (int j = warp; j < t.nseg; j += NW) {
      const SortedSeg e = t.ext ? t.ext[j] : s_seg[j];
      count_missed(e, row0, row1, 0, 0, false, true, cnt);
    }
  } else {
    for (int q = warp; q < s_nmiss; q += NW) {
      const int k = s_miss[q] >> 2;
      const SortedSeg e = t.ext ? t.ext[k] : s_seg[k];
      count_missed(e, row0, row1, s_miss_w[q][0], s_miss_w[q][1],
                   s_miss[q] & 1, s_miss[q] & 2, cnt);
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < TOCC_ROWS; i += TOCC_THREADS)
    s_out[i] = static_cast<uint8_t>(i < rows && cnt[i] >= t.threshold);
  __syncthreads();
  const int64_t nout = t.n_out - row0 < TOCC_ROWS ? t.n_out - row0
                                                  : TOCC_ROWS;
  for (int v = threadIdx.x; 16 * v < nout; v += TOCC_THREADS) {
    if (16 * v + 16 <= nout) {
      *reinterpret_cast<uint4*>(out + row0 + 16 * v) =
          *reinterpret_cast<const uint4*>(s_out + 16 * v);
    } else {
      for (int e = 16 * v; e < nout; ++e) out[row0 + e] = s_out[e];
    }
  }
}

// segs: host array of nseg segments, sorted; ext: the same nseg segments
// on the device when nseg > TOCC_PARAM_SEGS, else null; out: bool[n_out]
// (n_out >= n, 16-byte aligned) on the device.
extern "C" int rt_t_occurrence_sorted(const SortedSeg* segs, int nseg,
                                      int64_t n, int64_t n_out,
                                      int threshold, const SortedSeg* ext,
                                      uint8_t* out, void* stream) {
  if (nseg > TOCC_PARAM_SEGS && ext == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  SortedTable t;
  t.ext = nseg > TOCC_PARAM_SEGS ? ext : nullptr;
  t.n = n;
  t.n_out = n_out;
  t.nseg = nseg;
  t.threshold = threshold;
  for (int j = 0; j < nseg && j < TOCC_PARAM_SEGS; ++j) t.seg[j] = segs[j];
  const int64_t blocks = (n_out + TOCC_ROWS - 1) / TOCC_ROWS;
  tocc_sorted_kernel<<<static_cast<unsigned>(blocks > 0 ? blocks : 1),
                       TOCC_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      t, out);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// T = 1, and T > 1 over segments not known to be sorted
// ---------------------------------------------------------------------------

struct SegDesc {            // mirrored by SegDesc in kernels/fuzzy_ops.py
  const int64_t* pos;
  int64_t start, count, offset;
};

#define MAX_SEGS 32

struct SegTable {
  const int64_t* pos[MAX_SEGS];
  int64_t offset[MAX_SEGS];
  int64_t first[MAX_SEGS + 1];   // exclusive prefix of the counts
  int n;
};

__global__ void tocc_scatter_kernel(SegTable t, int64_t n, uint8_t* out,
                                    int* counts) {
  const int64_t total = t.first[t.n];
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t g = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       g < total; g += stride) {
    int j = 0;
    while (g >= t.first[j + 1]) ++j;
    const int64_t p = t.pos[j][g - t.first[j]] + t.offset[j];
    if (p < 0 || p >= n) continue;
    if (counts) atomicAdd(counts + p, 1);
    else out[p] = 1;
  }
}

__global__ void tocc_threshold_kernel(const int* counts, int64_t n,
                                      int threshold, uint8_t* out,
                                      int64_t n_out) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       i < n_out; i += stride)
    out[i] = static_cast<uint8_t>(i < n && counts[i] >= threshold);
}

// segs: host array of nseg segments; out: bool[n_out] (n_out >= n) on the
// device; counts: int32[n + 1] scratch, used only when threshold > 1.
extern "C" int rt_t_occurrence(const SegDesc* segs, int nseg, int64_t n,
                               int64_t n_out, int threshold, int* counts,
                               uint8_t* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int threads = 256;
  const bool count = threshold > 1;
  cudaError_t e = count
      ? cudaMemsetAsync(counts, 0, sizeof(int) * (n + 1), s)
      : cudaMemsetAsync(out, 0, n_out, s);
  if (e != cudaSuccess) return static_cast<int>(e);
  for (int g = 0; g < nseg; g += MAX_SEGS) {
    SegTable t;
    t.n = nseg - g < MAX_SEGS ? nseg - g : MAX_SEGS;
    t.first[0] = 0;
    for (int j = 0; j < t.n; ++j) {
      t.pos[j] = segs[g + j].pos + segs[g + j].start;
      t.offset[j] = segs[g + j].offset;
      t.first[j + 1] = t.first[j] + segs[g + j].count;
    }
    if (t.first[t.n] == 0) continue;
    tocc_scatter_kernel<<<grid_for(t.first[t.n], threads, 132 * 16),
                          threads, 0, s>>>(t, n, out,
                                           count ? counts : nullptr);
  }
  if (count)
    tocc_threshold_kernel<<<grid_for(n_out, threads, 132 * 16), threads, 0,
                            s>>>(counts, n, threshold, out, n_out);
  return static_cast<int>(cudaGetLastError());
}
