// K4 t_occurrence_mask: rows whose posting-position hit count reaches T.
//
// Replaces the TPU kernel repro/kernels/fuzzy_ops.py:_tocc_kernel (host
// wrapper _tocc_pallas), an O(n * m) compare loop over f32 row ids.  Here
// the hits scatter: one thread per posting position.  At T = 1 (every
// secondary-index candidate bitmap) a hit stores true directly; at T > 1
// an int32 count array of n + 1 entries takes integer atomicAdds (order-
// independent, so the result is exact) and a second pass writes
// count >= T.  Positions arrive as segments of device-resident posting
// arrays (pointer, start, count, row offset), so an index probe over
// resident postings ships nothing host -> device.
//
// Bound: memory.  8 bytes read per position plus one scattered byte (or
// 4-byte atomic) write, and n bytes of mask written.  The scattered
// writes are the cost; positions within one posting segment are sorted,
// so neighbouring threads mostly touch neighbouring mask bytes.
#include "common.cuh"

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
