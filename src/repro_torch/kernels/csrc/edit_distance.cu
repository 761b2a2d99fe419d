// K5 edit_distances: min(levenshtein(s, q), cap) per candidate string s.
//
// Replaces the TPU kernel repro/kernels/fuzzy_ops.py:_ed_kernel (host
// wrapper _ed_pallas).  The TPU version runs the DP one query character
// at a time over an [8, Lp] f32 block of candidates, turning the in-row
// recurrence into a log-step cumulative min of m[j] - j so that every step
// is dense vector arithmetic.  On the H100 a thread runs the plain scalar
// recurrence instead: one thread per candidate, one DP row over the query
// (m + 1 cells) updated once per candidate character, each cell saturated
// at cap = d + 1 (cells beyond the band can only yield answers > d, so the
// <= d decision stays exact and the result is min(ed, d + 1)).
//
// Bound: operations.  L * m cell updates of a few integer min/adds each,
// against 4 bytes read per candidate character.  The DP row lives in
// shared memory, laid out [cell][thread] so the 32 lanes of a warp touch
// 32 consecutive words (no bank conflicts); a query longer than
// ED_SMEM_ROW - 1 characters takes a device scratch buffer [cell][string]
// instead (coalesced the same way), so no length is refused.  Query
// characters are read by every lane at one address (a broadcast).  The
// candidate matrix is row-major [B, Lp], so each lane walks its own row:
// the loads are strided across the warp and served from L1 after the
// first touch of each 128-byte line.
#include "common.cuh"

#define ED_THREADS 128
#define ED_SMEM_ROW 64    // mirrored by _ED_SMEM_ROW in kernels/fuzzy_ops.py

__global__ void edit_distance_kernel(const int32_t* cand,
                                     const int64_t* lens, int64_t B,
                                     int64_t lp, const int32_t* q, int m,
                                     int cap, int* scratch, int64_t* out) {
  extern __shared__ int smem[];
  const int64_t b = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (b >= B) return;
  int* row;
  int64_t stride;
  if (scratch) { row = scratch + b; stride = B; }
  else { row = smem + threadIdx.x; stride = blockDim.x; }
  for (int j = 0; j <= m; ++j) row[j * stride] = j < cap ? j : cap;
  const int64_t len = lens[b] < lp ? lens[b] : lp;
  const int32_t* s = cand + b * lp;
  for (int64_t i = 1; i <= len; ++i) {
    const int32_t c = s[i - 1];
    int diag = row[0];
    int left = i < cap ? static_cast<int>(i) : cap;
    row[0] = left;
    for (int j = 1; j <= m; ++j) {
      const int up = row[j * stride];
      int v = (up < left ? up : left) + 1;
      const int sub = diag + (c != q[j - 1]);
      v = sub < v ? sub : v;
      v = v < cap ? v : cap;
      row[j * stride] = v;
      diag = up;
      left = v;
    }
  }
  out[b] = row[m * stride];
}

// cand: int32 [B, lp] code points; lens: int64 [B]; q: int32 [>= m] query
// code points; scratch: int32 [(m + 1) * B] when m + 1 > ED_SMEM_ROW, else
// null; out: int64 [B].
extern "C" int rt_edit_distance(const int32_t* cand, const int64_t* lens,
                                int64_t B, int64_t lp, const int32_t* q,
                                int m, int cap, int* scratch, int64_t* out,
                                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (m + 1 > ED_SMEM_ROW && scratch == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t blocks = (B + ED_THREADS - 1) / ED_THREADS;
  const size_t smem = scratch ? 0 : sizeof(int) * ED_THREADS * (m + 1);
  edit_distance_kernel<<<static_cast<unsigned>(blocks), ED_THREADS, smem,
                         s>>>(cand, lens, B, lp, q, m, cap,
                              scratch, out);
  return static_cast<int>(cudaGetLastError());
}
