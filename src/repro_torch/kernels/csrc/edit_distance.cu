// K5 edit_distances: min(levenshtein(s, q), cap) per candidate string s.
//
// Replaces the TPU kernel repro/kernels/fuzzy_ops.py:_ed_kernel (host
// wrapper _ed_pallas).  The TPU version runs the DP one query character
// at a time over an [8, Lp] f32 block of candidates, turning the in-row
// recurrence into a log-step cumulative min of m[j] - j so that every step
// is dense vector arithmetic.  On the H100 one thread takes one candidate.
//
// Queries of up to 64 code points (the path's has 15) run Myers'
// bit-parallel recurrence in Hyyrö's form for the global distance: the
// query's DP column lives in two machine words of vertical +1 / -1 deltas
// (one 32-bit word up to m = 32, one 64-bit word up to 64), and each
// candidate character updates the whole column in a fixed chain of about
// 17 integer operations, whatever m is, with the distance tracked at the
// column's last row.  The chain is exact, and the result is clamped once
// at the end: min(ed, cap) is the function the saturating DP computes.
// The query's match masks (Peq) are built once a block in shared memory:
// a direct table for code points below 256 and an open-addressing table
// (128 slots, at most 64 keys) for the rest, so a non-Latin-1 character
// costs a probe or two.  Candidate rows are read as 16-byte vectors, up
// to 32 characters in flight a thread, when the row width is a multiple
// of 4 and the matrix is 16-byte aligned; the row's first 32 code points
// are in flight while the masks are built, and a chunk's masks are
// looked up before its recurrence runs.
//
// Longer queries run the plain DP: one DP row of m + 1 cells a candidate,
// updated once a candidate character, in a device scratch buffer laid out
// [cell][candidate] (32 lanes touch 32 consecutive words), each cell
// saturated at cap (cells past the band can only give answers above d).
//
// Bound: bytes at m <= 64.  4 bytes a candidate character, 8 of length
// and 8 of result a candidate, against ~17 integer operations a character;
// the DP's m cell updates a character make longer queries bound by
// operations.
#include "common.cuh"

#define ED_THREADS 256
#define ED_BITS 64          // longest bit-parallel query (_ED_BITS in
                            // kernels/fuzzy_ops.py)
#define ED_LO 256           // code points with a direct Peq entry
#define ED_HASH 128         // open-addressing slots for the others
#define ED_CHUNK 8          // 16-byte vectors a thread loads at once

template <typename W>
struct Peq {
  W lo[ED_LO];
  int32_t key[ED_HASH];     // -1: empty (code points are non-negative)
  W val[ED_HASH];
};

__device__ __forceinline__ unsigned ed_hash(int32_t c) {
  return (static_cast<unsigned>(c) * 2654435761u) >> (32 - 7);
}

// The direct table's entry for c's low byte (right when c < ED_LO)
template <typename W>
__device__ __forceinline__ W peq_lo(const Peq<W>& t, int32_t c) {
#ifdef ED_PROBE_NO_PEQ               // scripts/probes: no table
  return static_cast<W>(c);
#endif
  return t.lo[c & (ED_LO - 1)];
}

template <typename W>
__device__ __forceinline__ W peq_of(const Peq<W>& t, int32_t c) {
#ifdef ED_PROBE_NO_PEQ               // scripts/probes: no table
  return static_cast<W>(c);
#endif
  if (static_cast<unsigned>(c) < ED_LO) return t.lo[c];
  for (unsigned h = ed_hash(c);; h = (h + 1) & (ED_HASH - 1)) {
    const int32_t k = t.key[h];
    if (k == c) return t.val[h];
    if (k < 0) return 0;
  }
}

// One candidate character, whose match mask is eq: the column's deltas
// (pv, mv) and the distance at its last row (score) after it.
template <typename W>
__device__ __forceinline__ void ed_step(W eq, W top, W& pv, W& mv,
                                        int& score) {
#ifdef ED_PROBE_NO_DP                // scripts/probes: the lookups only
  score += static_cast<int>(eq & 1);
  return;
#endif
  const W xv = eq | mv;
  const W xh = (((eq & pv) + pv) ^ pv) | eq;
  W ph = mv | ~(xh | pv);
  W mh = pv & xh;
  score += ((ph & top) != 0) - ((mh & top) != 0);
  ph = (ph << 1) | 1;           // the top row D[0][j] = j grows by one
  mh <<= 1;
  pv = mh | ~(xv | ph);
  mv = ph & xv;
}

template <typename W>
__global__ void __launch_bounds__(ED_THREADS)
edit_distance_bits_kernel(const int32_t* cand, const int64_t* lens,
                          int64_t B, int64_t lp, const int32_t* q, int m,
                          int cap, int vec, int64_t* out) {
  __shared__ Peq<W> t;
  __shared__ int32_t qs[ED_BITS];
  const int64_t b = static_cast<int64_t>(blockIdx.x) * ED_THREADS +
                    threadIdx.x;
  const bool live = b < B;
  // the candidate's length and the query load together; the row's first
  // 32 code points load while the block builds the query's masks
  int64_t len = live ? __ldg(lens + b) : 0;
  if (threadIdx.x < m) qs[threadIdx.x] = q[threadIdx.x];
  for (int i = threadIdx.x; i < ED_LO; i += ED_THREADS) t.lo[i] = 0;
  for (int i = threadIdx.x; i < ED_HASH; i += ED_THREADS) t.key[i] = -1;
  __syncthreads();
  len = len < lp ? len : lp;
  len = len < 0 ? 0 : len;
  const int32_t* s = cand + b * lp;
  const int4* s4 = reinterpret_cast<const int4*>(s);
  int4 v[ED_CHUNK];
#pragma unroll
  for (int u = 0; u < ED_CHUNK; ++u)
    v[u] = vec && 4 * u < len ? __ldg(s4 + u) : make_int4(0, 0, 0, 0);
#ifndef ED_PROBE_NO_PEQ
  if (threadIdx.x < m) {         // the first occurrence of a code point
    const int32_t c = qs[threadIdx.x];
    W mask = 0;
    bool first = true;
    for (int k = 0; k < m; ++k) {
      if (qs[k] == c) {
        mask |= W(1) << k;
        first = first && k >= static_cast<int>(threadIdx.x);
      }
    }
    if (first) {
      if (static_cast<unsigned>(c) < ED_LO) {
        t.lo[c] = mask;
      } else {
        unsigned h = ed_hash(c);
        while (atomicCAS(&t.key[h], -1, c) != -1) h = (h + 1) & (ED_HASH - 1);
        t.val[h] = mask;
      }
    }
  }
#endif
  __syncthreads();
  if (!live) return;
  if (m == 0) {
    out[b] = len < cap ? len : cap;
    return;
  }
  const W top = W(1) << (m - 1);
  W pv = ~W(0), mv = 0;
  int score = m;
  if (vec) {
    for (int64_t i0 = 0; i0 < len; i0 += 4 * ED_CHUNK) {
      if (i0 > 0) {
#pragma unroll
        for (int u = 0; u < ED_CHUNK; ++u)
          if (i0 + 4 * u < len) v[u] = __ldg(s4 + i0 / 4 + u);
      }
      // the chunk's masks first, all 32 direct-table loads issued back
      // to back (they do not wait on the recurrence); code points past
      // the table are looked up again in the hash
      W eq[4 * ED_CHUNK];
      bool wide = false;
#pragma unroll
      for (int u = 0; u < ED_CHUNK; ++u) {
        const int32_t c[4] = {v[u].x, v[u].y, v[u].z, v[u].w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          eq[4 * u + e] = peq_lo(t, c[e]);
          wide |= static_cast<unsigned>(c[e]) >= ED_LO;
        }
      }
      if (wide) {
#pragma unroll
        for (int u = 0; u < ED_CHUNK; ++u) {
          const int32_t c[4] = {v[u].x, v[u].y, v[u].z, v[u].w};
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (static_cast<unsigned>(c[e]) >= ED_LO)
              eq[4 * u + e] = peq_of(t, c[e]);
        }
      }
#pragma unroll
      for (int e = 0; e < 4 * ED_CHUNK; ++e)
        if (i0 + e < len) ed_step(eq[e], top, pv, mv, score);
    }
  } else {
    for (int64_t i = 0; i < len; ++i)
      ed_step(peq_of(t, __ldg(s + i)), top, pv, mv, score);
  }
  out[b] = score < cap ? score : cap;
}

// m > ED_BITS: the saturating DP, its rows in scratch [cell][candidate]
__global__ void edit_distance_dp_kernel(const int32_t* cand,
                                        const int64_t* lens, int64_t B,
                                        int64_t lp, const int32_t* q, int m,
                                        int cap, int* scratch,
                                        int64_t* out) {
  const int64_t b = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (b >= B) return;
  int* row = scratch + b;
  const int64_t stride = B;
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
// code points; scratch: int32 [(m + 1) * B] when m > ED_BITS, else null;
// vec: lp % 4 == 0 and cand 16-byte aligned; out: int64 [B].
extern "C" int rt_edit_distance(const int32_t* cand, const int64_t* lens,
                                int64_t B, int64_t lp, const int32_t* q,
                                int m, int cap, int vec, int* scratch,
                                int64_t* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned blocks =
      static_cast<unsigned>((B + ED_THREADS - 1) / ED_THREADS);
  if (m <= 32) {
    edit_distance_bits_kernel<uint32_t><<<blocks, ED_THREADS, 0, s>>>(
        cand, lens, B, lp, q, m, cap, vec, out);
  } else if (m <= ED_BITS) {
    edit_distance_bits_kernel<uint64_t><<<blocks, ED_THREADS, 0, s>>>(
        cand, lens, B, lp, q, m, cap, vec, out);
  } else {
    if (scratch == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    edit_distance_dp_kernel<<<blocks, ED_THREADS, 0, s>>>(
        cand, lens, B, lp, q, m, cap, scratch, out);
  }
  return static_cast<int>(cudaGetLastError());
}
