// K8 flash attention, forward: blockwise GQA softmax attention with the
// online (m, l, acc) state, causal or not, masked by a query offset and a
// valid key length.  Query head h reads KV head h / G (G = H / KV); the
// repeated KV heads are never materialized.
//
// Replaces the TPU kernel repro/kernels/flash_attention.py:_kernel (host
// wrapper flash_attention_fwd), whose grid (B*H, q blocks, kv blocks)
// walks the kv blocks in order and carries (m, l, acc) in VMEM scratch
// between grid steps.  On the H100 blocks run in parallel and in no
// order, so one CTA takes one (batch, head, 64-query tile) and an
// in-CTA loop over 64-key tiles takes the place of the sequential grid
// axis; the state stays in registers throughout.
//
//   * The query tile (pre-scaled by 1/sqrt(hd)), the key tile, the value
//     tile and the probability tile sit in shared memory as float32, each
//     row padded by one word, so that every read below is conflict-free:
//     a warp reads one query row (broadcast) against 16 consecutive keys.
//   * 256 threads: thread (tr, tc) = (tid / 16, tid % 16) owns query rows
//     tr + 16 i (i < 4); it computes the scores of those rows against keys
//     tc + 16 j (j < 4) and the output columns tc + 16 jj (jj < hd / 16).
//     A row's 16 owners are 16 lanes of one warp, so its max and sum are
//     xor-shuffle butterflies (every lane ends with the same bits).
//   * Masked scores are NEG_INF and their probabilities are set to 0
//     explicitly, so a tile with no visible key adds nothing even while
//     the running max is still NEG_INF.  A causal tile loop stops at the
//     last key the tile's last query sees (about half the work); keys at
//     or past the valid length are never read.
//
// Bound: operations.  4 * Sq * Skv * hd flops per head (half with causal
// masking) against (q + k + v + out) bytes; in this first version the
// products run on the float32 CUDA cores (no TF32, no wgmma), 16 FMAs per
// 8 shared-memory loads, so shared-memory bandwidth, not the FMA rate,
// is what it reaches.
#include "model_common.cuh"

namespace {
constexpr int BQ = 64, BK = 64, NT = 256, PLD = BK + 1;

template <int HD>
constexpr int smem_floats() {
  return (BQ + 2 * BK) * (HD + 1) + BQ * PLD;
}
}  // namespace

template <typename T, int HD>
__global__ void __launch_bounds__(NT, 2) flash_fwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, T* __restrict__ o, int H, int KV, int Sq,
    int kv_len, int nq, int64_t qsb, int64_t qss, int64_t qsh, int64_t ksb,
    int64_t kss, int64_t ksh, int64_t osb, int64_t oss, int64_t osh,
    int causal, int q_offset, float scale) {
  constexpr int LD = HD + 1, NJ = HD / 16;
  extern __shared__ float smem[];
  float* Qs = smem;               // [BQ][LD]
  float* Ks = Qs + BQ * LD;       // [BK][LD]
  float* Vs = Ks + BK * LD;       // [BK][LD]
  float* Ps = Vs + BK * LD;       // [BQ][PLD]
  const int tid = threadIdx.x, tr = tid >> 4, tc = tid & 15;
  const int qt = blockIdx.x % nq;
  const int bh = blockIdx.x / nq;
  const int b = bh / H, h = bh % H;
  const int kh = h / (H / KV);
  const int q0 = qt * BQ;
  const T* qb = q + b * qsb + h * qsh;
  const T* kb = k + b * ksb + kh * ksh;
  const T* vb = v + b * ksb + kh * ksh;

  for (int i = tid; i < BQ * HD; i += NT) {
    const int r = i / HD, e = i % HD, s = q0 + r;
    Qs[r * LD + e] = s < Sq ? ld(qb, s * qss + e) * scale : 0.f;
  }
  float m[4], l[4], acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF_F;
    l[i] = 0.f;
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj) acc[i][jj] = 0.f;
  }
  int kv_end = kv_len;
  if (causal) {
    const int last = q0 + BQ < Sq ? q0 + BQ : Sq;      // rows [q0, last)
    const int lim = q_offset + last;                    // keys < lim seen
    kv_end = lim < kv_end ? lim : kv_end;
  }
  for (int c0 = 0; c0 < kv_end; c0 += BK) {
    __syncthreads();            // the previous tile's Ks, Vs, Ps are read
    for (int i = tid; i < BK * HD; i += NT) {
      const int c = i / HD, e = i % HD, s = c0 + c;
      const bool in = s < kv_len;
      Ks[c * LD + e] = in ? ld(kb, s * kss + e) : 0.f;
      Vs[c * LD + e] = in ? ld(vb, s * kss + e) : 0.f;
    }
    __syncthreads();
    float sc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
#pragma unroll 4
    for (int e = 0; e < HD; ++e) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qs[(tr + 16 * i) * LD + e];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = Ks[(tc + 16 * j) * LD + e];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sc[i][j] = fmaf(qv[i], kv[j], sc[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q_offset + q0 + tr + 16 * i;
      bool ok[4];
      float mx = NEG_INF_F;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kp = c0 + tc + 16 * j;
        ok[j] = kp < kv_len && (!causal || kp <= qpos);
        sc[i][j] = ok[j] ? sc[i][j] : NEG_INF_F;
        mx = fmaxf(mx, sc[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = ok[j] ? expf(sc[i][j] - m_new) : 0.f;
        Ps[(tr + 16 * i) * PLD + tc + 16 * j] = p;
        rs += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      const float corr = expf(m[i] - m_new);
      l[i] = l[i] * corr + rs;
      m[i] = m_new;
#pragma unroll
      for (int jj = 0; jj < NJ; ++jj) acc[i][jj] *= corr;
    }
    __syncthreads();
    const int nc = kv_end - c0 < BK ? kv_end - c0 : BK;  // p = 0 past it
    for (int c = 0; c < nc; ++c) {
      float pv[4], vv[NJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = Ps[(tr + 16 * i) * PLD + c];
#pragma unroll
      for (int jj = 0; jj < NJ; ++jj) vv[jj] = Vs[c * LD + tc + 16 * jj];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jj = 0; jj < NJ; ++jj)
          acc[i][jj] = fmaf(pv[i], vv[jj], acc[i][jj]);
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int s = q0 + tr + 16 * i;
    if (s >= Sq) continue;
    const float den = fmaxf(l[i], 1e-20f);
    T* orow = o + b * osb + s * oss + h * osh;
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj) st(orow, tc + 16 * jj, acc[i][jj] / den);
  }
}

template <typename T, int HD>
static int launch(const void* q, const void* k, const void* v, void* o,
                  int B, int H, int KV, int Sq, int kv_len,
                  const int64_t* qst, const int64_t* kst, const int64_t* ost,
                  int causal, int q_offset, float scale, cudaStream_t s) {
  static int cap = 48 * 1024;
  const int bytes = smem_floats<HD>() * static_cast<int>(sizeof(float));
  cudaError_t e = allow_smem(flash_fwd_kernel<T, HD>, bytes, &cap);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int nq = (Sq + BQ - 1) / BQ;
  const int64_t grid = static_cast<int64_t>(nq) * B * H;
  if (grid > 0)
    flash_fwd_kernel<T, HD><<<static_cast<unsigned>(grid), NT, bytes, s>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<T*>(o), H, KV, Sq, kv_len, nq,
        qst[0], qst[1], qst[2], kst[0], kst[1], kst[2], ost[0], ost[1],
        ost[2], causal, q_offset, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
static int by_hd(int hd, const void* q, const void* k, const void* v,
                 void* o, int B, int H, int KV, int Sq, int kv_len,
                 const int64_t* qst, const int64_t* kst, const int64_t* ost,
                 int causal, int q_offset, float scale, cudaStream_t s) {
  switch (hd) {
    case 16: return launch<T, 16>(q, k, v, o, B, H, KV, Sq, kv_len, qst, kst,
                                  ost, causal, q_offset, scale, s);
    case 32: return launch<T, 32>(q, k, v, o, B, H, KV, Sq, kv_len, qst, kst,
                                  ost, causal, q_offset, scale, s);
    case 64: return launch<T, 64>(q, k, v, o, B, H, KV, Sq, kv_len, qst, kst,
                                  ost, causal, q_offset, scale, s);
    case 128: return launch<T, 128>(q, k, v, o, B, H, KV, Sq, kv_len, qst,
                                    kst, ost, causal, q_offset, scale, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// q: B x Sq x H x hd elements, element (b, s, h, e) at
//    b * qst[0] + s * qst[1] + h * qst[2] + e (unit stride along e);
// k, v: B x Skv x KV x hd with the strides kst (the same for both); keys
//    at or past kv_len are neither read nor seen;
// o: like q, strides ost, of q's type.  hd is 16, 32, 64 or 128.
extern "C" int rt_flash_attention(const void* q, const void* k,
                                  const void* v, void* o, int dt, int B,
                                  int H, int KV, int Sq, int kv_len, int hd,
                                  const int64_t* qst, const int64_t* kst,
                                  const int64_t* ost, int causal,
                                  int q_offset, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dt == MT_F32)
    return by_hd<float>(hd, q, k, v, o, B, H, KV, Sq, kv_len, qst, kst, ost,
                        causal, q_offset, scale, s);
  if (dt == MT_BF16)
    return by_hd<__nv_bfloat16>(hd, q, k, v, o, B, H, KV, Sq, kv_len, qst,
                                kst, ost, causal, q_offset, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
