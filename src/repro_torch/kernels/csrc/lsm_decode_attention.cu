// K9 LSM decode attention: one decode token per sequence against ONE KV
// component (an LSM run of the tiered cache, or the whole flat cache),
// masked by valid_len, returning the un-normalized flash state
// (acc [B, H, hd], m [B, H], l [B, H], all float32) that components merge
// by the associative logsumexp merge (ref.merge_partials).
//
// Replaces the TPU kernel repro/kernels/lsm_decode_attention.py:_kernel
// (host wrapper decode_partial), whose grid (B, KV, kv blocks) streams the
// component's blocks in order with the state in VMEM scratch.  Here one
// CTA takes one (batch, KV head) and loops over 64-key tiles itself, so
// the G = H / KV query heads of that KV head share every K/V tile it
// loads (GQA read once, not G times).  Per tile:
//   * the K and V rows arrive as 16-byte vector loads issued one tile
//     ahead into registers (the next tile's loads are in flight while the
//     current one is computed), then go to shared memory as float32, K
//     rows padded by one word so the score loop's reads are
//     conflict-free;
//   * the G x 64 scores are one thread each, the hd-long dot product in
//     four independent chains;
//   * one warp per query head takes the tile's max and sum with shuffles
//     and updates that head's (m, l);
//   * the G x hd accumulators stay in registers (up to MAXA a thread:
//     column tid % hd of heads tid / hd + a * 256 / hd), so each key costs
//     one shared load of V and independent FMAs.
//
// Hazard (the reference masks p twice for it, lsm_decode_attention.py:55):
// a key at or past valid_len must give p = 0, not exp(NEG_INF - NEG_INF)
// = 1 while a head's running max is still NEG_INF.  This kernel never
// reads such keys at all: the tile loop stops at valid_len, and inside the
// last tile the missing keys get p = 0 explicitly.  An empty component
// (valid_len 0, an empty L1 slot) writes acc = 0, m = NEG_INF, l = 0,
// as the reference does.
//
// Bound: memory.  It reads the valid_len valid K and V rows once
// (2 * valid_len * hd elements per (b, KV head)) and q, and writes the
// state; 4 * G * hd flops per key.  One CTA per (b, KV head) leaves SMs
// idle when B * KV < 132 (64 CTAs in the serve phase): splitting the keys
// over more CTAs is a later PR's work.
#include "model_common.cuh"

namespace {
constexpr int BK = 64, NT = 256;
}  // namespace

template <typename T, int HD, int MAXA>
__global__ void __launch_bounds__(NT) decode_partial_kernel(
    const float* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, float* __restrict__ acc_out,
    float* __restrict__ m_out, float* __restrict__ l_out, int H, int KV,
    int64_t Sc, int n, float scale) {
  constexpr int VW = 16 / sizeof(T);            // elements per 16 bytes
  constexpr int VPR = HD / VW;                  // vectors per row
  constexpr int NVEC = BK * VPR;                // vectors per tile
  constexpr int PF = (NVEC + NT - 1) / NT;      // per thread
  constexpr int LD = HD + 1;
  constexpr int G_STEP = NT / HD;               // NT is a multiple of HD
  extern __shared__ float smem[];
  const int G = H / KV;
  float* Qs = smem;               // [G][HD]
  float* Ks = Qs + G * HD;        // [BK][LD]
  float* Vs = Ks + BK * LD;       // [BK][HD]
  float* Ss = Vs + BK * HD;       // [G][BK] scores, then probabilities
  float* Ms = Ss + G * BK;        // [G] running max
  float* Ls = Ms + G;             // [G] running sum
  float* Cs = Ls + G;             // [G] this tile's correction
  const int b = blockIdx.x / KV, kh = blockIdx.x % KV;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int64_t head0 = static_cast<int64_t>(b) * H + kh * G;
  const int64_t kst = static_cast<int64_t>(KV) * HD;   // between keys
  const T* kb = k + static_cast<int64_t>(b) * Sc * kst + kh * HD;
  const T* vb = v + static_cast<int64_t>(b) * Sc * kst + kh * HD;
  const int e_t = tid % HD, g_t = tid / HD;

  for (int i = tid; i < G * HD; i += NT) Qs[i] = q[head0 * HD + i] * scale;
  for (int g = tid; g < G; g += NT) {
    Ms[g] = NEG_INF_F;
    Ls[g] = 0.f;
  }
  float acc[MAXA];
#pragma unroll
  for (int a = 0; a < MAXA; ++a) acc[a] = 0.f;

  uint4 rk[PF], rv[PF];
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  auto fetch = [&](int c0) {
#pragma unroll
    for (int p = 0; p < PF; ++p) {
      const int vi = tid + p * NT, c = vi / VPR, ev = vi % VPR;
      const bool in = vi < NVEC && c0 + c < n;
      const int64_t off = (c0 + c) * kst + ev * VW;
      rk[p] = in ? *reinterpret_cast<const uint4*>(kb + off) : zero;
      rv[p] = in ? *reinterpret_cast<const uint4*>(vb + off) : zero;
    }
  };
  if (n > 0) fetch(0);

  for (int c0 = 0; c0 < n; c0 += BK) {
    const int nc = n - c0 < BK ? n - c0 : BK;
    __syncthreads();            // Qs / Ms written, or the last tile read
#pragma unroll
    for (int p = 0; p < PF; ++p) {
      const int vi = tid + p * NT, c = vi / VPR, e0 = (vi % VPR) * VW;
      if (vi < NVEC) {
        float f[VW];
        unpack(rk[p], f, T());
#pragma unroll
        for (int j = 0; j < VW; ++j) Ks[c * LD + e0 + j] = f[j];
        unpack(rv[p], f, T());
#pragma unroll
        for (int j = 0; j < VW; ++j) Vs[c * HD + e0 + j] = f[j];
      }
    }
    __syncthreads();
    if (c0 + BK < n) fetch(c0 + BK);             // in flight from here on
    for (int i = tid; i < G * BK; i += NT) {
      const int g = i / BK, c = i % BK;
      const float* qg = Qs + g * HD;
      const float* kc = Ks + c * LD;
      float s0 = 0.f, s1 = 0.f, s2 = 0.f, s3 = 0.f;
#pragma unroll 8
      for (int e = 0; e < HD; e += 4) {
        s0 = fmaf(qg[e], kc[e], s0);
        s1 = fmaf(qg[e + 1], kc[e + 1], s1);
        s2 = fmaf(qg[e + 2], kc[e + 2], s2);
        s3 = fmaf(qg[e + 3], kc[e + 3], s3);
      }
      Ss[i] = c < nc ? (s0 + s1) + (s2 + s3) : NEG_INF_F;
    }
    __syncthreads();
    for (int g = warp; g < G; g += NT / 32) {
      float mx = NEG_INF_F;
      for (int c = lane; c < BK; c += 32) mx = fmaxf(mx, Ss[g * BK + c]);
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_old = Ms[g], m_new = fmaxf(m_old, mx);
      float rs = 0.f;
      for (int c = lane; c < BK; c += 32) {
        const float p = c < nc ? expf(Ss[g * BK + c] - m_new) : 0.f;
        Ss[g * BK + c] = p;
        rs += p;
      }
      for (int off = 16; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      __syncwarp();
      if (lane == 0) {
        const float corr = expf(m_old - m_new);
        Cs[g] = corr;
        Ls[g] = Ls[g] * corr + rs;
        Ms[g] = m_new;
      }
    }
    __syncthreads();
#pragma unroll
    for (int a = 0; a < MAXA; ++a) {
      const int g = g_t + a * G_STEP;
      if (g < G) acc[a] *= Cs[g];
    }
    for (int c = 0; c < nc; ++c) {
      const float vv = Vs[c * HD + e_t];
#pragma unroll
      for (int a = 0; a < MAXA; ++a) {
        const int g = g_t + a * G_STEP;
        if (g < G) acc[a] = fmaf(Ss[g * BK + c], vv, acc[a]);
      }
    }
  }
  __syncthreads();
#pragma unroll
  for (int a = 0; a < MAXA; ++a) {
    const int g = g_t + a * G_STEP;
    if (g < G) acc_out[(head0 + g) * HD + e_t] = acc[a];
  }
  for (int g = tid; g < G; g += NT) {
    m_out[head0 + g] = Ms[g];
    l_out[head0 + g] = Ls[g];
  }
}

template <typename T, int HD, int MAXA>
static int launch(const float* q, const void* k, const void* v, float* acc,
                  float* m, float* l, int B, int H, int KV, int64_t Sc,
                  int n, float scale, cudaStream_t s) {
  static int cap = 48 * 1024;
  const int G = H / KV;
  const int bytes = static_cast<int>(sizeof(float)) *
                    (G * HD + BK * (HD + 1) + BK * HD + G * BK + 3 * G);
  cudaError_t e = allow_smem(decode_partial_kernel<T, HD, MAXA>, bytes, &cap);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (B * KV > 0)
    decode_partial_kernel<T, HD, MAXA><<<B * KV, NT, bytes, s>>>(
        q, static_cast<const T*>(k), static_cast<const T*>(v), acc, m, l, H,
        KV, Sc, n, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int HD>
static int by_width(const float* q, const void* k, const void* v,
                    float* acc, float* m, float* l, int B, int H, int KV,
                    int64_t Sc, int n, float scale, cudaStream_t s) {
  const int na = ((H / KV) * HD + NT - 1) / NT;   // accumulators a thread
  if (na <= 4)
    return launch<T, HD, 4>(q, k, v, acc, m, l, B, H, KV, Sc, n, scale, s);
  if (na <= 16)
    return launch<T, HD, 16>(q, k, v, acc, m, l, B, H, KV, Sc, n, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T>
static int by_hd(int hd, const float* q, const void* k, const void* v,
                 float* acc, float* m, float* l, int B, int H, int KV,
                 int64_t Sc, int n, float scale, cudaStream_t s) {
  switch (hd) {
    case 16: return by_width<T, 16>(q, k, v, acc, m, l, B, H, KV, Sc, n,
                                    scale, s);
    case 32: return by_width<T, 32>(q, k, v, acc, m, l, B, H, KV, Sc, n,
                                    scale, s);
    case 64: return by_width<T, 64>(q, k, v, acc, m, l, B, H, KV, Sc, n,
                                    scale, s);
    case 128: return by_width<T, 128>(q, k, v, acc, m, l, B, H, KV, Sc, n,
                                      scale, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// q: [B, H, hd] float32 (the reference casts q to float32 too); k, v:
// [B, Sc, KV, hd] of type dt, 16-byte aligned; all contiguous.  acc:
// [B, H, hd], m, l: [B, H] float32.  Keys [0, n) are valid (0 <= n <= Sc).
// hd is 16, 32, 64 or 128 and (H / KV) * hd <= 16 * 256.
extern "C" int rt_decode_partial(const float* q, const void* k,
                                 const void* v, int dt, float* acc,
                                 float* m, float* l, int B, int H, int KV,
                                 int hd, int64_t Sc, int n, float scale,
                                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dt == MT_F32)
    return by_hd<float>(hd, q, k, v, acc, m, l, B, H, KV, Sc, n, scale, s);
  if (dt == MT_BF16)
    return by_hd<__nv_bfloat16>(hd, q, k, v, acc, m, l, B, H, KV, Sc, n,
                                scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
