// K8 flash attention, backward: the gradients dq, dk, dv of K8's forward
// (blockwise GQA softmax attention, causal with a query offset), given the
// output o, its gradient do and the forward's row logsumexp lse.
//
// Replaces the reference's backward of its Pallas kernel,
// repro/kernels/ops.py:_flash_vjp_bwd (jax.vjp of the plain oracle
// ref.flash_attention_ref), which materializes the [Sq, Skv] scores and
// probabilities of every head.  FlashAttention-2's recomputation instead,
// tile by tile, with the scale s = 1 / sqrt(hd):
//   P  = exp(s Q K^T - lse)        (0 where masked)
//   dV = P^T dO,  dP = dO V^T,  dS = P (dP - D),  D = rowsum(dO o)
//   dQ = s dS K,  dK = s dS^T Q
// in three launches:
//   flash_bwd_dsum_kernel  D [B, H, Sq], one warp a row;
//   flash_bwd_dkdv_kernel  one CTA a (batch, KV head, 64-key tile): K and V
//                          stay in shared memory while it walks the G query
//                          heads that read that KV head and, for each, the
//                          query tiles that see the key tile, accumulating
//                          dK and dV in registers, so the GQA sum runs in the
//                          block and in a fixed order;
//   flash_bwd_dq_kernel    one CTA a (batch, query head, 64-query tile),
//                          walking the key tiles it sees, dQ in registers.
// No atomics: every sum has an order fixed by the shapes, so a launch
// gives the same bits every run.
//
// First design: float32 FMA outside the tensor cores.  A CTA is 256
// threads, a 16 x 16 grid; thread (ty, tx) owns rows ty + 16 a and
// columns tx + 16 b of every tile product, reading its operands from
// shared memory rows padded to an odd stride (hd + 1, 65 floats), so the
// 16 columns of a half-warp fall in 16 banks.  Inputs are float32 or
// bfloat16 (converted on the way into shared memory), sums are float32 and
// the gradients are written in the inputs' type.  q, k, v, o, do and the
// gradients are contiguous [B, S, heads, hd].
//
// Bound: operations.  10 hd flops per visible (query, key) pair and head
// (S recomputed, dP, dV, dK, dQ: 2.5 times the forward's 4 hd).  This
// design spends 14 hd (the two kernels both recompute S and dP) at the
// FP32 rate.
#include "model_common.cuh"

namespace {
constexpr int BT = 64;                  // queries or keys a tile
constexpr int BNT = 256;                // threads: a 16 x 16 grid
constexpr int RW = BT / 16;             // rows (columns) a thread of a tile

template <int HD>
struct BCfg {
  static constexpr int LD = HD + 1;     // row stride of a [BT, HD] tile
  static constexpr int LP = BT + 1;     // row stride of a [BT, BT] tile
  static constexpr int TILE = BT * LD;  // floats
  static constexpr int SQ = BT * LP;
  static constexpr int NE = HD / 16;    // columns a thread of a [BT, HD]
  static constexpr int SMEM_DKDV = 4 * (4 * TILE + 2 * SQ + 2 * BT);
  static constexpr int SMEM_DQ = 4 * (4 * TILE + SQ + 2 * BT);
};

// rows [r0, r0 + BT) of head h of a contiguous [B, S, NH, HD] tensor into
// a [BT, LD] float32 tile, rows past S zero
template <typename T, int HD>
__device__ __forceinline__ void load_tile(float* dst, const T* src, int b,
                                          int S, int NH, int h, int r0) {
  constexpr int LD = HD + 1;
  for (int idx = threadIdx.x; idx < BT * HD; idx += BNT) {
    const int r = idx / HD, e = idx % HD, s = r0 + r;
    dst[r * LD + e] = s < S
        ? ld(src, ((static_cast<int64_t>(b) * S + s) * NH + h) * HD + e)
        : 0.f;
  }
}

// c[a][j] += sum over k < K of A(ty + 16 a, k) B(tx + 16 j, k), where
// A(m, k) = A[m sam + k sak] and B(n, k) = B[n sbn + k sbk]
template <int RA, int RB>
__device__ __forceinline__ void mac(float (&c)[RA][RB], const float* A,
                                    int sam, int sak, const float* B,
                                    int sbn, int sbk, int K, int ty,
                                    int tx) {
#pragma unroll 4
  for (int k = 0; k < K; ++k) {
    float a[RA], bv[RB];
#pragma unroll
    for (int i = 0; i < RA; ++i) a[i] = A[(ty + 16 * i) * sam + k * sak];
#pragma unroll
    for (int j = 0; j < RB; ++j) bv[j] = B[(tx + 16 * j) * sbn + k * sbk];
#pragma unroll
    for (int i = 0; i < RA; ++i)
#pragma unroll
      for (int j = 0; j < RB; ++j) c[i][j] = fmaf(a[i], bv[j], c[i][j]);
  }
}

template <int RA, int RB>
__device__ __forceinline__ void zero(float (&c)[RA][RB]) {
#pragma unroll
  for (int i = 0; i < RA; ++i)
#pragma unroll
    for (int j = 0; j < RB; ++j) c[i][j] = 0.f;
}

// write rows r0 + ty + 16 a (< S) of a [BT, HD] accumulator, times mul,
// to head h of a contiguous [B, S, NH, HD] tensor
template <typename T, int HD>
__device__ __forceinline__ void store_tile(T* dst, const float (&c)[RW][HD / 16],
                                           float mul, int b, int S, int NH,
                                           int h, int r0, int ty, int tx) {
#pragma unroll
  for (int a = 0; a < RW; ++a) {
    const int s = r0 + ty + 16 * a;
    if (s >= S) continue;
    const int64_t base = ((static_cast<int64_t>(b) * S + s) * NH + h) * HD;
#pragma unroll
    for (int j = 0; j < HD / 16; ++j) st(dst, base + tx + 16 * j, c[a][j] * mul);
  }
}

__device__ __forceinline__ bool visible(int i, int j, int Sq, int Skv,
                                        int causal, int q_offset) {
  return i < Sq && j < Skv && (!causal || j <= q_offset + i);
}
}  // namespace

// D[b, h, s] = sum over e of do[b, s, h, e] o[b, s, h, e]: one warp a row
template <typename T>
__global__ void flash_bwd_dsum_kernel(const T* __restrict__ o,
                                      const T* __restrict__ dout,
                                      float* __restrict__ dsum, int64_t rows,
                                      int H, int Sq, int hd) {
  const int64_t row = (static_cast<int64_t>(blockIdx.x) * blockDim.x +
                       threadIdx.x) / 32;
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  float acc = 0.f;
  for (int e = lane; e < hd; e += 32)
    acc = fmaf(ld(o, row * hd + e), ld(dout, row * hd + e), acc);
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) {
    const int h = static_cast<int>(row % H);
    const int64_t bs = row / H;              // b * Sq + s
    const int s = static_cast<int>(bs % Sq);
    const int64_t b = bs / Sq;
    dsum[(b * H + h) * Sq + s] = acc;
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(BNT, 1) flash_bwd_dkdv_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const T* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ dsum,
    T* __restrict__ dk, T* __restrict__ dv, int H, int KV, int Sq, int Skv,
    int causal, int q_offset, float scale) {
  using C = BCfg<HD>;
  constexpr int LD = C::LD, LP = C::LP, NE = C::NE;
  extern __shared__ float sm[];
  float* Ks = sm;
  float* Vs = Ks + C::TILE;
  float* Qs = Vs + C::TILE;
  float* dOs = Qs + C::TILE;
  float* Ps = dOs + C::TILE;
  float* dSs = Ps + C::SQ;
  float* Ls = dSs + C::SQ;
  float* Ds = Ls + BT;

  // key tiles of one (batch, KV head) adjacent, the first (which the most
  // query tiles see when causal) first
  const int nkt = (Skv + BT - 1) / BT;
  const int kt = blockIdx.x % nkt, rest = blockIdx.x / nkt;
  const int kh = rest % KV, b = rest / KV;
  const int k0 = kt * BT, G = H / KV;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;

  load_tile<T, HD>(Ks, k, b, Skv, KV, kh, k0);
  load_tile<T, HD>(Vs, v, b, Skv, KV, kh, k0);
  float dKa[RW][NE], dVa[RW][NE];
  zero(dKa);
  zero(dVa);
  // the first query that sees a key of the tile
  const int i_lo = causal ? max(0, k0 - q_offset) : 0;
  const int nqt = (Sq + BT - 1) / BT;
  for (int gi = 0; gi < G; ++gi) {
    const int h = kh * G + gi;
    const float* lrow = lse + (static_cast<int64_t>(b) * H + h) * Sq;
    const float* drow = dsum + (static_cast<int64_t>(b) * H + h) * Sq;
    for (int qt = i_lo / BT; qt < nqt; ++qt) {
      const int i0 = qt * BT;
      __syncthreads();                 // the last tile's operands are used
      load_tile<T, HD>(Qs, q, b, Sq, H, h, i0);
      load_tile<T, HD>(dOs, dout, b, Sq, H, h, i0);
      if (tid < BT) {
        const int i = i0 + tid;
        Ls[tid] = i < Sq ? lrow[i] : 0.f;
        Ds[tid] = i < Sq ? drow[i] : 0.f;
      }
      __syncthreads();
      float s[RW][RW], dp[RW][RW];
      zero(s);
      zero(dp);
      mac(s, Qs, LD, 1, Ks, LD, 1, HD, ty, tx);
      mac(dp, dOs, LD, 1, Vs, LD, 1, HD, ty, tx);
#pragma unroll
      for (int a = 0; a < RW; ++a)
#pragma unroll
        for (int c = 0; c < RW; ++c) {
          const int i = ty + 16 * a, j = tx + 16 * c;
          const float p =
              visible(i0 + i, k0 + j, Sq, Skv, causal, q_offset)
                  ? expf(s[a][c] * scale - Ls[i]) : 0.f;
          Ps[i * LP + j] = p;
          dSs[i * LP + j] = p * (dp[a][c] - Ds[i]);
        }
      __syncthreads();
      // dV[j][e] += sum_i P[i][j] dO[i][e]; dK[j][e] += sum_i dS[i][j] Q[i][e]
      mac(dVa, Ps, 1, LP, dOs, 1, LD, BT, ty, tx);
      mac(dKa, dSs, 1, LP, Qs, 1, LD, BT, ty, tx);
    }
  }
  store_tile<T, HD>(dk, dKa, scale, b, Skv, KV, kh, k0, ty, tx);
  store_tile<T, HD>(dv, dVa, 1.f, b, Skv, KV, kh, k0, ty, tx);
}

template <typename T, int HD>
__global__ void __launch_bounds__(BNT, 1) flash_bwd_dq_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const T* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ dsum,
    T* __restrict__ dq, int H, int KV, int Sq, int Skv, int causal,
    int q_offset, float scale) {
  using C = BCfg<HD>;
  constexpr int LD = C::LD, LP = C::LP, NE = C::NE;
  extern __shared__ float sm[];
  float* Qs = sm;
  float* dOs = Qs + C::TILE;
  float* Ks = dOs + C::TILE;
  float* Vs = Ks + C::TILE;
  float* dSs = Vs + C::TILE;
  float* Ls = dSs + C::SQ;
  float* Ds = Ls + BT;

  // query tiles of one (batch, head) adjacent, causal ones longest first
  const int nqt = (Sq + BT - 1) / BT;
  int qt = blockIdx.x % nqt;
  const int rest = blockIdx.x / nqt;
  if (causal) qt = nqt - 1 - qt;
  const int h = rest % H, b = rest / H;
  const int kh = h / (H / KV), i0 = qt * BT;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;

  load_tile<T, HD>(Qs, q, b, Sq, H, h, i0);
  load_tile<T, HD>(dOs, dout, b, Sq, H, h, i0);
  if (tid < BT) {
    const int i = i0 + tid;
    const int64_t row = (static_cast<int64_t>(b) * H + h) * Sq;
    Ls[tid] = i < Sq ? lse[row + i] : 0.f;
    Ds[tid] = i < Sq ? dsum[row + i] : 0.f;
  }
  const int last = min(i0 + BT, Sq);
  const int j_end = causal ? min(Skv, q_offset + last) : Skv;
  float dQa[RW][NE];
  zero(dQa);
  for (int j0 = 0; j0 < j_end; j0 += BT) {
    __syncthreads();                   // the last tile's operands are used
    load_tile<T, HD>(Ks, k, b, Skv, KV, kh, j0);
    load_tile<T, HD>(Vs, v, b, Skv, KV, kh, j0);
    __syncthreads();
    float s[RW][RW], dp[RW][RW];
    zero(s);
    zero(dp);
    mac(s, Qs, LD, 1, Ks, LD, 1, HD, ty, tx);
    mac(dp, dOs, LD, 1, Vs, LD, 1, HD, ty, tx);
#pragma unroll
    for (int a = 0; a < RW; ++a)
#pragma unroll
      for (int c = 0; c < RW; ++c) {
        const int i = ty + 16 * a, j = tx + 16 * c;
        const float p = visible(i0 + i, j0 + j, Sq, Skv, causal, q_offset)
            ? expf(s[a][c] * scale - Ls[i]) : 0.f;
        dSs[i * LP + j] = p * (dp[a][c] - Ds[i]);
      }
    __syncthreads();
    // dQ[i][e] += sum_j dS[i][j] K[j][e]
    mac(dQa, dSs, LP, 1, Ks, 1, LD, BT, ty, tx);
  }
  store_tile<T, HD>(dq, dQa, scale, b, Sq, H, h, i0, ty, tx);
}

namespace {
template <typename T, int HD>
int launch_bwd(const void* q, const void* k, const void* v, const void* o,
               const void* dout, const float* lse, float* dsum, void* dq,
               void* dk, void* dv, int B, int H, int KV, int Sq, int Skv,
               int causal, int q_offset, float scale, cudaStream_t s) {
  using C = BCfg<HD>;
  static int cap_kv = 48 * 1024, cap_q = 48 * 1024;
  cudaError_t e = allow_smem(flash_bwd_dkdv_kernel<T, HD>, C::SMEM_DKDV,
                             &cap_kv);
  if (e == cudaSuccess)
    e = allow_smem(flash_bwd_dq_kernel<T, HD>, C::SMEM_DQ, &cap_q);
  if (e != cudaSuccess) return static_cast<int>(e);
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* dot = static_cast<const T*>(dout);
  const int64_t rows = static_cast<int64_t>(B) * Sq * H;
  flash_bwd_dsum_kernel<T><<<static_cast<unsigned>((rows + 7) / 8), 256, 0,
                             s>>>(static_cast<const T*>(o), dot, dsum, rows,
                                  H, Sq, HD);
  const int64_t grid_kv =
      static_cast<int64_t>((Skv + BT - 1) / BT) * B * KV;
  flash_bwd_dkdv_kernel<T, HD><<<static_cast<unsigned>(grid_kv), BNT,
                                 C::SMEM_DKDV, s>>>(
      qt, kt, vt, dot, lse, dsum, static_cast<T*>(dk), static_cast<T*>(dv),
      H, KV, Sq, Skv, causal, q_offset, scale);
  const int64_t grid_q = static_cast<int64_t>((Sq + BT - 1) / BT) * B * H;
  flash_bwd_dq_kernel<T, HD><<<static_cast<unsigned>(grid_q), BNT,
                               C::SMEM_DQ, s>>>(
      qt, kt, vt, dot, lse, dsum, static_cast<T*>(dq), H, KV, Sq, Skv,
      causal, q_offset, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int bwd_by_hd(int hd, const void* q, const void* k, const void* v,
              const void* o, const void* dout, const float* lse, float* dsum,
              void* dq, void* dk, void* dv, int B, int H, int KV, int Sq,
              int Skv, int causal, int q_offset, float scale,
              cudaStream_t s) {
  switch (hd) {
    case 16: return launch_bwd<T, 16>(q, k, v, o, dout, lse, dsum, dq, dk,
                                      dv, B, H, KV, Sq, Skv, causal,
                                      q_offset, scale, s);
    case 32: return launch_bwd<T, 32>(q, k, v, o, dout, lse, dsum, dq, dk,
                                      dv, B, H, KV, Sq, Skv, causal,
                                      q_offset, scale, s);
    case 64: return launch_bwd<T, 64>(q, k, v, o, dout, lse, dsum, dq, dk,
                                      dv, B, H, KV, Sq, Skv, causal,
                                      q_offset, scale, s);
    case 128: return launch_bwd<T, 128>(q, k, v, o, dout, lse, dsum, dq, dk,
                                        dv, B, H, KV, Sq, Skv, causal,
                                        q_offset, scale, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
}  // namespace

// q, o, dout, dq: contiguous [B, Sq, H, hd]; k, v, dk, dv: contiguous
// [B, Skv, KV, hd]; all of type dt (float32 or bfloat16); lse: the
// forward's float32 [B, H, Sq]; dsum: float32 scratch [B, H, Sq].  Query i
// sits at position q_offset + i; causal: it sees keys j <= q_offset + i.
// hd is 16, 32, 64 or 128.
extern "C" int rt_flash_attention_bwd(const void* q, const void* k,
                                      const void* v, const void* o,
                                      const void* dout, const float* lse,
                                      float* dsum, void* dq, void* dk,
                                      void* dv, int dt, int B, int H, int KV,
                                      int Sq, int Skv, int hd, int causal,
                                      int q_offset, float scale,
                                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (KV < 1 || H % KV != 0 || Skv < 1 || (dt != MT_F32 && dt != MT_BF16))
    return static_cast<int>(cudaErrorInvalidValue);
  if (B < 1 || Sq < 1) return static_cast<int>(cudaSuccess);
  if (dt == MT_F32)
    return bwd_by_hd<float>(hd, q, k, v, o, dout, lse, dsum, dq, dk, dv, B,
                            H, KV, Sq, Skv, causal, q_offset, scale, s);
  return bwd_by_hd<__nv_bfloat16>(hd, q, k, v, o, dout, lse, dsum, dq, dk,
                                  dv, B, H, KV, Sq, Skv, causal, q_offset,
                                  scale, s);
}
