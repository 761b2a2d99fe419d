// K8 flash attention, backward: the gradients dq, dk, dv of K8's forward
// (blockwise GQA softmax attention, causal with a query offset), given the
// output o, its gradient do and the forward's row logsumexp lse.
//
// No TPU kernel of its own: the reference has no pallas_call for the
// backward.  Its custom VJP, repro/kernels/ops.py:_flash_vjp_bwd (:86), is
// jax.vjp of the plain oracle ref.flash_attention_ref, which materializes
// the [Sq, Skv] scores and probabilities of every head.  FlashAttention-2's
// recomputation instead, tile by tile, with the scale s = 1 / sqrt(hd):
//   P  = exp(s Q K^T - lse)        (0 where masked)
//   dV = P^T dO,  dP = dO V^T,  dS = P (dP - D),  D = rowsum(dO o)
//   dQ = s dS K,  dK = s dS^T Q
// in three launches: D [B, H, Sq] (one warp a row); dK and dV, one CTA a
// (batch, KV head, key tile) that keeps its keys while it walks the G query
// heads reading that KV head and, for each, the query tiles that see the
// key tile, so the GQA sum runs in the block; dQ, one CTA a (batch, query
// head, query tile) walking the key tiles it sees.  No atomics: every sum
// has an order fixed by the shapes, so a launch gives the same bits every
// run.  q, k, v, o, do and the gradients are contiguous [B, S, heads, hd].
//
// Bound: operations.  10 hd flops per visible (query, key) pair and head
// (S recomputed, dP, dV, dK, dQ: 2.5 times the forward's 4 hd); at float32
// accuracy on the tensor cores (3xTF32) 3 times as many tensor-core flops,
// 2.08 ms at the train step's shape (q [2, 2048, 64, 128], k/v [2, 2048, 8,
// 128], causal) at 495 TFLOP/s dense TF32; 5.13 ms at float32's 67 TFLOP/s
// outside the tensor cores.  Both designs spend 14 hd: dQ's kernel
// recomputes S and dP, since summing dQ over key tiles in the dK/dV kernel
// would need atomics or [key tiles, Sq, H, hd] partials.
//
// float32 (flash_bwd_kv_wg_kernel, flash_bwd_q_wg_kernel): the products on the
// tensor cores as K8's forward computes them (tf32_wgmma.cuh: 3xTF32, small
// terms first, wgmma.mma_async .tf32 on 128-byte swizzled operands, TMA tiles,
// one 5-d load a tensor and tile bringing all of its 128-byte column blocks;
// warpgroup 1's first thread issues them, as warpgroup 1 waits for warpgroup 0
// at the hand-over anyway). wgmma .tf32 reads only K-major operands from shared
// memory, so each tile is split once into hi and lo in every layout its
// products read: as loaded (hd contiguous) where hd is the contraction,
// transposed (rows hd, a row's 8-row groups in the order 0 2 4 6 1 3 5 7, so
// that the accumulator layout of P^T, dS^T or dS is its A fragment) where the
// tile's rows are. A CTA is two warpgroups that share the tiles and split the
// products between them:
//   dK/dV (64 keys a CTA, 32-query tiles, 230 KB of shared memory at hd 128): K
//     lo and V lo stay in shared memory, K hi in warpgroup 0's registers and V
//     hi in warpgroup 1's (the A fragments of the hi.x terms); each Q and dO
//     tile arrives by TMA and is split as loaded and transposed. Warpgroup 0
//     computes S^T = K Q^T, P^T from it, and hands P^T to warpgroup 1 through
//     shared memory (the Q tile's buffers, which only warpgroup 0 reads);
//     warpgroup 1 computes dP^T = V dO^T and dS^T = P^T (dP^T - D). Then dV +=
//     P^T dO in warpgroup 0 and dK += dS^T Q in warpgroup 1 (m64n{hd}, A in
//     registers), each keeping one 64 x hd accumulator (64 registers a thread
//     at hd 128). Storing Q, dO, their transposes, each hi and lo, with K and V
//     resident, fills shared memory at 32 queries a tile; keeping K hi and V hi
//     in registers is what makes room for that tile.
//   dQ (64 queries a CTA, 32-key tiles, 209 KB): Q lo and dO lo stay in shared
//     memory, Q hi in warpgroup 0's registers and dO hi in warpgroup 1's; each
//     K and V tile arrives by TMA and is split as loaded, K also transposed.
//     Warpgroup 0 computes S = Q K^T and P, warpgroup 1 dP = dO V^T; each hands
//     its tile to the other and both form the same dS, then dQ += dS K with
//     each warpgroup taking half of hd's columns.
// P = exp2(S scale log2(e) - lse log2(e)) on the SFU, masked through an
// argument of -inf rather than a branch; each thread reads its queries' lse (or
// D) before the first products; the transposed split reads its rows rotated, so
// that a quarter-warp's 16-byte reads hit 8 distinct bank groups. A tile's
// splits run before its products (the tensor cores idle through them); the next
// tile's load runs under the products. Accumulating every tile of a CTA in one
// wgmma accumulator drifted: dK and dV off by 2.9e-5, 7.2e-5 and 1.3e-4 of
// their largest magnitude at Sq = Skv = 512, 1024 and 2048 (PERF.md), growing
// with the number of adds into it as a bias would, not as rounding to nearest
// does. So each accumulator covers at most FOLD_TILES tiles and is then folded
// into the thread's own rows of the output in global memory by float32 adds, in
// tile order.
//
// bfloat16 (flash_bwd_dkdv_kernel, flash_bwd_dq_kernel): the first design,
// float32 FMA outside the tensor cores, which no path of the port launches
// (the train step runs float32): a CTA is 256 threads, a 16 x 16 grid;
// thread (ty, tx) owns rows ty + 16 a and columns tx + 16 b of every tile
// product, reading its operands from shared memory rows padded to an odd
// stride (hd + 1), so the 16 columns of a half-warp fall in 16 banks; sums
// in float32, the gradients written in bfloat16.
#include "tf32_wgmma.cuh"

// ---------------------------------------------------------------------------
// bfloat16: the first design, float32 FMA outside the tensor cores
// ---------------------------------------------------------------------------
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


// ---------------------------------------------------------------------------
// float32: 3xTF32 on warpgroup MMAs (wgmma)
// ---------------------------------------------------------------------------
namespace {
constexpr int WT = 256;              // threads: two warpgroups
constexpr int WBAR = 64;             // the tile mbarrier, padded
constexpr int KROWS = 64;            // keys a dK/dV CTA
constexpr int QTW = 32;              // queries a dK/dV tile
constexpr int QROWS = 64;            // queries a dQ CTA
constexpr int KTW = 32;              // keys a dQ tile
constexpr int XCH = 16 * 128 * 4;    // a warpgroup's 32-wide accumulator
constexpr int FOLD_TILES = 32;       // tiles a wgmma accumulator takes
// the thread that issues the tiles' TMA loads: warpgroup 1's first, as
// warpgroup 1 waits for warpgroup 0 at the hand-over anyway (issued from
// thread 0 the loads held warpgroup 0's first products back)
constexpr int TMA_TID = 128;
constexpr float L2E = 1.4426950408889634f;   // log2(e)

// 2^x by the SFU (ex2.approx.ftz: ~2^-22 relative, 2^-inf = 0).  P is
// exp2(s scale log2(e) - lse log2(e)), masked by an argument of -inf and
// not by a branch: the masks and exps with branches took 1,300-1,900
// cycles a tile (scripts/probes/k8_bwd_clock.py, PERF.md)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}
__device__ __forceinline__ float masked(bool vis, float x) {
  return vis ? x : __uint_as_float(0xff800000u);   // -inf
}

template <int HD>
struct KvCfg {
  static constexpr int NB = (HD + 31) / 32;     // 128-byte column blocks
  static constexpr int KBLK = KROWS * SPAN;
  static constexpr int KS = NB * KBLK;          // a [64, hd] operand
  static constexpr int QBLK = QTW * SPAN;
  static constexpr int QS = NB * QBLK;          // a [32, hd] operand
  static constexpr int TS = HD * SPAN;          // a transposed [hd, 32] one
  // K lo, V lo; the raw Q and dO tiles; Q, dO as loaded, then transposed,
  // hi and lo each; the tile's lse and D
  static constexpr int O_KLO = 0, O_VLO = KS, O_RAW = 2 * KS,
                       O_QH = O_RAW + 2 * QS, O_QL = O_QH + QS,
                       O_DH = O_QL + QS, O_DL = O_DH + QS,
                       O_QTH = O_DL + QS, O_QTL = O_QTH + TS,
                       O_DTH = O_QTL + TS, O_DTL = O_DTH + TS,
                       O_STATS = O_DTL + TS;
  static constexpr int SMEM = WBAR + 1024 + O_STATS + 2 * QTW * 4;
  // K and V pass through the split buffers on their way in; P^T passes
  // through Q's (hi, then lo)
  static_assert(O_STATS - O_QH >= 2 * KS, "K, V staging fits");
  static_assert(2 * QS >= XCH, "the P^T hand-over fits");
  static_assert(SMEM <= 232448, "fits an SM");
};

template <int HD>
struct QCfg {
  static constexpr int NB = (HD + 31) / 32;
  static constexpr int KBLK = KTW * SPAN;
  static constexpr int KS = NB * KBLK;          // a [32, hd] operand
  static constexpr int QBLK = QROWS * SPAN;
  static constexpr int QS = NB * QBLK;          // a [64, hd] operand
  static constexpr int TS = HD * SPAN;          // K^T [hd, 32]
  // Q lo, dO lo; the raw K and V tiles; K, V as loaded, hi and lo each;
  // K^T hi and lo; P and dP handed over
  static constexpr int O_QLO = 0, O_DLO = QS, O_RAW = 2 * QS,
                       O_KH = O_RAW + 2 * KS, O_KL = O_KH + KS,
                       O_VH = O_KL + KS, O_VL = O_VH + KS,
                       O_KTH = O_VL + KS, O_KTL = O_KTH + TS,
                       O_XP = O_KTL + TS, O_XD = O_XP + XCH,
                       END = O_XD + XCH;
  static constexpr int SMEM = WBAR + 1024 + END;
  // Q hi and dO hi pass through the tile buffers on their way into
  // registers
  static_assert(END - O_RAW >= 2 * QS, "Q, dO hi staging fits");
  static_assert(SMEM <= 232448, "fits an SM");
};

// the TMA coordinates (row, head, batch) in the order of a map's dims
// (selects, not an indexed array, which went through local memory)
__device__ __forceinline__ int pick(int k, int row, int head, int b) {
  return k == 0 ? row : k == 1 ? head : b;
}
__device__ __forceinline__ void map_xyz(int perm, int row, int head, int b,
                                        int& x1, int& x2, int& x3) {
  x1 = pick(perm & 3, row, head, b);
  x2 = pick((perm >> 2) & 3, row, head, b);
  x3 = pick((perm >> 4) & 3, row, head, b);
}

// The tile at raw (a [rows, hd] operand as loaded, NB column blocks of
// blk_bytes) transposed and split: row d of hi / lo holds the tile's rows
// in 8-row groups, each group's rows in the order 0 2 4 6 1 3 5 7 (chunk
// 2 q8 + par holds rows 8 q8 + 2 e + par, e < 4).  Units u0, u0 + step, ...
// of NB 8 (rows / 8) 2.
template <int HD, int ROWS>
__device__ __forceinline__ void split_t(const unsigned char* raw,
                                        int blk_bytes, unsigned char* hi,
                                        unsigned char* lo, int u0,
                                        int step) {
  constexpr int NB = (HD + 31) / 32, NG = ROWS / 8;
  static_assert(NG == 4, "the read rotation takes 4 row groups");
  for (int i = u0; i < NB * 8 * NG * 2; i += step) {
    const int par = i & 1, q8 = (i >> 1) % NG;
    const int c = (i / (2 * NG)) % 8, blk = i / (16 * NG);
    // load e reads row 8 q8 + 2 ((e + q8) % 4) + par, so that the 8 lanes
    // of a quarter-warp (par and q8 vary) read 8 distinct 16-byte slots;
    // x[e] then holds row (e + q8) % 4 of the group, rotated back below
    uint4 x[4];
#pragma unroll
    for (int e = 0; e < 4; ++e)
      x[e] = *reinterpret_cast<const uint4*>(
          raw + blk * blk_bytes + swz(8 * q8 + 2 * ((e + q8) & 3) + par, c));
    if (q8 & 1) {
      const uint4 y = x[3];
      x[3] = x[2];
      x[2] = x[1];
      x[1] = x[0];
      x[0] = y;
    }
    if (q8 & 2) {
      uint4 y = x[0];
      x[0] = x[2];
      x[2] = y;
      y = x[1];
      x[1] = x[3];
      x[3] = y;
    }
    float v[4][4];                                 // [row e][hd f]
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      v[e][0] = __uint_as_float(x[e].x);
      v[e][1] = __uint_as_float(x[e].y);
      v[e][2] = __uint_as_float(x[e].z);
      v[e][3] = __uint_as_float(x[e].w);
    }
#pragma unroll
    for (int f = 0; f < 4; ++f) {
      const int d = blk * 32 + 4 * c + f;
      if (d >= HD) continue;
      const uint4 col = make_uint4(__float_as_uint(v[0][f]),
                                   __float_as_uint(v[1][f]),
                                   __float_as_uint(v[2][f]),
                                   __float_as_uint(v[3][f]));
      uint4 h, l;
      split4(col, h, l);
      const int off = swz(d, 2 * q8 + par);
      *reinterpret_cast<uint4*>(hi + off) = h;
      *reinterpret_cast<uint4*>(lo + off) = l;
    }
  }
}

// s (+)= A B^T over hd, 3xTF32 small terms first: A's lo from shared
// memory (alo, m64, column blocks of a_blk bytes) and its hi from
// registers (ah), B's hi and lo from shared memory (n32, blocks of b_blk)
template <int HD>
__device__ __forceinline__ void prod_hd(float* s, const unsigned char* alo,
                                        int a_blk, uint32_t (*ah)[4],
                                        const unsigned char* bhi,
                                        const unsigned char* blo,
                                        int b_blk) {
#pragma unroll
  for (int i = 0; i < 16; ++i) pin(s[i]);
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < HD / 8; ++kk) {
    const int ao = (kk / 4) * a_blk + (kk % 4) * 32;
    const int bo = (kk / 4) * b_blk + (kk % 4) * 32;
    wgmma_ss_n32(s, sw128(alo + ao), sw128(bhi + bo), kk > 0);
    wgmma_rs_n32(s, ah[kk], sw128(blo + bo));
    wgmma_rs_n32(s, ah[kk], sw128(bhi + bo));
  }
  wg_commit();
  wg_wait0();
#pragma unroll
  for (int i = 0; i < 16; ++i) pin(s[i]);
#pragma unroll
  for (int kk = 0; kk < HD / 8; ++kk)
#pragma unroll
    for (int f = 0; f < 4; ++f) pin(ah[kk][f]);
}

// acc += X B over 32 rows of the tile, 3xTF32 small terms first: X the
// m64n32 accumulator x (its n-tile kj the A fragment of k-step kj), B
// transposed in shared memory (thi, tlo: rows of N, the tile's 32 rows
// along them)
template <int N>
__device__ __forceinline__ void prod_t(float* acc, const float* x,
                                       const unsigned char* thi,
                                       const unsigned char* tlo) {
  uint32_t ph[4][4], pl[4][4];
#pragma unroll
  for (int kj = 0; kj < 4; ++kj) {
    split(x[4 * kj], ph[kj][0], pl[kj][0]);
    split(x[4 * kj + 2], ph[kj][1], pl[kj][1]);
    split(x[4 * kj + 1], ph[kj][2], pl[kj][2]);
    split(x[4 * kj + 3], ph[kj][3], pl[kj][3]);
  }
#pragma unroll
  for (int i = 0; i < N / 2; ++i) pin(acc[i]);
  wg_fence();
#pragma unroll
  for (int kj = 0; kj < 4; ++kj) {
    wgmma_rs<N>(acc, pl[kj], sw128(thi + kj * 32));
    wgmma_rs<N>(acc, ph[kj], sw128(tlo + kj * 32));
    wgmma_rs<N>(acc, ph[kj], sw128(thi + kj * 32));
  }
  wg_commit();
  wg_wait0();
#pragma unroll
  for (int kj = 0; kj < 4; ++kj)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      pin(ph[kj][i]);
      pin(pl[kj][i]);
    }
#pragma unroll
  for (int i = 0; i < N / 2; ++i) pin(acc[i]);
}

// Fold an m64nN accumulator into its rows of the output: the thread's
// acc[4 n + i] (row g + 8 (i >> 1) of its warp's 16, column 8 n + 2 t +
// (i & 1)) goes to rows[i >> 1] (null past the tensor's end) as
// out = (first ? 0 : out) + acc, times mul when last; acc is zeroed.
template <int N>
__device__ __forceinline__ void fold(float* acc, float* const* rows, int t,
                                     bool first, bool last, float mul) {
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    if (rows[rr] == nullptr) continue;
#pragma unroll
    for (int n = 0; n < N / 8; ++n) {
      float2* p = reinterpret_cast<float2*>(rows[rr] + 8 * n + 2 * t);
      float2 v = first ? make_float2(0.f, 0.f) : *p;
      v.x += acc[4 * n + 2 * rr];
      v.y += acc[4 * n + 2 * rr + 1];
      if (last) {
        v.x *= mul;
        v.y *= mul;
      }
      *p = v;
    }
  }
#pragma unroll
  for (int i = 0; i < N / 2; ++i) acc[i] = 0.f;
}
}  // namespace

// dK, dV: one CTA a (batch, KV head, 64-key tile); tk, tv tensor maps of
// k, v with 64-row boxes, tq, tdo of q, do with 32-row boxes.
template <int HD>
__global__ void __launch_bounds__(WT, 1) flash_bwd_kv_wg_kernel(
    const __grid_constant__ CUtensorMap tk,
    const __grid_constant__ CUtensorMap tv,
    const __grid_constant__ CUtensorMap tq,
    const __grid_constant__ CUtensorMap tdo, const float* __restrict__ lse,
    const float* __restrict__ dsum, float* __restrict__ dk,
    float* __restrict__ dv, int H, int KV, int Sq, int Skv, int causal,
    int q_offset, float scale, int perm_k, int perm_q) {
  using C = KvCfg<HD>;
  extern __shared__ __align__(16) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  const uint32_t base = smem_u32(smem + WBAR);
  unsigned char* sb = smem + WBAR + (((base + 1023u) & ~1023u) - base);
  float* stats = reinterpret_cast<float*>(sb + C::O_STATS);  // lse, D

  // key tiles of one (batch, KV head) adjacent, the first (which the most
  // query tiles see when causal) first
  const int nkt = (Skv + KROWS - 1) / KROWS;
  const int kt = blockIdx.x % nkt, rest = blockIdx.x / nkt;
  const int kh = rest % KV, b = rest / KV;
  const int k0 = kt * KROWS, G = H / KV;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wg = warp >> 2, wq = warp & 3, g = lane >> 2, t = lane & 3;
  const int tw = tid & 127;
  // tiles: for each of the G heads in order, the query tiles from the
  // first that sees key k0
  const int i_lo = causal ? max(0, k0 - q_offset) : 0;
  const int nqt = (Sq + QTW - 1) / QTW, qt0 = i_lo / QTW;
  const int per_head = qt0 < nqt ? nqt - qt0 : 0;
  const int ntiles = G * per_head;

  if (tid == 0) {
    mbar_init(full, 1);
    mbar_fence_init();
  }
  __syncthreads();

  // ---- K and V rows [k0, k0 + 64), through the split buffers: lo into
  // shared memory as loaded, hi into registers (warpgroup 0 K's, 1 V's) as
  // the A fragments of the hi.x terms (m64n32k8 layout a k-step: rows
  // 16 wq + g (+ 8), columns 8 kk + t (+ 4)) -------------------------------
  unsigned char* stage = sb + C::O_QH;
  if (tid == 0) {
    mbar_arrive_expect_tx(full, 2 * C::KS);
    int x1, x2, x3;
    map_xyz(perm_k, k0, kh, b, x1, x2, x3);
    tma_load_5d(stage, &tk, 0, x1, x2, x3, 0, full);
    tma_load_5d(stage + C::KS, &tv, 0, x1, x2, x3, 0, full);
  }
  mbar_wait(full, 0);
  for (int i = tid; i < 2 * C::KS / 16; i += WT) {  // K then V, as V follows K
    const uint4 x = *reinterpret_cast<const uint4*>(stage + 16 * i);
    uint4 hi, lo;
    split4(x, hi, lo);
    *reinterpret_cast<uint4*>(sb + C::O_KLO + 16 * i) = lo;
  }
  uint32_t ah[HD / 8][4];
  {
    const unsigned char* src = stage + wg * C::KS;
#pragma unroll
    for (int kk = 0; kk < HD / 8; ++kk)
#pragma unroll
      for (int f = 0; f < 4; ++f) {
        const int r = 16 * wq + g + 8 * (f & 1), d = 8 * kk + t + 4 * (f >> 1);
        ah[kk][f] = tf32(*reinterpret_cast<const float*>(
            src + (d / 32) * C::KBLK + swz(r, (d % 32) / 4) + 4 * (d % 4)));
      }
  }
  fence_async_smem();
  __syncthreads();                   // staging read out, K lo and V lo set

  auto issue = [&](int j) {          // tile j's Q and dO into the raw buffer
    const int h = kh * G + j / per_head, qt = qt0 + j % per_head;
    mbar_arrive_expect_tx(full, 2 * C::QS);
    int x1, x2, x3;
    map_xyz(perm_q, qt * QTW, h, b, x1, x2, x3);
    tma_load_5d(sb + C::O_RAW, &tq, 0, x1, x2, x3, 0, full);
    tma_load_5d(sb + C::O_RAW + C::QS, &tdo, 0, x1, x2, x3, 0, full);
  };
  if (tid == TMA_TID && ntiles > 0) issue(0);

  // warpgroup 0: dV, 1: dK; acc[4 n + i]: key k0 + 16 wq + g + 8 (i >> 1),
  // column 8 n + 2 t + (i & 1), folded into the output rows every
  // FOLD_TILES tiles
  float acc[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) acc[i] = 0.f;
  float* rows[2];
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int key = k0 + 16 * wq + g + 8 * rr;
    rows[rr] = key < Skv
        ? (wg ? dk : dv) +
              ((static_cast<int64_t>(b) * Skv + key) * KV + kh) * HD
        : nullptr;
  }

  // tile j's lse (threads 0-31) or D (32-63) of query q0 + tid % 32,
  // loaded a tile ahead and used (lse times log2(e)) only when stored, so
  // that no tile waits for the load
  auto stat = [&](int j) {
    const int h = kh * G + j / per_head;
    const int i = (qt0 + j % per_head) * QTW + tid % QTW;
    const float* src = tid < QTW ? lse : dsum;
    return i < Sq ? src[(static_cast<int64_t>(b) * H + h) * Sq + i] : 0.f;
  };
  const float sl2 = scale * L2E;
  float st_next = tid < 2 * QTW && ntiles > 0 ? stat(0) : 0.f;

  for (int j = 0; j < ntiles; ++j) {
    const int q0 = (qt0 + j % per_head) * QTW;
    if (tid < 2 * QTW) {
      stats[tid] = tid < QTW ? st_next * L2E : st_next;
      if (j + 1 < ntiles) st_next = stat(j + 1);
    }
    mbar_wait(full, (j + 1) & 1);
    // ---- split Q and dO as loaded and transposed, hi and lo ------------
    const unsigned char* raw = sb + C::O_RAW;
    for (int i = tid; i < 2 * C::QS / 16; i += WT) {   // Q then dO
      const int which = i / (C::QS / 16), c = i % (C::QS / 16);
      const uint4 x = *reinterpret_cast<const uint4*>(raw + 16 * i);
      uint4 hi, lo;
      split4(x, hi, lo);
      unsigned char* dst = sb + (which ? C::O_DH : C::O_QH) + 16 * c;
      *reinterpret_cast<uint4*>(dst) = hi;
      *reinterpret_cast<uint4*>(dst + C::QS) = lo;
    }
    split_t<HD, QTW>(raw, C::QBLK, sb + C::O_QTH, sb + C::O_QTL, tid, WT);
    split_t<HD, QTW>(raw + C::QS, C::QBLK, sb + C::O_DTH, sb + C::O_DTL, tid,
                     WT);
    fence_async_smem();
    __syncthreads();                 // the raw tile is free, the split one set
    if (tid == TMA_TID && j + 1 < ntiles) issue(j + 1);

    // ---- S^T = K Q^T (warpgroup 0), dP^T = V dO^T (1); element 4 n + i:
    // key k0 + 16 wq + g + 8 (i >> 1), query q0 + 8 n + 2 t + (i & 1).
    // The thread's 8 queries' lse log2(e) (warpgroup 0) or D (1) are read
    // before the products: query 8 m + 2 t + u's is st[2 m + u] ----------
    float st[8];
#pragma unroll
    for (int m = 0; m < 4; ++m)
#pragma unroll
      for (int u = 0; u < 2; ++u)
        st[2 * m + u] = stats[wg * QTW + 8 * m + 2 * t + u];
    float s[16];
    prod_hd<HD>(s, sb + (wg ? C::O_VLO : C::O_KLO), C::KBLK, ah,
                sb + (wg ? C::O_DH : C::O_QH), sb + (wg ? C::O_DL : C::O_QL),
                C::QBLK);
    float* xch = reinterpret_cast<float*>(sb + C::O_QH);
    if (wg == 0) {                   // P^T, handed to warpgroup 1
#pragma unroll
      for (int e = 0; e < 16; ++e) {
        const int key = k0 + 16 * wq + g + 8 * ((e >> 1) & 1);
        const int qc = 8 * (e >> 2) + 2 * t + (e & 1), qi = q0 + qc;
        const bool vis = (qi < Sq) & (key < Skv) &
                         ((causal == 0) | (key <= q_offset + qi));
        s[e] = ex2(masked(vis, fmaf(s[e], sl2, -st[2 * (e >> 2) + (e & 1)])));
        xch[e * 128 + tw] = s[e];
      }
    }
    __syncthreads();
    if (wg == 1) {                   // dS^T = P^T (dP^T - D)
#pragma unroll
      for (int e = 0; e < 16; ++e)
        s[e] = xch[e * 128 + tw] * (s[e] - st[2 * (e >> 2) + (e & 1)]);
    }
    // ---- dV += P^T dO (warpgroup 0), dK += dS^T Q (1) --------------------
    prod_t<HD>(acc, s, sb + (wg ? C::O_QTH : C::O_DTH),
               sb + (wg ? C::O_QTL : C::O_DTL));
    __syncthreads();                 // every warpgroup is done with the tile
    if ((j + 1) % FOLD_TILES == 0 && j + 1 < ntiles)
      fold<HD>(acc, rows, t, j + 1 == FOLD_TILES, false, 1.f);
  }
  fold<HD>(acc, rows, t, ntiles <= FOLD_TILES, true, wg ? scale : 1.f);
}

// dQ: one CTA a (batch, query head, 64-query tile); tk, tv tensor maps of
// k, v with 32-row boxes.
template <int HD>
__global__ void __launch_bounds__(WT, 1) flash_bwd_q_wg_kernel(
    const __grid_constant__ CUtensorMap tk,
    const __grid_constant__ CUtensorMap tv, const float* __restrict__ q,
    const float* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ dsum, float* __restrict__ dq, int H, int KV,
    int Sq, int Skv, int causal, int q_offset, float scale, int perm) {
  using C = QCfg<HD>;
  constexpr int NB = C::NB;
  extern __shared__ __align__(16) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  const uint32_t base = smem_u32(smem + WBAR);
  unsigned char* sb = smem + WBAR + (((base + 1023u) & ~1023u) - base);

  // query tiles of one (batch, head) adjacent, heads of one KV head
  // adjacent (their K/V stay in L2), causal ones longest first
  const int nqt = (Sq + QROWS - 1) / QROWS;
  int qt = blockIdx.x % nqt;
  const int rest = blockIdx.x / nqt;
  if (causal) qt = nqt - 1 - qt;
  const int h = rest % H, b = rest / H;
  const int kh = h / (H / KV), q0 = qt * QROWS;
  const int last = min(q0 + QROWS, Sq);
  const int kv_end = causal ? min(Skv, q_offset + last) : Skv;
  const int ntiles = kv_end > 0 ? (kv_end + KTW - 1) / KTW : 0;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wg = warp >> 2, wq = warp & 3, g = lane >> 2, t = lane & 3;
  const int tw = tid & 127;

  if (tid == 0) {
    mbar_init(full, 1);
    mbar_fence_init();
  }

  // ---- this warp's 16 rows of Q (warpgroup 0) or dO (1), split: lo into
  // shared memory, hi into registers as the A fragments of the hi.x terms,
  // staged through the tile buffers, which are free until the first tile
  // is issued ---------------------------------------------------------------
  uint32_t ah[HD / 8][4];
  {
    const float* src = (wg ? dout : q) +
        (static_cast<int64_t>(b) * Sq * H + h) * HD;
    const int r0 = q0 + 16 * wq, nrows = min(16, Sq - r0);
    const int64_t rs = static_cast<int64_t>(H) * HD;
    unsigned char* hi_st = sb + C::O_RAW + wg * C::QS;
    unsigned char* lo_dst = sb + (wg ? C::O_DLO : C::O_QLO);
    constexpr int QV = 16 * NB * 8 / 32;
    uint4 qv[QV];
#pragma unroll
    for (int u = 0; u < QV; ++u) {
      const int i = lane + 32 * u;
      const int r = i / (NB * 8), blk = (i / 8) % NB, c = i % 8;
      const int d = blk * 32 + c * 4;
      qv[u] = r < nrows && d < HD
          ? *reinterpret_cast<const uint4*>(src + (r0 + r) * rs + d)
          : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int u = 0; u < QV; ++u) {
      const int i = lane + 32 * u;
      const int r = 16 * wq + i / (NB * 8), blk = (i / 8) % NB, c = i % 8;
      uint4 hi, lo;
      split4(qv[u], hi, lo);
      const int off = blk * C::QBLK + swz(r, c);
      *reinterpret_cast<uint4*>(hi_st + off) = hi;
      *reinterpret_cast<uint4*>(lo_dst + off) = lo;
    }
    __syncwarp();
#pragma unroll
    for (int kk = 0; kk < HD / 8; ++kk)
#pragma unroll
      for (int f = 0; f < 4; ++f) {
        const int r = 16 * wq + g + 8 * (f & 1), d = 8 * kk + t + 4 * (f >> 1);
        ah[kk][f] = *reinterpret_cast<const uint32_t*>(
            hi_st + (d / 32) * C::QBLK + swz(r, (d % 32) / 4) + 4 * (d % 4));
      }
  }
  // lse and D of the thread's rows q0 + 16 wq + g (+ 8)
  float lr[2], dr[2];
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int qi = q0 + 16 * wq + g + 8 * rr;
    const int64_t at = (static_cast<int64_t>(b) * H + h) * Sq + qi;
    lr[rr] = qi < Sq ? lse[at] * L2E : 0.f;        // lse log2(e)
    dr[rr] = qi < Sq ? dsum[at] : 0.f;
  }
  const float sl2 = scale * L2E;
  fence_async_smem();
  __syncthreads();                   // Q hi, dO hi read out; the barrier set

  auto issue = [&](int j) {          // key tile j's K and V, as loaded
    mbar_arrive_expect_tx(full, 2 * C::KS);
    int x1, x2, x3;
    map_xyz(perm, j * KTW, kh, b, x1, x2, x3);
    tma_load_5d(sb + C::O_RAW, &tk, 0, x1, x2, x3, 0, full);
    tma_load_5d(sb + C::O_RAW + C::KS, &tv, 0, x1, x2, x3, 0, full);
  };
  if (tid == TMA_TID && ntiles > 0) issue(0);

  // dQ columns HD / 2 wg ..: acc[4 n + i], row q0 + 16 wq + g + 8 (i >> 1),
  // column HD / 2 wg + 8 n + 2 t + (i & 1), folded into the output rows
  // every FOLD_TILES tiles
  float acc[HD / 4];
#pragma unroll
  for (int i = 0; i < HD / 4; ++i) acc[i] = 0.f;
  float* rows[2];
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int qi = q0 + 16 * wq + g + 8 * rr;
    rows[rr] = qi < Sq
        ? dq + ((static_cast<int64_t>(b) * Sq + qi) * H + h) * HD +
              wg * (HD / 2)
        : nullptr;
  }

  for (int j = 0; j < ntiles; ++j) {
    const int c0 = j * KTW;
    mbar_wait(full, j & 1);
    // ---- split K and V as loaded, K also transposed, hi and lo ----------
    const unsigned char* raw = sb + C::O_RAW;
    for (int i = tid; i < 2 * C::KS / 16; i += WT) {   // K then V
      const int which = i / (C::KS / 16), c = i % (C::KS / 16);
      const uint4 x = *reinterpret_cast<const uint4*>(raw + 16 * i);
      uint4 hi, lo;
      split4(x, hi, lo);
      unsigned char* dst = sb + (which ? C::O_VH : C::O_KH) + 16 * c;
      *reinterpret_cast<uint4*>(dst) = hi;
      *reinterpret_cast<uint4*>(dst + C::KS) = lo;
    }
    split_t<HD, KTW>(raw, C::KBLK, sb + C::O_KTH, sb + C::O_KTL, tid, WT);
    fence_async_smem();
    __syncthreads();                 // the raw tile is free, the split one set
    if (tid == TMA_TID && j + 1 < ntiles) issue(j + 1);

    // ---- S = Q K^T (warpgroup 0), dP = dO V^T (1); element 4 n + i: row
    // q0 + 16 wq + g + 8 (i >> 1), key c0 + 8 n + 2 t + (i & 1) -----------
    float s[16];
    prod_hd<HD>(s, sb + (wg ? C::O_DLO : C::O_QLO), C::QBLK, ah,
                sb + (wg ? C::O_VH : C::O_KH), sb + (wg ? C::O_VL : C::O_KL),
                C::KBLK);
    float* xp = reinterpret_cast<float*>(sb + C::O_XP);
    float* xd = reinterpret_cast<float*>(sb + C::O_XD);
    if (wg == 0) {
#pragma unroll
      for (int e = 0; e < 16; ++e) {
        const int qi = q0 + 16 * wq + g + 8 * ((e >> 1) & 1);
        const int key = c0 + 8 * (e >> 2) + 2 * t + (e & 1);
        const bool vis = (qi < Sq) & (key < Skv) &
                         ((causal == 0) | (key <= q_offset + qi));
        s[e] = ex2(masked(vis, fmaf(s[e], sl2, -lr[(e >> 1) & 1])));
        xp[e * 128 + tw] = s[e];
      }
    } else {
#pragma unroll
      for (int e = 0; e < 16; ++e) xd[e * 128 + tw] = s[e];
    }
    __syncthreads();
    // both warpgroups form the same dS = P (dP - D)
#pragma unroll
    for (int e = 0; e < 16; ++e) {
      const float p = wg ? xp[e * 128 + tw] : s[e];
      const float dp = wg ? s[e] : xd[e * 128 + tw];
      s[e] = p * (dp - dr[(e >> 1) & 1]);
    }
    // ---- dQ[:, HD / 2 wg ..] += dS K -------------------------------------
    const int ho = wg * (HD / 2) * SPAN;           // rows HD / 2 wg .. of K^T
    prod_t<HD / 2>(acc, s, sb + C::O_KTH + ho, sb + C::O_KTL + ho);
    __syncthreads();                 // every warpgroup is done with the tile
    if ((j + 1) % FOLD_TILES == 0 && j + 1 < ntiles)
      fold<HD / 2>(acc, rows, t, j + 1 == FOLD_TILES, false, 1.f);
  }
  fold<HD / 2>(acc, rows, t, ntiles <= FOLD_TILES, true, scale);
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
}  // namespace

namespace {
template <int HD>
int launch_wg(const float* q, const float* k, const float* v, const float* o,
              const float* dout, const float* lse, float* dsum, float* dq,
              float* dk, float* dv, int B, int H, int KV, int Sq, int Skv,
              int causal, int q_offset, float scale, cudaStream_t s) {
  static int cap_kv = 48 * 1024, cap_q = 48 * 1024;
  cudaError_t e = allow_smem(flash_bwd_kv_wg_kernel<HD>, KvCfg<HD>::SMEM,
                             &cap_kv);
  if (e == cudaSuccess)
    e = allow_smem(flash_bwd_q_wg_kernel<HD>, QCfg<HD>::SMEM, &cap_q);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int64_t kst[3] = {static_cast<int64_t>(Skv) * KV * HD,
                          static_cast<int64_t>(KV) * HD, HD};
  const int64_t qst[3] = {static_cast<int64_t>(Sq) * H * HD,
                          static_cast<int64_t>(H) * HD, HD};
  CUtensorMap tk64 = {}, tv64 = {}, tq = {}, tdo = {}, tk32 = {}, tv32 = {};
  int perm_k = 0, perm_q = 0;
  e = kv_map(k, MT_F32, HD, Skv, KV, B, kst, KROWS, &tk64, &perm_k, true);
  if (e == cudaSuccess)
    e = kv_map(v, MT_F32, HD, Skv, KV, B, kst, KROWS, &tv64, &perm_k, true);
  if (e == cudaSuccess)
    e = kv_map(k, MT_F32, HD, Skv, KV, B, kst, KTW, &tk32, &perm_k, true);
  if (e == cudaSuccess)
    e = kv_map(v, MT_F32, HD, Skv, KV, B, kst, KTW, &tv32, &perm_k, true);
  if (e == cudaSuccess)
    e = kv_map(q, MT_F32, HD, Sq, H, B, qst, QTW, &tq, &perm_q, true);
  if (e == cudaSuccess)
    e = kv_map(dout, MT_F32, HD, Sq, H, B, qst, QTW, &tdo, &perm_q, true);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int64_t rows = static_cast<int64_t>(B) * Sq * H;
  flash_bwd_dsum_kernel<float><<<static_cast<unsigned>((rows + 7) / 8), 256,
                                 0, s>>>(o, dout, dsum, rows, H, Sq, HD);
  const int64_t grid_kv =
      static_cast<int64_t>((Skv + KROWS - 1) / KROWS) * B * KV;
  flash_bwd_kv_wg_kernel<HD><<<static_cast<unsigned>(grid_kv), WT,
                               KvCfg<HD>::SMEM, s>>>(
      tk64, tv64, tq, tdo, lse, dsum, dk, dv, H, KV, Sq, Skv, causal,
      q_offset, scale, perm_k, perm_q);
  const int64_t grid_q =
      static_cast<int64_t>((Sq + QROWS - 1) / QROWS) * B * H;
  flash_bwd_q_wg_kernel<HD><<<static_cast<unsigned>(grid_q), WT,
                              QCfg<HD>::SMEM, s>>>(
      tk32, tv32, q, dout, lse, dsum, dq, H, KV, Sq, Skv, causal, q_offset,
      scale, perm_k);
  return static_cast<int>(cudaGetLastError());
}

int f32_by_hd(int hd, const void* q, const void* k, const void* v,
              const void* o, const void* dout, const float* lse, float* dsum,
              void* dq, void* dk, void* dv, int B, int H, int KV, int Sq,
              int Skv, int causal, int q_offset, float scale,
              cudaStream_t s) {
  const float* qf = static_cast<const float*>(q);
  const float* kf = static_cast<const float*>(k);
  const float* vf = static_cast<const float*>(v);
  const float* of = static_cast<const float*>(o);
  const float* df = static_cast<const float*>(dout);
  float* dqf = static_cast<float*>(dq);
  float* dkf = static_cast<float*>(dk);
  float* dvf = static_cast<float*>(dv);
  switch (hd) {
    case 16: return launch_wg<16>(qf, kf, vf, of, df, lse, dsum, dqf, dkf,
                                  dvf, B, H, KV, Sq, Skv, causal, q_offset,
                                  scale, s);
    case 32: return launch_wg<32>(qf, kf, vf, of, df, lse, dsum, dqf, dkf,
                                  dvf, B, H, KV, Sq, Skv, causal, q_offset,
                                  scale, s);
    case 64: return launch_wg<64>(qf, kf, vf, of, df, lse, dsum, dqf, dkf,
                                  dvf, B, H, KV, Sq, Skv, causal, q_offset,
                                  scale, s);
    case 128: return launch_wg<128>(qf, kf, vf, of, df, lse, dsum, dqf, dkf,
                                    dvf, B, H, KV, Sq, Skv, causal,
                                    q_offset, scale, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

int bf16_by_hd(int hd, const void* q, const void* k, const void* v,
               const void* o, const void* dout, const float* lse,
               float* dsum, void* dq, void* dk, void* dv, int B, int H,
               int KV, int Sq, int Skv, int causal, int q_offset,
               float scale, cudaStream_t s) {
  using T = __nv_bfloat16;
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

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}
}  // namespace

// q, o, dout, dq: contiguous [B, Sq, H, hd]; k, v, dk, dv: contiguous
// [B, Skv, KV, hd]; all of type dt (float32 or bfloat16); lse: the
// forward's float32 [B, H, Sq]; dsum: float32 scratch [B, H, Sq].  Query i
// sits at position q_offset + i; causal: it sees keys j <= q_offset + i.
// hd is 16, 32, 64 or 128.  float32 takes the tensor-core kernels and needs
// q, k, v, dout, dq, dk and dv 16-byte aligned (the wrapper copies an
// operand that is not); bfloat16 the first design.
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
  if (dt == MT_F32) {
    if (!(aligned16(q) && aligned16(k) && aligned16(v) && aligned16(dout) &&
          aligned16(dq) && aligned16(dk) && aligned16(dv)))
      return static_cast<int>(cudaErrorInvalidValue);
    return f32_by_hd(hd, q, k, v, o, dout, lse, dsum, dq, dk, dv, B, H, KV,
                     Sq, Skv, causal, q_offset, scale, s);
  }
  return bf16_by_hd(hd, q, k, v, o, dout, lse, dsum, dq, dk, dv, B, H, KV,
                    Sq, Skv, causal, q_offset, scale, s);
}
