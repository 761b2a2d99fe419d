// K8 flash attention, forward: blockwise GQA softmax attention with the
// online (m, l, acc) state, causal or not, masked by a query offset and a
// valid key length.  Query head h reads KV head h / G (G = H / KV); the
// repeated KV heads are never materialized.
//
// Replaces the TPU kernel repro/kernels/flash_attention.py:_kernel (host
// wrapper flash_attention_fwd), whose grid (B*H, q blocks, kv blocks)
// walks the kv blocks in order and carries (m, l, acc) in VMEM scratch
// between grid steps.  On the H100 blocks run in parallel and in no
// order, so one CTA takes one work item and an in-CTA loop over key
// tiles takes the place of the sequential grid axis.
//
// Design for Hopper: the products on the tensor cores, at float32
// accuracy for float32 inputs (the pieces shared with the backward are in
// tf32_wgmma.cuh).  3xTF32: x = hi + lo with hi = rna_tf32(x)
// and lo = rna_tf32(x - hi) (cvt.rna.tf32's rounding, done in integer
// operations), a.b ~ lo.hi + hi.lo + hi.hi accumulated in float32, small
// terms first (1xTF32 keeps ~3 digits).  A CTA of 8 warps takes (batch, KV
// head, GH of its G query heads, BQ queries), GH the largest of 8, 4, 2, 1
// dividing G and BQ = 16 * 8 / GH: 128 query rows, 16 a warp, that share
// every K/V tile it loads (8 heads at the serve shape).  The query tiles of
// a KV head are adjacent in the grid, so its K/V stay in L2 (spread over
// the grid, they were re-read from memory while Q and O streamed through);
// causal ones run longest first.  K and V arrive by TMA (cp.async.bulk
// .tensor.4d over tensor maps of the strided views, whose row extent is
// kv_len, so rows past it are zero-filled and never read) as 128-byte
// column blocks with the TMA's 128-byte swizzle (16-byte chunk c of row r
// at c ^ (r % 8)); thread 0 issues them.
//
// float32 (flash_wg_kernel): warpgroup MMAs, wgmma.mma_async .tf32, one CTA
// an SM (two warpgroups of 64 query rows; 160 KB of shared memory), 32-key
// tiles, one raw stage.  Q is split once: its lo part into shared memory,
// its hi part (used by two of the three terms) into registers as the A
// fragments.  Each tile's K is split into hi and lo in its own swizzled
// layout and V transposed into V^T hi and lo (rows hd, a row's 8-key
// groups in the order 0 2 4 6 1 3 5 7, so that P's accumulator layout is
// its A fragment), all 8 warps splitting once for both warpgroups.  Then
// S = Q K^T by m64n32k8 (lo.hi with both operands in shared memory, the
// hi.x terms with Q hi from registers) and O += P V by m64n{hd}k8 with P
// in registers; the online softmax runs on the S accumulator between them.
// Two CTA barriers a tile hand the split tile over; the next tile's load
// runs under both products.
//
// bfloat16 (flash_fwd_kernel): mma.sync.m16n8k16 .bf16 for S (exact
// products, float32 sums), P split as above against V, which is exact in
// TF32 (m16n8k8, 2 MMAs).  64-key tiles in a 2-stage ring with full/empty
// mbarriers (thread 0 refills tile j - 1's stage with tile j + 1 once every
// warp has released it); each warp's Q rows in shared memory; fragments
// loaded as 16-byte chunks (the dot-product index permuted so that one
// chunk feeds 2 k-steps), conflict-free under the swizzle.
//
// Both: masks per element, only in tiles that cross kv_len or the causal
// diagonal; masked probabilities are 0 exactly, so a tile with no visible
// key adds nothing while the running max is still NEG_INF; a row's max and
// sum over the 4 lanes of a quad by xor shuffles (the sum deferred to the
// end); l clamped at 1e-20.  Given a non-null lse, lane 0 of each quad
// also writes its rows' logsumexp of the scaled scores (m scale + log l),
// which the backward (flash_attention_bwd.cu) reads instead of recomputing
// the softmax statistics; the serve path passes null and runs a separate
// instantiation without the store (a runtime null test in the one kernel
// cost ~2% at the serve shape, PERF.md).  Tried and dropped for float32
// (PERF.md): mma.sync at 3xTF32 (0.77 ms at the serve shape on an H100 at
// 700 W: its TF32 path peaks near 315 TFLOP/s there, and each warp split
// and loaded its own B operands); a ninth, producer warp (9 warps leave a
// thread 168 registers: spills); Q hi in shared memory (slower); the
// splits run under the products, through separate K and V stages or two
// split tiles (slower).
//
// Bound: operations.  4 * hd flops per visible (query, key) pair and head;
// as 3xTF32 that is 3 times as many tensor-core flops, 0.209 ms at the
// serve shape at 495 TFLOP/s dense TF32 (0.514 ms at float32's 67 TFLOP/s
// outside the tensor cores).  What holds the float32 kernel back: a tile
// runs split, S products, softmax and PV products one after another in
// both warpgroups at once, so the tensor cores idle through the split and
// the softmax; moving the split under the products made it slower.
#include "tf32_wgmma.cuh"

namespace {
constexpr int BK = 64;              // keys a tile
constexpr int NWC = 8;              // warps, 16 query rows each
constexpr int NT = NWC * 32;
constexpr int NS = 2;               // ring stages
constexpr int BLOCK = BK * SPAN;    // one 128-byte column block of a tile
constexpr int BAR_BYTES = 64;       // full[NS], empty[NS]
constexpr float LOG2E = 1.4426950408889634f;

template <typename T, int HD>
struct Cfg {
  static constexpr int ESZ = static_cast<int>(sizeof(T));
  static constexpr int EPC = 16 / ESZ;                // elements a chunk
  static constexpr int EPB = SPAN / ESZ;              // elements a block row
  static constexpr int NB = (HD + EPB - 1) / EPB;     // column blocks
  static constexpr int TILE = NB * BLOCK;             // K (or V) a tile
  static constexpr int STAGE = 2 * TILE;
  static constexpr int QWARP = NB * 16 * SPAN;        // a warp's 16 Q rows
  static constexpr int SMEM = BAR_BYTES + 1024 + NS * STAGE + NWC * QWARP;
};

// d += a b: m16n8k8, a row-major (4 regs), b column-major (2 regs)
__device__ __forceinline__ void mma_tf32(float* d, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ uint32_t uword(const uint4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}
// element e (0..7) of 8 bfloat16 values, as the float32 it is exactly
__device__ __forceinline__ float bf16_at(const uint4& v, int e) {
  const uint32_t w = uword(v, e >> 1);
  return __uint_as_float((e & 1) ? (w & 0xffff0000u) : (w << 16));
}
// The row logsumexp of the scaled scores, m scale + log(l), for the
// backward (kernels/flash_attention_bwd.cu): lse [B, H, Sq] float32, rows
// g and g + 8 of the warp's 16 (m and l are the quad's, after its shuffles)
__device__ __forceinline__ void store_lse(float* lse, int b, int H, int h,
                                          int Sq, int r0, int nrows, int g,
                                          const float* m, const float* l,
                                          float scale) {
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int r = g + 8 * rr;
    if (r < nrows)
      lse[(static_cast<int64_t>(b) * H + h) * Sq + r0 + r] =
          m[rr] * scale + logf(fmaxf(l[rr], 1e-20f));
  }
}
}  // namespace

// tk, tv: tensor maps of the [hd, three of (rows < kv_len, KV heads,
// batch)] views (the host orders those three by stride); perm names the
// coordinate each of map dims 1..3 takes (0 row, 1 KV head, 2 batch), two
// bits each.
template <typename T, int HD, bool LSE>
__global__ void __launch_bounds__(NT, 1) flash_fwd_kernel(
    const __grid_constant__ CUtensorMap tk,
    const __grid_constant__ CUtensorMap tv, const T* __restrict__ q,
    T* __restrict__ o, int B, int H, int KV, int GH, int Sq, int kv_len,
    int nq, int64_t qsb, int64_t qss, int64_t qsh, int64_t osb, int64_t oss,
    int64_t osh, int causal, int q_offset, float scale, int perm,
    float* __restrict__ lse) {
  using C = Cfg<T, HD>;
  constexpr int EPC = C::EPC, EPB = C::EPB, NB = C::NB;
  constexpr int NKT = BK / 8;                // 8-key steps (n-tiles of S)
  extern __shared__ __align__(16) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + NS;
  const uint32_t base = smem_u32(smem + BAR_BYTES);
  unsigned char* ring = smem + BAR_BYTES + (((base + 1023u) & ~1023u) - base);

  // the nq items of one (batch, KV head, head chunk) are adjacent, so the
  // CTAs that read its K/V run together and find them in L2; causal items
  // longest first within them
  const int G = H / KV, WPH = NWC / GH, BQ = 16 * WPH;
  int qt = blockIdx.x % nq, rest = blockIdx.x / nq;
  if (causal) qt = nq - 1 - qt;
  const int hc = rest % (G / GH);
  rest /= G / GH;
  const int kh = rest % KV, b = rest / KV;
  const int last = min(qt * BQ + BQ, Sq);       // rows [qt BQ, last)
  const int kv_end = causal ? min(kv_len, q_offset + last) : kv_len;
  const int ntiles = kv_end > 0 ? (kv_end + BK - 1) / BK : 0;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  if (tid == 0) {
    for (int s = 0; s < NS; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], NWC);
    }
    mbar_fence_init();
  }
  __syncthreads();

  // tile t into stage t % NS: 2 NB TMA loads (lane 0 of warp 0)
  auto issue = [&](int t) {
    const int st = t % NS;
    mbar_arrive_expect_tx(&full[st], C::STAGE);
    const int c[3] = {t * BK, kh, b};
    const int x1 = c[perm & 3], x2 = c[(perm >> 2) & 3],
              x3 = c[(perm >> 4) & 3];
    unsigned char* kt = ring + st * C::STAGE;
#pragma unroll
    for (int blk = 0; blk < NB; ++blk) {
      tma_load_4d(kt + blk * BLOCK, &tk, blk * EPB, x1, x2, x3, &full[st]);
      tma_load_4d(kt + C::TILE + blk * BLOCK, &tv, blk * EPB, x1, x2, x3,
                  &full[st]);
    }
  };
  if (tid == 0)
    for (int t = 0; t < NS && t < ntiles; ++t) issue(t);

  // ---- warp = (head hh, row group rg) -----------------------------------
  const int g = lane >> 2, t = lane & 3;
  const int hh = warp / WPH, rg = warp % WPH;
  const int h = kh * G + hc * GH + hh;
  const int r0 = qt * BQ + rg * 16;             // the warp's first row
  const int nrows = min(16, Sq - r0);           // <= 0: an idle warp
  const int qlo = q_offset + r0;                // its first query position
  const int w_end = nrows <= 0 ? 0
      : causal ? min(kv_len, qlo + nrows) : kv_len;

  // the warp's Q rows in shared memory, column blocks of 16 swizzled rows
  // (zeros past Sq and hd); lane t later reads chunk 2t + hf of rows g and
  // g + 8
  // (all of a lane's loads issued before any store: one trip to memory)
  unsigned char* qs = ring + NS * C::STAGE + warp * C::QWARP;
  const T* qb = q + b * qsb + h * qsh;
  constexpr int QV = 16 * NB * 8 / 32;          // 16-byte chunks a lane
  uint4 qv[QV];
#pragma unroll
  for (int u = 0; u < QV; ++u) {
    const int i = lane + 32 * u;
    const int r = i / (NB * 8), blk = (i / 8) % NB, c = i % 8;
    const int d = blk * EPB + c * EPC;
    qv[u] = r < nrows && d < HD
        ? *reinterpret_cast<const uint4*>(qb + (r0 + r) * qss + d)
        : make_uint4(0u, 0u, 0u, 0u);
  }
#pragma unroll
  for (int u = 0; u < QV; ++u) {
    const int i = lane + 32 * u;
    const int r = i / (NB * 8), blk = (i / 8) % NB, c = i % 8;
    *reinterpret_cast<uint4*>(qs + blk * 16 * SPAN + swz(r, c)) = qv[u];
  }
  __syncwarp();

  float acc[NB][EPC][4];
#pragma unroll
  for (int blk = 0; blk < NB; ++blk)
#pragma unroll
    for (int n = 0; n < EPC; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[blk][n][i] = 0.f;
  float m[2] = {NEG_INF_F, NEG_INF_F}, l[2] = {0.f, 0.f};
  const float sl2 = scale * LOG2E;

  for (int j = 0; j < ntiles; ++j) {
    const int s = j % NS, c0 = j * BK;
    if (tid == 0 && j >= 1 && j + NS - 1 < ntiles) {
      // refill tile j - 1's stage once every warp has released it
      const int tn = j + NS - 1;
      mbar_wait(&empty[tn % NS], ((tn / NS) - 1) & 1);
      issue(tn);
    }
    mbar_wait(&full[s], (j / NS) & 1);
    if (c0 < w_end) {
      const unsigned char* kt = ring + s * C::STAGE;
      const unsigned char* vt = kt + C::TILE;
      // ---- S = Q K^T ----------------------------------------------------
      float sc[NKT][4];
#pragma unroll
      for (int n = 0; n < NKT; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) sc[n][i] = 0.f;
#pragma unroll
      for (int blk = 0; blk < NB; ++blk)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const uint4 qa = *reinterpret_cast<const uint4*>(
              qs + blk * 16 * SPAN + swz(g, 2 * t + hf));
          const uint4 qb8 = *reinterpret_cast<const uint4*>(
              qs + blk * 16 * SPAN + swz(g + 8, 2 * t + hf));
          // k16-step kk: A regs (0, 2) / B regs (0, 1) are chunk words
          // 2kk, 2kk + 1
#pragma unroll
          for (int n = 0; n < NKT; ++n) {
            const uint4 kc = *reinterpret_cast<const uint4*>(
                kt + blk * BLOCK + swz(8 * n + g, 2 * t + hf));
#pragma unroll
            for (int kk = 0; kk < 2; ++kk) {
              const uint32_t a[4] = {uword(qa, 2 * kk), uword(qb8, 2 * kk),
                                     uword(qa, 2 * kk + 1),
                                     uword(qb8, 2 * kk + 1)};
              mma_bf16(sc[n], a, uword(kc, 2 * kk), uword(kc, 2 * kk + 1));
            }
          }
        }
      // ---- masks and the online softmax --------------------------------
      // element (n, i): row g + 8 (i >> 1), key c0 + 8 n + 2 t + (i & 1)
      const bool masked = c0 + BK > kv_len || (causal && c0 + BK - 1 > qlo);
      uint32_t ok = 0xffffffffu;
      if (masked) {
#pragma unroll
        for (int n = 0; n < NKT; ++n)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int key = c0 + 8 * n + 2 * t + (i & 1);
            const int qp = qlo + g + 8 * (i >> 1);
            if (key >= kv_len || (causal && key > qp)) {
              ok &= ~(1u << (4 * n + i));
              sc[n][i] = NEG_INF_F;
            }
          }
      }
      float mx[2] = {NEG_INF_F, NEG_INF_F};
#pragma unroll
      for (int n = 0; n < NKT; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          mx[i >> 1] = fmaxf(mx[i >> 1], sc[n][i]);
      float corr[2];
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        mx[rr] = fmaxf(mx[rr], __shfl_xor_sync(0xffffffffu, mx[rr], 1));
        mx[rr] = fmaxf(mx[rr], __shfl_xor_sync(0xffffffffu, mx[rr], 2));
        const float m_new = fmaxf(m[rr], mx[rr]);
        corr[rr] = exp2f((m[rr] - m_new) * sl2);
        m[rr] = m_new;
        l[rr] *= corr[rr];
      }
#pragma unroll
      for (int n = 0; n < NKT; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int rr = i >> 1;
          const float p = (ok >> (4 * n + i)) & 1u
              ? exp2f((sc[n][i] - m[rr]) * sl2) : 0.f;
          sc[n][i] = p;
          l[rr] += p;
        }
#pragma unroll
      for (int blk = 0; blk < NB; ++blk)
#pragma unroll
        for (int n = 0; n < EPC; ++n) {
          acc[blk][n][0] *= corr[0];
          acc[blk][n][1] *= corr[0];
          acc[blk][n][2] *= corr[1];
          acc[blk][n][3] *= corr[1];
        }
      // ---- O += P V: 8-key step kj, A = S's accumulator of n-tile kj
      // (cols t, t + 4 = keys 2t, 2t + 1), B = V rows 8kj + 2t (+1),
      // n-tile n of block blk at columns blk EPB + EPC g' + n ------------
#pragma unroll
      for (int kj = 0; kj < NKT; ++kj) {
        uint32_t ph[4], pl[4];
        split(sc[kj][0], ph[0], pl[0]);
        split(sc[kj][2], ph[1], pl[1]);
        split(sc[kj][1], ph[2], pl[2]);
        split(sc[kj][3], ph[3], pl[3]);
#pragma unroll
        for (int blk = 0; blk < NB; ++blk) {
          const uint4 v0 = *reinterpret_cast<const uint4*>(
              vt + blk * BLOCK + swz(8 * kj + 2 * t, g));
          const uint4 v1 = *reinterpret_cast<const uint4*>(
              vt + blk * BLOCK + swz(8 * kj + 2 * t + 1, g));
#pragma unroll
          for (int n = 0; n < EPC; ++n) {   // V is exact in TF32
            const uint32_t b0 = __float_as_uint(bf16_at(v0, n));
            const uint32_t b1 = __float_as_uint(bf16_at(v1, n));
            mma_tf32(acc[blk][n], pl, b0, b1);
            mma_tf32(acc[blk][n], ph, b0, b1);
          }
        }
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
  }

  // ---- normalise and store: lane t holds columns blk EPB + 2 EPC t + e,
  // e < 2 EPC, of rows g and g + 8 -----------------------------------------
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    l[rr] += __shfl_xor_sync(0xffffffffu, l[rr], 1);
    l[rr] += __shfl_xor_sync(0xffffffffu, l[rr], 2);
  }
  if (LSE && t == 0)
    store_lse(lse, b, H, h, Sq, r0, nrows, g, m, l, scale);
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int r = g + 8 * rr;
    if (r >= nrows) continue;
    const float den = fmaxf(l[rr], 1e-20f);
    T* orow = o + b * osb + (r0 + r) * oss + h * osh;
#pragma unroll
    for (int blk = 0; blk < NB; ++blk) {
      const int d = blk * EPB + 2 * EPC * t;
      if (d >= HD) continue;
      float f[2 * EPC];
#pragma unroll
      for (int e = 0; e < 2 * EPC; ++e)
        f[e] = acc[blk][e % EPC][2 * rr + e / EPC] / den;
#pragma unroll
      for (int v = 0; v < 2 * EPC / 8; ++v) {
        const int e0 = 8 * v;
        *reinterpret_cast<uint4*>(orow + d + e0) = pack(f + e0, T());
      }
    }
  }
}

// ---------------------------------------------------------------------------
// float32: warpgroup MMAs (wgmma), every operand split once into hi and lo
// ---------------------------------------------------------------------------
namespace {
constexpr int BKW = 32;                  // keys a tile
constexpr int QROWS = NWC * 16;          // query rows a CTA

template <int HD>
struct WCfg {
  static constexpr int NB = (HD + 31) / 32;     // 128-byte column blocks
  static constexpr int KBLK = BKW * SPAN;       // one block of a K tile
  static constexpr int RAW = 2 * NB * KBLK;     // K and V tile as loaded
  static constexpr int KS = NB * KBLK;          // K hi (or lo)
  static constexpr int VT = HD * SPAN;          // V^T hi (or lo): HD x 32
  static constexpr int QBLK = QROWS * SPAN;     // one block of Q
  static constexpr int QS = NB * QBLK;          // Q lo
  static constexpr int O_KHI = RAW, O_KLO = O_KHI + KS, O_VHI = O_KLO + KS,
                       O_VLO = O_VHI + VT, O_QLO = O_VLO + VT;
  static constexpr int SMEM = BAR_BYTES + 1024 + O_QLO + QS;
  // Q hi passes through the tile buffers on its way into registers
  static_assert(O_QLO >= QS, "Q hi staging fits the tile buffers");
};

}  // namespace

template <int HD, bool LSE>
__global__ void __launch_bounds__(NT, 1) flash_wg_kernel(
    const __grid_constant__ CUtensorMap tk,
    const __grid_constant__ CUtensorMap tv, const float* __restrict__ q,
    float* __restrict__ o, int B, int H, int KV, int GH, int Sq, int kv_len,
    int nq, int64_t qsb, int64_t qss, int64_t qsh, int64_t osb, int64_t oss,
    int64_t osh, int causal, int q_offset, float scale, int perm,
    float* __restrict__ lse) {
  using C = WCfg<HD>;
  constexpr int NB = C::NB, NKT = BKW / 8, NO = HD / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  const uint32_t base = smem_u32(smem + BAR_BYTES);
  unsigned char* sb = smem + BAR_BYTES + (((base + 1023u) & ~1023u) - base);
  unsigned char* raw = sb;
  unsigned char* khi = sb + C::O_KHI;
  unsigned char* klo = sb + C::O_KLO;
  unsigned char* vhi = sb + C::O_VHI;
  unsigned char* vlo = sb + C::O_VLO;
  unsigned char* qlo = sb + C::O_QLO;

  const int G = H / KV, WPH = NWC / GH, BQ = 16 * WPH;
  int qt = blockIdx.x % nq, rest = blockIdx.x / nq;
  if (causal) qt = nq - 1 - qt;
  const int hc = rest % (G / GH);
  rest /= G / GH;
  const int kh = rest % KV, b = rest / KV;
  const int last = min(qt * BQ + BQ, Sq);
  const int kv_end = causal ? min(kv_len, q_offset + last) : kv_len;
  const int ntiles = kv_end > 0 ? (kv_end + BKW - 1) / BKW : 0;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  auto issue = [&](int t) {         // tile t into the raw buffer
    mbar_arrive_expect_tx(full, C::RAW);
    const int c[3] = {t * BKW, kh, b};
    const int x1 = c[perm & 3], x2 = c[(perm >> 2) & 3],
              x3 = c[(perm >> 4) & 3];
#pragma unroll
    for (int blk = 0; blk < NB; ++blk) {
      tma_load_4d(raw + blk * C::KBLK, &tk, blk * 32, x1, x2, x3, full);
      tma_load_4d(raw + (NB + blk) * C::KBLK, &tv, blk * 32, x1, x2, x3,
                  full);
    }
  };
  if (tid == 0) {
    mbar_init(full, 1);
    mbar_fence_init();
  }

  const int g = lane >> 2, t = lane & 3;
  const int hh = warp / WPH, rg = warp % WPH;
  const int h = kh * G + hc * GH + hh;
  const int r0 = qt * BQ + rg * 16;
  const int nrows = min(16, Sq - r0);
  const int qlo_pos = q_offset + r0;

  // this warp's 16 rows of Q (rows 16 warp .. of the CTA's), split: lo
  // into shared memory, hi into registers as the A fragments of the S
  // products' two hi.x terms (m16n8k8 layout a k-step: rows g, g + 8,
  // columns 8 kk + t, 8 kk + t + 4), staged through the tile buffers, which
  // are free until the first tile is issued
  uint32_t qh[HD / 8][4];
  {
    const float* qb = q + b * qsb + h * qsh;
    constexpr int QV = 16 * NB * 8 / 32;
    uint4 qv[QV];
#pragma unroll
    for (int u = 0; u < QV; ++u) {
      const int i = lane + 32 * u;
      const int r = i / (NB * 8), blk = (i / 8) % NB, c = i % 8;
      const int d = blk * 32 + c * 4;
      qv[u] = r < nrows && d < HD
          ? *reinterpret_cast<const uint4*>(qb + (r0 + r) * qss + d)
          : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int u = 0; u < QV; ++u) {
      const int i = lane + 32 * u;
      const int r = 16 * warp + i / (NB * 8), blk = (i / 8) % NB, c = i % 8;
      uint4 hi, lo;
      split4(qv[u], hi, lo);
      const int off = blk * C::QBLK + swz(r, c);
      *reinterpret_cast<uint4*>(sb + off) = hi;
      *reinterpret_cast<uint4*>(qlo + off) = lo;
    }
    __syncwarp();
#pragma unroll
    for (int kk = 0; kk < HD / 8; ++kk)
#pragma unroll
      for (int f = 0; f < 4; ++f) {
        const int r = 16 * warp + g + 8 * (f & 1), d = 8 * kk + t + 4 * (f >> 1);
        qh[kk][f] = *reinterpret_cast<const uint32_t*>(
            sb + (d / 32) * C::QBLK + swz(r, (d % 32) / 4) + 4 * (d % 4));
      }
  }
  __syncthreads();                   // Q hi read out; the barrier set up
  if (tid == 0 && ntiles > 0) issue(0);

  const int wg = warp >> 2;                      // warpgroup: rows 64 wg ..
  float acc[NO * 4];
#pragma unroll
  for (int i = 0; i < NO * 4; ++i) acc[i] = 0.f;
  float m[2] = {NEG_INF_F, NEG_INF_F}, l[2] = {0.f, 0.f};
  const float sl2 = scale * LOG2E;

  for (int j = 0; j < ntiles; ++j) {
    const int c0 = j * BKW;
    mbar_wait(full, j & 1);
    // ---- split K (same layout) and V (transposed: V^T rows are hd, a
    // row's 8-key groups in the order 0 2 4 6 1 3 5 7, so that P's
    // accumulator layout is its A fragment) into hi and lo -----------------
    for (int i = tid; i < NB * BKW * 8; i += NT) {
      const uint4 x = *reinterpret_cast<const uint4*>(raw + 16 * i);
      uint4 hi, lo;
      split4(x, hi, lo);
      *reinterpret_cast<uint4*>(khi + 16 * i) = hi;
      *reinterpret_cast<uint4*>(klo + 16 * i) = lo;
    }
    for (int i = tid; i < NB * 8 * (BKW / 8) * 2; i += NT) {
      // unit: block blk, logical chunk c (hd 32 blk + 4 c ..), key group
      // q8, parity par: keys 8 q8 + 2 e + par, e < 4
      const int par = i & 1, q8 = (i >> 1) % (BKW / 8);
      const int c = (i / (2 * (BKW / 8))) % 8, blk = i / (16 * (BKW / 8));
      float v[4][4];                               // [key e][hd f]
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = 8 * q8 + 2 * e + par;
        const uint4 x = *reinterpret_cast<const uint4*>(
            raw + (NB + blk) * C::KBLK + swz(r, c));
        v[e][0] = __uint_as_float(x.x);
        v[e][1] = __uint_as_float(x.y);
        v[e][2] = __uint_as_float(x.z);
        v[e][3] = __uint_as_float(x.w);
      }
#pragma unroll
      for (int f = 0; f < 4; ++f) {
        const int d = blk * 32 + 4 * c + f;
        if (d >= HD) continue;
        const uint4 col = make_uint4(__float_as_uint(v[0][f]),
                                     __float_as_uint(v[1][f]),
                                     __float_as_uint(v[2][f]),
                                     __float_as_uint(v[3][f]));
        uint4 hi, lo;
        split4(col, hi, lo);
        const int off = swz(d, 2 * q8 + par);
        *reinterpret_cast<uint4*>(vhi + off) = hi;
        *reinterpret_cast<uint4*>(vlo + off) = lo;
      }
    }
    fence_async_smem();
    __syncthreads();                 // the raw tile is free, the split one set
    if (tid == 0 && j + 1 < ntiles) issue(j + 1);

    // ---- S = Q K^T: 3 TF32 products a k-step, small terms first ---------
    float sc[NKT * 4];
#pragma unroll
    for (int i = 0; i < NKT * 4; ++i) pin(sc[i]);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 8; ++kk) {
      const int qo = (kk / 4) * C::QBLK + wg * 64 * SPAN + (kk % 4) * 32;
      const int ko = (kk / 4) * C::KBLK + (kk % 4) * 32;
      wgmma_ss_n32(sc, sw128(qlo + qo), sw128(khi + ko), kk > 0);
      wgmma_rs_n32(sc, qh[kk], sw128(klo + ko));
      wgmma_rs_n32(sc, qh[kk], sw128(khi + ko));
    }
    wg_commit();
    wg_wait0();
#pragma unroll
    for (int i = 0; i < NKT * 4; ++i) pin(sc[i]);
#pragma unroll
    for (int kk = 0; kk < HD / 8; ++kk)
#pragma unroll
      for (int f = 0; f < 4; ++f) pin(qh[kk][f]);

    // ---- masks and the online softmax (element n, i: row g + 8 (i >> 1),
    // key c0 + 8 n + 2 t + (i & 1)) ---------------------------------------
    const bool masked =
        c0 + BKW > kv_len || (causal && c0 + BKW - 1 > qlo_pos);
    uint32_t ok = 0xffffu;
    if (masked) {
#pragma unroll
      for (int n = 0; n < NKT; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int key = c0 + 8 * n + 2 * t + (i & 1);
          const int qp = qlo_pos + g + 8 * (i >> 1);
          if (key >= kv_len || (causal && key > qp)) {
            ok &= ~(1u << (4 * n + i));
            sc[4 * n + i] = NEG_INF_F;
          }
        }
    }
    float mx[2] = {NEG_INF_F, NEG_INF_F};
#pragma unroll
    for (int i = 0; i < NKT * 4; ++i)
      mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sc[i]);
    float corr[2];
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      mx[rr] = fmaxf(mx[rr], __shfl_xor_sync(0xffffffffu, mx[rr], 1));
      mx[rr] = fmaxf(mx[rr], __shfl_xor_sync(0xffffffffu, mx[rr], 2));
      const float m_new = fmaxf(m[rr], mx[rr]);
      corr[rr] = exp2f((m[rr] - m_new) * sl2);
      m[rr] = m_new;
      l[rr] *= corr[rr];
    }
#pragma unroll
    for (int i = 0; i < NKT * 4; ++i) {
      const int rr = (i >> 1) & 1;
      const float p = (ok >> i) & 1u ? exp2f((sc[i] - m[rr]) * sl2) : 0.f;
      sc[i] = p;
      l[rr] += p;
    }
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      acc[4 * n] *= corr[0];
      acc[4 * n + 1] *= corr[0];
      acc[4 * n + 2] *= corr[1];
      acc[4 * n + 3] *= corr[1];
    }
    // ---- O += P V: k-step kj's A is S's n-tile kj (cols t, t + 4 = keys
    // 2t, 2t + 1), its B the matching V^T columns ------------------------
    uint32_t ph[NKT][4], pl[NKT][4];
#pragma unroll
    for (int kj = 0; kj < NKT; ++kj) {
      split(sc[4 * kj], ph[kj][0], pl[kj][0]);
      split(sc[4 * kj + 2], ph[kj][1], pl[kj][1]);
      split(sc[4 * kj + 1], ph[kj][2], pl[kj][2]);
      split(sc[4 * kj + 3], ph[kj][3], pl[kj][3]);
    }
#pragma unroll
    for (int i = 0; i < NO * 4; ++i) pin(acc[i]);
    wg_fence();
#pragma unroll
    for (int kj = 0; kj < NKT; ++kj) {
      wgmma_rs<HD>(acc, pl[kj], sw128(vhi + kj * 32));
      wgmma_rs<HD>(acc, ph[kj], sw128(vlo + kj * 32));
      wgmma_rs<HD>(acc, ph[kj], sw128(vhi + kj * 32));
    }
    wg_commit();
    wg_wait0();
#pragma unroll
    for (int kj = 0; kj < NKT; ++kj)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        pin(ph[kj][i]);
        pin(pl[kj][i]);
      }
#pragma unroll
    for (int i = 0; i < NO * 4; ++i) pin(acc[i]);
    __syncthreads();                 // every warpgroup is done with the tile
  }

  // ---- normalise and store: acc[4 n + i], row g + 8 (i >> 1), column
  // 8 n + 2 t + (i & 1) --------------------------------------------------
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    l[rr] += __shfl_xor_sync(0xffffffffu, l[rr], 1);
    l[rr] += __shfl_xor_sync(0xffffffffu, l[rr], 2);
  }
  if (LSE && t == 0)
    store_lse(lse, b, H, h, Sq, r0, nrows, g, m, l, scale);
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int r = g + 8 * rr;
    if (r >= nrows) continue;
    const float den = fmaxf(l[rr], 1e-20f);
    float* orow = o + b * osb + (r0 + r) * oss + h * osh;
#pragma unroll
    for (int n = 0; n < NO; ++n)
      *reinterpret_cast<float2*>(orow + 8 * n + 2 * t) =
          make_float2(acc[4 * n + 2 * rr] / den, acc[4 * n + 2 * rr + 1] / den);
  }
}

// ---------------------------------------------------------------------------
// host: tensor maps and launch
// ---------------------------------------------------------------------------

namespace {
template <typename T, int HD, bool LSE>
int launch_k(const CUtensorMap& tk, const CUtensorMap& tv, const void* q,
             void* o, int B, int H, int KV, int GH, int Sq, int kv_len,
             const int64_t* qst, const int64_t* ost, int causal,
             int q_offset, float scale, int perm, float* lse,
             cudaStream_t s) {
  static int cap = 48 * 1024;
  const int bytes = Cfg<T, HD>::SMEM;
  cudaError_t e = allow_smem(flash_fwd_kernel<T, HD, LSE>, bytes, &cap);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int BQ = 16 * (NWC / GH);
  const int nq = (Sq + BQ - 1) / BQ;
  const int64_t grid =
      static_cast<int64_t>(nq) * B * KV * ((H / KV) / GH);
  if (grid > 0)
    flash_fwd_kernel<T, HD, LSE><<<static_cast<unsigned>(grid), NT, bytes,
                                   s>>>(
        tk, tv, static_cast<const T*>(q), static_cast<T*>(o), B, H, KV, GH,
        Sq, kv_len, nq, qst[0], qst[1], qst[2], ost[0], ost[1], ost[2],
        causal, q_offset, scale, perm, lse);
  return static_cast<int>(cudaGetLastError());
}

// the row logsumexp is a template switch, so the serve path's kernel (no
// lse) is compiled exactly as it was before the backward needed one
template <typename T, int HD>
int launch(const CUtensorMap& tk, const CUtensorMap& tv, const void* q,
           void* o, int B, int H, int KV, int GH, int Sq, int kv_len,
           const int64_t* qst, const int64_t* ost, int causal, int q_offset,
           float scale, int perm, float* lse, cudaStream_t s) {
  return lse != nullptr
      ? launch_k<T, HD, true>(tk, tv, q, o, B, H, KV, GH, Sq, kv_len, qst,
                              ost, causal, q_offset, scale, perm, lse, s)
      : launch_k<T, HD, false>(tk, tv, q, o, B, H, KV, GH, Sq, kv_len, qst,
                               ost, causal, q_offset, scale, perm, lse, s);
}

template <int HD, bool LSE>
int launch_wg_k(const CUtensorMap& tk, const CUtensorMap& tv, const void* q,
                void* o, int B, int H, int KV, int GH, int Sq, int kv_len,
                const int64_t* qst, const int64_t* ost, int causal,
                int q_offset, float scale, int perm, float* lse,
                cudaStream_t s) {
  static int cap = 48 * 1024;
  const int bytes = WCfg<HD>::SMEM;
  cudaError_t e = allow_smem(flash_wg_kernel<HD, LSE>, bytes, &cap);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int BQ = 16 * (NWC / GH);
  const int nq = (Sq + BQ - 1) / BQ;
  const int64_t grid =
      static_cast<int64_t>(nq) * B * KV * ((H / KV) / GH);
  if (grid > 0)
    flash_wg_kernel<HD, LSE><<<static_cast<unsigned>(grid), NT, bytes, s>>>(
        tk, tv, static_cast<const float*>(q), static_cast<float*>(o), B, H,
        KV, GH, Sq, kv_len, nq, qst[0], qst[1], qst[2], ost[0], ost[1],
        ost[2], causal, q_offset, scale, perm, lse);
  return static_cast<int>(cudaGetLastError());
}

template <int HD>
int launch_wg(const CUtensorMap& tk, const CUtensorMap& tv, const void* q,
              void* o, int B, int H, int KV, int GH, int Sq, int kv_len,
              const int64_t* qst, const int64_t* ost, int causal,
              int q_offset, float scale, int perm, float* lse,
              cudaStream_t s) {
  return lse != nullptr
      ? launch_wg_k<HD, true>(tk, tv, q, o, B, H, KV, GH, Sq, kv_len, qst,
                              ost, causal, q_offset, scale, perm, lse, s)
      : launch_wg_k<HD, false>(tk, tv, q, o, B, H, KV, GH, Sq, kv_len, qst,
                               ost, causal, q_offset, scale, perm, lse, s);
}

template <typename T>
int by_hd(int hd, const CUtensorMap& tk, const CUtensorMap& tv,
          const void* q, void* o, int B, int H, int KV, int GH, int Sq,
          int kv_len, const int64_t* qst, const int64_t* ost, int causal,
          int q_offset, float scale, int perm, float* lse, cudaStream_t s) {
  switch (hd) {
    case 16: return launch<T, 16>(tk, tv, q, o, B, H, KV, GH, Sq, kv_len,
                                  qst, ost, causal, q_offset, scale, perm,
                                  lse, s);
    case 32: return launch<T, 32>(tk, tv, q, o, B, H, KV, GH, Sq, kv_len,
                                  qst, ost, causal, q_offset, scale, perm,
                                  lse, s);
    case 64: return launch<T, 64>(tk, tv, q, o, B, H, KV, GH, Sq, kv_len,
                                  qst, ost, causal, q_offset, scale, perm,
                                  lse, s);
    case 128: return launch<T, 128>(tk, tv, q, o, B, H, KV, GH, Sq, kv_len,
                                    qst, ost, causal, q_offset, scale, perm,
                                    lse, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
}  // namespace

// q: B x Sq x H x hd elements, element (b, s, h, e) at
//    b * qst[0] + s * qst[1] + h * qst[2] + e (unit stride along e);
// k, v: B x Skv x KV x hd with the strides kst (the same for both); keys
//    at or past kv_len are neither read nor seen;
// o: like q, strides ost, of q's type.  hd is 16, 32, 64 or 128; q, k, v
// and o 16-byte aligned with strides of whole 16-byte units (the wrapper
// checks); GH (8, 4, 2 or 1) divides H / KV: the query heads a CTA takes.
// lse: null, or float32 [B, H, Sq] (contiguous) for the row logsumexp of
// the scaled scores, which the backward reads.
extern "C" int rt_flash_attention(const void* q, const void* k,
                                  const void* v, void* o, int dt, int B,
                                  int H, int KV, int Sq, int kv_len, int hd,
                                  const int64_t* qst, const int64_t* kst,
                                  const int64_t* ost, int causal,
                                  int q_offset, float scale, int GH,
                                  float* lse, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (KV < 1 || H % KV != 0 || GH < 1 || NWC % GH != 0 ||
      (H / KV) % GH != 0 || kv_len < 1 || (dt != MT_F32 && dt != MT_BF16))
    return static_cast<int>(cudaErrorInvalidValue);
  if (B < 1 || Sq < 1) return static_cast<int>(cudaSuccess);
  CUtensorMap tk = {}, tv = {};
  int perm = 0;
  const int rows = dt == MT_F32 ? BKW : BK;
  cudaError_t e = kv_map(k, dt, hd, kv_len, KV, B, kst, rows, &tk, &perm);
  if (e == cudaSuccess)
    e = kv_map(v, dt, hd, kv_len, KV, B, kst, rows, &tv, &perm);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dt == MT_F32) {
    switch (hd) {
      case 16: return launch_wg<16>(tk, tv, q, o, B, H, KV, GH, Sq, kv_len,
                                    qst, ost, causal, q_offset, scale, perm,
                                    lse, s);
      case 32: return launch_wg<32>(tk, tv, q, o, B, H, KV, GH, Sq, kv_len,
                                    qst, ost, causal, q_offset, scale, perm,
                                    lse, s);
      case 64: return launch_wg<64>(tk, tv, q, o, B, H, KV, GH, Sq, kv_len,
                                    qst, ost, causal, q_offset, scale, perm,
                                    lse, s);
      case 128: return launch_wg<128>(tk, tv, q, o, B, H, KV, GH, Sq, kv_len,
                                      qst, ost, causal, q_offset, scale,
                                      perm, lse, s);
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  return by_hd<__nv_bfloat16>(hd, tk, tv, q, o, B, H, KV, GH, Sq, kv_len,
                              qst, ost, causal, q_offset, scale, perm, lse,
                              s);
}
