// K9 LSM decode attention: one decode token per sequence against ONE KV
// component (an LSM run of the tiered cache, or the whole flat cache),
// masked by valid_len, returning the un-normalized flash state
// (acc [B, H, hd], m [B, H], l [B, H], all float32) that components merge
// by the associative logsumexp merge (ref.merge_partials).
//
// Replaces the TPU kernel repro/kernels/lsm_decode_attention.py:_kernel
// (host wrapper decode_partial), whose grid (B, KV, kv blocks) streams the
// component's blocks in order with the state in VMEM scratch.
//
// Design for Hopper: one thread-block CLUSTER of C CTAs per (batch, KV
// head), C <= 8 chosen by the wrapper (lsm_decode_attention.py:
// cluster_size, split_plan): the most CTAs that leave every rank at least
// one 64-row tile and still let all B * KV clusters be resident at once
// (cudaOccupancyMaxActiveClusters).  Rank r takes rows [r * chunk,
// min(valid_len, (r + 1) * chunk)), chunk a multiple of 64 rows; a range
// may be empty.  On the serve path (B * KV = 64, float32, hd 128) that is
// C = 2 on the L2 and the flat cache (128 CTAs, one an SM: each holds 136
// KiB of shared memory) and C = 1 on the 64-row L1 slots and the tail.
// Each CTA:
//   * a producer warp streams its range in tiles of BK = 64 rows into a
//     2-stage ring in shared memory with the Tensor Memory Accelerator:
//     one cp.async.bulk.tensor.4d per tile for K and one for V, over a
//     tensor map of the [B, valid_len, KV, hd] view of the cache (encoded
//     on the host and cached), so rows at or past valid_len lie outside the
//     map: the TMA writes zeros for them and never reads them.  A "full"
//     mbarrier per stage counts the tile's bytes, an "empty" one its
//     release (one arrival per consumer warp).  No register holds a tile
//     on its way in, and the G = H / KV query heads share every tile;
//   * eight consumer warps compute on the landed stage.  Layout: the rows
//     stay dense (the TMA box, no padding) and every warp reads whole rows,
//     4 values a lane (a 512-byte float32 row is one 16-byte load per
//     lane), so no load conflicts.  Scores keep q of GS <= 4 heads in
//     registers and fold the GS partial dots across the lanes by a
//     transposing shuffle reduction (6 shuffles for 4 heads over 32
//     lanes), a warp's 8 keys of the tile folded together so their
//     shuffles overlap; one warp per head updates (m, l) over the tile;
//     p.V gives each thread 4 values of hd for GW <= 8 heads and the warps
//     the tile's keys, so a V row is read once per 8 heads.  Two consumer
//     barriers a tile;
//   * the cluster merges inside the same launch: each rank folds its key
//     groups in order and parks (acc, m, l) in its shared memory, a
//     cluster barrier publishes them, and each rank merges a 1/C slice of
//     the [G, hd] outputs by reading every rank's state through
//     distributed shared memory (DSMEM): M = max_r m_r, acc = sum_r
//     exp(m_r - M) acc_r in rank order 0..C-1 (fixed, so the result
//     repeats bit for bit), likewise l.  A last cluster barrier keeps
//     every rank's shared memory alive until the merge has read it.
// Tiles of 16 rows (3-4 CTAs an SM, C up to 8) were slower: their two
// barriers and shuffle chains a tile were not hidden behind the loads.
//
// Hazard (the reference masks p twice for it, lsm_decode_attention.py:55):
// a key at or past valid_len must give p = 0, not exp(NEG_INF - NEG_INF)
// = 1 while a head's running max is still NEG_INF.  Such keys are never
// read (outside the tensor map) and get no score: the tile loops stop at
// the range's end.  An empty range keeps (0, NEG_INF, 0), and the merge
// skips ranks whose m is NEG_INF, so it never takes exp(NEG_INF -
// NEG_INF) either; an empty component (valid_len 0, an empty L1 slot)
// writes acc = 0, m = NEG_INF, l = 0, as the reference does.
//
// Bound: memory.  It reads the valid_len valid K and V rows once
// (2 * valid_len * hd elements per (b, KV head)) and q, and writes the
// state: 50.9 MB, 15.2 us at 3.35 TB/s, on the serve path's L2 (768 valid
// rows, float32), 55.0 MB and 16.4 us on its flat cache (831); 4 * G * hd
// flops per key, about 4 flops a byte against the card's 20 a byte for
// float32.  A KV head's rows are 512-byte pieces 4 KB apart in the
// [B, S, KV, hd] cache, which keeps even a bare stream of these tiles
// well below the card's rate (PERF.md).
#include <cooperative_groups.h>

#include <mutex>
#include <type_traits>

#include "model_common.cuh"

namespace cg = cooperative_groups;

namespace {
constexpr int NWC = 8;                 // consumer warps
constexpr int NTC = NWC * 32;          // consumer threads
constexpr int NT = NTC + 32;           // plus one producer warp
constexpr int NS = 2;                  // ring stages
constexpr int BK = 64;                 // rows a tile (TILE_ROWS in the .py)
constexpr int MAX_KG = 16;             // key groups of p.V at most
constexpr int BAR_BYTES = 128;         // full[NS], empty[NS] mbarriers

// Per (element type, head dim, p.V heads a thread) constants and the
// shared-memory plan, on the host and the device alike.
template <typename T, int HD, int GW>
struct Plan {
  static constexpr int ROWB = HD * static_cast<int>(sizeof(T));
  static constexpr int TILE = BK * ROWB;         // K (or V) bytes a tile
  static constexpr int STAGE = 2 * TILE;
  static constexpr int LPK = HD / 4;             // lanes a key, 4 values each
  static constexpr int KPW = 32 / LPK;           // keys a warp pass
  static constexpr int GS = GW > 4 ? 4 : GW;     // score heads a pass
  static constexpr int SSTR = BK + 1;            // score row stride
  __host__ __device__ static int gpad(int G) { return (G + GW - 1) / GW * GW; }
  // key groups of p.V: (head group, 4 values of hd) pairs fill NTC threads
  __host__ __device__ static int kgroups(int G) {
    const int k = NTC / (gpad(G) / GW * LPK);
    return k > MAX_KG ? MAX_KG : k;
  }
  // the ring, reused for the key groups' partial acc after the last tile
  __host__ __device__ static int ring(int G) {
    const int part = kgroups(G) * gpad(G) * HD * 4;
    return NS * STAGE > part ? NS * STAGE : part;
  }
  __host__ __device__ static int bytes(int G) {
    const int gp = gpad(G);
    return BAR_BYTES + ring(G) +
           4 * (gp * HD + gp * SSTR + BK * gp + 3 * gp);
  }
};

// 4 consecutive values of a K or V row in shared memory as float32
__device__ __forceinline__ float4 ld4(const unsigned char* p, float) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 ld4(const unsigned char* p,
                                      __nv_bfloat16) {
  const uint2 w = *reinterpret_cast<const uint2*>(p);
  return make_float4(__uint_as_float(w.x << 16),
                     __uint_as_float(w.x & 0xffff0000u),
                     __uint_as_float(w.y << 16),
                     __uint_as_float(w.y & 0xffff0000u));
}

// Fold NV per-lane partial sums over lane offsets O, O/2, .., 1.  While
// more than one value is left, a step keeps half of them (the upper half
// where the lane's offset bit is set) and adds the partner lane's copy of
// that half: NV/2 shuffles; then plain butterflies.  After it a lane
// holds the full sums of heads base + i, i < max(1, NV / (2 O)); lanes
// that differ only in the butterfly bits hold equal values.
template <int NV, int O>
struct Fold {
  static __device__ __forceinline__ void run(float* v, int lane, int& base) {
    if constexpr (O > 0) {
      if constexpr (NV > 1) {
        const bool up = (lane & O) != 0;
#pragma unroll
        for (int i = 0; i < NV / 2; ++i) {
          const float send = up ? v[i] : v[i + NV / 2];
          const float keep = up ? v[i + NV / 2] : v[i];
          v[i] = keep + __shfl_xor_sync(0xffffffffu, send, O);
        }
        if (up) base += NV / 2;
        Fold<NV / 2, O / 2>::run(v, lane, base);
      } else {
        v[0] += __shfl_xor_sync(0xffffffffu, v[0], O);
        Fold<1, O / 2>::run(v, lane, base);
      }
    }
  }
};

}  // namespace

template <typename T, int HD, int GW>
__global__ void __launch_bounds__(NT) decode_partial_kernel(
    const __grid_constant__ CUtensorMap tk,
    const __grid_constant__ CUtensorMap tv, const float* __restrict__ q,
    float* __restrict__ acc_out, float* __restrict__ m_out,
    float* __restrict__ l_out, int H, int KV, int n, int C, int chunk,
    float scale) {
  using P = Plan<T, HD, GW>;
  constexpr int LPK = P::LPK, KPW = P::KPW, ROWB = P::ROWB, GS = P::GS;
  constexpr int SSTR = P::SSTR, E4 = HD / 4;
  constexpr int RV = GS / LPK > 1 ? GS / LPK : 1;   // sums a lane keeps
  constexpr int BUTTERFLY = LPK / GS > 1 ? LPK / GS : 1;
  constexpr int NPASS = BK / (NWC * KPW);
  static_assert(NPASS * NWC * KPW == BK, "score passes cover the tile");
  extern __shared__ __align__(128) unsigned char smem[];
  const int G = H / KV, GP = P::gpad(G), HG = GP / GW, KG = P::kgroups(G);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + NS;
  unsigned char* ring = smem + BAR_BYTES;
  float* Qs = reinterpret_cast<float*>(ring + P::ring(G));  // [GP][HD]
  float* Ss = Qs + GP * HD;        // [GP][SSTR] scores
  float* Ps = Ss + GP * SSTR;      // [BK][GP] probabilities
  float* Ms = Ps + BK * GP;        // [GP] running max
  float* Ls = Ms + GP;             // [GP] running sum
  float* Cs = Ls + GP;             // [GP] this tile's correction

  const int bh = blockIdx.x / C, rank = blockIdx.x % C;
  const int b = bh / KV, kh = bh % KV;
  const int lo = min(n, rank * chunk), hi = min(n, lo + chunk);
  const int ntiles = (hi - lo + BK - 1) / BK;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int64_t head0 = static_cast<int64_t>(b) * H + kh * G;

  if (n == 0) {
    // an empty component: the reference's (0, NEG_INF, 0), from rank 0
    if (rank == 0) {
      for (int i = tid; i < G * HD; i += NT) acc_out[head0 * HD + i] = 0.f;
      for (int g = tid; g < G; g += NT) {
        m_out[head0 + g] = NEG_INF_F;
        l_out[head0 + g] = 0.f;
      }
    }
    return;
  }
  // the producer sets up the ring and starts loading at once; the
  // consumers meanwhile fetch q
  if (warp == NWC && lane == 0 && ntiles > 0) {
    for (int s = 0; s < NS; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], NWC);
    }
    mbar_fence_init();
  }
  __syncthreads();

  // p.V: this thread owns values 4 e4 .. 4 e4 + 3 of heads hg GW .. + GW
  // over keys kg, kg + KG, ... of every tile
  const int e4 = tid % LPK, hg = (tid / LPK) % HG, kg = tid / (LPK * HG);
  const bool pv = warp < NWC && kg < KG;
  float4 acc[GW];
#pragma unroll
  for (int i = 0; i < GW; ++i) acc[i] = make_float4(0.f, 0.f, 0.f, 0.f);

  if (warp == NWC) {
    // ---- producer: one TMA load of K and one of V a tile ---------------
    if (lane == 0) {
      for (int j = 0; j < ntiles; ++j) {
        const int s = j % NS;
        if (j >= NS) mbar_wait(&empty[s], ((j / NS) - 1) & 1);
        mbar_arrive_expect_tx(&full[s], P::STAGE);
        unsigned char* kt = ring + s * P::STAGE;
        tma_load_4d(kt, &tk, 0, kh, lo + j * BK, b, &full[s]);
        tma_load_4d(kt + P::TILE, &tv, 0, kh, lo + j * BK, b, &full[s]);
      }
    }
  } else {
    // ---- consumers --------------------------------------------------
    for (int i = tid; i < GP * HD; i += NTC)
      Qs[i] = i < G * HD ? q[head0 * HD + i] * scale : 0.f;
    for (int g = tid; g < GP; g += NTC) {
      Ms[g] = NEG_INF_F;
      Ls[g] = 0.f;
    }
    named_sync(1, NTC);
    const int ek = lane % LPK, ks = lane / LPK;    // score lane layout
    for (int j = 0; j < ntiles; ++j) {
      const int s = j % NS;
      const int nc = min(BK, hi - (lo + j * BK));
      const unsigned char* kt = ring + s * P::STAGE;
      const unsigned char* vt = kt + P::TILE;
      mbar_wait(&full[s], (j / NS) & 1);
      // scores: pass t of a warp takes keys (warp + t NWC) KPW + ks, the
      // passes' shuffle folds independent so they overlap
      for (int h = 0; h < GP; h += GS) {
        float4 qr[GS];
#pragma unroll
        for (int i = 0; i < GS; ++i)
          qr[i] = reinterpret_cast<const float4*>(Qs + (h + i) * HD)[ek];
        float sv[NPASS][GS];
        int base[NPASS];
#pragma unroll
        for (int t = 0; t < NPASS; ++t) {
          // a key past the range's end (zeros, or the next rank's row)
          // keeps its sums in its own lanes, unwritten
          const int c = (warp + t * NWC) * KPW + ks;
          const float4 kv = ld4(kt + c * ROWB + ek * 4 * sizeof(T), T());
#pragma unroll
          for (int i = 0; i < GS; ++i)
            sv[t][i] = fmaf(qr[i].w, kv.w,
                           fmaf(qr[i].z, kv.z, fmaf(qr[i].y, kv.y,
                                                    qr[i].x * kv.x)));
          base[t] = 0;
        }
#pragma unroll
        for (int t = 0; t < NPASS; ++t)
          Fold<GS, LPK / 2>::run(sv[t], lane, base[t]);
#pragma unroll
        for (int t = 0; t < NPASS; ++t) {
          const int c = (warp + t * NWC) * KPW + ks;
          if (c < nc && ek % BUTTERFLY == 0) {
#pragma unroll
            for (int i = 0; i < RV; ++i)
              Ss[(h + base[t] + i) * SSTR + c] = sv[t][i];
          }
        }
      }
      named_sync(1, NTC);
      for (int g = warp; g < GP; g += NWC) {
        float mx = NEG_INF_F;
        for (int c = lane; c < nc; c += 32) mx = fmaxf(mx, Ss[g * SSTR + c]);
        for (int off = 16; off > 0; off >>= 1)
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
        const float m_old = Ms[g], m_new = fmaxf(m_old, mx);
        float rs = 0.f;
        for (int c = lane; c < nc; c += 32) {
          const float p = expf(Ss[g * SSTR + c] - m_new);
          Ps[c * GP + g] = p;
          rs += p;
        }
        for (int off = 16; off > 0; off >>= 1)
          rs += __shfl_xor_sync(0xffffffffu, rs, off);
        if (lane == 0) {
          const float corr = expf(m_old - m_new);
          Cs[g] = corr;
          Ls[g] = Ls[g] * corr + rs;
          Ms[g] = m_new;
        }
      }
      named_sync(1, NTC);
      if (pv) {
#pragma unroll
        for (int i = 0; i < GW; ++i) {
          const float cr = Cs[hg * GW + i];
          acc[i].x *= cr; acc[i].y *= cr; acc[i].z *= cr; acc[i].w *= cr;
        }
        for (int c = kg; c < nc; c += KG) {
          const float4 vv = ld4(vt + c * ROWB + e4 * 4 * sizeof(T), T());
          const float* pc = Ps + c * GP + hg * GW;
#pragma unroll
          for (int i = 0; i < GW; ++i) {
            const float p = pc[i];
            acc[i].x = fmaf(p, vv.x, acc[i].x);
            acc[i].y = fmaf(p, vv.y, acc[i].y);
            acc[i].z = fmaf(p, vv.z, acc[i].z);
            acc[i].w = fmaf(p, vv.w, acc[i].w);
          }
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);
    }
    // fold the key groups in order: partials [KG][GP][E4] in the ring,
    // the sum left in key group 0's place ([GP][E4], the rank's acc)
    float4* As = reinterpret_cast<float4*>(ring);
    named_sync(1, NTC);            // every consumer is done with the ring
    if (pv) {
#pragma unroll
      for (int i = 0; i < GW; ++i)
        As[(kg * GP + hg * GW + i) * E4 + e4] = acc[i];
    }
    named_sync(1, NTC);
    for (int slot = tid; slot < G * E4; slot += NTC) {
      float4 x = As[slot];
      for (int k = 1; k < KG; ++k) {
        const float4 y = As[k * GP * E4 + slot];
        x.x += y.x; x.y += y.y; x.z += y.z; x.w += y.w;
      }
      if (C == 1)
        reinterpret_cast<float4*>(acc_out + head0 * HD)[slot] = x;
      else
        As[slot] = x;
    }
    if (C == 1) {
      for (int g = tid; g < G; g += NTC) {
        m_out[head0 + g] = Ms[g];
        l_out[head0 + g] = Ls[g];
      }
    }
  }
  if (C == 1) return;

  // ---- merge the cluster's ranks through DSMEM ------------------------
  const float4* As = reinterpret_cast<const float4*>(ring);
  cluster_arrive();                // publish As, Ms, Ls to the cluster
  cluster_wait();
  cg::cluster_group cluster = cg::this_cluster();
  const int per = (G * E4 + C - 1) / C;
  const int s_end = min(G * E4, (rank + 1) * per);
  for (int slot = rank * per + tid; slot < s_end; slot += NT) {
    const int g = slot / E4;
    float M = NEG_INF_F;
    for (int r = 0; r < C; ++r)
      M = fmaxf(M, cluster.map_shared_rank(Ms, r)[g]);
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    float l = 0.f;
    for (int r = 0; r < C; ++r) {
      const float mr = cluster.map_shared_rank(Ms, r)[g];
      if (mr == NEG_INF_F) continue;           // an empty range
      const float w = expf(mr - M);
      const float4 ar = cluster.map_shared_rank(As, r)[slot];
      x.x = fmaf(w, ar.x, x.x);
      x.y = fmaf(w, ar.y, x.y);
      x.z = fmaf(w, ar.z, x.z);
      x.w = fmaf(w, ar.w, x.w);
      l = fmaf(w, cluster.map_shared_rank(Ls, r)[g], l);
    }
    reinterpret_cast<float4*>(acc_out + head0 * HD)[slot] = x;
    if (slot % E4 == 0) {
      m_out[head0 + g] = M;
      l_out[head0 + g] = l;
    }
  }
  cluster_arrive();                // no rank leaves while others read it
  cluster_wait();
}

// ---------------------------------------------------------------------------
// host: tensor maps and launch
// ---------------------------------------------------------------------------

namespace {
struct MapKey {
  const void* ptr;
  int dt, B, KV, hd, n;
  int64_t Sc;
  bool operator==(const MapKey& o) const {
    return ptr == o.ptr && dt == o.dt && B == o.B && KV == o.KV &&
           hd == o.hd && n == o.n && Sc == o.Sc;
  }
};

// The cache's K and V buffers are written in place, so a buffer's pointer
// (and, for a component that is not growing, its valid_len) repeats from
// step to step: the last maps are kept, direct-mapped by a key hash.
constexpr int MAP_SLOTS = 256;
struct MapSlot {
  MapKey key;
  CUtensorMap map;
  bool used;
};
MapSlot map_cache[MAP_SLOTS];
std::mutex map_lock;

// The [B, n, KV, hd] view of a [B, Sc, KV, hd] cache (dims innermost
// first), boxes of one KV head's BK rows: rows n .. Sc - 1 are outside.
cudaError_t tensor_map(const void* ptr, int dt, int B, int64_t Sc, int KV,
                       int hd, int n, CUtensorMap* out) {
  const MapKey key{ptr, dt, B, KV, hd, n, Sc};
  const uint64_t h =
      (reinterpret_cast<uintptr_t>(ptr) >> 8) * 0x9E3779B97F4A7C15ull ^
      static_cast<uint64_t>(n) * 0xC2B2AE3D27D4EB4Full ^
      static_cast<uint64_t>(Sc);
  std::lock_guard<std::mutex> guard(map_lock);
  MapSlot& slot = map_cache[(h >> 32) % MAP_SLOTS];
  if (slot.used && slot.key == key) {
    *out = slot.map;
    return cudaSuccess;
  }
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorSymbolNotFound;
  const cuuint64_t esz = dt == MT_F32 ? 4 : 2;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(hd),
                              static_cast<cuuint64_t>(KV),
                              static_cast<cuuint64_t>(n),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {hd * esz, KV * hd * esz,
                                 static_cast<cuuint64_t>(Sc) * KV * hd * esz};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(hd), 1, BK, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = encode(
      out, dt == MT_F32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                        : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
      4, const_cast<void*>(ptr), dims, strides, box, unit,
      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) return cudaErrorInvalidValue;
  slot.key = key;
  slot.map = *out;
  slot.used = true;
  return cudaSuccess;
}

template <typename T, int HD, int GW>
int launch(const CUtensorMap& tk, const CUtensorMap& tv, const float* q,
           float* acc, float* m, float* l, int B, int H, int KV, int n, int C,
           int chunk, float scale, cudaStream_t s) {
  static int cap = 48 * 1024;
  const int bytes = Plan<T, HD, GW>::bytes(H / KV);
  cudaError_t e = allow_smem(decode_partial_kernel<T, HD, GW>, bytes, &cap);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (B * KV > 0) {
    e = launch_clusters(decode_partial_kernel<T, HD, GW>, B * KV * C, NT,
                        bytes, C, s, tk, tv, q, acc, m, l, H, KV, n, C, chunk,
                        scale);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  return static_cast<int>(cudaGetLastError());
}

// Calls f.template run<T, HD, GW>() for the element type, head dim and
// p.V head group (8, or the fewest powers of two that hold G).
template <typename F>
int dispatch(int dt, int hd, int G, const F& f) {
  auto by_group = [&](auto t, auto h) {
    using T = decltype(t);
    constexpr int HD = decltype(h)::value;
    if (G >= 5) return f.template run<T, HD, 8>();
    if (G >= 3) return f.template run<T, HD, 4>();
    if (G == 2) return f.template run<T, HD, 2>();
    return f.template run<T, HD, 1>();
  };
  auto by_hd = [&](auto t) {
    switch (hd) {
      case 16: return by_group(t, std::integral_constant<int, 16>());
      case 32: return by_group(t, std::integral_constant<int, 32>());
      case 64: return by_group(t, std::integral_constant<int, 64>());
      case 128: return by_group(t, std::integral_constant<int, 128>());
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  };
  if (G < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (dt == MT_F32) return by_hd(float());
  if (dt == MT_BF16) return by_hd(__nv_bfloat16());
  return static_cast<int>(cudaErrorInvalidValue);
}

struct Launch {
  const CUtensorMap &tk, &tv;
  const float* q;
  float *acc, *m, *l;
  int B, H, KV, n, C, chunk;
  float scale;
  cudaStream_t s;
  template <typename T, int HD, int GW>
  int run() const {
    return launch<T, HD, GW>(tk, tv, q, acc, m, l, B, H, KV, n, C, chunk,
                             scale, s);
  }
};

// cudaOccupancyMaxActiveClusters of the kernel for clusters of C CTAs
struct Resident {
  int G, C;
  int* out;
  template <typename T, int HD, int GW>
  int run() const {
    auto kernel = decode_partial_kernel<T, HD, GW>;
    static int cap = 48 * 1024;
    const int bytes = Plan<T, HD, GW>::bytes(G);
    cudaError_t e = allow_smem(kernel, bytes, &cap);
    if (e != cudaSuccess) return static_cast<int>(e);
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(static_cast<unsigned>(C));
    cfg.blockDim = dim3(NT);
    cfg.dynamicSmemBytes = static_cast<size_t>(bytes);
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = static_cast<unsigned>(C);
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    e = cudaOccupancyMaxActiveClusters(out, kernel, &cfg);
    if (e != cudaSuccess) cudaGetLastError();
    return static_cast<int>(e);
  }
};
}  // namespace

// q: [B, H, hd] float32 (the reference casts q to float32 too); k, v:
// [B, Sc, KV, hd] of type dt, 16-byte aligned; all contiguous.  acc:
// [B, H, hd], m, l: [B, H] float32.  Keys [0, n) are valid (0 <= n <= Sc).
// hd is 16, 32, 64 or 128 and (H / KV) * hd <= 16 * 256.  C CTAs a
// cluster take rows [r * chunk, min(n, (r + 1) * chunk)), r < C; the
// caller guarantees C * chunk >= n.
extern "C" int rt_decode_partial(const float* q, const void* k,
                                 const void* v, int dt, float* acc,
                                 float* m, float* l, int B, int H, int KV,
                                 int hd, int64_t Sc, int n, int C, int chunk,
                                 float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (C < 1 || chunk < 0 || static_cast<int64_t>(C) * chunk < n ||
      KV < 1 || H % KV != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap tk = {}, tv = {};
  if (n > 0 && B > 0) {
    cudaError_t e = tensor_map(k, dt, B, Sc, KV, hd, n, &tk);
    if (e == cudaSuccess) e = tensor_map(v, dt, B, Sc, KV, hd, n, &tv);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  return dispatch(dt, hd, H / KV,
                  Launch{tk, tv, q, acc, m, l, B, H, KV, n, C, chunk, scale,
                         s});
}

// How many clusters of C CTAs of K9 can be resident at once for element
// type dt, head dim hd and group G (cudaOccupancyMaxActiveClusters), into
// *out; the wrapper sizes C by it.  Returns the CUDA error.
extern "C" int rt_decode_partial_clusters(int dt, int hd, int G, int C,
                                          int* out) {
  if (C < 1) return static_cast<int>(cudaErrorInvalidValue);
  return dispatch(dt, hd, G, Resident{G, C, out});
}
