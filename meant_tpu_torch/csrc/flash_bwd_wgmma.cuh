// The bf16 bodies of the flash backwards on Hopper (sm_90a), shared by the
// resident backward K2 (flash_bwd.cu) and the streaming backward K4 + K5
// (flash_bwd_online.cu). Both take q and k rotated once by the rotation
// pass (R1, flash_bwd_online.cu) and differ only in where P comes from:
//   * K4, K5 (kStats false): P = exp(S - lse), lse the forward's (K3);
//   * K2 (kStats true): P = exp(S - m) * (1/l), m and l the row max and
//     denominator its dq kernel finds in a statistics pass of its own,
//     which also gives delta = sum_j P_ij dP_ij (the resident VJP saves no
//     lse: meant_tpu/ops/flash/kernel.py:851-862, :371). On a batch row
//     whose keys are all masked this is P = 1/s, where K4/K5's is 1.
//
// The dq kernel, one block per (bh, 64-row q tile), walks the Kr/V tiles
// up to the diagonal (K2: twice, the statistics pass then dS), forms dS
// and accumulates dQr in fp32 registers. The dk/dv kernel, one block per
// (bh, 64-row k tile), walks the Qr/dO tiles from the diagonal,
// recomputes S^T = Kr Qr^T and dP^T = V dO^T and accumulates dV and dKr.
// The rotation's adjoint is applied once in each epilogue. Every output
// element has one writer, no atomics: the result is deterministic.
//
// A block is its consumer warpgroups and a producer (Layout below). The
// producer brings the block's own two tiles, then the streamed ones,
// through TMA (hopper.cuh) into a ring of stages, each with a full and an
// empty mbarrier; the dk/dv producer also stages the streamed rows'
// statistics, read one tile ahead. The consumers run wgmma: S and dP with
// both operands K-major in shared memory (m64n64k16, summed in k16 steps
// into one fp32 accumulator); then dQr += dS Kr, dV += T(P^T) dO and dKr
// += dS^T Qr with A in registers -- the score accumulator rounded to bf16
// in place is the A fragment, exactly where the reference rounds P and dS
// -- and B the streamed row-major tile read MN-major through the transpose
// bit (m64nNk16, N the gradient columns a warpgroup holds). Between the
// products the consumers issue more instructions than the tensor cores
// need cycles, so only the diagonal and ragged tiles mask element by
// element; every other tile takes the key mask as a per-column bias (the
// same arithmetic, rounded operation by operation as the reference rounds
// it). The grid is (tile, bh): a head's blocks run together and share its
// streamed tiles in L2, those with the most tiles to walk first. Rows past
// s_q and keys past s_k get P = 0 and are never written; a key tile that
// no causal q row reaches (s_k > s_q) writes zeros.
//
// Both kernels are templates on the head dim D, a [64][D] tile being D / 32
// TMA boxes: 64, 96, 128, 192 and 256 for K2, K4 and K5 (past 128 in bf16
// at an even d), and past 256 their sliced forms (below) at 384, with and
// without the statistics pass; an odd d, fp32 past 128 and the other
// widths past 256 take flash_wide.cuh (768 in bf16
// flash_bwd_chain.cuh). At 192, 256 and 384 they replace
// meant_tpu/ops/flash/kernel.py:_bwd_kernel (K2), _bwd_dq_kernel (K4) and
// _bwd_dkdv_kernel (K5) as at the narrower widths. The layouts:
//   * D <= 128: one consumer warpgroup and a producer warp, three stages.
//     At D = 128 the dk/dv kernel holds two 64 x 128 fp32 accumulators
//     (128 registers a thread) beside S and dP.
//   * the dq kernel (K4, K2's) at D = 192: the same block; dQ is 96
//     registers a thread, S and dP 32 each, within the 255 a thread of a
//     160-thread block may hold. Eight tiles of 24 KB: three stages.
//   * the dq kernel at D = 256 and the dk/dv kernel (K5, K2's) at 192 and
//     256: two consumer warpgroups that split the D columns of dQ (of dK
//     and dV): 64 registers of dQ, 96 of dK and dV at 192, 128 at 256. Each
//     forms the tile's whole S and dP (S^T and dP^T) itself, which costs
//     K5 1.5x its tensor work (K4 at 256: 5/3) and needs no exchange; so K2's
//     statistics pass runs in each dq warpgroup on its own (m, l and delta
//     depend on S and dP alone: the same values in both), and the first
//     writes them; the dk/dv producer stages them once for both warpgroups
//     (DkdvSmem). The other split -- one warpgroup
//     forms S^T, the other dP^T, and they swap halves through shared
//     memory -- saves those products but puts a barrier between the
//     warpgroups on every tile. Chosen the first: K5 at (40, 4096, 192)
//     reads 1.63 ms against 1.56 for the one-warpgroup d = 96 body on the
//     same work (80, 4096, 96), so the repeated products cost about 5%.
//     The producer is then a whole warpgroup, since setmaxnreg moves
//     registers a warpgroup at a time: of the 168 a thread the block
//     launches with (65,536 / 384), the producer keeps 24 and each consumer
//     thread takes 240. Three stages at 192 (~197 KB), two at 256 (six
//     tiles of 32 KB, ~198 KB). ptxas: K4 at 192 204 registers, the others
//     168 at launch, none spills (chip_smoke.py prints the report).
//   * past 256 (the sliced kernels, SlicedLayout): neither a block's
//     resident [64][384] tile pair beside whole streamed tiles nor dK + dV
//     for 64 keys (192 KB of fp32) fits, so the streamed tiles come in
//     kSliceCols-column slices through the ring (five stages of 24 KB beside
//     the two resident 48 KB tiles), each released once the products of the
//     next are under way (sliced_scores), as the forwards' sliced ring does
//     (flash_fwd.cu). The dq kernel holds dQ in two consumer warpgroups of
//     192 columns (96 registers each beside S and dP) and keeps the Kr
//     slices for dQ += dS Kr; the dk/dv kernel holds kSlicedDkdvCols columns
//     of dK and dV a block (the D = 192 dk/dv layout, S^T and dP^T formed
//     over all 384 columns), the column groups on the grid, and keeps the Qr
//     and dO slices of its columns. At (160, 512, 384) 96-column slices
//     (nine stages) read the same as 192 (1.136 against 1.138 ms), and 96
//     columns a dk/dv block (one consumer warpgroup, four groups) 1.36x
//     slower (tools/k23_variants.py --kernels K2wide; PERF.md). K2 runs
//     them with its statistics pass (the dq kernel walks the key tiles
//     twice and writes m, 1/l and delta); K4 and K5 (src4096 --num_heads
//     2's (20, 4096, 384)) without: the dq kernel walks the key tiles once
//     with row_m = lse and the given delta, the dk/dv producer stages lse
//     and delta with each q tile. ptxas: 168 registers at launch for
//     both kernels, no spills.
// Bound on an H100 SXM at src4096's launch at --num_heads 4, (40, 4096,
// 192) bf16 causal: K4 386.5 GFLOP, 0.39 ms, K5 515.4 GFLOP, 0.52 ms, both
// bound by operations (the same products as at (80, 4096, 96)); at
// --num_heads 3, (30, 4096, 256), the same. They read K4 1.08 / 1.22 ms
// and K5 1.63 / 1.47 ms there (PERF.md). K2 at meant_src --num_heads 4's
// (320, 512, 192) causal and --num_heads 3's (240, 512, 256) must move 442
// MB (0.132 ms) for 80.7 GFLOP of products (0.082 ms), at (320, 196, 192)
// 169 MB (0.051 ms): bound by bytes, as at d = 96 (flash_bwd.cu); so is K2
// at --num_heads 2's (160, 512, 384), 443 MB (0.132 ms) for 80.8 GFLOP,
// where the sliced kernels form S and dP 8 times over (each dq warpgroup
// twice, each dk/dv warpgroup once in each of two column groups). K4 and K5
// at src4096 --num_heads 2's (20, 4096, 384) causal: the products of (40,
// 4096, 192), K4 386.5 GFLOP (0.39094 ms), K5 515.4 GFLOP (0.52126 ms),
// bound by operations; there the sliced dq kernel forms S and dP in each
// of its two warpgroups (5/3 of K4's products on the tensor cores), the
// dk/dv kernel S^T and dP^T in each warpgroup of each of two column groups
// (10/4 of K5's).
// The order of the sums of S and dP (k16 steps on the tensor cores) is not
// the plain versions' column order. tools/wide_sum_order.py holds that
// order to the gradients' element bar at the widths these bodies take: 0
// elements past it at d = 192 and 256 (K4 + K5 at s=4096 and at the ring's
// chunk, K2 at s=512 and 196) and at 384 (K2 at s=512 masked and 196, K4
// + K5 at s=4096), where at d = 768 such sums put single dq elements past
// it (PERF.md).

#pragma once

#include "flash_common.cuh"
#include "hopper.cuh"

namespace meant {
namespace bwd {

constexpr int kTile = hopper::kRows;     // q rows (dq) or keys (dk/dv)
constexpr int kStages = 3;               // ring of streamed tiles
constexpr int kWarpgroup = 128;          // threads of a warpgroup
constexpr int kNs = kTile / 8;           // n8 blocks of a score
// setmaxnreg's registers a thread in a block of two consumer warpgroups
constexpr int kProducerRegs = 24, kConsumerRegs = 240;

// The stages of the ring at head dim D (the layouts above).
template <int D>
__host__ __device__ constexpr int stages() {
  return D <= 192 ? kStages : 2;
}

// The block of the dq (kDkdv false) or dk/dv kernel at head dim D (the
// layouts above): kWGs consumer warpgroups, warpgroup wg holding the
// gradients' columns [wg * kCols, (wg + 1) * kCols), then the producer, a
// warp beside one consumer warpgroup and a whole warpgroup beside two.
template <int D, bool kDkdv>
struct Layout {
  static constexpr int kWGs = D <= 128 || (D == 192 && !kDkdv) ? 1 : 2;
  static constexpr int kCols = D / kWGs;
  static constexpr int kColBytes =
      kCols / hopper::kBoxCols * hopper::kBoxBytes;
  static constexpr int kConsumers = kWarpgroup * kWGs;
  static constexpr int kBlock = kConsumers + (kWGs == 1 ? 32 : kWarpgroup);
};

// Tiles first, each at a multiple of 1024 bytes from the aligned start.
template <int D>
struct DqSmem {
  static constexpr int kTileBytes = hopper::tile_bytes<D>();
  static constexpr int kN = stages<D>();
  uint8_t q[kTileBytes];       // this block's Qr rows
  uint8_t dout[kTileBytes];    // and their dO
  uint8_t k[kN][kTileBytes];   // the ring: Kr
  uint8_t v[kN][kTileBytes];   // and V
  uint64_t fixed_full, full[kN], empty[kN];
};

template <int D>
struct DkdvSmem {
  static constexpr int kTileBytes = hopper::tile_bytes<D>();
  static constexpr int kN = stages<D>();
  uint8_t k[kTileBytes];         // this block's Kr rows
  uint8_t v[kTileBytes];         // and their V
  uint8_t q[kN][kTileBytes];     // the ring: Qr
  uint8_t dout[kN][kTileBytes];  // dO
  float m[kN][kTile];            // and the rows' lse (or m),
  float delta[kN][kTile];        // delta
  float il[kN][kTile];           // and 1/l (K2 only)
  uint64_t fixed_full, full[kN], empty[kN];
};

// dS = T(p * (dp - delta) * scale) for two neighbouring columns, rounded to
// nearest as the reference rounds it, packed as one A-fragment register.
__device__ __forceinline__ uint32_t ds_pair(float p0, float p1, float dp0,
                                            float dp1, float dl0, float dl1,
                                            float scale) {
  return pack_pair(p0 * (dp0 - dl0) * scale, p1 * (dp1 - dl1) * scale);
}

// Whether a dq tile masks element by element: the diagonal, or ragged.
__device__ __forceinline__ bool dq_edge(int causal, int tile, int qt, int k0,
                                        int seq_k) {
  return (causal && tile == qt) || k0 + kTile > seq_k;
}

// Whether a dk/dv tile masks element by element: the diagonal (the first
// q tile of a causal walk), or ragged in q or in keys.
__device__ __forceinline__ bool dkdv_edge(int causal, int it, int q0, int k0,
                                          int seq_q, int seq_k) {
  return (causal && it == 0) || q0 + kTile > seq_q || k0 + kTile > seq_k;
}

// P = exp(score - m), times 1/l for K2 (p_of, flash_common.cuh); K2's
// statistics pass is stats_tile there, shared with K1.

// The dq kernel's dS for one tile as A fragments (ds[k] covers keys
// 16k..16k+15) from the S and dP accumulators. kEdge: the diagonal or the
// ragged tile, masked element by element (masked_score); else every score
// is live and the key mask is a per-column bias.
template <bool kEdge, bool kStats>
__device__ __forceinline__ void dq_tile_ds(
    uint32_t (&ds)[kTile / 16][4], const float (&s)[4 * kNs],
    const float (&dp)[4 * kNs], const int (&row)[2], const float (&row_m)[2],
    const float (&row_il)[2], const float (&row_delta)[2], int k0, int t,
    int seq_k, int causal, const float* km, float scale) {
#pragma unroll
  for (int j = 0; j < kNs; ++j) {
    float bias[2];
    if (!kEdge) column_bias(bias, km, k0 + j * 8 + 2 * t);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float p[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float acc = s[4 * j + 2 * h + e];
        if (kEdge) {
          const float sc = masked_score(acc, scale, row[h],
                                        k0 + j * 8 + 2 * t + e, seq_k,
                                        causal, km);
          p[e] = (sc == -INFINITY) ? 0.f
                                   : p_of<kStats>(sc, row_m[h], row_il[h]);
        } else {
          p[e] = p_of<kStats>(interior_score(acc, scale, bias[e]), row_m[h],
                              row_il[h]);
        }
      }
      ds[j >> 1][(j & 1) * 2 + h] =
          ds_pair(p[0], p[1], dp[4 * j + 2 * h], dp[4 * j + 2 * h + 1],
                  row_delta[h], row_delta[h], scale);
    }
  }
}

// The dk/dv kernel's T(P^T) and dS^T for one tile as A fragments (q rows
// 16k..16k+15 in [k]) from the S^T and dP^T accumulators; m_s, il_s and
// delta_s are the tile's staged rows. kEdge as in dq_tile_ds; key_bias is
// the mask's bias of this thread's two keys.
template <bool kEdge, bool kStats>
__device__ __forceinline__ void dkdv_tile_p_ds(
    uint32_t (&pt)[kTile / 16][4], uint32_t (&dst)[kTile / 16][4],
    const float (&s)[4 * kNs], const float (&dp)[4 * kNs],
    const int (&key)[2], const float (&key_bias)[2], const float* m_s,
    const float* il_s, const float* delta_s, int q0, int t, int seq_q,
    int seq_k, int causal, const float* km, float scale) {
#pragma unroll
  for (int j = 0; j < kNs; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int qi = j * 8 + 2 * t;
      float p[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float acc = s[4 * j + 2 * h + e];
        const float il = kStats ? il_s[qi + e] : 1.f;
        if (kEdge) {
          const float sc = masked_score(acc, scale, q0 + qi + e, key[h],
                                        seq_k, causal, km);
          p[e] = (sc == -INFINITY || q0 + qi + e >= seq_q)
                     ? 0.f
                     : p_of<kStats>(sc, m_s[qi + e], il);
        } else {
          p[e] = p_of<kStats>(interior_score(acc, scale, key_bias[h]),
                              m_s[qi + e], il);
        }
      }
      pt[j >> 1][(j & 1) * 2 + h] = pack_pair(p[0], p[1]);
      dst[j >> 1][(j & 1) * 2 + h] =
          ds_pair(p[0], p[1], dp[4 * j + 2 * h], dp[4 * j + 2 * h + 1],
                  delta_s[qi], delta_s[qi + 1], scale);
    }
}

// dq (K4; K2's dq and statistics when kStats). Grid (q tiles, bh); block
// Layout<D, false>::kBlock threads. K4 reads row_m = lse and row_delta; K2
// writes row_m = m, row_il = 1/l and row_delta = delta of every row below
// seq_q.
template <bool kStats, int D>
__global__ void __launch_bounds__((Layout<D, false>::kBlock), 1)
    flash_bwd_dq_wgmma_kernel(
    const __grid_constant__ CUtensorMap tm_q,
    const __grid_constant__ CUtensorMap tm_k,
    const __grid_constant__ CUtensorMap tm_v,
    const __grid_constant__ CUtensorMap tm_do, float* __restrict__ row_m_g,
    float* __restrict__ row_il_g, float* __restrict__ row_delta_g,
    bf16* __restrict__ dq, const float* __restrict__ qcos,
    const float* __restrict__ qsin, const float* __restrict__ kmask,
    int mask_rows, int seq_q, int seq_k, int num_heads, float scale,
    int causal) {
  using namespace hopper;
  using L = Layout<D, false>;
  constexpr int kNd = L::kCols / 8;        // n8 blocks of this dQ share
  constexpr int kTileBytes = tile_bytes<D>();
  constexpr int kN = stages<D>();
  extern __shared__ uint8_t smem_raw[];
  DqSmem<D>& sm = aligned_smem<DqSmem<D>>(smem_raw);
  const int n_tq = (seq_q + kTile - 1) / kTile;
  const int n_tk = (seq_k + kTile - 1) / kTile;
  const int bh = blockIdx.y, qt = n_tq - 1 - (int)blockIdx.x;
  const int q0 = qt * kTile;
  const int n_tiles = causal ? min(qt + 1, n_tk) : n_tk;
  constexpr int kPasses = kStats ? 2 : 1;  // K2 walks the tiles twice
  if (threadIdx.x == 0) {
    mbar_init(&sm.fixed_full, 1);
    for (int st = 0; st < kN; ++st) {
      mbar_init(&sm.full[st], 1);
      mbar_init(&sm.empty[st], L::kConsumers);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x >= L::kConsumers) {  // the producer: one thread issues TMA
    if constexpr (L::kWGs > 1) setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == L::kConsumers) {
      mbar_arrive_expect_tx(&sm.fixed_full, 2 * kTileBytes);
      tma_load_tile<D>(sm.q, &tm_q, &sm.fixed_full, q0, bh);
      tma_load_tile<D>(sm.dout, &tm_do, &sm.fixed_full, q0, bh);
      for (int it = 0; it < kPasses * n_tiles; ++it) {
        const int st = it % kN, k0 = (it % n_tiles) * kTile;
        if (it >= kN) mbar_wait(&sm.empty[st], (it / kN - 1) & 1);
        mbar_arrive_expect_tx(&sm.full[st], 2 * kTileBytes);
        tma_load_tile<D>(sm.k[st], &tm_k, &sm.full[st], k0, bh);
        tma_load_tile<D>(sm.v[st], &tm_v, &sm.full[st], k0, bh);
      }
    }
    return;
  }
  if constexpr (L::kWGs > 1) setmaxnreg_inc<kConsumerRegs>();

  // this warpgroup's dQ columns start wg * kCols in (wg_bytes into a tile)
  const int wg = L::kWGs == 1 ? 0 : threadIdx.x / kWarpgroup;
  const int wg_bytes = wg * L::kColBytes;
  const int warp = (threadIdx.x % kWarpgroup) / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int row[2] = {q0 + warp * 16 + g, q0 + warp * 16 + g + 8};
  const float* km = nullptr;
  if (kmask != nullptr)
    km = kmask + (size_t)(mask_rows == 1 ? 0 : bh / num_heads) * seq_k;
  // Accumulator element 4j + 2h + e: row 16 warp + g + 8h, column 8j + 2t + e.
  float dq_acc[4 * kNd], s[4 * kNs], dp[4 * kNs];
  zero_regs(dq_acc);
  zero_regs(s);
  zero_regs(dp);
  // S and dP of the tile in stage st
  const auto scores = [&](int st) {
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_m64n64k16_ss(s, kmajor_desc(sm.q, kk), kmajor_desc(sm.k[st], kk),
                         kk > 0);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_m64n64k16_ss(dp, kmajor_desc(sm.dout, kk),
                         kmajor_desc(sm.v[st], kk), kk > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);
    fence_regs(dp);
  };

  float row_m[2], row_il[2] = {1.f, 1.f}, row_delta[2];
  int ring = 0;  // tiles taken from the ring so far
  mbar_wait(&sm.fixed_full, 0);
  if constexpr (kStats) {
    // every warpgroup forms the rows' whole S and dP, so each finds the
    // same m, l and delta for its rows without an exchange; the first
    // writes them
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
    float dsum[2] = {0.f, 0.f};
    for (int it = 0; it < n_tiles; ++it, ++ring) {
      const int st = ring % kN, k0 = it * kTile;
      mbar_wait(&sm.full[st], (ring / kN) & 1);
      scores(st);
      mbar_arrive(&sm.empty[st]);  // the products have read the stage
      if (dq_edge(causal, it, qt, k0, seq_k))
        stats_tile<true, true>(s, dp, m, l, dsum, row, k0, t, seq_k, causal,
                               km, scale);
      else
        stats_tile<false, true>(s, dp, m, l, dsum, row, k0, t, seq_k,
                                causal, km, scale);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float lt = row_sum(l[h]);
      row_m[h] = (m[h] == -INFINITY) ? 0.f : m[h];
      row_il[h] = lt > 0.f ? 1.0f / lt : 0.f;
      row_delta[h] = row_sum(dsum[h]) * row_il[h];
      if (wg == 0 && t == 0 && row[h] < seq_q) {
        const size_t i = (size_t)bh * seq_q + row[h];
        row_m_g[i] = row_m[h];
        row_il_g[i] = row_il[h];
        row_delta_g[i] = row_delta[h];
      }
    }
  } else {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const bool valid = row[h] < seq_q;
      const size_t i = (size_t)bh * seq_q + row[h];
      row_m[h] = valid ? row_m_g[i] : 0.f;
      row_delta[h] = valid ? row_delta_g[i] : 0.f;
    }
  }

  for (int it = 0; it < n_tiles; ++it, ++ring) {
    const int st = ring % kN, k0 = it * kTile;
    mbar_wait(&sm.full[st], (ring / kN) & 1);
    scores(st);
    uint32_t ds[kTile / 16][4];  // A fragments of dS, one per 16 keys
    if (dq_edge(causal, it, qt, k0, seq_k))
      dq_tile_ds<true, kStats>(ds, s, dp, row, row_m, row_il, row_delta, k0,
                               t, seq_k, causal, km, scale);
    else
      dq_tile_ds<false, kStats>(ds, s, dp, row, row_m, row_il, row_delta,
                                k0, t, seq_k, causal, km, scale);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk)
      wgmma_m64nNk16_rs<L::kCols, kMNMajor>(
          dq_acc, ds[kk], mnmajor_desc(sm.k[st] + wg_bytes, kk));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dq_acc);
    fence_regs(ds);
    mbar_arrive(&sm.empty[st]);
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (row[h] >= seq_q) continue;
    bf16* out = dq + ((size_t)bh * seq_q + row[h]) * D;
    const float* cr = qcos + (size_t)row[h] * D;
    const float* sr = qsin + (size_t)row[h] * D;
#pragma unroll
    for (int j = 0; j < kNd; ++j)
      store_adjoint<bf16>(out, cr, sr, wg * L::kCols + j * 8 + 2 * t,
                          dq_acc[4 * j + 2 * h], dq_acc[4 * j + 2 * h + 1]);
  }
}

// dk and dv (K5; K2's when kStats). Grid (k tiles, bh); block
// Layout<D, true>::kBlock threads. Reads row_m (K5: lse; K2: m), row_delta
// and, for K2, row_il.
template <bool kStats, int D>
__global__ void __launch_bounds__((Layout<D, true>::kBlock), 1)
    flash_bwd_dkdv_wgmma_kernel(
    const __grid_constant__ CUtensorMap tm_q,
    const __grid_constant__ CUtensorMap tm_k,
    const __grid_constant__ CUtensorMap tm_v,
    const __grid_constant__ CUtensorMap tm_do,
    const float* __restrict__ row_m_g, const float* __restrict__ row_il_g,
    const float* __restrict__ row_delta_g, bf16* __restrict__ dk,
    bf16* __restrict__ dv, const float* __restrict__ kcos,
    const float* __restrict__ ksin, const float* __restrict__ kmask,
    int mask_rows, int seq_q, int seq_k, int num_heads, float scale,
    int causal) {
  using namespace hopper;
  using L = Layout<D, true>;
  constexpr int kNd = L::kCols / 8;        // n8 blocks of this dK, dV share
  constexpr int kTileBytes = tile_bytes<D>();
  constexpr int kN = stages<D>();
  extern __shared__ uint8_t smem_raw[];
  DkdvSmem<D>& sm = aligned_smem<DkdvSmem<D>>(smem_raw);
  const int n_tq = (seq_q + kTile - 1) / kTile;
  const int bh = blockIdx.y, kt = blockIdx.x;  // low k tiles see most rows
  const int k0 = kt * kTile;
  // the q tiles from the diagonal on (none when s_k > s_q leaves this key
  // tile past every causal row)
  const int q_first = causal ? kt : 0, n_tiles = max(0, n_tq - q_first);
  if (threadIdx.x == 0) {
    mbar_init(&sm.fixed_full, 1);
    for (int st = 0; st < kN; ++st) {
      mbar_init(&sm.full[st], 32);  // the producer warp's lanes
      mbar_init(&sm.empty[st], L::kConsumers);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x >= L::kConsumers) {  // the producer warp
    if constexpr (L::kWGs > 1) {       // (the first of its warpgroup)
      setmaxnreg_dec<kProducerRegs>();
      if (threadIdx.x >= L::kConsumers + 32) return;
    }
    const int lane = threadIdx.x - L::kConsumers;
    if (lane == 0) {
      mbar_arrive_expect_tx(&sm.fixed_full, 2 * kTileBytes);
      tma_load_tile<D>(sm.k, &tm_k, &sm.fixed_full, k0, bh);
      tma_load_tile<D>(sm.v, &tm_v, &sm.fixed_full, k0, bh);
    }
    // the statistics of rows lane and lane + 32 of a tile, read one tile
    // ahead so that their latency overlaps the wait for a free stage
    float rm[2], rd[2], ril[2];
    const auto fetch = [&](int it) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int i = (q_first + it) * kTile + lane + 32 * r;
        const size_t gi = (size_t)bh * seq_q + i;
        rm[r] = i < seq_q ? row_m_g[gi] : 0.f;
        rd[r] = i < seq_q ? row_delta_g[gi] : 0.f;
        if (kStats) ril[r] = i < seq_q ? row_il_g[gi] : 0.f;
      }
    };
    fetch(0);
    for (int it = 0; it < n_tiles; ++it) {
      const int st = it % kN, q0 = (q_first + it) * kTile;
      if (it >= kN) mbar_wait(&sm.empty[st], (it / kN - 1) & 1);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        sm.m[st][lane + 32 * r] = rm[r];
        sm.delta[st][lane + 32 * r] = rd[r];
        if (kStats) sm.il[st][lane + 32 * r] = ril[r];
      }
      if (lane == 0) {
        mbar_arrive_expect_tx(&sm.full[st], 2 * kTileBytes);
        tma_load_tile<D>(sm.q[st], &tm_q, &sm.full[st], q0, bh);
        tma_load_tile<D>(sm.dout[st], &tm_do, &sm.full[st], q0, bh);
      } else {
        mbar_arrive(&sm.full[st]);
      }
      if (it + 1 < n_tiles) fetch(it + 1);
    }
    return;
  }

  if constexpr (L::kWGs > 1) setmaxnreg_inc<kConsumerRegs>();

  // this warpgroup's dK and dV columns start wg * kCols in (wg_bytes into
  // a tile); both warpgroups hold the same 64 keys
  const int wg = L::kWGs == 1 ? 0 : threadIdx.x / kWarpgroup;
  const int wg_bytes = wg * L::kColBytes;
  const int warp = (threadIdx.x % kWarpgroup) / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int key[2] = {k0 + warp * 16 + g, k0 + warp * 16 + g + 8};
  const float* km = nullptr;
  if (kmask != nullptr)
    km = kmask + (size_t)(mask_rows == 1 ? 0 : bh / num_heads) * seq_k;
  float key_bias[2] = {0.f, 0.f};
#pragma unroll
  for (int h = 0; h < 2; ++h)
    if (km != nullptr && key[h] < seq_k)
      key_bias[h] = (1.0f - km[key[h]]) * -1e9f;
  // Accumulator element 4j + 2h + e: key 16 warp + g + 8h, column 8j + 2t + e.
  float dv_acc[4 * kNd], dk_acc[4 * kNd], s[4 * kNs], dp[4 * kNs];
  zero_regs(dv_acc);
  zero_regs(dk_acc);
  zero_regs(s);
  zero_regs(dp);
  mbar_wait(&sm.fixed_full, 0);
  for (int it = 0; it < n_tiles; ++it) {
    const int st = it % kN, q0 = (q_first + it) * kTile;
    mbar_wait(&sm.full[st], (it / kN) & 1);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)  // S^T: rows keys, columns q
      wgmma_m64n64k16_ss(s, kmajor_desc(sm.k, kk), kmajor_desc(sm.q[st], kk),
                         kk > 0);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)  // dP^T
      wgmma_m64n64k16_ss(dp, kmajor_desc(sm.v, kk),
                         kmajor_desc(sm.dout[st], kk), kk > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);
    fence_regs(dp);
    uint32_t pt[kTile / 16][4], dst[kTile / 16][4];  // T(P^T), dS^T
    if (dkdv_edge(causal, it, q0, k0, seq_q, seq_k))
      dkdv_tile_p_ds<true, kStats>(pt, dst, s, dp, key, key_bias, sm.m[st],
                                   sm.il[st], sm.delta[st], q0, t, seq_q,
                                   seq_k, causal, km, scale);
    else
      dkdv_tile_p_ds<false, kStats>(pt, dst, s, dp, key, key_bias, sm.m[st],
                                    sm.il[st], sm.delta[st], q0, t, seq_q,
                                    seq_k, causal, km, scale);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk)
      wgmma_m64nNk16_rs<L::kCols, kMNMajor>(
          dv_acc, pt[kk], mnmajor_desc(sm.dout[st] + wg_bytes, kk));
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk)
      wgmma_m64nNk16_rs<L::kCols, kMNMajor>(
          dk_acc, dst[kk], mnmajor_desc(sm.q[st] + wg_bytes, kk));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dv_acc);
    fence_regs(dk_acc);
    fence_regs(pt);
    fence_regs(dst);
    mbar_arrive(&sm.empty[st]);
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (key[h] >= seq_k) continue;
    bf16* dv_row = dv + ((size_t)bh * seq_k + key[h]) * D;
    bf16* dk_row = dk + ((size_t)bh * seq_k + key[h]) * D;
    const float* cr = kcos + (size_t)key[h] * D;
    const float* sr = ksin + (size_t)key[h] * D;
#pragma unroll
    for (int j = 0; j < kNd; ++j) {
      const int c = wg * L::kCols + j * 8 + 2 * t;
      dv_row[c] = from_f<bf16>(dv_acc[4 * j + 2 * h]);
      dv_row[c + 1] = from_f<bf16>(dv_acc[4 * j + 2 * h + 1]);
      store_adjoint<bf16>(dk_row, cr, sr, c, dk_acc[4 * j + 2 * h],
                          dk_acc[4 * j + 2 * h + 1]);
    }
  }
}

// ---- past 256: the sliced ring ---------------------------------------------

// The width of a ring stage past 256: Kr and V (dq kernel) or Qr and dO
// (dk/dv kernel) stream in slices of kSliceCols columns; and the gradients'
// columns a dk/dv block holds (a group of them on the grid's first axis).
constexpr int kSliceCols = 192;
constexpr int kSlicedDkdvCols = 192;

// The block of a sliced kernel at D: the dq kernel holds all of dQ's D
// columns, the dk/dv kernel kSlicedDkdvCols of dK's and dV's, in
// consumer warpgroups of 192 (dq) or 96 (dk/dv) columns and a producer:
// a warp beside one consumer warpgroup, a warpgroup beside two (setmaxnreg
// moves registers a warpgroup at a time).
template <int D, bool kDkdv>
struct SlicedLayout {
  static constexpr int kBlockCols = kDkdv ? kSlicedDkdvCols : D;
  static constexpr int kGroups = D / kBlockCols;  // blocks a tile, on the grid
  static constexpr int kCols = kDkdv ? 96 : 192;  // a consumer warpgroup's
  static constexpr int kWGs = kBlockCols / kCols;
  static constexpr int kSlices = D / kSliceCols;  // stages a streamed tile
  // a warpgroup's columns as products of kPartCols, each within one slice
  static constexpr int kPartCols = kCols < kSliceCols ? kCols : kSliceCols;
  static constexpr int kParts = kCols / kPartCols;
  static constexpr int kConsumers = kWarpgroup * kWGs;
  static constexpr int kBlock = kConsumers + (kWGs == 1 ? 32 : kWarpgroup);
  static_assert(D % kSliceCols == 0 && D % kBlockCols == 0 &&
                    kBlockCols % kCols == 0 &&
                    kSliceCols % kPartCols == 0 && kCols % kPartCols == 0,
                "slices, groups and warpgroups tile the columns");
};

// The block's two resident [64][D] tiles, then the ring of slices; in the
// dk/dv kernel each stage also carries the statistics of the streamed q
// rows (written with the block's first kept Qr slice).
template <int D, int kN>
struct SlicedSmem {
  uint8_t a[hopper::tile_bytes<D>()];   // dq: Qr rows; dk/dv: Kr rows
  uint8_t b[hopper::tile_bytes<D>()];   // dq: dO; dk/dv: V
  uint8_t ring[kN][hopper::tile_bytes<kSliceCols>()];
  float m[kN][kTile], delta[kN][kTile], il[kN][kTile];
  uint64_t fixed_full, full[kN], empty[kN];
};

// As many stages as fit beside the two resident tiles.
template <int D>
__host__ __device__ constexpr int sliced_stages() {
  return (232448 - 4096 - 2 * hopper::tile_bytes<D>()) /
         (hopper::tile_bytes<kSliceCols>() + 3 * kTile * 4);
}

// The slice that holds column c of a streamed tile, and c's byte offset
// within it (c a multiple of 32).
__host__ __device__ constexpr int slice_of(int c) { return c / kSliceCols; }
__host__ __device__ constexpr int slice_bytes_at(int c) {
  return c % kSliceCols / hopper::kBoxCols * hopper::kBoxBytes;
}

// S (or S^T) and dP (dP^T) of one tile pair over every column of D: the
// streamed tile's kSlices slices taken from the ring in order against the
// resident tile a, then its partner's against b (the j-th slice taken
// from stage (taken before + j) % kN). A slice is released once the
// products of the next are under way, but for the slices [keep_lo,
// keep_hi] of the streamed tile (and of its partner's with keep_b), which
// the caller releases. `take` and `release` run the ring.
template <int D, typename Take, typename Release>
__device__ __forceinline__ void sliced_scores(
    float (&s)[4 * kNs], float (&dp)[4 * kNs], const uint8_t* a,
    const uint8_t* b, uint8_t (*ring)[hopper::tile_bytes<kSliceCols>()],
    int keep_lo, int keep_hi, bool keep_b, Take&& take, Release&& release) {
  using namespace hopper;
  constexpr int kSlices = D / kSliceCols, kSteps = kSliceCols / 16;
  int prev = -1;
  bool prev_kept = false;
  // the products of slice j into acc, from resident tile res
  const auto step = [&](float(&acc)[4 * kNs], const uint8_t* res, int j,
                        bool keep) {
    const int cur = take();
#pragma unroll
    for (int kk = 0; kk < kSteps; ++kk)
      wgmma_m64n64k16_ss(acc, kmajor_desc(res, j * kSteps + kk),
                         kmajor_desc(ring[cur], kk), j > 0 || kk > 0);
    wgmma_commit();
    if (prev >= 0) {
      wgmma_wait<1>();
      if (!prev_kept) release(prev);
    }
    prev = cur;
    prev_kept = keep && j >= keep_lo && j <= keep_hi;
  };
  wgmma_fence();
#pragma unroll
  for (int j = 0; j < kSlices; ++j) step(s, a, j, true);
#pragma unroll
  for (int j = 0; j < kSlices; ++j) step(dp, b, j, keep_b);
  wgmma_wait<0>();
  if (!prev_kept) release(prev);
  fence_regs(s);
  fence_regs(dp);
}

// dq past 256 (K4; K2's dq and statistics when kStats). Grid (q tiles,
// bh); block SlicedLayout<D, false>::kBlock threads: two consumer
// warpgroups, each holding 192 of dQ's columns and forming the rows' whole
// S and dP, and a producer warpgroup whose first thread streams Kr's and
// V's slices of each key tile (twice for K2: the statistics pass, then dS;
// once for K4, which reads row_m = lse and row_delta). Every warpgroup
// needs every Kr slice for S; each keeps its own for dQ += dS Kr, so the
// Kr slices are released after that product, the V slices one product
// behind.
template <bool kStats, int D>
__global__ void __launch_bounds__((SlicedLayout<D, false>::kBlock), 1)
    flash_bwd_dq_sliced_kernel(
    const __grid_constant__ CUtensorMap tm_q,
    const __grid_constant__ CUtensorMap tm_k,
    const __grid_constant__ CUtensorMap tm_v,
    const __grid_constant__ CUtensorMap tm_do, float* __restrict__ row_m_g,
    float* __restrict__ row_il_g, float* __restrict__ row_delta_g,
    bf16* __restrict__ dq, const float* __restrict__ qcos,
    const float* __restrict__ qsin, const float* __restrict__ kmask,
    int mask_rows, int seq_q, int seq_k, int num_heads, float scale,
    int causal) {
  using namespace hopper;
  using L = SlicedLayout<D, false>;
  constexpr int kN = sliced_stages<D>();
  constexpr int kSlices = L::kSlices, kNd = L::kPartCols / 8;
  constexpr int kStageBytes = tile_bytes<kSliceCols>();
  static_assert(kN >= 2 * kSlices, "a tile's slices fit the ring at once");
  extern __shared__ uint8_t smem_raw[];
  SlicedSmem<D, kN>& sm = aligned_smem<SlicedSmem<D, kN>>(smem_raw);
  const int n_tq = (seq_q + kTile - 1) / kTile;
  const int n_tk = (seq_k + kTile - 1) / kTile;
  const int bh = blockIdx.y, qt = n_tq - 1 - (int)blockIdx.x;
  const int q0 = qt * kTile;
  const int n_tiles = causal ? min(qt + 1, n_tk) : n_tk;
  if (threadIdx.x == 0) {
    mbar_init(&sm.fixed_full, 1);
    for (int st = 0; st < kN; ++st) {
      mbar_init(&sm.full[st], 1);
      mbar_init(&sm.empty[st], L::kConsumers);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x >= L::kConsumers) {  // the producer: one thread
    if constexpr (L::kWGs > 1) setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == L::kConsumers) {
      mbar_arrive_expect_tx(&sm.fixed_full, 2 * tile_bytes<D>());
      tma_load_tile<D>(sm.a, &tm_q, &sm.fixed_full, q0, bh);
      tma_load_tile<D>(sm.b, &tm_do, &sm.fixed_full, q0, bh);
      int n = 0;  // stages filled
      for (int it = 0; it < (kStats ? 2 : 1) * n_tiles; ++it) {
        const int k0 = (it % n_tiles) * kTile;
        for (int j = 0; j < 2 * kSlices; ++j, ++n) {
          const int st = n % kN;
          if (n >= kN) mbar_wait(&sm.empty[st], (n / kN - 1) & 1);
          mbar_arrive_expect_tx(&sm.full[st], kStageBytes);
          tma_load_cols<kSliceCols>(sm.ring[st], j < kSlices ? &tm_k : &tm_v,
                                    &sm.full[st], (j % kSlices) * kSliceCols,
                                    k0, bh);
        }
      }
    }
    return;
  }
  if constexpr (L::kWGs > 1) setmaxnreg_inc<kConsumerRegs>();

  const int wg = threadIdx.x / kWarpgroup;
  const int warp = (threadIdx.x % kWarpgroup) / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int row[2] = {q0 + warp * 16 + g, q0 + warp * 16 + g + 8};
  const float* km = nullptr;
  if (kmask != nullptr)
    km = kmask + (size_t)(mask_rows == 1 ? 0 : bh / num_heads) * seq_k;
  float dq_acc[L::kParts][4 * kNd], s[4 * kNs], dp[4 * kNs];
#pragma unroll
  for (int p = 0; p < L::kParts; ++p) zero_regs(dq_acc[p]);
  zero_regs(s);
  zero_regs(dp);
  int ring = 0;  // stages taken so far
  const auto take = [&]() {
    const int st = ring % kN;
    mbar_wait(&sm.full[st], (ring / kN) & 1);
    ++ring;
    return st;
  };
  const auto release = [&](int st) { mbar_arrive(&sm.empty[st]); };

  float row_m[2], row_il[2] = {1.f, 1.f}, row_delta[2];
  mbar_wait(&sm.fixed_full, 0);
  if constexpr (kStats) {
    // each warpgroup finds the same m, l and delta; the first writes them
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
    float dsum[2] = {0.f, 0.f};
    for (int it = 0; it < n_tiles; ++it) {
      const int k0 = it * kTile;
      sliced_scores<D>(s, dp, sm.a, sm.b, sm.ring, kSlices, kSlices, false,
                       take, release);
      if (dq_edge(causal, it, qt, k0, seq_k))
        stats_tile<true, true>(s, dp, m, l, dsum, row, k0, t, seq_k, causal,
                               km, scale);
      else
        stats_tile<false, true>(s, dp, m, l, dsum, row, k0, t, seq_k,
                                causal, km, scale);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float lt = row_sum(l[h]);
      row_m[h] = (m[h] == -INFINITY) ? 0.f : m[h];
      row_il[h] = lt > 0.f ? 1.0f / lt : 0.f;
      row_delta[h] = row_sum(dsum[h]) * row_il[h];
      if (wg == 0 && t == 0 && row[h] < seq_q) {
        const size_t i = (size_t)bh * seq_q + row[h];
        row_m_g[i] = row_m[h];
        row_il_g[i] = row_il[h];
        row_delta_g[i] = row_delta[h];
      }
    }
  } else {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const bool valid = row[h] < seq_q;
      const size_t i = (size_t)bh * seq_q + row[h];
      row_m[h] = valid ? row_m_g[i] : 0.f;
      row_delta[h] = valid ? row_delta_g[i] : 0.f;
    }
  }

  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = it * kTile;
    // keep every Kr slice for dQ += dS Kr; slice j is in stage kr_st(j)
    const int base = ring;
    const auto kr_st = [&](int j) { return (base + j) % kN; };
    sliced_scores<D>(s, dp, sm.a, sm.b, sm.ring, 0, kSlices - 1, false,
                     take, release);
    uint32_t ds[kTile / 16][4];
    if (dq_edge(causal, it, qt, k0, seq_k))
      dq_tile_ds<true, kStats>(ds, s, dp, row, row_m, row_il, row_delta,
                               k0, t, seq_k, causal, km, scale);
    else
      dq_tile_ds<false, kStats>(ds, s, dp, row, row_m, row_il, row_delta,
                                k0, t, seq_k, causal, km, scale);
    wgmma_fence();
#pragma unroll
    for (int p = 0; p < L::kParts; ++p) {
      const int c = wg * L::kCols + p * L::kPartCols;
      const uint8_t* kr = sm.ring[kr_st(slice_of(c))] + slice_bytes_at(c);
#pragma unroll
      for (int kk = 0; kk < kTile / 16; ++kk)
        wgmma_m64nNk16_rs<L::kPartCols, kMNMajor>(dq_acc[p], ds[kk],
                                                  mnmajor_desc(kr, kk));
    }
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int p = 0; p < L::kParts; ++p) fence_regs(dq_acc[p]);
    fence_regs(ds);
#pragma unroll
    for (int j = 0; j < kSlices; ++j) release(kr_st(j));
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (row[h] >= seq_q) continue;
    bf16* out = dq + ((size_t)bh * seq_q + row[h]) * D;
    const float* cr = qcos + (size_t)row[h] * D;
    const float* sr = qsin + (size_t)row[h] * D;
#pragma unroll
    for (int p = 0; p < L::kParts; ++p)
#pragma unroll
      for (int j = 0; j < kNd; ++j)
        store_adjoint<bf16>(out, cr, sr,
                            wg * L::kCols + p * L::kPartCols + j * 8 + 2 * t,
                            dq_acc[p][4 * j + 2 * h],
                            dq_acc[p][4 * j + 2 * h + 1]);
  }
}

// dk and dv past 256 (K5; K2's when kStats). Grid (k tiles x column
// groups, bh), a key tile's groups side by side; block SlicedLayout<D,
// true>::kBlock threads: consumer warpgroups of 96 of the group's columns
// of dK and dV, each forming the tile pair's whole S^T and dP^T from the
// resident Kr and V and the streamed Qr and dO slices, and a producer warp
// (of a warpgroup) that stages the streamed rows' statistics (K5: lse and
// delta; K2: m, 1/l and delta) with the block's first kept Qr slice. The
// slices that hold the group's columns are kept for dV += T(P^T) dO and
// dK += dS^T Qr; the others are released one product behind.
template <bool kStats, int D>
__global__ void __launch_bounds__((SlicedLayout<D, true>::kBlock), 1)
    flash_bwd_dkdv_sliced_kernel(
    const __grid_constant__ CUtensorMap tm_q,
    const __grid_constant__ CUtensorMap tm_k,
    const __grid_constant__ CUtensorMap tm_v,
    const __grid_constant__ CUtensorMap tm_do,
    const float* __restrict__ row_m_g, const float* __restrict__ row_il_g,
    const float* __restrict__ row_delta_g, bf16* __restrict__ dk,
    bf16* __restrict__ dv, const float* __restrict__ kcos,
    const float* __restrict__ ksin, const float* __restrict__ kmask,
    int mask_rows, int seq_q, int seq_k, int num_heads, float scale,
    int causal) {
  using namespace hopper;
  using L = SlicedLayout<D, true>;
  constexpr int kN = sliced_stages<D>();
  constexpr int kSlices = L::kSlices, kNd = L::kPartCols / 8;
  constexpr int kStageBytes = tile_bytes<kSliceCols>();
  static_assert(kN >= 2 * kSlices, "a tile's slices fit the ring at once");
  extern __shared__ uint8_t smem_raw[];
  SlicedSmem<D, kN>& sm = aligned_smem<SlicedSmem<D, kN>>(smem_raw);
  const int n_tq = (seq_q + kTile - 1) / kTile;
  const int bh = blockIdx.y;
  const int kt = (int)blockIdx.x / L::kGroups;
  const int c0 = (int)blockIdx.x % L::kGroups * L::kBlockCols;
  const int k0 = kt * kTile;
  // the slices holding this block's columns, kept for the products; the
  // statistics ride with the first
  const int keep_lo = slice_of(c0), keep_hi = slice_of(c0 + L::kBlockCols - 1);
  const int q_first = causal ? kt : 0, n_tiles = max(0, n_tq - q_first);
  if (threadIdx.x == 0) {
    mbar_init(&sm.fixed_full, 1);
    for (int st = 0; st < kN; ++st) {
      mbar_init(&sm.full[st], 32);  // the producer warp's lanes
      mbar_init(&sm.empty[st], L::kConsumers);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x >= L::kConsumers) {  // the producer warp
    if constexpr (L::kWGs > 1) {
      setmaxnreg_dec<kProducerRegs>();
      if (threadIdx.x >= L::kConsumers + 32) return;
    }
    const int lane = threadIdx.x - L::kConsumers;
    if (lane == 0) {
      mbar_arrive_expect_tx(&sm.fixed_full, 2 * tile_bytes<D>());
      tma_load_tile<D>(sm.a, &tm_k, &sm.fixed_full, k0, bh);
      tma_load_tile<D>(sm.b, &tm_v, &sm.fixed_full, k0, bh);
    }
    float rm[2], rd[2], ril[2];
    const auto fetch = [&](int it) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int i = (q_first + it) * kTile + lane + 32 * r;
        const size_t gi = (size_t)bh * seq_q + i;
        rm[r] = i < seq_q ? row_m_g[gi] : 0.f;
        rd[r] = i < seq_q ? row_delta_g[gi] : 0.f;
        if (kStats) ril[r] = i < seq_q ? row_il_g[gi] : 0.f;
      }
    };
    fetch(0);
    int n = 0;
    for (int it = 0; it < n_tiles; ++it) {
      const int q0 = (q_first + it) * kTile;
      for (int j = 0; j < 2 * kSlices; ++j, ++n) {
        const int st = n % kN;
        if (n >= kN) mbar_wait(&sm.empty[st], (n / kN - 1) & 1);
        if (j == keep_lo) {
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            sm.m[st][lane + 32 * r] = rm[r];
            sm.delta[st][lane + 32 * r] = rd[r];
            if (kStats) sm.il[st][lane + 32 * r] = ril[r];
          }
        }
        if (lane == 0) {
          mbar_arrive_expect_tx(&sm.full[st], kStageBytes);
          tma_load_cols<kSliceCols>(
              sm.ring[st], j < kSlices ? &tm_q : &tm_do, &sm.full[st],
              (j % kSlices) * kSliceCols, q0, bh);
        } else {
          mbar_arrive(&sm.full[st]);
        }
      }
      if (it + 1 < n_tiles) fetch(it + 1);
    }
    return;
  }
  if constexpr (L::kWGs > 1) setmaxnreg_inc<kConsumerRegs>();

  const int wg = threadIdx.x / kWarpgroup;
  const int warp = (threadIdx.x % kWarpgroup) / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int key[2] = {k0 + warp * 16 + g, k0 + warp * 16 + g + 8};
  const float* km = nullptr;
  if (kmask != nullptr)
    km = kmask + (size_t)(mask_rows == 1 ? 0 : bh / num_heads) * seq_k;
  float key_bias[2] = {0.f, 0.f};
#pragma unroll
  for (int h = 0; h < 2; ++h)
    if (km != nullptr && key[h] < seq_k)
      key_bias[h] = (1.0f - km[key[h]]) * -1e9f;
  float dv_acc[L::kParts][4 * kNd], dk_acc[L::kParts][4 * kNd];
  float s[4 * kNs], dp[4 * kNs];
#pragma unroll
  for (int p = 0; p < L::kParts; ++p) {
    zero_regs(dv_acc[p]);
    zero_regs(dk_acc[p]);
  }
  zero_regs(s);
  zero_regs(dp);
  int ring = 0;
  const auto take = [&]() {
    const int st = ring % kN;
    mbar_wait(&sm.full[st], (ring / kN) & 1);
    ++ring;
    return st;
  };
  const auto release = [&](int st) { mbar_arrive(&sm.empty[st]); };
  mbar_wait(&sm.fixed_full, 0);
  for (int it = 0; it < n_tiles; ++it) {
    const int q0 = (q_first + it) * kTile;
    // S^T = Kr Qr^T, dP^T = V dO^T; the j-th slice taken is in stage
    // slice_st(j) (Qr's kSlices, then dO's)
    const int base = ring;
    const auto slice_st = [&](int j) { return (base + j) % kN; };
    sliced_scores<D>(s, dp, sm.a, sm.b, sm.ring, keep_lo, keep_hi, true,
                     take, release);
    const int st = slice_st(keep_lo);  // the tile's statistics
    uint32_t pt[kTile / 16][4], dst[kTile / 16][4];
    if (dkdv_edge(causal, it, q0, k0, seq_q, seq_k))
      dkdv_tile_p_ds<true, kStats>(pt, dst, s, dp, key, key_bias,
                                   sm.m[st], sm.il[st], sm.delta[st], q0, t,
                                   seq_q, seq_k, causal, km, scale);
    else
      dkdv_tile_p_ds<false, kStats>(pt, dst, s, dp, key, key_bias,
                                    sm.m[st], sm.il[st], sm.delta[st], q0,
                                    t, seq_q, seq_k, causal, km, scale);
    wgmma_fence();
#pragma unroll
    for (int p = 0; p < L::kParts; ++p) {
      const int c = c0 + wg * L::kCols + p * L::kPartCols;
      const uint8_t* dout =
          sm.ring[slice_st(kSlices + slice_of(c))] + slice_bytes_at(c);
      const uint8_t* qr = sm.ring[slice_st(slice_of(c))] + slice_bytes_at(c);
#pragma unroll
      for (int kk = 0; kk < kTile / 16; ++kk)
        wgmma_m64nNk16_rs<L::kPartCols, kMNMajor>(dv_acc[p], pt[kk],
                                                  mnmajor_desc(dout, kk));
#pragma unroll
      for (int kk = 0; kk < kTile / 16; ++kk)
        wgmma_m64nNk16_rs<L::kPartCols, kMNMajor>(dk_acc[p], dst[kk],
                                                  mnmajor_desc(qr, kk));
    }
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int p = 0; p < L::kParts; ++p) {
      fence_regs(dv_acc[p]);
      fence_regs(dk_acc[p]);
    }
    fence_regs(pt);
    fence_regs(dst);
    for (int j = keep_lo; j <= keep_hi; ++j) {
      release(slice_st(j));
      release(slice_st(kSlices + j));
    }
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (key[h] >= seq_k) continue;
    bf16* dv_row = dv + ((size_t)bh * seq_k + key[h]) * D;
    bf16* dk_row = dk + ((size_t)bh * seq_k + key[h]) * D;
    const float* cr = kcos + (size_t)key[h] * D;
    const float* sr = ksin + (size_t)key[h] * D;
#pragma unroll
    for (int p = 0; p < L::kParts; ++p)
#pragma unroll
      for (int j = 0; j < kNd; ++j) {
        const int c = c0 + wg * L::kCols + p * L::kPartCols + j * 8 + 2 * t;
        dv_row[c] = from_f<bf16>(dv_acc[p][4 * j + 2 * h]);
        dv_row[c + 1] = from_f<bf16>(dv_acc[p][4 * j + 2 * h + 1]);
        store_adjoint<bf16>(dk_row, cr, sr, c, dk_acc[p][4 * j + 2 * h],
                            dk_acc[p][4 * j + 2 * h + 1]);
      }
  }
}

// ---- launch (host) -------------------------------------------------------------

// The arguments both kernels take: qr/kr (q and k rotated by R1), v, dout,
// (bh, seq_q | seq_k, D) bf16; the per-row statistics (bh, seq_q) fp32
// (row_il null for K4 and K5); the tables, (seq_q | seq_k, D) fp32, read by
// the rotation's adjoint; kmask (mask_rows, seq_k) fp32 or null.
struct Args {
  const void *qr, *kr, *v, *dout;
  float *row_m, *row_il, *row_delta;
  const float *qcos, *qsin, *kcos, *ksin, *kmask;
  int mask_rows, bh, seq_q, seq_k, num_heads;
  float scale;
  int causal;
  cudaStream_t stream;
};

// Tensor maps of qr, kr, v and dout, (bh, seq, D) bf16 each.
template <int D>
bool make_maps(CUtensorMap (&m)[4], const Args& a) {
  return hopper::make_map(&m[0], a.qr, a.bh, a.seq_q, D) &&
         hopper::make_map(&m[1], a.kr, a.bh, a.seq_k, D) &&
         hopper::make_map(&m[2], a.v, a.bh, a.seq_k, D) &&
         hopper::make_map(&m[3], a.dout, a.bh, a.seq_q, D);
}

template <bool kStats, int D>
cudaError_t launch_dq(const CUtensorMap (&m)[4], const Args& a, void* dq) {
  constexpr int bytes = hopper::smem_bytes<DqSmem<D>>();
  const auto kernel = flash_bwd_dq_wgmma_kernel<kStats, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.seq_q + kTile - 1) / kTile, a.bh);
  kernel<<<grid, Layout<D, false>::kBlock, bytes, a.stream>>>(
      m[0], m[1], m[2], m[3], a.row_m, a.row_il, a.row_delta,
      static_cast<bf16*>(dq), a.qcos, a.qsin, a.kmask, a.mask_rows, a.seq_q,
      a.seq_k, a.num_heads, a.scale, a.causal);
  return cudaGetLastError();
}

template <bool kStats, int D>
cudaError_t launch_dkdv(const CUtensorMap (&m)[4], const Args& a, void* dk,
                        void* dv) {
  constexpr int bytes = hopper::smem_bytes<DkdvSmem<D>>();
  const auto kernel = flash_bwd_dkdv_wgmma_kernel<kStats, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.seq_k + kTile - 1) / kTile, a.bh);
  kernel<<<grid, Layout<D, true>::kBlock, bytes, a.stream>>>(
      m[0], m[1], m[2], m[3], a.row_m, a.row_il, a.row_delta,
      static_cast<bf16*>(dk), static_cast<bf16*>(dv), a.kcos, a.ksin,
      a.kmask, a.mask_rows, a.seq_q, a.seq_k, a.num_heads, a.scale,
      a.causal);
  return cudaGetLastError();
}

// The sliced kernels (D past 256; K2's with kStats, K4's and K5's without)
// on the same arguments and maps.
template <bool kStats, int D>
cudaError_t launch_dq_sliced(const CUtensorMap (&m)[4], const Args& a,
                             void* dq) {
  constexpr int bytes = hopper::smem_bytes<SlicedSmem<D, sliced_stages<D>()>>();
  static_assert(bytes <= 232448, "a block's shared memory");
  const auto kernel = flash_bwd_dq_sliced_kernel<kStats, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.seq_q + kTile - 1) / kTile, a.bh);
  kernel<<<grid, SlicedLayout<D, false>::kBlock, bytes, a.stream>>>(
      m[0], m[1], m[2], m[3], a.row_m, a.row_il, a.row_delta,
      static_cast<bf16*>(dq), a.qcos, a.qsin, a.kmask, a.mask_rows, a.seq_q,
      a.seq_k, a.num_heads, a.scale, a.causal);
  return cudaGetLastError();
}

template <bool kStats, int D>
cudaError_t launch_dkdv_sliced(const CUtensorMap (&m)[4], const Args& a,
                               void* dk, void* dv) {
  using L = SlicedLayout<D, true>;
  constexpr int bytes = hopper::smem_bytes<SlicedSmem<D, sliced_stages<D>()>>();
  static_assert(bytes <= 232448, "a block's shared memory");
  const auto kernel = flash_bwd_dkdv_sliced_kernel<kStats, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.seq_k + kTile - 1) / kTile * L::kGroups, a.bh);
  kernel<<<grid, L::kBlock, bytes, a.stream>>>(
      m[0], m[1], m[2], m[3], a.row_m, a.row_il, a.row_delta,
      static_cast<bf16*>(dk), static_cast<bf16*>(dv), a.kcos, a.ksin,
      a.kmask, a.mask_rows, a.seq_q, a.seq_k, a.num_heads, a.scale,
      a.causal);
  return cudaGetLastError();
}

}  // namespace bwd
}  // namespace meant
