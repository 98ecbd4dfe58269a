// The resident backward K2 in bf16 at a padded width of 768 (meant_src
// --num_heads 1) on Hopper (sm_90a): the chain body. It replaces
// meant_tpu/ops/flash/kernel.py:_bwd_kernel there as flash_bwd.cu's other
// bodies do at the other widths, and computes what they compute.
//
// Why a body of its own. At d = 768 the sums of S = Qr Kr^T and dP = dO V^T
// decide single roundings of dS, and one flipped rounding moves a dq
// element by some 0.025, past the gradients' element bar: summed on the
// tensor cores K2 at (80, 196, 768) puts 7 dq elements past it, as does the
// plain version summed in fp64 against itself (tools/wide_sum_order.py;
// PERF.md). So each S and dP element is the wide body's fp32 FMA chain over
// the columns 0..767 in order (flash_wide.cuh, dp_mm), and P, dS and the
// row statistics m, 1/l and delta are bit for bit the wide body's. What
// changes is that each is formed once per (q tile, key tile), where the
// wide body formed them 14 times (each of its 4 dq column groups twice, each
// of its 6 dk/dv groups once), on FMAs fed from fp32 operands in shared
// memory, and that the three products over keys run on wgmma.
//
// A K2 call is three launches, in order on the caller's stream:
//   1. chain_scores_kernel, one block per (key tile, q tile, bh) pair in the
//      causal triangle: S and dP of the pair, 64 x 64 each, into the fp32
//      scratch. The 128 threads each hold an 8 x 8 micro-tile of S (threads
//      0-63) or of dP (64-127) and run one fp32 FMA chain per element over
//      16-column chunks in order; each chunk of Qr, Kr, dO and V is read from
//      global memory into registers while the previous one is summed, then
//      converted to fp32 once and stored transposed into shared memory
//      (double-buffered). A warp whose 32 rows lie past s_q, and a thread
//      whose 8 keys lie past s_k, skips the chains (their scores are masked).
//   2. chain_ds_kernel, one block per (q tile, bh), 4 warps of 16 rows in
//      the wide body's fragment layout (warp_mm's): the statistics pass
//      (stats_tile, online over the key tiles in order, then row_sum) reads
//      the pair's S and dP from the scratch and gives m, 1/l and delta with
//      the wide body's order of operations; it writes them to the (3, bh,
//      s_q) planes. Then P = exp(S - m) (1/l) and dS = P (dP - delta) scale,
//      rounded to bf16 as the wide body rounds them, into the scratch as the
//      A fragments of the products: dS for dQ, and through a transpose in
//      shared memory dS^T for dK and T(P)^T for dV.
//   3. chain_products_kernel, one block per (job, 384-column group, bh): dQ
//      = dS Kr over the key tiles, dK = dS^T Qr and dV = T(P)^T dO over the
//      q tiles (causal: up to / from the diagonal). Two consumer
//      warpgroups of 192 columns run m64n192k16 with A in registers (read
//      from the scratch one tile ahead) and B the streamed row-major tile
//      read MN-major, through a TMA ring (hopper.cuh) a producer warp fills;
//      the rotation's adjoint in the epilogue of dQ and dK.
// The scratch (scratch_bytes) holds, per pair, S and dP in fp32 (32
// KB, read back twice by step 2, mostly from L2) and the three fragment
// tiles (24 KB). The chain step (1) and the products (3) do not depend on
// where P comes from; the streaming backward K4 + K5 (P = exp(S - lse),
// delta given) would take them with a P/dS step of its own.
//
// Bound at --num_heads 1's (80, 196, 768) pixel rotary: 51 MB of inputs,
// outputs and tables (0.051 ms at 3.35 TB/s) and, where the tensor cores
// would take 23.6 GFLOP, S and dP summed by scalar FMAs: 2 x 80 x 196^2 x
// 768 = 4.72e9 FMAs, 9.44e9 operations, 0.141 ms at the 67 TFLOP/s fp32
// peak (PERF.md names that floor beside the bytes).

#pragma once

#include "flash_common.cuh"
#include "hopper.cuh"

namespace meant {
namespace chain {

constexpr int kTile = 64;         // q rows or keys of a tile
constexpr int kD = 768;           // the width this body takes
constexpr int kChunk = 16;        // columns of a chain chunk
constexpr int kThreads = 128;     // chain and dS steps
constexpr int kMicro = 8;         // a chain thread's rows and columns
constexpr int kNs = kTile / 8;    // n8 blocks of a score (fragment layout)
constexpr int kPairFloats = 2 * kTile * kTile;   // S and dP of a pair
constexpr int kFragWords = kTile * kTile / 2;    // bf16 pairs of a tile
// the products: a consumer warpgroup's columns, two a block
constexpr int kWgCols = 192;
constexpr int kGroupCols = 2 * kWgCols;
constexpr int kGroups = kD / kGroupCols;
constexpr int kProductBlock = 2 * 128 + 32;
constexpr int kStageBytes = hopper::tile_bytes<kGroupCols>();
constexpr int kStages = (232448 - 2048) / kStageBytes;

// The scratch of one call, in bytes: S and dP (fp32) and the dS, dS^T and
// T(P)^T fragment tiles of every (q tile, key tile) pair.
inline size_t scratch_bytes(int bh, int seq_q, int seq_k) {
  const size_t pairs = (size_t)bh * ((seq_q + kTile - 1) / kTile) *
                       ((seq_k + kTile - 1) / kTile);
  return pairs * (kPairFloats * sizeof(float) + 3 * kFragWords * 4);
}

// The scratch's regions: S and dP, then the three fragment planes.
struct Scratch {
  float* sd;            // [pair][2][64][64]
  uint32_t* ds;         // [pair][4 k16 steps][128 threads][4]
  uint32_t* dst;        // the same for dS^T
  uint32_t* pt;         // and T(P)^T
  __host__ __device__ Scratch(void* base, size_t pairs)
      : sd(static_cast<float*>(base)),
        ds(reinterpret_cast<uint32_t*>(sd + pairs * kPairFloats)),
        dst(ds + pairs * kFragWords),
        pt(dst + pairs * kFragWords) {}
};

// ---- 1. S and dP on FMA chains ----------------------------------------------

// Grid (key tiles, q tiles, bh); block kThreads. sd receives the pair's S
// then dP, [64][64] fp32 each, row-major (rows q, columns keys).
__global__ void __launch_bounds__(kThreads, 3)
    chain_scores_kernel(const bf16* __restrict__ qr,
                        const bf16* __restrict__ kr,
                        const bf16* __restrict__ v,
                        const bf16* __restrict__ dout,
                        float* __restrict__ sd, int seq_q, int seq_k,
                        int causal) {
  // [buffer][operand: Qr, Kr, dO, V][chunk column][row], fp32
  __shared__ __align__(16) float ops[2][4][kChunk][kTile];
  const int kt = blockIdx.x, qt = blockIdx.y, bh = blockIdx.z;
  if (causal && kt > qt) return;
  const int n_tq = gridDim.y, n_tk = gridDim.x;
  const int q0 = qt * kTile, k0 = kt * kTile;
  const int tid = threadIdx.x;
  // the chunk loads: row tid / 2, columns (tid % 2) * 8.. of each operand
  const int lr = tid / 2, lc = (tid % 2) * 8;
  const bf16* src[4] = {qr + ((size_t)bh * seq_q + q0) * kD,
                        kr + ((size_t)bh * seq_k + k0) * kD,
                        dout + ((size_t)bh * seq_q + q0) * kD,
                        v + ((size_t)bh * seq_k + k0) * kD};
  const bool live[4] = {q0 + lr < seq_q, k0 + lr < seq_k, q0 + lr < seq_q,
                        k0 + lr < seq_k};
  uint4 next[4];
  const auto load = [&](int col0) {
#pragma unroll
    for (int o = 0; o < 4; ++o)
      next[o] = live[o] ? *reinterpret_cast<const uint4*>(
                              src[o] + (size_t)lr * kD + col0 + lc)
                        : make_uint4(0u, 0u, 0u, 0u);
  };
  const auto store = [&](int buf) {
#pragma unroll
    for (int o = 0; o < 4; ++o) {
      const bf16* x = reinterpret_cast<const bf16*>(&next[o]);
#pragma unroll
      for (int i = 0; i < 8; ++i) ops[buf][o][lc + i][lr] = to_f<bf16>(x[i]);
    }
  };
  // this thread's micro-tile: S (threads 0-63) or dP, rows ty * 8..,
  // keys tx * 8..
  const int which = tid / 64, ty = (tid % 64) / 8, tx = tid % 8;
  const float(*a)[kTile] = ops[0][2 * which];
  const float(*b)[kTile] = ops[0][2 * which + 1];
  constexpr int kBufFloats = 4 * kChunk * kTile;
  // a warp holds 32 rows; past s_q (or a thread's keys past s_k) the
  // scores are masked and the chains are skipped
  const bool active = q0 + (ty / 4) * 32 < seq_q && k0 + tx * kMicro < seq_k;
  float acc[kMicro][kMicro];
#pragma unroll
  for (int i = 0; i < kMicro; ++i)
#pragma unroll
    for (int j = 0; j < kMicro; ++j) acc[i][j] = 0.f;

  load(0);
  store(0);
  __syncthreads();
  for (int c = 0; c < kD / kChunk; ++c) {
    const int buf = c & 1;
    if (c + 1 < kD / kChunk) load((c + 1) * kChunk);
    if (active) {
      const float* ab = &a[0][0] + buf * kBufFloats;
      const float* bb = &b[0][0] + buf * kBufFloats;
#pragma unroll 4
      for (int k = 0; k < kChunk; ++k) {
        const float4 a0 = *reinterpret_cast<const float4*>(
            ab + k * kTile + ty * kMicro);
        const float4 a1 = *reinterpret_cast<const float4*>(
            ab + k * kTile + ty * kMicro + 4);
        const float4 b0 = *reinterpret_cast<const float4*>(
            bb + k * kTile + tx * kMicro);
        const float4 b1 = *reinterpret_cast<const float4*>(
            bb + k * kTile + tx * kMicro + 4);
        const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
        const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int i = 0; i < kMicro; ++i)
#pragma unroll
          for (int j = 0; j < kMicro; ++j)
            acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
    }
    if (c + 1 < kD / kChunk) store(buf ^ 1);
    __syncthreads();
  }
  float* out = sd + (((size_t)bh * n_tq + qt) * n_tk + kt) * kPairFloats +
               which * kTile * kTile;
#pragma unroll
  for (int i = 0; i < kMicro; ++i) {
    float4* row = reinterpret_cast<float4*>(out + (ty * kMicro + i) * kTile +
                                            tx * kMicro);
    row[0] = make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    row[1] = make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]);
  }
}

// ---- 2. the statistics, P and dS --------------------------------------------

// This thread's S (or dP) accumulator elements of a pair in the fragment
// layout (element 4j + 2h + e: row 16 warp + g + 8h, key 8j + 2t + e).
__device__ __forceinline__ void read_frag(float (&x)[4 * kNs],
                                          const float* tile, int warp,
                                          int g, int t) {
#pragma unroll
  for (int j = 0; j < kNs; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float2 f = *reinterpret_cast<const float2*>(
          tile + (warp * 16 + g + 8 * h) * kTile + j * 8 + 2 * t);
      x[4 * j + 2 * h] = f.x;
      x[4 * j + 2 * h + 1] = f.y;
    }
}

// The four A-fragment registers of k16 step kk for this thread from a
// [64][kLd] bf16 tile read transposed (rows of the fragment = the tile's
// columns).
template <int kLd>
__device__ __forceinline__ uint4 frag_t(const bf16* tile, int kk, int warp,
                                        int g, int t) {
  const auto pair = [&](int r, int c) {
    __nv_bfloat162 p;
    p.x = tile[c * kLd + r];
    p.y = tile[(c + 1) * kLd + r];
    return *reinterpret_cast<uint32_t*>(&p);
  };
  const int r = warp * 16 + g, c = kk * 16 + 2 * t;
  return make_uint4(pair(r, c), pair(r + 8, c), pair(r, c + 8),
                    pair(r + 8, c + 8));
}

// Grid (q tiles, bh); block kThreads (4 warps of 16 q rows). stats: the
// (3, bh, s_q) planes m, 1/l, delta.
__global__ void __launch_bounds__(kThreads) chain_ds_kernel(
    const float* __restrict__ sd, uint32_t* __restrict__ ds_f,
    uint32_t* __restrict__ dst_f, uint32_t* __restrict__ pt_f,
    float* __restrict__ stats, const float* __restrict__ kmask,
    int mask_rows, int seq_q, int seq_k, int num_heads, float scale,
    int causal) {
  constexpr int kLd = kTile + 8;
  __shared__ bf16 p_s[kTile][kLd], ds_s[kTile][kLd];  // [q][key]
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int qt = blockIdx.x, bh = blockIdx.y;
  const int n_tq = gridDim.x, n_tk = (seq_k + kTile - 1) / kTile;
  const int q0 = qt * kTile;
  const int row[2] = {q0 + warp * 16 + g, q0 + warp * 16 + g + 8};
  const float* km = nullptr;
  if (kmask != nullptr)
    km = kmask + (size_t)(mask_rows == 1 ? 0 : bh / num_heads) * seq_k;
  const int n_tiles = causal ? min(n_tk, qt + 1) : n_tk;
  const size_t pair0 = ((size_t)bh * n_tq + qt) * n_tk;
  float s[4 * kNs], dp[4 * kNs];

  // the statistics pass, as the wide body's dq kernel runs it
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float dsum[2] = {0.f, 0.f};
  for (int tile = 0; tile < n_tiles; ++tile) {
    const float* pair = sd + (pair0 + tile) * kPairFloats;
    read_frag(s, pair, warp, g, t);
    read_frag(dp, pair + kTile * kTile, warp, g, t);
    stats_tile<true, true>(s, dp, m, l, dsum, row, tile * kTile, t, seq_k,
                           causal, km, scale);
  }
  float m_row[2], il_row[2], delta[2];
  const size_t plane = (size_t)gridDim.y * seq_q;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float lt = row_sum(l[h]);
    m_row[h] = (m[h] == -INFINITY) ? 0.f : m[h];
    il_row[h] = lt > 0.f ? 1.0f / lt : 0.f;
    delta[h] = row_sum(dsum[h]) * il_row[h];
    if (t == 0 && row[h] < seq_q) {
      const size_t i = (size_t)bh * seq_q + row[h];
      stats[i] = m_row[h];
      stats[plane + i] = il_row[h];
      stats[2 * plane + i] = delta[h];
    }
  }

  // P and dS of each pair, rounded as the wide body rounds them
  for (int tile = 0; tile < n_tiles; ++tile) {
    const int k0 = tile * kTile;
    const size_t p = pair0 + tile;
    read_frag(s, sd + p * kPairFloats, warp, g, t);
    read_frag(dp, sd + p * kPairFloats + kTile * kTile, warp, g, t);
    uint32_t frag[kTile / 16][4];
#pragma unroll
    for (int j = 0; j < kNs; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float pv[2], dv[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = j * 8 + 2 * t + e;
          const float sc = masked_score(s[4 * j + 2 * h + e], scale, row[h],
                                        k0 + col, seq_k, causal, km);
          const float pe = (sc == -INFINITY || row[h] >= seq_q)
                               ? 0.f
                               : expf(sc - m_row[h]) * il_row[h];
          pv[e] = pe;
          dv[e] = pe * (dp[4 * j + 2 * h + e] - delta[h]) * scale;
        }
        const __nv_bfloat162 pb = __floats2bfloat162_rn(pv[0], pv[1]);
        const __nv_bfloat162 db = __floats2bfloat162_rn(dv[0], dv[1]);
        const int r = warp * 16 + g + 8 * h, c = j * 8 + 2 * t;
        *reinterpret_cast<__nv_bfloat162*>(&p_s[r][c]) = pb;
        *reinterpret_cast<__nv_bfloat162*>(&ds_s[r][c]) = db;
        frag[j >> 1][(j & 1) * 2 + h] = *reinterpret_cast<const uint32_t*>(&db);
      }
    uint4* out = reinterpret_cast<uint4*>(ds_f + p * kFragWords);
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk)
      out[kk * kThreads + threadIdx.x] =
          make_uint4(frag[kk][0], frag[kk][1], frag[kk][2], frag[kk][3]);
    __syncthreads();  // P and dS of the pair in shared memory
    uint4* out_dst = reinterpret_cast<uint4*>(dst_f + p * kFragWords);
    uint4* out_pt = reinterpret_cast<uint4*>(pt_f + p * kFragWords);
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk) {
      out_dst[kk * kThreads + threadIdx.x] =
          frag_t<kLd>(&ds_s[0][0], kk, warp, g, t);
      out_pt[kk * kThreads + threadIdx.x] =
          frag_t<kLd>(&p_s[0][0], kk, warp, g, t);
    }
    __syncthreads();  // read before the next pair overwrites them
  }
}

// ---- 3. the products over keys on wgmma -------------------------------------

struct ProductSmem {
  uint8_t ring[kStages][kStageBytes];
  uint64_t full[kStages], empty[kStages];
};

// Grid ((n_tq + 2 n_tk) kGroups, bh); block kProductBlock. Job j = x /
// kGroups: dQ of q tile j (j < n_tq), then dK, then dV of each key tile;
// the block holds the job's rows and kGroupCols columns from (x % kGroups)
// kGroupCols, warpgroup wg kWgCols of them.
__global__ void __launch_bounds__(kProductBlock, 1) chain_products_kernel(
    const __grid_constant__ CUtensorMap tm_q,
    const __grid_constant__ CUtensorMap tm_k,
    const __grid_constant__ CUtensorMap tm_do,
    const uint32_t* __restrict__ ds_f, const uint32_t* __restrict__ dst_f,
    const uint32_t* __restrict__ pt_f, bf16* __restrict__ dq,
    bf16* __restrict__ dk, bf16* __restrict__ dv,
    const float* __restrict__ qcos, const float* __restrict__ qsin,
    const float* __restrict__ kcos, const float* __restrict__ ksin,
    int seq_q, int seq_k, int causal) {
  using namespace hopper;
  constexpr int kNd = kWgCols / 8;
  extern __shared__ uint8_t smem_raw[];
  ProductSmem& sm = aligned_smem<ProductSmem>(smem_raw);
  const int n_tq = (seq_q + kTile - 1) / kTile;
  const int n_tk = (seq_k + kTile - 1) / kTile;
  const int bh = blockIdx.y;
  const int job = (int)blockIdx.x / kGroups;
  const int c0 = (int)blockIdx.x % kGroups * kGroupCols;
  // kind 0: dQ (rows q tile r, over key tiles); 1: dK; 2: dV (rows key
  // tile r, over q tiles)
  const int kind = job < n_tq ? 0 : 1 + (job - n_tq) / n_tk;
  const int r = kind == 0 ? job : (job - n_tq) % n_tk;
  const int first = kind == 0 || !causal ? 0 : r;
  const int last = kind == 0 ? (causal ? min(r + 1, n_tk) : n_tk) : n_tq;
  const int n = max(0, last - first);
  const CUtensorMap* tm = kind == 0 ? &tm_k : kind == 1 ? &tm_q : &tm_do;
  const uint32_t* frags = kind == 0 ? ds_f : kind == 1 ? dst_f : pt_f;
  if (threadIdx.x == 0) {
    for (int st = 0; st < kStages; ++st) {
      mbar_init(&sm.full[st], 1);
      mbar_init(&sm.empty[st], 256);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x >= 256) {  // the producer warp: one thread issues TMA
    if (threadIdx.x == 256) {
      for (int i = 0; i < n; ++i) {
        const int st = i % kStages;
        if (i >= kStages) mbar_wait(&sm.empty[st], (i / kStages - 1) & 1);
        mbar_arrive_expect_tx(&sm.full[st], kStageBytes);
        tma_load_cols<kGroupCols>(sm.ring[st], tm, &sm.full[st], c0,
                                  (first + i) * kTile, bh);
      }
    }
    return;
  }

  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t = lane & 3;
  // the pair of the i-th contraction tile
  const auto pair = [&](int i) {
    const int other = first + i;
    const int qt = kind == 0 ? r : other, kt = kind == 0 ? other : r;
    return ((size_t)bh * n_tq + qt) * n_tk + kt;
  };
  float acc[4 * kNd];
  zero_regs(acc);
  uint4 a[kTile / 16], a_next[kTile / 16];
  const auto fetch = [&](uint4(&dst)[kTile / 16], int i) {
    const uint4* src =
        reinterpret_cast<const uint4*>(frags + pair(i) * kFragWords);
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk) dst[kk] = src[kk * 128 + tid];
  };
  if (n > 0) fetch(a_next, 0);
  for (int i = 0; i < n; ++i) {
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk) a[kk] = a_next[kk];
    if (i + 1 < n) fetch(a_next, i + 1);
    const int st = i % kStages;
    mbar_wait(&sm.full[st], (i / kStages) & 1);
    const uint8_t* b = sm.ring[st] + wg * (kWgCols / kBoxCols) * kBoxBytes;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk) {
      const uint32_t frag[4] = {a[kk].x, a[kk].y, a[kk].z, a[kk].w};
      wgmma_m64nNk16_rs<kWgCols, kMNMajor>(acc, frag, mnmajor_desc(b, kk));
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    mbar_arrive(&sm.empty[st]);
  }

  const int seq = kind == 0 ? seq_q : seq_k;
  bf16* out = kind == 0 ? dq : kind == 1 ? dk : dv;
  const float* cs = kind == 0 ? qcos : kcos;
  const float* sn = kind == 0 ? qsin : ksin;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int rw = r * kTile + warp * 16 + g + 8 * h;
    if (rw >= seq) continue;
    bf16* o = out + ((size_t)bh * seq + rw) * kD;
    const float* cr = cs + (size_t)rw * kD;
    const float* sr = sn + (size_t)rw * kD;
#pragma unroll
    for (int j = 0; j < kNd; ++j) {
      const int c = c0 + wg * kWgCols + j * 8 + 2 * t;
      if (kind == 2) {
        *reinterpret_cast<uint32_t*>(o + c) =
            pack_pair(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
      } else {
        store_adjoint<bf16>(o, cr, sr, c, acc[4 * j + 2 * h],
                            acc[4 * j + 2 * h + 1]);
      }
    }
  }
}

// ---- launch (host) -------------------------------------------------------------

// K2 at 768 in bf16: qr, kr, v, dout (bh, seq, 768); stats (3, bh, seq_q)
// fp32; scratch of scratch_bytes(bh, seq_q, seq_k).
inline cudaError_t launch(const void* qr, const void* kr, const void* v,
                          const void* dout, void* dq, void* dk, void* dv,
                          float* stats, void* scratch, const float* qcos,
                          const float* qsin, const float* kcos,
                          const float* ksin, const float* kmask,
                          int mask_rows, int bh, int seq_q, int seq_k,
                          int num_heads, float scale, int causal,
                          cudaStream_t stream) {
  if (scratch == nullptr) return cudaErrorInvalidValue;
  const int n_tq = (seq_q + kTile - 1) / kTile;
  const int n_tk = (seq_k + kTile - 1) / kTile;
  const Scratch sc(scratch, (size_t)bh * n_tq * n_tk);
  const auto b = [](const void* p) { return static_cast<const bf16*>(p); };
  chain_scores_kernel<<<dim3(n_tk, n_tq, bh), kThreads, 0, stream>>>(
      b(qr), b(kr), b(v), b(dout), sc.sd, seq_q, seq_k, causal);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  chain_ds_kernel<<<dim3(n_tq, bh), kThreads, 0, stream>>>(
      sc.sd, sc.ds, sc.dst, sc.pt, stats, kmask, mask_rows, seq_q, seq_k,
      num_heads, scale, causal);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  CUtensorMap m[3];
  if (!hopper::make_map(&m[0], qr, bh, seq_q, kD) ||
      !hopper::make_map(&m[1], kr, bh, seq_k, kD) ||
      !hopper::make_map(&m[2], dout, bh, seq_q, kD))
    return cudaErrorInvalidValue;
  constexpr int bytes = hopper::smem_bytes<ProductSmem>();
  static_assert(bytes <= 232448, "a block's shared memory");
  err = cudaFuncSetAttribute(chain_products_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
  if (err != cudaSuccess) return err;
  chain_products_kernel<<<dim3((n_tq + 2 * n_tk) * kGroups, bh),
                          kProductBlock, bytes, stream>>>(
      m[0], m[1], m[2], sc.ds, sc.dst, sc.pt, static_cast<bf16*>(dq),
      static_cast<bf16*>(dk), static_cast<bf16*>(dv), qcos, qsin, kcos, ksin,
      seq_q, seq_k, causal);
  return cudaGetLastError();
}

}  // namespace chain
}  // namespace meant
