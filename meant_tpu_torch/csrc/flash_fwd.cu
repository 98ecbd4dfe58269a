// Flash-attention forwards for Hopper (sm_90a): the resident K1 and the
// streaming K3. Both take q and k rotated once per call by the rotation
// pass (R1, flash_bwd_online.cu: x*cos + rotate_half(x)*sin in fp32 with
// the (s, d) tables, rounded to the input dtype, the bits of the TPU
// kernels' rotation), so neither rotates anything.
//
// K1 replaces the TPU kernel meant_tpu/ops/flash/kernel.py:_fwd_kernel (the
// resident forward, launched by _flash_fwd). For each (batch*head, q row) it
// computes what that kernel computes from Qr and Kr:
//   1. S = Qr Kr^T accumulated in fp32, times `scale`;
//   2. the causal -inf fill (col <= row kept);
//   3. + (1 - kmask) * -1e9 when a key mask is given, mask row bh / num_heads
//      (or row 0 for a broadcast mask);
//   4. P = softmax(S) in fp32, exp(S - m) * (1/l) with m and l the row's
//      max and denominator; 5. P rounded to the input dtype (the TPU
//      kernel's `jax.nn.softmax(scores).astype(in_dtype)`, :120);
//   6. P @ V accumulated in fp32; 7. output in the input dtype.
// The TPU kernel keeps a whole K/V row resident in VMEM and takes a single-
// pass softmax. A Hopper block cannot hold K+V for s=512 beside its q rows
// in fp32, and holding them in bf16 would leave one block an SM, so K1
// walks Kr in 64-row tiles twice: a statistics pass finds each row's final
// m and l, then a second pass forms P normalised and rounds it where the
// TPU kernel rounds it. A fully masked batch row gets the reference's
// uniform P over the keys the causal fill leaves (1/(row+1), or 1/s).
//
// K3 replaces meant_tpu/ops/flash/kernel.py:_fwd_online_kernel (launched by
// _flash_fwd_online, the path flash_mha takes past the resident limits, for
// return_lse and for force_online). That kernel walks k blocks with an
// online softmax, rounds the unnormalised P at the running max, divides at
// the end, and writes each row's log-sum-exp beside the output: lse =
// m_safe + log(max(l, 1e-30)), m_safe = 0 on a row with no finite score;
// K3 does the same over 64-key tiles. lse is (bh, seq_q) fp32; rows past
// seq_q are not written.
//
// Bounds on an H100 SXM (989 TFLOP/s bf16 dense, 3.35 TB/s). K1 at the
// flagship's launches (BH = 640, d = 96, bf16) must move qr, kr, v and o
// once -- 252 MB at s=512 (75 us) and 97 MB at s=196 (29 us) -- and its two
// products are 32 GFLOP over the causal triangle and 9.4 GFLOP (33 and
// 10 us): bound by bytes. The statistics pass adds a third product (S
// twice, 48 GFLOP at s=512) and reads Kr a second time, mostly from L2: it
// stays bound by bytes. K3 at src4096's launch (BH = 80, s = 4096, causal)
// is bound by operations: two products over the causal triangle, 257.7
// GFLOP (0.26 ms), against 189 MB of qr, kr, v, o and lse (0.056 ms).
//
// bf16 (the main path), one body for both (fwd_wgmma, kStats = K1): a block
// is kGroups consumer warpgroups of 64 q rows each and a producer warp. The
// producer brings the block's Qr rows once, then streams Kr (and V)
// through TMA (hopper.cuh: 3-D tensor maps over (bh, s, D), 64-byte
// swizzle, zero past s) into a ring of kStages stages with full and empty
// mbarriers; every consumer warpgroup reads every stage. K1's producer
// walks the tiles twice: Kr alone for the statistics pass, then Kr and V.
// S = Qr Kr^T runs on wgmma with both operands in shared memory
// (m64n64k16); the softmax stays in the accumulator registers; P, rounded
// to bf16 in place, is the A fragment of O += P V (m64nDk16, V read
// MN-major through the transpose bit: no transposed copy). K1 releases a
// statistics-pass stage as soon as its S is read (stats_tile,
// flash_common.cuh, shared with K2's dq kernel). Only the diagonal and
// ragged tiles mask element by element (masked_score); every other tile
// takes the key mask as a per-column bias, rounded as the reference rounds
// it. Grid (q blocks, bh): the blocks with the most tiles to walk first,
// and a head's blocks together, sharing its Kr and V in L2. Each kernel's
// groups and stages are constants below (tools/k1_variants.py and
// tools/k23_variants.py time the alternatives).
// fp32 (the tight on-card check): scalar fp32 FMAs from shared memory on
// synchronous loads (every thread owns 8 q rows x 4 score columns and 8
// rows x d/16 output columns), since the tensor cores would round fp32 to
// TF32; an online softmax, P in fp32 either way.
// Head dims: both bodies are templates on D, built for 64, 96 and 128 (a
// [64][D] tile is D / 32 TMA boxes; O += P V is m64nDk16); the wrapper pads
// any other even d up to 128 with zero columns, and an odd d or one past
// 128 to a multiple of 64. In bf16 the wgmma body is also built at 192 and
// 256 (the padded widths of every d in (128, 256]: meant_src --num_heads 4
// and 3, src4096 at those heads, the played ring's chunk) and at 384 and
// 768 (--num_heads 2 and 1) for both kernels; fp32 past 128 and every
// other padded width past 256 take the wide body of flash_wide.cuh (the
// same function, the contraction streamed over the width on FMA chains,
// the output cut into 64-column chunks on a grid axis).
// At 192 and 256 the registers set the layout: O for 64 rows is 96 fp32
// registers a thread at 192 and 128 at 256 (the m64n256k16 product),
// beside S (32) and P (16). Each consumer warpgroup holds all of O for its
// 64 rows, so no product is repeated; the alternative, two warpgroups
// splitting O's columns and each forming the rows' whole S (1.5x the
// tensor work), read 1.23 / 1.02 ms against 0.97 / 0.85 for K3 with one
// warpgroup at (40, 4096, 192) / (30, 4096, 256) (tools/k23_variants.py
// --kernels K3wide; PERF.md). At 192 two such warpgroups a block (128 q
// rows, 288 threads) let one warpgroup's softmax run while the other's
// products do; at 256 one warpgroup with three stages (224 KB of shared
// memory, 230 registers for K3) beats two with the two stages that fit
// beside two Qr tiles. K1 takes the same groups, with two stages (1-3%
// faster than three: tools/k1_variants.py --widths). Bound of K3 at
// src4096's launches, (40, 4096, 192) and (30, 4096, 256) bf16 causal: two
// products over the causal triangle, 257.8 GFLOP (0.26 ms), against 252 MB
// (0.075 ms): by operations, as at d = 96; of K1 at (320, 512, 192) the
// 0.0756 ms of its bytes.
// At 384 and 768 O for 64 rows is 192 / 384 registers a thread, more than
// a warpgroup holds, and a [64][768] Kr tile is 96 KB: the sliced ring.
// O's columns are cut into groups of 384 on the grid's first axis (beside
// the q block, so a q block's groups run together and share its Qr and Kr
// in L2: one group at 384, two at 768). A block is one q-row group of 64
// and two consumer warpgroups, each holding 192 of the group's columns (96
// registers) and forming the rows' whole S over every column of D, from
// the resident Qr tile (48 KB at 384, 96 KB at 768) and Kr streamed
// through the ring in 384-column slices; the stage after a tile's slices
// carries the group's 384 columns of V. A slice is released as soon as the
// products of the next one are under way (wgmma_wait<1>). The stages are
// 48 KB: three fit at 384, two at 768. S is formed once per warpgroup (and
// twice in K1, whose statistics pass walks Kr again): at (80, 196, 768)
// some 80 GFLOP on the tensor cores against the 0.0295 ms bytes bound.
// One warpgroup a block holding 192 columns (192-column groups and slices,
// five 24 KB stages) read its Kr twice as often from L2: K1 alone at (80,
// 196, 768) 0.328 ms against 0.194, K3 at (80, 512, 768) 0.457 against
// 0.283, K1 at (160, 512, 384) 0.343 against 0.292 (with two q-row groups
// a block; one read 0.525; tools/k1_variants.py --widths; PERF.md).
// q and k lengths are separate (s_q rows of q, s_k keys; causal keeps col
// <= row, both from 0, as the reference does): the grid walks q, the ring
// walks k.
//
// C interface (loaded with ctypes): meant_flash_fwd (K1) and
// meant_flash_fwd_lse (K3) return the cudaError_t of the launch (0 on
// success); they never synchronise.

#include "flash_common.cuh"
#include "flash_wide.cuh"
#include "hopper.cuh"

namespace {

using namespace meant;

constexpr int kBlockQ = 64;              // q rows per tile
constexpr int kBlockK = 64;              // k rows per tile
constexpr int kThreads = 128;            // the fp32 body's block: 4 warps

// The log-sum-exp K3 writes for a row whose running max is m and whose
// denominator (relative to that max, or to 0 when m = -inf) is l, as the
// TPU kernel writes it: m_safe + log(max(l, 1e-30)).
__device__ __forceinline__ float row_lse(float m, float l) {
  return (m == -INFINITY ? 0.f : m) + logf(fmaxf(l, 1e-30f));
}

// ---- fp32: scalar FMAs ---------------------------------------------------

constexpr int kTx = 16;                  // threads across columns
constexpr int kTy = kThreads / kTx;      // 8 threads across rows
constexpr int kRows = kBlockQ / kTy;     // 8 q rows per thread
constexpr int kCols = kBlockK / kTx;     // 4 score columns per thread

template <int D>
constexpr int fp32_smem_bytes() {
  return (int)sizeof(float) *
         (kBlockQ * (D + 1) + kBlockK * (D + 1) + kBlockK * D +
          kBlockQ * (kBlockK + 1));
}

// K1 and K3 in fp32 (K3 also writes lse when kLse). Grid (bh, q tiles);
// block kThreads.
template <int D, bool kLse>
__global__ void __launch_bounds__(kThreads, 2) flash_fwd_fp32_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, float* __restrict__ o,
    float* __restrict__ lse, const float* __restrict__ kmask, int mask_rows,
    int seq_q, int seq_k, int num_heads, float scale, int causal) {
  constexpr int kOut = D / kTx;          // output columns per thread
  constexpr int kStrideQK = D + 1;       // pad: column walks hit all banks
  constexpr int kStrideP = kBlockK + 1;
  extern __shared__ float smem[];
  float* qs = smem;                                  // [kBlockQ][D+1]
  float* ks = qs + kBlockQ * kStrideQK;              // [kBlockK][D+1]
  float* vs = ks + kBlockK * kStrideQK;              // [kBlockK][D]
  float* ps = vs + kBlockK * D;                      // [kBlockQ][kBlockK+1]

  const int bh = blockIdx.x;
  const int q0 = blockIdx.y * kBlockQ;
  const int tx = threadIdx.x % kTx;
  const int ty = threadIdx.x / kTx;
  const size_t q_base = (size_t)bh * seq_q * D;
  const size_t k_base = (size_t)bh * seq_k * D;
  const float* km = nullptr;
  if (kmask != nullptr)
    km = kmask + (size_t)(mask_rows == 1 ? 0 : bh / num_heads) * seq_k;

  load_tile<float, D>(qs, kStrideQK, nullptr, 0, q + q_base, nullptr,
                      nullptr, q0, seq_q);

  float m[kRows], l[kRows], acc[kRows][kOut];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < kOut; ++j) acc[i][j] = 0.f;
  }

  const int n_k = (seq_k + kBlockK - 1) / kBlockK;
  const int n_tiles = causal ? min(n_k, q0 / kBlockK + 1) : n_k;
  for (int tile = 0; tile < n_tiles; ++tile) {
    const int k0 = tile * kBlockK;
    __syncthreads();  // the previous tile's ks/vs/ps reads are done
    load_tile<float, D>(ks, kStrideQK, nullptr, 0, k + k_base, nullptr,
                        nullptr, k0, seq_k);
    for (int e = threadIdx.x; e < kBlockK * D; e += kThreads) {
      const int r = e / D;
      vs[e] = (k0 + r < seq_k) ? v[k_base + (size_t)k0 * D + e] : 0.f;
    }
    __syncthreads();

    float s[kRows][kCols];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int c = 0; c < kCols; ++c) s[i][c] = 0.f;
    for (int d = 0; d < D; ++d) {
      float qv[kRows], kv[kCols];
#pragma unroll
      for (int i = 0; i < kRows; ++i) qv[i] = qs[(ty + kTy * i) * kStrideQK + d];
#pragma unroll
      for (int c = 0; c < kCols; ++c) kv[c] = ks[(tx + kTx * c) * kStrideQK + d];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int c = 0; c < kCols; ++c) s[i][c] = fmaf(qv[i], kv[c], s[i][c]);
    }

#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int row = q0 + ty + kTy * i;
      float mx = -INFINITY;
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        s[i][c] = masked_score(s[i][c], scale, row, k0 + tx + kTx * c,
                               seq_k, causal, km);
        mx = fmaxf(mx, s[i][c]);
      }
      // the 16 threads of a row sit in one half-warp
#pragma unroll
      for (int off = kTx / 2; off > 0; off /= 2)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      float m_use;
      const float corr = rescale(m[i], mx, m_use);
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const float p = (s[i][c] == -INFINITY) ? 0.f : expf(s[i][c] - m_use);
        sum += p;
        ps[(ty + kTy * i) * kStrideP + tx + kTx * c] = p;
      }
#pragma unroll
      for (int off = kTx / 2; off > 0; off /= 2)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = l[i] * corr + sum;
#pragma unroll
      for (int j = 0; j < kOut; ++j) acc[i][j] *= corr;
    }
    __syncthreads();  // ps complete

    for (int c = 0; c < kBlockK; ++c) {
      float pv[kRows], vv[kOut];
#pragma unroll
      for (int i = 0; i < kRows; ++i) pv[i] = ps[(ty + kTy * i) * kStrideP + c];
#pragma unroll
      for (int j = 0; j < kOut; ++j) vv[j] = vs[c * D + tx + kTx * j];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kOut; ++j) acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int row = q0 + ty + kTy * i;
    if (row >= seq_q) continue;
    const float inv = l[i] > 0.f ? 1.0f / l[i] : 0.f;
#pragma unroll
    for (int j = 0; j < kOut; ++j)
      o[q_base + (size_t)row * D + tx + kTx * j] = acc[i][j] * inv;
    if constexpr (kLse) {
      if (tx == 0) lse[(size_t)bh * seq_q + row] = row_lse(m[i], l[i]);
    }
  }
}

// ---- bf16: TMA, mbarriers and wgmma ---------------------------------------

// K1's and K3's consumer warpgroups and ring stages (measured:
// tools/k1_variants.py, tools/k23_variants.py; PERF.md).
constexpr int kResGroups = 1;                      // K1
constexpr int kResStages = 2;
constexpr int kFwdGroups = 1;                      // K3
constexpr int kFwdStages = 2;
// K3 at D = 192 and 256 (the layouts in the note above): q-row groups of
// 64 a block, each one consumer warpgroup holding all of O's columns
// (kWideFwdSplit warpgroups a group would split them), and ring stages.
template <int D>
constexpr int wide_fwd_groups() {
  return D <= 192 ? 2 : 1;
}
constexpr int kWideFwdSplit = 1;
constexpr int kWideFwdStages = 3;
// K1 at D = 192 and 256: K3's groups and split, and its own stages.
constexpr int kWideResStages = 2;
// K1 and K3 at D = 384 and 768, the sliced ring (the note above): the
// columns of O a consumer warpgroup holds, and the warpgroups a block of
// 64 q rows (each holding kSlicedCols of the block's kSlicedCols *
// kSlicedSplit columns).
constexpr int kSlicedCols = 192;
constexpr int kSlicedSplit = 2;
constexpr int kNs = kBlockK / 8;                   // n8 blocks of a score
static_assert(kBlockQ == hopper::kRows && kBlockK == hopper::kRows,
              "a q or k tile is one [64][D] TMA tile");

// Tiles first, each at a multiple of 1024 bytes from the aligned start.
template <int D, int kGroups, int kStages>
struct FwdSmem {
  static constexpr int kTileBytes = hopper::tile_bytes<D>();
  uint8_t q[kGroups][kTileBytes];  // the block's Qr rows
  uint8_t k[kStages][kTileBytes];  // the ring: Kr
  uint8_t v[kStages][kTileBytes];  // and V
  uint64_t fixed_full, full[kStages], empty[kStages];
};

// The sliced ring (D past 256): each stage holds W columns of one [64]-key
// tile, a slice of Kr's width or the block's columns of V.
template <int D, int W, int kGroups, int kStages>
struct FwdSlicedSmem {
  uint8_t q[kGroups][hopper::tile_bytes<D>()];  // the block's Qr rows
  uint8_t ring[kStages][hopper::tile_bytes<W>()];
  uint64_t fixed_full, full[kStages], empty[kStages];
};

// The shared memory of a forward block at D holding kBlockCols of O's
// columns.
template <int D, int kGroups, int kStages, int kBlockCols>
using FwdSmemOf =
    std::conditional_t<(D > 256),
                       FwdSlicedSmem<D, kBlockCols, kGroups, kStages>,
                       FwdSmem<D, kGroups, kStages>>;

// The ring stages a sliced block at D takes: as many W-column stages as
// fit beside its kGroups Qr tiles.
template <int D, int kGroups, int W>
constexpr int sliced_stages() {
  return (232448 - 2048 - kGroups * hopper::tile_bytes<D>()) /
         hopper::tile_bytes<W>();
}

// Whether a tile masks element by element: the diagonal of q tile qt, or
// the ragged tile.
__device__ __forceinline__ bool edge_tile(int causal, int it, int qt, int k0,
                                          int seq_k) {
  return (causal && it == qt) || k0 + kBlockK > seq_k;
}

// K3's online-softmax step for one tile of a warpgroup's rows, from the S
// accumulator (element 4j + 2h + e: row row[h], column k0 + 8j + 2t + e):
// the scores' running max m, rescaling l and the output o; P = exp(score -
// m) added to this thread's share of l; and P rounded to bf16 as the A
// fragments of P V (pa[k] covers keys 16k..16k+15). kEdge as in stats_tile;
// kNo, the n8 blocks of the output, D / 8.
template <bool kEdge, int kNo>
__device__ __forceinline__ void fwd_tile_p(
    uint32_t (&pa)[kBlockK / 16][4], float (&s)[4 * kNs],
    float (&o)[4 * kNo], float (&m)[2], float (&l)[2], const int (&row)[2],
    int k0, int t, int seq_k, int causal, const float* km, float scale) {
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int j = 0; j < kNs; ++j) {
    const int col = k0 + j * 8 + 2 * t;
    float bias[2];
    if (!kEdge) column_bias(bias, km, col);
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float& x = s[4 * j + 2 * h + e];
        x = kEdge ? masked_score(x, scale, row[h], col + e, seq_k, causal,
                                 km)
                  : interior_score(x, scale, bias[e]);
        mx[h] = fmaxf(mx[h], x);
      }
  }
  float m_use[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float corr = rescale(m[h], row_max(mx[h]), m_use[h]);
    l[h] *= corr;
#pragma unroll
    for (int j = 0; j < kNo; ++j) {
      o[4 * j + 2 * h] *= corr;
      o[4 * j + 2 * h + 1] *= corr;
    }
  }
#pragma unroll
  for (int j = 0; j < kNs; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float p[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float x = s[4 * j + 2 * h + e];
        p[e] = (kEdge && x == -INFINITY) ? 0.f : expf(x - m_use[h]);
        l[h] += p[e];
      }
      pa[j >> 1][(j & 1) * 2 + h] = pack_pair(p[0], p[1]);
    }
}

// K1's P for one tile as A fragments, from the S accumulator and the rows'
// final max m and 1/l: exp(score - m) * (1/l) in fp32, rounded to bf16.
// (torch.softmax divides by l; the product reads the same error against it
// and costs a quarter less of K1's time: tools/k1_variants.py, PERF.md.)
// kEdge as in stats_tile.
template <bool kEdge>
__device__ __forceinline__ void fwd_tile_p_normalised(
    uint32_t (&pa)[kBlockK / 16][4], const float (&s)[4 * kNs],
    const float (&row_m)[2], const float (&row_il)[2], const int (&row)[2],
    int k0, int t, int seq_k, int causal, const float* km, float scale) {
#pragma unroll
  for (int j = 0; j < kNs; ++j) {
    const int col = k0 + j * 8 + 2 * t;
    float bias[2];
    if (!kEdge) column_bias(bias, km, col);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float p[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float acc = s[4 * j + 2 * h + e];
        const float x =
            kEdge ? masked_score(acc, scale, row[h], col + e, seq_k, causal,
                                 km)
                  : interior_score(acc, scale, bias[e]);
        p[e] = (kEdge && x == -INFINITY) ? 0.f
                                           : p_of<true>(x, row_m[h], row_il[h]);
      }
      pa[j >> 1][(j & 1) * 2 + h] = pack_pair(p[0], p[1]);
    }
  }
}

// The body of K1 (kStats: a statistics pass, then P normalised; out only)
// and K3 (one online pass; out and lse) at head dim D. Grid (q blocks of 64
// kGroups rows times D / (kOCols kSplit) column groups, bh); block 128
// kGroups kSplit + 32 threads: kSplit warpgroups a group of 64 q rows,
// warpgroup `part` holding kOCols of O's columns (D / kSplit, the whole
// width split, up to 256; past 256 kSlicedCols of the block's column
// group), each forming the rows' whole S. Up to 256 a ring stage holds a
// whole [64][D] tile of Kr and of V; past 256 (the sliced ring) one slice
// of W = kOCols kSplit columns, the tile's D / W slices of Kr in turn, then
// (in the pass that forms P V) its block's W columns of V.
template <bool kStats, int D, int kGroups, int kStages, int kSplit,
          int kOCols = D / kSplit>
__device__ __forceinline__ void fwd_wgmma(
    const CUtensorMap* tm_q, const CUtensorMap* tm_k, const CUtensorMap* tm_v,
    bf16* __restrict__ o, float* __restrict__ lse,
    const float* __restrict__ kmask, int mask_rows, int seq_q, int seq_k,
    int num_heads, float scale, int causal) {
  using namespace hopper;
  constexpr int kBlockRows = kBlockQ * kGroups;
  constexpr int kPasses = kStats ? 2 : 1;
  constexpr bool kSliced = D > 256;
  constexpr int kW = kOCols * kSplit;               // O's columns a block
  constexpr int kColGroups = D / kW;                // holds; blocks a row
  constexpr int kSlices = kSliced ? D / kW : 1;     // Kr stages a tile
  constexpr int kNo = kOCols / 8;                   // n8 blocks of O
  constexpr int kOColBytes = kOCols / kBoxCols * kBoxBytes;
  constexpr int kConsumers = 128 * kGroups * kSplit;
  static_assert(kOCols % kBoxCols == 0, "a warpgroup's columns are boxes");
  static_assert(kColGroups * kW == D && (kSliced || kColGroups == 1),
                "the blocks of a row group cover O's columns");
  static_assert(!kSliced || kStages >= 2,
                "a tile's next slice arrives before its last is released");
  // a slice; up to 256 each of a stage's two tiles (Kr, V)
  constexpr int kStageBytes = tile_bytes<kW>();
  extern __shared__ uint8_t smem_raw[];
  auto& sm = aligned_smem<FwdSmemOf<D, kGroups, kStages, kW>>(smem_raw);
  const int n_t = (seq_k + kBlockK - 1) / kBlockK;
  const int n_b = (seq_q + kBlockRows - 1) / kBlockRows;
  // a q block's column groups run side by side, sharing its Qr and Kr
  const int col_group = (int)blockIdx.x % kColGroups;
  const int bh = blockIdx.y;
  const int q0 = (n_b - 1 - (int)blockIdx.x / kColGroups) * kBlockRows;
  // the warpgroups whose rows start below seq_q; a causal walk ends at the
  // last one's diagonal tile (or at the last k tile)
  const int groups = min(kGroups, (seq_q - q0 + kBlockQ - 1) / kBlockQ);
  const int n_tiles = causal ? min(n_t, q0 / kBlockK + groups) : n_t;
  if (threadIdx.x == 0) {
    mbar_init(&sm.fixed_full, 1);
    for (int st = 0; st < kStages; ++st) {
      mbar_init(&sm.full[st], 1);
      mbar_init(&sm.empty[st], 128 * kSplit * groups);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {  // the producer: one thread
    if (threadIdx.x == kConsumers) {
      mbar_arrive_expect_tx(&sm.fixed_full, groups * tile_bytes<D>());
      for (int w = 0; w < groups; ++w)
        tma_load_tile<D>(sm.q[w], tm_q, &sm.fixed_full, q0 + w * kBlockQ,
                         bh);
      if constexpr (kSliced) {
        int n = 0;  // stages filled
        const auto fill = [&](const CUtensorMap* tm, int col0, int k0) {
          const int st = n % kStages;
          if (n >= kStages) mbar_wait(&sm.empty[st], (n / kStages - 1) & 1);
          mbar_arrive_expect_tx(&sm.full[st], kStageBytes);
          tma_load_cols<kW>(sm.ring[st], tm, &sm.full[st], col0, k0, bh);
          ++n;
        };
        for (int it = 0; it < kPasses * n_tiles; ++it) {
          const int k0 = (it % n_tiles) * kBlockK;
          for (int j = 0; j < kSlices; ++j) fill(tm_k, j * kW, k0);
          if (!kStats || it >= n_tiles) fill(tm_v, col_group * kW, k0);
        }
      } else {
        for (int it = 0; it < kPasses * n_tiles; ++it) {
          const int st = it % kStages, k0 = (it % n_tiles) * kBlockK;
          const bool with_v = !kStats || it >= n_tiles;  // K1's pass 1: Kr
          if (it >= kStages) mbar_wait(&sm.empty[st], (it / kStages - 1) & 1);
          mbar_arrive_expect_tx(&sm.full[st],
                                (with_v ? 2 : 1) * kStageBytes);
          tma_load_tile<D>(sm.k[st], tm_k, &sm.full[st], k0, bh);
          if (with_v) tma_load_tile<D>(sm.v[st], tm_v, &sm.full[st], k0, bh);
        }
      }
    }
    return;
  }

  // this warpgroup's q-row group and its part of the block's columns
  const int wg = threadIdx.x / 128 / kSplit;
  const int part = threadIdx.x / 128 % kSplit;
  if (wg >= groups) return;  // every row of this warpgroup is past seq_q
  const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int qt = q0 / kBlockQ + wg;  // this warpgroup's q tile
  const int row[2] = {qt * kBlockQ + warp * 16 + g,
                      qt * kBlockQ + warp * 16 + g + 8};
  // up to its diagonal
  const int own_tiles = causal ? min(qt + 1, n_tiles) : n_tiles;
  const float* km = nullptr;
  if (kmask != nullptr)
    km = kmask + (size_t)(mask_rows == 1 ? 0 : bh / num_heads) * seq_k;
  // Accumulator element 4j + 2h + e: row 16 warp + g + 8h, column 8j + 2t + e.
  float o_acc[4 * kNo], s[4 * kNs];
  zero_regs(o_acc);
  zero_regs(s);
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  int ring = 0;  // stages taken from the ring so far
  // the next stage, once it has arrived
  const auto take = [&]() {
    const int st = ring % kStages;
    mbar_wait(&sm.full[st], (ring / kStages) & 1);
    ++ring;
    return st;
  };
  const auto release = [&](int st) { mbar_arrive(&sm.empty[st]); };
  // S = Qr Kr^T of the next tile: from stage st, which the caller took;
  // in the sliced ring from the tile's kSlices stages, each taken here and
  // released once the products of the next one are under way
  const auto scores = [&](int st) {
    wgmma_fence();
    if constexpr (kSliced) {
      int prev = 0;
#pragma unroll
      for (int j = 0; j < kSlices; ++j) {
        const int cur = take();
#pragma unroll
        for (int kk = 0; kk < kW / 16; ++kk)
          wgmma_m64n64k16_ss(s, kmajor_desc(sm.q[wg], j * (kW / 16) + kk),
                             kmajor_desc(sm.ring[cur], kk), j > 0 || kk > 0);
        wgmma_commit();
        if (j > 0) {
          wgmma_wait<1>();
          release(prev);
        }
        prev = cur;
      }
      wgmma_wait<0>();
      release(prev);
    } else {
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_m64n64k16_ss(s, kmajor_desc(sm.q[wg], kk),
                           kmajor_desc(sm.k[st], kk), kk > 0);
      wgmma_commit();
      wgmma_wait<0>();
    }
    fence_regs(s);
  };
  float row_m[2], row_il[2];
  mbar_wait(&sm.fixed_full, 0);
  if constexpr (kStats) {
    // pass 1: each row's max and denominator
    float unused[2];
    for (int it = 0; it < n_tiles; ++it) {
      const int k0 = it * kBlockK;
      if (it >= own_tiles) {  // past this warpgroup's diagonal
        for (int j = 0; j < kSlices; ++j) release(take());
        continue;
      }
      if constexpr (kSliced) {
        scores(0);
      } else {
        const int st = take();
        scores(st);
        release(st);  // the product has read the stage
      }
      if (edge_tile(causal, it, qt, k0, seq_k))
        stats_tile<true, false>(s, s, m, l, unused, row, k0, t, seq_k,
                                causal, km, scale);
      else
        stats_tile<false, false>(s, s, m, l, unused, row, k0, t, seq_k,
                                 causal, km, scale);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float lt = row_sum(l[h]);
      row_m[h] = (m[h] == -INFINITY) ? 0.f : m[h];
      row_il[h] = lt > 0.f ? 1.0f / lt : 0.f;
    }
  }

  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = it * kBlockK;
    // a stage is released only after it arrived, also where this
    // warpgroup skips it (a causal tile past its diagonal)
    if (it >= own_tiles) {
      for (int j = 0; j < (kSliced ? kSlices + 1 : 1); ++j) release(take());
      continue;
    }
    int st = kSliced ? 0 : take();
    scores(st);
    uint32_t pa[kBlockK / 16][4];  // A fragments of P, one per 16 keys
    const bool edge = edge_tile(causal, it, qt, k0, seq_k);
    if constexpr (kStats) {
      if (edge)
        fwd_tile_p_normalised<true>(pa, s, row_m, row_il, row, k0, t, seq_k,
                                    causal, km, scale);
      else
        fwd_tile_p_normalised<false>(pa, s, row_m, row_il, row, k0, t,
                                     seq_k, causal, km, scale);
    } else {
      if (edge)
        fwd_tile_p<true, kNo>(pa, s, o_acc, m, l, row, k0, t, seq_k, causal,
                              km, scale);
      else
        fwd_tile_p<false, kNo>(pa, s, o_acc, m, l, row, k0, t, seq_k,
                               causal, km, scale);
    }
    const uint8_t* v_cols;  // the tile's V, from this warpgroup's columns
    if constexpr (kSliced) {
      st = take();
      v_cols = sm.ring[st] + part * kOColBytes;
    } else {
      v_cols = sm.v[st] + part * kOColBytes;
    }
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBlockK / 16; ++kk)
      wgmma_m64nNk16_rs<kOCols, kMNMajor>(o_acc, pa[kk],
                                          mnmajor_desc(v_cols, kk));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(o_acc);
    fence_regs(pa);
    release(st);
  }

  // this warpgroup's first column of O
  const int col0 = col_group * kW + part * kOCols;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float lt = kStats ? 1.f : row_sum(l[h]);
    if (row[h] >= seq_q) continue;
    const float inv = kStats ? 1.f : (lt > 0.f ? 1.0f / lt : 0.f);
    bf16* out = o + ((size_t)bh * seq_q + row[h]) * D + col0 + 2 * t;
#pragma unroll
    for (int j = 0; j < kNo; ++j)
      *reinterpret_cast<uint32_t*>(out + j * 8) =
          pack_pair(o_acc[4 * j + 2 * h] * inv, o_acc[4 * j + 2 * h + 1] * inv);
    if (!kStats && col0 == 0 && t == 0)
      lse[(size_t)bh * seq_q + row[h]] = row_lse(m[h], lt);
  }
}

#define FWD_WGMMA_PARAMS                                                     \
  const __grid_constant__ CUtensorMap tm_q,                                  \
      const __grid_constant__ CUtensorMap tm_k,                              \
      const __grid_constant__ CUtensorMap tm_v, bf16 *__restrict__ o,        \
      float *__restrict__ lse, const float *__restrict__ kmask,              \
      int mask_rows, int seq_q, int seq_k, int num_heads, float scale,       \
      int causal

// K1: the output (lse unused, null).
template <int D, int kGroups, int kStages, int kSplit, int kOCols>
__global__ void __launch_bounds__(128 * kGroups * kSplit + 32, 1)
    flash_fwd_wgmma_kernel(FWD_WGMMA_PARAMS) {
  fwd_wgmma<true, D, kGroups, kStages, kSplit, kOCols>(
      &tm_q, &tm_k, &tm_v, o, lse, kmask, mask_rows, seq_q, seq_k,
      num_heads, scale, causal);
}

// K3: the output and lse.
template <int D, int kGroups, int kStages, int kSplit, int kOCols>
__global__ void __launch_bounds__(128 * kGroups * kSplit + 32, 1)
    flash_fwd_lse_wgmma_kernel(FWD_WGMMA_PARAMS) {
  fwd_wgmma<false, D, kGroups, kStages, kSplit, kOCols>(
      &tm_q, &tm_k, &tm_v, o, lse, kmask, mask_rows, seq_q, seq_k,
      num_heads, scale, causal);
}

#undef FWD_WGMMA_PARAMS

// ---- launch --------------------------------------------------------------

// The arguments of one forward launch. qr/kr (q and k rotated by R1), v, o:
// (bh, seq_q | seq_k, d) contiguous; kmask (mask_rows, seq_k) fp32 or null;
// lse (bh, seq_q) fp32 (K3) or null (K1).
struct FwdArgs {
  const void *qr, *kr, *v;
  void* o;
  float* lse;
  const float* kmask;
  int mask_rows, bh, seq_q, seq_k, num_heads;
  float scale;
  int causal;
  cudaStream_t stream;
};

template <int D, bool kLse>
cudaError_t launch_fp32(const FwdArgs& a) {
  constexpr int bytes = fp32_smem_bytes<D>();
  const auto kernel = flash_fwd_fp32_kernel<D, kLse>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  dim3 grid(a.bh, (a.seq_q + kBlockQ - 1) / kBlockQ);
  kernel<<<grid, kThreads, bytes, a.stream>>>(
      static_cast<const float*>(a.qr), static_cast<const float*>(a.kr),
      static_cast<const float*>(a.v), static_cast<float*>(a.o), a.lse,
      a.kmask, a.mask_rows, a.seq_q, a.seq_k, a.num_heads, a.scale,
      a.causal);
  return cudaGetLastError();
}

// K1 (kLse false) or K3 in bf16; kOCols of O's columns a consumer
// warpgroup.
template <int D, bool kLse, int kGroups, int kStages, int kSplit = 1,
          int kOCols = D / kSplit>
cudaError_t launch_bf16(const FwdArgs& a) {
  CUtensorMap m[3];
  if (!hopper::make_map(&m[0], a.qr, a.bh, a.seq_q, D) ||
      !hopper::make_map(&m[1], a.kr, a.bh, a.seq_k, D) ||
      !hopper::make_map(&m[2], a.v, a.bh, a.seq_k, D))
    return cudaErrorInvalidValue;
  constexpr int kW = kOCols * kSplit;
  constexpr int bytes =
      hopper::smem_bytes<FwdSmemOf<D, kGroups, kStages, kW>>();
  static_assert(bytes <= 232448, "a block's shared memory");
  const auto kernel = [] {
    if constexpr (kLse)
      return flash_fwd_lse_wgmma_kernel<D, kGroups, kStages, kSplit, kOCols>;
    else
      return flash_fwd_wgmma_kernel<D, kGroups, kStages, kSplit, kOCols>;
  }();
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const int rows = kBlockQ * kGroups;
  const dim3 grid((a.seq_q + rows - 1) / rows * (D / kW), a.bh);
  kernel<<<grid, 128 * kGroups * kSplit + 32, bytes, a.stream>>>(
      m[0], m[1], m[2], static_cast<bf16*>(a.o), a.lse, a.kmask,
      a.mask_rows, a.seq_q, a.seq_k, a.num_heads, a.scale, a.causal);
  return cudaGetLastError();
}

// K1 or K3 in bf16 at D = 384 or 768, on the sliced ring.
template <int D, bool kLse>
cudaError_t launch_sliced(const FwdArgs& a) {
  constexpr int kGroups = 1;  // q-row groups of 64 a block
  return launch_bf16<D, kLse, kGroups,
                     sliced_stages<D, kGroups, kSlicedCols * kSlicedSplit>(),
                     kSlicedSplit, kSlicedCols>(a);
}

// K1 (kLse false) or K3 at a.d's instantiation, fp32 (dtype 0) or bf16
// (also at 192, 256, 384 and 768); at any other multiple of 64, the wide
// body.
template <bool kLse>
cudaError_t launch(int dtype, int d, const FwdArgs& a) {
  if (a.bh <= 0 || a.bh > 65535 || a.seq_q <= 0 || a.seq_k <= 0 ||
      (dtype != 0 && dtype != 1) || (a.seq_q + kBlockQ - 1) / kBlockQ > 65535)
    return cudaErrorInvalidValue;
  if (wide::takes_wide(kLse ? wide::kK3 : wide::kK1, dtype, d, d)) {
    const wide::Args w{a.qr,      a.kr,        a.v,     nullptr, nullptr,
                       nullptr,   nullptr,     nullptr, nullptr, nullptr,
                       nullptr,   a.kmask,     a.mask_rows, a.bh, a.seq_q,
                       a.seq_k,   d,           d,       a.num_heads, a.scale,
                       a.causal,  a.stream};
    return dtype == 0 ? wide::launch_fwd<float, !kLse>(w, a.o, a.lse)
                      : wide::launch_fwd<bf16, !kLse>(w, a.o, a.lse);
  }
  // past 128 (takes_wide sends fp32 and the other widths to the wide body)
  switch (dtype == 1 ? d : 0) {
    case 192:
      if constexpr (kLse)
        return launch_bf16<192, true, wide_fwd_groups<192>(), kWideFwdStages,
                           kWideFwdSplit>(a);
      else
        return launch_bf16<192, false, wide_fwd_groups<192>(),
                           kWideResStages, kWideFwdSplit>(a);
    case 256:
      if constexpr (kLse)
        return launch_bf16<256, true, wide_fwd_groups<256>(), kWideFwdStages,
                           kWideFwdSplit>(a);
      else
        return launch_bf16<256, false, wide_fwd_groups<256>(),
                           kWideResStages, kWideFwdSplit>(a);
    case 384:
      return launch_sliced<384, kLse>(a);
    case 768:
      return launch_sliced<768, kLse>(a);
  }
  return dispatch_head_dim(d, [&](auto head_dim) {
    constexpr int D = decltype(head_dim)::value;
    if (dtype == 0) return launch_fp32<D, kLse>(a);
    if constexpr (kLse)
      return launch_bf16<D, true, kFwdGroups, kFwdStages>(a);
    else
      return launch_bf16<D, false, kResGroups, kResStages>(a);
  });
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. qr (q rotated by R1), o: (bh, seq_q, d);
// kr (k rotated by R1), v: (bh, seq_k, d); all contiguous; d = 64, 96, 128
// or a multiple of 64; kmask: (mask_rows, seq_k) fp32 or null.
// K1: the output only.
extern "C" int meant_flash_fwd(int dtype, const void* qr, const void* kr,
                               const void* v, void* o, const void* kmask,
                               int mask_rows, int bh, int seq_q, int seq_k,
                               int d, int num_heads, float scale, int causal,
                               void* stream) {
  const FwdArgs a{qr, kr, v, o, nullptr, static_cast<const float*>(kmask),
                  mask_rows, bh, seq_q, seq_k, num_heads, scale, causal,
                  static_cast<cudaStream_t>(stream)};
  return (int)launch<false>(dtype, d, a);
}

// K3: the output and each row's log-sum-exp, lse: (bh, seq_q) fp32.
extern "C" int meant_flash_fwd_lse(int dtype, const void* qr, const void* kr,
                                   const void* v, void* o, void* lse,
                                   const void* kmask, int mask_rows, int bh,
                                   int seq_q, int seq_k, int d, int num_heads,
                                   float scale, int causal, void* stream) {
  if (lse == nullptr) return (int)cudaErrorInvalidValue;
  const FwdArgs a{qr, kr, v, o, static_cast<float*>(lse),
                  static_cast<const float*>(kmask), mask_rows, bh, seq_q,
                  seq_k, num_heads, scale, causal,
                  static_cast<cudaStream_t>(stream)};
  return (int)launch<true>(dtype, d, a);
}
