// Rotary-fused flash-attention forwards for Hopper (sm_90a): K1 and K3.
//
// K1 replaces the TPU kernel meant_tpu/ops/flash/kernel.py:_fwd_kernel (the
// resident forward, launched by _flash_fwd). For each (batch*head, q row) it
// computes what that kernel computes:
//   1. rotate q and k in fp32: x*cos + rotate_half(x)*sin, with interleaved
//      pairs (out[2i] = -x[2i+1], out[2i+1] = x[2i]) and fp32 (s, d) tables
//      that already carry the xPos scales;
//   2. round the rotated q and k to the input dtype;
//   3. QK^T accumulated in fp32, times `scale`;
//   4. the causal -inf fill (col <= row kept);
//   5. + (1 - kmask) * -1e9 when a key mask is given, mask row bh / num_heads
//      (or row 0 for a broadcast mask);
//   6. softmax in fp32; 7. P rounded to the input dtype;
//   8. P @ V accumulated in fp32; 9. output in the input dtype.
//
// Design. The TPU kernel keeps a whole K/V row resident in VMEM and takes a
// single-pass softmax. On Hopper K+V for s=512, d=96 in bf16 is already
// 192 KiB of the 227 KiB a block may hold (fp32 would not fit), so both
// kernels here walk K/V in 64-row tiles inside the block with an online
// softmax (running max and denominator per row; the result is the same up
// to fp32 rounding, except that P is rounded to the input dtype relative to
// the running max instead of after normalising). One block of 4 warps per
// (bh, 64-row q tile); causal tiles past the diagonal are skipped; the
// ragged edge (s=196) is masked in the kernel: rows past s are zero-filled
// on load and never written, columns past s get -inf. Only the main path's
// head dim, 96, is instantiated; the kernels are templated on it (any
// multiple of 16 up to 128 would do) so another width is one case more.
//
// * bf16 (the main path): tensor cores through mma.sync m16n8k16 (bf16 in,
//   fp32 accumulate). Each warp owns 16 q rows; their rotated Q fragments
//   stay in registers, S = Q K^T and the online softmax stay in registers,
//   and P goes from the S accumulators straight into the A fragments of
//   P @ V. Rotated K and transposed V go through shared memory.
// * fp32 (the tight on-card check): scalar fp32 FMAs from shared memory
//   (every thread owns 8 q rows x 4 score columns and 8 rows x d/16 output
//   columns), since the tensor cores would round fp32 to TF32.
//
// Bound on an H100 SXM (989 TFLOP/s bf16 dense, 3.35 TB/s): at the main
// path's shapes (BH = 640, d = 96, bf16) the launch must move q, k, v and o
// once -- 252 MB at s=512, about 75 us, and 96 MB at s=196, about 29 us --
// while its products need 32 GFLOP (causal half) and 9.4 GFLOP, 33 us and
// 10 us on the tensor cores: both shapes are bound by bytes. Neither of
// K1's kernels pipelines its loads (no cp.async/TMA, no wgmma): that is
// later work.
//
// K3. The streaming forward meant_tpu/ops/flash/kernel.py:_fwd_online_kernel
// (launched by _flash_fwd_online, the path flash_mha takes past the
// resident limits, for return_lse and for force_online). That kernel walks
// k blocks with an online softmax, rounds the unnormalised P at the running
// max, and writes each row's log-sum-exp beside the output: lse = m_safe +
// log(max(l, 1e-30)), m_safe = 0 on a row with no finite score. K3 computes
// that from q and k rotated once by the rotation pass (R1,
// flash_bwd_online.cu; the bits of the TPU kernel's rotation at :152-155),
// so it rotates nothing itself; lse is (bh, seq) fp32, rows past seq are not
// written. At its main path's shapes (text tower of src4096: BH = 80, s =
// 4096, d = 96, bf16, causal) K3 is bound by operations: two products over
// the causal triangle, 257.7 GFLOP, 0.26 ms at 989 TFLOP/s, against 189 MB
// of qr, kr, v, o and lse (0.056 ms).
// * bf16: a block is kFwdGroups consumer warpgroups of 64 q rows each and a
//   producer warp. The producer brings the block's Qr rows once, then
//   streams Kr and V tiles through TMA (hopper.cuh: 3-D tensor maps over
//   (bh, s, 96), 64-byte swizzle, zero past s) into a ring of kFwdStages
//   stages with full and empty mbarriers; every consumer warpgroup reads
//   every stage. One group and two stages were measured fastest (two
//   groups, which halve the streamed bytes per q row, and three stages
//   were some 4% slower at src4096's launch: tools/k23_variants.py); one
//   group of 154 registers leaves room for two blocks an SM. S = Qr
//   Kr^T runs on wgmma with both operands in shared memory (m64n64k16); the
//   online softmax stays in the accumulator registers; P, rounded to bf16 in
//   place at the running max as the reference rounds it, is the A fragment
//   of O += P V (m64n96k16, V read MN-major through the transpose bit: no
//   transposed copy). Only the diagonal and ragged tiles mask element by
//   element (masked_score); every other tile takes the key mask as a
//   per-column bias, rounded as the reference rounds it. Grid (q blocks,
//   bh), the blocks with the most tiles to walk first.
// * fp32 (the tight on-card check): the scalar body above, reading the
//   pre-rotated tiles.
//
// C interface (loaded with ctypes): meant_flash_fwd (K1) and
// meant_flash_fwd_lse (K3) return the cudaError_t of the launch (0 on
// success); they never synchronise.

#include <type_traits>

#include "flash_common.cuh"
#include "hopper.cuh"

namespace {

using namespace meant;

constexpr int kBlockQ = 64;              // q rows per block
constexpr int kBlockK = 64;              // k rows per tile
constexpr int kThreads = 128;            // 4 warps

// Load rows [row0, row0 + rows) of one (s, D) slice of input dtype T into
// shared memory of element type S (row stride `stride` elements), rotating
// each interleaved pair with the fp32 tables and rounding to T. Rows at or
// past `seq` are zero-filled.
template <typename T, int D, typename S>
__device__ __forceinline__ void load_rotated(
    S* dst, int stride, const T* src, const float* cos_t, const float* sin_t,
    int row0, int rows, int seq) {
  constexpr int kPairs = D / 2;
  for (int e = threadIdx.x; e < rows * kPairs; e += kThreads) {
    const int r = e / kPairs;
    const int c = 2 * (e % kPairs);
    const int g = row0 + r;
    float y0 = 0.f, y1 = 0.f;
    if (g < seq) {
      const float x0 = to_f<T>(src[(size_t)g * D + c]);
      const float x1 = to_f<T>(src[(size_t)g * D + c + 1]);
      const float* cs = cos_t + (size_t)g * D + c;
      const float* sn = sin_t + (size_t)g * D + c;
      // x*cos + rotate_half(x)*sin, as two products and one add each
      // (no FMA contraction), as the reference rounds them.
      y0 = __fadd_rn(__fmul_rn(x0, cs[0]), __fmul_rn(-x1, sn[0]));
      y1 = __fadd_rn(__fmul_rn(x1, cs[1]), __fmul_rn(x0, sn[1]));
    }
    dst[r * stride + c] = from_f<S>(to_f<T>(from_f<T>(y0)));
    dst[r * stride + c + 1] = from_f<S>(to_f<T>(from_f<T>(y1)));
  }
}

__device__ __forceinline__ int num_k_tiles(int seq, int q0, int causal) {
  const int n = (seq + kBlockK - 1) / kBlockK;
  return causal ? min(n, (q0 + kBlockQ - 1) / kBlockK + 1) : n;
}

// ---- bf16: tensor cores (mma.sync m16n8k16) ------------------------------

constexpr int kPadH = 8;  // bf16 elements of padding per shared-memory row

template <int D>
constexpr int mma_smem_bytes() {
  return (int)sizeof(bf16) * ((kBlockQ + kBlockK) * (D + kPadH) +
                              D * (kBlockK + kPadH));
}

// The log-sum-exp K3 writes for a row whose running max is m and whose
// denominator (relative to that max, or to 0 when m = -inf) is l, as the
// TPU kernel writes it: m_safe + log(max(l, 1e-30)).
__device__ __forceinline__ float row_lse(float m, float l) {
  return (m == -INFINITY ? 0.f : m) + logf(fmaxf(l, 1e-30f));
}

// Fragment layout of m16n8k16: see flash_common.cuh. The body of K1.
template <int D>
__device__ __forceinline__ void fwd_mma(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, bf16* __restrict__ o,
    const float* __restrict__ qcos, const float* __restrict__ qsin,
    const float* __restrict__ kcos, const float* __restrict__ ksin,
    const float* __restrict__ kmask, int mask_rows, int seq, int num_heads,
    float scale, int causal) {
  constexpr int kStride = D + kPadH;           // qs / ks row stride
  constexpr int kStrideV = kBlockK + kPadH;    // vt row stride
  constexpr int kChunksD = D / 16;             // k-steps of Q K^T
  constexpr int kTilesS = kBlockK / 8;         // n-tiles of S (8 keys each)
  constexpr int kTilesO = D / 8;               // n-tiles of O
  extern __shared__ float smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem);    // [kBlockQ][D + pad]
  bf16* ks = qs + kBlockQ * kStride;           // [kBlockK][D + pad]
  bf16* vt = ks + kBlockK * kStride;           // [D][kBlockK + pad], V^T

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.x;
  const int q0 = blockIdx.y * kBlockQ;
  const int r0 = warp * 16 + g;                // this lane's first q row
  const int row[2] = {q0 + r0, q0 + r0 + 8};
  const size_t base = (size_t)bh * seq * D;
  const float* km = nullptr;
  if (kmask != nullptr)
    km = kmask + (size_t)(mask_rows == 1 ? 0 : bh / num_heads) * seq;

  load_rotated<bf16, D>(qs, kStride, q + base, qcos, qsin, q0, kBlockQ, seq);
  __syncthreads();
  uint32_t qa[kChunksD][4];
#pragma unroll
  for (int c = 0; c < kChunksD; ++c) {
    const bf16* p = qs + r0 * kStride + c * 16 + 2 * t;
    qa[c][0] = ld_pair(p);
    qa[c][1] = ld_pair(p + 8 * kStride);
    qa[c][2] = ld_pair(p + 8);
    qa[c][3] = ld_pair(p + 8 * kStride + 8);
  }

  float acc[kTilesO][4];
#pragma unroll
  for (int j = 0; j < kTilesO; ++j)
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

  const int n_tiles = num_k_tiles(seq, q0, causal);
  for (int tile = 0; tile < n_tiles; ++tile) {
    const int k0 = tile * kBlockK;
    __syncthreads();  // the previous tile's ks / vt reads are done
    load_rotated<bf16, D>(ks, kStride, k + base, kcos, ksin, k0, kBlockK,
                          seq);
    for (int e = threadIdx.x; e < kBlockK * D; e += kThreads) {
      const int r = e / D, d = e % D;
      vt[d * kStrideV + r] = (k0 + r < seq)
                                 ? v[base + (size_t)(k0 + r) * D + d]
                                 : __float2bfloat16_rn(0.f);
    }
    __syncthreads();

    float s[kTilesS][4];
#pragma unroll
    for (int j = 0; j < kTilesS; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
      for (int c = 0; c < kChunksD; ++c) {
        const bf16* p = ks + (j * 8 + g) * kStride + c * 16 + 2 * t;
        mma_bf16(s[j], qa[c], ld_pair(p), ld_pair(p + 8));
      }
    }

    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < kTilesS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1;
        s[j][e] = masked_score(s[j][e], scale, row[h],
                               k0 + j * 8 + 2 * t + (e & 1), seq, causal, km);
        mx[h] = fmaxf(mx[h], s[j][e]);
      }
    float m_use[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      // the four lanes of a row group hold the row's other columns
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      const float corr = rescale(m[h], mx[h], m_use[h]);
      l[h] *= corr;
#pragma unroll
      for (int j = 0; j < kTilesO; ++j) {
        acc[j][2 * h] *= corr;
        acc[j][2 * h + 1] *= corr;
      }
    }
#pragma unroll
    for (int j = 0; j < kTilesS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1;
        const float p =
            (s[j][e] == -INFINITY) ? 0.f : expf(s[j][e] - m_use[h]);
        l[h] += p;
        s[j][e] = p;
      }

    // P @ V: S n-tiles 2kc, 2kc+1 are the A fragment of key chunk kc
#pragma unroll
    for (int kc = 0; kc < kBlockK / 16; ++kc) {
      const uint32_t pa[4] = {
          pack_pair(s[2 * kc][0], s[2 * kc][1]),
          pack_pair(s[2 * kc][2], s[2 * kc][3]),
          pack_pair(s[2 * kc + 1][0], s[2 * kc + 1][1]),
          pack_pair(s[2 * kc + 1][2], s[2 * kc + 1][3])};
#pragma unroll
      for (int j = 0; j < kTilesO; ++j) {
        const bf16* p = vt + (j * 8 + g) * kStrideV + kc * 16 + 2 * t;
        mma_bf16(acc[j], pa, ld_pair(p), ld_pair(p + 8));
      }
    }
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    if (row[h] >= seq) continue;
    const float inv = l[h] > 0.f ? 1.0f / l[h] : 0.f;
    bf16* out = o + base + (size_t)row[h] * D + 2 * t;
#pragma unroll
    for (int j = 0; j < kTilesO; ++j)
      *reinterpret_cast<uint32_t*>(out + j * 8) =
          pack_pair(acc[j][2 * h] * inv, acc[j][2 * h + 1] * inv);
  }
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

template <int D, bool kLse>
__device__ __forceinline__ void fwd_fp32(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, float* __restrict__ o,
    float* __restrict__ lse, const float* __restrict__ qcos, const float* __restrict__ qsin,
    const float* __restrict__ kcos, const float* __restrict__ ksin,
    const float* __restrict__ kmask, int mask_rows, int seq, int num_heads,
    float scale, int causal) {
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
  const size_t base = (size_t)bh * seq * D;
  const float* km = nullptr;
  if (kmask != nullptr)
    km = kmask + (size_t)(mask_rows == 1 ? 0 : bh / num_heads) * seq;

  // K3 (kLse) takes q and k rotated by R1, K1 rotates them here
  if constexpr (kLse)
    load_tile<float, D>(qs, kStrideQK, nullptr, 0, q + base, nullptr,
                        nullptr, q0, seq);
  else
    load_rotated<float, D>(qs, kStrideQK, q + base, qcos, qsin, q0, kBlockQ,
                           seq);

  float m[kRows], l[kRows], acc[kRows][kOut];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < kOut; ++j) acc[i][j] = 0.f;
  }

  const int n_tiles = num_k_tiles(seq, q0, causal);
  for (int tile = 0; tile < n_tiles; ++tile) {
    const int k0 = tile * kBlockK;
    __syncthreads();  // the previous tile's ks/vs/ps reads are done
    if constexpr (kLse)
      load_tile<float, D>(ks, kStrideQK, nullptr, 0, k + base, nullptr,
                          nullptr, k0, seq);
    else
      load_rotated<float, D>(ks, kStrideQK, k + base, kcos, ksin, k0,
                             kBlockK, seq);
    for (int e = threadIdx.x; e < kBlockK * D; e += kThreads) {
      const int r = e / D;
      vs[e] = (k0 + r < seq) ? v[base + (size_t)k0 * D + e] : 0.f;
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
        s[i][c] = masked_score(s[i][c], scale, row, k0 + tx + kTx * c, seq,
                               causal, km);
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
    if (row >= seq) continue;
    const float inv = l[i] > 0.f ? 1.0f / l[i] : 0.f;
#pragma unroll
    for (int j = 0; j < kOut; ++j)
      o[base + (size_t)row * D + tx + kTx * j] = acc[i][j] * inv;
    if constexpr (kLse) {
      if (tx == 0) lse[(size_t)bh * seq + row] = row_lse(m[i], l[i]);
    }
  }
}

// ---- K1's kernels, and K3's fp32 kernel -----------------------------------

#define FLASH_FWD_PARAMS(T)                                                  \
  const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v, \
      T* __restrict__ o, float* __restrict__ lse,                            \
      const float* __restrict__ qcos, const float* __restrict__ qsin,        \
      const float* __restrict__ kcos, const float* __restrict__ ksin,        \
      const float* __restrict__ kmask, int mask_rows, int seq,               \
      int num_heads, float scale, int causal
#define FLASH_FWD_ARGS                                                     \
  q, k, v, o, lse, qcos, qsin, kcos, ksin, kmask, mask_rows, seq, num_heads, \
      scale, causal

// K1 (lse unused, null)
template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_mma_kernel(FLASH_FWD_PARAMS(bf16)) {
  fwd_mma<D>(q, k, v, o, qcos, qsin, kcos, ksin, kmask, mask_rows, seq,
             num_heads, scale, causal);
}
template <int D>
__global__ void __launch_bounds__(kThreads, 2)
    flash_fwd_fp32_kernel(FLASH_FWD_PARAMS(float)) {
  fwd_fp32<D, false>(FLASH_FWD_ARGS);
}
// K3 in fp32 (q and k rotated by R1; the tables are null)
template <int D>
__global__ void __launch_bounds__(kThreads, 2)
    flash_fwd_lse_fp32_kernel(FLASH_FWD_PARAMS(float)) {
  fwd_fp32<D, true>(FLASH_FWD_ARGS);
}

#undef FLASH_FWD_PARAMS
#undef FLASH_FWD_ARGS

// ---- K3 in bf16: TMA, mbarriers and wgmma ---------------------------------

constexpr int kHeadDim = 96;                       // the only head dim built
constexpr int kFwdGroups = 1;                      // consumer warpgroups
constexpr int kFwdStages = 2;                      // ring of Kr/V tiles
constexpr int kFwdRows = kBlockQ * kFwdGroups;     // q rows of a block
constexpr int kFwdBlock = 128 * kFwdGroups + 32;   // and the producer warp
constexpr int kNs = kBlockK / 8;                   // n8 blocks of a score
constexpr int kNo = kHeadDim / 8;                  // n8 blocks of the output
static_assert(kBlockQ == hopper::kRows && kBlockK == hopper::kRows &&
                  kHeadDim == hopper::kTileCols,
              "a q or k tile is one [64][96] TMA tile");

// Tiles first, each at a multiple of 1024 bytes from the aligned start.
struct FwdSmem {
  uint8_t q[kFwdGroups][hopper::kTileBytes];  // the block's Qr rows
  uint8_t k[kFwdStages][hopper::kTileBytes];  // the ring: Kr
  uint8_t v[kFwdStages][hopper::kTileBytes];  // and V
  uint64_t fixed_full, full[kFwdStages], empty[kFwdStages];
};

// One tile's online-softmax step for a warpgroup's rows, from the S
// accumulator (element 4j + 2h + e: row row[h], column k0 + 8j + 2t + e):
// the scores' running max m, rescaling l and the output o; P = exp(score -
// m) added to this thread's share of l; and P rounded to bf16 as the A
// fragments of P V (pa[k] covers keys 16k..16k+15). kEdge: the diagonal or
// the ragged tile, masked element by element (masked_score); else every
// score is live (interior_score).
template <bool kEdge>
__device__ __forceinline__ void fwd_tile_p(
    uint32_t (&pa)[kBlockK / 16][4], float (&s)[4 * kNs],
    float (&o)[4 * kNo], float (&m)[2], float (&l)[2], const int (&row)[2],
    int k0, int t, int seq, int causal, const float* km, float scale) {
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
        x = kEdge ? masked_score(x, scale, row[h], col + e, seq, causal, km)
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

// K3: out and lse. Grid (q blocks of kFwdRows rows, bh); block kFwdBlock
// threads.
__global__ void __launch_bounds__(kFwdBlock, 1) flash_fwd_lse_wgmma_kernel(
    const __grid_constant__ CUtensorMap tm_q,
    const __grid_constant__ CUtensorMap tm_k,
    const __grid_constant__ CUtensorMap tm_v, bf16* __restrict__ o,
    float* __restrict__ lse, const float* __restrict__ kmask, int mask_rows,
    int seq, int num_heads, float scale, int causal) {
  using namespace hopper;
  extern __shared__ uint8_t smem_raw[];
  FwdSmem& sm = aligned_smem<FwdSmem>(smem_raw);
  const int n_t = (seq + kBlockK - 1) / kBlockK;
  const int n_b = (seq + kFwdRows - 1) / kFwdRows;
  const int bh = blockIdx.y, q0 = (n_b - 1 - (int)blockIdx.x) * kFwdRows;
  // the warpgroups whose rows start below seq; a causal walk ends at the
  // last one's diagonal tile
  const int groups = min(kFwdGroups, (seq - q0 + kBlockQ - 1) / kBlockQ);
  const int n_tiles = causal ? q0 / kBlockK + groups : n_t;
  if (threadIdx.x == 0) {
    mbar_init(&sm.fixed_full, 1);
    for (int st = 0; st < kFwdStages; ++st) {
      mbar_init(&sm.full[st], 1);
      mbar_init(&sm.empty[st], 128 * groups);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x >= 128 * kFwdGroups) {  // the producer: one thread
    if (threadIdx.x == 128 * kFwdGroups) {
      mbar_arrive_expect_tx(&sm.fixed_full, groups * kTileBytes);
      for (int w = 0; w < groups; ++w)
        tma_load_tile(sm.q[w], &tm_q, &sm.fixed_full, q0 + w * kBlockQ, bh);
      for (int it = 0; it < n_tiles; ++it) {
        const int st = it % kFwdStages;
        if (it >= kFwdStages)
          mbar_wait(&sm.empty[st], (it / kFwdStages - 1) & 1);
        mbar_arrive_expect_tx(&sm.full[st], 2 * kTileBytes);
        tma_load_tile(sm.k[st], &tm_k, &sm.full[st], it * kBlockK, bh);
        tma_load_tile(sm.v[st], &tm_v, &sm.full[st], it * kBlockK, bh);
      }
    }
    return;
  }

  const int wg = threadIdx.x / 128;
  if (wg >= groups) return;  // every row of this warpgroup is past seq
  const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int qt = q0 / kBlockQ + wg;  // this warpgroup's q tile
  const int row[2] = {qt * kBlockQ + warp * 16 + g,
                      qt * kBlockQ + warp * 16 + g + 8};
  const int own_tiles = causal ? qt + 1 : n_tiles;  // up to its diagonal
  const float* km = nullptr;
  if (kmask != nullptr)
    km = kmask + (size_t)(mask_rows == 1 ? 0 : bh / num_heads) * seq;
  // Accumulator element 4j + 2h + e: row 16 warp + g + 8h, column 8j + 2t + e.
  float o_acc[4 * kNo], s[4 * kNs];
  zero_regs(o_acc);
  zero_regs(s);
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  mbar_wait(&sm.fixed_full, 0);
  for (int it = 0; it < n_tiles; ++it) {
    const int st = it % kFwdStages, k0 = it * kBlockK;
    // a stage is released only after it arrived, also where this
    // warpgroup skips it (a causal tile past its diagonal)
    mbar_wait(&sm.full[st], (it / kFwdStages) & 1);
    if (it < own_tiles) {
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kHeadDim / 16; ++kk)
        wgmma_m64n64k16_ss(s, kmajor_desc(sm.q[wg], kk),
                           kmajor_desc(sm.k[st], kk), kk > 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(s);
      uint32_t pa[kBlockK / 16][4];  // A fragments of P, one per 16 keys
      if ((causal && it == qt) || k0 + kBlockK > seq)
        fwd_tile_p<true>(pa, s, o_acc, m, l, row, k0, t, seq, causal, km,
                         scale);
      else
        fwd_tile_p<false>(pa, s, o_acc, m, l, row, k0, t, seq, causal, km,
                          scale);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBlockK / 16; ++kk)
        wgmma_m64n96k16_rs<kMNMajor>(o_acc, pa[kk],
                                     mnmajor_desc(sm.v[st], kk));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(o_acc);
      fence_regs(pa);
    }
    mbar_arrive(&sm.empty[st]);
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float lt = row_sum(l[h]);
    if (row[h] >= seq) continue;
    const float inv = lt > 0.f ? 1.0f / lt : 0.f;
    bf16* out = o + ((size_t)bh * seq + row[h]) * kHeadDim + 2 * t;
#pragma unroll
    for (int j = 0; j < kNo; ++j)
      *reinterpret_cast<uint32_t*>(out + j * 8) =
          pack_pair(o_acc[4 * j + 2 * h] * inv, o_acc[4 * j + 2 * h + 1] * inv);
    if (t == 0) lse[(size_t)bh * seq + row[h]] = row_lse(m[h], lt);
  }
}

// ---- launch --------------------------------------------------------------

// The kernels of one shared-memory body: K1's for both dtypes, and K3's
// fp32 one when kLse (K3's bf16 kernel has its own launch below).
template <int D, bool kLse> auto kernel_for(const bf16*) {
  static_assert(!kLse, "K3's bf16 kernel is launched by launch_lse_bf16");
  return flash_fwd_mma_kernel<D>;
}
template <int D, bool kLse> auto kernel_for(const float*) {
  return kLse ? flash_fwd_lse_fp32_kernel<D> : flash_fwd_fp32_kernel<D>;
}

template <typename T, int D, bool kLse>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   float* lse, const float* qcos, const float* qsin,
                   const float* kcos, const float* ksin, const float* kmask,
                   int mask_rows, int bh, int seq, int num_heads, float scale,
                   int causal, cudaStream_t stream) {
  constexpr int bytes = std::is_same<T, bf16>::value ? mma_smem_bytes<D>()
                                                     : fp32_smem_bytes<D>();
  auto kernel = kernel_for<D, kLse>(static_cast<const T*>(nullptr));
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  dim3 grid(bh, (seq + kBlockQ - 1) / kBlockQ);
  kernel<<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, qcos, qsin, kcos,
      ksin, kmask, mask_rows, seq, num_heads, scale, causal);
  return cudaGetLastError();
}

cudaError_t launch_lse_bf16(const void* qr, const void* kr, const void* v,
                            void* o, float* lse, const float* kmask,
                            int mask_rows, int bh, int seq, int num_heads,
                            float scale, int causal, cudaStream_t stream) {
  CUtensorMap m[3];
  if (!hopper::make_map(&m[0], qr, bh, seq) ||
      !hopper::make_map(&m[1], kr, bh, seq) ||
      !hopper::make_map(&m[2], v, bh, seq))
    return cudaErrorInvalidValue;
  constexpr int bytes = hopper::smem_bytes<FwdSmem>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_lse_wgmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((seq + kFwdRows - 1) / kFwdRows, bh);
  flash_fwd_lse_wgmma_kernel<<<grid, kFwdBlock, bytes, stream>>>(
      m[0], m[1], m[2], static_cast<bf16*>(o), lse, kmask, mask_rows, seq,
      num_heads, scale, causal);
  return cudaGetLastError();
}

bool invalid(int dtype, int bh, int seq, int d) {
  return bh <= 0 || bh > 65535 || seq <= 0 || d != kHeadDim ||
         (dtype != 0 && dtype != 1) || (seq + kBlockQ - 1) / kBlockQ > 65535;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. q/k/v/o: (bh, seq, d) contiguous;
// kmask: (mask_rows, seq) fp32 or null.
// K1: the output only; q and k rotated here by the (seq, d) fp32 tables.
extern "C" int meant_flash_fwd(int dtype, const void* q, const void* k,
                               const void* v, void* o, const void* qcos,
                               const void* qsin, const void* kcos,
                               const void* ksin, const void* kmask,
                               int mask_rows, int bh, int seq, int d,
                               int num_heads, float scale, int causal,
                               void* stream) {
  if (invalid(dtype, bh, seq, d)) return (int)cudaErrorInvalidValue;
  const auto f = [](const void* p) { return static_cast<const float*>(p); };
  const auto st = static_cast<cudaStream_t>(stream);
  return (int)(dtype == 0
                   ? launch<float, kHeadDim, false>(
                         q, k, v, o, nullptr, f(qcos), f(qsin), f(kcos),
                         f(ksin), f(kmask), mask_rows, bh, seq, num_heads,
                         scale, causal, st)
                   : launch<bf16, kHeadDim, false>(
                         q, k, v, o, nullptr, f(qcos), f(qsin), f(kcos),
                         f(ksin), f(kmask), mask_rows, bh, seq, num_heads,
                         scale, causal, st));
}

// K3: the output and each row's log-sum-exp, lse: (bh, seq) fp32, from qr
// and kr, q and k rotated by R1.
extern "C" int meant_flash_fwd_lse(int dtype, const void* qr, const void* kr,
                                   const void* v, void* o, void* lse,
                                   const void* kmask, int mask_rows, int bh,
                                   int seq, int d, int num_heads, float scale,
                                   int causal, void* stream) {
  if (invalid(dtype, bh, seq, d) || lse == nullptr)
    return (int)cudaErrorInvalidValue;
  const auto* km = static_cast<const float*>(kmask);
  auto* ls = static_cast<float*>(lse);
  const auto st = static_cast<cudaStream_t>(stream);
  return (int)(dtype == 0
                   ? launch<float, kHeadDim, true>(
                         qr, kr, v, o, ls, nullptr, nullptr, nullptr, nullptr,
                         km, mask_rows, bh, seq, num_heads, scale, causal, st)
                   : launch_lse_bf16(qr, kr, v, o, ls, km, mask_rows, bh, seq,
                                     num_heads, scale, causal, st));
}
