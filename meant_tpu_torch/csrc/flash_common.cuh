// Helpers shared by the flash kernels: the forwards (flash_fwd.cu, K1 and
// K3) and the backwards (flash_bwd.cu, K2; flash_bwd_online.cu, K4 and K5):
// dtype conversions, the bf16 tensor-core product mma.sync m16n8k16 and its
// fragment packing, the score masking, online-softmax rescale and
// statistics pass the kernels apply exactly alike, and the backwards'
// warp-level NT product, tile loader and rotation adjoint.
//
// Fragment layout of m16n8k16 (lane = 4 * g + t): A (16x16, row major)
// holds rows g and g+8 at columns 2t, 2t+1 and 2t+8, 2t+9; B (16x8, column
// major) holds k rows 2t, 2t+1 and 2t+8, 2t+9 of column g; C (16x8 fp32)
// holds rows g and g+8 at columns 2t, 2t+1.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace meant {

using bf16 = __nv_bfloat16;

template <typename T> __device__ __forceinline__ float to_f(T x);
template <> __device__ __forceinline__ float to_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ float to_f<bf16>(bf16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ bf16 from_f<bf16>(float x) {
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two bf16 at p, p+1 as one register (p even): the lower index in the low
// half, as mma.sync fragments hold them.
__device__ __forceinline__ uint32_t ld_pair(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_pair(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Scaled score with the causal fill and the additive key mask applied, in
// the reference's order: acc * scale, -inf where col > row, then
// + (1 - kmask) * -1e9. Columns (keys) at or past seq_k are -inf; row and
// col both count from 0, as the reference's causal fill does for any q and
// k lengths.
__device__ __forceinline__ float masked_score(float acc, float scale, int row,
                                              int col, int seq_k, int causal,
                                              const float* km) {
  if (col >= seq_k || (causal && col > row)) return -INFINITY;
  const float x = acc * scale;
  return km != nullptr ? x + (1.0f - km[col]) * -1e9f : x;
}

// The same score on a tile that neither the causal fill nor the ragged
// edge reaches, the key mask given as a per-column bias (column_bias):
// scale * acc + bias, rounded operation by operation as the reference
// rounds it.
__device__ __forceinline__ float interior_score(float acc, float scale,
                                                float bias) {
  return __fadd_rn(__fmul_rn(acc, scale), bias);
}

// The key mask's bias (1 - kmask) * -1e9 of columns col and col + 1; 0
// without a mask.
__device__ __forceinline__ void column_bias(float (&bias)[2], const float* km,
                                            int col) {
  bias[0] = bias[1] = 0.f;
  if (km != nullptr) {
    bias[0] = (1.0f - km[col]) * -1e9f;
    bias[1] = (1.0f - km[col + 1]) * -1e9f;
  }
}

// Online-softmax step for one row: new running max, and the factor that
// rescales what was accumulated under the old one.
__device__ __forceinline__ float rescale(float& m, float tile_max,
                                         float& m_use) {
  const float m_new = fmaxf(m, tile_max);
  m_use = (m_new == -INFINITY) ? 0.f : m_new;
  const float corr = (m == -INFINITY) ? 0.f : expf(m - m_use);
  m = m_new;
  return corr;
}

// Sum and max over the four lanes of a row group, which hold the row's
// other columns.
__device__ __forceinline__ float row_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

__device__ __forceinline__ float row_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

// exp(score - m), times 1/l when kScaled: P of one score (masked_score's
// -inf gives 0).
template <bool kScaled>
__device__ __forceinline__ float p_of(float sc, float m, float il) {
  const float e = expf(__fsub_rn(sc, m));
  return kScaled ? e * il : e;
}

// One tile's step of a statistics pass (K1's, and K2's dq kernel's), from a
// score accumulator of N = 4 * (n8 blocks) elements (element 4j + 2h + e:
// row row[h], column k0 + 8j + 2t + e): the scores masked in place, the
// running max m, and the denominator l -- and, when kDelta, sum_j P_ij
// dP_ij from the dP accumulator -- relative to it, over this thread's
// columns (summed over the row group at the end). kEdge: the diagonal or
// the ragged tile, masked element by element (masked_score); else every
// score is live and the key mask is a per-column bias (interior_score).
template <bool kEdge, bool kDelta, int N>
__device__ __forceinline__ void stats_tile(
    float (&s)[N], const float (&dp)[N], float (&m)[2], float (&l)[2],
    float (&dsum)[2], const int (&row)[2], int k0, int t, int seq_k,
    int causal, const float* km, float scale) {
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int j = 0; j < N / 4; ++j) {
    float bias[2];
    if (!kEdge) column_bias(bias, km, k0 + j * 8 + 2 * t);
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float& x = s[4 * j + 2 * h + e];
        x = kEdge ? masked_score(x, scale, row[h], k0 + j * 8 + 2 * t + e,
                                 seq_k, causal, km)
                  : interior_score(x, scale, bias[e]);
        mx[h] = fmaxf(mx[h], x);
      }
  }
  float m_use[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float corr = rescale(m[h], row_max(mx[h]), m_use[h]);
    l[h] *= corr;
    if (kDelta) dsum[h] *= corr;
  }
#pragma unroll
  for (int j = 0; j < N / 4; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float x = s[4 * j + 2 * h + e];
        const float p =
            (kEdge && x == -INFINITY) ? 0.f : p_of<false>(x, m_use[h], 1.f);
        l[h] += p;
        if (kDelta) dsum[h] += p * dp[4 * j + 2 * h + e];
      }
}

// The head dims the wgmma and fp32 bodies of every kernel are
// instantiated for: f(integral_constant<D>) for d = D, else
// cudaErrorInvalidValue. The wrapper pads any other even d up to 128 to the
// next of them; K4 and K5 in bf16 also take 192 and 256, which their
// launchers pick before they get here, as they pick the wide bodies
// (flash_wide.cuh) for every other width.
template <typename F>
cudaError_t dispatch_head_dim(int d, F&& f) {
  switch (d) {
    case 64:
      return f(std::integral_constant<int, 64>{});
    case 96:
      return f(std::integral_constant<int, 96>{});
    case 128:
      return f(std::integral_constant<int, 128>{});
    default:
      return cudaErrorInvalidValue;
  }
}

// ---- the backwards' building blocks ----------------------------------------

// Shared-memory row padding in elements. bf16: 8 keep mma.sync's row reads
// on distinct banks; fp32: 1 makes the row stride odd for the scalar reads.
template <typename T>
struct Pad {
  static constexpr int value = std::is_same<T, bf16>::value ? 8 : 1;
};

// C (16 x 8*NT) += A (16 x K) * B (8*NT x K)^T. A and B are row-major with
// the depth K contiguous (row strides lda, ldb elements); A points at this
// warp's 16 rows, B at the first of its 8*NT rows. Lane (g, t) holds
// c[j][0..1] at row g, columns 8j+2t, 8j+2t+1 and c[j][2..3] at row g+8.
// bf16: mma.sync m16n8k16, fp32 accumulate.
template <int NT, int K>
__device__ __forceinline__ void warp_mm(float (&c)[NT][4], const bf16* A,
                                        int lda, const bf16* B, int ldb) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int kc = 0; kc < K / 16; ++kc) {
    const bf16* a = A + g * lda + kc * 16 + 2 * t;
    const uint32_t af[4] = {ld_pair(a), ld_pair(a + 8 * lda), ld_pair(a + 8),
                            ld_pair(a + 8 * lda + 8)};
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const bf16* b = B + (j * 8 + g) * ldb + kc * 16 + 2 * t;
      mma_bf16(c[j], af, ld_pair(b), ld_pair(b + 8));
    }
  }
}

// fp32: the same fragment layout computed by scalar FMAs (the tensor cores
// would round fp32 to TF32).
template <int NT, int K>
__device__ __forceinline__ void warp_mm(float (&c)[NT][4], const float* A,
                                        int lda, const float* B, int ldb) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const float* a_lo = A + g * lda;
  const float* a_hi = A + (g + 8) * lda;
#pragma unroll 4
  for (int k = 0; k < K; ++k) {
    const float a0 = a_lo[k], a1 = a_hi[k];
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const float b0 = B[(j * 8 + 2 * t) * ldb + k];
      const float b1 = B[(j * 8 + 2 * t + 1) * ldb + k];
      c[j][0] = fmaf(a0, b0, c[j][0]);
      c[j][1] = fmaf(a0, b1, c[j][1]);
      c[j][2] = fmaf(a1, b0, c[j][2]);
      c[j][3] = fmaf(a1, b1, c[j][3]);
    }
  }
}

template <int NT>
__device__ __forceinline__ void zero(float (&c)[NT][4]) {
#pragma unroll
  for (int j = 0; j < NT; ++j) c[j][0] = c[j][1] = c[j][2] = c[j][3] = 0.f;
}

// Rows [row0, row0 + ROWS) of one (seq, D) slice into shared memory by a
// block of THREADS threads: rotated with the fp32 tables when cos_t is
// given (x*cos + H(x)*sin, no FMA contraction, as the reference rounds it),
// rounded to T, rows at or past seq zero. dst is [ROWS][ld]; dstT, when
// given, receives the transpose [D][ldT] as well.
template <typename T, int D, int ROWS = 64, int THREADS = 128>
__device__ __forceinline__ void load_tile(T* dst, int ld, T* dstT, int ldT,
                                          const T* src, const float* cos_t,
                                          const float* sin_t, int row0,
                                          int seq) {
  constexpr int kPairs = D / 2;
  for (int e = threadIdx.x; e < ROWS * kPairs; e += THREADS) {
    const int r = e / kPairs;
    const int c = 2 * (e % kPairs);
    const int gr = row0 + r;
    float y0 = 0.f, y1 = 0.f;
    if (gr < seq) {
      const float x0 = to_f<T>(src[(size_t)gr * D + c]);
      const float x1 = to_f<T>(src[(size_t)gr * D + c + 1]);
      if (cos_t != nullptr) {
        const float* cs = cos_t + (size_t)gr * D + c;
        const float* sn = sin_t + (size_t)gr * D + c;
        y0 = __fadd_rn(__fmul_rn(x0, cs[0]), __fmul_rn(-x1, sn[0]));
        y1 = __fadd_rn(__fmul_rn(x1, cs[1]), __fmul_rn(x0, sn[1]));
      } else {
        y0 = x0;
        y1 = x1;
      }
    }
    const T v0 = from_f<T>(y0), v1 = from_f<T>(y1);
    dst[r * ld + c] = v0;
    dst[r * ld + c + 1] = v1;
    if (dstT != nullptr) {
      dstT[c * ldT + r] = v0;
      dstT[(c + 1) * ldT + r] = v1;
    }
  }
}

// The adjoint of the rotation for one interleaved pair of a gradient row:
// (cos o g - H(sin o g)) at columns c, c+1, rounded to T.
template <typename T>
__device__ __forceinline__ void store_adjoint(T* out, const float* cos_row,
                                              const float* sin_row, int c,
                                              float g0, float g1) {
  out[c] = from_f<T>(__fadd_rn(__fmul_rn(cos_row[c], g0),
                               __fmul_rn(sin_row[c + 1], g1)));
  out[c + 1] = from_f<T>(__fsub_rn(__fmul_rn(cos_row[c + 1], g1),
                                   __fmul_rn(sin_row[c], g0)));
}

// The adjoint of the rotation for the pair at columns c, c+1 of a gradient
// row (store_adjoint), with JAX's wrap at an odd head dim
// (meant_tpu/ops/flash/kernel.py:_rotate_half_lanes): where c is d-1,
// H(sin o g)[d-1] = -(sin o g)[0], g0 being column 0's gradient of the
// same row. At an even head_dim c + 1 (odd) never equals it.
template <typename T>
__device__ __forceinline__ void store_adjoint_wrap(T* out, const float* cr,
                                                   const float* sr, int c,
                                                   float g_c, float g_c1,
                                                   int head_dim, float g0) {
  if (c + 1 == head_dim) {
    out[c] = from_f<T>(__fadd_rn(__fmul_rn(cr[c], g_c), __fmul_rn(sr[0], g0)));
    out[c + 1] = from_f<T>(
        __fsub_rn(__fmul_rn(cr[c + 1], g_c1), __fmul_rn(sr[c], g_c)));
  } else {
    store_adjoint<T>(out, cr, sr, c, g_c, g_c1);
  }
}

// Column 0 of a gradient row in the warp-level accumulator layouts (the
// NT product above, mma.sync and wgmma alike): a lane holds columns
// 8j + 2t and 8j + 2t + 1, t = lane % 4, of rows fixed by its warp and
// lane / 4, so the row's column 0 is element 0 of the first n8 block of
// the quad's lane t = 0; c0 is this lane's such element. Every lane of the
// warp must call it.
__device__ __forceinline__ float quad_column0(float c0) {
  return __shfl_sync(0xffffffffu, c0, (threadIdx.x & 31) & ~3);
}

}  // namespace meant
