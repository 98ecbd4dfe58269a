// Helpers shared by the flash forward (flash_fwd.cu, K1) and backward
// (flash_bwd.cu, K2): dtype conversions, the bf16 tensor-core product
// mma.sync m16n8k16 and its fragment packing, and the score masking and
// online-softmax rescale both kernels apply exactly alike.
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
// + (1 - kmask) * -1e9. Columns at or past seq are -inf.
__device__ __forceinline__ float masked_score(float acc, float scale, int row,
                                              int col, int seq, int causal,
                                              const float* km) {
  if (col >= seq || (causal && col > row)) return -INFINITY;
  const float x = acc * scale;
  return km != nullptr ? x + (1.0f - km[col]) * -1e9f : x;
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

}  // namespace meant
