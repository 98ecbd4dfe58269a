// Fused AdamW / Adam update for Hopper (sm_90a), one launch per optimizer
// step over every trainable parameter.
//
// Replaces the TPU kernel scripts/probe_fused_adamw.py:_kernel (launched by
// pallas_adamw): read p, m, v, g; write p, m, v; with the moments' bias
// corrections c1 = 1/(1-b1^t), c2 = 1/(1-b2^t) as arguments. Beyond that
// kernel (fixed lr, wd = 0) it computes the whole update of the trainer's
// optax chain (meant_tpu/train/optim.py build_optimizer):
//   g  = clip(g)          optax clip_by_global_norm: g / |g| * max_norm
//                         when |g| >= max_norm; |g| is a device scalar, so
//                         a step never waits on the host;
//   g += wd * p           coupled decay (torch Adam), before the moments;
//   m  = b1 m + (1-b1) g;  v = b2 v + (1-b2) g g;
//   u  = (m c1) / (sqrt(v c2) + eps)
//   u += wd * p           decoupled decay (AdamW);
//   p -= lr * u.
// Every scalar arrives precomputed in fp32 (1-b1 and 1-b2 too, so they
// round as the plain version's Python floats do), and every operation is
// an explicitly rounded fp32 intrinsic with no FMA contraction, so the
// kernel repeats the plain version (meant_tpu_torch/ops/adamw.py
// adamw_reference) operation for operation.
//
// The first moment is stored in fp32 or, for the trainer's --mu_bf16
// (optax's scale_by_adam(mu_dtype=bfloat16)), in bf16: a template on m's
// type. Then m is read in bf16 and widened, m' = b1 m + (1-b1) g is formed
// in fp32 (b1 arrives as the wrapper gives it: JAX multiplies the bf16
// moment by b1 rounded to bf16), the bias-corrected update uses that fp32
// m' (optax corrects the uncast moment and casts only what it stores), and
// bf16(m'), rounded to nearest even, is stored. v and p stay fp32.
//
// Bound on an H100 SXM (3.35 TB/s): 28 bytes per parameter (p, m, v, g
// read, p, m, v written, fp32) -- 4.97 GB, 1.484 ms, for the 177,607,733
// trainable parameters of flagship meant_src; 24 with a bf16 m (4.26 GB,
// 1.272 ms). Its 20-odd flops per
// parameter are far below the card's rate, so it is bound by bytes: the
// kernel streams 16-byte vectors (8-byte ones of a bf16 m) with a
// grid-stride loop and no shared
// memory, the layout A1 itself uses (flat fp32 buffers, here with the
// parameters and their gradients as views into them).
//
// C interface (loaded with ctypes): meant_adamw returns the cudaError_t of
// the launch (0 on success); it never synchronises.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

struct Hyper {
  float lr, b1, one_minus_b1, b2, one_minus_b2, eps, wd, c1, c2, max_norm;
  int coupled;
};

__device__ __forceinline__ void update(float& p, float& m, float& v, float g,
                                       const Hyper& h, float norm,
                                       bool clip) {
  if (clip) g = __fmul_rn(__fdiv_rn(g, norm), h.max_norm);
  if (h.coupled) g = __fadd_rn(g, __fmul_rn(h.wd, p));
  m = __fadd_rn(__fmul_rn(h.b1, m), __fmul_rn(h.one_minus_b1, g));
  v = __fadd_rn(__fmul_rn(h.b2, v),
                __fmul_rn(__fmul_rn(h.one_minus_b2, g), g));
  const float mhat = __fmul_rn(m, h.c1);
  const float vhat = __fmul_rn(v, h.c2);
  float u = __fdiv_rn(mhat, __fadd_rn(__fsqrt_rn(vhat), h.eps));
  if (!h.coupled) u = __fadd_rn(u, __fmul_rn(h.wd, p));
  p = __fsub_rn(p, __fmul_rn(h.lr, u));
}

// Four moments at m4 + 4i as fp32 and back: a 16-byte vector of fp32 m,
// an 8-byte one of bf16 m (stored rounded to nearest even).
__device__ __forceinline__ float4 load4(const float* m, long long i) {
  return reinterpret_cast<const float4*>(m)[i];
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* m,
                                        long long i) {
  const uint2 raw = reinterpret_cast<const uint2*>(m)[i];
  const float2 lo = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 hi = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}
__device__ __forceinline__ void store4(float* m, long long i, float4 x) {
  reinterpret_cast<float4*>(m)[i] = x;
}
__device__ __forceinline__ void store4(__nv_bfloat16* m, long long i,
                                       float4 x) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(x.x, x.y);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(x.z, x.w);
  uint2 raw;
  raw.x = *reinterpret_cast<const uint32_t*>(&lo);
  raw.y = *reinterpret_cast<const uint32_t*>(&hi);
  reinterpret_cast<uint2*>(m)[i] = raw;
}
__device__ __forceinline__ float load1(const float* m, long long i) {
  return m[i];
}
__device__ __forceinline__ float load1(const __nv_bfloat16* m, long long i) {
  return __bfloat162float(m[i]);
}
__device__ __forceinline__ void store1(float* m, long long i, float x) {
  m[i] = x;
}
__device__ __forceinline__ void store1(__nv_bfloat16* m, long long i,
                                       float x) {
  m[i] = __float2bfloat16_rn(x);
}

// M: the first moment's storage type, float or __nv_bfloat16.
template <typename M>
__global__ void __launch_bounds__(256) adamw_kernel(
    float* __restrict__ p, const float* __restrict__ g, M* __restrict__ m,
    float* __restrict__ v, long long n, Hyper h,
    const float* __restrict__ norm) {
  float gn = 1.f;
  bool clip = false;
  if (norm != nullptr) {
    gn = *norm;
    clip = !(gn < h.max_norm);  // optax: clip unless |g| < max_norm
  }
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long first = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long n4 = n / 4;
  float4* p4 = reinterpret_cast<float4*>(p);
  float4* v4 = reinterpret_cast<float4*>(v);
  const float4* g4 = reinterpret_cast<const float4*>(g);
  for (long long i = first; i < n4; i += stride) {
    float4 pp = p4[i], mm = load4(m, i), vv = v4[i];
    const float4 gg = g4[i];
    update(pp.x, mm.x, vv.x, gg.x, h, gn, clip);
    update(pp.y, mm.y, vv.y, gg.y, h, gn, clip);
    update(pp.z, mm.z, vv.z, gg.z, h, gn, clip);
    update(pp.w, mm.w, vv.w, gg.w, h, gn, clip);
    p4[i] = pp;
    store4(m, i, mm);
    v4[i] = vv;
  }
  for (long long i = 4 * n4 + first; i < n; i += stride) {
    float mm = load1(m, i);
    update(p[i], mm, v[i], g[i], h, gn, clip);
    store1(m, i, mm);
  }
}

}  // namespace

// p, g, v: n contiguous fp32 values each, m: n fp32 (mu_bf16 0) or bf16
// (mu_bf16 1) values; all 16-byte aligned. norm: the device scalar |g|
// (fp32) or null for no clipping. coupled: 1 = Adam with coupled decay,
// 0 = AdamW.
extern "C" int meant_adamw(void* p, const void* g, void* m, void* v,
                           long long n, float lr, float b1,
                           float one_minus_b1, float b2, float one_minus_b2,
                           float eps, float wd, float c1, float c2,
                           const void* norm, float max_norm, int coupled,
                           int mu_bf16, int num_sms, void* stream) {
  if (n <= 0 || num_sms <= 0) return (int)cudaErrorInvalidValue;
  const uintptr_t align = reinterpret_cast<uintptr_t>(p) |
                          reinterpret_cast<uintptr_t>(g) |
                          reinterpret_cast<uintptr_t>(m) |
                          reinterpret_cast<uintptr_t>(v);
  if (align % 16 != 0) return (int)cudaErrorMisalignedAddress;
  const Hyper h{lr, b1, one_minus_b1, b2, one_minus_b2, eps, wd, c1, c2,
                max_norm, coupled};
  constexpr int kThreads = 256;
  const long long want = (n / 4 + kThreads - 1) / kThreads;
  const int blocks = (int)(want < 8LL * num_sms ? (want > 0 ? want : 1)
                                                : 8LL * num_sms);
  const auto st = static_cast<cudaStream_t>(stream);
  if (mu_bf16)
    adamw_kernel<__nv_bfloat16><<<blocks, kThreads, 0, st>>>(
        static_cast<float*>(p), static_cast<const float*>(g),
        static_cast<__nv_bfloat16*>(m), static_cast<float*>(v), n, h,
        static_cast<const float*>(norm));
  else
    adamw_kernel<float><<<blocks, kThreads, 0, st>>>(
        static_cast<float*>(p), static_cast<const float*>(g),
        static_cast<float*>(m), static_cast<float*>(v), n, h,
        static_cast<const float*>(norm));
  return (int)cudaGetLastError();
}
