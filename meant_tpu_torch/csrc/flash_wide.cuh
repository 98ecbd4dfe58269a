// The flash kernels at the head dims the wgmma bodies are not built for:
// every kernel in fp32 past 128, every kernel in bf16 at the widths past
// 256 other than 384 and 768, and (in the backwards) an odd head dim
// padded to a width past 256 in bf16 or past 128 in fp32 (takes_wide
// below). One body per
// kernel, templated on the dtype (fp32 or bf16) and not on the head dim:
//   * fwd_kernel<T, true>:   K1 (flash_fwd.cu), a statistics pass, then P
//                            normalised and rounded before P V;
//   * fwd_kernel<T, false>:  K3 (flash_fwd.cu), one online pass, P rounded
//                            at the running max, out and lse;
//   * dq_kernel<T, true>:    K2's dq kernel (flash_bwd.cu), its own
//                            statistics pass (m, 1/l, delta);
//   * dq_kernel<T, false>:   K4 (flash_bwd_online.cu), P = exp(S - lse);
//   * dkdv_kernel<T, true>:  K2's dk/dv kernel, P from K2's statistics;
//   * dkdv_kernel<T, false>: K5, P = exp(S - lse).
// Each computes what its wgmma counterpart computes, in the same order of
// rounding (flash_fwd.cu, flash_bwd.cu, flash_bwd_online.cu say what).
//
// Design: split the contraction from the output. Every product that
// contracts over the head dim (S = Qr Kr^T, dP = dO V^T, and their
// transposes in the dk/dv kernel) streams the padded width dp through
// shared memory in 64-column slices, so a tile's operands never have to
// sit whole in shared memory (a 64-row Qr tile at d = 768 is 197 KB in
// fp32). Every output (o, dq, dk, dv) is cut into 64-column chunks, and a
// block holds a group of up to G of them in registers (G at most 4 in the
// forwards, 3 in the dq kernel, 2 in the dk/dv kernel: one accumulator
// each, two in dk/dv, beside S and dP), the groups balanced (d = 192: one
// group of 3 chunks; 384: two of 3; 768: three of 4). The grid is (bh,
// 64-row tile, group). Each block recomputes S (and dP) and the softmax
// statistics over the whole dp for its group. The groups are a grid axis,
// not launches: a call is one launch of each kernel at any d. Within a
// block, 4 warps of 16 rows run mma.sync m16n8k16 in bf16 and scalar FMAs
// in fp32 (warp_mm, flash_common.cuh) on tiles loaded 16 bytes a thread,
// but for the products over the head dim (S and dP), which take scalar
// FMAs in both dtypes (dp_mm): one fp32 chain over the columns in order,
// the plain versions' order (fp32 K4 reads 0 from its plain version). At
// d = 768 any other order of these sums flips the rounding of single dS
// entries, and one flip moves a dq element by some 0.025, past the
// gradients' element bar: on the tensor cores K4 at (80, 512, 768), with
// each k16 step summed from zero K2 at (80, 196, 768), and so does the
// plain version summed in fp64 against itself; the chain does not
// (tools/wide_sum_order.py; PERF.md);
// P and dS are rounded to the input dtype into shared memory, where the
// products that follow read them. The other route -- wgmma bodies
// instantiated at D = 192 and 256 -- is taken in bf16 by K1 and K3
// (flash_fwd.cu) and by K2, K4 and K5 at any head dim
// (flash_bwd_wgmma.cuh), at D = 384 and 768 by K1 and K3 (the forwards'
// body on a ring of column slices) and at 384 by K2, K4 and K5 at an even
// head dim (the backwards' sliced kernels), where tools/wide_sum_order.py
// finds their tensor-core sums within the element bars. The backwards in bf16 at 768
// (meant_src --num_heads 1: K2 on its charts, K4 + K5 on its streaming
// text tower) run the chain body (flash_bwd_chain.cuh): these chains,
// formed once per tile pair where this body forms them 14 times for K2 and
// 10 for K4 + K5 (4 dq groups, 6 dk/dv groups), and the products on
// wgmma; P, dS and K2's statistics bit for bit this body's. This body
// covers every width, simply and not fast (PERF.md has its times).
//
// The rotation's adjoint at an odd head dim d wraps as the JAX kernels'
// lane rotate-half does (meant_tpu/ops/flash/kernel.py:63-71, :378-379,
// :523, :609): H(y)[d-1] = -y[0], so column d-1 of dq and dk takes
// cos[d-1] g[d-1] + sin[0] g[0]. Column 0's gradient lives in the first
// group; a block that stores column d-1 in another group accumulates
// columns 0-7 as one more n8 block of its product, and each lane takes
// column 0 from the lane of its row group that holds it (a shuffle). The
// column pair's store is store_adjoint_wrap (flash_common.cuh), which the
// wgmma and fp32 bodies share.
//
// The wrapper (ops/flash/kernel.py) pads q, k, v, dO and the tables to dp,
// a multiple of 64, with zero columns and the identity rotation; the
// padded columns add nothing to any score and are sliced off the outputs.

#pragma once

#include "flash_common.cuh"

namespace meant {
namespace wide {

constexpr int kTile = 64;        // q rows or keys per tile
constexpr int kCols = 64;        // columns of a slice of dp, and of a chunk
constexpr int kThreads = 128;    // 4 warps, 16 rows each
constexpr int kNt = kCols / 8;   // n8 blocks of a 64-column product
static_assert(kTile == kCols, "score tiles and chunks share the slab stride");

template <typename T>
__host__ __device__ constexpr int ld() {
  return kCols + Pad<T>::value;
}

// The arguments of every wide launch. (bh, seq_q | seq_k, dp) tensors,
// contiguous: qr and kr (q and k rotated by R1), v, dout; row statistics
// (bh, seq_q) fp32 -- K2: m, 1/l, delta; K4/K5: lse, delta; tables
// (seq_q | seq_k, dp) fp32 (the adjoint's); kmask (mask_rows, seq_k) fp32 or
// null. head_dim is the caller's d (<= dp): its parity decides the wrap.
struct Args {
  const void *qr, *kr, *v, *dout;
  float *row_a, *row_b, *row_c;
  const float *qcos, *qsin, *kcos, *ksin, *kmask;
  int mask_rows, bh, seq_q, seq_k, dp, head_dim, num_heads;
  float scale;
  int causal;
  cudaStream_t stream;
};

// Rows [row0, row0 + 64) and columns [col0, col0 + W) of a (seq, dp)
// matrix into dst [64][ldd] and/or its transpose dstT [W][ldt]; rows at or
// past seq are zero. Reads 16 bytes a thread and load where src is 16-byte
// aligned (dp and col0 keep every row so), else one element.
template <typename T, int W = kCols>
__device__ __forceinline__ void load_block(T* dst, int ldd, T* dstT, int ldt,
                                           const T* src, int dp, int row0,
                                           int col0, int seq) {
  constexpr int kVec = 16 / (int)sizeof(T);  // elements of a 16-byte load
  static_assert(W % kVec == 0, "a block row is whole 16-byte vectors");
  if (reinterpret_cast<uintptr_t>(src) % 16 != 0) {
    for (int e = threadIdx.x; e < kTile * W; e += kThreads) {
      const int r = e / W, c = e % W;
      const T x = row0 + r < seq ? src[(size_t)(row0 + r) * dp + col0 + c]
                                 : from_f<T>(0.f);
      if (dst != nullptr) dst[r * ldd + c] = x;
      if (dstT != nullptr) dstT[c * ldt + r] = x;
    }
    return;
  }
  constexpr int kVecs = W / kVec;
  for (int e = threadIdx.x; e < kTile * kVecs; e += kThreads) {
    const int r = e / kVecs, c = (e % kVecs) * kVec;
    const uint4 u = row0 + r < seq
                        ? *reinterpret_cast<const uint4*>(
                              src + (size_t)(row0 + r) * dp + col0 + c)
                        : make_uint4(0u, 0u, 0u, 0u);
    const T* x = reinterpret_cast<const T*>(&u);
    if (dst != nullptr) {
      if (sizeof(T) == 2 && ldd % kVec == 0) {
        *reinterpret_cast<uint4*>(dst + r * ldd + c) = u;
      } else {
#pragma unroll
        for (int i = 0; i < kVec; ++i) dst[r * ldd + c + i] = x[i];
      }
    }
    if (dstT != nullptr) {
#pragma unroll
      for (int i = 0; i < kVec; ++i) dstT[(c + i) * ldt + r] = x[i];
    }
  }
}

// Eight bf16 at p (16-byte aligned) as fp32.
__device__ __forceinline__ void bf16x8(const bf16* p, float (&x)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
}

// c += A B^T over K columns of the head dim in warp_mm's fragment layout,
// by scalar FMAs in column order (fp32: warp_mm; bf16: read 8 columns at
// a time, 16-byte aligned, as fp32).
template <int NT, int K>
__device__ __forceinline__ void dp_mm(float (&c)[NT][4], const bf16* A,
                                      int lda, const bf16* B, int ldb) {
  static_assert(K % 8 == 0 && ld<bf16>() % 8 == 0,
                "rows and columns read as whole 16-byte vectors");
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const bf16* a_lo = A + g * lda;
  const bf16* a_hi = A + (g + 8) * lda;
#pragma unroll 2
  for (int k = 0; k < K; k += 8) {
    float a0[8], a1[8];
    bf16x8(a_lo + k, a0);
    bf16x8(a_hi + k, a1);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      float b0[8], b1[8];
      bf16x8(B + (j * 8 + 2 * t) * ldb + k, b0);
      bf16x8(B + (j * 8 + 2 * t + 1) * ldb + k, b1);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        c[j][0] = fmaf(a0[i], b0[i], c[j][0]);
        c[j][1] = fmaf(a0[i], b1[i], c[j][1]);
        c[j][2] = fmaf(a1[i], b0[i], c[j][2]);
        c[j][3] = fmaf(a1[i], b1[i], c[j][3]);
      }
    }
  }
}

template <int NT, int K>
__device__ __forceinline__ void dp_mm(float (&c)[NT][4], const float* A,
                                      int lda, const float* B, int ldb) {
  warp_mm<NT, K>(c, A, lda, B, ldb);
}

// acc (this warp's 16 rows of the 64 x 64 tile) += A B^T over all dp
// columns: rows a0.. of a and b0.. of b, streamed a 64-column slice at a
// time through sa and sb ([64][ld] each). With a second pair (c, d into
// sc, sd), acc2 += C D^T in the same walk. Ends with every thread past a
// barrier after its last read of the slices' previous contents.
template <typename T, bool kTwo>
__device__ __forceinline__ void products_over_d(
    float (&acc)[kNt][4], float (&acc2)[kNt][4], T* sa, T* sb, T* sc, T* sd,
    const T* a, int a0, int seq_a, const T* b, int b0, int seq_b,
    const T* c, const T* d, int dp) {
  constexpr int L = ld<T>();
  const int warp = threadIdx.x / 32;
  for (int col0 = 0; col0 < dp; col0 += kCols) {
    __syncthreads();  // the previous slice's reads are done
    load_block<T>(sa, L, nullptr, 0, a, dp, a0, col0, seq_a);
    load_block<T>(sb, L, nullptr, 0, b, dp, b0, col0, seq_b);
    if (kTwo) {
      load_block<T>(sc, L, nullptr, 0, c, dp, a0, col0, seq_a);
      load_block<T>(sd, L, nullptr, 0, d, dp, b0, col0, seq_b);
    }
    __syncthreads();
    dp_mm<kNt, kCols>(acc, sa + warp * 16 * L, L, sb, L);
    if (kTwo) dp_mm<kNt, kCols>(acc2, sc + warp * 16 * L, L, sd, L);
  }
}

template <int N>
__device__ __forceinline__ float (&flat(float (&x)[N][4]))[4 * N] {
  return reinterpret_cast<float(&)[4 * N]>(x);
}

// Whether the block whose chunks start at column c0 and span n chunks
// stores column d-1 of an odd head dim d without holding column 0: then it
// accumulates columns 0-7 as well.
__device__ __forceinline__ bool wraps(int head_dim, int c0, int n) {
  return (head_dim & 1) && c0 > 0 && head_dim - 1 >= c0 &&
         head_dim - 1 < c0 + n * kCols;
}

// The chunks a block holds: blockIdx.z's group of G, fewer in the last
// group when G does not divide dp / 64. Returns the first column.
template <int G>
__device__ __forceinline__ int group_chunks(int dp, int& n) {
  const int c0 = blockIdx.z * G * kCols;
  n = min(G, (dp - c0) / kCols);
  return c0;
}

// ---- the forwards: K1 (kStats) and K3 ------------------------------------

template <typename T, int G>
constexpr int fwd_smem_bytes() {
  return (int)sizeof(T) * (3 + G) * kTile * ld<T>();
}

// Grid (bh, q tiles, groups of G chunks of dp / 64); block kThreads.
template <typename T, bool kStats, int G>
__global__ void __launch_bounds__(kThreads) fwd_kernel(
    const T* __restrict__ qr, const T* __restrict__ kr,
    const T* __restrict__ v, T* __restrict__ o, float* __restrict__ lse,
    const float* __restrict__ kmask, int mask_rows, int seq_q, int seq_k,
    int dp, int num_heads, float scale, int causal) {
  constexpr int L = ld<T>();
  extern __shared__ float smem[];
  T* qs = reinterpret_cast<T*>(smem);  // [64][L] a slice of Qr
  T* ks = qs + kTile * L;              // [64][L] a slice of Kr
  T* ps = ks + kTile * L;              // [64][L] P, a slab per warp
  T* vts = ps + kTile * L;             // [G * 64][L] V's chunks, transposed
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.x, q0 = blockIdx.y * kTile;
  int nc;
  const int c0 = group_chunks<G>(dp, nc);
  const int row[2] = {q0 + warp * 16 + g, q0 + warp * 16 + g + 8};
  const T* q = qr + (size_t)bh * seq_q * dp;
  const T* k = kr + (size_t)bh * seq_k * dp;
  const T* vv = v + (size_t)bh * seq_k * dp;
  const float* km = nullptr;
  if (kmask != nullptr)
    km = kmask + (size_t)(mask_rows == 1 ? 0 : bh / num_heads) * seq_k;
  T* pw = ps + warp * 16 * L;
  const int n_k = (seq_k + kTile - 1) / kTile;
  const int n_tiles = causal ? min(n_k, (int)blockIdx.y + 1) : n_k;

  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float row_m[2] = {0.f, 0.f}, row_il[2] = {1.f, 1.f};
  float s[kNt][4], o_acc[G][kNt][4];
#pragma unroll
  for (int c = 0; c < G; ++c) zero(o_acc[c]);
  if (kStats) {  // pass 1: each row's max and denominator
    float unused[2];
    for (int tile = 0; tile < n_tiles; ++tile) {
      const int k0 = tile * kTile;
      zero(s);
      products_over_d<T, false>(s, s, qs, ks, nullptr, nullptr, q, q0, seq_q,
                                k, k0, seq_k, nullptr, nullptr, dp);
      stats_tile<true, false>(flat(s), flat(s), m, l, unused, row, k0, t,
                              seq_k, causal, km, scale);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float lt = row_sum(l[h]);
      row_m[h] = (m[h] == -INFINITY) ? 0.f : m[h];
      row_il[h] = lt > 0.f ? 1.0f / lt : 0.f;
    }
  }

  for (int tile = 0; tile < n_tiles; ++tile) {
    const int k0 = tile * kTile;
    zero(s);
    products_over_d<T, false>(s, s, qs, ks, nullptr, nullptr, q, q0, seq_q, k,
                              k0, seq_k, nullptr, nullptr, dp);
    // (the walk's barriers order the previous tile's reads of vts)
#pragma unroll
    for (int c = 0; c < G; ++c)
      if (c < nc)
        load_block<T>(nullptr, 0, vts + c * kCols * L, L, vv, dp, k0,
                      c0 + c * kCols, seq_k);
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < kNt; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = masked_score(s[j][e], scale, row[e >> 1],
                               k0 + j * 8 + 2 * t + (e & 1), seq_k, causal, km);
        mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
      }
    float m_use[2] = {row_m[0], row_m[1]};
    if (!kStats) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float corr = rescale(m[h], row_max(mx[h]), m_use[h]);
        l[h] *= corr;
#pragma unroll
        for (int c = 0; c < G; ++c)
#pragma unroll
          for (int j = 0; j < kNt; ++j) {
            o_acc[c][j][2 * h] *= corr;
            o_acc[c][j][2 * h + 1] *= corr;
          }
      }
    }
#pragma unroll
    for (int j = 0; j < kNt; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1;
        const float x = s[j][e];
        const float p = x == -INFINITY
                            ? 0.f
                            : p_of<kStats>(x, m_use[h], row_il[h]);
        if (!kStats) l[h] += p;
        pw[(g + 8 * h) * L + j * 8 + 2 * t + (e & 1)] = from_f<T>(p);
      }
    __syncthreads();  // vts in place; P written
#pragma unroll
    for (int c = 0; c < G; ++c)
      if (c < nc) warp_mm<kNt, kTile>(o_acc[c], pw, L, vts + c * kCols * L, L);
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float lt = kStats ? 1.f : row_sum(l[h]);
    if (row[h] >= seq_q) continue;
    const float inv = kStats ? 1.f : (lt > 0.f ? 1.0f / lt : 0.f);
    T* out = o + ((size_t)bh * seq_q + row[h]) * dp + c0;
#pragma unroll
    for (int c = 0; c < G; ++c)
#pragma unroll
      for (int j = 0; j < kNt; ++j) {
        if (c >= nc) continue;
        out[c * kCols + j * 8 + 2 * t] = from_f<T>(o_acc[c][j][2 * h] * inv);
        out[c * kCols + j * 8 + 2 * t + 1] =
            from_f<T>(o_acc[c][j][2 * h + 1] * inv);
      }
    if (!kStats && blockIdx.z == 0 && t == 0)
      lse[(size_t)bh * seq_q + row[h]] =
          (m[h] == -INFINITY ? 0.f : m[h]) + logf(fmaxf(lt, 1e-30f));
  }
}

// ---- the backwards: dq (K2's with kStats, K4) ------------------------------

template <typename T, int G>
constexpr int dq_smem_bytes() {
  return (int)sizeof(T) * (5 * kTile + G * kCols + 8) * ld<T>();
}

// Grid (bh, q tiles, groups of G chunks); block kThreads. kStats: row_a
// receives the planes m, 1/l and delta (from the first group's blocks);
// else row_a is lse and row_b delta.
template <typename T, bool kStats, int G>
__global__ void __launch_bounds__(kThreads) dq_kernel(Args a,
                                                      T* __restrict__ dq) {
  constexpr int L = ld<T>();
  extern __shared__ float smem[];
  T* qs = reinterpret_cast<T*>(smem);  // [64][L] a slice of Qr
  T* ks = qs + kTile * L;              // [64][L] a slice of Kr
  T* dos = ks + kTile * L;             // [64][L] a slice of dO
  T* vs = dos + kTile * L;             // [64][L] a slice of V
  T* dss = vs + kTile * L;             // [64][L] dS, a slab per warp
  T* kts = dss + kTile * L;            // [G * 64 + 8][L] Kr's chunks
                                       // transposed, then its columns 0-7
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.x, q0 = blockIdx.y * kTile;
  const int seq_q = a.seq_q, seq_k = a.seq_k, dp = a.dp;
  int nc;
  const int c0 = group_chunks<G>(dp, nc);
  const int row[2] = {q0 + warp * 16 + g, q0 + warp * 16 + g + 8};
  const T* q = static_cast<const T*>(a.qr) + (size_t)bh * seq_q * dp;
  const T* k = static_cast<const T*>(a.kr) + (size_t)bh * seq_k * dp;
  const T* v = static_cast<const T*>(a.v) + (size_t)bh * seq_k * dp;
  const T* dout = static_cast<const T*>(a.dout) + (size_t)bh * seq_q * dp;
  const float* km = nullptr;
  if (a.kmask != nullptr)
    km = a.kmask + (size_t)(a.mask_rows == 1 ? 0 : bh / a.num_heads) * seq_k;
  T* dsw = dss + warp * 16 * L;
  const bool wrap = wraps(a.head_dim, c0, nc);
  const int n_k = (seq_k + kTile - 1) / kTile;
  const int n_tiles = a.causal ? min(n_k, (int)blockIdx.y + 1) : n_k;
  float s[kNt][4], dp_acc[kNt][4];

  float m_row[2], il_row[2], delta[2];  // K4: il_row unused, m_row = lse
  if (kStats) {  // pass 1: m, l and delta, online over the key tiles
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
    float dsum[2] = {0.f, 0.f};
    for (int tile = 0; tile < n_tiles; ++tile) {
      const int k0 = tile * kTile;
      zero(s);
      zero(dp_acc);
      products_over_d<T, true>(s, dp_acc, qs, ks, dos, vs, q, q0, seq_q, k,
                               k0, seq_k, dout, v, dp);
      stats_tile<true, true>(flat(s), flat(dp_acc), m, l, dsum, row, k0, t,
                             seq_k, a.causal, km, a.scale);
    }
    const size_t plane = (size_t)gridDim.x * seq_q;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float lt = row_sum(l[h]);
      m_row[h] = (m[h] == -INFINITY) ? 0.f : m[h];
      il_row[h] = lt > 0.f ? 1.0f / lt : 0.f;
      delta[h] = row_sum(dsum[h]) * il_row[h];
      if (blockIdx.z == 0 && t == 0 && row[h] < seq_q) {
        const size_t i = (size_t)bh * seq_q + row[h];
        a.row_a[i] = m_row[h];
        a.row_a[plane + i] = il_row[h];
        a.row_a[2 * plane + i] = delta[h];
      }
    }
  } else {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const bool valid = row[h] < seq_q;
      const size_t i = (size_t)bh * seq_q + row[h];
      m_row[h] = valid ? a.row_a[i] : 0.f;
      il_row[h] = 1.f;
      delta[h] = valid ? a.row_b[i] : 0.f;
    }
  }

  // pass 2: dS and dQr = dS Kr over this block's chunks
  float acc[G][kNt][4], acc0[1][4];
#pragma unroll
  for (int c = 0; c < G; ++c) zero(acc[c]);
  zero(acc0);
  for (int tile = 0; tile < n_tiles; ++tile) {
    const int k0 = tile * kTile;
    zero(s);
    zero(dp_acc);
    products_over_d<T, true>(s, dp_acc, qs, ks, dos, vs, q, q0, seq_q, k, k0,
                             seq_k, dout, v, dp);
#pragma unroll
    for (int c = 0; c < G; ++c)
      if (c < nc)
        load_block<T>(nullptr, 0, kts + c * kCols * L, L, k, dp, k0,
                      c0 + c * kCols, seq_k);
    if (wrap) load_block<T, 8>(nullptr, 0, kts + G * kCols * L, L, k, dp, k0,
                               0, seq_k);
#pragma unroll
    for (int j = 0; j < kNt; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1;
        const int col = j * 8 + 2 * t + (e & 1);
        const float sc = masked_score(s[j][e], a.scale, row[h], k0 + col,
                                      seq_k, a.causal, km);
        const float p = (sc == -INFINITY)
                            ? 0.f
                            : (kStats ? expf(sc - m_row[h]) * il_row[h]
                                      : expf(sc - m_row[h]));
        dsw[(g + 8 * h) * L + col] =
            from_f<T>(p * (dp_acc[j][e] - delta[h]) * a.scale);
      }
    __syncthreads();  // kts in place; dS written
#pragma unroll
    for (int c = 0; c < G; ++c)
      if (c < nc) warp_mm<kNt, kTile>(acc[c], dsw, L, kts + c * kCols * L, L);
    if (wrap) warp_mm<1, kTile>(acc0, dsw, L, kts + G * kCols * L, L);
  }

  float g0[2];  // column 0's dQr of rows g and g + 8, for the wrap
#pragma unroll
  for (int h = 0; h < 2; ++h)
    g0[h] = __shfl_sync(0xffffffffu,
                        c0 == 0 ? acc[0][0][2 * h] : acc0[0][2 * h],
                        lane & ~3);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (row[h] >= seq_q) continue;
    T* out = dq + ((size_t)bh * seq_q + row[h]) * dp;
    const float* cr = a.qcos + (size_t)row[h] * dp;
    const float* sr = a.qsin + (size_t)row[h] * dp;
#pragma unroll
    for (int c = 0; c < G; ++c)
#pragma unroll
      for (int j = 0; j < kNt; ++j)
        if (c < nc)
          store_adjoint_wrap<T>(out, cr, sr, c0 + c * kCols + j * 8 + 2 * t,
                                acc[c][j][2 * h], acc[c][j][2 * h + 1],
                                a.head_dim, g0[h]);
  }
}

// ---- the backwards: dk and dv (K2's with kStats, K5) -----------------------

template <typename T, int G>
constexpr int dkdv_smem_bytes() {
  return (int)sizeof(T) * (6 * kTile + 2 * G * kCols + 8) * ld<T>();
}

// Grid (bh, k tiles, groups of G chunks); block kThreads. kStats: row_a
// holds the rows' m, 1/l and delta planes (K2's dq kernel wrote them);
// else row_a is lse and row_b delta.
template <typename T, bool kStats, int G>
__global__ void __launch_bounds__(kThreads) dkdv_kernel(Args a,
                                                        T* __restrict__ dk,
                                                        T* __restrict__ dv) {
  constexpr int L = ld<T>();
  extern __shared__ float smem[];
  T* ks = reinterpret_cast<T*>(smem);  // [64][L] a slice of Kr
  T* qs = ks + kTile * L;              // [64][L] a slice of Qr
  T* vs = qs + kTile * L;              // [64][L] a slice of V
  T* dos = vs + kTile * L;             // [64][L] a slice of dO
  T* ps = dos + kTile * L;             // [64][L] T(P^T), a slab per warp
  T* dss = ps + kTile * L;             // [64][L] dS^T, a slab per warp
  T* dots = dss + kTile * L;           // [G * 64][L] dO's chunks, transposed
  T* qts = dots + G * kCols * L;       // [G * 64 + 8][L] Qr's chunks
                                       // transposed, then its columns 0-7
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.x, k0 = blockIdx.y * kTile;
  const int seq_q = a.seq_q, seq_k = a.seq_k, dp = a.dp;
  int nc;
  const int c0 = group_chunks<G>(dp, nc);
  const int key[2] = {k0 + warp * 16 + g, k0 + warp * 16 + g + 8};
  const T* q = static_cast<const T*>(a.qr) + (size_t)bh * seq_q * dp;
  const T* k = static_cast<const T*>(a.kr) + (size_t)bh * seq_k * dp;
  const T* v = static_cast<const T*>(a.v) + (size_t)bh * seq_k * dp;
  const T* dout = static_cast<const T*>(a.dout) + (size_t)bh * seq_q * dp;
  const float* km = nullptr;
  if (a.kmask != nullptr)
    km = a.kmask + (size_t)(a.mask_rows == 1 ? 0 : bh / a.num_heads) * seq_k;
  const size_t plane = (size_t)gridDim.x * seq_q;
  T* pw = ps + warp * 16 * L;
  T* dsw = dss + warp * 16 * L;
  const bool wrap = wraps(a.head_dim, c0, nc);
  float s[kNt][4], dp_acc[kNt][4];
  float dv_acc[G][kNt][4], dk_acc[G][kNt][4], dk0[1][4];
#pragma unroll
  for (int c = 0; c < G; ++c) {
    zero(dv_acc[c]);
    zero(dk_acc[c]);
  }
  zero(dk0);
  const int n_q = (seq_q + kTile - 1) / kTile;
  for (int qt = a.causal ? (int)blockIdx.y : 0; qt < n_q; ++qt) {
    const int q0 = qt * kTile;
    zero(s);
    zero(dp_acc);
    // S^T = Kr Qr^T and dP^T = V dO^T: rows keys, columns q
    products_over_d<T, true>(s, dp_acc, ks, qs, vs, dos, k, k0, seq_k, q, q0,
                             seq_q, v, dout, dp);
#pragma unroll
    for (int c = 0; c < G; ++c)
      if (c < nc) {
        load_block<T>(nullptr, 0, qts + c * kCols * L, L, q, dp, q0,
                      c0 + c * kCols, seq_q);
        load_block<T>(nullptr, 0, dots + c * kCols * L, L, dout, dp, q0,
                      c0 + c * kCols, seq_q);
      }
    if (wrap) load_block<T, 8>(nullptr, 0, qts + G * kCols * L, L, q, dp, q0,
                               0, seq_q);
#pragma unroll
    for (int j = 0; j < kNt; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1;
        const int qi = j * 8 + 2 * t + (e & 1);
        const bool valid = q0 + qi < seq_q;
        const size_t r = (size_t)bh * seq_q + q0 + qi;
        float p;
        const float sc = masked_score(s[j][e], a.scale, q0 + qi, key[h], seq_k,
                                      a.causal, km);
        float st_dl;
        if (kStats) {
          const float st_m = valid ? a.row_a[r] : 0.f;
          const float st_il = valid ? a.row_a[plane + r] : 0.f;
          st_dl = valid ? a.row_a[2 * plane + r] : 0.f;
          p = (sc == -INFINITY) ? 0.f : expf(sc - st_m) * st_il;
        } else {
          const float st_lse = valid ? a.row_a[r] : 0.f;
          st_dl = valid ? a.row_b[r] : 0.f;
          p = (sc == -INFINITY || !valid) ? 0.f : expf(sc - st_lse);
        }
        pw[(g + 8 * h) * L + qi] = from_f<T>(p);
        dsw[(g + 8 * h) * L + qi] =
            from_f<T>(p * (dp_acc[j][e] - st_dl) * a.scale);
      }
    __syncthreads();  // qts and dots in place; P^T and dS^T written
#pragma unroll
    for (int c = 0; c < G; ++c)
      if (c < nc) {
        warp_mm<kNt, kTile>(dv_acc[c], pw, L, dots + c * kCols * L, L);
        warp_mm<kNt, kTile>(dk_acc[c], dsw, L, qts + c * kCols * L, L);
      }
    if (wrap) warp_mm<1, kTile>(dk0, dsw, L, qts + G * kCols * L, L);
  }

  float g0[2];  // column 0's dKr of keys g and g + 8, for the wrap
#pragma unroll
  for (int h = 0; h < 2; ++h)
    g0[h] = __shfl_sync(0xffffffffu,
                        c0 == 0 ? dk_acc[0][0][2 * h] : dk0[0][2 * h],
                        lane & ~3);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (key[h] >= seq_k) continue;
    T* dv_row = dv + ((size_t)bh * seq_k + key[h]) * dp;
    T* dk_row = dk + ((size_t)bh * seq_k + key[h]) * dp;
    const float* cr = a.kcos + (size_t)key[h] * dp;
    const float* sr = a.ksin + (size_t)key[h] * dp;
#pragma unroll
    for (int c = 0; c < G; ++c)
#pragma unroll
      for (int j = 0; j < kNt; ++j) {
        if (c >= nc) continue;
        const int col = c0 + c * kCols + j * 8 + 2 * t;
        dv_row[col] = from_f<T>(dv_acc[c][j][2 * h]);
        dv_row[col + 1] = from_f<T>(dv_acc[c][j][2 * h + 1]);
        store_adjoint_wrap<T>(dk_row, cr, sr, col, dk_acc[c][j][2 * h],
                              dk_acc[c][j][2 * h + 1], a.head_dim, g0[h]);
      }
  }
}

// ---- launch --------------------------------------------------------------

// The most chunks a block of each body holds in registers: one score tile
// beside G (forward), G and dP (dq) or 2 G (dk/dv) 64-column accumulators.
constexpr int kFwdGroup = 4;
constexpr int kDqGroup = 3;
constexpr int kDkdvGroup = 2;

inline bool invalid(const Args& a) {
  return a.bh <= 0 || a.seq_q <= 0 || a.seq_k <= 0 || a.dp <= 0 ||
         a.dp % kCols != 0 || a.head_dim <= 0 || a.head_dim > a.dp ||
         (a.seq_q + kTile - 1) / kTile > 65535 ||
         (a.seq_k + kTile - 1) / kTile > 65535;
}

template <typename K>
cudaError_t set_smem(K kernel, int bytes) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

// f(integral_constant<G>) for the group size of a call at dp, at most
// kMax chunks a block: the fewest groups, balanced (dp = 384: two groups
// of 3 chunks; dp = 768: three of 4). Sets `groups`.
template <int kMax, typename F>
cudaError_t dispatch_group(int dp, int& groups, F&& f) {
  const int n = dp / kCols;
  groups = (n + kMax - 1) / kMax;
  switch ((n + groups - 1) / groups) {
    case 1:
      return f(std::integral_constant<int, 1>{});
    case 2:
      if constexpr (kMax >= 2) return f(std::integral_constant<int, 2>{});
      break;
    case 3:
      if constexpr (kMax >= 3) return f(std::integral_constant<int, 3>{});
      break;
    case 4:
      if constexpr (kMax >= 4) return f(std::integral_constant<int, 4>{});
      break;
  }
  return cudaErrorInvalidValue;
}

// K1 (kStats) or K3: o (bh, seq_q, dp); lse (bh, seq_q) fp32 for K3.
template <typename T, bool kStats>
cudaError_t launch_fwd(const Args& a, void* o, float* lse) {
  if (invalid(a)) return cudaErrorInvalidValue;
  int groups;
  return dispatch_group<kFwdGroup>(a.dp, groups, [&](auto group) {
    constexpr int G = decltype(group)::value;
    constexpr int bytes = fwd_smem_bytes<T, G>();
    const auto kernel = fwd_kernel<T, kStats, G>;
    cudaError_t err = set_smem(kernel, bytes);
    if (err != cudaSuccess) return err;
    const dim3 grid(a.bh, (a.seq_q + kTile - 1) / kTile, groups);
    kernel<<<grid, kThreads, bytes, a.stream>>>(
        static_cast<const T*>(a.qr), static_cast<const T*>(a.kr),
        static_cast<const T*>(a.v), static_cast<T*>(o), lse, a.kmask,
        a.mask_rows, a.seq_q, a.seq_k, a.dp, a.num_heads, a.scale, a.causal);
    return cudaGetLastError();
  });
}

template <typename T, bool kStats>
cudaError_t launch_dq(const Args& a, void* dq) {
  if (invalid(a)) return cudaErrorInvalidValue;
  int groups;
  return dispatch_group<kDqGroup>(a.dp, groups, [&](auto group) {
    constexpr int G = decltype(group)::value;
    constexpr int bytes = dq_smem_bytes<T, G>();
    const auto kernel = dq_kernel<T, kStats, G>;
    cudaError_t err = set_smem(kernel, bytes);
    if (err != cudaSuccess) return err;
    const dim3 grid(a.bh, (a.seq_q + kTile - 1) / kTile, groups);
    kernel<<<grid, kThreads, bytes, a.stream>>>(a, static_cast<T*>(dq));
    return cudaGetLastError();
  });
}

template <typename T, bool kStats>
cudaError_t launch_dkdv(const Args& a, void* dk, void* dv) {
  if (invalid(a)) return cudaErrorInvalidValue;
  int groups;
  return dispatch_group<kDkdvGroup>(a.dp, groups, [&](auto group) {
    constexpr int G = decltype(group)::value;
    constexpr int bytes = dkdv_smem_bytes<T, G>();
    const auto kernel = dkdv_kernel<T, kStats, G>;
    cudaError_t err = set_smem(kernel, bytes);
    if (err != cudaSuccess) return err;
    const dim3 grid(a.bh, (a.seq_k + kTile - 1) / kTile, groups);
    kernel<<<grid, kThreads, bytes, a.stream>>>(a, static_cast<T*>(dk),
                                                static_cast<T*>(dv));
    return cudaGetLastError();
  });
}

// The kernels, as the launchers name them to takes_wide.
enum Kernel { kK1 = 1, kK2, kK3, kK4, kK5 };

// Whether a launch of `kernel` in `dtype` (0 fp32, 1 bf16) at padded width
// dp and head dim head_dim takes these bodies: every kernel at a dp the
// wgmma and fp32 bodies are not built for, and the backwards at an odd head
// dim where a block of those bodies would not hold all of a gradient row's
// columns, which the adjoint's wrap joins (column d-1 takes column 0's
// term). The built widths are 64, 96 and 128 in both dtypes, where every
// body holds a row's columns in one warpgroup and wraps through a
// shuffle (flash_common.cuh: store_adjoint_wrap, quad_column0); in bf16
// also 192 and 256 for every kernel (the forwards' body in flash_fwd.cu,
// the backwards' in flash_bwd_wgmma.cuh, whose two consumer warpgroups
// pass column 0 through shared memory: wrap_column0), and 384 and 768 for
// every kernel at an even d: the forwards K1 and K3 on the forwards'
// sliced ring (an odd d padded there too, since the forwards have no
// adjoint); the backwards K2 (replacing
// meant_tpu/ops/flash/kernel.py:_bwd_kernel), K4 (_bwd_dq_kernel) and K5
// (_bwd_dkdv_kernel) at 384 on the backwards' sliced kernels
// (flash_bwd_wgmma.cuh; bound by operations at src4096's (20, 4096, 384):
// K4 0.39 ms, K5 0.52 ms), at 768 on the chain body of flash_bwd_chain.cuh
// (takes_chain: S and dP on fp32 FMA chains in column order, these bodies'
// bits; beside the bytes bound, the chains' floor at the fp32 peak:
// PERF.md). These bodies keep fp32 past 128, every other width past 256
// (320, 448, ..., 704), and the backwards at an odd d padded to 384 (the
// sliced dk/dv kernel's column groups are on the grid) or 768 (the chain
// body's epilogue holds no wrap).
inline bool takes_wide(Kernel kernel, int dtype, int dp, int head_dim) {
  const bool backward = kernel == kK2 || kernel == kK4 || kernel == kK5;
  if (dp == 64 || dp == 96 || dp == 128) return false;
  if (dtype != 1) return true;
  if (dp == 192 || dp == 256) return false;
  if (backward && (head_dim & 1)) return true;
  if (dp == 384 || dp == 768) return false;
  return true;
}

// Whether a launch that takes_wide leaves to the other bodies runs the
// chain body (flash_bwd_chain.cuh): the backwards K2, K4 and K5 in bf16 at
// dp = 768.
inline bool takes_chain(Kernel kernel, int dtype, int dp, int head_dim) {
  const bool backward = kernel == kK2 || kernel == kK4 || kernel == kK5;
  return backward && dtype == 1 && dp == 768 &&
         !takes_wide(kernel, dtype, dp, head_dim);
}

}  // namespace wide
}  // namespace meant

// The body a launch runs, for the launchers in Python, which name it: 1
// these wide bodies, 2 the backwards' chain body, 0 the library's own
// wgmma or fp32 body (each library that includes this header exports its
// own copy).
extern "C" int meant_flash_body(int kernel, int dtype, int dp,
                                int head_dim) {
  using namespace meant::wide;
  const auto k = static_cast<Kernel>(kernel);
  if (takes_wide(k, dtype, dp, head_dim)) return 1;
  return takes_chain(k, dtype, dp, head_dim) ? 2 : 0;
}
