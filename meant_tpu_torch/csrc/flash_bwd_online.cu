// Streaming rotary-fused flash-attention backward for Hopper (sm_90a):
// dQ (K4), dK/dV (K5), and the rotation pass that feeds them.
//
// Replaces the TPU kernels meant_tpu/ops/flash/kernel.py:_bwd_dq_kernel
// (K4) and _bwd_dkdv_kernel (K5), launched by _flash_bwd_online through the
// joint (out, lse) custom VJP of _make_flash. Given the forward's per-row
// log-sum-exp lse (K3, flash_fwd.cu) and delta = rowsum(dO o O) - g_lse
// (computed outside the kernels, as JAX computes it in XLA), for each
// (batch*head):
//   Qr  = T(rot(q)),  Kr = T(rot(k))              (the rotation pass)
//   P   = exp(mask(scale * Qr Kr^T) - lse)        (fp32; 0 where -inf)
//   dV  = T(P)^T dO                               (fp32 sums)
//   dS  = T(P o (dO V^T - delta) * scale)
//   dQ  = rot^T(dS Kr),  dK = rot^T(dS^T Qr)
// with rot(x) = cos o x + sin o H(x) in fp32 (the tables), rot^T(g) =
// cos o g - H(sin o g), H the interleaved rotate_half and T the rounding to
// the input dtype. P comes from lse exactly as the reference takes it. On a
// batch row whose keys are all masked every score rounds to -1e9 and so
// does lse, so P is 1 for every key there, where the resident backward (K2)
// has 1/s: the reference's result, kept (ROADMAP §5).
//
// Design. Every output element has one writer, no atomics: the result is
// deterministic.
//   * rotate_qk_kernel, the rotation pass, writes Qr and Kr once per
//     backward call with load_tile's arithmetic (no FMA contraction), the
//     bits the TPU kernels' in-kernel rotation gives. Those rotate every
//     tile they load: each k tile once per q tile in K4, each q tile once
//     per k tile in K5 (80 x 2,080 tile rotations each at src4096, for
//     80 x 64 distinct tiles).
//   * K4, one block per (bh, 64-row q tile), walks the Kr/V tiles up to
//     the diagonal, forms dS and accumulates dQr in fp32 registers; the
//     adjoint is applied once at the end.
//   * K5, one block per (bh, 64-row k tile), walks the Qr/dO tiles from
//     the diagonal, recomputes S^T = Kr Qr^T and dP^T = V dO^T, and
//     accumulates dV and dKr in fp32 registers.
// bf16, the main path: a block is one consumer warpgroup and one producer
// warp. The producer brings the block's own two tiles, then the streamed
// ones, through TMA (3-D tensor maps over (bh, s, 96), 64-byte swizzle,
// zero past s) into a ring of kStages stages, each with a full and an
// empty mbarrier; K5's producer also stages the streamed rows' lse and
// delta, read one tile ahead. The consumers run wgmma (hopper.cuh): S and
// dP with both operands K-major in shared memory (m64n64k16); then dQr +=
// dS Kr, dV += T(P^T) dO and dKr += dS^T Qr with A in registers -- the
// score accumulator rounded to bf16 in place is the A fragment, exactly
// where the reference rounds P and dS -- and B the streamed row-major tile
// read MN-major through the transpose bit (m64n96k16). Nothing is
// transposed or rotated in K4 or K5. Between the products the consumers
// issue more instructions than the tensor cores need cycles, so only the
// diagonal and ragged tiles mask element by element; every other tile
// takes the key mask as a per-column bias (the same arithmetic, rounded
// operation by operation as the reference rounds it). The grid is (tile,
// bh): a head's blocks run together and share its streamed tiles in L2,
// those with the most tiles to walk first. The tensor maps come from
// cuTensorMapEncodeTiled, reached through cudaGetDriverEntryPoint: the
// library links nothing but the runtime (a tensor map zero-fills rows past
// s, where cp.async would need the fill and the swizzle written by hand).
// fp32, the tight on-card check: scalar bodies (the warp-level NT product
// of flash_common.cuh on synchronous loads with transposed copies), fed
// the same Qr and Kr.
// Rows and keys past s get P = 0 and are never written. Only head dim 96
// is instantiated.
//
// Bound on an H100 SXM (989 TFLOP/s bf16 dense, 3.35 TB/s) at the main
// path's shapes (text tower of src4096: BH = 80, s = 4096, d = 96, bf16,
// causal): K4 runs three products over the causal triangle (S, dP, dS Kr),
// 386.5 GFLOP, 0.39 ms; K5 four (S, dP, P^T dO, dS^T Qr), 515.4 GFLOP,
// 0.52 ms; both are bound by operations (each moves some 0.3 GB, 0.1 ms).
// The rotation pass is bound by bytes: q and k read, Qr and Kr written,
// the four tables read, 258 MB, 0.077 ms.
//
// C interface (loaded with ctypes): meant_rotate_qk, meant_flash_bwd_dq and
// meant_flash_bwd_dkdv return the cudaError_t of the launch (0 on
// success); they never synchronise.

#include <cudaTypedefs.h>

#include "flash_common.cuh"
#include "hopper.cuh"

namespace {

using namespace meant;

constexpr int kTile = 64;      // q rows (K4) or keys (K5)
constexpr int kThreads = 128;  // fp32 bodies: 4 warps, 16 rows each
static_assert(kTile == 64 && kThreads == 128, "load_tile's default tile");
constexpr int kHeadDim = 96;   // the only head dim instantiated

// ---- the rotation pass ----------------------------------------------------

template <typename T>
struct alignas(16) Pack8 {
  T v[8];
};

// Qr = T(rot(q)) and Kr = T(rot(k)), eight elements a thread: n_vec
// vectors per tensor, table_vec per (s, 96) table.
template <typename T>
__global__ void __launch_bounds__(256) rotate_qk_kernel(
    const T* __restrict__ q, const T* __restrict__ k, T* __restrict__ qr,
    T* __restrict__ kr, const float* __restrict__ qcos,
    const float* __restrict__ qsin, const float* __restrict__ kcos,
    const float* __restrict__ ksin, long long n_vec, int table_vec) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= 2 * n_vec) return;
  const bool is_k = i >= n_vec;
  const long long e = is_k ? i - n_vec : i;
  const int tv = (int)(e % table_vec);
  const Pack8<T> x = reinterpret_cast<const Pack8<T>*>(is_k ? k : q)[e];
  const Pack8<float> cs =
      reinterpret_cast<const Pack8<float>*>(is_k ? kcos : qcos)[tv];
  const Pack8<float> sn =
      reinterpret_cast<const Pack8<float>*>(is_k ? ksin : qsin)[tv];
  Pack8<T> y;
#pragma unroll
  for (int c = 0; c < 8; c += 2) {
    const float x0 = to_f<T>(x.v[c]), x1 = to_f<T>(x.v[c + 1]);
    y.v[c] = from_f<T>(
        __fadd_rn(__fmul_rn(x0, cs.v[c]), __fmul_rn(-x1, sn.v[c])));
    y.v[c + 1] = from_f<T>(
        __fadd_rn(__fmul_rn(x1, cs.v[c + 1]), __fmul_rn(x0, sn.v[c + 1])));
  }
  reinterpret_cast<Pack8<T>*>(is_k ? kr : qr)[e] = y;
}

// ---- fp32: the scalar bodies ----------------------------------------------

template <typename T, int D>
constexpr int dq_smem_bytes() {
  return (int)sizeof(T) * (4 * kTile * (D + Pad<T>::value) +
                           D * (kTile + Pad<T>::value) +
                           kTile * (kTile + Pad<T>::value));
}

template <typename T, int D>
constexpr int dkdv_smem_bytes() {
  return (int)sizeof(T) * (4 * kTile * (D + Pad<T>::value) +
                           2 * D * (kTile + Pad<T>::value) +
                           2 * kTile * (kTile + Pad<T>::value)) +
         2 * kTile * (int)sizeof(float);
}

// K4: dQ.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_online_dq_kernel(
    const T* __restrict__ qr, const T* __restrict__ kr, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, T* __restrict__ dq,
    const float* __restrict__ qcos, const float* __restrict__ qsin,
    const float* __restrict__ kmask, int mask_rows, int seq, int num_heads,
    float scale, int causal) {
  constexpr int ld = D + Pad<T>::value;       // [row][d] tiles
  constexpr int ldk = kTile + Pad<T>::value;  // [.][key] tiles
  constexpr int kNk = kTile / 8;              // n-tiles over keys
  constexpr int kNd = D / 8;                  // n-tiles over d
  extern __shared__ float smem[];
  T* qs = reinterpret_cast<T*>(smem);  // [kTile][ld] rotated q
  T* dos = qs + kTile * ld;            // [kTile][ld] dO
  T* ks = dos + kTile * ld;            // [kTile][ld] rotated k
  T* vs = ks + kTile * ld;             // [kTile][ld] v
  T* kts = vs + kTile * ld;            // [D][ldk] rotated k, transposed
  T* dss = kts + D * ldk;              // [kTile][ldk] dS, a slab per warp

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.x, q0 = blockIdx.y * kTile;
  const int row[2] = {q0 + warp * 16 + g, q0 + warp * 16 + g + 8};
  const size_t base = (size_t)bh * seq * D;
  const float* km = nullptr;
  if (kmask != nullptr)
    km = kmask + (size_t)(mask_rows == 1 ? 0 : bh / num_heads) * seq;
  const T* qw = qs + warp * 16 * ld;
  const T* dow = dos + warp * 16 * ld;
  T* dsw = dss + warp * 16 * ldk;

  load_tile<T, D>(qs, ld, nullptr, 0, qr + base, nullptr, nullptr, q0, seq);
  load_tile<T, D>(dos, ld, nullptr, 0, dout + base, nullptr, nullptr, q0,
                  seq);
  float row_lse[2], row_delta[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const bool valid = row[h] < seq;
    const size_t i = (size_t)bh * seq + row[h];
    row_lse[h] = valid ? lse[i] : 0.f;
    row_delta[h] = valid ? delta[i] : 0.f;
  }
  const int n_k = (seq + kTile - 1) / kTile;
  const int n_tiles = causal ? min(n_k, (int)blockIdx.y + 1) : n_k;

  float acc[kNd][4];
  zero(acc);
  for (int tile = 0; tile < n_tiles; ++tile) {
    const int k0 = tile * kTile;
    __syncthreads();  // the previous tile's reads are done
    load_tile<T, D>(ks, ld, kts, ldk, kr + base, nullptr, nullptr, k0, seq);
    load_tile<T, D>(vs, ld, nullptr, 0, v + base, nullptr, nullptr, k0, seq);
    __syncthreads();
    float s[kNk][4], dp[kNk][4];
    zero(s);
    zero(dp);
    warp_mm<kNk, D>(s, qw, ld, ks, ld);
    warp_mm<kNk, D>(dp, dow, ld, vs, ld);
#pragma unroll
    for (int j = 0; j < kNk; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1;
        const int col = j * 8 + 2 * t + (e & 1);
        const float sc = masked_score(s[j][e], scale, row[h], k0 + col, seq,
                                      causal, km);
        const float p = (sc == -INFINITY) ? 0.f : expf(sc - row_lse[h]);
        dsw[(g + 8 * h) * ldk + col] =
            from_f<T>(p * (dp[j][e] - row_delta[h]) * scale);
      }
    __syncwarp();
    warp_mm<kNd, kTile>(acc, dsw, ldk, kts, ldk);
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (row[h] >= seq) continue;
    T* out = dq + base + (size_t)row[h] * D;
    const float* cr = qcos + (size_t)row[h] * D;
    const float* sr = qsin + (size_t)row[h] * D;
#pragma unroll
    for (int j = 0; j < kNd; ++j)
      store_adjoint<T>(out, cr, sr, j * 8 + 2 * t, acc[j][2 * h],
                       acc[j][2 * h + 1]);
  }
}

// K5: dK and dV.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_online_dkdv_kernel(
    const T* __restrict__ qr, const T* __restrict__ kr, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv,
    const float* __restrict__ kcos, const float* __restrict__ ksin,
    const float* __restrict__ kmask, int mask_rows, int seq, int num_heads,
    float scale, int causal) {
  constexpr int ld = D + Pad<T>::value;
  constexpr int ldk = kTile + Pad<T>::value;
  constexpr int kNq = kTile / 8;  // n-tiles over q rows
  constexpr int kNd = D / 8;
  extern __shared__ float smem[];
  T* ks = reinterpret_cast<T*>(smem);  // [kTile][ld] rotated k
  T* vs = ks + kTile * ld;             // [kTile][ld] v
  T* qs = vs + kTile * ld;             // [kTile][ld] rotated q
  T* dos = qs + kTile * ld;            // [kTile][ld] dO
  T* qts = dos + kTile * ld;           // [D][ldk] rotated q, transposed
  T* dots = qts + D * ldk;             // [D][ldk] dO, transposed
  T* ps = dots + D * ldk;              // [kTile][ldk] P^T, a slab per warp
  T* dss = ps + kTile * ldk;           // [kTile][ldk] dS^T, a slab per warp
  float* st_lse = reinterpret_cast<float*>(dss + kTile * ldk);  // [kTile]
  float* st_dl = st_lse + kTile;                                 // [kTile]

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.x, k0 = blockIdx.y * kTile;
  const int key[2] = {k0 + warp * 16 + g, k0 + warp * 16 + g + 8};
  const size_t base = (size_t)bh * seq * D;
  const float* km = nullptr;
  if (kmask != nullptr)
    km = kmask + (size_t)(mask_rows == 1 ? 0 : bh / num_heads) * seq;
  const T* kw = ks + warp * 16 * ld;
  const T* vw = vs + warp * 16 * ld;
  T* pw = ps + warp * 16 * ldk;
  T* dsw = dss + warp * 16 * ldk;

  load_tile<T, D>(ks, ld, nullptr, 0, kr + base, nullptr, nullptr, k0, seq);
  load_tile<T, D>(vs, ld, nullptr, 0, v + base, nullptr, nullptr, k0, seq);

  float dv_acc[kNd][4], dk_acc[kNd][4];
  zero(dv_acc);
  zero(dk_acc);
  const int n_q = (seq + kTile - 1) / kTile;
  for (int qt = causal ? (int)blockIdx.y : 0; qt < n_q; ++qt) {
    const int q0 = qt * kTile;
    __syncthreads();  // the previous tile's reads are done
    load_tile<T, D>(qs, ld, qts, ldk, qr + base, nullptr, nullptr, q0, seq);
    load_tile<T, D>(dos, ld, dots, ldk, dout + base, nullptr, nullptr, q0,
                    seq);
    for (int i = threadIdx.x; i < kTile; i += kThreads) {
      const bool valid = q0 + i < seq;
      const size_t r = (size_t)bh * seq + q0 + i;
      st_lse[i] = valid ? lse[r] : 0.f;
      st_dl[i] = valid ? delta[r] : 0.f;
    }
    __syncthreads();
    float s[kNq][4], dp[kNq][4];
    zero(s);
    zero(dp);
    warp_mm<kNq, D>(s, kw, ld, qs, ld);    // S^T: rows keys, columns q
    warp_mm<kNq, D>(dp, vw, ld, dos, ld);  // dP^T
#pragma unroll
    for (int j = 0; j < kNq; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1;
        const int qi = j * 8 + 2 * t + (e & 1);
        const float sc = masked_score(s[j][e], scale, q0 + qi, key[h], seq,
                                      causal, km);
        const float p = (sc == -INFINITY || q0 + qi >= seq)
                            ? 0.f
                            : expf(sc - st_lse[qi]);
        pw[(g + 8 * h) * ldk + qi] = from_f<T>(p);
        dsw[(g + 8 * h) * ldk + qi] =
            from_f<T>(p * (dp[j][e] - st_dl[qi]) * scale);
      }
    __syncwarp();
    warp_mm<kNd, kTile>(dv_acc, pw, ldk, dots, ldk);
    warp_mm<kNd, kTile>(dk_acc, dsw, ldk, qts, ldk);
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (key[h] >= seq) continue;
    T* dv_row = dv + base + (size_t)key[h] * D;
    T* dk_row = dk + base + (size_t)key[h] * D;
    const float* cr = kcos + (size_t)key[h] * D;
    const float* sr = ksin + (size_t)key[h] * D;
#pragma unroll
    for (int j = 0; j < kNd; ++j) {
      const int c = j * 8 + 2 * t;
      dv_row[c] = from_f<T>(dv_acc[j][2 * h]);
      dv_row[c + 1] = from_f<T>(dv_acc[j][2 * h + 1]);
      store_adjoint<T>(dk_row, cr, sr, c, dk_acc[j][2 * h],
                       dk_acc[j][2 * h + 1]);
    }
  }
}

// ---- bf16: TMA, mbarriers and wgmma ---------------------------------------

constexpr int kStages = 3;                         // ring of streamed tiles
constexpr int kTileBytes = 3 * hopper::kBoxBytes;  // one [64][96] bf16 tile
constexpr int kConsumers = 128;                    // one warpgroup
constexpr int kBlock = kConsumers + 32;            // and the producer warp
constexpr int kNs = kTile / 8;                     // n8 blocks of a score
constexpr int kNd = kHeadDim / 8;                  // n8 blocks of a gradient
static_assert(kHeadDim == 3 * hopper::kBoxCols && kTile == hopper::kRows,
              "a tile is three 64 x 32 boxes");

// Tiles first, each at a multiple of 1024 bytes from the aligned start.
struct DqSmem {
  uint8_t q[kTileBytes];           // this block's Qr rows
  uint8_t dout[kTileBytes];        // and their dO
  uint8_t k[kStages][kTileBytes];  // the ring: Kr
  uint8_t v[kStages][kTileBytes];  // and V
  uint64_t fixed_full, full[kStages], empty[kStages];
};

struct DkdvSmem {
  uint8_t k[kTileBytes];              // this block's Kr rows
  uint8_t v[kTileBytes];              // and their V
  uint8_t q[kStages][kTileBytes];     // the ring: Qr
  uint8_t dout[kStages][kTileBytes];  // dO
  float lse[kStages][kTile];          // and the rows' lse, delta
  float delta[kStages][kTile];
  uint64_t fixed_full, full[kStages], empty[kStages];
};

template <typename S>
constexpr int smem_bytes() {
  return (int)sizeof(S) + 1024;  // room to align the start
}

// Dynamic shared memory from a 1024-byte boundary (the TMA boxes' and
// wgmma's swizzle pattern is a function of the address).
template <typename S>
__device__ __forceinline__ S& aligned_smem(uint8_t* raw) {
  const uint32_t pad = (1024 - (hopper::smem_u32(raw) & 1023)) & 1023;
  return *reinterpret_cast<S*>(raw + pad);
}

// dS = T(p * (dp - delta) * scale) for two neighbouring columns, rounded to
// nearest as the reference rounds it, packed as one A-fragment register.
__device__ __forceinline__ uint32_t ds_pair(float p0, float p1, float dp0,
                                            float dp1, float dl0, float dl1,
                                            float scale) {
  return pack_pair(p0 * (dp0 - dl0) * scale, p1 * (dp1 - dl1) * scale);
}

// P = exp(scale * acc + bias - lse), rounded operation by operation as
// the reference rounds it, for a score that neither the causal fill nor
// the ragged edge reaches; bias is the key mask's (1 - kmask) * -1e9, 0
// without a mask.
__device__ __forceinline__ float interior_p(float acc, float scale,
                                            float bias, float lse) {
  return expf(__fsub_rn(__fadd_rn(__fmul_rn(acc, scale), bias), lse));
}

// K4's dS for one tile as A fragments (ds[k] covers keys 16k..16k+15)
// from the S and dP accumulators. kEdge: the diagonal or the ragged tile,
// masked element by element (masked_score); else every score is live and
// the key mask is a per-column bias.
template <bool kEdge>
__device__ __forceinline__ void dq_tile_ds(
    uint32_t (&ds)[kTile / 16][4], const float (&s)[4 * kNs],
    const float (&dp)[4 * kNs], const int (&row)[2],
    const float (&row_lse)[2], const float (&row_delta)[2], int k0, int t,
    int seq, int causal, const float* km, float scale) {
#pragma unroll
  for (int j = 0; j < kNs; ++j) {
    float bias[2] = {0.f, 0.f};
    if (!kEdge && km != nullptr) {
#pragma unroll
      for (int e = 0; e < 2; ++e)
        bias[e] = (1.0f - km[k0 + j * 8 + 2 * t + e]) * -1e9f;
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float p[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float acc = s[4 * j + 2 * h + e];
        if (kEdge) {
          const float sc = masked_score(acc, scale, row[h],
                                        k0 + j * 8 + 2 * t + e, seq, causal,
                                        km);
          p[e] = (sc == -INFINITY) ? 0.f : expf(sc - row_lse[h]);
        } else {
          p[e] = interior_p(acc, scale, bias[e], row_lse[h]);
        }
      }
      ds[j >> 1][(j & 1) * 2 + h] =
          ds_pair(p[0], p[1], dp[4 * j + 2 * h], dp[4 * j + 2 * h + 1],
                  row_delta[h], row_delta[h], scale);
    }
  }
}

// K5's T(P^T) and dS^T for one tile as A fragments (q rows 16k..16k+15 in
// [k]) from the S^T and dP^T accumulators; lse_s and delta_s are the
// tile's staged rows. kEdge as in dq_tile_ds; key_bias is the mask's bias
// of this thread's two keys.
template <bool kEdge>
__device__ __forceinline__ void dkdv_tile_p_ds(
    uint32_t (&pt)[kTile / 16][4], uint32_t (&dst)[kTile / 16][4],
    const float (&s)[4 * kNs], const float (&dp)[4 * kNs],
    const int (&key)[2], const float (&key_bias)[2], const float* lse_s,
    const float* delta_s, int q0, int t, int seq, int causal,
    const float* km, float scale) {
#pragma unroll
  for (int j = 0; j < kNs; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int qi = j * 8 + 2 * t;
      float p[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float acc = s[4 * j + 2 * h + e];
        if (kEdge) {
          const float sc = masked_score(acc, scale, q0 + qi + e, key[h], seq,
                                        causal, km);
          p[e] = (sc == -INFINITY || q0 + qi + e >= seq)
                     ? 0.f
                     : expf(sc - lse_s[qi + e]);
        } else {
          p[e] = interior_p(acc, scale, key_bias[h], lse_s[qi + e]);
        }
      }
      pt[j >> 1][(j & 1) * 2 + h] = pack_pair(p[0], p[1]);
      dst[j >> 1][(j & 1) * 2 + h] =
          ds_pair(p[0], p[1], dp[4 * j + 2 * h], dp[4 * j + 2 * h + 1],
                  delta_s[qi], delta_s[qi + 1], scale);
    }
}

template <int N>
__device__ __forceinline__ void zero_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) r[i] = 0.f;
}

// K4: dQ. Grid (q tiles, bh); block kBlock threads.
__global__ void __launch_bounds__(kBlock, 1) flash_bwd_online_dq_wgmma_kernel(
    const __grid_constant__ CUtensorMap tm_q,
    const __grid_constant__ CUtensorMap tm_k,
    const __grid_constant__ CUtensorMap tm_v,
    const __grid_constant__ CUtensorMap tm_do, const float* __restrict__ lse,
    const float* __restrict__ delta, bf16* __restrict__ dq,
    const float* __restrict__ qcos, const float* __restrict__ qsin,
    const float* __restrict__ kmask, int mask_rows, int seq, int num_heads,
    float scale, int causal) {
  using namespace hopper;
  extern __shared__ uint8_t smem_raw[];
  DqSmem& sm = aligned_smem<DqSmem>(smem_raw);
  const int n_t = (seq + kTile - 1) / kTile;
  const int bh = blockIdx.y, qt = n_t - 1 - (int)blockIdx.x;
  const int q0 = qt * kTile;
  const int n_tiles = causal ? qt + 1 : n_t;
  if (threadIdx.x == 0) {
    mbar_init(&sm.fixed_full, 1);
    for (int st = 0; st < kStages; ++st) {
      mbar_init(&sm.full[st], 1);
      mbar_init(&sm.empty[st], kConsumers);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {  // the producer: one thread issues TMA
    if (threadIdx.x == kConsumers) {
      mbar_arrive_expect_tx(&sm.fixed_full, 2 * kTileBytes);
      tma_load_tile(sm.q, &tm_q, &sm.fixed_full, q0, bh);
      tma_load_tile(sm.dout, &tm_do, &sm.fixed_full, q0, bh);
      for (int it = 0; it < n_tiles; ++it) {
        const int st = it % kStages;
        if (it >= kStages) mbar_wait(&sm.empty[st], (it / kStages - 1) & 1);
        mbar_arrive_expect_tx(&sm.full[st], 2 * kTileBytes);
        tma_load_tile(sm.k[st], &tm_k, &sm.full[st], it * kTile, bh);
        tma_load_tile(sm.v[st], &tm_v, &sm.full[st], it * kTile, bh);
      }
    }
    return;
  }

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int row[2] = {q0 + warp * 16 + g, q0 + warp * 16 + g + 8};
  const float* km = nullptr;
  if (kmask != nullptr)
    km = kmask + (size_t)(mask_rows == 1 ? 0 : bh / num_heads) * seq;
  float row_lse[2], row_delta[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const bool valid = row[h] < seq;
    const size_t i = (size_t)bh * seq + row[h];
    row_lse[h] = valid ? lse[i] : 0.f;
    row_delta[h] = valid ? delta[i] : 0.f;
  }
  // Accumulator element 4j + 2h + e: row 16 warp + g + 8h, column 8j + 2t + e.
  float dq_acc[4 * kNd], s[4 * kNs], dp[4 * kNs];
  zero_regs(dq_acc);
  zero_regs(s);
  zero_regs(dp);
  mbar_wait(&sm.fixed_full, 0);
  for (int it = 0; it < n_tiles; ++it) {
    const int st = it % kStages, k0 = it * kTile;
    mbar_wait(&sm.full[st], (it / kStages) & 1);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kHeadDim / 16; ++kk)
      wgmma_m64n64k16_ss(s, kmajor_desc(sm.q, kk), kmajor_desc(sm.k[st], kk),
                         kk > 0);
#pragma unroll
    for (int kk = 0; kk < kHeadDim / 16; ++kk)
      wgmma_m64n64k16_ss(dp, kmajor_desc(sm.dout, kk),
                         kmajor_desc(sm.v[st], kk), kk > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);
    fence_regs(dp);
    uint32_t ds[kTile / 16][4];  // A fragments of dS, one per 16 keys
    if ((causal && it == qt) || k0 + kTile > seq)
      dq_tile_ds<true>(ds, s, dp, row, row_lse, row_delta, k0, t, seq,
                       causal, km, scale);
    else
      dq_tile_ds<false>(ds, s, dp, row, row_lse, row_delta, k0, t, seq,
                        causal, km, scale);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk)
      wgmma_m64n96k16_rs<kMNMajor>(dq_acc, ds[kk], mnmajor_desc(sm.k[st], kk));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dq_acc);
    fence_regs(ds);
    mbar_arrive(&sm.empty[st]);
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (row[h] >= seq) continue;
    bf16* out = dq + ((size_t)bh * seq + row[h]) * kHeadDim;
    const float* cr = qcos + (size_t)row[h] * kHeadDim;
    const float* sr = qsin + (size_t)row[h] * kHeadDim;
#pragma unroll
    for (int j = 0; j < kNd; ++j)
      store_adjoint<bf16>(out, cr, sr, j * 8 + 2 * t, dq_acc[4 * j + 2 * h],
                          dq_acc[4 * j + 2 * h + 1]);
  }
}

// K5: dK and dV. Grid (k tiles, bh); block kBlock threads.
__global__ void __launch_bounds__(kBlock, 1)
    flash_bwd_online_dkdv_wgmma_kernel(
        const __grid_constant__ CUtensorMap tm_q,
        const __grid_constant__ CUtensorMap tm_k,
        const __grid_constant__ CUtensorMap tm_v,
        const __grid_constant__ CUtensorMap tm_do,
        const float* __restrict__ lse, const float* __restrict__ delta,
        bf16* __restrict__ dk, bf16* __restrict__ dv,
        const float* __restrict__ kcos, const float* __restrict__ ksin,
        const float* __restrict__ kmask, int mask_rows, int seq,
        int num_heads, float scale, int causal) {
  using namespace hopper;
  extern __shared__ uint8_t smem_raw[];
  DkdvSmem& sm = aligned_smem<DkdvSmem>(smem_raw);
  const int n_t = (seq + kTile - 1) / kTile;
  const int bh = blockIdx.y, kt = blockIdx.x;  // low k tiles see most rows
  const int k0 = kt * kTile;
  const int q_first = causal ? kt : 0, n_tiles = n_t - q_first;
  if (threadIdx.x == 0) {
    mbar_init(&sm.fixed_full, 1);
    for (int st = 0; st < kStages; ++st) {
      mbar_init(&sm.full[st], 32);  // the producer warp's lanes
      mbar_init(&sm.empty[st], kConsumers);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {  // the producer warp
    const int lane = threadIdx.x - kConsumers;
    if (lane == 0) {
      mbar_arrive_expect_tx(&sm.fixed_full, 2 * kTileBytes);
      tma_load_tile(sm.k, &tm_k, &sm.fixed_full, k0, bh);
      tma_load_tile(sm.v, &tm_v, &sm.fixed_full, k0, bh);
    }
    // lse and delta of rows lane and lane + 32 of a tile, read one tile
    // ahead so that their latency overlaps the wait for a free stage
    float row_lse[2], row_delta[2];
    const auto fetch = [&](int it) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int i = (q_first + it) * kTile + lane + 32 * r;
        row_lse[r] = i < seq ? lse[(size_t)bh * seq + i] : 0.f;
        row_delta[r] = i < seq ? delta[(size_t)bh * seq + i] : 0.f;
      }
    };
    fetch(0);
    for (int it = 0; it < n_tiles; ++it) {
      const int st = it % kStages, q0 = (q_first + it) * kTile;
      if (it >= kStages) mbar_wait(&sm.empty[st], (it / kStages - 1) & 1);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        sm.lse[st][lane + 32 * r] = row_lse[r];
        sm.delta[st][lane + 32 * r] = row_delta[r];
      }
      if (lane == 0) {
        mbar_arrive_expect_tx(&sm.full[st], 2 * kTileBytes);
        tma_load_tile(sm.q[st], &tm_q, &sm.full[st], q0, bh);
        tma_load_tile(sm.dout[st], &tm_do, &sm.full[st], q0, bh);
      } else {
        mbar_arrive(&sm.full[st]);
      }
      if (it + 1 < n_tiles) fetch(it + 1);
    }
    return;
  }

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int key[2] = {k0 + warp * 16 + g, k0 + warp * 16 + g + 8};
  const float* km = nullptr;
  if (kmask != nullptr)
    km = kmask + (size_t)(mask_rows == 1 ? 0 : bh / num_heads) * seq;
  float key_bias[2] = {0.f, 0.f};
#pragma unroll
  for (int h = 0; h < 2; ++h)
    if (km != nullptr && key[h] < seq)
      key_bias[h] = (1.0f - km[key[h]]) * -1e9f;
  // Accumulator element 4j + 2h + e: key 16 warp + g + 8h, column 8j + 2t + e.
  float dv_acc[4 * kNd], dk_acc[4 * kNd], s[4 * kNs], dp[4 * kNs];
  zero_regs(dv_acc);
  zero_regs(dk_acc);
  zero_regs(s);
  zero_regs(dp);
  mbar_wait(&sm.fixed_full, 0);
  for (int it = 0; it < n_tiles; ++it) {
    const int st = it % kStages, q0 = (q_first + it) * kTile;
    mbar_wait(&sm.full[st], (it / kStages) & 1);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kHeadDim / 16; ++kk)  // S^T: rows keys, columns q
      wgmma_m64n64k16_ss(s, kmajor_desc(sm.k, kk), kmajor_desc(sm.q[st], kk),
                         kk > 0);
#pragma unroll
    for (int kk = 0; kk < kHeadDim / 16; ++kk)  // dP^T
      wgmma_m64n64k16_ss(dp, kmajor_desc(sm.v, kk),
                         kmajor_desc(sm.dout[st], kk), kk > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);
    fence_regs(dp);
    uint32_t pt[kTile / 16][4], dst[kTile / 16][4];  // T(P^T), dS^T
    if ((causal && it == 0) || q0 + kTile > seq || k0 + kTile > seq)
      dkdv_tile_p_ds<true>(pt, dst, s, dp, key, key_bias, sm.lse[st],
                           sm.delta[st], q0, t, seq, causal, km, scale);
    else
      dkdv_tile_p_ds<false>(pt, dst, s, dp, key, key_bias, sm.lse[st],
                            sm.delta[st], q0, t, seq, causal, km, scale);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk)
      wgmma_m64n96k16_rs<kMNMajor>(dv_acc, pt[kk],
                                   mnmajor_desc(sm.dout[st], kk));
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk)
      wgmma_m64n96k16_rs<kMNMajor>(dk_acc, dst[kk],
                                   mnmajor_desc(sm.q[st], kk));
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
    if (key[h] >= seq) continue;
    bf16* dv_row = dv + ((size_t)bh * seq + key[h]) * kHeadDim;
    bf16* dk_row = dk + ((size_t)bh * seq + key[h]) * kHeadDim;
    const float* cr = kcos + (size_t)key[h] * kHeadDim;
    const float* sr = ksin + (size_t)key[h] * kHeadDim;
#pragma unroll
    for (int j = 0; j < kNd; ++j) {
      const int c = j * 8 + 2 * t;
      dv_row[c] = from_f<bf16>(dv_acc[4 * j + 2 * h]);
      dv_row[c + 1] = from_f<bf16>(dv_acc[4 * j + 2 * h + 1]);
      store_adjoint<bf16>(dk_row, cr, sr, c, dk_acc[4 * j + 2 * h],
                          dk_acc[4 * j + 2 * h + 1]);
    }
  }
}

// ---- launch ---------------------------------------------------------------

struct Args {
  int dtype;
  const void *qr, *kr, *v, *dout;
  const float *lse, *delta, *qcos, *qsin, *kcos, *ksin, *kmask;
  int mask_rows, bh, seq, d, num_heads;
  float scale;
  int causal;
  cudaStream_t stream;
};

bool invalid(const Args& a) {
  return a.bh <= 0 || a.bh > 65535 || a.seq <= 0 || a.d != kHeadDim ||
         (a.dtype != 0 && a.dtype != 1) ||
         (a.seq + kTile - 1) / kTile > 65535;
}

PFN_cuTensorMapEncodeTiled_v12000 tensor_map_encoder() {
  static PFN_cuTensorMapEncodeTiled_v12000 fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(p);
  }
  return fn;
}

// A (bh, seq, 96) bf16 tensor as a 3-D tensor map of [64 rows][32 columns]
// boxes with the 64-byte swizzle; reads outside it give zeros.
bool make_map(CUtensorMap* map, const void* ptr, int bh, int seq) {
  const auto encode = tensor_map_encoder();
  if (encode == nullptr || reinterpret_cast<uintptr_t>(ptr) % 16 != 0)
    return false;
  const cuuint64_t dims[3] = {(cuuint64_t)kHeadDim, (cuuint64_t)seq,
                              (cuuint64_t)bh};
  const cuuint64_t strides[2] = {kHeadDim * sizeof(bf16),
                                 (cuuint64_t)seq * kHeadDim * sizeof(bf16)};
  const cuuint32_t box[3] = {hopper::kBoxCols, kTile, 1};
  const cuuint32_t elem_strides[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                const_cast<void*>(ptr), dims, strides, box, elem_strides,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_64B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

bool make_maps(const Args& a, CUtensorMap (&m)[4]) {
  return make_map(&m[0], a.qr, a.bh, a.seq) &&
         make_map(&m[1], a.kr, a.bh, a.seq) &&
         make_map(&m[2], a.v, a.bh, a.seq) &&
         make_map(&m[3], a.dout, a.bh, a.seq);
}

cudaError_t launch_dq_fp32(const Args& a, void* dq) {
  constexpr int bytes = dq_smem_bytes<float, kHeadDim>();
  auto kernel = flash_bwd_online_dq_kernel<float, kHeadDim>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.bh, (a.seq + kTile - 1) / kTile);
  kernel<<<grid, kThreads, bytes, a.stream>>>(
      static_cast<const float*>(a.qr), static_cast<const float*>(a.kr),
      static_cast<const float*>(a.v), static_cast<const float*>(a.dout),
      a.lse, a.delta, static_cast<float*>(dq), a.qcos, a.qsin, a.kmask,
      a.mask_rows, a.seq, a.num_heads, a.scale, a.causal);
  return cudaGetLastError();
}

cudaError_t launch_dkdv_fp32(const Args& a, void* dk, void* dv) {
  constexpr int bytes = dkdv_smem_bytes<float, kHeadDim>();
  auto kernel = flash_bwd_online_dkdv_kernel<float, kHeadDim>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.bh, (a.seq + kTile - 1) / kTile);
  kernel<<<grid, kThreads, bytes, a.stream>>>(
      static_cast<const float*>(a.qr), static_cast<const float*>(a.kr),
      static_cast<const float*>(a.v), static_cast<const float*>(a.dout),
      a.lse, a.delta, static_cast<float*>(dk), static_cast<float*>(dv),
      a.kcos, a.ksin, a.kmask, a.mask_rows, a.seq, a.num_heads, a.scale,
      a.causal);
  return cudaGetLastError();
}

cudaError_t launch_dq_bf16(const Args& a, void* dq) {
  CUtensorMap m[4];
  if (!make_maps(a, m)) return cudaErrorInvalidValue;
  constexpr int bytes = smem_bytes<DqSmem>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_online_dq_wgmma_kernel,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.seq + kTile - 1) / kTile, a.bh);
  flash_bwd_online_dq_wgmma_kernel<<<grid, kBlock, bytes, a.stream>>>(
      m[0], m[1], m[2], m[3], a.lse, a.delta, static_cast<bf16*>(dq), a.qcos,
      a.qsin, a.kmask, a.mask_rows, a.seq, a.num_heads, a.scale, a.causal);
  return cudaGetLastError();
}

cudaError_t launch_dkdv_bf16(const Args& a, void* dk, void* dv) {
  CUtensorMap m[4];
  if (!make_maps(a, m)) return cudaErrorInvalidValue;
  constexpr int bytes = smem_bytes<DkdvSmem>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_online_dkdv_wgmma_kernel,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.seq + kTile - 1) / kTile, a.bh);
  flash_bwd_online_dkdv_wgmma_kernel<<<grid, kBlock, bytes, a.stream>>>(
      m[0], m[1], m[2], m[3], a.lse, a.delta, static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), a.kcos, a.ksin, a.kmask, a.mask_rows, a.seq,
      a.num_heads, a.scale, a.causal);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_rotate(const void* q, const void* k, void* qr, void* kr,
                          const void* qcos, const void* qsin,
                          const void* kcos, const void* ksin, int bh,
                          int seq, cudaStream_t stream) {
  const uintptr_t align =
      reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
      reinterpret_cast<uintptr_t>(qr) | reinterpret_cast<uintptr_t>(kr) |
      reinterpret_cast<uintptr_t>(qcos) | reinterpret_cast<uintptr_t>(qsin) |
      reinterpret_cast<uintptr_t>(kcos) | reinterpret_cast<uintptr_t>(ksin);
  if (align % 16 != 0) return cudaErrorMisalignedAddress;
  const long long n_vec = (long long)bh * seq * (kHeadDim / 8);
  const long long blocks = (2 * n_vec + 255) / 256;
  const auto f = [](const void* p) { return static_cast<const float*>(p); };
  rotate_qk_kernel<T><<<(unsigned)blocks, 256, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<T*>(qr),
      static_cast<T*>(kr), f(qcos), f(qsin), f(kcos), f(ksin), n_vec,
      seq * (kHeadDim / 8));
  return cudaGetLastError();
}

Args make_args(int dtype, const void* qr, const void* kr, const void* v,
               const void* dout, const void* lse, const void* delta,
               const void* qcos, const void* qsin, const void* kcos,
               const void* ksin, const void* kmask, int mask_rows, int bh,
               int seq, int d, int num_heads, float scale, int causal,
               void* stream) {
  const auto f = [](const void* p) { return static_cast<const float*>(p); };
  return Args{dtype,     qr,        kr,        v,       dout,
              f(lse),    f(delta),  f(qcos),   f(qsin), f(kcos),
              f(ksin),   f(kmask),  mask_rows, bh,      seq,
              d,         num_heads, scale,     causal,
              static_cast<cudaStream_t>(stream)};
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. q/k and their rotations qr/kr, v, dout
// and the gradients: (bh, seq, d) contiguous; lse, delta: (bh, seq) fp32;
// tables: (seq, d) fp32; kmask: (mask_rows, seq) fp32 or null.

// The rotation pass: qr = T(rot(q)), kr = T(rot(k)).
extern "C" int meant_rotate_qk(int dtype, const void* q, const void* k,
                               void* qr, void* kr, const void* qcos,
                               const void* qsin, const void* kcos,
                               const void* ksin, int bh, int seq, int d,
                               void* stream) {
  if (bh <= 0 || seq <= 0 || d != kHeadDim || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
  return (int)(dtype == 0 ? launch_rotate<float>(q, k, qr, kr, qcos, qsin,
                                                 kcos, ksin, bh, seq, s)
                          : launch_rotate<bf16>(q, k, qr, kr, qcos, qsin,
                                                kcos, ksin, bh, seq, s));
}

// K4: dq, from the rotated qr and kr; the adjoint reads qcos and qsin.
extern "C" int meant_flash_bwd_dq(int dtype, const void* qr, const void* kr,
                                  const void* v, const void* dout,
                                  const void* lse, const void* delta,
                                  void* dq, const void* qcos,
                                  const void* qsin, const void* kcos,
                                  const void* ksin, const void* kmask,
                                  int mask_rows, int bh, int seq, int d,
                                  int num_heads, float scale, int causal,
                                  void* stream) {
  const Args a = make_args(dtype, qr, kr, v, dout, lse, delta, qcos, qsin,
                           kcos, ksin, kmask, mask_rows, bh, seq, d,
                           num_heads, scale, causal, stream);
  if (invalid(a)) return (int)cudaErrorInvalidValue;
  return (int)(dtype == 0 ? launch_dq_fp32(a, dq) : launch_dq_bf16(a, dq));
}

// K5: dk and dv, from the rotated qr and kr; the adjoint reads kcos, ksin.
extern "C" int meant_flash_bwd_dkdv(int dtype, const void* qr, const void* kr,
                                    const void* v, const void* dout,
                                    const void* lse, const void* delta,
                                    void* dk, void* dv, const void* qcos,
                                    const void* qsin, const void* kcos,
                                    const void* ksin, const void* kmask,
                                    int mask_rows, int bh, int seq, int d,
                                    int num_heads, float scale, int causal,
                                    void* stream) {
  const Args a = make_args(dtype, qr, kr, v, dout, lse, delta, qcos, qsin,
                           kcos, ksin, kmask, mask_rows, bh, seq, d,
                           num_heads, scale, causal, stream);
  if (invalid(a)) return (int)cudaErrorInvalidValue;
  return (int)(dtype == 0 ? launch_dkdv_fp32(a, dk, dv)
                          : launch_dkdv_bf16(a, dk, dv));
}
