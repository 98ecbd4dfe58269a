// Rotary-fused flash-attention backward for Hopper (sm_90a).
//
// Replaces the TPU kernel meant_tpu/ops/flash/kernel.py:_bwd_kernel (the
// resident backward, launched by _flash_bwd through the custom VJP of
// _make_flash). For each (batch*head) it computes what that kernel
// computes, from q and k rotated by the fp32 tables and rounded to the
// input dtype T once per call by the rotation pass (R1,
// flash_bwd_online.cu; the bits of the TPU kernel's rotation at :340-341):
//   P     = softmax(mask(scale * Qr Kr^T))                 (fp32)
//   dV    = T(P)^T dO                                       (fp32 sums)
//   dP    = dO V^T;  delta = rowsum(P o dP)                 (fp32)
//   dS    = T(P o (dP - delta) * scale)
//   dQ    = rot^T(dS Kr),  dK = rot^T(dS^T Qr)
// with rot^T(g) = cos o g - H(sin o g), H the interleaved rotate_half
// (H(x)[2i] = -x[2i+1], H(x)[2i+1] = x[2i]) and H^T = -H. The tables serve
// only the adjoint, applied once in each epilogue.
//
// Design. The TPU kernel accumulates dK/dV by revisiting its output blocks
// across the q-block grid axis, sound only because a TPU grid runs in
// order; on a GPU the blocks run in parallel, so that would race. Here two
// kernels split the work so every output element has one writer and no
// atomics are needed (the result is deterministic):
//   * the dq kernel, one block per (bh, 64-row q tile), walks the Kr/V
//     tiles twice. Pass 1 finds each row's max m, denominator l and
//     delta = sum_j P_ij dP_ij online (delta is accumulated against the
//     running max and rescaled with l; it is JAX's delta, not FA2's
//     rowsum(dO o O), so it needs S and dP on every tile). It writes m, 1/l
//     and delta as (3, BH, s) fp32 scratch. Pass 2 recomputes S and dP,
//     forms dS and accumulates dQr in fp32 registers.
//   * the dk/dv kernel, one block per (bh, 64-row k tile), walks the q tiles
//     (from the diagonal on, when causal), recomputes S^T = Kr Qr^T and
//     dP^T = V dO^T, takes P from the saved m and 1/l (not from a
//     log-sum-exp: a fully masked row sits near -1e9, where m + log l would
//     lose every digit of log l; P is 1/s there, the reference's result),
//     and accumulates dV and dKr in fp32 registers.
// Rows and keys past s (s=196 is ragged) get P = 0 and are never written.
//   * bf16 (the main path): the wgmma bodies of flash_bwd_wgmma.cuh, shared
//     with the streaming backward's K4 and K5 and instantiated here with the
//     statistics pass (kStats): a producer warp streams the Kr/V tiles
//     (twice, for the two passes) or the Qr/dO tiles through TMA into a
//     ring of stages; S and dP run on wgmma from shared memory; P and dS are
//     rounded in the registers that become the A fragments of dQr += dS Kr,
//     dV += T(P^T) dO and dKr += dS^T Qr, exactly where the reference rounds
//     them; masks only on the diagonal and ragged tiles (at s=196, not
//     causal, only the last tile).
//   * fp32 (the tight on-card check): scalar bodies, the warp-level NT
//     product of flash_common.cuh computed by fp32 FMAs (the tensor cores
//     would round fp32 to TF32), on synchronous loads with transposed
//     copies, fed the same Qr and Kr; the dk/dv body reads the row
//     statistics from device memory, which keeps its tiles within a
//     block's shared memory at D = 128.
// Head dims 64, 96 and 128 are instantiated (the wrapper pads any other
// d up to 128 to the next of them), and in bf16 also 192 and 256, the
// padded widths of every d in (128, 256] (meant_src --num_heads 4 and 3):
// the same wgmma bodies, the dq kernel one consumer warpgroup at 192 and two
// splitting dQ's columns at 256, the dk/dv kernel two at both, each
// warpgroup forming the tile's whole S and dP (the layouts and their
// bounds: flash_bwd_wgmma.cuh). In bf16 at 384 (meant_src --num_heads 2)
// the sliced kernels of flash_bwd_wgmma.cuh: the streamed tiles in
// 192-column slices, dQ in two warpgroups of 192 columns, dK and dV in
// column groups of 192 on the grid. In bf16 at 768 (--num_heads 1) the
// chain body of flash_bwd_chain.cuh: S and dP on fp32 FMA chains in column
// order (the wide body's bits), formed once per tile pair, the products
// on wgmma; three launches a call. At an odd head dim the adjoint wraps
// column d-1 onto column 0 as the JAX kernel's lane rotate-half does
// (store_adjoint_wrap, flash_common.cuh): up to 256 in bf16 and 128 in
// fp32 in the epilogues of these bodies, whose blocks hold all of a row's
// columns. In fp32 past 128, at the other widths past 256 and at an odd
// head dim past 256 both kernels take the wide bodies of flash_wide.cuh at
// the padded width (a multiple of 64), still one dq launch and one dk/dv
// launch. q has s_q rows and k s_k keys: the dq kernel's grid walks q
// tiles, the dk/dv kernel's k tiles.
//
// Bound on an H100 SXM (3.35 TB/s, 989 TFLOP/s bf16 dense) at the main
// path's shapes (BH = 640, d = 96, bf16): the launch must read q, k, v, dO
// and the four (s, 96) tables and write dq, dk, dv once: 441 MB at s=512
// (0.132 ms) and 169 MB at s=196 (0.050 ms). Its five products over the
// causal triangle are 80.5 GFLOP at s=512 (0.081 ms) and 23.6 GFLOP at
// s=196 (0.024 ms): bound by bytes. The design does nine products' worth
// of tensor-core work (S three times, dP three times, dS Kr, P^T dO,
// dS^T Qr), since the statistics pass and the dk/dv kernel each recompute
// S and dP.
//
// C interface (loaded with ctypes): meant_flash_bwd returns the
// cudaError_t of the launches (0 on success); it never synchronises.

#include "flash_bwd_chain.cuh"
#include "flash_bwd_wgmma.cuh"
#include "flash_common.cuh"
#include "flash_wide.cuh"

namespace {

using namespace meant;

constexpr int kTile = 64;      // q rows (dq kernel) or keys (dk/dv kernel)
constexpr int kThreads = 128;  // 4 warps, 16 rows each

// The shared building blocks (Pad, warp_mm, zero, load_tile,
// store_adjoint, row_sum, row_max) are in flash_common.cuh; load_tile's
// default tile is this file's.
static_assert(kTile == 64 && kThreads == 128, "load_tile's default tile");

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
                           2 * kTile * (kTile + Pad<T>::value));
}

// ---- fp32: dQ and the row statistics --------------------------------------

template <typename T, int D, bool kWrap>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_kernel(
    const T* __restrict__ qr, const T* __restrict__ kr,
    const T* __restrict__ v, const T* __restrict__ dout, T* __restrict__ dq,
    float* __restrict__ stats, const float* __restrict__ qcos,
    const float* __restrict__ qsin, const float* __restrict__ kmask,
    int mask_rows, int seq_q, int seq_k, int num_heads, float scale,
    int causal, int head_dim) {
  constexpr int ld = D + Pad<T>::value;       // [row][d] tiles
  constexpr int ldk = kTile + Pad<T>::value;  // [.][key] tiles
  constexpr int kNk = kTile / 8;            // n-tiles over keys
  constexpr int kNd = D / 8;                // n-tiles over d
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
  const size_t q_base = (size_t)bh * seq_q * D;
  const size_t k_base = (size_t)bh * seq_k * D;
  const float* km = nullptr;
  if (kmask != nullptr)
    km = kmask + (size_t)(mask_rows == 1 ? 0 : bh / num_heads) * seq_k;
  const T* qw = qs + warp * 16 * ld;
  const T* dow = dos + warp * 16 * ld;
  T* dsw = dss + warp * 16 * ldk;

  load_tile<T, D>(qs, ld, nullptr, 0, qr + q_base, nullptr, nullptr, q0,
                  seq_q);
  load_tile<T, D>(dos, ld, nullptr, 0, dout + q_base, nullptr, nullptr, q0,
                  seq_q);
  const int n_k = (seq_k + kTile - 1) / kTile;
  const int n_tiles = causal ? min(n_k, (int)blockIdx.y + 1) : n_k;

  // pass 1: m, l and delta for every row, online over the key tiles
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float dsum[2] = {0.f, 0.f};
  for (int tile = 0; tile < n_tiles; ++tile) {
    const int k0 = tile * kTile;
    __syncthreads();  // the previous tile's reads are done
    load_tile<T, D>(ks, ld, nullptr, 0, kr + k_base, nullptr, nullptr, k0,
                    seq_k);
    load_tile<T, D>(vs, ld, nullptr, 0, v + k_base, nullptr, nullptr, k0,
                    seq_k);
    __syncthreads();
    float s[kNk][4], dp[kNk][4];
    zero(s);
    zero(dp);
    warp_mm<kNk, D>(s, qw, ld, ks, ld);
    warp_mm<kNk, D>(dp, dow, ld, vs, ld);
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < kNk; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1;
        s[j][e] = masked_score(s[j][e], scale, row[h],
                               k0 + j * 8 + 2 * t + (e & 1), seq_k, causal,
                               km);
        mx[h] = fmaxf(mx[h], s[j][e]);
      }
    float m_use[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float corr = rescale(m[h], row_max(mx[h]), m_use[h]);
      l[h] *= corr;
      dsum[h] *= corr;
    }
#pragma unroll
    for (int j = 0; j < kNk; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1;
        const float p =
            (s[j][e] == -INFINITY) ? 0.f : expf(s[j][e] - m_use[h]);
        l[h] += p;
        dsum[h] += p * dp[j][e];
      }
  }
  float m_fin[2], inv_l[2], delta[2];
  const size_t plane = (size_t)gridDim.x * seq_q;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float lt = row_sum(l[h]);
    m_fin[h] = (m[h] == -INFINITY) ? 0.f : m[h];
    inv_l[h] = lt > 0.f ? 1.0f / lt : 0.f;
    delta[h] = row_sum(dsum[h]) * inv_l[h];
    if (t == 0 && row[h] < seq_q) {
      const size_t i = (size_t)bh * seq_q + row[h];
      stats[i] = m_fin[h];
      stats[plane + i] = inv_l[h];
      stats[2 * plane + i] = delta[h];
    }
  }

  // pass 2: dS and dQr = dS Kr
  float acc[kNd][4];
  zero(acc);
  for (int tile = 0; tile < n_tiles; ++tile) {
    const int k0 = tile * kTile;
    __syncthreads();
    load_tile<T, D>(ks, ld, kts, ldk, kr + k_base, nullptr, nullptr, k0,
                    seq_k);
    load_tile<T, D>(vs, ld, nullptr, 0, v + k_base, nullptr, nullptr, k0,
                    seq_k);
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
        const float sc = masked_score(s[j][e], scale, row[h], k0 + col,
                                      seq_k, causal, km);
        const float p =
            (sc == -INFINITY) ? 0.f : expf(sc - m_fin[h]) * inv_l[h];
        dsw[(g + 8 * h) * ldk + col] =
            from_f<T>(p * (dp[j][e] - delta[h]) * scale);
      }
    __syncwarp();
    warp_mm<kNd, kTile>(acc, dsw, ldk, kts, ldk);
  }

  // column 0 of the rows, for the wrap at an odd head dim (kWrap)
  float g0[2] = {0.f, 0.f};
  if constexpr (kWrap)
#pragma unroll
    for (int h = 0; h < 2; ++h) g0[h] = quad_column0(acc[0][2 * h]);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (row[h] >= seq_q) continue;
    T* out = dq + q_base + (size_t)row[h] * D;
    const float* cr = qcos + (size_t)row[h] * D;
    const float* sr = qsin + (size_t)row[h] * D;
#pragma unroll
    for (int j = 0; j < kNd; ++j) {
      if constexpr (kWrap)
        store_adjoint_wrap<T>(out, cr, sr, j * 8 + 2 * t, acc[j][2 * h],
                              acc[j][2 * h + 1], head_dim, g0[h]);
      else
        store_adjoint<T>(out, cr, sr, j * 8 + 2 * t, acc[j][2 * h],
                         acc[j][2 * h + 1]);
    }
  }
}

// ---- fp32: dK and dV -------------------------------------------------------

template <typename T, int D, bool kWrap>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkdv_kernel(
    const T* __restrict__ qr, const T* __restrict__ kr,
    const T* __restrict__ v, const T* __restrict__ dout, T* __restrict__ dk,
    T* __restrict__ dv, const float* __restrict__ stats,
    const float* __restrict__ kcos, const float* __restrict__ ksin,
    const float* __restrict__ kmask, int mask_rows, int seq_q, int seq_k,
    int num_heads, float scale, int causal, int head_dim) {
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

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.x, k0 = blockIdx.y * kTile;
  const int key[2] = {k0 + warp * 16 + g, k0 + warp * 16 + g + 8};
  const size_t q_base = (size_t)bh * seq_q * D;
  const size_t k_base = (size_t)bh * seq_k * D;
  const size_t plane = (size_t)gridDim.x * seq_q;
  const float* km = nullptr;
  if (kmask != nullptr)
    km = kmask + (size_t)(mask_rows == 1 ? 0 : bh / num_heads) * seq_k;
  const T* kw = ks + warp * 16 * ld;
  const T* vw = vs + warp * 16 * ld;
  T* pw = ps + warp * 16 * ldk;
  T* dsw = dss + warp * 16 * ldk;

  load_tile<T, D>(ks, ld, nullptr, 0, kr + k_base, nullptr, nullptr, k0,
                  seq_k);
  load_tile<T, D>(vs, ld, nullptr, 0, v + k_base, nullptr, nullptr, k0,
                  seq_k);

  float dv_acc[kNd][4], dk_acc[kNd][4];
  zero(dv_acc);
  zero(dk_acc);
  const int n_q = (seq_q + kTile - 1) / kTile;
  for (int qt = causal ? (int)blockIdx.y : 0; qt < n_q; ++qt) {
    const int q0 = qt * kTile;
    __syncthreads();  // the previous tile's reads are done
    load_tile<T, D>(qs, ld, qts, ldk, qr + q_base, nullptr, nullptr, q0,
                    seq_q);
    load_tile<T, D>(dos, ld, dots, ldk, dout + q_base, nullptr, nullptr, q0,
                    seq_q);
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
        // the row's m, 1/l and delta (P = 0 past seq_q)
        const bool valid = q0 + qi < seq_q;
        const size_t r = (size_t)bh * seq_q + q0 + qi;
        const float st_m = valid ? stats[r] : 0.f;
        const float st_il = valid ? stats[plane + r] : 0.f;
        const float st_dl = valid ? stats[2 * plane + r] : 0.f;
        const float sc = masked_score(s[j][e], scale, q0 + qi, key[h], seq_k,
                                      causal, km);
        const float p = (sc == -INFINITY) ? 0.f : expf(sc - st_m) * st_il;
        pw[(g + 8 * h) * ldk + qi] = from_f<T>(p);
        dsw[(g + 8 * h) * ldk + qi] =
            from_f<T>(p * (dp[j][e] - st_dl) * scale);
      }
    __syncwarp();
    warp_mm<kNd, kTile>(dv_acc, pw, ldk, dots, ldk);
    warp_mm<kNd, kTile>(dk_acc, dsw, ldk, qts, ldk);
  }

  // column 0 of the keys, for the wrap at an odd head dim (kWrap)
  float g0[2] = {0.f, 0.f};
  if constexpr (kWrap)
#pragma unroll
    for (int h = 0; h < 2; ++h) g0[h] = quad_column0(dk_acc[0][2 * h]);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (key[h] >= seq_k) continue;
    T* dv_row = dv + k_base + (size_t)key[h] * D;
    T* dk_row = dk + k_base + (size_t)key[h] * D;
    const float* cr = kcos + (size_t)key[h] * D;
    const float* sr = ksin + (size_t)key[h] * D;
#pragma unroll
    for (int j = 0; j < kNd; ++j) {
      const int c = j * 8 + 2 * t;
      dv_row[c] = from_f<T>(dv_acc[j][2 * h]);
      dv_row[c + 1] = from_f<T>(dv_acc[j][2 * h + 1]);
      if constexpr (kWrap)
        store_adjoint_wrap<T>(dk_row, cr, sr, c, dk_acc[j][2 * h],
                              dk_acc[j][2 * h + 1], head_dim, g0[h]);
      else
        store_adjoint<T>(dk_row, cr, sr, c, dk_acc[j][2 * h],
                         dk_acc[j][2 * h + 1]);
    }
  }
}

// ---- launch --------------------------------------------------------------

template <int D, bool kWrap>
cudaError_t launch_fp32_body(const bwd::Args& a, void* dq, void* dk,
                             void* dv, float* stats) {
  constexpr int dq_bytes = dq_smem_bytes<float, D>();
  constexpr int dkdv_bytes = dkdv_smem_bytes<float, D>();
  const auto dq_kernel = flash_bwd_dq_kernel<float, D, kWrap>;
  const auto dkdv_kernel = flash_bwd_dkdv_kernel<float, D, kWrap>;
  cudaError_t err = cudaFuncSetAttribute(
      dq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, dq_bytes);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(
      dkdv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, dkdv_bytes);
  if (err != cudaSuccess) return err;
  const auto f = [](const void* p) { return static_cast<const float*>(p); };
  dq_kernel<<<dim3(a.bh, (a.seq_q + kTile - 1) / kTile), kThreads, dq_bytes,
              a.stream>>>(
      f(a.qr), f(a.kr), f(a.v), f(a.dout), static_cast<float*>(dq), stats,
      a.qcos, a.qsin, a.kmask, a.mask_rows, a.seq_q, a.seq_k, a.num_heads,
      a.scale, a.causal, a.head_dim);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dkdv_kernel<<<dim3(a.bh, (a.seq_k + kTile - 1) / kTile), kThreads,
                dkdv_bytes, a.stream>>>(
      f(a.qr), f(a.kr), f(a.v), f(a.dout), static_cast<float*>(dk),
      static_cast<float*>(dv), stats, a.kcos, a.ksin, a.kmask, a.mask_rows,
      a.seq_q, a.seq_k, a.num_heads, a.scale, a.causal, a.head_dim);
  return cudaGetLastError();
}

// at a.head_dim: the kWrap instantiations at an odd one
template <int D>
cudaError_t launch_fp32(const bwd::Args& a, void* dq, void* dk, void* dv,
                        float* stats) {
  return (a.head_dim & 1) ? launch_fp32_body<D, true>(a, dq, dk, dv, stats)
                          : launch_fp32_body<D, false>(a, dq, dk, dv, stats);
}

// a's row statistics are the planes m, 1/l, delta, each (bh, seq_q)
template <int D>
cudaError_t launch_bf16(const bwd::Args& a, void* dq, void* dk, void* dv) {
  CUtensorMap m[4];
  if (!bwd::make_maps<D>(m, a)) return cudaErrorInvalidValue;
  cudaError_t err = bwd::launch_dq<true, D>(m, a, dq);
  if (err != cudaSuccess) return err;
  return bwd::launch_dkdv<true, D>(m, a, dk, dv);
}

// bf16 at D = 384: the sliced kernels
template <int D>
cudaError_t launch_sliced(const bwd::Args& a, void* dq, void* dk, void* dv) {
  CUtensorMap m[4];
  if (!bwd::make_maps<D>(m, a)) return cudaErrorInvalidValue;
  cudaError_t err = bwd::launch_dq_sliced<true, D>(m, a, dq);
  if (err != cudaSuccess) return err;
  return bwd::launch_dkdv_sliced<true, D>(m, a, dk, dv);
}

}  // namespace

// The bytes of scratch a call with these arguments needs beside stats: the
// chain body's (bf16 at d = 768), else 0.
extern "C" long long meant_flash_bwd_scratch_bytes(int dtype, int d,
                                                   int head_dim, int bh,
                                                   int seq_q, int seq_k) {
  if (!wide::takes_chain(wide::kK2, dtype, d, head_dim)) return 0;
  return (long long)chain::scratch_bytes(bh, seq_q, seq_k);
}

// dtype: 0 = float32, 1 = bfloat16. qr (q rotated by R1), dout, dq:
// (bh, seq_q, d); kr (k rotated by R1), v, dk, dv: (bh, seq_k, d); all
// contiguous, d = 64, 96, 128 or a multiple of 64, head_dim <= d the
// caller's head dim (an odd one wraps the adjoint); stats: (3, bh, seq_q)
// fp32, the rows' m, 1/l and delta (written, then read); scratch:
// meant_flash_bwd_scratch_bytes of device memory (null when that is 0);
// tables: (seq_q | seq_k, d) fp32, read by the rotation's adjoint; kmask:
// (mask_rows, seq_k) fp32 or null.
extern "C" int meant_flash_bwd(int dtype, const void* qr, const void* kr,
                               const void* v, const void* dout, void* dq,
                               void* dk, void* dv, void* stats,
                               void* scratch, const void* qcos,
                               const void* qsin,
                               const void* kcos, const void* ksin,
                               const void* kmask, int mask_rows, int bh,
                               int seq_q, int seq_k, int d, int head_dim,
                               int num_heads, float scale, int causal,
                               void* stream) {
  if (bh <= 0 || bh > 65535 || seq_q <= 0 || seq_k <= 0 ||
      (dtype != 0 && dtype != 1) || (seq_q + kTile - 1) / kTile > 65535 ||
      (seq_k + kTile - 1) / kTile > 65535)
    return (int)cudaErrorInvalidValue;
  const auto f = [](const void* p) { return static_cast<const float*>(p); };
  auto* st = static_cast<float*>(stats);
  const size_t plane = (size_t)bh * seq_q;
  const bwd::Args a{qr, kr, v, dout, st, st + plane, st + 2 * plane,
                    f(qcos), f(qsin), f(kcos), f(ksin), f(kmask), mask_rows,
                    bh, seq_q, seq_k, num_heads, scale, causal, head_dim,
                    static_cast<cudaStream_t>(stream)};
  if (wide::takes_wide(wide::kK2, dtype, d, head_dim)) {
    const wide::Args w{qr,      kr,      v,       dout,      st,
                       nullptr, nullptr, f(qcos), f(qsin),   f(kcos),
                       f(ksin), f(kmask), mask_rows, bh,     seq_q,
                       seq_k,   d,       head_dim, num_heads, scale,
                       causal,  static_cast<cudaStream_t>(stream)};
    cudaError_t err = dtype == 0 ? wide::launch_dq<float, true>(w, dq)
                                 : wide::launch_dq<bf16, true>(w, dq);
    if (err != cudaSuccess) return (int)err;
    return (int)(dtype == 0 ? wide::launch_dkdv<float, true>(w, dk, dv)
                            : wide::launch_dkdv<bf16, true>(w, dk, dv));
  }
  if (head_dim <= 0 || head_dim > d) return (int)cudaErrorInvalidValue;
  if (wide::takes_chain(wide::kK2, dtype, d, head_dim))
    return (int)chain::launch<true>(a, dq, dk, dv, scratch, chain::kAll);
  // past 128 only bf16 at 192, 256 and 384 has a wgmma body, and at 768
  // the chain body (takes_wide sends fp32 there, and an odd head dim past
  // 256, to the wide bodies)
  if (dtype == 1 && d == 192) return (int)launch_bf16<192>(a, dq, dk, dv);
  if (dtype == 1 && d == 256) return (int)launch_bf16<256>(a, dq, dk, dv);
  if (dtype == 1 && d == 384) return (int)launch_sliced<384>(a, dq, dk, dv);
  return (int)dispatch_head_dim(d, [&](auto built) {
    constexpr int D = decltype(built)::value;
    return dtype == 0 ? launch_fp32<D>(a, dq, dk, dv, st)
                      : launch_bf16<D>(a, dq, dk, dv);
  });
}
