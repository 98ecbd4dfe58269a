// Streaming rotary-fused flash-attention backward for Hopper (sm_90a):
// dQ (K4), dK/dV (K5), and the rotation pass (R1) that feeds them, the
// streaming forward (K3, flash_fwd.cu) and the resident backward (K2,
// flash_bwd.cu).
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
//   * rotate_qk_kernel, the rotation pass, writes Qr and Kr once per call
//     of K3, K2 or K4 + K5 with load_tile's arithmetic (no FMA
//     contraction), the bits the TPU kernels' in-kernel rotation gives.
//     Those rotate every tile they load: each k tile once per q tile in K3
//     and K4, each q tile once per k tile in K5 (80 x 2,080 tile rotations
//     each at src4096, for 80 x 64 distinct tiles).
//   * K4, one block per (bh, 64-row q tile), walks the Kr/V tiles up to
//     the diagonal, forms dS and accumulates dQr in fp32 registers; the
//     adjoint is applied once at the end.
//   * K5, one block per (bh, 64-row k tile), walks the Qr/dO tiles from
//     the diagonal, recomputes S^T = Kr Qr^T and dP^T = V dO^T, and
//     accumulates dV and dKr in fp32 registers.
// bf16, the main path: the wgmma bodies of flash_bwd_wgmma.cuh (shared with
// the resident backward K2, flash_bwd.cu), with P from the forward's lse:
// a consumer warpgroup and a producer warp per block, Qr/Kr/V/dO through
// TMA into a ring of stages, S and dP on wgmma with both operands in
// shared memory, dS (and K5's T(P^T)) rounded in the registers that become
// the A fragments of the products that follow, masks only on the diagonal
// and ragged tiles. Nothing is transposed or rotated in K4 or K5.
// fp32, the tight on-card check: scalar bodies (the warp-level NT product
// of flash_common.cuh on synchronous loads with transposed copies), fed
// the same Qr and Kr; K5's reads the rows' lse and delta from device
// memory, which keeps its tiles within a block's shared memory at D = 128.
// Rows past s_q and keys past s_k get P = 0 and are never written. Head
// dims 64, 96 and 128 are instantiated in both dtypes (the wrapper pads any
// other even d up to 128 to the next of them), and in bf16 also 192 and
// 256, the padded widths of every even d in (128, 256]: the wgmma bodies at
// two consumer warpgroups (flash_bwd_wgmma.cuh says how); at 384 (d in
// (320, 384], src4096 --num_heads 2) the sliced kernels of
// flash_bwd_wgmma.cuh without the statistics pass (Kr / V or Qr / dO
// streamed in 192-column slices, dK and dV in column groups of 192 on the
// grid); at 768 (d in (704, 768], --num_heads 1's streaming text tower) the
// chain body of flash_bwd_chain.cuh with P = exp(S - lse): S and dP on
// fp32 FMA chains in column order into a scratch the wrapper allocates
// (meant_flash_bwd_online_scratch_bytes), P and dS as the wide bodies
// form them, the products on wgmma. K4 or K5 alone there forms S and dP
// itself; meant_flash_bwd_online, the main path's one call at every width,
// forms them once for dQ, dK and dV there. In fp32 past 128, at the other
// widths past 256, and at an odd head dim (whose adjoint wraps), K4 and K5
// take the wide bodies of flash_wide.cuh. The rotation pass takes any
// width that is a multiple of 8, the caller's head dim d beside it: at
// an odd d, column d-1 pairs with column 0 as the JAX kernels' lane
// rotate-half pairs them (x[d-1] cos - x[0] sin). q has s_q rows and k s_k
// keys, as in the resident kernels.
//
// Bound on an H100 SXM (989 TFLOP/s bf16 dense, 3.35 TB/s) at the main
// path's shapes (text tower of src4096: BH = 80, s = 4096, d = 96, bf16,
// causal): K4 runs three products over the causal triangle (S, dP, dS Kr),
// 386.5 GFLOP, 0.39 ms; K5 four (S, dP, P^T dO, dS^T Qr), 515.4 GFLOP,
// 0.52 ms; both are bound by operations (each moves some 0.3 GB, 0.1 ms).
// src4096 at --num_heads 4 launches them at (40, 4096, 192), at 3 heads at
// (30, 4096, 256) and at 2 at (20, 4096, 384): the same operations, the
// same bounds. --num_heads 1 streams its s=512 text tower at (80, 512,
// 768): K4 alone 96 MB and K5 alone 115 MB (0.096 and 0.115 ms, bound by
// bytes), the one call that forms S and dP once for both 447 MB (0.133
// ms: Qr, Kr, V, dO read once, dQ, dK, dV written); the chain body sums S
// and dP by scalar FMAs there, 80 x 36 tile pairs x 64 x 64 x 768 x 2 =
// 1.81e10 FMAs, 0.54 ms at the 67 TFLOP/s fp32 peak, its floor (PERF.md).
// The rotation pass is bound by bytes: q and k read, Qr and Kr written,
// the four tables read, 258 MB, 0.077 ms.
//
// C interface (loaded with ctypes): meant_rotate_qk, meant_flash_bwd_dq,
// meant_flash_bwd_dkdv and meant_flash_bwd_online return the cudaError_t
// of the launch (0 on success); they never synchronise.

#include "flash_bwd_chain.cuh"
#include "flash_bwd_wgmma.cuh"
#include "flash_common.cuh"
#include "flash_wide.cuh"

namespace {

using namespace meant;

constexpr int kTile = 64;      // q rows (K4) or keys (K5)
constexpr int kThreads = 128;  // fp32 bodies: 4 warps, 16 rows each
static_assert(kTile == 64 && kThreads == 128, "load_tile's default tile");

// ---- the rotation pass ----------------------------------------------------

template <typename T>
struct alignas(16) Pack8 {
  T v[8];
};

// Qr = T(rot(q)) and Kr = T(rot(k)), eight elements a thread: q_vec
// vectors of q and k_vec of k, q_table_vec per (s_q, d) table of q and
// k_table_vec per (s_k, d) table of k, row_vec per row (d / 8). At an odd
// head_dim the vector holding column head_dim - 1 reads its row's column 0
// as that column's partner.
template <typename T>
__global__ void __launch_bounds__(256) rotate_qk_kernel(
    const T* __restrict__ q, const T* __restrict__ k, T* __restrict__ qr,
    T* __restrict__ kr, const float* __restrict__ qcos,
    const float* __restrict__ qsin, const float* __restrict__ kcos,
    const float* __restrict__ ksin, long long q_vec, long long k_vec,
    int q_table_vec, int k_table_vec, int row_vec, int head_dim) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= q_vec + k_vec) return;
  const bool is_k = i >= q_vec;
  const long long e = is_k ? i - q_vec : i;
  const int tv = (int)(e % (is_k ? k_table_vec : q_table_vec));
  const int col = (tv % row_vec) * 8;  // the vector's first column
  const Pack8<T> x = reinterpret_cast<const Pack8<T>*>(is_k ? k : q)[e];
  const Pack8<float> cs =
      reinterpret_cast<const Pack8<float>*>(is_k ? kcos : qcos)[tv];
  const Pack8<float> sn =
      reinterpret_cast<const Pack8<float>*>(is_k ? ksin : qsin)[tv];
  float wrap_x = 0.f;  // column 0 of the row, partner of column head_dim - 1
  if ((head_dim & 1) && col < head_dim && head_dim <= col + 8)
    wrap_x = to_f<T>((is_k ? k : q)[e * 8 - col]);
  Pack8<T> y;
#pragma unroll
  for (int c = 0; c < 8; c += 2) {
    const float x0 = to_f<T>(x.v[c]), x1 = to_f<T>(x.v[c + 1]);
    const float partner = col + c + 1 == head_dim ? wrap_x : x1;
    y.v[c] = from_f<T>(
        __fadd_rn(__fmul_rn(x0, cs.v[c]), __fmul_rn(-partner, sn.v[c])));
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
                           2 * kTile * (kTile + Pad<T>::value));
}

// K4: dQ.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_online_dq_kernel(
    const T* __restrict__ qr, const T* __restrict__ kr, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, T* __restrict__ dq,
    const float* __restrict__ qcos, const float* __restrict__ qsin,
    const float* __restrict__ kmask, int mask_rows, int seq_q, int seq_k,
    int num_heads, float scale, int causal) {
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
  float row_lse[2], row_delta[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const bool valid = row[h] < seq_q;
    const size_t i = (size_t)bh * seq_q + row[h];
    row_lse[h] = valid ? lse[i] : 0.f;
    row_delta[h] = valid ? delta[i] : 0.f;
  }
  const int n_k = (seq_k + kTile - 1) / kTile;
  const int n_tiles = causal ? min(n_k, (int)blockIdx.y + 1) : n_k;

  float acc[kNd][4];
  zero(acc);
  for (int tile = 0; tile < n_tiles; ++tile) {
    const int k0 = tile * kTile;
    __syncthreads();  // the previous tile's reads are done
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
        const float p = (sc == -INFINITY) ? 0.f : expf(sc - row_lse[h]);
        dsw[(g + 8 * h) * ldk + col] =
            from_f<T>(p * (dp[j][e] - row_delta[h]) * scale);
      }
    __syncwarp();
    warp_mm<kNd, kTile>(acc, dsw, ldk, kts, ldk);
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (row[h] >= seq_q) continue;
    T* out = dq + q_base + (size_t)row[h] * D;
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
    const float* __restrict__ kmask, int mask_rows, int seq_q, int seq_k,
    int num_heads, float scale, int causal) {
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
        // the row's lse and delta (P = 0 past seq_q)
        const bool valid = q0 + qi < seq_q;
        const size_t r = (size_t)bh * seq_q + q0 + qi;
        const float st_lse = valid ? lse[r] : 0.f;
        const float st_dl = valid ? delta[r] : 0.f;
        const float sc = masked_score(s[j][e], scale, q0 + qi, key[h], seq_k,
                                      causal, km);
        const float p =
            (sc == -INFINITY || !valid) ? 0.f : expf(sc - st_lse);
        pw[(g + 8 * h) * ldk + qi] = from_f<T>(p);
        dsw[(g + 8 * h) * ldk + qi] =
            from_f<T>(p * (dp[j][e] - st_dl) * scale);
      }
    __syncwarp();
    warp_mm<kNd, kTile>(dv_acc, pw, ldk, dots, ldk);
    warp_mm<kNd, kTile>(dk_acc, dsw, ldk, qts, ldk);
  }

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
      store_adjoint<T>(dk_row, cr, sr, c, dk_acc[j][2 * h],
                       dk_acc[j][2 * h + 1]);
    }
  }
}

// ---- launch ---------------------------------------------------------------

bool invalid(int dtype, const bwd::Args& a) {
  return a.bh <= 0 || a.bh > 65535 || a.seq_q <= 0 || a.seq_k <= 0 ||
         (dtype != 0 && dtype != 1) ||
         (a.seq_q + kTile - 1) / kTile > 65535 ||
         (a.seq_k + kTile - 1) / kTile > 65535;
}

template <int D>
cudaError_t launch_dq_fp32(const bwd::Args& a, void* dq) {
  constexpr int bytes = dq_smem_bytes<float, D>();
  auto kernel = flash_bwd_online_dq_kernel<float, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.bh, (a.seq_q + kTile - 1) / kTile);
  kernel<<<grid, kThreads, bytes, a.stream>>>(
      static_cast<const float*>(a.qr), static_cast<const float*>(a.kr),
      static_cast<const float*>(a.v), static_cast<const float*>(a.dout),
      a.row_m, a.row_delta, static_cast<float*>(dq), a.qcos, a.qsin,
      a.kmask, a.mask_rows, a.seq_q, a.seq_k, a.num_heads, a.scale,
      a.causal);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dkdv_fp32(const bwd::Args& a, void* dk, void* dv) {
  constexpr int bytes = dkdv_smem_bytes<float, D>();
  auto kernel = flash_bwd_online_dkdv_kernel<float, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.bh, (a.seq_k + kTile - 1) / kTile);
  kernel<<<grid, kThreads, bytes, a.stream>>>(
      static_cast<const float*>(a.qr), static_cast<const float*>(a.kr),
      static_cast<const float*>(a.v), static_cast<const float*>(a.dout),
      a.row_m, a.row_delta, static_cast<float*>(dk), static_cast<float*>(dv),
      a.kcos, a.ksin, a.kmask, a.mask_rows, a.seq_q, a.seq_k, a.num_heads,
      a.scale, a.causal);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dq_bf16(const bwd::Args& a, void* dq) {
  CUtensorMap m[4];
  if (!bwd::make_maps<D>(m, a)) return cudaErrorInvalidValue;
  if constexpr (D == 384)
    return bwd::launch_dq_sliced<false, D>(m, a, dq);
  else
    return bwd::launch_dq<false, D>(m, a, dq);
}

template <int D>
cudaError_t launch_dkdv_bf16(const bwd::Args& a, void* dk, void* dv) {
  CUtensorMap m[4];
  if (!bwd::make_maps<D>(m, a)) return cudaErrorInvalidValue;
  if constexpr (D == 384)
    return bwd::launch_dkdv_sliced<false, D>(m, a, dk, dv);
  else
    return bwd::launch_dkdv<false, D>(m, a, dk, dv);
}

template <typename T>
cudaError_t launch_rotate(const void* q, const void* k, void* qr, void* kr,
                          const void* qcos, const void* qsin,
                          const void* kcos, const void* ksin, int bh,
                          int seq_q, int seq_k, int d, int head_dim,
                          cudaStream_t stream) {
  const uintptr_t align =
      reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
      reinterpret_cast<uintptr_t>(qr) | reinterpret_cast<uintptr_t>(kr) |
      reinterpret_cast<uintptr_t>(qcos) | reinterpret_cast<uintptr_t>(qsin) |
      reinterpret_cast<uintptr_t>(kcos) | reinterpret_cast<uintptr_t>(ksin);
  if (align % 16 != 0) return cudaErrorMisalignedAddress;
  const long long q_vec = (long long)bh * seq_q * (d / 8);
  const long long k_vec = (long long)bh * seq_k * (d / 8);
  const long long blocks = (q_vec + k_vec + 255) / 256;
  const auto f = [](const void* p) { return static_cast<const float*>(p); };
  rotate_qk_kernel<T><<<(unsigned)blocks, 256, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<T*>(qr),
      static_cast<T*>(kr), f(qcos), f(qsin), f(kcos), f(ksin), q_vec, k_vec,
      seq_q * (d / 8), seq_k * (d / 8), d / 8, head_dim);
  return cudaGetLastError();
}

bwd::Args make_args(const void* qr, const void* kr, const void* v,
                    const void* dout, const void* lse, const void* delta,
                    const void* qcos, const void* qsin, const void* kcos,
                    const void* ksin, const void* kmask, int mask_rows,
                    int bh, int seq_q, int seq_k, int num_heads, float scale,
                    int causal, void* stream) {
  const auto f = [](const void* p) {
    return const_cast<float*>(static_cast<const float*>(p));
  };
  return bwd::Args{qr,        kr,        v,       dout,    f(lse),
                   nullptr,   f(delta),  f(qcos), f(qsin), f(kcos),
                   f(ksin),   f(kmask),  mask_rows, bh,    seq_q,
                   seq_k,     num_heads, scale,   causal,
                   static_cast<cudaStream_t>(stream)};
}

// The wide bodies' arguments (flash_wide.cuh): row_a the rows' lse, row_b
// their delta.
wide::Args wide_args(const bwd::Args& a, int d, int head_dim) {
  return wide::Args{a.qr,      a.kr,       a.v,      a.dout,      a.row_m,
                    a.row_delta, nullptr,  a.qcos,   a.qsin,      a.kcos,
                    a.ksin,    a.kmask,    a.mask_rows, a.bh,     a.seq_q,
                    a.seq_k,   d,          head_dim, a.num_heads, a.scale,
                    a.causal,  a.stream};
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. q, its rotation qr, dout and dq:
// (bh, seq_q, d); k, kr, v, dk, dv: (bh, seq_k, d); all contiguous; d = 64,
// 96, 128 or a multiple of 64 for K4 and K5, any multiple of 8 for the
// rotation pass; head_dim <= d the caller's head dim (an odd one wraps);
// lse, delta: (bh, seq_q) fp32; scratch: meant_flash_bwd_online_scratch_bytes
// of device memory (the chain body's at d = 768 in bf16; null when that is
// 0); tables: (seq_q | seq_k, d) fp32; kmask: (mask_rows, seq_k) fp32 or
// null.

// The bytes of scratch a K4, K5 or K4 + K5 call with these arguments
// needs: the chain body's (bf16 at d = 768, an even head dim), else 0.
extern "C" long long meant_flash_bwd_online_scratch_bytes(int dtype, int d,
                                                          int head_dim,
                                                          int bh, int seq_q,
                                                          int seq_k) {
  if (!wide::takes_chain(wide::kK4, dtype, d, head_dim)) return 0;
  return (long long)chain::scratch_bytes(bh, seq_q, seq_k);
}

// The rotation pass: qr = T(rot(q)), kr = T(rot(k)).
extern "C" int meant_rotate_qk(int dtype, const void* q, const void* k,
                               void* qr, void* kr, const void* qcos,
                               const void* qsin, const void* kcos,
                               const void* ksin, int bh, int seq_q,
                               int seq_k, int d, int head_dim,
                               void* stream) {
  if (bh <= 0 || seq_q <= 0 || seq_k <= 0 || d <= 0 || d % 8 != 0 ||
      head_dim <= 0 || head_dim > d || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
  return (int)(dtype == 0
                   ? launch_rotate<float>(q, k, qr, kr, qcos, qsin, kcos,
                                          ksin, bh, seq_q, seq_k, d,
                                          head_dim, s)
                   : launch_rotate<bf16>(q, k, qr, kr, qcos, qsin, kcos,
                                         ksin, bh, seq_q, seq_k, d, head_dim,
                                         s));
}

// K4: dq, from the rotated qr and kr; the adjoint reads qcos and qsin.
extern "C" int meant_flash_bwd_dq(int dtype, const void* qr, const void* kr,
                                  const void* v, const void* dout,
                                  const void* lse, const void* delta,
                                  void* dq, void* scratch, const void* qcos,
                                  const void* qsin, const void* kcos,
                                  const void* ksin, const void* kmask,
                                  int mask_rows, int bh, int seq_q,
                                  int seq_k, int d, int head_dim,
                                  int num_heads, float scale, int causal,
                                  void* stream) {
  const bwd::Args a = make_args(qr, kr, v, dout, lse, delta, qcos, qsin,
                                kcos, ksin, kmask, mask_rows, bh, seq_q,
                                seq_k, num_heads, scale, causal, stream);
  if (invalid(dtype, a) || head_dim <= 0 || head_dim > d)
    return (int)cudaErrorInvalidValue;
  if (wide::takes_wide(wide::kK4, dtype, d, head_dim)) {
    const wide::Args w = wide_args(a, d, head_dim);
    return (int)(dtype == 0 ? wide::launch_dq<float, false>(w, dq)
                            : wide::launch_dq<bf16, false>(w, dq));
  }
  if (wide::takes_chain(wide::kK4, dtype, d, head_dim))
    return (int)chain::launch<false>(a, dq, nullptr, nullptr, scratch,
                                     chain::kDq);
  // past 128 only bf16 at 192, 256 and 384 has a wgmma body (at 768 the
  // chain body); fp32 there is refused by dispatch_head_dim if takes_wide
  // ever lets it through
  if (dtype == 1 && d == 192) return (int)launch_dq_bf16<192>(a, dq);
  if (dtype == 1 && d == 256) return (int)launch_dq_bf16<256>(a, dq);
  if (dtype == 1 && d == 384) return (int)launch_dq_bf16<384>(a, dq);
  return (int)dispatch_head_dim(d, [&](auto built) {
    constexpr int D = decltype(built)::value;
    return dtype == 0 ? launch_dq_fp32<D>(a, dq) : launch_dq_bf16<D>(a, dq);
  });
}

// K5: dk and dv, from the rotated qr and kr; the adjoint reads kcos, ksin.
extern "C" int meant_flash_bwd_dkdv(int dtype, const void* qr, const void* kr,
                                    const void* v, const void* dout,
                                    const void* lse, const void* delta,
                                    void* dk, void* dv, void* scratch,
                                    const void* qcos,
                                    const void* qsin, const void* kcos,
                                    const void* ksin, const void* kmask,
                                    int mask_rows, int bh, int seq_q,
                                    int seq_k, int d, int head_dim,
                                    int num_heads, float scale, int causal,
                                    void* stream) {
  const bwd::Args a = make_args(qr, kr, v, dout, lse, delta, qcos, qsin,
                                kcos, ksin, kmask, mask_rows, bh, seq_q,
                                seq_k, num_heads, scale, causal, stream);
  if (invalid(dtype, a) || head_dim <= 0 || head_dim > d)
    return (int)cudaErrorInvalidValue;
  if (wide::takes_wide(wide::kK5, dtype, d, head_dim)) {
    const wide::Args w = wide_args(a, d, head_dim);
    return (int)(dtype == 0 ? wide::launch_dkdv<float, false>(w, dk, dv)
                            : wide::launch_dkdv<bf16, false>(w, dk, dv));
  }
  if (wide::takes_chain(wide::kK5, dtype, d, head_dim))
    return (int)chain::launch<false>(a, nullptr, dk, dv, scratch,
                                     chain::kDkdv);
  // past 128 only bf16 at 192, 256 and 384 has a wgmma body (as in K4)
  if (dtype == 1 && d == 192) return (int)launch_dkdv_bf16<192>(a, dk, dv);
  if (dtype == 1 && d == 256) return (int)launch_dkdv_bf16<256>(a, dk, dv);
  if (dtype == 1 && d == 384) return (int)launch_dkdv_bf16<384>(a, dk, dv);
  return (int)dispatch_head_dim(d, [&](auto built) {
    constexpr int D = decltype(built)::value;
    return dtype == 0 ? launch_dkdv_fp32<D>(a, dk, dv)
                      : launch_dkdv_bf16<D>(a, dk, dv);
  });
}

// K4 + K5 in one call, the streaming backward's entry on the main path:
// where the chain body takes them (bf16, d = 768, an even head dim) S and
// dP are formed once for dq, dk and dv, then the products of all three;
// at every other width K4's launch, then K5's.
extern "C" int meant_flash_bwd_online(int dtype, const void* qr,
                                      const void* kr, const void* v,
                                      const void* dout, const void* lse,
                                      const void* delta, void* dq, void* dk,
                                      void* dv, void* scratch,
                                      const void* qcos, const void* qsin,
                                      const void* kcos, const void* ksin,
                                      const void* kmask, int mask_rows,
                                      int bh, int seq_q, int seq_k, int d,
                                      int head_dim, int num_heads,
                                      float scale, int causal, void* stream) {
  if (!wide::takes_chain(wide::kK4, dtype, d, head_dim)) {
    const int err = meant_flash_bwd_dq(
        dtype, qr, kr, v, dout, lse, delta, dq, scratch, qcos, qsin, kcos,
        ksin, kmask, mask_rows, bh, seq_q, seq_k, d, head_dim, num_heads,
        scale, causal, stream);
    if (err) return err;
    return meant_flash_bwd_dkdv(
        dtype, qr, kr, v, dout, lse, delta, dk, dv, scratch, qcos, qsin,
        kcos, ksin, kmask, mask_rows, bh, seq_q, seq_k, d, head_dim,
        num_heads, scale, causal, stream);
  }
  const bwd::Args a = make_args(qr, kr, v, dout, lse, delta, qcos, qsin,
                                kcos, ksin, kmask, mask_rows, bh, seq_q,
                                seq_k, num_heads, scale, causal, stream);
  if (invalid(dtype, a) || head_dim <= 0 || head_dim > d)
    return (int)cudaErrorInvalidValue;
  return (int)chain::launch<false>(a, dq, dk, dv, scratch, chain::kAll);
}
