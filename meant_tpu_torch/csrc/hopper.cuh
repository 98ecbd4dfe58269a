// Hopper (sm_90a) building blocks of the flash kernels' bf16 bodies (the
// forwards K1 and K3 in flash_fwd.cu; the backwards K2, K4 and K5 through
// flash_bwd_wgmma.cuh): mbarriers, TMA tile loads through a tensor map and
// the host code that encodes one, and warpgroup matrix products (wgmma) on
// operands in shared memory laid out with the 64-byte swizzle.
//
// Tile layout. A [64 rows][D columns] bf16 tile (D = 64, 96, 128, 192 or
// 256, the head dim; 384 or 768 for the forward's Qr, whose Kr and V come
// in 192- or 384-column slices) lives in shared memory as D / 32 boxes of
// [64][32] (4096 bytes each, columns 0-31, 32-63, ...),
// each written by one TMA load with CU_TENSOR_MAP_SWIZZLE_64B: rows of 64
// bytes, the 16-byte chunk c of row r stored at chunk c ^ ((r >> 1) & 3).
// wgmma reads the same bytes two ways (its descriptor's 64-byte swizzle):
//   * K-major (the D columns are the depth K): rows 64 bytes apart, eight-
//     row groups 512 bytes apart (SBO); the k-th 16-column step starts
//     (k / 2) boxes and (k % 2) * 32 bytes in;
//   * MN-major (the 64 rows are the depth K, the columns are N): 32 columns
//     per box, boxes 4096 bytes apart (LBO), eight-row groups 512 bytes
//     apart (SBO); the k-th 16-row step starts k * 1024 bytes in, and the
//     product's transpose-B bit is set; the columns from a box boundary
//     on (a warpgroup's share of the gradient's columns) start that many
//     boxes in.
// So one copy of a row-major tile serves as both Q K^T's K-major operand
// and P V's (or dS K's) MN-major operand; no transposed copy is written.
//
// The tensor maps come from cuTensorMapEncodeTiled, reached through
// cudaGetDriverEntryPoint: the libraries link nothing but the runtime. A
// 3-D map over (bh, s, D) zero-fills rows past s within each head, where
// cp.async would need the fill and the swizzle written by hand.

#pragma once

#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace meant {
namespace hopper {

constexpr int kKMajor = 0, kMNMajor = 1;  // wgmma's transpose bit
constexpr int kRows = 64;                  // rows of a tile
constexpr int kBoxCols = 32;               // bf16 columns of a box (64 B)
constexpr int kBoxBytes = kRows * kBoxCols * 2;

// The widths of the tiles the bodies hold (the head dims they are
// instantiated for), and the bytes of one [64][D] tile: D / 32 boxes.
template <int D>
__host__ __device__ constexpr int tile_bytes() {
  static_assert(D == 64 || D == 96 || D == 128 || D == 192 || D == 256 ||
                    D == 384 || D == 768,
                "tile width 64, 96, 128, 192, 256, 384 or 768");
  return D / kBoxCols * kBoxBytes;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Dynamic shared memory from a 1024-byte boundary (the TMA boxes' and
// wgmma's swizzle pattern is a function of the address).
template <typename S>
__device__ __forceinline__ S& aligned_smem(uint8_t* raw) {
  const uint32_t pad = (1024 - (smem_u32(raw) & 1023)) & 1023;
  return *reinterpret_cast<S*>(raw + pad);
}

// Dynamic shared memory to ask for a struct S placed by aligned_smem.
template <typename S>
constexpr int smem_bytes() {
  return (int)sizeof(S) + 1024;
}

template <int N>
__device__ __forceinline__ void zero_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) r[i] = 0.f;
}

// The registers a thread of the issuing warpgroup may hold from here on:
// setmaxnreg gives them back to the block's pool (dec) or takes them from
// it (inc), waiting until the pool has them. Every warp of the warpgroup
// executes it.
template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

// Waits at named barrier `id` (1-15; __syncthreads takes 0) until `threads`
// threads, a multiple of 32, have reached it: a subset of the block, such
// as its consumer warpgroups once the producer has left.
__device__ __forceinline__ void named_barrier_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// ---- mbarriers --------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

// Makes the barriers' initialisation visible to the async proxy (TMA).
__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// Arrives and adds `bytes` to the transaction count the phase waits for.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// Waits until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

// ---- TMA --------------------------------------------------------------------

// One box of a 3-D tensor map (columns, rows, batch) into shared memory;
// completion is counted on `bar`. Elements outside the tensor are zero.
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2)
      : "memory");
}

// Rows [row0, row0 + 64) and columns [col0, col0 + W) of head `bh` of a
// (bh, seq, d) bf16 tensor as one [64][W] tile (W / 32 boxes);
// tile_bytes<W>() bytes counted on `bar`.
template <int W>
__device__ __forceinline__ void tma_load_cols(uint8_t* tile,
                                              const CUtensorMap* map,
                                              uint64_t* bar, int col0,
                                              int row0, int bh) {
#pragma unroll
  for (int b = 0; b < W / kBoxCols; ++b)
    tma_load_3d(tile + b * kBoxBytes, map, bar, col0 + b * kBoxCols, row0,
                bh);
}

// Rows [row0, row0 + 64) of head `bh` of a (bh, seq, D) bf16 tensor as one
// tile (D / 32 boxes); tile_bytes<D>() bytes counted on `bar`.
template <int D>
__device__ __forceinline__ void tma_load_tile(uint8_t* tile,
                                              const CUtensorMap* map,
                                              uint64_t* bar, int row0,
                                              int bh) {
  tma_load_cols<D>(tile, map, bar, 0, row0, bh);
}

// ---- wgmma ------------------------------------------------------------------

// Shared-memory matrix descriptor, 64-byte swizzle: start address, leading
// and stride byte offsets (all in 16-byte units), layout type 2.
__device__ __forceinline__ uint64_t sw64_desc(const void* p, uint32_t lbo,
                                              uint32_t sbo) {
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (2ull << 62);
}

// The k-th 16-column depth step of a tile read K-major.
__device__ __forceinline__ uint64_t kmajor_desc(const uint8_t* tile, int k) {
  return sw64_desc(tile + (k >> 1) * kBoxBytes + (k & 1) * 32, 16, 512);
}

// The k-th 16-row depth step of a tile read MN-major (N = the D columns).
__device__ __forceinline__ uint64_t mnmajor_desc(const uint8_t* tile, int k) {
  return sw64_desc(tile + k * 16 * 2 * kBoxCols, kBoxBytes, 512);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving reads or writes of registers that an
// asynchronous wgmma still uses across the wait that ends it.
template <int R>
__device__ __forceinline__ void fence_regs(float (&r)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

template <int M, int R>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[M][R]) {
#pragma unroll
  for (int m = 0; m < M; ++m)
#pragma unroll
    for (int i = 0; i < R; ++i) asm volatile("" : "+r"(r[m][i])::"memory");
}

// D (64 x 64, fp32) = A * B^T (+ D when scale_d), A (64 x 16) and B
// (64 x 16) both K-major in shared memory, given by their descriptors.
__device__ __forceinline__ void wgmma_m64n64k16_ss(float (&d)[32], uint64_t a,
                                                   uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(scale_d));
}

// D (64 x N, fp32) += A * B, A (64 x 16 bf16) in registers as four
// mma.sync-style A fragments, B (16 x N) in shared memory: K-major
// (TransB = kKMajor) or MN-major (kMNMajor) as its descriptor says. One
// instruction per N the bodies need (64, 96, 128, 192, 256).
template <int TransB>
__device__ __forceinline__ void wgmma_m64n64k16_rs(float (&d)[32],
                                                   const uint32_t (&a)[4],
                                                   uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1),
        "n"(TransB));
}

template <int TransB>
__device__ __forceinline__ void wgmma_m64n96k16_rs(float (&d)[48],
                                                   const uint32_t (&a)[4],
                                                   uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47"
      "}, {%48, %49, %50, %51}, %52, p, 1, 1, %54;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1),
        "n"(TransB));
}

template <int TransB>
__device__ __forceinline__ void wgmma_m64n128k16_rs(float (&d)[64],
                                                    const uint32_t (&a)[4],
                                                    uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1),
        "n"(TransB));
}

template <int TransB>
__device__ __forceinline__ void wgmma_m64n192k16_rs(float (&d)[96],
                                                    const uint32_t (&a)[4],
                                                    uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %101, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, "
      "%84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95"
      "}, {%96, %97, %98, %99}, %100, p, 1, 1, %102;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
        "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]),
        "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]),
        "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]),
        "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]),
        "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), "+f"(d[80]),
        "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]),
        "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]),
        "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1),
        "n"(TransB));
}

template <int TransB>
__device__ __forceinline__ void wgmma_m64n256k16_rs(float (&d)[128],
                                                    const uint32_t (&a)[4],
                                                    uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, "
      "%84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, "
      "%106, %107, %108, %109, %110, %111, %112, %113, %114, %115, "
      "%116, %117, %118, %119, %120, %121, %122, %123, %124, %125, "
      "%126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, %134;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
        "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]),
        "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]),
        "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]),
        "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]),
        "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), "+f"(d[80]),
        "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]),
        "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]),
        "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]),
        "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]),
        "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]),
        "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), "+f"(d[120]),
        "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]),
        "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1),
        "n"(TransB));
}

// The product above at N = the columns a warpgroup holds of an
// output or a gradient.
template <int N, int TransB>
__device__ __forceinline__ void wgmma_m64nNk16_rs(float (&d)[N / 2],
                                                  const uint32_t (&a)[4],
                                                  uint64_t b) {
  static_assert(N == 64 || N == 96 || N == 128 || N == 192 || N == 256,
                "no wgmma for this N");
  if constexpr (N == 64)
    wgmma_m64n64k16_rs<TransB>(d, a, b);
  else if constexpr (N == 96)
    wgmma_m64n96k16_rs<TransB>(d, a, b);
  else if constexpr (N == 128)
    wgmma_m64n128k16_rs<TransB>(d, a, b);
  else if constexpr (N == 192)
    wgmma_m64n192k16_rs<TransB>(d, a, b);
  else
    wgmma_m64n256k16_rs<TransB>(d, a, b);
}

// ---- tensor maps (host) -------------------------------------------------------

// The driver function `name` (CUDA 12.0's), or null.
inline void* driver_entry(const char* name) {
  void* p = nullptr;
  cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
  const cudaError_t err = cudaGetDriverEntryPointByVersion(
      name, &p, 12000, cudaEnableDefault, &found);
#else
  const cudaError_t err =
      cudaGetDriverEntryPoint(name, &p, cudaEnableDefault, &found);
#endif
  return err == cudaSuccess && found == cudaDriverEntryPointSuccess ? p
                                                                    : nullptr;
}

inline PFN_cuTensorMapEncodeTiled_v12000 tensor_map_encoder() {
  static const auto fn = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(
      driver_entry("cuTensorMapEncodeTiled"));
  return fn;
}

// Makes the context of the device memory at ptr current in the calling
// thread where none is: the tensor-map encoder needs a current context,
// and a launch can come from a thread that has made none current (the
// autograd engine's worker of the first device, where a library's first
// encoding returned CUDA_ERROR_INVALID_CONTEXT; PERF.md).
inline void ensure_context(const void* ptr) {
  using CtxGet = CUresult (*)(CUcontext*);
  using CtxSet = CUresult (*)(CUcontext);
  using PtrAttr = CUresult (*)(void*, CUpointer_attribute, CUdeviceptr);
  static const auto get =
      reinterpret_cast<CtxGet>(driver_entry("cuCtxGetCurrent"));
  static const auto set =
      reinterpret_cast<CtxSet>(driver_entry("cuCtxSetCurrent"));
  static const auto attr =
      reinterpret_cast<PtrAttr>(driver_entry("cuPointerGetAttribute"));
  CUcontext cur = nullptr;
  if (get == nullptr || set == nullptr || attr == nullptr ||
      (get(&cur) == CUDA_SUCCESS && cur != nullptr))
    return;
  CUcontext ctx = nullptr;
  if (attr(&ctx, CU_POINTER_ATTRIBUTE_CONTEXT,
           reinterpret_cast<CUdeviceptr>(ptr)) == CUDA_SUCCESS &&
      ctx != nullptr)
    set(ctx);
}

// A (bh, seq, d) bf16 tensor as a 3-D tensor map of [64 rows][32 columns]
// boxes with the 64-byte swizzle; reads outside it give zeros.
inline bool make_map(CUtensorMap* map, const void* ptr, int bh, int seq,
                     int d) {
  const auto encode = tensor_map_encoder();
  if (encode == nullptr || reinterpret_cast<uintptr_t>(ptr) % 16 != 0)
    return false;
  ensure_context(ptr);
  const cuuint64_t dims[3] = {(cuuint64_t)d, (cuuint64_t)seq,
                              (cuuint64_t)bh};
  const cuuint64_t strides[2] = {
      d * sizeof(__nv_bfloat16),
      (cuuint64_t)seq * d * sizeof(__nv_bfloat16)};
  const cuuint32_t box[3] = {kBoxCols, kRows, 1};
  const cuuint32_t elem_strides[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                const_cast<void*>(ptr), dims, strides, box, elem_strides,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_64B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace hopper
}  // namespace meant
