// The wgmma GEMMs of K2's bf16 form (attn_block.cu) and of K5's
// (attn_block_i8.cu): C[M, N] = A[M, K] B on the Hopper tensor cores, then
// a per-element epilogue that each block defines (its roundings, bias,
// q/k scale or residual); and the pass that prepares their A operand once.
// They replace no TPU kernel of their own: they are the qkv and proj
// products of dxmi_tpu/ops/attn_block.py:225 _kernel and :353 _kernel_i8.
//
// A is (M, K) row-major (K-major), bf16 or int8: the activations, M = B S
// rows. B is the weight, small beside A: bf16 (K, N) row-major (N-major:
// wgmma reads it through its transpose flag) or int8 (N, K) row-major
// (K-major: int8 wgmma takes no transpose). C is bf16 (M, N). A tile is
// BM = 128 rows (64 per consumer warpgroup, wgmma m64nBNk16 bf16 -> fp32 or
// m64nBNk32 s8 -> s32) by BN = 192 or 256 columns. K runs in k-blocks of
// 128 bytes a row (64 bf16, 128 int8), one 128-byte swizzle span; TMA
// zero-fills the last past K in both operands, so its products add exact
// zeros, and reads zeros past M and N, where nothing is stored.
//
// Bound: at the ImageNet64 widths (K = C = 384-768, N = C or 3C) a GEMM
// moves about as many bytes as its products take on the tensor cores (K2's
// qkv at the 32x32 maps: 0.092 ms of bf16 products, 0.094 ms of h read and
// qkv written), and its epilogue is as long as its products. So:
//   - Loads: a producer warp issues every copy by TMA (cp.async.bulk.tensor)
//     into 128-byte-swizzled tiles, a ring as deep as shared memory allows
//     (4 stages at BN = 192, 3 at 256), guarded by full and empty
//     mbarriers; bf16 B arrives in boxes of 64 columns x 64 k-rows (those
//     wholly past N skipped), int8 B in one box of BN rows. Each consumer
//     warpgroup issues a k-block's four products as one wgmma group, keeps
//     one group in flight, and frees a stage when its group is done.
//   - Persistence: one block a SM walks over the tiles, N fastest so that
//     the blocks at work share their A rows in L2; the producer runs into
//     the next tile's k-blocks while the consumers run the epilogue.
//     Keeping a block's weight panel resident (only A streaming) measured
//     no faster on the H100, so B streams with A.
//   - Epilogue: each warpgroup rounds its 64 x BN sums in registers (paired
//     conversions), with the columns' parameters staged in shared memory
//     once a tile, writes them into a 128-byte-swizzled staging tile
//     (conflict-free), and one thread stores the tile by TMA; the proj's
//     residual tile arrives there by TMA while the first products run.
//     Scattered 4-byte global stores and per-element parameter loads had
//     taken two thirds of the GEMM's time.
//   - Tile width by wave count (pick_bn): at the 8x8 maps (M = 6400, 50 row
//     tiles) the qkv GEMM's 2304 columns take BN = 256, 450 tiles in 4
//     rounds of 132 SMs (192: 600 tiles in 5), its proj's 768 take 192,
//     200 tiles in 2 rounds; at the 32x32 maps (800 row tiles) both take
//     192 (4800 and 1600 tiles, 36.4 and 12.1 waves).
// Each output is one sum in the tensor cores' order, so a replay is
// bit-equal; no split-k, no atomics.
#pragma once

#include <type_traits>

#include "tma.cuh"

namespace tma_gemm {

constexpr int BM = 128;        // rows of a tile: 64 per consumer warpgroup
constexpr int KB = 128;        // bytes of a k-block row: the swizzle span
constexpr int kThreads = 384;  // consumer warpgroups 0 and 1, producer 2
constexpr unsigned A_TILE = BM * KB;

// a stage (A and B tiles); the epilogue's staging tile of a consumer
// warpgroup (64 rows x BN as BN / 64 boxes of 64 rows x 128 bytes); as many
// stages as fit in a block's 227 KB beside the staging, the column
// parameters, the 1024-byte alignment slack and the mbarriers
template <int BN>
__host__ __device__ constexpr unsigned stage_bytes() {
  return A_TILE + BN * KB;
}
template <int BN>
__host__ __device__ constexpr unsigned staging_bytes() {
  return BN / 64 * 64 * KB;
}
// the epilogue's column parameters of a tile, float2 a column, per
// consumer warpgroup
template <int BN>
__host__ __device__ constexpr unsigned cols_bytes() {
  return BN * 8;
}
template <int BN>
__host__ __device__ constexpr int stages() {
  return (232448 - 1024 - 256 - 2 * staging_bytes<BN>() -
          2 * cols_bytes<BN>()) /
         stage_bytes<BN>();
}
template <int BN>
__host__ __device__ constexpr int smem_bytes() {
  return 1024 + stages<BN>() * stage_bytes<BN>() + 2 * staging_bytes<BN>() +
         2 * cols_bytes<BN>() + 16 * stages<BN>() + 16;
}

template <bool I8>
using Acc = typename std::conditional<I8, int, float>::type;

// d (64 x BN) += one k-block's A (64 x 128 bytes) B (128 bytes x BN) as four
// products in one wgmma group: a fence, the products, the commit. A and B
// from shared memory (bf16: B through its transpose, MN-major).
template <bool I8, int BN>
__device__ __forceinline__ void wgmma_kblock(Acc<I8> (&d)[BN / 2],
                                             const uint64_t (&da)[4],
                                             const uint64_t (&db)[4]);

template <>
__device__ __forceinline__ void wgmma_kblock<false, 192>(
    float (&d)[96], const uint64_t (&da)[4], const uint64_t (&db)[4]) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
      "wgmma.fence.sync.aligned;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95}, %96, %100, p, 1, 1, 0, 1;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95}, %97, %101, p, 1, 1, 0, 1;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95}, %98, %102, p, 1, 1, 0, 1;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95}, %99, %103, p, 1, 1, 0, 1;\n"
      "wgmma.commit_group.sync.aligned;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
      : "l"(da[0]), "l"(da[1]), "l"(da[2]), "l"(da[3]), "l"(db[0]), "l"(db[1]), "l"(db[2]), "l"(db[3])
      : "memory");
}

template <>
__device__ __forceinline__ void wgmma_kblock<false, 256>(
    float (&d)[128], const uint64_t (&da)[4], const uint64_t (&db)[4]) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
      "wgmma.fence.sync.aligned;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, %128, %132, p, 1, 1, 0, 1;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, %129, %133, p, 1, 1, 0, 1;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, %130, %134, p, 1, 1, 0, 1;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, %131, %135, p, 1, 1, 0, 1;\n"
      "wgmma.commit_group.sync.aligned;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da[0]), "l"(da[1]), "l"(da[2]), "l"(da[3]), "l"(db[0]), "l"(db[1]), "l"(db[2]), "l"(db[3])
      : "memory");
}

template <>
__device__ __forceinline__ void wgmma_kblock<true, 192>(
    int (&d)[96], const uint64_t (&da)[4], const uint64_t (&db)[4]) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
      "wgmma.fence.sync.aligned;\n"
      "wgmma.mma_async.sync.aligned.m64n192k32.s32.s8.s8 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95}, %96, %100, p;\n"
      "wgmma.mma_async.sync.aligned.m64n192k32.s32.s8.s8 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95}, %97, %101, p;\n"
      "wgmma.mma_async.sync.aligned.m64n192k32.s32.s8.s8 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95}, %98, %102, p;\n"
      "wgmma.mma_async.sync.aligned.m64n192k32.s32.s8.s8 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95}, %99, %103, p;\n"
      "wgmma.commit_group.sync.aligned;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]), "+r"(d[64]), "+r"(d[65]), "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]), "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]), "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]), "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]), "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87]), "+r"(d[88]), "+r"(d[89]), "+r"(d[90]), "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95])
      : "l"(da[0]), "l"(da[1]), "l"(da[2]), "l"(da[3]), "l"(db[0]), "l"(db[1]), "l"(db[2]), "l"(db[3])
      : "memory");
}

template <>
__device__ __forceinline__ void wgmma_kblock<true, 256>(
    int (&d)[128], const uint64_t (&da)[4], const uint64_t (&db)[4]) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
      "wgmma.fence.sync.aligned;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, %128, %132, p;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, %129, %133, p;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, %130, %134, p;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, %131, %135, p;\n"
      "wgmma.commit_group.sync.aligned;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]), "+r"(d[64]), "+r"(d[65]), "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]), "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]), "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]), "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]), "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87]), "+r"(d[88]), "+r"(d[89]), "+r"(d[90]), "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95]), "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]), "+r"(d[100]), "+r"(d[101]), "+r"(d[102]), "+r"(d[103]), "+r"(d[104]), "+r"(d[105]), "+r"(d[106]), "+r"(d[107]), "+r"(d[108]), "+r"(d[109]), "+r"(d[110]), "+r"(d[111]), "+r"(d[112]), "+r"(d[113]), "+r"(d[114]), "+r"(d[115]), "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]), "+r"(d[120]), "+r"(d[121]), "+r"(d[122]), "+r"(d[123]), "+r"(d[124]), "+r"(d[125]), "+r"(d[126]), "+r"(d[127])
      : "l"(da[0]), "l"(da[1]), "l"(da[2]), "l"(da[3]), "l"(db[0]), "l"(db[1]), "l"(db[2]), "l"(db[3])
      : "memory");
}

struct Shape {
  int M, N, K, n_tiles, nt;  // nt: tiles along N
};

// Consumer threads: the epilogue u = epi(n, c0, c1, v0, v1, r) returns the
// bf16 pair of outputs (m, n), (m, n + 1) packed, from the columns'
// parameters c = epi.col(n), epi.col(n + 1) (float2 each, staged in shared
// memory per tile), their sums v (fp32 or s32) and, when epi.resid, the
// residual pair r packed as bf16 (from tr); the kernel stages u in shared
// memory and stores the tile to tc by TMA.
template <bool I8, int BN, class Epi>
__global__ void __launch_bounds__(kThreads, 1)
gemm_kernel(const __grid_constant__ CUtensorMap ta,
            const __grid_constant__ CUtensorMap tb,
            const __grid_constant__ CUtensorMap tc,
            const __grid_constant__ CUtensorMap tr, const Shape sh,
            const Epi epi) {
  constexpr int KE = I8 ? 128 : 64;  // elements of a k-block
  constexpr int NS = stages<BN>();
  constexpr unsigned SB = stage_bytes<BN>();
  extern __shared__ unsigned char smem_raw[];
  const unsigned base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const unsigned staging = base + NS * SB;
  const unsigned cols = staging + 2 * staging_bytes<BN>();
  const unsigned bars = cols + 2 * cols_bytes<BN>();
  auto a_s = [&](int s) { return base + s * SB; };
  auto b_s = [&](int s) { return base + s * SB + A_TILE; };
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (NS + s); };
  const int nk = (sh.K + KE - 1) / KE;
  // the warpgroup, broadcast from lane 0 so that ptxas sees it warp-uniform
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x >> 7, 0);
  const unsigned r_full = bars + 8 * (2 * NS + (wg & 1));  // residual in

  if (threadIdx.x == 0) {
    for (int s = 0; s < NS; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 2);
    }
    mbar_init(bars + 16 * NS, 1);
    mbar_init(bars + 16 * NS + 8, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {
    // producer: one thread issues every copy
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 256) {
      int it = 0;  // k-blocks so far
      for (int tile = blockIdx.x; tile < sh.n_tiles; tile += gridDim.x) {
        const int m0 = tile / sh.nt * BM, n0 = tile % sh.nt * BN;
        const int nbox = I8 ? 1 : min(BN / 64, (sh.N - n0 + 63) / 64);
        const unsigned bytes = A_TILE + (I8 ? BN : 64 * nbox) * KB;
        for (int kb = 0; kb < nk; ++kb, ++it) {
          const int s = it % NS;
          if (it >= NS)  // the consumers are done with k-block it - NS
            mbar_wait(empty(s), (it / NS - 1) & 1);
          mbar_expect_tx(full(s), bytes);
          tma_load_2d(a_s(s), &ta, full(s), kb * KE, m0);
          if (I8)
            tma_load_2d(b_s(s), &tb, full(s), kb * KE, n0);
          else
            for (int c = 0; c < nbox; ++c)
              tma_load_2d(b_s(s) + c * 64 * KB, &tb, full(s), n0 + 64 * c,
                          kb * KE);
        }
      }
    }
  } else {
    // consumer warpgroup wg: rows 64 wg .. + 63 of each tile; this thread
    // holds rows g and g + 8 of its warp's 16, columns 8 j + 2 t + {0, 1}
    // in d[4 j + {0, 1}] (row g) and d[4 j + {2, 3}] (row g + 8)
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int t = threadIdx.x & 127, warp = t >> 5, lane = t & 31;
    const unsigned stg = staging + wg * staging_bytes<BN>();
    float2* col = reinterpret_cast<float2*>(
        smem_raw + (cols - smem_u32(smem_raw)) + wg * cols_bytes<BN>());
    Acc<I8> acc[BN / 2];
    int it = 0, n_r = 0;  // k-blocks so far; residual tiles loaded
    for (int tile = blockIdx.x; tile < sh.n_tiles; tile += gridDim.x) {
      const int m0 = tile / sh.nt * BM, n0 = tile % sh.nt * BN;
      const int row0 = m0 + 64 * wg;  // this warpgroup's first row
      const int nbox = min(BN / 64, (sh.N - n0 + 63) / 64);
      const bool rows_in = row0 < sh.M;
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[i] = 0;
      for (int kb = 0; kb < nk; ++kb, ++it) {
        const int s = it % NS;
        mbar_wait(full(s), (it / NS) & 1);
        uint64_t da[4], db[4];
#pragma unroll
        for (int ks = 0; ks < 4; ++ks) {  // 32 bytes of k a product
          da[ks] = gmma_desc(a_s(s) + wg * 64 * KB + ks * 32, 16, 1024, 1);
          db[ks] = I8 ? gmma_desc(b_s(s) + ks * 32, 16, 1024, 1)
                      : gmma_desc(b_s(s) + ks * 16 * KB, 64 * KB, 1024, 1);
        }
        wgmma_kblock<I8, BN>(acc, da, db);
        if (kb == 0 && rows_in) {
          // while the first products run: the residual tile into the
          // staging boxes once the last tile's store has read them, and the
          // columns' parameters (the last tile's epilogue is done with them)
          if (epi.resid && t == 0) {
            bulk_wait<true>();
            mbar_expect_tx(r_full, nbox * 64 * KB);
            for (int c = 0; c < nbox; ++c)
              tma_load_2d(stg + c * 64 * KB, &tr, r_full, n0 + 64 * c, row0);
          }
          for (int c = t; c < BN; c += 128)
            col[c] = n0 + c < sh.N ? epi.col(n0 + c) : make_float2(0.f, 0.f);
        }
        // the previous k-block's group is done: its stage is free
        if (kb > 0) {
          wgmma_wait<1>();
          if (t == 0) mbar_arrive(empty((it - 1) % NS));
        }
      }
      wgmma_wait<0>();
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) fence_operand(acc[i]);
      if (t == 0) mbar_arrive(empty((it - 1) % NS));
      if (!rows_in) continue;  // warpgroup-uniform

      // the epilogue into the staging boxes (128-byte swizzle: 16-byte
      // chunk q of row r at chunk q ^ (r % 8)), then one TMA store a box
      if (epi.resid)
        mbar_wait(r_full, n_r++ & 1);
      else if (t == 0)
        bulk_wait<true>();
      asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
      // plain shared-memory accesses, which the compiler may reorder
      // against the epilogue's global loads
      const int g = lane >> 2;
      unsigned char* my = smem_raw + (stg - smem_u32(smem_raw)) +
                          (warp * 16 + g) * KB + 4 * (lane & 3);
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int n = n0 + 8 * j + 2 * (lane & 3);
        if (n < sh.N) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            unsigned* at = reinterpret_cast<unsigned*>(
                my + j / 8 * 64 * KB + 8 * h * KB + (((j % 8) ^ g) << 4));
            *at = epi(n, col[8 * j + 2 * (lane & 3)],
                      col[8 * j + 2 * (lane & 3) + 1], acc[4 * j + 2 * h],
                      acc[4 * j + 2 * h + 1], epi.resid ? *at : 0u);
          }
        }
      }
      fence_async_smem();
      asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
      if (t == 0) {
        for (int c = 0; c < nbox; ++c)
          tma_store_2d(&tc, stg + c * 64 * KB, n0 + 64 * c, row0);
        bulk_commit();
      }
    }
    if (t == 0) bulk_wait<false>();
  }
}

// A (rows, cols) row-major matrix of bf16 or int8 as a 2-d tensor map with
// boxes of box_rows rows by box_cols columns (128 bytes), 128-byte swizzle;
// boxes past the edge read zeros
inline bool encode_2d(CUtensorMap* map, bool i8, const void* base, int cols,
                      int rows, int box_cols, int box_rows) {
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * (i8 ? 1 : 2)};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  const cuuint32_t unit[2] = {1, 1};
  return fn(map,
            i8 ? CU_TENSOR_MAP_DATA_TYPE_UINT8
               : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
            2, const_cast<void*>(base), dims, strides, box, unit,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The tile width by wave count: each width's tiles over the SMs in whole
// waves, times the width plus a tile's fixed cost (its A rows, the ring's
// fill, ~64 columns' worth); the wider on a tie.
inline int pick_bn(int M, int N, int sms) {
  const long long mt = (M + BM - 1) / BM;
  long long best = -1;
  int bn = 256;
  const int widths[2] = {256, 192};
  for (int w : widths) {
    const long long tiles = mt * ((N + w - 1) / w);
    const long long cost = (tiles + sms - 1) / sms * (w + 64);
    if (best < 0 || cost < best) {
      best = cost;
      bn = w;
    }
  }
  return bn;
}

template <bool I8, int BN, class Epi>
cudaError_t launch_bn(const void* A, const void* B, void* C, const void* R,
                      int M, int N, int K, const Epi& epi, int sms,
                      cudaStream_t s) {
  constexpr int KE = I8 ? 128 : 64;
  CUtensorMap ta, tb, tc, tr;
  if (!encode_2d(&ta, I8, A, K, M, KE, BM) ||
      !(I8 ? encode_2d(&tb, true, B, K, N, KE, BN)
           : encode_2d(&tb, false, B, N, K, 64, KE)) ||
      !encode_2d(&tc, false, C, N, M, 64, 64) ||
      !encode_2d(&tr, false, R != nullptr ? R : C, N, M, 64, 64))
    return cudaErrorInvalidValue;
  const int nt = (N + BN - 1) / BN, n_tiles = (M + BM - 1) / BM * nt;
  const int smem = smem_bytes<BN>();
  const cudaError_t err = cudaFuncSetAttribute(
      gemm_kernel<I8, BN, Epi>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  gemm_kernel<I8, BN, Epi><<<n_tiles < sms ? n_tiles : sms, kThreads, smem,
                             s>>>(ta, tb, tc, tr,
                                  Shape{M, N, K, n_tiles, nt}, epi);
  return cudaGetLastError();
}

// C = A B through epi into the bf16 (M, N) C, with the bf16 (M, N)
// residual R when epi.resid: A (M, K), B (K, N) bf16 or (N, K) int8 (I8),
// all row-major, 16-byte aligned, rows a multiple of 16 bytes.
template <bool I8, class Epi>
cudaError_t launch(const void* A, const void* B, void* C, const void* R,
                   int M, int N, int K, const Epi& epi, cudaStream_t s) {
  const int es = I8 ? 1 : 2;
  if (((uintptr_t)A | (uintptr_t)B | (uintptr_t)C | (uintptr_t)R) % 16 ||
      K * es % 16 || N * 2 % 16 || M <= 0 || N <= 0 || K <= 0 ||
      epi.resid != (R != nullptr))
    return cudaErrorInvalidValue;
  int dev, sms;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  return pick_bn(M, N, sms) == 256
             ? launch_bn<I8, 256>(A, B, C, R, M, N, K, epi, sms, s)
             : launch_bn<I8, 192>(A, B, C, R, M, N, K, epi, sms, s);
}

// The A operand, prepared once for all of its N tiles: h = x (gs rstd) +
// (gb - mean gs rstd) with per-(sample, channel) statistics (GN; else
// h = x), each operation rounded in fp32 as the plain versions round it,
// written as bf16, or (I8) quantised round(h isa) clipped to +-127 as int8.
// x (B, S, C) bf16. Block (i, b) takes rows i kPrepRows .. of sample b; a
// thread keeps 8 channels' factors and walks their rows, C / 8 threads a
// row.
constexpr int kPrepRows = 16, kPrepThreads = 256;

template <bool GN, bool I8>
__global__ void __launch_bounds__(kPrepThreads)
prep_kernel(const bf16* __restrict__ x, void* __restrict__ out,
            const float* __restrict__ mean_c, const float* __restrict__ rstd_c,
            const float* __restrict__ gs, const float* __restrict__ gb,
            const float* __restrict__ isa, int S, int C) {
  const int c8 = C / 8, rows_at_once = kPrepThreads / c8;
  const int r0 = threadIdx.x / c8, k = (threadIdx.x - r0 * c8) * 8;
  if (r0 >= rows_at_once) return;
  const int b = blockIdx.y;
  float sc[8], sh[8], is[8];
#pragma unroll
  for (int j = 0; j < 8; j += 4) {
    if (GN) {
      const float4 g4 = ldg4(gs + k + j), b4 = ldg4(gb + k + j);
      const float4 m4 = ldg4(mean_c + (size_t)b * C + k + j);
      const float4 r4 = ldg4(rstd_c + (size_t)b * C + k + j);
      const float gv[4] = {g4.x, g4.y, g4.z, g4.w},
                  bv[4] = {b4.x, b4.y, b4.z, b4.w},
                  mv[4] = {m4.x, m4.y, m4.z, m4.w},
                  rv[4] = {r4.x, r4.y, r4.z, r4.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        sc[j + e] = __fmul_rn(gv[e], rv[e]);
        sh[j + e] = __fsub_rn(bv[e], __fmul_rn(mv[e], sc[j + e]));
      }
    }
    if (I8) {
      const float4 i4 = ldg4(isa + k + j);
      is[j] = i4.x;
      is[j + 1] = i4.y;
      is[j + 2] = i4.z;
      is[j + 3] = i4.w;
    }
  }
  const int r_end = min(S, (blockIdx.x + 1) * kPrepRows);
#pragma unroll 4
  for (int r = blockIdx.x * kPrepRows + r0; r < r_end; r += rows_at_once) {
    const size_t o = ((size_t)b * S + r) * C + k;
    float v[8];
    load8(x + o, v);
#pragma unroll
    for (int j = 0; j < 8; ++j)
      if (GN) v[j] = __fadd_rn(__fmul_rn(v[j], sc[j]), sh[j]);
    if (I8) {
      int q[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) q[j] = quant_i8(__fmul_rn(v[j], is[j]));
      *reinterpret_cast<uint2*>(static_cast<int8_t*>(out) + o) =
          make_uint2(pack_s8x4(q[0], q[1], q[2], q[3]),
                     pack_s8x4(q[4], q[5], q[6], q[7]));
    } else {
      *reinterpret_cast<uint4*>(static_cast<bf16*>(out) + o) =
          make_uint4(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]),
                     pack_bf16(v[4], v[5]), pack_bf16(v[6], v[7]));
    }
  }
}

template <bool GN, bool I8>
cudaError_t launch_prep(const bf16* x, void* out, const float* mean_c,
                        const float* rstd_c, const float* gs, const float* gb,
                        const float* isa, int B, int S, int C,
                        cudaStream_t s) {
  if (C % 8 || C / 8 > kPrepThreads) return cudaErrorInvalidValue;
  prep_kernel<GN, I8>
      <<<dim3((S + kPrepRows - 1) / kPrepRows, B), kPrepThreads, 0, s>>>(
          x, out, mean_c, rstd_c, gs, gb, isa, S, C);
  return cudaGetLastError();
}

}  // namespace tma_gemm
