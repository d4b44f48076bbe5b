// mbarriers and TMA (cp.async.bulk.tensor) for the kernels that stream their
// tiles from a producer thread: K4 (flash_attn.cu), the wide attention core
// of K2 and K7 bf16 (attn_core_wide.cu), the wgmma GEMMs of K2 bf16 and K5
// (tma_gemm.cuh) and K3's conv (conv_fused.cu).
#pragma once

#include <cuda.h>  // CUtensorMap and its enums (no link against libcuda)
#include <stdint.h>

#include "common.cuh"

__device__ __forceinline__ void mbar_init(unsigned bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count));
}
__device__ __forceinline__ void mbar_expect_tx(unsigned bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(unsigned bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}
// returns once the phase of the given parity has completed
__device__ __forceinline__ void mbar_wait(unsigned bar, unsigned parity) {
  asm volatile(
      "{\n.reg .pred P1;\nLAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\nbra LAB_WAIT;\nDONE:\n}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}
// one box of a 2-d, 3-d or 4-d tensor map into shared memory, completing on
// bar
__device__ __forceinline__ void tma_load_2d(unsigned dst, const CUtensorMap* map,
                                            unsigned bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}
__device__ __forceinline__ void tma_load_3d(unsigned dst, const CUtensorMap* map,
                                            unsigned bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2)
      : "memory");
}
__device__ __forceinline__ void tma_load_4d(unsigned dst, const CUtensorMap* map,
                                            unsigned bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

// one box of shared memory into a 2-d or 4-d tensor map (parts past the
// edge are not written), as part of this thread's bulk group
__device__ __forceinline__ void tma_store_2d(const CUtensorMap* map,
                                             unsigned src, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], "
      "[%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1)
      : "memory");
}
__device__ __forceinline__ void tma_store_4d(const CUtensorMap* map,
                                             unsigned src, int c0, int c1,
                                             int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%2, %3, "
      "%4, %5}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// returns once this thread's bulk stores have read their shared memory
// (READ) or have completed
template <bool READ>
__device__ __forceinline__ void bulk_wait() {
  if (READ)
    asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
  else
    asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// cuTensorMapEncodeTiled, reached through the runtime so that the library
// links without libcuda
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

inline EncodeTiledFn encode_tiled() {
  static const EncodeTiledFn fn = [] {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &f, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &f, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiledFn>(f)
               : nullptr;
  }();
  return fn;
}

// The (B, S, nh, d) view at base (rows row_stride elements apart, heads d
// apart) as a 4-d tensor map with boxes of box_cols columns of one head and
// box_rows rows; columns at or past d read as zeros.
inline bool encode_view(CUtensorMap* map, const bf16* base, int B, int S,
                        int nh, int d, int row_stride, int box_cols,
                        int box_rows, CUtensorMapSwizzle swizzle) {
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)d, (cuuint64_t)nh, (cuuint64_t)S,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)d * 2,
                                 (cuuint64_t)row_stride * 2,
                                 (cuuint64_t)S * row_stride * 2};
  const cuuint32_t box[4] = {(cuuint32_t)box_cols, 1, (cuuint32_t)box_rows,
                             1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<bf16*>(base),
            dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}
