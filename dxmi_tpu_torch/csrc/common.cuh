// Shared pieces of the port's kernels: the GroupNorm statistics passes that
// K1 (groupnorm.cu), K3 (conv_fused.cu), K2 (attn_block.cu) and K5
// (attn_block_i8.cu) start from, the affine and SiLU they apply, bf16
// rounding, int8 quantisation, the tensor-core helpers (ldmatrix, mma.sync
// m16n8k16 bf16 and m16n8k32 s8, cp.async) of K2-K5 and K8, and the
// attention cores that K2 and K5 share: the flash-attention launch
// (flash_attn.cu, K4's kernel) and K2's fp32 core (attn_block.cu).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

typedef __nv_bfloat16 bf16;

// Per-(sample, group) mean and 1/sqrt(var + eps) of a channels-last
// (B, HW, C) fp32 tensor, two-pass in fp32 (the JAX package's default
// group_norm_silu_reference), written out per channel: mean_c and rstd_c
// are (B, C), so that a consumer reads them with the same 16-byte loads as
// x. Needs C / G <= 64. Defined in groupnorm.cu.
cudaError_t launch_gn_stats(const float* x, float* mean_c, float* rstd_c,
                            int B, int HW, int C, int G, float eps,
                            cudaStream_t stream);

// The same for a bf16 tensor. onepass == 0: two-pass fp32 statistics;
// onepass == 1: the bf16_onepass mode (s1 and s2 of bf16 x and bf16 x*x in
// fp32; mean, var + eps and the rsqrt each rounded to bf16).
cudaError_t launch_gn_stats_bf16(const bf16* x, float* mean_c, float* rstd_c,
                                 int B, int HW, int C, int G, float eps,
                                 int onepass, cudaStream_t stream);

// softmax(q k^T * sm_scale) v per (sample, head) for bf16 q, k, v whose
// rows (one per position) are row_stride elements apart, heads d apart
// within a row; o rows are out_row_stride apart. Needs S % 64 == 0,
// d % 8 == 0, d <= 128 and 16-byte aligned rows. Defined in flash_attn.cu.
cudaError_t launch_flash_attn(const bf16* q, const bf16* k, const bf16* v,
                              bf16* o, int B, int S, int nh, int d,
                              int row_stride, int out_row_stride,
                              float sm_scale, cudaStream_t stream);

// The fp32 attention core of K2: out = softmax(q k^T) v per (sample, head)
// on a (B, S, 3C) qkv buffer whose q and k are pre-scaled, into (B, S, C).
// Needs S % 64 == 0 and d = C / nh with d % 16 == 0, d <= 256. Defined in
// attn_block.cu.
cudaError_t launch_attn_core_f32(const float* qkv, float* out, int B, int S,
                                 int C, int nh, cudaStream_t stream);

// ((x - mean) * rstd) * scale + bias, the plain version's order.
__device__ __forceinline__ float4 gn_affine4(float4 v, float4 m, float4 r,
                                             float4 s, float4 b) {
  return make_float4((v.x - m.x) * r.x * s.x + b.x,
                     (v.y - m.y) * r.y * s.y + b.y,
                     (v.z - m.z) * r.z * s.z + b.z,
                     (v.w - m.w) * r.w * s.w + b.w);
}

__device__ __forceinline__ float silu(float t) { return t / (1.f + expf(-t)); }

__device__ __forceinline__ float4 ldg4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

// round to bf16 and back: the rounding XLA applies after each bf16 op
__device__ __forceinline__ float rb(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ unsigned int pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<unsigned int*>(&v);
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], unsigned addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_trans(unsigned (&r)[4], unsigned addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// d += a (16x16 bf16, row) * b (16x8 bf16, col), fp32 accumulators
__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a (16x32 s8, row) * b (32x8 s8, col), s32 accumulators: exact
__device__ __forceinline__ void mma_s8(int (&d)[4], const unsigned (&a)[4],
                                       unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// round half to even, clip to [-127, 127] (jnp.clip(jnp.round(v)) as int8)
__device__ __forceinline__ int quant_i8(float v) {
  return (int)fminf(fmaxf(rintf(v), -127.f), 127.f);
}

// four int8 values, lowest address first
__device__ __forceinline__ unsigned pack_s8x4(int a, int b, int c, int d) {
  return (unsigned)(a & 0xff) | ((unsigned)(b & 0xff) << 8) |
         ((unsigned)(c & 0xff) << 16) | ((unsigned)(d & 0xff) << 24);
}

// eight consecutive fp32 or bf16 elements as fp32 (16-byte aligned)
__device__ __forceinline__ void load8(const float* p, float (&v)[8]) {
  const float4 a = ldg4(p), b = ldg4(p + 4);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}
__device__ __forceinline__ void load8(const bf16* p, float (&v)[8]) {
  const uint4 r = __ldg(reinterpret_cast<const uint4*>(p));
  const bf16* e = reinterpret_cast<const bf16*>(&r);
#pragma unroll
  for (int j = 0; j < 8; ++j) v[j] = __bfloat162float(e[j]);
}

// 16-byte async copy; src_bytes == 0 writes zeros
__device__ __forceinline__ void cp_async16(unsigned dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
