// Shared pieces of the port's kernels: the GroupNorm statistics passes that
// K1 (groupnorm.cu), K3 (conv_fused.cu), K2 (attn_block.cu and, fp32,
// attn_block_bb.cu), K5 (attn_block_i8.cu) and K6 (attn_block_bwd.cu) start
// from, the element helpers that K7 (attn_block_bb.cu) uses too, K1's apply
// launch that K6 reuses, the affine and SiLU they apply, bf16 rounding,
// int8 quantisation, the tensor-core helpers (ldmatrix, mma.sync m16n8k16
// bf16 and m16n8k32 s8, cp.async) of K3-K7 and K8, the wgmma helpers of K4,
// K8 and the GEMMs of K2 bf16 and K5 (tma_gemm.cuh), K6's mma.sync GEMM
// (attn_block.cu), the attention cores that K2 and K5 share (the
// flash-attention launch, flash_attn.cu, K4's kernel, and the fp32 SIMT
// core of K5's fp32 form, attn_block.cu), and the attention backward that
// K4-dkv, K4-dq and K6 share: its launches (flash_attn_bwd.cu) and the tile
// loads and dot products of their kernels; and the wide attention core,
// K2's and K7's bf16 core at d > 128 (attn_core_wide.cu).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

// Per-(sample, group) mean and 1/sqrt(var + eps) of a channels-last
// (B, HW, C) fp32 tensor, two-pass in fp32 (the JAX package's default
// group_norm_silu_reference), written out per channel: mean_c and rstd_c
// are (B, C), so that a consumer reads them with the same 16-byte loads as
// x. K1's statistics pass on the route gn_plan chooses (a slice held in a
// cluster's shared memory, x read once, or streamed); cudaErrorInvalidValue
// for a shape neither route takes. Defined in groupnorm.cu.
cudaError_t launch_gn_stats(const float* x, float* mean_c, float* rstd_c,
                            int B, int HW, int C, int G, float eps,
                            cudaStream_t stream);

// The same for a bf16 tensor. onepass == 0: two-pass fp32 statistics;
// onepass == 1: the bf16_onepass mode (s1 and s2 of bf16 x and bf16 x*x in
// fp32; mean, var + eps and the rsqrt each rounded to bf16); onepass == 2:
// one-pass fp32 statistics of the widened x (s1 and s2 of x and x*x in fp32,
// var = s2/n - mean^2, nothing rounded), as K3's TPU body takes them.
cudaError_t launch_gn_stats_bf16(const bf16* x, float* mean_c, float* rstd_c,
                                 int B, int HW, int C, int G, float eps,
                                 int onepass, cudaStream_t stream);

// y = ((x - mean) rstd) scale + bias (then SiLU when silu != 0) on a
// channels-last (B, HW, C) tensor with the statistics per (sample, channel)
// that launch_gn_stats writes: K1's apply kernels. fp32: C % 4 == 0; bf16
// (C % 8 == 0): stepwise == 0 takes fp32 arithmetic in the plain version's
// order, rounded once; stepwise == 1 rounds every operation to bf16
// (bf16_onepass). 16-byte aligned tensors. Defined in groupnorm.cu.
cudaError_t launch_gn_apply(const float* x, const float* scale,
                            const float* bias, const float* mean_c,
                            const float* rstd_c, float* y, int B, int HW,
                            int C, int silu, cudaStream_t stream);
cudaError_t launch_gn_apply(const bf16* x, const float* scale,
                            const float* bias, const float* mean_c,
                            const float* rstd_c, bf16* y, int B, int HW,
                            int C, int silu, int stepwise,
                            cudaStream_t stream);

// softmax(q k^T * sm_scale) v per (sample, head) for bf16 q, k, v whose
// rows (one per position) are row_stride elements apart, heads d apart
// within a row; o rows are out_row_stride apart; lse, when not null, gets
// each row's logsumexp of the scaled logits, (B, nh, S) fp32. Needs
// S % 64 == 0, d % 8 == 0, d <= 128 and 16-byte aligned rows. Defined in
// flash_attn.cu.
cudaError_t launch_flash_attn(const bf16* q, const bf16* k, const bf16* v,
                              bf16* o, float* lse, int B, int S, int nh, int d,
                              int row_stride, int out_row_stride,
                              float sm_scale, cudaStream_t stream);

// The wide attention core (attn_core_wide.cu) on a (B, S, 3C) bf16 qkv
// buffer whose q and k are pre-scaled, into (B, S, C): per (sample, head)
// an fp32 softmax over whole key rows, p normalised then rounded to bf16,
// AV summed in fp32 and rounded; two passes over the keys on wgmma. K2 and
// K7 in bf16 run it at d > 128. Needs S % 64 == 0 and d = C / nh with
// 128 < d <= 256, d % 8 == 0, and a 16-byte aligned qkv.
cudaError_t launch_attn_core_wide(const bf16* qkv, bf16* attn, int B, int S,
                                  int C, int nh, cudaStream_t stream);

// The fp32 SIMT attention core of K5's fp32 form: out = softmax(q k^T) v
// per (sample, head) on a (B, S, 3C) qkv buffer whose q and k are
// pre-scaled, into (B, S, C). Needs S % 64 == 0 and d = C / nh with
// d % 16 == 0, d <= 256. Defined in attn_block.cu.
cudaError_t launch_attn_core_f32(const float* qkv, float* out, int B, int S,
                                 int C, int nh, cudaStream_t stream);

// qkv = h W_qkv + b_qkv with the q and k columns (the first 2C) scaled by
// qk_scale on an already normalised h (M, C), rounded as K2 rounds in each
// dtype (fp32: a SIMT GEMM; bf16: K6's mma.sync GEMM). K6 recomputes the
// forward with it. Needs C % 32 == 0. Defined in attn_block.cu.
cudaError_t launch_qkv_gemm(const float* h, const float* w, const float* b,
                            float* qkv, int M, int C, float qk_scale,
                            cudaStream_t stream);
cudaError_t launch_qkv_gemm(const bf16* h, const bf16* w, const bf16* b,
                            bf16* qkv, int M, int C, float qk_scale,
                            cudaStream_t stream);

// The attention backward of K4 and K6 (flash_attn_bwd.cu), per (sample,
// head) on strided rows: p = exp(q.k * sm_scale - lse) in fp32,
// dv = sum_q T(p) dout, dp = dout.v, ds = T((dp - di) p * sm_scale),
// dk = sum_q ds q, dq = sum_k ds k (T() rounds to the element type), dq and
// dk times out_scale_qk at the end. Row strides are in elements, head h
// starts at column h * d; lse and di are (B, nh, S). Each output pointer may
// be null; the fp32 ones get the sums, the T ones the same rounded to T.
template <typename T>
struct AttnBwdArgs {
  const T* q;
  const T* k;
  const T* v;
  const T* dout;
  const float* lse;
  const float* di;
  float* dq_f;
  float* dk_f;
  float* dv_f;
  T* dq_t;
  T* dk_t;
  T* dv_t;
  int in_stride, dout_stride, out_stride;
  int S, nh, d;
  float sm_scale, out_scale_qk;
};

// dk and dv (one block per 64 keys) and dq (one block per 64 query rows).
// Need S % 64 == 0, d % 4 == 0, d <= 64 and strides that are multiples of 4.
// The bf16 launches run on the tensor cores, the fp32 ones SIMT fp32.
template <typename T>
cudaError_t launch_attn_bwd_dkv(const AttnBwdArgs<T>& a, int B,
                                cudaStream_t stream);
template <typename T>
cudaError_t launch_attn_bwd_dq(const AttnBwdArgs<T>& a, int B,
                               cudaStream_t stream);

// C = op(A) op(B) on the tensor cores (K6's mma.sync GEMM, attn_block.cu), bf16
// operands and fp32 sums: A (M, K) rows, or (K, M) when a_trans; B (K, N)
// rows, or (N, K) when b_trans. The K rows are taken in slices of k_chunk,
// slice z written at c_f + z M N; the sums go to c_f in fp32, or to c_t
// rounded to bf16 (exactly one of the two non-null). Layouts: (A, B^T)
// into either, (A^T, B) into fp32. Needs K % 32 == 0, k_chunk % 32 == 0,
// M % 8 == 0, N % 8 == 0 and 16-byte aligned operands.
cudaError_t launch_hgemm(const bf16* A, const bf16* B, float* c_f, bf16* c_t,
                         int M, int N, int K, int k_chunk, bool a_trans,
                         bool b_trans, cudaStream_t stream);

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

// 2^x on the special-function unit (2 ulp; the softmax exponentials of K4
// and the wide attention core)
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// round to bf16 and back: the rounding XLA applies after each bf16 op
__device__ __forceinline__ float rb(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ unsigned int pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<unsigned int*>(&v);
}

// lo and hi rounded to bf16 and back with one paired conversion (the
// single conversions run at a quarter of the rate); returns them packed
__device__ __forceinline__ unsigned rb2(float& lo, float& hi) {
  const unsigned u = pack_bf16(lo, hi);
  lo = __uint_as_float(u << 16);
  hi = __uint_as_float(u & 0xffff0000u);
  return u;
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// ---- thread-block clusters (K1's on-chip route, K6 fp32's small maps) ----
__device__ __forceinline__ int cluster_rank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return (int)r;
}
__device__ __forceinline__ int cluster_ctas() {
  unsigned n;
  asm volatile("mov.u32 %0, %%cluster_nctarank;\n" : "=r"(n));
  return (int)n;
}
// every thread of every CTA of the cluster arrives, then waits; a thread's
// shared-memory writes before its arrive are seen after the wait
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}
// *p in the shared memory of the cluster's CTA `rank`
__device__ __forceinline__ float ld_rank(const float* p, int rank) {
  unsigned addr;
  float v;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(addr)
               : "r"(smem_u32(p)), "r"(rank));
  asm volatile("ld.shared::cluster.f32 %0, [%1];\n"
               : "=f"(v)
               : "r"(addr)
               : "memory");
  return v;
}
// the 16 bytes at p in the shared memory of the cluster's CTA `rank`
__device__ __forceinline__ float4 ld4_rank(const float* p, int rank) {
  unsigned addr;
  float4 v;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(addr)
               : "r"(smem_u32(p)), "r"(rank));
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(addr)
               : "memory");
  return v;
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

// element-type helpers of the kernels generic in fp32 / bf16
__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store_as(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_as(bf16* p, float v) {
  *p = __float2bfloat16_rn(v);
}
// v rounded to T and back (the identity for fp32)
template <typename T>
__device__ __forceinline__ float round_t(float v);
template <>
__device__ __forceinline__ float round_t<float>(float v) { return v; }
template <>
__device__ __forceinline__ float round_t<bf16>(float v) { return rb(v); }
// four consecutive elements as fp32 (16-byte fp32 / 8-byte bf16 aligned)
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const bf16* p) {
  const uint2 r = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&r.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&r.y));
  return make_float4(a.x, a.y, b.x, b.y);
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

// ---- wgmma (K4, K8, tma_gemm.cuh) ------------------------------------
// A wgmma matrix descriptor: start address, lbo and sbo in bytes, and the
// swizzle (0: none, 1: 128-byte, 2: 64-byte). Without swizzle the operand
// is K-major core matrices of 8 rows x 16 bytes, stored as 128 contiguous
// bytes: lbo = bytes between the two 16-byte halves of a 32-byte k-step,
// sbo = bytes between 8-row groups. With swizzle, sbo = bytes between 8-row
// (K-major) or 8-k-row (MN-major) groups, lbo = bytes between the swizzle
// spans of an MN-major operand (unused K-major).
__device__ __forceinline__ uint64_t gmma_desc(unsigned addr, unsigned lbo,
                                              unsigned sbo,
                                              uint64_t swizzle = 0) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (swizzle << 62);
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
// this thread's shared-memory writes (st.shared, cp.async) made visible to
// the async proxy that wgmma reads through
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// pins a register's value after the last wgmma.wait_group
__device__ __forceinline__ void fence_operand(int& r) {
  asm volatile("" : "+r"(r)::"memory");
}
__device__ __forceinline__ void fence_operand(float& r) {
  asm volatile("" : "+f"(r)::"memory");
}

// 64 rows of a strided bf16 matrix (d columns) into shared rows D + 8 bf16
// apart (ldmatrix conflict-free), zeros in columns d..D-1: cp.async 16-byte
// copies when v16 (d, the row stride and the head offset on 16 bytes),
// else 8-byte loads (d % 4 == 0) stored at once. The tensor-core attention
// backward kernels (K4-dkv, K6's statistics pass) load their tiles so.
template <int D>
__device__ __forceinline__ void rows_in_bf16(bf16* dst, const bf16* src,
                                             int row_stride, int d, int v16) {
  constexpr int LD = D + 8, CH = D / 8;
  for (int idx = threadIdx.x; idx < 64 * CH; idx += blockDim.x) {
    const int r = idx / CH, c = (idx - r * CH) * 8;
    const bf16* gp = src + (size_t)r * row_stride + c;
    bf16* sp = dst + r * LD + c;
    if (v16) {
      cp_async16(smem_u32(sp), c < d ? gp : src, c < d ? 16 : 0);
    } else {
      uint2 lo = make_uint2(0u, 0u), hi = lo;
      if (c < d) lo = *reinterpret_cast<const uint2*>(gp);
      if (c + 4 < d) hi = *reinterpret_cast<const uint2*>(gp + 4);
      *reinterpret_cast<uint4*>(sp) = make_uint4(lo.x, lo.y, hi.x, hi.y);
    }
  }
}

// ---- tiles of the attention backward kernels (K4-dkv, K4-dq, K6) ---------
// 64-row tiles and 256 threads per block; thread (ty, tx) = (tid / 16,
// tid % 16) holds rows 4ty..4ty+3 and columns tx + 16j of a 64 x 64 tile.
constexpr int kBwdTile = 64, kBwdThreads = 256;

// 64 rows of a strided T matrix (d columns, zeros up to D) into fp32
// shared rows D + 4 floats apart
template <typename T, int D>
__device__ __forceinline__ void tile_in(float* dst, const T* src,
                                        int row_stride, int d) {
  constexpr int LD = D + 4, C4 = D / 4;
  for (int idx = threadIdx.x; idx < kBwdTile * C4; idx += kBwdThreads) {
    const int r = idx / C4, c = (idx - r * C4) * 4;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (c < d) v = load4(src + (size_t)r * row_stride + c);
    *reinterpret_cast<float4*>(dst + r * LD + c) = v;
  }
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

// s[r][j] = A[4ty + r] . B[tx + 16j] over D columns of two shared tiles
template <int D>
__device__ __forceinline__ void tile_dots(float (&s)[4][4], const float* A,
                                          const float* Bt, int ty, int tx) {
  constexpr int LD = D + 4;
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[r][j] = 0.f;
#pragma unroll 4
  for (int c = 0; c < D; c += 4) {
    float4 a[4], b[4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
      a[r] = *reinterpret_cast<const float4*>(A + (4 * ty + r) * LD + c);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      b[j] = *reinterpret_cast<const float4*>(Bt + (tx + 16 * j) * LD + c);
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[r][j] = dot4(a[r], b[j], s[r][j]);
  }
}
