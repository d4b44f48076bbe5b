// K5: the int8 (W8A8) attention block,
//   y = x + proj_i8(attention(qkv_i8(GroupNorm(x)))) on (B, S, C).
//
// Replaces: dxmi_tpu/ops/attn_block.py:353 _kernel_i8 (run by
// _pallas_forward_i8, public entry fused_attn_block_int8), the Pallas TPU
// kernel that holds one (S, C) element in VMEM and runs: GroupNorm
// statistics in fp32; h quantised straight from the fp32 GN epilogue,
// round((x * s_c + t_c) * (1 / sa_q)) clipped to +-127; the qkv product int8
// x int8 -> int32 with weights prepared per output channel (activation
// scales folded into their input axis); the epilogue acc * swq + b_qkv in
// fp32, cast to the compute dtype; the attention core in the compute dtype
// with q and k scaled by d^-1/4; the attention output quantised the same way
// with 1 / sa_p; the int8 proj product, its epilogue, and the residual add
// in the compute dtype.
//
// Bound on the H100: operations. At ImageNet64's 32x32 maps (B=100, S=1024,
// C=384, nh=6) the qkv and proj products are 121 G int8 operations (0.061
// ms at 1,979 TOPS) and the bf16 attention core 161 GFLOP (0.163 ms at 989
// TFLOP/s), against 157 MB of bf16 input and output.
//
// Design: the four launches of K2 (attn_block.cu), since Hopper's 227 KB of
// shared memory per block cannot hold the TPU body's VMEM working set:
//   (a) K1's per-(sample, group) statistics, two-pass fp32, per channel;
//   (b) an int8 tensor-core GEMM (128x128 block tiles of 8 warps, each
//       64x32 with mma.sync m16n8k32 s8 -> s32, ldmatrix, two shared stages,
//       weights by cp.async) whose A loads apply GN in fp32 and quantise to
//       s8 in shared memory, so h never reaches device memory; its epilogue
//       dequantises, adds the fp32 bias, rounds to the compute dtype and
//       scales the q and k columns by the rounded d^-1/4 (rounded again);
//   (c) the attention core of K2: K4's flash kernel with sm_scale 1 in bf16
//       (it reads q, k and v through the qkv buffer's row stride), K2's fp32
//       core in fp32;
//   (d) the same GEMM for proj, quantising the attention output while
//       loading, with the residual added in the compute dtype in its
//       epilogue.
// Every rounding step is explicit (__fmul_rn, __fadd_rn, rintf), so no
// fused multiply-add moves a rounding against the plain version; the int8
// products are exact, so the two differ only by the order of the GN sums and
// the attention core's arithmetic, and the int8 rounding flips those cause.
// The qkv and attention-output intermediates go through device memory (the
// TPU kernel keeps them in VMEM).
#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int IBM = 128, IBN = 128, IBK = 32, kIThreads = 256;
constexpr int LDR = IBK + 16;  // bytes per shared row: 48, ldmatrix conflict-free

enum Prologue { kGroupNormA = 0, kPlainA = 1 };
enum Epilogue { kBiasScaleQK = 0, kBiasResidual = 1 };

// round to the compute dtype and back (to_f is common.cuh's)
__device__ __forceinline__ float round_to(float v, float) { return v; }
__device__ __forceinline__ float round_to(float v, bf16) { return rb(v); }
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(bf16* p, float a, float b) {
  *reinterpret_cast<unsigned*>(p) = pack_bf16(a, b);
}

// C[M, N] = epilogue(quant(A)[M, K] W^T): A (M, K) in T, rows of sample
// m / rows_per_sample; W (N, K) int8; ws, bias (N,) fp32; isa (K,) fp32.
// kGroupNormA quantises (a * (gs * rstd) + (gb - mean * gs * rstd)) * isa,
// kPlainA quantises a * isa. kBiasScaleQK: c = T(acc * ws + bias), then
// T(c * qk_scale) for n < qk_cols; kBiasResidual: T(resid + T(acc * ws +
// bias)).
template <typename T, int PRO, int EPI>
__global__ void __launch_bounds__(kIThreads)
igemm_kernel(const T* __restrict__ A, const int8_t* __restrict__ Wt,
             T* __restrict__ Cm, int M, int N, int K,
             const float* __restrict__ isa, const float* __restrict__ ws,
             const float* __restrict__ bias, const T* __restrict__ resid,
             float qk_scale, int qk_cols, const float* __restrict__ mean_c,
             const float* __restrict__ rstd_c, const float* __restrict__ gs,
             const float* __restrict__ gb, int rows_per_sample) {
  __shared__ __align__(128) unsigned char As[2][IBM * LDR];
  __shared__ __align__(128) unsigned char Bs[2][IBN * LDR];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 2, wn = warp & 3;
  const int m0 = blockIdx.y * IBM, n0 = blockIdx.x * IBN;
  // this thread's 16 A elements of a tile (one row, 16 columns) and its
  // 16-byte chunk of the W tile
  const int a_r = tid >> 1, a_c = (tid & 1) * 16, a_m = m0 + a_r;
  const int b_r = tid >> 1, b_c = (tid & 1) * 16;
  float ra[16];

  auto copy_b_async = [&](int k0, int st) {
    const bool ok = n0 + b_r < N;
    const int8_t* src = ok ? Wt + (size_t)(n0 + b_r) * K + k0 + b_c : Wt;
    cp_async16(smem_u32(&Bs[st][b_r * LDR + b_c]), src, ok ? 16 : 0);
    cp_async_commit();
  };
  auto load_a = [&](int k0) {  // global -> registers
    if (a_m < M) {
      float v[8];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        load8(A + (size_t)a_m * K + k0 + a_c + 8 * h, v);
#pragma unroll
        for (int j = 0; j < 8; ++j) ra[8 * h + j] = v[j];
      }
    }
  };
  auto store_a = [&](int k0, int st) {  // quantise, store s8
    uint4 packed = make_uint4(0u, 0u, 0u, 0u);
    if (a_m < M) {
      int qi[16];
      const int k = k0 + a_c;
      const size_t bk = (size_t)(a_m / rows_per_sample) * K + k;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        float h = ra[j];
        if (PRO == kGroupNormA) {
          const float sc = __fmul_rn(gs[k + j], rstd_c[bk + j]);
          const float sh = __fsub_rn(gb[k + j], __fmul_rn(mean_c[bk + j], sc));
          h = __fadd_rn(__fmul_rn(h, sc), sh);
        }
        qi[j] = quant_i8(__fmul_rn(h, isa[k + j]));
      }
      packed.x = pack_s8x4(qi[0], qi[1], qi[2], qi[3]);
      packed.y = pack_s8x4(qi[4], qi[5], qi[6], qi[7]);
      packed.z = pack_s8x4(qi[8], qi[9], qi[10], qi[11]);
      packed.w = pack_s8x4(qi[12], qi[13], qi[14], qi[15]);
    }
    *reinterpret_cast<uint4*>(&As[st][a_r * LDR + a_c]) = packed;
  };

  int acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  const int a_koff = (lane >> 4) * 16;
  const int b_row = (lane & 7) + ((lane >> 4) << 3);
  const int b_koff = ((lane >> 3) & 1) * 16;

  copy_b_async(0, 0);
  load_a(0);
  store_a(0, 0);
  cp_async_wait<0>();
  __syncthreads();

  const int n_k = K / IBK;
  for (int kt = 0; kt < n_k; ++kt) {
    const int st = kt & 1;
    const bool more = kt + 1 < n_k;
    if (more) {  // stage st^1 was last read before the last barrier
      copy_b_async((kt + 1) * IBK, st ^ 1);
      load_a((kt + 1) * IBK);
    }
    unsigned a[4][4], b[4][2];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      ldsm_x4(a[i], smem_u32(&As[st][(wm * 64 + i * 16 + (lane & 15)) * LDR +
                                     a_koff]));
#pragma unroll
    for (int jj = 0; jj < 2; ++jj) {
      unsigned r[4];
      ldsm_x4(r, smem_u32(&Bs[st][(wn * 32 + jj * 16 + b_row) * LDR + b_koff]));
      b[2 * jj][0] = r[0];
      b[2 * jj][1] = r[1];
      b[2 * jj + 1][0] = r[2];
      b[2 * jj + 1][1] = r[3];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) mma_s8(acc[i][j], a[i], b[j][0], b[j][1]);
    if (more) {
      store_a((kt + 1) * IBK, st ^ 1);
      cp_async_wait<0>();
    }
    __syncthreads();
  }

  const int g = lane >> 2, t = lane & 3;
  const T tag{};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int m = m0 + wm * 64 + i * 16 + g + half * 8;
      if (m >= M) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = n0 + wn * 32 + j * 8 + 2 * t;
        if (n >= N) continue;
        float v[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float u = round_to(
              __fadd_rn(__fmul_rn(__int2float_rn(acc[i][j][2 * half + e]),
                                  ws[n + e]),
                        bias[n + e]),
              tag);
          if (EPI == kBiasScaleQK) {
            if (n + e < qk_cols) u = round_to(__fmul_rn(u, qk_scale), tag);
          } else {
            u = round_to(__fadd_rn(to_f(resid[(size_t)m * N + n + e]), u), tag);
          }
          v[e] = u;
        }
        store2(Cm + (size_t)m * N + n, v[0], v[1]);
      }
    }
  }
}

template <typename T>
cudaError_t stats(const T* x, float* mean_c, float* rstd_c, int B, int S,
                  int C, int G, float eps, cudaStream_t s);
template <>
cudaError_t stats(const float* x, float* mean_c, float* rstd_c, int B, int S,
                  int C, int G, float eps, cudaStream_t s) {
  return launch_gn_stats(x, mean_c, rstd_c, B, S, C, G, eps, s);
}
template <>
cudaError_t stats(const bf16* x, float* mean_c, float* rstd_c, int B, int S,
                  int C, int G, float eps, cudaStream_t s) {
  return launch_gn_stats_bf16(x, mean_c, rstd_c, B, S, C, G, eps, 0, s);
}

cudaError_t core(const float* qkv, float* attn, int B, int S, int C, int nh,
                 cudaStream_t s) {
  return launch_attn_core_f32(qkv, attn, B, S, C, nh, s);
}
cudaError_t core(const bf16* qkv, bf16* attn, int B, int S, int C, int nh,
                 cudaStream_t s) {
  return launch_flash_attn(qkv, qkv + C, qkv + 2 * C, attn, nullptr, B, S,
                           nh, C / nh, 3 * C, C, 1.f, s);
}

template <typename T>
cudaError_t run(const T* x, const float* gs, const float* gb,
                const int8_t* wq, const float* swq, const float* isa_q,
                const float* bq, const int8_t* wp, const float* swp,
                const float* isa_p, const float* bp, T* y, float* mean_c,
                float* rstd_c, T* qkv, T* attn, int B, int S, int C, int nh,
                int G, float eps, float qk_scale, cudaStream_t s) {
  cudaError_t err = stats(x, mean_c, rstd_c, B, S, C, G, eps, s);
  if (err != cudaSuccess) return err;
  const int M = B * S;
  dim3 g_qkv((3 * C + IBN - 1) / IBN, (M + IBM - 1) / IBM);
  igemm_kernel<T, kGroupNormA, kBiasScaleQK><<<g_qkv, kIThreads, 0, s>>>(
      x, wq, qkv, M, 3 * C, C, isa_q, swq, bq, nullptr, qk_scale, 2 * C,
      mean_c, rstd_c, gs, gb, S);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = core(qkv, attn, B, S, C, nh, s);
  if (err != cudaSuccess) return err;
  dim3 g_proj((C + IBN - 1) / IBN, (M + IBM - 1) / IBM);
  igemm_kernel<T, kPlainA, kBiasResidual><<<g_proj, kIThreads, 0, s>>>(
      attn, wp, y, M, C, C, isa_p, swp, bp, x, 1.f, 0, nullptr, nullptr,
      nullptr, nullptr, S);
  return cudaGetLastError();
}

}  // namespace

// x, y: (B, S, C) fp32 (is_bf16 == 0) or bf16; gs, gb (C,) fp32; wq: (3C, C)
// int8, the qkv weight per output channel ([3, nh, d] rows) with the
// activation scales folded into its input axis; swq, bq (3C,) and isa_q (C,)
// fp32 (isa_q = 1 / sa_q); wp (C, C) int8, swp, bp, isa_p (C,) fp32;
// mean_c/rstd_c: (B, C) fp32 scratch; qkv: (B, S, 3C) and attn: (B, S, C)
// scratch in x's dtype. Needs S % 64 == 0, C % 32 == 0, C / G <= 64 and
// d = C / nh with d % 8 == 0 and d <= 128 (bf16) or d % 16 == 0 and
// d <= 256 (fp32).
extern "C" int dxmi_attn_block_i8(const void* x, int is_bf16, const float* gs,
                                  const float* gb, const void* wq,
                                  const float* swq, const float* isa_q,
                                  const float* bq, const void* wp,
                                  const float* swp, const float* isa_p,
                                  const float* bp, void* y, float* mean_c,
                                  float* rstd_c, void* qkv, void* attn, int B,
                                  int S, int C, int nh, int G, float eps,
                                  void* stream) {
  if (C % IBK || S % 64 || C % nh) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int d = C / nh;
  const double scale = 1.0 / sqrt(sqrt((double)d));
  const int8_t* wqi = static_cast<const int8_t*>(wq);
  const int8_t* wpi = static_cast<const int8_t*>(wp);
  if (is_bf16) {
    // the TPU body scales by jnp.asarray(d ** -0.25, bf16)
    const float qk = __bfloat162float(__float2bfloat16_rn((float)scale));
    return (int)run(static_cast<const bf16*>(x), gs, gb, wqi, swq, isa_q, bq,
                    wpi, swp, isa_p, bp, static_cast<bf16*>(y), mean_c,
                    rstd_c, static_cast<bf16*>(qkv), static_cast<bf16*>(attn),
                    B, S, C, nh, G, eps, qk, s);
  }
  return (int)run(static_cast<const float*>(x), gs, gb, wqi, swq, isa_q, bq,
                  wpi, swp, isa_p, bp, static_cast<float*>(y), mean_c, rstd_c,
                  static_cast<float*>(qkv), static_cast<float*>(attn), B, S,
                  C, nh, G, eps, (float)scale, s);
}
