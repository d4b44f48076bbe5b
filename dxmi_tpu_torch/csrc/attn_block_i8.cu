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
// TFLOP/s), against 157 MB of bf16 input and output. Alone, the qkv GEMM is
// bounded by its bytes: 275 MB of int8 h read and bf16 qkv written (0.082
// ms at 3.35 TB/s) against 0.046 ms of products; the proj GEMM 197 MB
// (0.059 ms) against 0.015 ms.
//
// Design, bf16 form (the ImageNet64 and LSUN main paths): six launches,
// since Hopper's 227 KB of shared memory per block cannot hold the TPU
// body's VMEM working set:
//   (a) K1's per-(sample, group) statistics, two-pass fp32, per channel;
//   (b) h quantised once, straight from fp32, into int8 (tma_gemm.cuh
//       launch_prep), written to the attention output's buffer, which is
//       free until (d);
//   (c) the qkv GEMM on wgmma m64nNk32 s8 -> s32 with both operands K-major
//       by TMA (tma_gemm.cuh; int8 wgmma takes no transpose, and wq is
//       (3C, C) output-major): the epilogue dequantises, adds the fp32 bias,
//       rounds to bf16 and scales the q and k columns by the rounded d^-1/4
//       (rounded again);
//   (d) K4's flash kernel with sm_scale 1 (it reads q, k and v through the
//       qkv buffer's row stride);
//   (e) the attention output quantised with isa_p into the qkv buffer, free
//       once (d) is done;
//   (f) the proj GEMM, the same kernel, with the residual added in bf16.
// The earlier design quantised A in the GEMM's loads, once per 128-wide N
// tile (9, 14 or 18 times at 3C = 1152, 1728, 2304); (b) and (e) quantise
// each element once (design (a) of the two considered, as in attn_block.cu)
// and write int8, half the bytes of the bf16 they read. Split by launch at
// the 32x32 maps (chip_smoke.py phase T, NVIDIA H100 80GB HBM3, 700.00 W):
// statistics 0.0620 ms, (b) 0.0543, (c) 0.1550, (d) 0.3815, (e) 0.0425,
// (f) 0.0780 (those of the earlier design, 1.64 ms in all, were not
// split): 0.77 ms. The fp32 form (the trained ADM fixture's 8x8 maps, on no
// main path) keeps the earlier design: K2's fp32 SIMT attention core and
// an int8 mma.sync GEMM (128x128 tiles of 8 warps, m16n8k32 s8, two shared
// stages) that quantises its A loads, which the TMA GEMM cannot do for an
// fp32 A.
#include <math.h>
#include <stdint.h>

#include "tma_gemm.cuh"

namespace {

constexpr int IBM = 128, IBN = 128, IBK = 32, kIThreads = 256;
constexpr int LDR = IBK + 16;  // bytes per shared row: 48, ldmatrix conflict-free

enum Prologue { kGroupNormA = 0, kPlainA = 1 };
enum Epilogue { kBiasScaleQK = 0, kBiasResidual = 1 };

// The fp32 form's GEMM: C[M, N] = epilogue(quant(A)[M, K] W^T): A (M, K)
// fp32, rows of sample m / rows_per_sample; W (N, K) int8; ws, bias (N,)
// fp32; isa (K,) fp32. kGroupNormA quantises (a * (gs * rstd) + (gb - mean *
// gs * rstd)) * isa, kPlainA quantises a * isa. kBiasScaleQK: c = acc * ws +
// bias, then c * qk_scale for n < qk_cols; kBiasResidual: resid + (acc * ws
// + bias).
template <int PRO, int EPI>
__global__ void __launch_bounds__(kIThreads)
igemm_kernel(const float* __restrict__ A, const int8_t* __restrict__ Wt,
             float* __restrict__ Cm, int M, int N, int K,
             const float* __restrict__ isa, const float* __restrict__ ws,
             const float* __restrict__ bias, const float* __restrict__ resid,
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
          float u = __fadd_rn(
              __fmul_rn(__int2float_rn(acc[i][j][2 * half + e]), ws[n + e]),
              bias[n + e]);
          if (EPI == kBiasScaleQK) {
            if (n + e < qk_cols) u = __fmul_rn(u, qk_scale);
          } else {
            u = __fadd_rn(resid[(size_t)m * N + n + e], u);
          }
          v[e] = u;
        }
        *reinterpret_cast<float2*>(Cm + (size_t)m * N + n) =
            make_float2(v[0], v[1]);
      }
    }
  }
}

// The epilogue of the bf16 form's wgmma GEMMs, a pair of columns n, n + 1
// of one row: v = bf16(acc * ws + bias) in fp32, each operation rounded;
// then the q and k columns (n < qk_cols) bf16(v qk_scale) (qkv), or
// bf16(resid + v) (proj, resid); returned packed. Its roundings are paired
// conversions (rb2); a column's parameters are (ws, bias).
struct I8Epi {
  const float* ws;
  const float* bias;
  float qk_scale;
  int qk_cols;
  bool resid;
  __device__ __forceinline__ float2 col(int n) const {
    return make_float2(ws[n], bias[n]);
  }
  __device__ __forceinline__ unsigned operator()(int n, float2 c0, float2 c1,
                                                 int a0, int a1,
                                                 unsigned r) const {
    float v0 = __fadd_rn(__fmul_rn(__int2float_rn(a0), c0.x), c0.y);
    float v1 = __fadd_rn(__fmul_rn(__int2float_rn(a1), c1.x), c1.y);
    const unsigned u = rb2(v0, v1);
    if (resid)
      return pack_bf16(__fadd_rn(__uint_as_float(r << 16), v0),
                       __fadd_rn(__uint_as_float(r & 0xffff0000u), v1));
    // n even and qk_cols a multiple of 8: both columns on the same side
    if (n < qk_cols)
      return pack_bf16(__fmul_rn(v0, qk_scale), __fmul_rn(v1, qk_scale));
    return u;
  }
};

cudaError_t run_bf16(const bf16* x, const float* gs, const float* gb,
                     const int8_t* wq, const float* swq, const float* isa_q,
                     const float* bq, const int8_t* wp, const float* swp,
                     const float* isa_p, const float* bp, bf16* y,
                     float* mean_c, float* rstd_c, bf16* qkv, bf16* attn,
                     int B, int S, int C, int nh, int G, float eps,
                     float qk_scale, cudaStream_t s) {
  const int M = B * S;
  // int8 h in the attention output's buffer, the int8 attention output in
  // the qkv buffer: each is free while it is used so
  int8_t* h_i8 = reinterpret_cast<int8_t*>(attn);
  int8_t* a_i8 = reinterpret_cast<int8_t*>(qkv);
  cudaError_t err =
      launch_gn_stats_bf16(x, mean_c, rstd_c, B, S, C, G, eps, 0, s);
  if (err == cudaSuccess)
    err = tma_gemm::launch_prep<true, true>(x, h_i8, mean_c, rstd_c, gs, gb,
                                            isa_q, B, S, C, s);
  if (err == cudaSuccess)
    err = tma_gemm::launch<true>(h_i8, wq, qkv, nullptr, M, 3 * C, C,
                                 I8Epi{swq, bq, qk_scale, 2 * C, false}, s);
  if (err == cudaSuccess)
    err = launch_flash_attn(qkv, qkv + C, qkv + 2 * C, attn, nullptr, B, S,
                            nh, C / nh, 3 * C, C, 1.f, s);
  if (err == cudaSuccess)
    err = tma_gemm::launch_prep<false, true>(attn, a_i8, nullptr, nullptr,
                                             nullptr, nullptr, isa_p, B, S, C,
                                             s);
  if (err == cudaSuccess)
    err = tma_gemm::launch<true>(a_i8, wp, y, x, M, C, C,
                                 I8Epi{swp, bp, 1.f, 0, true}, s);
  return err;
}

cudaError_t run_f32(const float* x, const float* gs, const float* gb,
                    const int8_t* wq, const float* swq, const float* isa_q,
                    const float* bq, const int8_t* wp, const float* swp,
                    const float* isa_p, const float* bp, float* y,
                    float* mean_c, float* rstd_c, float* qkv, float* attn,
                    int B, int S, int C, int nh, int G, float eps,
                    float qk_scale, cudaStream_t s) {
  if (C % IBK) return cudaErrorInvalidValue;
  cudaError_t err = launch_gn_stats(x, mean_c, rstd_c, B, S, C, G, eps, s);
  if (err != cudaSuccess) return err;
  const int M = B * S;
  dim3 g_qkv((3 * C + IBN - 1) / IBN, (M + IBM - 1) / IBM);
  igemm_kernel<kGroupNormA, kBiasScaleQK><<<g_qkv, kIThreads, 0, s>>>(
      x, wq, qkv, M, 3 * C, C, isa_q, swq, bq, nullptr, qk_scale, 2 * C,
      mean_c, rstd_c, gs, gb, S);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = launch_attn_core_f32(qkv, attn, B, S, C, nh, s);
  if (err != cudaSuccess) return err;
  dim3 g_proj((C + IBN - 1) / IBN, (M + IBM - 1) / IBM);
  igemm_kernel<kPlainA, kBiasResidual><<<g_proj, kIThreads, 0, s>>>(
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
  if (C % 32 || S % 64 || C % nh) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int d = C / nh;
  const double scale = 1.0 / sqrt(sqrt((double)d));
  const int8_t* wqi = static_cast<const int8_t*>(wq);
  const int8_t* wpi = static_cast<const int8_t*>(wp);
  if (is_bf16) {
    // the TPU body scales by jnp.asarray(d ** -0.25, bf16)
    const float qk = __bfloat162float(__float2bfloat16_rn((float)scale));
    return (int)run_bf16(static_cast<const bf16*>(x), gs, gb, wqi, swq, isa_q,
                         bq, wpi, swp, isa_p, bp, static_cast<bf16*>(y),
                         mean_c, rstd_c, static_cast<bf16*>(qkv),
                         static_cast<bf16*>(attn), B, S, C, nh, G, eps, qk, s);
  }
  return (int)run_f32(static_cast<const float*>(x), gs, gb, wqi, swq, isa_q,
                      bq, wpi, swp, isa_p, bp, static_cast<float*>(y), mean_c,
                      rstd_c, static_cast<float*>(qkv),
                      static_cast<float*>(attn), B, S, C, nh, G, eps,
                      (float)scale, s);
}
