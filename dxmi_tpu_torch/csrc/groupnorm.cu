// K1: GroupNorm(+SiLU) over a channels-last (B, HW, C) fp32 or bf16 tensor.
//
// Replaces: dxmi_tpu/ops/groupnorm.py:_kernel (run by _forward under
// fused_group_norm), the Pallas TPU kernel that takes one-pass s1/s2
// statistics through a one-hot group-mask matmul, then normalises, applies
// the affine and optionally SiLU, all in VMEM.
//
// Bound on the H100: memory. The work is ~10-20 flops per element against
// 8 (fp32) or 4 (bf16) bytes moved, far below the ~20 flop/byte at which
// fp32 arithmetic would limit it.
//
// Design: two kernels. gn_stats_kernel takes one block per (sample, run of
// whole groups within 32 or 64 channels): lane l of the block's channel
// lanes owns one channel and the lane rows split the pixels, so every load
// instruction reads a pixel's run of channels. It computes either two-pass
// fp32 mean/variance (the plain version's default; the TPU body's
// E[x^2] - mean^2 is not used), re-reading the slice, which the second pass
// finds in cache, or the bf16_onepass statistics of the JAX package
// (groupnorm.py:66-90): s1 and s2 of x and bf16-rounded x*x in fp32, mean
// and var rounded to bf16. It writes mean and rstd per channel. The apply
// kernels are grid-stride elementwise passes with 16-byte loads and stores:
// fp32 arithmetic rounded once at the end, or, for bf16_onepass on bf16,
// each operation rounded to bf16 where XLA rounds it. Groups of up to 64
// channels are taken, including widths such as 42 or 48 that are not
// powers of two (the ADM decoders reach 48 channels per group).
#include "common.cuh"

namespace {

constexpr int kStatsThreads = 256;
constexpr int kApplyThreads = 256;

__device__ __forceinline__ float load_f(const float* p) { return *p; }
__device__ __forceinline__ float load_f(const bf16* p) {
  return __bfloat162float(*p);
}
// x*x as the input dtype rounds it (exact in fp32 for fp32 input)
__device__ __forceinline__ float sq_in(float v, const float*) { return v * v; }
__device__ __forceinline__ float sq_in(float v, const bf16*) { return rb(v * v); }
__device__ __forceinline__ float round_in(float v, const float*) { return v; }
__device__ __forceinline__ float round_in(float v, const bf16*) { return rb(v); }

// grid (ceil(G / (cw / cg)), B); cg = C / G <= cw, cw = 32 or 64 channel
// lanes, kStatsThreads / cw lane rows
template <typename T>
__global__ void __launch_bounds__(kStatsThreads)
gn_stats_kernel(const T* __restrict__ x, float* __restrict__ mean_c,
                float* __restrict__ rstd_c, int HW, int C, int G, float eps,
                int cw, int onepass) {
  __shared__ float part[2][kStatsThreads];
  __shared__ float g_mean[64], g_rstd[64];
  const int rows = kStatsThreads / cw;
  const int cg = C / G, groups_per_block = cw / cg;
  const int lane = threadIdx.x % cw, row = threadIdx.x / cw;
  const int b = blockIdx.y, g0 = blockIdx.x * groups_per_block;
  const int ng = min(groups_per_block, G - g0);
  const bool active = lane < ng * cg;
  const int gl = active ? lane / cg : 0;  // this lane's group in the block
  const T* xc = x + (size_t)b * HW * C + (size_t)g0 * cg + lane;
  const float n = (float)(HW * cg);
  const float inv_n = 1.f / n;

  // per-channel partial sums over the lane rows, then per group
  auto group_sums = [&](int slot, float v) {
    part[slot][threadIdx.x] = v;
    __syncthreads();
    if (row == 0) {
      float t = 0.f;
      for (int r = 0; r < rows; ++r) t += part[slot][r * cw + lane];
      part[slot][lane] = t;
    }
    __syncthreads();
  };
  auto group_total = [&](int slot, int gi) {
    float t = 0.f;
    for (int k = 0; k < cg; ++k) t += part[slot][gi * cg + k];
    return t;
  };

  if (onepass) {
    float s1 = 0.f, s2 = 0.f;
    if (active)
      for (int p = row; p < HW; p += rows) {
        const float v = load_f(xc + (size_t)p * C);
        s1 += v;
        s2 += sq_in(v, xc);
      }
    part[0][threadIdx.x] = s1;
    group_sums(1, s2);  // its barriers also cover slot 0's partials
    if (row == 0) {
      float t = 0.f;
      for (int r = 0; r < rows; ++r) t += part[0][r * cw + lane];
      part[0][lane] = t;
    }
    __syncthreads();
    if (threadIdx.x < ng) {
      const float m = group_total(0, threadIdx.x) / n;
      const float var =
          round_in(fmaxf(group_total(1, threadIdx.x) / n - m * m, 0.f), xc);
      g_mean[threadIdx.x] = round_in(m, xc);
      g_rstd[threadIdx.x] =
          round_in(1.f / sqrtf(round_in(var + round_in(eps, xc), xc)), xc);
    }
    __syncthreads();
  } else {
    float s = 0.f;
    if (active)
      for (int p = row; p < HW; p += rows) s += load_f(xc + (size_t)p * C);
    group_sums(0, s);
    if (threadIdx.x < ng) g_mean[threadIdx.x] = group_total(0, threadIdx.x) * inv_n;
    __syncthreads();
    const float m = g_mean[gl];
    float v = 0.f;
    if (active)
      for (int p = row; p < HW; p += rows) {
        const float dv = load_f(xc + (size_t)p * C) - m;
        v += dv * dv;
      }
    group_sums(1, v);
    if (threadIdx.x < ng)
      g_rstd[threadIdx.x] =
          1.f / sqrtf(group_total(1, threadIdx.x) * inv_n + eps);
    __syncthreads();
  }

  if (row == 0 && active) {
    const size_t bc = (size_t)b * C + (size_t)g0 * cg + lane;
    mean_c[bc] = g_mean[gl];
    rstd_c[bc] = g_rstd[gl];
  }
}

template <typename T>
cudaError_t launch_stats(const T* x, float* mean_c, float* rstd_c, int B,
                         int HW, int C, int G, float eps, int onepass,
                         cudaStream_t stream) {
  const int cg = C / G;
  if (cg < 1 || cg > 64 || C % G) return cudaErrorInvalidValue;
  const int cw = cg <= 32 ? 32 : 64;
  const int groups_per_block = cw / cg;
  dim3 grid((G + groups_per_block - 1) / groups_per_block, B);
  gn_stats_kernel<T><<<grid, kStatsThreads, 0, stream>>>(
      x, mean_c, rstd_c, HW, C, G, eps, cw, onepass);
  return cudaGetLastError();
}

__global__ void __launch_bounds__(kApplyThreads)
gn_apply_kernel(const float* __restrict__ x, const float* __restrict__ scale,
                const float* __restrict__ bias,
                const float* __restrict__ mean_c,
                const float* __restrict__ rstd_c, float* __restrict__ y,
                long long n4, int HW, int C, int silu_on) {
  const long long per_sample4 = (long long)HW * (C / 4);
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n4;
       i += (long long)gridDim.x * blockDim.x) {
    const int b = (int)(i / per_sample4);
    const int c = (int)(i % (C / 4)) * 4;
    const size_t bc = (size_t)b * C + c;
    float4 t = gn_affine4(ldg4(x + 4 * i), ldg4(mean_c + bc),
                          ldg4(rstd_c + bc), ldg4(scale + c), ldg4(bias + c));
    if (silu_on) t = make_float4(silu(t.x), silu(t.y), silu(t.z), silu(t.w));
    reinterpret_cast<float4*>(y)[i] = t;
  }
}

// bf16 in and out, 8 channels per thread. stepwise == 0: fp32 arithmetic
// in the plain version's order, rounded once; stepwise == 1: every
// operation rounded to bf16 (bf16_onepass), mean and rstd already bf16.
__global__ void __launch_bounds__(kApplyThreads)
gn_apply_bf16_kernel(const bf16* __restrict__ x,
                     const float* __restrict__ scale,
                     const float* __restrict__ bias,
                     const float* __restrict__ mean_c,
                     const float* __restrict__ rstd_c, bf16* __restrict__ y,
                     long long n8, int HW, int C, int silu_on, int stepwise) {
  const long long per_sample8 = (long long)HW * (C / 8);
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n8;
       i += (long long)gridDim.x * blockDim.x) {
    const int b = (int)(i / per_sample8);
    const int c = (int)(i % (C / 8)) * 8;
    const size_t bc = (size_t)b * C + c;
    uint4 raw = __ldg(reinterpret_cast<const uint4*>(x) + i);
    const bf16* xv = reinterpret_cast<const bf16*>(&raw);
    uint4 packed;
    unsigned* out = reinterpret_cast<unsigned*>(&packed);
#pragma unroll
    for (int j = 0; j < 8; j += 2) {
      float t[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float v = __bfloat162float(xv[j + e]);
        const float m = mean_c[bc + j + e], r = rstd_c[bc + j + e];
        const float s = scale[c + j + e], bb = bias[c + j + e];
        float u;
        if (stepwise) {
          u = rb(rb(rb(rb(v - m) * r) * rb(s)) + rb(bb));
          // XLA's bf16 sigmoid: 1 / (1 + exp(-u)), each op rounded
          if (silu_on) u = rb(u * rb(1.f / rb(1.f + rb(expf(-u)))));
        } else {
          u = __fadd_rn(__fmul_rn(__fmul_rn(v - m, r), s), bb);
          if (silu_on) u = __fmul_rn(u, 1.f / (1.f + expf(-u)));
        }
        t[e] = u;
      }
      out[j / 2] = pack_bf16(t[0], t[1]);
    }
    reinterpret_cast<uint4*>(y)[i] = packed;
  }
}

int apply_blocks(long long n) {
  long long blocks = (n + kApplyThreads - 1) / kApplyThreads;
  return (int)(blocks > 132 * 16 ? 132 * 16 : blocks);
}

}  // namespace

cudaError_t launch_gn_stats(const float* x, float* mean_c, float* rstd_c,
                            int B, int HW, int C, int G, float eps,
                            cudaStream_t stream) {
  return launch_stats<float>(x, mean_c, rstd_c, B, HW, C, G, eps, 0, stream);
}

cudaError_t launch_gn_stats_bf16(const bf16* x, float* mean_c, float* rstd_c,
                                 int B, int HW, int C, int G, float eps,
                                 int onepass, cudaStream_t stream) {
  return launch_stats<bf16>(x, mean_c, rstd_c, B, HW, C, G, eps, onepass,
                            stream);
}

cudaError_t launch_gn_apply(const float* x, const float* scale,
                            const float* bias, const float* mean_c,
                            const float* rstd_c, float* y, int B, int HW,
                            int C, int silu, cudaStream_t stream) {
  if (C % 4) return cudaErrorInvalidValue;
  const long long n4 = (long long)B * HW * C / 4;
  gn_apply_kernel<<<apply_blocks(n4), kApplyThreads, 0, stream>>>(
      x, scale, bias, mean_c, rstd_c, y, n4, HW, C, silu);
  return cudaGetLastError();
}

cudaError_t launch_gn_apply(const bf16* x, const float* scale,
                            const float* bias, const float* mean_c,
                            const float* rstd_c, bf16* y, int B, int HW,
                            int C, int silu, int stepwise,
                            cudaStream_t stream) {
  if (C % 8) return cudaErrorInvalidValue;
  const long long n8 = (long long)B * HW * C / 8;
  gn_apply_bf16_kernel<<<apply_blocks(n8), kApplyThreads, 0, stream>>>(
      x, scale, bias, mean_c, rstd_c, y, n8, HW, C, silu, stepwise);
  return cudaGetLastError();
}

// x, y: (B, HW, C) fp32 (is_bf16 == 0) or bf16; scale, bias: (C,) fp32;
// mean_c, rstd_c: (B, C) scratch; onepass selects the bf16_onepass
// statistics (for fp32 x: one-pass fp32 statistics).
extern "C" int dxmi_gn_forward(const void* x, const float* scale,
                               const float* bias, void* y, float* mean_c,
                               float* rstd_c, int B, int HW, int C, int G,
                               float eps, int silu, int is_bf16, int onepass,
                               void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (!is_bf16) {
    const float* xf = static_cast<const float*>(x);
    cudaError_t err = launch_stats<float>(xf, mean_c, rstd_c, B, HW, C, G,
                                          eps, onepass, s);
    if (err != cudaSuccess) return (int)err;
    return (int)launch_gn_apply(xf, scale, bias, mean_c, rstd_c,
                                static_cast<float*>(y), B, HW, C, silu, s);
  }
  const bf16* xb = static_cast<const bf16*>(x);
  cudaError_t err =
      launch_stats<bf16>(xb, mean_c, rstd_c, B, HW, C, G, eps, onepass, s);
  if (err != cudaSuccess) return (int)err;
  return (int)launch_gn_apply(xb, scale, bias, mean_c, rstd_c,
                              static_cast<bf16*>(y), B, HW, C, silu, onepass,
                              s);
}
