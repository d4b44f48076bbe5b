// K1: GroupNorm(+SiLU) over a channels-last (B, HW, C) fp32 tensor.
//
// Replaces: dxmi_tpu/ops/groupnorm.py:_kernel (run by _forward under
// fused_group_norm), the Pallas TPU kernel that takes one-pass s1/s2
// statistics through a one-hot group-mask matmul, then normalises, applies
// the affine and optionally SiLU, all in VMEM.
//
// Bound on the H100: memory. The work is ~10 flops per element against 8
// bytes moved (one fp32 read, one fp32 write), far below the ~20 flop/byte
// at which fp32 arithmetic would limit it.
//
// Design: two kernels. gn_stats_kernel takes one block per (sample, run
// of whole groups within 32 channels): lane l of each of its 8 warps owns
// one channel and the warps split the pixels, so every load instruction
// reads a pixel's run of channels, up to 128 contiguous bytes. It computes
// a two-pass fp32 mean/variance (the plain version's formulation; the TPU
// body's E[x^2] - mean^2 is not used), re-reading the slice, which the
// second pass finds in cache, and writes mean and rstd out per channel.
// gn_apply_kernel is a grid-stride elementwise pass with 16-byte loads and
// stores that applies (x - mean) * rstd * scale + bias and SiLU.
#include "common.cuh"

namespace {

constexpr int kStatsWarps = 8;
constexpr int kApplyThreads = 256;

// grid (ceil(G / (32 / cg)), B); cg = C / G <= 32
__global__ void __launch_bounds__(kStatsWarps * 32)
gn_stats_kernel(const float* __restrict__ x, float* __restrict__ mean_c,
                float* __restrict__ rstd_c, int HW, int C, int G, float eps) {
  __shared__ float part[kStatsWarps][32];
  __shared__ float g_mean[32], g_rstd[32];
  const int cg = C / G, groups_per_block = 32 / cg;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int b = blockIdx.y, g0 = blockIdx.x * groups_per_block;
  const int ng = min(groups_per_block, G - g0);
  const bool active = lane < ng * cg;
  const int gl = active ? lane / cg : 0;  // this lane's group in the block
  const float* xc = x + (size_t)b * HW * C + (size_t)g0 * cg + lane;
  const float inv_n = 1.f / (float)(HW * cg);

  // per-channel partial sums over this warp's pixels, then per group
  auto group_sums = [&](float v, float* out, bool to_rstd) {
    part[warp][lane] = v;
    __syncthreads();
    if (warp == 0) {
      float t = 0.f;
      for (int w = 0; w < kStatsWarps; ++w) t += part[w][lane];
      part[0][lane] = t;
    }
    __syncthreads();
    if (threadIdx.x < ng) {
      float t = 0.f;
      for (int k = 0; k < cg; ++k) t += part[0][threadIdx.x * cg + k];
      out[threadIdx.x] = to_rstd ? 1.f / sqrtf(t * inv_n + eps) : t * inv_n;
    }
    __syncthreads();
  };

  float s = 0.f;
  if (active)
    for (int p = warp; p < HW; p += kStatsWarps) s += xc[(size_t)p * C];
  group_sums(s, g_mean, false);

  const float m = g_mean[gl];
  float v = 0.f;
  if (active)
    for (int p = warp; p < HW; p += kStatsWarps) {
      const float d = xc[(size_t)p * C] - m;
      v += d * d;
    }
  group_sums(v, g_rstd, true);

  if (warp == 0 && active) {
    const size_t bc = (size_t)b * C + (size_t)g0 * cg + lane;
    mean_c[bc] = m;
    rstd_c[bc] = g_rstd[gl];
  }
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

}  // namespace

cudaError_t launch_gn_stats(const float* x, float* mean_c, float* rstd_c,
                            int B, int HW, int C, int G, float eps,
                            cudaStream_t stream) {
  const int cg = C / G;
  if (cg < 1 || cg > 32 || C % G) return cudaErrorInvalidValue;
  const int groups_per_block = 32 / cg;
  dim3 grid((G + groups_per_block - 1) / groups_per_block, B);
  gn_stats_kernel<<<grid, kStatsWarps * 32, 0, stream>>>(x, mean_c, rstd_c, HW,
                                                         C, G, eps);
  return cudaGetLastError();
}

// mean_c, rstd_c: (B, C) scratch.
extern "C" int dxmi_gn_forward(const float* x, const float* scale,
                               const float* bias, float* y, float* mean_c,
                               float* rstd_c, int B, int HW, int C, int G,
                               float eps, int silu, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = launch_gn_stats(x, mean_c, rstd_c, B, HW, C, G, eps, s);
  if (err != cudaSuccess) return (int)err;
  const long long n4 = (long long)B * HW * C / 4;
  long long blocks = (n4 + kApplyThreads - 1) / kApplyThreads;
  if (blocks > 132 * 16) blocks = 132 * 16;
  gn_apply_kernel<<<(int)blocks, kApplyThreads, 0, s>>>(
      x, scale, bias, mean_c, rstd_c, y, n4, HW, C, silu);
  return (int)cudaGetLastError();
}
