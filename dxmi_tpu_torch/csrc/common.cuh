// Shared pieces of the port's kernels: the GroupNorm statistics pass that
// K1 (groupnorm.cu), K3 (conv_fused.cu) and K2 (attn_block.cu) all start
// from, and the affine and SiLU they apply.
#pragma once

#include <cuda_runtime.h>

// Per-(sample, group) mean and 1/sqrt(var + eps) of a channels-last
// (B, HW, C) fp32 tensor, two-pass in fp32 (the JAX package's default
// group_norm_silu_reference), written out per channel: mean_c and rstd_c
// are (B, C), so that a consumer reads them with the same 16-byte loads as
// x. Needs C / G <= 32. Defined in groupnorm.cu.
cudaError_t launch_gn_stats(const float* x, float* mean_c, float* rstd_c,
                            int B, int HW, int C, int G, float eps,
                            cudaStream_t stream);

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
