// K4: flash attention forward, bf16: o = softmax(q k^T * sm_scale) v per
// (sample, head).
//
// Replaces: dxmi_tpu/ops/attention.py:53 _flash_bnsd, which calls JAX's
// bundled Pallas TPU flash-attention kernel with one kv block (block_k = S,
// its single-step body, flash_attention.py:484): fp32 logits scaled by
// sm_scale, an fp32 softmax normalised before p is cast to bf16, p v
// accumulated in fp32. The TPU keeps a head's whole K and V (S * d * 2 bytes
// each) in VMEM.
//
// Bound on the H100: operations. At the ImageNet64 32x32 maps (B=100, nh=6,
// S=1024, d=64) the two products are 4 B nh S^2 d = 161 GFLOP, 0.163 ms at
// the 989 TFLOP/s bf16 tensor-core peak, against 315 MB of q, k, v and o,
// 0.094 ms at 3.35 TB/s.
//
// Design: a block of 4 warps owns 64 q rows of one (sample, head); each
// warp owns 16 rows. K and V do not fit in shared memory whole (256 KB per
// head at d=64 against 227 KB), so they stream through it in 64-row tiles,
// double buffered with cp.async while the previous tile is in the tensor
// cores. The q tile is read once into registers with ldmatrix. Per K/V
// tile each warp forms its 16 x 64 fp32 logits with mma.sync m16n8k16
// (bf16 operands, fp32 accumulators), scales them by sm_scale in fp32,
// updates an online softmax (running max and per-thread partial row sums in
// fp32, rescaling the output accumulators), casts p to bf16 straight from
// the accumulator registers into A fragments, and adds p v with mma.sync,
// V's B fragments loaded with ldmatrix.trans. At the end the output is
// divided by the row sum and rounded to bf16 once. Unlike the TPU body, p
// is cast to bf16 before it is normalised (the online form cannot
// normalise first). q, k and v are read through row strides, so K2's bf16
// form runs the same kernel on its (B, S, 3C) qkv buffer without copies.
// For training the kernel also writes each row's natural-log logsumexp of
// the scaled logits (m + log l, fp32), the residual that the backward
// kernels (flash_attn_bwd.cu) recompute p from.
#include <math.h>

#include "common.cuh"

namespace {

constexpr int FBQ = 64, FBK = 64, kFlashThreads = 128;

template <int D>
__host__ __device__ constexpr int flash_smem_bytes() {
  return (FBQ + 4 * FBK) * (D + 8) * 2;  // q tile, two stages of K and V
}

template <int D>
__global__ void __launch_bounds__(kFlashThreads)
flash_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, bf16* __restrict__ o,
                 float* __restrict__ lse, int S, int d, int row_stride,
                 int out_row_stride, float scale_log2) {
  constexpr int LD = D + 8;  // bf16 per shared row: ldmatrix conflict-free
  constexpr int CH = D / 8;  // 16-byte chunks per row
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Ks = Qs + FBQ * LD;      // [2][FBK][LD]
  bf16* Vs = Ks + 2 * FBK * LD;  // [2][FBK][LD]

  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * FBQ;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t base = (size_t)b * S * row_stride + (size_t)h * d;

  // 64 rows from row0 of src into dst; columns at or past d read zeros
  auto load_rows = [&](bf16* dst, const bf16* src, int row0) {
    for (int idx = tid; idx < 64 * CH; idx += kFlashThreads) {
      const int r = idx / CH, c = (idx - r * CH) * 8;
      const bool ok = c < d;
      const bf16* g = ok ? src + base + (size_t)(row0 + r) * row_stride + c
                         : src;
      cp_async16(smem_u32(dst + r * LD + c), g, ok ? 16 : 0);
    }
  };

  load_rows(Qs, q, q0);
  load_rows(Ks, k, 0);
  load_rows(Vs, v, 0);
  cp_async_commit();

  unsigned qa[D / 16][4];
  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  float m_r[2] = {-INFINITY, -INFINITY}, l_r[2] = {0.f, 0.f};

  const int n_tiles = S / FBK;
  for (int it = 0; it < n_tiles; ++it) {
    const int st = it & 1;
    if (it + 1 < n_tiles) {  // stage st^1 was last read before the last barrier
      load_rows(Ks + (st ^ 1) * FBK * LD, k, (it + 1) * FBK);
      load_rows(Vs + (st ^ 1) * FBK * LD, v, (it + 1) * FBK);
    }
    cp_async_commit();
    cp_async_wait<1>();  // this tile's group has landed
    __syncthreads();
    if (it == 0) {
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        ldsm_x4(qa[kk], smem_u32(Qs + (warp * 16 + (lane & 15)) * LD +
                                 kk * 16 + (lane >> 4) * 8));
    }

    // logits: this warp's 16 rows x 64 keys, 8 n-tiles of 8 keys
    const bf16* Kt = Ks + st * FBK * LD;
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        unsigned r[4];
        ldsm_x4(r, smem_u32(Kt + (jj * 16 + (lane & 7) + (lane >> 4) * 8) * LD +
                            kk * 16 + ((lane >> 3) & 1) * 8));
        mma_bf16(s[2 * jj], qa[kk], r[0], r[1]);
        mma_bf16(s[2 * jj + 1], qa[kk], r[2], r[3]);
      }
    }

    // online softmax; this thread holds rows g (e = 0, 1) and g + 8 (e = 2,
    // 3) of the warp's tile, a row's 64 keys spread over a quad of lanes
    float mx[2] = {m_r[0], m_r[1]};
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] *= scale_log2;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
      }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      alpha[r] = exp2f(m_r[r] - mx[r]);
      m_r[r] = mx[r];
      l_r[r] *= alpha[r];
    }
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = exp2f(s[j][e] - mx[e >> 1]);
        l_r[e >> 1] += s[j][e];
      }
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      acc[n][0] *= alpha[0];
      acc[n][1] *= alpha[0];
      acc[n][2] *= alpha[1];
      acc[n][3] *= alpha[1];
    }

    // o += p v: p's accumulator layout is the A fragment layout
    const bf16* Vt = Vs + st * FBK * LD;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const unsigned pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                              pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                              pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int nn = 0; nn < D / 16; ++nn) {
        unsigned r[4];
        ldsm_x4_trans(r, smem_u32(Vt + (kk * 16 + (lane & 7) +
                                        ((lane >> 3) & 1) * 8) * LD +
                                  nn * 16 + (lane >> 4) * 8));
        mma_bf16(acc[2 * nn], pa, r[0], r[1]);
        mma_bf16(acc[2 * nn + 1], pa, r[2], r[3]);
      }
    }
    __syncthreads();  // the next loads overwrite the stage just read
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_r[r] += __shfl_xor_sync(0xffffffffu, l_r[r], 1);
    l_r[r] += __shfl_xor_sync(0xffffffffu, l_r[r], 2);
  }
  const int row = q0 + warp * 16 + (lane >> 2);
  if (lse != nullptr && (lane & 3) == 0) {
    // m_r is in units of log2 of the scaled logits
    float* lrow = lse + ((size_t)b * gridDim.y + h) * S + row;
    lrow[0] = (m_r[0] + log2f(l_r[0])) * 0.6931471805599453f;
    lrow[8] = (m_r[1] + log2f(l_r[1])) * 0.6931471805599453f;
  }
  bf16* o0 = o + ((size_t)b * S + row) * out_row_stride + (size_t)h * d;
  bf16* o1 = o0 + (size_t)8 * out_row_stride;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    const int c = n * 8 + 2 * (lane & 3);
    if (c < d) {
      *reinterpret_cast<unsigned*>(o0 + c) =
          pack_bf16(acc[n][0] / l_r[0], acc[n][1] / l_r[0]);
      *reinterpret_cast<unsigned*>(o1 + c) =
          pack_bf16(acc[n][2] / l_r[1], acc[n][3] / l_r[1]);
    }
  }
}

template <int D>
cudaError_t launch(const bf16* q, const bf16* k, const bf16* v, bf16* o,
                   float* lse, int B, int S, int nh, int d, int row_stride,
                   int out_row_stride, float scale_log2, cudaStream_t stream) {
  const int smem = flash_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  flash_fwd_kernel<D><<<dim3(S / FBQ, nh, B), kFlashThreads, smem, stream>>>(
      q, k, v, o, lse, S, d, row_stride, out_row_stride, scale_log2);
  return cudaGetLastError();
}

}  // namespace

cudaError_t launch_flash_attn(const bf16* q, const bf16* k, const bf16* v,
                              bf16* o, float* lse, int B, int S, int nh,
                              int d, int row_stride, int out_row_stride,
                              float sm_scale, cudaStream_t stream) {
  if (S % FBQ || d % 8 || d > 128 || row_stride % 8 || out_row_stride % 8)
    return cudaErrorInvalidValue;
  const float scale_log2 = sm_scale * 1.4426950408889634f;  // log2(e)
  if (d <= 32)
    return launch<32>(q, k, v, o, lse, B, S, nh, d, row_stride, out_row_stride,
                      scale_log2, stream);
  if (d <= 64)
    return launch<64>(q, k, v, o, lse, B, S, nh, d, row_stride, out_row_stride,
                      scale_log2, stream);
  return launch<128>(q, k, v, o, lse, B, S, nh, d, row_stride, out_row_stride,
                     scale_log2, stream);
}

// q, k, v: bf16 (B, S, nh, d) views with unit stride in d, heads d apart
// and rows row_stride elements apart; o: (B, S, nh, d), rows
// out_row_stride apart; lse: (B, nh, S) fp32, or null.
extern "C" int dxmi_flash_attn(const void* q, const void* k, const void* v,
                               void* o, float* lse, int B, int S, int nh,
                               int d, int row_stride, int out_row_stride,
                               float sm_scale, void* stream) {
  return (int)launch_flash_attn(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o), lse, B, S, nh, d,
      row_stride, out_row_stride, sm_scale, (cudaStream_t)stream);
}
