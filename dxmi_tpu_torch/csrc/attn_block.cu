// K2: the whole attention block, fp32:
//   y = x + proj(attention(qkv(GroupNorm(x)))) on (B, S, C).
//
// Replaces: dxmi_tpu/ops/attn_block.py:_kernel (run by _pallas_forward with
// bb=1, public entry fused_attn_block), the Pallas TPU kernel that holds a
// whole (S, C) element, its q/k/v, the logits of 256-row q tiles and the
// four weight matrices in ~16 MB of VMEM.
//
// Bound on the H100: operations. At the main path's shape (B=100, S=256,
// C=256, one head) the block does 20 GFLOP of fp32 products (qkv 10.1,
// logits 3.4, AV 3.4, proj 3.4) against 52 MB of input and output: 0.30 ms
// at the 67 TFLOP/s fp32 peak against 0.016 ms of memory time. fp32 is the
// reference's precision here, so the tensor cores (bf16/TF32) are not used.
//
// Design: Hopper has 227 KB of shared memory per block, not 16 MB, so the
// block is tiled into four launches, all hand-written:
//   (a) K1's per-(sample, group) statistics, written per channel;
//   (b) a SIMT fp32 GEMM (128x128 tiles, 8x8 outputs per thread, two
//       shared-memory stages) that applies GN while loading x and computes
//       qkv = h W_qkv + b_qkv, scaling the q and k columns by d^-1/4 in its
//       epilogue (attn_block.py:253-254);
//   (c) a flash-style attention kernel: one block per (sample, head,
//       64-row q tile) keeps the q tile in shared memory, streams K/V in
//       64-row tiles, carries an online fp32 softmax (running max and sum
//       per row), and gives each thread 4x4 scores and 4 rows x 16 columns
//       of the output in registers;
//   (d) the same GEMM for proj, with a bias-plus-residual epilogue.
// The qkv and attention-output intermediates go through device memory
// (the TPU kernel keeps them in VMEM); fusing them is later work.
//
// bf16 form (the ADM nets' multi-head blocks, dxmi_attn_block_bf16): the same
// four launches with the rounding of the TPU kernel's bf16 body
// (attn_block.py:225-258). Bound: operations on the bf16 tensor cores; at
// ImageNet64's 32x32 maps (B=100, S=1024, C=384, nh=6) the block does
// 91 + 30 GFLOP of qkv and proj products and 161 GFLOP of attention, 0.29 ms
// at 989 TFLOP/s, against 157 MB of input and output. (a) takes fp32
// two-pass statistics of the bf16 x; (b) and (d) are a tensor-core GEMM
// (128x128 block tiles of 8 warps, each 64x32 with mma.sync m16n8k16 bf16,
// fp32 accumulators, ldmatrix, two shared stages, weights by cp.async) whose
// A loads apply h = x * (gn_scale * rstd) + (gn_bias - mean * gn_scale *
// rstd) in fp32 and round h to bf16 (b), or copy the attention output (d);
// their epilogues round the accumulator to bf16, add the bf16 bias in bf16,
// and scale q and k by the bf16 d^-1/4 in bf16 (b) or add the residual in
// bf16 (d); (c) is K4's flash-attention kernel (flash_attn.cu) with
// sm_scale 1, reading q, k and v through the qkv buffer's row stride.
#include <math.h>

#include "common.cuh"

namespace {

// ---- (b), (d): fp32 SIMT GEMM C[M,N] = A[M,K] B[K,N] + epilogue --------
constexpr int GBM = 128, GBN = 128, GBK = 8, kGemmThreads = 256;

enum Prologue { kPlainA = 0, kGroupNormA = 1 };
enum Epilogue { kBiasScaleQK = 0, kBiasResidual = 1 };

// Thread (ty, tx) = (tid / 16, tid % 16) owns rows {4ty..4ty+3, 64+4ty..}
// and columns {4tx..4tx+3, 64+4tx..} of the 128x128 tile.
template <int PRO, int EPI>
__global__ void __launch_bounds__(kGemmThreads)
sgemm_kernel(const float* __restrict__ A, const float* __restrict__ Bm,
             float* __restrict__ Cm, int M, int N, int K,
             const float* __restrict__ bias, const float* __restrict__ resid,
             float qk_scale, int qk_cols, const float* __restrict__ mean_c,
             const float* __restrict__ rstd_c, const float* __restrict__ gs,
             const float* __restrict__ gb, int rows_per_sample) {
  __shared__ __align__(16) float As[2][GBK][GBM + 4];  // transposed A tiles
  __shared__ __align__(16) float Bs[2][GBK][GBN + 4];
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int m0 = blockIdx.y * GBM, n0 = blockIdx.x * GBN;
  // this thread's loads: A row a_r, k offset a_k; B row b_k, column b_n
  const int a_r = tid >> 1, a_k = (tid & 1) * 4, a_m = m0 + a_r;
  const int b_k = tid >> 5, b_n = (tid & 31) * 4;
  float4 ra = make_float4(0.f, 0.f, 0.f, 0.f), rb = ra;

  auto load = [&](int k0) {
    ra = make_float4(0.f, 0.f, 0.f, 0.f);
    rb = ra;
    if (a_m < M) ra = ldg4(A + (size_t)a_m * K + k0 + a_k);
    if (n0 + b_n < N) rb = ldg4(Bm + (size_t)(k0 + b_k) * N + n0 + b_n);
  };
  auto store = [&](int k0, int st) {
    float4 v = ra;
    if (PRO == kGroupNormA && a_m < M) {
      const int k = k0 + a_k;
      const size_t bk = (size_t)(a_m / rows_per_sample) * K + k;
      v = gn_affine4(v, ldg4(mean_c + bk), ldg4(rstd_c + bk), ldg4(gs + k),
                     ldg4(gb + k));
    }
    As[st][a_k][a_r] = v.x;
    As[st][a_k + 1][a_r] = v.y;
    As[st][a_k + 2][a_r] = v.z;
    As[st][a_k + 3][a_r] = v.w;
    *reinterpret_cast<float4*>(&Bs[st][b_k][b_n]) = rb;
  };

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  load(0);
  store(0, 0);
  __syncthreads();
  int st = 0;
  for (int k0 = 0; k0 < K; k0 += GBK, st ^= 1) {
    const bool more = k0 + GBK < K;
    if (more) load(k0 + GBK);
#pragma unroll
    for (int kk = 0; kk < GBK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&As[st][kk][ty * 4]);
      const float4 a1 =
          *reinterpret_cast<const float4*>(&As[st][kk][64 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Bs[st][kk][tx * 4]);
      const float4 b1 =
          *reinterpret_cast<const float4*>(&Bs[st][kk][64 + tx * 4]);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    // the other stage was last read before the previous barrier
    if (more) store(k0 + GBK, st ^ 1);
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = m0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + i - 4);
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int n = n0 + (j < 4 ? tx * 4 + j : 64 + tx * 4 + j - 4);
      if (n >= N) continue;
      float v = acc[i][j] + bias[n];
      if (EPI == kBiasScaleQK) {
        if (n < qk_cols) v *= qk_scale;
      } else {
        v = resid[(size_t)m * N + n] + v;
      }
      Cm[(size_t)m * N + n] = v;
    }
  }
}

// ---- (c): attention core, online softmax -------------------------------
constexpr int QT = 64, KT = 64, kAttnThreads = 256, LDP = QT + 4;

__host__ __device__ constexpr int attn_smem_floats(int d) {
  return (QT + KT) * (d + 4) + KT * d + KT * LDP;
}

// qkv: (B, S, 3C) with q and k pre-scaled; out: (B, S, C). Thread
// (ty, tx) = (tid / 16, tid % 16) owns q rows 4ty..4ty+3 of the tile; its
// scores are the keys {tx + 16j} of each K/V tile, its output columns
// {64i + 4tx .. +3}. A row's 16 threads are 16 lanes of one warp.
__global__ void __launch_bounds__(kAttnThreads, 1)
attn_fwd_kernel(const float* __restrict__ qkv, float* __restrict__ out, int S,
                int C, int d) {
  extern __shared__ __align__(16) float smem[];
  const int ldq = d + 4;
  float* Qs = smem;             // [QT][ldq]
  float* Ks = Qs + QT * ldq;    // [KT][ldq]
  float* Vs = Ks + KT * ldq;    // [KT][d]
  float* Pt = Vs + KT * d;      // [KT][LDP]: probabilities, key-major
  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * QT;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const size_t row3 = 3 * (size_t)C;
  const float* base = qkv + (size_t)b * S * row3 + (size_t)h * d;
  const int d4 = d / 4;

  for (int idx = tid; idx < QT * d4; idx += kAttnThreads) {
    const int i = idx / d4, c4 = (idx - i * d4) * 4;
    *reinterpret_cast<float4*>(Qs + i * ldq + c4) =
        ldg4(base + (size_t)(q0 + i) * row3 + c4);
  }

  float m_i[4], l_i[4];
  float4 o[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    m_i[r] = -INFINITY;
    l_i[r] = 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i) o[r][i] = make_float4(0.f, 0.f, 0.f, 0.f);
  }

  for (int k0 = 0; k0 < S; k0 += KT) {
    __syncthreads();  // the previous tile's K, V and P are no longer read
    for (int idx = tid; idx < KT * d4; idx += kAttnThreads) {
      const int j = idx / d4, c4 = (idx - j * d4) * 4;
      const float* src = base + (size_t)(k0 + j) * row3 + c4;
      *reinterpret_cast<float4*>(Ks + j * ldq + c4) = ldg4(src + C);
      *reinterpret_cast<float4*>(Vs + j * d + c4) = ldg4(src + 2 * C);
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[r][j] = 0.f;
    for (int c = 0; c < d; c += 4) {
      float4 q[4], k[4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
        q[r] = *reinterpret_cast<const float4*>(Qs + (ty * 4 + r) * ldq + c);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        k[j] = *reinterpret_cast<const float4*>(Ks + (tx + 16 * j) * ldq + c);
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[r][j] = fmaf(q[r].x, k[j].x, s[r][j]);
          s[r][j] = fmaf(q[r].y, k[j].y, s[r][j]);
          s[r][j] = fmaf(q[r].z, k[j].z, s[r][j]);
          s[r][j] = fmaf(q[r].w, k[j].w, s[r][j]);
        }
    }

#pragma unroll
    for (int r = 0; r < 4; ++r) {
      float mx = fmaxf(fmaxf(s[r][0], s[r][1]), fmaxf(s[r][2], s[r][3]));
#pragma unroll
      for (int o_ = 8; o_ > 0; o_ >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o_));
      const float m_new = fmaxf(m_i[r], mx);
      const float alpha = expf(m_i[r] - m_new);
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[r][j] - m_new);
        Pt[(tx + 16 * j) * LDP + ty * 4 + r] = p;
        psum += p;
      }
#pragma unroll
      for (int o_ = 8; o_ > 0; o_ >>= 1)
        psum += __shfl_xor_sync(0xffffffffu, psum, o_);
      l_i[r] = l_i[r] * alpha + psum;
      m_i[r] = m_new;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        o[r][i].x *= alpha; o[r][i].y *= alpha;
        o[r][i].z *= alpha; o[r][i].w *= alpha;
      }
    }
    __syncwarp();  // a row's probabilities come from 16 lanes of this warp

    for (int j = 0; j < KT; ++j) {
      const float4 p = *reinterpret_cast<const float4*>(Pt + j * LDP + ty * 4);
      const float pr[4] = {p.x, p.y, p.z, p.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (64 * i + tx * 4 < d) {
          const float4 v =
              *reinterpret_cast<const float4*>(Vs + j * d + 64 * i + tx * 4);
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            o[r][i].x = fmaf(pr[r], v.x, o[r][i].x);
            o[r][i].y = fmaf(pr[r], v.y, o[r][i].y);
            o[r][i].z = fmaf(pr[r], v.z, o[r][i].z);
            o[r][i].w = fmaf(pr[r], v.w, o[r][i].w);
          }
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const float inv_l = 1.f / l_i[r];
    float* orow = out + ((size_t)b * S + q0 + ty * 4 + r) * C + (size_t)h * d;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (64 * i + tx * 4 < d)
        *reinterpret_cast<float4*>(orow + 64 * i + tx * 4) =
            make_float4(o[r][i].x * inv_l, o[r][i].y * inv_l,
                        o[r][i].z * inv_l, o[r][i].w * inv_l);
    }
  }
}

// ---- bf16 form: tensor-core GEMM C[M,N] = A[M,K] B[K,N] + epilogue -------
constexpr int HBM = 128, HBN = 128, HBK = 32, kHThreads = 256;
constexpr int LDA = HBK + 8;  // bf16 per A row: 80 B, ldmatrix conflict-free
constexpr int LDBH = HBN + 8;  // bf16 per B row: 272 B

// A: (M, K) bf16 rows; Bm: (K, N) bf16; Cm: (M, N) bf16. PRO == kGroupNormA
// normalises A on load with per-(sample, channel) statistics; EPI ==
// kBiasScaleQK rounds, adds the bias and scales columns < qk_cols by the
// bf16 qk_scale; EPI == kBiasResidual rounds, adds the bias, then resid.
template <int PRO, int EPI>
__global__ void __launch_bounds__(kHThreads)
hgemm_kernel(const bf16* __restrict__ A, const bf16* __restrict__ Bm,
             bf16* __restrict__ Cm, int M, int N, int K,
             const bf16* __restrict__ bias, const bf16* __restrict__ resid,
             float qk_scale, int qk_cols, const float* __restrict__ mean_c,
             const float* __restrict__ rstd_c, const float* __restrict__ gs,
             const float* __restrict__ gb, int rows_per_sample) {
  __shared__ __align__(128) bf16 As[2][HBM * LDA];
  __shared__ __align__(128) bf16 Bs[2][HBK * LDBH];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 2, wn = warp & 3;
  const int m0 = blockIdx.y * HBM, n0 = blockIdx.x * HBN;
  // this thread's two 8-element chunks of each A tile and of each B tile
  int a_r[2], a_c[2], b_r[2], b_c[2];
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const int idx = tid + u * kHThreads;
    a_r[u] = idx >> 2;
    a_c[u] = (idx & 3) * 8;
    b_r[u] = idx >> 4;
    b_c[u] = (idx & 15) * 8;
  }
  uint4 ra[2];

  auto copy_b_async = [&](int k0, int st) {
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const bool ok = n0 + b_c[u] < N;
      const bf16* src = ok ? Bm + (size_t)(k0 + b_r[u]) * N + n0 + b_c[u] : Bm;
      cp_async16(smem_u32(&Bs[st][b_r[u] * LDBH + b_c[u]]), src, ok ? 16 : 0);
    }
    if (PRO != kGroupNormA) {
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int m = m0 + a_r[u];
        const bool ok = m < M;
        const bf16* src = ok ? A + (size_t)m * K + k0 + a_c[u] : A;
        cp_async16(smem_u32(&As[st][a_r[u] * LDA + a_c[u]]), src, ok ? 16 : 0);
      }
    }
    cp_async_commit();
  };
  auto load_a = [&](int k0) {  // GN path: global -> registers
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int m = m0 + a_r[u];
      ra[u] = m < M ? __ldg(reinterpret_cast<const uint4*>(
                          A + (size_t)m * K + k0 + a_c[u]))
                    : make_uint4(0u, 0u, 0u, 0u);
    }
  };
  auto store_a = [&](int k0, int st) {  // GN path: normalise, round, store
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int m = m0 + a_r[u];
      uint4 packed = make_uint4(0u, 0u, 0u, 0u);
      if (m < M) {
        const bf16* xv = reinterpret_cast<const bf16*>(&ra[u]);
        unsigned* out = reinterpret_cast<unsigned*>(&packed);
        const int k = k0 + a_c[u];
        const size_t bk = (size_t)(m / rows_per_sample) * K + k;
#pragma unroll
        for (int j = 0; j < 8; j += 2) {
          float hv[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float sc = __fmul_rn(gs[k + j + e], rstd_c[bk + j + e]);
            const float sh = __fsub_rn(gb[k + j + e],
                                       __fmul_rn(mean_c[bk + j + e], sc));
            hv[e] = __fadd_rn(__fmul_rn(__bfloat162float(xv[j + e]), sc), sh);
          }
          out[j / 2] = pack_bf16(hv[0], hv[1]);
        }
      }
      *reinterpret_cast<uint4*>(&As[st][a_r[u] * LDA + a_c[u]]) = packed;
    }
  };

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  copy_b_async(0, 0);
  if (PRO == kGroupNormA) {
    load_a(0);
    store_a(0, 0);
  }
  cp_async_wait<0>();
  __syncthreads();

  const int n_k = K / HBK;
  for (int kt = 0; kt < n_k; ++kt) {
    const int st = kt & 1;
    const bool more = kt + 1 < n_k;
    if (more) {  // stage st^1 was last read before the last barrier
      copy_b_async((kt + 1) * HBK, st ^ 1);
      if (PRO == kGroupNormA) load_a((kt + 1) * HBK);
    }
#pragma unroll
    for (int kk = 0; kk < HBK; kk += 16) {
      unsigned a[4][4], b[4][2];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        ldsm_x4(a[i], smem_u32(&As[st][(wm * 64 + i * 16 + (lane & 15)) * LDA +
                                       kk + (lane >> 4) * 8]));
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        unsigned r[4];
        ldsm_x4_trans(r, smem_u32(&Bs[st][(kk + (lane & 7) +
                                           ((lane >> 3) & 1) * 8) * LDBH +
                                          wn * 32 + jj * 16 +
                                          (lane >> 4) * 8]));
        b[2 * jj][0] = r[0];
        b[2 * jj][1] = r[1];
        b[2 * jj + 1][0] = r[2];
        b[2 * jj + 1][1] = r[3];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_bf16(acc[i][j], a[i], b[j][0], b[j][1]);
    }
    if (more) {
      if (PRO == kGroupNormA) store_a((kt + 1) * HBK, st ^ 1);
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
          float u = rb(rb(acc[i][j][2 * half + e]) +
                       __bfloat162float(bias[n + e]));
          if (EPI == kBiasScaleQK) {
            if (n + e < qk_cols) u = rb(u * qk_scale);
          } else {
            u = rb(__bfloat162float(resid[(size_t)m * N + n + e]) + u);
          }
          v[e] = u;
        }
        *reinterpret_cast<unsigned*>(Cm + (size_t)m * N + n) =
            pack_bf16(v[0], v[1]);
      }
    }
  }
}

}  // namespace

cudaError_t launch_qkv_gemm(const float* h, const float* w, const float* b,
                            float* qkv, int M, int C, float qk_scale,
                            cudaStream_t s) {
  if (C % GBK) return cudaErrorInvalidValue;
  dim3 g((3 * C + GBN - 1) / GBN, (M + GBM - 1) / GBM);
  sgemm_kernel<kPlainA, kBiasScaleQK><<<g, kGemmThreads, 0, s>>>(
      h, w, qkv, M, 3 * C, C, b, nullptr, qk_scale, 2 * C, nullptr, nullptr,
      nullptr, nullptr, 1);
  return cudaGetLastError();
}

cudaError_t launch_qkv_gemm(const bf16* h, const bf16* w, const bf16* b,
                            bf16* qkv, int M, int C, float qk_scale,
                            cudaStream_t s) {
  if (C % HBK) return cudaErrorInvalidValue;
  dim3 g((3 * C + HBN - 1) / HBN, (M + HBM - 1) / HBM);
  hgemm_kernel<kPlainA, kBiasScaleQK><<<g, kHThreads, 0, s>>>(
      h, w, qkv, M, 3 * C, C, b, nullptr, qk_scale, 2 * C, nullptr, nullptr,
      nullptr, nullptr, 1);
  return cudaGetLastError();
}

cudaError_t launch_attn_core_f32(const float* qkv, float* out, int B, int S,
                                 int C, int nh, cudaStream_t stream) {
  const int d = C / nh;
  const int smem = attn_smem_floats(d) * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      attn_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  attn_fwd_kernel<<<dim3(S / QT, nh, B), kAttnThreads, smem, stream>>>(
      qkv, out, S, C, d);
  return cudaGetLastError();
}

// bf16 x, y: (B, S, C); w_qkv: (C, 3C) with [3, nh, d] output columns, b_qkv
// (3C,), w_proj (C, C), b_proj (C,) bf16; gs, gb fp32; mean_c/rstd_c: (B, C)
// fp32 scratch; qkv: (B, S, 3C) and attn: (B, S, C) bf16 scratch. Needs
// S % 64 == 0, C % 32 == 0, C / G <= 64 and d = C/nh with d % 8 == 0 and
// d <= 128.
extern "C" int dxmi_attn_block_bf16(const void* x, const float* gs,
                                    const float* gb, const void* w_qkv,
                                    const void* b_qkv, const void* w_proj,
                                    const void* b_proj, void* y,
                                    float* mean_c, float* rstd_c, void* qkv,
                                    void* attn, int B, int S, int C, int nh,
                                    int G, float eps, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const bf16* xb = static_cast<const bf16*>(x);
  bf16* qkvb = static_cast<bf16*>(qkv);
  bf16* attnb = static_cast<bf16*>(attn);
  if (C % HBK) return (int)cudaErrorInvalidValue;
  cudaError_t err =
      launch_gn_stats_bf16(xb, mean_c, rstd_c, B, S, C, G, eps, 0, s);
  if (err != cudaSuccess) return (int)err;

  const int M = B * S, d = C / nh;
  // the TPU body scales by jnp.asarray(d ** -0.25, bf16)
  const float qk_scale =
      __bfloat162float(__float2bfloat16_rn((float)(1.0 / sqrt(sqrt((double)d)))));
  dim3 g_qkv((3 * C + HBN - 1) / HBN, (M + HBM - 1) / HBM);
  hgemm_kernel<kGroupNormA, kBiasScaleQK><<<g_qkv, kHThreads, 0, s>>>(
      xb, static_cast<const bf16*>(w_qkv), qkvb, M, 3 * C, C,
      static_cast<const bf16*>(b_qkv), nullptr, qk_scale, 2 * C, mean_c,
      rstd_c, gs, gb, S);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  err = launch_flash_attn(qkvb, qkvb + C, qkvb + 2 * C, attnb, nullptr, B, S,
                          nh, d, 3 * C, C, 1.f, s);
  if (err != cudaSuccess) return (int)err;

  dim3 g_proj((C + HBN - 1) / HBN, (M + HBM - 1) / HBM);
  hgemm_kernel<kPlainA, kBiasResidual><<<g_proj, kHThreads, 0, s>>>(
      attnb, static_cast<const bf16*>(w_proj), static_cast<bf16*>(y), M, C, C,
      static_cast<const bf16*>(b_proj), xb, 1.f, 0, nullptr, nullptr, nullptr,
      nullptr, S);
  return (int)cudaGetLastError();
}

// x, y: (B, S, C); w_qkv: (C, 3C) with [3, nh, d] output columns; b_qkv:
// (3C,); w_proj: (C, C); mean_c/rstd_c: (B, C); qkv: (B, S, 3C) and attn:
// (B, S, C) scratch. Needs S % 64 == 0, C % 32 == 0, d = C/nh with
// d % 16 == 0 and d <= 256.
extern "C" int dxmi_attn_block(const float* x, const float* gs,
                               const float* gb, const float* w_qkv,
                               const float* b_qkv, const float* w_proj,
                               const float* b_proj, float* y, float* mean_c,
                               float* rstd_c, float* qkv, float* attn, int B,
                               int S, int C, int nh, int G, float eps,
                               void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = launch_gn_stats(x, mean_c, rstd_c, B, S, C, G, eps, s);
  if (err != cudaSuccess) return (int)err;

  const int M = B * S, d = C / nh;
  const float qk_scale = (float)(1.0 / sqrt(sqrt((double)d)));
  dim3 g_qkv((3 * C + GBN - 1) / GBN, (M + GBM - 1) / GBM);
  sgemm_kernel<kGroupNormA, kBiasScaleQK><<<g_qkv, kGemmThreads, 0, s>>>(
      x, w_qkv, qkv, M, 3 * C, C, b_qkv, nullptr, qk_scale, 2 * C, mean_c,
      rstd_c, gs, gb, S);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  err = launch_attn_core_f32(qkv, attn, B, S, C, nh, s);
  if (err != cudaSuccess) return (int)err;

  dim3 g_proj((C + GBN - 1) / GBN, (M + GBM - 1) / GBM);
  sgemm_kernel<kPlainA, kBiasResidual><<<g_proj, kGemmThreads, 0, s>>>(
      attn, w_proj, y, M, C, C, b_proj, x, 1.f, 0, nullptr, nullptr, nullptr,
      nullptr, S);
  return (int)cudaGetLastError();
}
