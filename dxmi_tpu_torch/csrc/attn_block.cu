// K2: the whole attention block, bf16 (the ADM nets' multi-head blocks):
//   y = x + proj(attention(qkv(GroupNorm(x)))) on (B, S, C).
// K2's fp32 form (dxmi_attn_block) runs on K7's tensor-core launches and
// lives in attn_block_bb.cu; this file also keeps the pieces that K6 and
// K5's fp32 form call: the mma.sync GEMM (hgemm_kernel: launch_qkv_gemm,
// launch_hgemm) and the fp32 SIMT GEMM and attention core.
//
// Replaces: dxmi_tpu/ops/attn_block.py:_kernel (run by _pallas_forward with
// bb=1, public entry fused_attn_block), the Pallas TPU kernel that holds a
// whole (S, C) element, its q/k/v, the logits of 256-row q tiles and the
// four weight matrices in ~16 MB of VMEM.
//
// Bound: operations on the bf16 tensor cores. At ImageNet64's 32x32 maps
// (B=100, S=1024, C=384, nh=6) the block does 91 + 30 GFLOP of qkv and proj
// products and 161 GFLOP of attention, 0.29 ms at 989 TFLOP/s, against 157
// MB of input and output; the qkv GEMM alone 0.092 ms of operations against
// 315 MB of h read and qkv written (0.094 ms at 3.35 TB/s), the proj GEMM
// 0.031 ms against 157 MB of a, x and y (0.047 ms).
//
// Design: Hopper has 227 KB of shared memory per block, not 16 MB, so the
// block runs as five launches, all hand-written, with the rounding of the
// TPU kernel's bf16 body (attn_block.py:225-258):
//   (a) K1's fp32 two-pass statistics of the bf16 x (groupnorm.cu);
//   (b) h = x * (gn_scale * rstd) + (gn_bias - mean * gn_scale * rstd) in
//       fp32, rounded to bf16 once (exact: the TPU body rounds h to bf16
//       before its product), written to the attention output's buffer,
//       which is free until (d) (tma_gemm.cuh launch_prep);
//   (c) the qkv GEMM, h W_qkv on wgmma with both operands by TMA and the
//       output stored by TMA (tma_gemm.cuh): the accumulator rounded to
//       bf16, the bf16 bias added in bf16, the q and k columns scaled by
//       the bf16 d^-1/4 in bf16;
//   (d) K4's flash-attention kernel (flash_attn.cu) with sm_scale 1,
//       reading q, k and v through the qkv buffer's row stride; at d > 128
//       (one head, the CIFAR-10 nets' d = 256 blocks), which K4 does not
//       take, K7's attention launch (attn_block_bb.cu) on the same buffers,
//       which normalises p before rounding it, as the TPU body does;
//   (e) the proj GEMM, the same kernel: rounded, the bias added, then the
//       residual (by TMA) added in bf16.
// The GroupNorm is applied once per element in (b), not once per N tile of
// the qkv GEMM as the earlier mma.sync GEMM did when it normalised its
// A loads (9, 14 or 18 times at 3C = 1152, 1728, 2304). That is design (a)
// of the two considered, kept: it costs one read of x and one write of h
// (0.0538 ms at the 32x32 maps, 87% of its bytes bound) and lets A reach
// the GEMM by TMA; the other, normalising each A tile once into swizzled
// shared memory inside a 256-wide N tile, would still do it 3C / 256 times
// and keep A off TMA. Split by launch at the 32x32 maps (B=100, S=1024,
// C=384, nh=6; chip_smoke.py phase T, NVIDIA H100 80GB HBM3, 700.00 W):
// statistics 0.0615 ms, (b) 0.0538, (c) 0.2284 (bound 0.094 ms of bytes,
// 0.092 of products), (d) 0.3802, (e) 0.0947 (bound 0.071 of bytes): 0.82
// ms against 1.46 with the earlier GEMMs and the library's 1.55.
//
// K6 (attn_block_bwd.cu) keeps hgemm_kernel below: 128x128 block tiles of 8
// warps on mma.sync m16n8k16, two shared stages by cp.async, in the layouts
// its weight-gradient GEMMs need (A or B read transposed, k split over the
// grid into fp32 slices), which the wgmma GEMM does not take; it is
// redesigned with K6.
// The fp32 SIMT pieces: a GEMM (128x128 tiles, 8x8 outputs per thread, two
// shared-memory stages) computing qkv = h W_qkv + b_qkv with the q and k
// columns scaled by d^-1/4 (attn_block.py:253-254), and a flash-style
// attention (one block per (sample, head, 64-row q tile), K/V streamed in
// 64-row tiles, an online fp32 softmax, 4x4 scores and 4 rows x 16 columns
// of the output a thread).
#include <math.h>

#include "tma_gemm.cuh"

namespace {

// ---- fp32 SIMT GEMM: qkv[M,N] = A[M,K] B[K,N] + bias, q/k scaled -------
constexpr int GBM = 128, GBN = 128, GBK = 8, kGemmThreads = 256;

// Thread (ty, tx) = (tid / 16, tid % 16) owns rows {4ty..4ty+3, 64+4ty..}
// and columns {4tx..4tx+3, 64+4tx..} of the 128x128 tile; the columns below
// qk_cols are scaled by qk_scale after the bias.
__global__ void __launch_bounds__(kGemmThreads)
sgemm_kernel(const float* __restrict__ A, const float* __restrict__ Bm,
             float* __restrict__ Cm, int M, int N, int K,
             const float* __restrict__ bias, float qk_scale, int qk_cols) {
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
  auto store = [&](int st) {
    As[st][a_k][a_r] = ra.x;
    As[st][a_k + 1][a_r] = ra.y;
    As[st][a_k + 2][a_r] = ra.z;
    As[st][a_k + 3][a_r] = ra.w;
    *reinterpret_cast<float4*>(&Bs[st][b_k][b_n]) = rb;
  };

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  load(0);
  store(0);
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
    if (more) store(st ^ 1);
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
      if (n < qk_cols) v *= qk_scale;
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

// ---- K6's tensor-core GEMM C[M,N] = A[M,K] B[K,N] + epilogue ------------
constexpr int HBM = 128, HBN = 128, HBK = 32, kHThreads = 256;
constexpr int LDA = HBK + 8;  // bf16 per A row: 80 B, ldmatrix conflict-free
constexpr int LDBH = HBN + 8;  // bf16 per B row: 272 B
// kBiasScaleQK: K6's forward recompute of qkv; the plain stores of its
// weight GEMMs (attn_block_bwd.cu)
enum Epilogue { kBiasScaleQK = 0, kStoreF32 = 2, kStoreBF16 = 3 };

// A: (M, K) bf16 rows, or (K, M) when AT (A read transposed); Bm: (K, N)
// bf16, or (N, K) when BT; Cm: (M, N) bf16, Cf: (M, N) fp32. EPI ==
// kBiasScaleQK rounds, adds the bias and scales columns < qk_cols by the
// bf16 qk_scale; kStoreF32 writes the fp32 sums to Cf, kStoreBF16 rounds
// them into Cm. Block z of the grid sums k in [z k_chunk, (z + 1) k_chunk)
// and writes at Cf + z M N (kStoreF32). A tile is loaded along its unit
// stride and its fragments come from ldmatrix, with .trans where the stored
// layout is the fragment's transpose; the k order of the sums is the same
// in every layout.
template <int EPI, bool AT = false, bool BT = false>
__global__ void __launch_bounds__(kHThreads)
hgemm_kernel(const bf16* __restrict__ A, const bf16* __restrict__ Bm,
             bf16* __restrict__ Cm, float* __restrict__ Cf, int M, int N,
             int K, int k_chunk, const bf16* __restrict__ bias,
             float qk_scale, int qk_cols) {
  // A stage: [m][k] rows LDA apart, or [k][m] rows LDBH apart (AT); B
  // stage: [k][n] rows LDBH apart, or [n][k] rows LDA apart (BT)
  constexpr int AST = AT ? HBK * LDBH : HBM * LDA;
  constexpr int BST = BT ? HBN * LDA : HBK * LDBH;
  __shared__ __align__(128) bf16 As[2][AST];
  __shared__ __align__(128) bf16 Bs[2][BST];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 2, wn = warp & 3;
  const int m0 = blockIdx.y * HBM, n0 = blockIdx.x * HBN;
  const int kb = blockIdx.z * k_chunk, ke = min(K, kb + k_chunk);
  // this thread's two 8-element chunks of each tile of 128 rows x 32
  // columns (r4, c4) and of 32 rows x 128 columns (r16, c16)
  int r4[2], c4[2], r16[2], c16[2];
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const int idx = tid + u * kHThreads;
    r4[u] = idx >> 2;
    c4[u] = (idx & 3) * 8;
    r16[u] = idx >> 4;
    c16[u] = (idx & 15) * 8;
  }

  auto copy_async = [&](int k0, int st) {
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      if constexpr (BT) {
        const bool ok = n0 + r4[u] < N;
        const bf16* src = ok ? Bm + (size_t)(n0 + r4[u]) * K + k0 + c4[u] : Bm;
        cp_async16(smem_u32(&Bs[st][r4[u] * LDA + c4[u]]), src, ok ? 16 : 0);
      } else {
        const bool ok = n0 + c16[u] < N;
        const bf16* src =
            ok ? Bm + (size_t)(k0 + r16[u]) * N + n0 + c16[u] : Bm;
        cp_async16(smem_u32(&Bs[st][r16[u] * LDBH + c16[u]]), src,
                   ok ? 16 : 0);
      }
    }
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      if constexpr (AT) {
        const bool ok = m0 + c16[u] < M;
        const bf16* src = ok ? A + (size_t)(k0 + r16[u]) * M + m0 + c16[u] : A;
        cp_async16(smem_u32(&As[st][r16[u] * LDBH + c16[u]]), src,
                   ok ? 16 : 0);
      } else {
        const int m = m0 + r4[u];
        const bool ok = m < M;
        const bf16* src = ok ? A + (size_t)m * K + k0 + c4[u] : A;
        cp_async16(smem_u32(&As[st][r4[u] * LDA + c4[u]]), src, ok ? 16 : 0);
      }
    }
    cp_async_commit();
  };

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  copy_async(kb, 0);
  cp_async_wait<0>();
  __syncthreads();

  const int n_k = (ke - kb) / HBK;
  for (int kt = 0; kt < n_k; ++kt) {
    const int st = kt & 1;
    const bool more = kt + 1 < n_k;
    // stage st^1 was last read before the last barrier
    if (more) copy_async(kb + (kt + 1) * HBK, st ^ 1);
#pragma unroll
    for (int kk = 0; kk < HBK; kk += 16) {
      unsigned a[4][4], b[4][2];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if constexpr (AT)  // stored [k][m]: the 8x8 blocks transposed
          ldsm_x4_trans(a[i], smem_u32(&As[st][(kk + (lane & 7) +
                                                (lane >> 4) * 8) * LDBH +
                                               wm * 64 + i * 16 +
                                               ((lane >> 3) & 1) * 8]));
        else
          ldsm_x4(a[i], smem_u32(&As[st][(wm * 64 + i * 16 + (lane & 15)) *
                                             LDA +
                                         kk + (lane >> 4) * 8]));
      }
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        unsigned r[4];
        if constexpr (BT)  // stored [n][k]: the fragments' own layout
          ldsm_x4(r, smem_u32(&Bs[st][(wn * 32 + jj * 16 + (lane & 7) +
                                       (lane >> 4) * 8) * LDA +
                                      kk + ((lane >> 3) & 1) * 8]));
        else
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
    if (more) cp_async_wait<0>();
    __syncthreads();
  }

  const int g = lane >> 2, t = lane & 3;
  if constexpr (EPI == kStoreF32) Cf += (size_t)blockIdx.z * M * N;
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
        const float* c = acc[i][j] + 2 * half;
        if constexpr (EPI == kStoreF32) {
          *reinterpret_cast<float2*>(Cf + (size_t)m * N + n) =
              make_float2(c[0], c[1]);
        } else if constexpr (EPI == kStoreBF16) {
          *reinterpret_cast<unsigned*>(Cm + (size_t)m * N + n) =
              pack_bf16(c[0], c[1]);
        } else {
          float v[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            v[e] = rb(rb(c[e]) + __bfloat162float(bias[n + e]));
            if (n + e < qk_cols) v[e] = rb(v[e] * qk_scale);
          }
          *reinterpret_cast<unsigned*>(Cm + (size_t)m * N + n) =
              pack_bf16(v[0], v[1]);
        }
      }
    }
  }
}

// The epilogue of K2's wgmma GEMMs, in the TPU body's roundings, a
// pair of columns n, n + 1 of one row: v = bf16(bf16(acc) + bias); then
// the q and k columns (n < qk_cols) bf16(v qk_scale) (qkv), or
// bf16(resid + v) (proj, resid); returned packed. Its roundings are paired
// conversions (rb2); a column's parameter is its bias.
struct BlockEpi {
  const bf16* bias;
  float qk_scale;
  int qk_cols;
  bool resid;
  __device__ __forceinline__ float2 col(int n) const {
    return make_float2(__bfloat162float(bias[n]), 0.f);
  }
  __device__ __forceinline__ unsigned operator()(int n, float2 c0, float2 c1,
                                                 float v0, float v1,
                                                 unsigned r) const {
    rb2(v0, v1);
    v0 += c0.x;
    v1 += c1.x;
    const unsigned u = rb2(v0, v1);
    if (resid)
      return pack_bf16(__uint_as_float(r << 16) + v0,
                       __uint_as_float(r & 0xffff0000u) + v1);
    // n even and qk_cols a multiple of 8: both columns on the same side
    if (n < qk_cols) return pack_bf16(v0 * qk_scale, v1 * qk_scale);
    return u;
  }
};

}  // namespace

cudaError_t launch_qkv_gemm(const float* h, const float* w, const float* b,
                            float* qkv, int M, int C, float qk_scale,
                            cudaStream_t s) {
  if (C % GBK) return cudaErrorInvalidValue;
  dim3 g((3 * C + GBN - 1) / GBN, (M + GBM - 1) / GBM);
  sgemm_kernel<<<g, kGemmThreads, 0, s>>>(h, w, qkv, M, 3 * C, C, b,
                                          qk_scale, 2 * C);
  return cudaGetLastError();
}

cudaError_t launch_qkv_gemm(const bf16* h, const bf16* w, const bf16* b,
                            bf16* qkv, int M, int C, float qk_scale,
                            cudaStream_t s) {
  if (C % HBK) return cudaErrorInvalidValue;
  dim3 g((3 * C + HBN - 1) / HBN, (M + HBM - 1) / HBM);
  hgemm_kernel<kBiasScaleQK><<<g, kHThreads, 0, s>>>(
      h, w, qkv, nullptr, M, 3 * C, C, C, b, qk_scale, 2 * C);
  return cudaGetLastError();
}

cudaError_t launch_hgemm(const bf16* A, const bf16* B, float* c_f, bf16* c_t,
                         int M, int N, int K, int k_chunk, bool a_trans,
                         bool b_trans, cudaStream_t s) {
  if (K % HBK || k_chunk % HBK || k_chunk <= 0 || N % 8 || M % 8 ||
      (c_f == nullptr) == (c_t == nullptr))
    return cudaErrorInvalidValue;
  const dim3 g((N + HBN - 1) / HBN, (M + HBM - 1) / HBM,
               (K + k_chunk - 1) / k_chunk);
  if (!a_trans && b_trans && c_f != nullptr)
    hgemm_kernel<kStoreF32, false, true><<<g, kHThreads, 0, s>>>(
        A, B, nullptr, c_f, M, N, K, k_chunk, nullptr, 1.f, 0);
  else if (!a_trans && b_trans)
    hgemm_kernel<kStoreBF16, false, true><<<g, kHThreads, 0, s>>>(
        A, B, c_t, nullptr, M, N, K, k_chunk, nullptr, 1.f, 0);
  else if (a_trans && !b_trans && c_f != nullptr)
    hgemm_kernel<kStoreF32, true, false><<<g, kHThreads, 0, s>>>(
        A, B, nullptr, c_f, M, N, K, k_chunk, nullptr, 1.f, 0);
  else
    return cudaErrorInvalidValue;  // a layout K6 does not use
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
// fp32 scratch; qkv: (B, S, 3C) and attn: (B, S, C) bf16 scratch (attn holds
// h until the attention core writes it). Needs S % 64 == 0, C % 32 == 0,
// C / G <= 64 and d = C/nh with d % 8 == 0 and d <= 256 (K4's core up to
// 128, K7's above).
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
  if (C % 32) return (int)cudaErrorInvalidValue;
  const int M = B * S, d = C / nh;
  // the TPU body scales by jnp.asarray(d ** -0.25, bf16)
  const float qk_scale =
      __bfloat162float(__float2bfloat16_rn((float)(1.0 / sqrt(sqrt((double)d)))));
  cudaError_t err =
      launch_gn_stats_bf16(xb, mean_c, rstd_c, B, S, C, G, eps, 0, s);
  if (err == cudaSuccess)
    err = tma_gemm::launch_prep<true, false>(xb, attnb, mean_c, rstd_c, gs,
                                             gb, nullptr, B, S, C, s);
  if (err == cudaSuccess)
    err = tma_gemm::launch<false>(
        attnb, w_qkv, qkvb, nullptr, M, 3 * C, C,
        BlockEpi{static_cast<const bf16*>(b_qkv), qk_scale, 2 * C, false}, s);
  if (err == cudaSuccess)
    err = d <= 128 ? launch_flash_attn(qkvb, qkvb + C, qkvb + 2 * C, attnb,
                                       nullptr, B, S, nh, d, 3 * C, C, 1.f, s)
                   : launch_attn_core_bb(qkvb, attnb, B, S, C, nh, s);
  if (err == cudaSuccess)
    err = tma_gemm::launch<false>(
        attnb, w_proj, y, xb, M, C, C,
        BlockEpi{static_cast<const bf16*>(b_proj), 1.f, 0, true}, s);
  return (int)err;
}
