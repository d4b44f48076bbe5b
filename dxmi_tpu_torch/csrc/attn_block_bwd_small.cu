// K6's fp32 form at small maps: the attention block's fused backward in one
// launch of one block (or a cluster of two) per sample, then one launch that
// sums the samples' parameter cotangents in sample order.
//
// Replaces: dxmi_tpu/ops/attn_block.py:406 _kernel_bwd (grid (B,), pallas_call
// :566) for fp32 x at S = 64 and C <= 64 (configs/imagenet64/conv16.yaml's
// 8x8 map: S = 64, C = 64, two heads of d = 32). Its arithmetic is the one
// attn_block_bwd.cu states (fp32 throughout: every rounding T() there is the
// identity), with two-pass fp32 GroupNorm statistics as that route takes.
//
// Design. The TPU runs one program per sample that keeps the sample's
// working set and the weights in VMEM and accumulates the parameter
// cotangents in sample order (program 0 writes, later programs add). Here a
// block of 256 threads, or a cluster of two when the heads split evenly
// (each CTA its half of the heads, so that a sample's latency halves and
// batch 64 fills 128 of the 132 SMs), takes one sample and keeps every
// per-sample tensor in shared memory; at C = 64 (floats, each (S, w) buffer
// padded to w + 4 columns):
//   x, h, ct, da (then dh), a (one head) (64, 68) each  87,040 bytes
//   the softmax w (then dlg) of one head (64, 68)        17,408
//   qkv and dqkv (64, 196) each                         100,352
//   one 16-row chunk of a weight (192, 20)               15,360
//   GroupNorm parameters, statistics and column sums      2,048
// 222,208 bytes of the 227 KB a block may hold. The weights (W_qkv 48 KB,
// W_proj 16 KB), shared by every sample, are read from L2 a 16-row chunk at
// a time, the next chunk loaded into registers while the last one is
// multiplied. In a cluster each CTA computes h and the GroupNorm statistics
// itself, its heads' columns of qkv, da and dqkv and their share of dh; the
// two shares of dh are added in rank order through distributed shared
// memory. The next widths do not fit: C = 96 at S = 64 needs 326 KB,
// S = 128 at C = 64 needs 410 KB; those maps keep the multi-launch route
// (attn_block_bwd.cu). Launch 1 writes dx and the sample's fp32 partials of
// dW_qkv, dW_proj, db_qkv, db_proj, dgs and dgb; launch 2 sums the B
// partials of each element in sample order, the TPU body's order, with no
// atomics, so a replay is bit for bit the same.
//
// Arithmetic: fp32 FFMA on the SIMT units. Every product is a block of 16 x
// 16 threads, each with a 4 x 4 (or 4 x 2, 2 x 4, ...) register tile whose
// operands come from shared memory in 16-byte loads (8 loads per 64 FFMA);
// row-major operands are read along k, transposed ones along the other
// index, and the pitches (4 mod 32 floats) keep the loads free of bank
// conflicts. Each output sums its k terms in order.
//
// Bound on the H100: operations. The block's GEMMs (qkv recompute, da, dh,
// dW_qkv, dW_proj: 11 S C^2 multiply-adds a sample) and attention products
// (6 nh S^2 d) come to 4.5 M multiply-adds a sample at (64, 64, nh 2): 0.58
// GFLOP at batch 64, 8.6 us at 67 TFLOP/s.
#include <math.h>

#include "common.cuh"

namespace {

constexpr int kS = 64, kThreads = 256, kKC = 16, kLdB = kKC + 4, kG = 32;

// Shared-memory plan of one sample at width C (offsets in floats; every
// offset and pitch a multiple of 4, every pitch 4 mod 32)
template <int C>
struct Plan {
  static constexpr int PC = C + 4, PQ = 3 * C + 4, PW = kS + 4;
  static constexpr int X = 0, H = X + kS * PC, CT = H + kS * PC,
                       DA = CT + kS * PC, A = DA + kS * PC, W = A + kS * PC,
                       QKV = W + kS * PW, DQKV = QKV + kS * PQ,
                       BS = DQKV + kS * PQ, GS = BS + 3 * C * kLdB,
                       GB = GS + C, MEAN = GB + C, RSTD = MEAN + kG,
                       SUMS = RSTD + kG, GSTAT = SUMS + 2 * C,
                       TOTAL = GSTAT + 2 * kG;
  static constexpr int BYTES = TOTAL * 4;
  // a sample's partials: dW_qkv (C, 3C), dW_proj (C, C), db_qkv (3C),
  // db_proj, dgs, dgb (C each)
  static constexpr int NPART = 4 * C * C + 6 * C;
  static_assert(BYTES <= 227 * 1024, "one sample must fit in a block");
};

template <int N>
__device__ __forceinline__ void ld_vec(const float* p, float (&v)[N]) {
  if constexpr (N == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    v[0] = t.x;
    v[1] = t.y;
    v[2] = t.z;
    v[3] = t.w;
  } else if constexpr (N == 2) {
    const float2 t = *reinterpret_cast<const float2*>(p);
    v[0] = t.x;
    v[1] = t.y;
  } else {
    v[0] = *p;
  }
}

// acc[i][j] += sum over k < K of A(m_i, k) B(k, n_j), k in order, for the
// (16 TM) x (16 TN) block of 256 threads (tx = tid % 16, ty = tid / 16):
// m_i = TM ty + i; n_j = TN tx + j when B is row-major (B(k, n) =
// B[k ldb + n]), n_j = tx + 16 j when it is transposed (BT: B[n ldb + k]).
// A(m, k) = A[m lda + k], or A[k lda + m] when transposed (AT).
template <int TM, int TN, bool AT, bool BT, int K>
__device__ __forceinline__ void mm(float (&acc)[TM][TN],
                                   const float* __restrict__ A, int lda,
                                   const float* __restrict__ B, int ldb,
                                   int ty, int tx) {
  static_assert(K % 4 == 0, "k runs in steps of 4");
  // 4 deep, not K / 4: the full unroll spilled at C = 64 and ran 1.2x slower
#pragma unroll 4
  for (int k = 0; k < K; k += 4) {
    float a[TM][4], b[4][TN];
    if constexpr (AT) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        float t[TM];
        ld_vec<TM>(A + (k + kk) * lda + TM * ty, t);
#pragma unroll
        for (int i = 0; i < TM; ++i) a[i][kk] = t[i];
      }
    } else {
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        float t[4];
        ld_vec<4>(A + (TM * ty + i) * lda + k, t);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) a[i][kk] = t[kk];
      }
    }
    if constexpr (BT) {
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        float t[4];
        ld_vec<4>(B + (tx + 16 * j) * ldb + k, t);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) b[kk][j] = t[kk];
      }
    } else {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        float t[TN];
        ld_vec<TN>(B + (k + kk) * ldb + TN * tx, t);
#pragma unroll
        for (int j = 0; j < TN; ++j) b[kk][j] = t[j];
      }
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j)
          acc[i][j] = fmaf(a[i][kk], b[kk][j], acc[i][j]);
  }
}

// Which global columns (or k rows) of a weight a product takes: index i
// maps to base + (i / width) stride + i % width (blocks of `width` taken
// every `stride`, from `base`); {0, n, n} is the identity.
struct Span {
  int base, width, stride;
  __device__ __forceinline__ int operator()(int i) const {
    return base + (i / width) * stride + i % width;
  }
};

// One kKC-row chunk of a weight W (K x N) from global memory: W(k, n) =
// w[k ld + n], or w[n ld + k] when WT, at the rows and columns its Spans
// give; the thread's share in registers.
template <int N, bool WT>
struct WeightChunk {
  static constexpr int PER = N * kKC / kThreads;
  static_assert(N * kKC % kThreads == 0, "whole chunks a thread");
  float r[PER];

  __device__ __forceinline__ static void at(int idx, int& n, int& kk) {
    if constexpr (WT) {  // along k in global memory
      kk = idx % kKC;
      n = idx / kKC;
    } else {  // along n
      n = idx % N;
      kk = idx / N;
    }
  }
  // kg: the global row of the chunk's first k (a chunk never crosses a
  // block of the k Span)
  __device__ __forceinline__ void fetch(const float* __restrict__ w, int ld,
                                        int kg, Span cols, int tid) {
#pragma unroll
    for (int e = 0; e < PER; ++e) {
      int n, kk;
      at(tid + e * kThreads, n, kk);
      const int ng = cols(n);
      r[e] = __ldg(WT ? w + (size_t)ng * ld + kg + kk
                      : w + (size_t)(kg + kk) * ld + ng);
    }
  }
  // into Bs as B(k, n) = Bs[n kLdB + k]
  __device__ __forceinline__ void store(float* Bs, int tid) const {
#pragma unroll
    for (int e = 0; e < PER; ++e) {
      int n, kk;
      at(tid + e * kThreads, n, kk);
      Bs[n * kLdB + kk] = r[e];
    }
  }
};

// acc[nb] += A (64 x K) times W (K x N) in NB blocks of 16 TN columns: A(m,
// k) = A[m lda + krows(k)] in shared memory, W's rows krows(k) and columns
// cols(n) staged through Bs a chunk of kKC rows at a time, the next chunk
// loaded into registers while the last is multiplied. Starts with a barrier
// (Bs may still be read by the last product).
template <int TN, int NB, int K, bool WT>
__device__ __forceinline__ void mm_weight(float (&acc)[NB][4][TN],
                                          const float* A, int lda,
                                          const float* __restrict__ w, int ld,
                                          Span krows, Span cols, float* Bs,
                                          int tid, int ty, int tx) {
  constexpr int N = NB * 16 * TN;
  static_assert(K % kKC == 0, "whole chunks");
  WeightChunk<N, WT> chunk;
  chunk.fetch(w, ld, krows(0), cols, tid);
#pragma unroll 1
  for (int k0 = 0; k0 < K; k0 += kKC) {
    __syncthreads();
    chunk.store(Bs, tid);
    __syncthreads();
    if (k0 + kKC < K) chunk.fetch(w, ld, krows(k0 + kKC), cols, tid);
    const float* a = A + krows(k0);
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
      mm<4, TN, false, true, kKC>(acc[nb], a, lda, Bs + nb * 16 * TN * kLdB,
                                  kLdB, ty, tx);
  }
}

// the sum of v over the 16 lanes that share a row (tx = lane % 16)
__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}
__device__ __forceinline__ float row_max(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Launch 1: sample blockIdx.x / R, in a cluster of R CTAs (R = 1 or 2);
// CTA `rank` takes heads [rank NH / R, (rank + 1) NH / R), their columns of
// qkv, da, dqkv, dW_qkv and db_qkv and their rows of dW_proj, and rows
// [rank 64 / R, (rank + 1) 64 / R) of dx; the two halves of dh (each
// CTA's heads' share) are added in rank order through the cluster's shared
// memory, and rank 0 writes db_proj, dgs and dgb. x, ct, dx: (B, 64, C);
// part: (B, NPART).
template <int C, int D, int R>
__global__ void __launch_bounds__(kThreads, 1)
bwd_sample_kernel(const float* __restrict__ x, const float* __restrict__ ct,
                  const float* __restrict__ gs, const float* __restrict__ gb,
                  const float* __restrict__ wqkv,
                  const float* __restrict__ bqkv,
                  const float* __restrict__ wproj, float* __restrict__ dx,
                  float* __restrict__ part, float eps, float qk_scale,
                  float sf) {
  using P = Plan<C>;
  constexpr int NH = C / D, TC = C / 16, TD = D / 16, CG = C / kG;
  constexpr int HC = C / R, THC = HC / 16, NHR = NH / R;
  constexpr int PC = P::PC, PQ = P::PQ, PW = P::PW;
  static_assert(NH % R == 0, "whole heads a CTA");
  extern __shared__ __align__(16) float sm[];
  float* sX = sm + P::X;
  float* sH = sm + P::H;
  float* sCt = sm + P::CT;
  float* sDa = sm + P::DA;  // da, then dh
  float* sA = sm + P::A;
  float* sW = sm + P::W;  // one head's softmax w, then its dlg
  float* sQkv = sm + P::QKV;
  float* sDqkv = sm + P::DQKV;
  float* sBs = sm + P::BS;
  float* sGs = sm + P::GS;
  float* sGb = sm + P::GB;
  float* sMean = sm + P::MEAN;
  float* sRstd = sm + P::RSTD;
  float* sSums = sm + P::SUMS;
  float* sG = sm + P::GSTAT;
  const int rank = R == 1 ? 0 : cluster_rank(), b = blockIdx.x / R;
  const int co = rank * HC;  // this CTA's first column of q, k, v and da
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const size_t off = (size_t)b * kS * C;
  float* pb = part + (size_t)b * P::NPART;

  // 0. x, ct and the GroupNorm parameters into shared memory
  for (int e = tid; e < kS * C / 4; e += kThreads) {
    const int s = e / (C / 4), c = 4 * (e % (C / 4));
    *reinterpret_cast<float4*>(sX + s * PC + c) = ldg4(x + off + s * C + c);
    *reinterpret_cast<float4*>(sCt + s * PC + c) = ldg4(ct + off + s * C + c);
  }
  for (int c = tid; c < C; c += kThreads) {
    sGs[c] = gs[c];
    sGb[c] = gb[c];
  }
  __syncthreads();

  // 1. GroupNorm statistics, two-pass fp32: 8 threads a group
  {
    const int g = tid >> 3, l = tid & 7;
    constexpr int N = kS * CG;
    float s1 = 0.f;
    for (int e = l; e < N; e += 8) s1 += sX[(e / CG) * PC + g * CG + e % CG];
#pragma unroll
    for (int o = 4; o > 0; o >>= 1) s1 += __shfl_xor_sync(0xffffffffu, s1, o);
    const float mean = s1 / (float)N;
    float s2 = 0.f;
    for (int e = l; e < N; e += 8) {
      const float t = sX[(e / CG) * PC + g * CG + e % CG] - mean;
      s2 = fmaf(t, t, s2);
    }
#pragma unroll
    for (int o = 4; o > 0; o >>= 1) s2 += __shfl_xor_sync(0xffffffffu, s2, o);
    if (l == 0) {
      sMean[g] = mean;
      sRstd[g] = 1.f / sqrtf(s2 / (float)N + eps);
    }
  }
  __syncthreads();

  // 2. h = ((x - mean) rstd) gs + gb
  for (int e = tid; e < kS * C; e += kThreads) {
    const int s = e / C, c = e % C, g = c / CG;
    const float hp = __fmul_rn(__fsub_rn(sX[s * PC + c], sMean[g]), sRstd[g]);
    sH[s * PC + c] = __fadd_rn(__fmul_rn(hp, sGs[c]), sGb[c]);
  }
  __syncthreads();

  // 3. this CTA's columns of qkv = h W_qkv + b_qkv, q and k times d^-1/4,
  //    and of da = ct W_proj^T
  const Span all_c{0, C, C}, own_c{co, HC, C};
  {
    float acc[3][4][THC] = {};
    mm_weight<THC, 3, C, false>(acc, sH, PC, wqkv, 3 * C, all_c, own_c, sBs,
                                tid, ty, tx);
#pragma unroll
    for (int nb = 0; nb < 3; ++nb)
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < THC; ++j) {
          const int n = nb * C + co + tx + 16 * j;
          float v = __fadd_rn(acc[nb][i][j], __ldg(bqkv + n));
          if (nb < 2) v = __fmul_rn(v, qk_scale);
          sQkv[(4 * ty + i) * PQ + n] = v;
        }
  }
  {
    float acc[1][4][THC] = {};
    mm_weight<THC, 1, C, true>(acc, sCt, PC, wproj, C, all_c, own_c, sBs,
                               tid, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < THC; ++j)
        sDa[(4 * ty + i) * PC + co + tx + 16 * j] = acc[0][i][j];
  }
  __syncthreads();

  // 4. per head: the softmax, a, dv, dlg, dq, dk and the head's rows of
  //    dW_proj
#pragma unroll 1
  for (int hd = rank * NHR; hd < (rank + 1) * NHR; ++hd) {
    const int oq = hd * D, ok = C + hd * D, ov = 2 * C + hd * D;
    {  // w = softmax(qs ks^T), fp32
      float s[4][4] = {};
      mm<4, 4, false, true, D>(s, sQkv + oq, PQ, sQkv + ok, PQ, ty, tx);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float mx = row_max(fmaxf(fmaxf(s[i][0], s[i][1]),
                                       fmaxf(s[i][2], s[i][3])));
        float e[4], sum = 0.f;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          e[j] = expf(s[i][j] - mx);
          sum += e[j];
        }
        sum = row_sum(sum);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          sW[(4 * ty + i) * PW + tx + 16 * j] = e[j] / sum;
      }
    }
    __syncthreads();
    {  // a = w v (into sA)
      float acc[4][TD] = {};
      mm<4, TD, false, false, kS>(acc, sW, PW, sQkv + ov, PQ, ty, tx);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < TD; ++j)
          sA[(4 * ty + i) * PC + TD * tx + j] = acc[i][j];
    }
    {  // dv = w^T da
      float acc[4][TD] = {};
      mm<4, TD, true, false, kS>(acc, sW, PW, sDa + hd * D, PC, ty, tx);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < TD; ++j)
          sDqkv[(4 * ty + i) * PQ + ov + TD * tx + j] = acc[i][j];
    }
    __syncthreads();
    {  // dwt = da v^T; dlg = w (dwt - rowsum(dwt w)) in place of w
      float t[4][4] = {};
      mm<4, 4, false, true, D>(t, sDa + hd * D, PC, sQkv + ov, PQ, ty, tx);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float* row = sW + (4 * ty + i) * PW + tx;
        float w[4], r = 0.f;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          w[j] = row[16 * j];
          r += __fmul_rn(t[i][j], w[j]);
        }
        r = row_sum(r);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          row[16 * j] = __fmul_rn(w[j], __fsub_rn(t[i][j], r));
      }
    }
    __syncthreads();
    {  // dq = (dlg ks) d^-1/4
      float acc[4][TD] = {};
      mm<4, TD, false, false, kS>(acc, sW, PW, sQkv + ok, PQ, ty, tx);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < TD; ++j)
          sDqkv[(4 * ty + i) * PQ + oq + TD * tx + j] =
              __fmul_rn(acc[i][j], sf);
    }
    {  // dk = (dlg^T qs) d^-1/4
      float acc[4][TD] = {};
      mm<4, TD, true, false, kS>(acc, sW, PW, sQkv + oq, PQ, ty, tx);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < TD; ++j)
          sDqkv[(4 * ty + i) * PQ + ok + TD * tx + j] =
              __fmul_rn(acc[i][j], sf);
    }
    {  // dW_proj[hd D + r, c] = sum over s of a[s, r] ct[s, c]
      float acc[TD][TC] = {};
      mm<TD, TC, true, false, kS>(acc, sA, PC, sCt, PC, ty, tx);
#pragma unroll
      for (int i = 0; i < TD; ++i)
#pragma unroll
        for (int j = 0; j < TC; ++j)
          pb[3 * C * C + (hd * D + TD * ty + i) * C + TC * tx + j] =
              acc[i][j];
    }
    __syncthreads();
  }

  // 5. this CTA's heads' share of dh = dqkv W_qkv^T (into sDa); its
  //    columns of dW_qkv = h^T dqkv
  {
    float acc[1][4][TC] = {};
    mm_weight<TC, 1, 3 * HC, true>(acc, sDqkv, PQ, wqkv, 3 * C, own_c, all_c,
                                   sBs, tid, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < TC; ++j)
        sDa[(4 * ty + i) * PC + tx + 16 * j] = acc[0][i][j];
  }
#pragma unroll 1
  for (int nb = 0; nb < 3; ++nb) {
    float acc[TC][THC] = {};
    mm<TC, THC, true, false, kS>(acc, sH, PC, sDqkv + nb * C + co, PQ, ty,
                                 tx);
#pragma unroll
    for (int i = 0; i < TC; ++i)
#pragma unroll
      for (int j = 0; j < THC; ++j)
        pb[(TC * ty + i) * 3 * C + nb * C + co + THC * tx + j] = acc[i][j];
  }
  // dh = the CTAs' shares added in rank order (into sA, free since the
  // heads): both CTAs hold the same dh
  const float* sDh = sDa;
  if constexpr (R == 2) {
    cluster_arrive();
    cluster_wait();
    for (int e = tid; e < kS * C / 4; e += kThreads) {
      const int s = e / (C / 4), c = 4 * (e % (C / 4));
      const float4 mine = *reinterpret_cast<const float4*>(sDa + s * PC + c);
      const float4 other = ld4_rank(sDa + s * PC + c, rank ^ 1);
      const float4 lo = rank == 0 ? mine : other, hi = rank == 0 ? other : mine;
      *reinterpret_cast<float4*>(sA + s * PC + c) =
          make_float4(__fadd_rn(lo.x, hi.x), __fadd_rn(lo.y, hi.y),
                      __fadd_rn(lo.z, hi.z), __fadd_rn(lo.w, hi.w));
    }
    cluster_arrive();  // this CTA has read the other's share
    sDh = sA;
  }
  __syncthreads();

  // 6. column sums over the 64 rows, in order: this CTA's columns of
  //    db_qkv; dgs, dgb and the group sums of dhp and dhp hp (dhp = dh gs;
  //    both CTAs); db_proj (rank 0)
  constexpr int NW = 4 * C * C;
  const int tasks = 3 * HC + C + (rank == 0 ? C : 0);
  for (int t = tid; t < tasks; t += kThreads) {
    if (t < 3 * HC) {
      const int col = own_c(t);
      float s = 0.f;
      for (int q = 0; q < kS; ++q) s += sDqkv[q * PQ + col];
      pb[NW + col] = s;
    } else if (t < 3 * HC + C) {
      const int c = t - 3 * HC, g = c / CG;
      const float mean = sMean[g], rstd = sRstd[g], sc = sGs[c];
      float dgs = 0.f, dgb = 0.f, s1 = 0.f, s2 = 0.f;
      for (int q = 0; q < kS; ++q) {
        const float hp = __fmul_rn(__fsub_rn(sX[q * PC + c], mean), rstd);
        const float dh = sDh[q * PC + c];
        const float dhp = __fmul_rn(dh, sc);
        dgs = fmaf(dh, hp, dgs);
        dgb += dh;
        s1 += dhp;
        s2 = fmaf(dhp, hp, s2);
      }
      if (rank == 0) {
        pb[NW + 4 * C + c] = dgs;
        pb[NW + 5 * C + c] = dgb;
      }
      sSums[c] = s1;
      sSums[C + c] = s2;
    } else {
      const int c = t - 3 * HC - C;
      float s = 0.f;
      for (int q = 0; q < kS; ++q) s += sCt[q * PC + c];
      pb[NW + 3 * C + c] = s;
    }
  }
  __syncthreads();
  if (tid < kG) {
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int cc = 0; cc < CG; ++cc) {
      s1 += sSums[tid * CG + cc];
      s2 += sSums[C + tid * CG + cc];
    }
    sG[tid] = s1 / (float)(kS * CG);
    sG[kG + tid] = s2 / (float)(kS * CG);
  }
  __syncthreads();

  // 7. the GroupNorm backward: dx = ct + rstd (dhp - mean(dhp) - hp
  //    mean(dhp hp))
  for (int e = rank * kS * C / R; e < (rank + 1) * kS * C / R;
       e += kThreads) {
    const int s = (e + tid) / C, c = (e + tid) % C, g = c / CG;
    const float rstd = sRstd[g];
    const float hp = __fmul_rn(__fsub_rn(sX[s * PC + c], sMean[g]), rstd);
    const float dhp = __fmul_rn(sDh[s * PC + c], sGs[c]);
    const float t = __fsub_rn(__fsub_rn(dhp, sG[g]), __fmul_rn(hp, sG[kG + g]));
    dx[off + e + tid] = __fadd_rn(sCt[s * PC + c], __fmul_rn(rstd, t));
  }
  if constexpr (R == 2) cluster_wait();  // no CTA leaves while the other
                                         // reads its share of dh
}

// Launch 2: out[i] = sum over b < B of part[b n + i], in order of b
__global__ void sum_samples_kernel(const float* __restrict__ part, int B,
                                   int n, float* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float acc = 0.f;
#pragma unroll 32
  for (int b = 0; b < B; ++b) acc += part[(size_t)b * n + i];
  out[i] = acc;
}

template <int C, int D, int R>
cudaError_t launch(const float* x, const float* ct, const float* gs,
                   const float* gb, const float* wqkv, const float* bqkv,
                   const float* wproj, float* dx, float* out, float* part,
                   int B, float eps, cudaStream_t s) {
  using P = Plan<C>;
  auto kern = bwd_sample_kernel<C, D, R>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, P::BYTES);
  if (err != cudaSuccess) return err;
  const float scale = (float)(1.0 / sqrt(sqrt((double)D)));
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B * R);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = P::BYTES;
  cfg.stream = s;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = R;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kern, x, ct, gs, gb, wqkv, bqkv, wproj, dx,
                           part, eps, scale, scale);
  if (err != cudaSuccess) return err;
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  sum_samples_kernel<<<(P::NPART + 255) / 256, 256, 0, s>>>(part, B,
                                                            P::NPART, out);
  return cudaGetLastError();
}

}  // namespace

// K6 fp32 at S = 64, C = 32 or 64, d = C / nh of 16, 32 or 64, G = 32.
// x, ct, dx: (B, S, C); w_qkv (C, 3C) with [3, nh, d] output columns, b_qkv
// (3C,), w_proj (C, C), gs, gb (C,), all fp32. out: 4 C^2 + 6 C floats,
// dW_qkv (C, 3C), dW_proj (C, C), db_qkv (3C), db_proj, dgs, dgb (C each);
// part: B times as many, scratch. Other shapes: cudaErrorInvalidValue.
extern "C" int dxmi_attn_block_bwd_small(
    const float* x, const float* ct, const float* gs, const float* gb,
    const float* w_qkv, const float* b_qkv, const float* w_proj, float* dx,
    float* out, float* part, int B, int S, int C, int nh, int G, float eps,
    void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (S != kS || G != kG || B < 1 || nh < 1 || C % nh)
    return (int)cudaErrorInvalidValue;
  const int d = C / nh;
  // two CTAs a sample wherever the heads split evenly
#define DXMI_SMALL(CC, DD, RR)                                           \
  if (C == CC && d == DD)                                                \
    return (int)launch<CC, DD, RR>(x, ct, gs, gb, w_qkv, b_qkv, w_proj, \
                                   dx, out, part, B, eps, s);
  DXMI_SMALL(64, 64, 1)
  DXMI_SMALL(64, 32, 2)
  DXMI_SMALL(64, 16, 2)
  DXMI_SMALL(32, 32, 1)
  DXMI_SMALL(32, 16, 2)
#undef DXMI_SMALL
  return (int)cudaErrorInvalidValue;
}
