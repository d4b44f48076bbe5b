// K7: the attention block over blocks of BB batch elements, fp32 or bf16:
//   y = x + proj(attention(qkv(GroupNorm(x)))) on (B, S, C).
//
// Replaces: dxmi_tpu/ops/attn_block.py:_kernel_bb (run by _pallas_forward
// when bb > 1, public entry fused_attn_block with block_b or
// DXMI_FUSED_ATTN_BB), the Pallas TPU kernel whose one program normalises
// and projects BB elements at once, so that its qkv and proj products run
// over BB * S rows: per-element GroupNorm statistics from one-pass fp32 sums
// over the flattened rows, h rounded to the compute dtype, one qkv product,
// per element and head an fp32 softmax over whole key rows (q tiles of up to
// 256 rows), AV rounded, one proj product, the residual.
//
// Bound on the H100: operations. At the CIFAR-10 training shape (B=128,
// S=256, C=256, one head, fp32) the block does 25.8 GFLOP of fp32 products
// (qkv 12.9, logits 4.3, AV 4.3, proj 4.3), 0.385 ms at the 67 TFLOP/s fp32
// peak, against 67 MB of input and output (0.020 ms at 3.35 TB/s). fp32 is
// the reference's precision, so the tensor cores are not used; the bf16 form
// computes in fp32 too (bf16 products are exact in fp32) and rounds where
// the TPU body rounds.
//
// Design: the TPU program's unit of work, one block of BB elements, is one
// thread-block cluster of kCluster CTAs here (Hopper schedules a cluster's
// CTAs together, so they may wait for each other); its 227 KB-per-CTA shared
// memory cannot hold the program's VMEM set, so the block's intermediates
// (statistics, qkv, attention output) go through device memory, where they
// stay in L2, between four phases that the cluster separates with its
// hardware barrier (barrier.cluster release / acquire, after a fence):
//   (1) statistics: one warp per (element, group) sums x and x*x in fp32;
//   (2) qkv: 128x128 SIMT GEMM tiles over the block's BB * S rows, the
//       GroupNorm affine applied while loading x, rounded to the element
//       type; the epilogue adds the bias and scales q and k by d^-1/4;
//   (3) attention: one tile per (element, head, 64 query rows), softmax in
//       two passes over the keys: the row maximum and sum, then p =
//       exp(s - max) / sum rounded to the element type (normalised before
//       rounding, as the TPU body) and AV summed in fp32;
//   (4) proj: the GEMM tiles again, bias and residual in the epilogue.
// Each phase's tiles are dealt round-robin to the cluster's CTAs. Data
// written in an earlier phase is read with ld.global.cg (L2, never the
// non-coherent read-only path).
#include <math.h>

#include "common.cuh"

namespace {

constexpr int kCluster = 8, kThreads = 256, kWarps = kThreads / 32;
constexpr int TM = 128, TN = 128, TK = 8, LDT = TM + 4;  // GEMM tiles
constexpr int QT = 64, KT = 64, LDP = QT + 4;             // attention tiles

template <typename T>
struct BBArgs {
  const T* x;
  const float* gs;
  const float* gb;
  const T* w_qkv;
  const T* b_qkv;
  const T* w_proj;
  const T* b_proj;
  T* y;
  float* stats;  // (B, G, 2): mean, rstd
  T* qkv;        // (B, S, 3C)
  T* attn;       // (B, S, C)
  int S, C, nh, G, bb;
  float eps, qk_scale;
};

__host__ __device__ constexpr int gemm_smem_floats() { return 4 * TK * LDT; }
__host__ __device__ constexpr int attn_smem_floats(int d) {
  return (QT + 2 * KT) * (d + 4) + KT * LDP;
}

__device__ __forceinline__ unsigned cluster_rank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

__device__ __forceinline__ unsigned cluster_index() {
  unsigned r;
  asm volatile("mov.u32 %0, %%clusterid.x;\n" : "=r"(r));
  return r;
}

// every CTA of the cluster has finished the phase and its global writes are
// visible to the others
__device__ __forceinline__ void cluster_barrier() {
  __threadfence();
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// four consecutive elements as fp32: inputs of the kernel (read-only path)
__device__ __forceinline__ float4 ld4_in(const float* p) { return ldg4(p); }
__device__ __forceinline__ float4 ld4_in(const bf16* p) {
  const uint2 r = __ldg(reinterpret_cast<const uint2*>(p));
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&r.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&r.y));
  return make_float4(a.x, a.y, b.x, b.y);
}
// ... and data an earlier phase of this launch wrote (through L2)
__device__ __forceinline__ float4 ld4_cg(const float* p) {
  return __ldcg(reinterpret_cast<const float4*>(p));
}
__device__ __forceinline__ float4 ld4_cg(const bf16* p) {
  const uint2 r = __ldcg(reinterpret_cast<const uint2*>(p));
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&r.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&r.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ void st4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ void st4(bf16* p, float4 v) {
  *reinterpret_cast<uint2*>(p) = make_uint2(pack_bf16(v.x, v.y),
                                            pack_bf16(v.z, v.w));
}

// (1) one-pass fp32 sums per (element, group) of the block's rows
template <typename T>
__device__ void stats_phase(const BBArgs<T>& a, int e0, int rank) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int cg = a.C / a.G, n = a.S * cg;
  for (int u = rank * kWarps + warp; u < a.bb * a.G; u += kCluster * kWarps) {
    const int e = u / a.G, g = u - e * a.G;
    const T* xe = a.x + (size_t)(e0 + e) * a.S * a.C + g * cg;
    float s1 = 0.f, s2 = 0.f;
    for (int i = lane; i < n; i += 32) {
      const int r = i / cg;
      const float v = to_f(xe[(size_t)r * a.C + (i - r * cg)]);
      s1 += v;
      s2 = fmaf(v, v, s2);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      s1 += __shfl_xor_sync(0xffffffffu, s1, o);
      s2 += __shfl_xor_sync(0xffffffffu, s2, o);
    }
    if (lane == 0) {
      const float mean = s1 / (float)n;
      const float var = s2 / (float)n - mean * mean;
      float* st = a.stats + ((size_t)(e0 + e) * a.G + g) * 2;
      st[0] = mean;
      st[1] = rsqrtf(var + a.eps);
    }
  }
}

// (2), (4): the (m0, n0) tile of out[M, N] = A[M, K] W[K, N] over the rows
// starting at row0. QKV: A is x with the GroupNorm affine applied on load,
// the epilogue adds the bias and scales columns < 2C by qk_scale. Else A is
// the attention output, the epilogue adds the bias and the residual x.
template <typename T, bool QKV>
__device__ void gemm_tile(const BBArgs<T>& a, float* smem, size_t row0,
                          int M, int N, int K, int m0, int n0) {
  float* As = smem;             // [2][TK][LDT], A transposed
  float* Bs = smem + 2 * TK * LDT;  // [2][TK][LDT]
  const T* A = QKV ? a.x : a.attn;
  const T* W = QKV ? a.w_qkv : a.w_proj;
  const T* bias = QKV ? a.b_qkv : a.b_proj;
  T* out = QKV ? a.qkv : a.y;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int a_r = tid >> 1, a_k = (tid & 1) * 4, a_m = m0 + a_r;
  const int b_k = tid >> 5, b_n = (tid & 31) * 4;
  const int cg = a.C / a.G;
  float4 ra = make_float4(0.f, 0.f, 0.f, 0.f), rw = ra;

  auto load = [&](int k0) {
    ra = make_float4(0.f, 0.f, 0.f, 0.f);
    rw = ra;
    if (a_m < M) {
      const T* p = A + (row0 + a_m) * K + k0 + a_k;
      if (QKV) {
        const float4 v = ld4_in(p);
        const size_t e = (row0 + a_m) / a.S;
        float xv[4] = {v.x, v.y, v.z, v.w}, h[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int k = k0 + a_k + j;
          const float2 st = __ldcg(reinterpret_cast<const float2*>(
              a.stats + (e * a.G + k / cg) * 2));
          const float s = __fmul_rn(a.gs[k], st.y);
          const float t = __fsub_rn(a.gb[k], __fmul_rn(st.x, s));
          h[j] = round_t<T>(__fadd_rn(__fmul_rn(xv[j], s), t));
        }
        ra = make_float4(h[0], h[1], h[2], h[3]);
      } else {
        ra = ld4_cg(p);
      }
    }
    if (n0 + b_n < N) rw = ld4_in(W + (size_t)(k0 + b_k) * N + n0 + b_n);
  };
  auto store = [&](int st) {
    float* as = As + st * TK * LDT;
    as[a_k * LDT + a_r] = ra.x;
    as[(a_k + 1) * LDT + a_r] = ra.y;
    as[(a_k + 2) * LDT + a_r] = ra.z;
    as[(a_k + 3) * LDT + a_r] = ra.w;
    *reinterpret_cast<float4*>(Bs + st * TK * LDT + b_k * LDT + b_n) = rw;
  };

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  __syncthreads();  // the shared tiles of the previous unit are read
  load(0);
  store(0);
  __syncthreads();
  int st = 0;
  for (int k0 = 0; k0 < K; k0 += TK, st ^= 1) {
    const bool more = k0 + TK < K;
    if (more) load(k0 + TK);
    const float* as = As + st * TK * LDT;
    const float* bs = Bs + st * TK * LDT;
#pragma unroll
    for (int kk = 0; kk < TK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(as + kk * LDT + ty * 4);
      const float4 a1 =
          *reinterpret_cast<const float4*>(as + kk * LDT + 64 + ty * 4);
      const float4 b0 = *reinterpret_cast<const float4*>(bs + kk * LDT + tx * 4);
      const float4 b1 =
          *reinterpret_cast<const float4*>(bs + kk * LDT + 64 + tx * 4);
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
    const size_t row = (row0 + m) * N;
#pragma unroll
    for (int jh = 0; jh < 2; ++jh) {
      const int n = n0 + jh * 64 + tx * 4;
      if (n >= N) continue;
      float v[4];
      const float4 bv = ld4_in(bias + n);
      const float bb4[4] = {bv.x, bv.y, bv.z, bv.w};
      float4 r4 = make_float4(0.f, 0.f, 0.f, 0.f);
      if (!QKV) r4 = ld4_in(a.x + row + n);
      const float rr[4] = {r4.x, r4.y, r4.z, r4.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        // dt(acc) + dt(bias) in dt, then q, k times dt(d^-1/4) in dt, or
        // the residual added in dt (each a no-op rounding for fp32)
        float u = round_t<T>(round_t<T>(acc[i][jh * 4 + j]) + bb4[j]);
        if (QKV) {
          if (n + j < 2 * a.C) u = round_t<T>(u * a.qk_scale);
        } else {
          u = round_t<T>(rr[j] + u);
        }
        v[j] = u;
      }
      st4(out + row + n, make_float4(v[0], v[1], v[2], v[3]));
    }
  }
}

// (3) softmax(q k^T) v for 64 query rows of one (element, head); q and k
// are pre-scaled. Thread (ty, tx) = (tid / 16, tid % 16) holds rows
// 4ty..4ty+3, the keys tx + 16j of each key tile and the output columns
// 64i + 4tx..+3; a row's 16 threads are 16 lanes of one warp.
template <typename T>
__device__ void attn_tile(const BBArgs<T>& a, float* smem, int e, int h,
                          int q0) {
  const int S = a.S, C = a.C, d = C / a.nh, ld = d + 4, d4 = d / 4;
  float* Qs = smem;           // [QT][ld]
  float* Ks = Qs + QT * ld;   // [KT][ld]
  float* Vs = Ks + KT * ld;   // [KT][ld]
  float* Pt = Vs + KT * ld;   // [KT][LDP]: probabilities, key-major
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const size_t row3 = 3 * (size_t)C;
  const T* base = a.qkv + (size_t)e * S * row3 + (size_t)h * d;

  __syncthreads();  // the shared tiles of the previous unit are read
  for (int idx = tid; idx < QT * d4; idx += kThreads) {
    const int i = idx / d4, c4 = (idx - i * d4) * 4;
    *reinterpret_cast<float4*>(Qs + i * ld + c4) =
        ld4_cg(base + (size_t)(q0 + i) * row3 + c4);
  }

  auto load_kv = [&](int k0, bool with_v) {
    for (int idx = tid; idx < KT * d4; idx += kThreads) {
      const int j = idx / d4, c4 = (idx - j * d4) * 4;
      const T* src = base + (size_t)(k0 + j) * row3 + c4;
      *reinterpret_cast<float4*>(Ks + j * ld + c4) = ld4_cg(src + C);
      if (with_v)
        *reinterpret_cast<float4*>(Vs + j * ld + c4) = ld4_cg(src + 2 * C);
    }
  };
  auto scores = [&](float (&s)[4][4]) {
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[r][j] = 0.f;
    for (int c = 0; c < d; c += 4) {
      float4 q[4], k[4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
        q[r] = *reinterpret_cast<const float4*>(Qs + (ty * 4 + r) * ld + c);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        k[j] = *reinterpret_cast<const float4*>(Ks + (tx + 16 * j) * ld + c);
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[r][j] = dot4(q[r], k[j], s[r][j]);
    }
  };

  // pass 1: each row's maximum and sum of exp(s - max) over all keys
  float m_i[4], l_i[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    m_i[r] = -INFINITY;
    l_i[r] = 0.f;
  }
  for (int k0 = 0; k0 < S; k0 += KT) {
    __syncthreads();  // the previous key tile is read
    load_kv(k0, false);
    __syncthreads();
    float s[4][4];
    scores(s);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      float mx = fmaxf(fmaxf(s[r][0], s[r][1]), fmaxf(s[r][2], s[r][3]));
#pragma unroll
      for (int o = 8; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m_i[r], mx);
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) psum += expf(s[r][j] - m_new);
#pragma unroll
      for (int o = 8; o > 0; o >>= 1)
        psum += __shfl_xor_sync(0xffffffffu, psum, o);
      l_i[r] = l_i[r] * expf(m_i[r] - m_new) + psum;
      m_i[r] = m_new;
    }
  }

  // pass 2: p = dt(exp(s - max) / sum), o += p v
  float4 o[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int i = 0; i < 4; ++i) o[r][i] = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int k0 = 0; k0 < S; k0 += KT) {
    __syncthreads();  // the previous K, V and P tiles are read
    load_kv(k0, true);
    __syncthreads();
    float s[4][4];
    scores(s);
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        Pt[(tx + 16 * j) * LDP + ty * 4 + r] =
            round_t<T>(expf(s[r][j] - m_i[r]) / l_i[r]);
    __syncwarp();  // a row's probabilities come from 16 lanes of this warp
    for (int j = 0; j < KT; ++j) {
      const float4 p = *reinterpret_cast<const float4*>(Pt + j * LDP + ty * 4);
      const float pr[4] = {p.x, p.y, p.z, p.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (64 * i + tx * 4 < d) {
          const float4 v =
              *reinterpret_cast<const float4*>(Vs + j * ld + 64 * i + tx * 4);
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
    T* orow = a.attn + ((size_t)e * S + q0 + ty * 4 + r) * C + (size_t)h * d;
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (64 * i + tx * 4 < d) st4(orow + 64 * i + tx * 4, o[r][i]);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
attn_bb_kernel(const BBArgs<T> a) {
  extern __shared__ __align__(16) float smem[];
  const int rank = (int)cluster_rank();
  const int e0 = (int)cluster_index() * a.bb;  // the block's first element
  const int M = a.bb * a.S, C = a.C;
  const size_t row0 = (size_t)e0 * a.S;

  stats_phase(a, e0, rank);
  cluster_barrier();

  const int tm = (M + TM - 1) / TM;
  const int tn_qkv = (3 * C + TN - 1) / TN;
  for (int u = rank; u < tm * tn_qkv; u += kCluster)
    gemm_tile<T, true>(a, smem, row0, M, 3 * C, C, (u / tn_qkv) * TM,
                       (u % tn_qkv) * TN);
  cluster_barrier();

  const int qt = a.S / QT;
  for (int u = rank; u < a.bb * a.nh * qt; u += kCluster) {
    const int e = u / (a.nh * qt), rest = u - e * a.nh * qt;
    attn_tile(a, smem, e0 + e, rest / qt, (rest % qt) * QT);
  }
  cluster_barrier();

  const int tn_proj = (C + TN - 1) / TN;
  for (int u = rank; u < tm * tn_proj; u += kCluster)
    gemm_tile<T, false>(a, smem, row0, M, C, C, (u / tn_proj) * TM,
                        (u % tn_proj) * TN);
}

template <typename T>
cudaError_t launch_bb(const BBArgs<T>& a, int B, cudaStream_t stream) {
  const int d = a.C / a.nh;
  if (a.bb < 2 || B % a.bb || a.S % QT || a.C % a.G || a.C % 32 || d % 4 ||
      d > 256)
    return cudaErrorInvalidValue;
  const int floats = attn_smem_floats(d) > gemm_smem_floats()
                         ? attn_smem_floats(d) : gemm_smem_floats();
  const int smem = (int)sizeof(float) * floats;
  cudaError_t err = cudaFuncSetAttribute(
      attn_bb_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((B / a.bb) * kCluster, 1, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, attn_bb_kernel<T>, a);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <typename T>
int run(const void* x, const float* gs, const float* gb, const void* w_qkv,
        const void* b_qkv, const void* w_proj, const void* b_proj, void* y,
        float* stats, void* qkv, void* attn, int B, int S, int C, int nh,
        int G, int bb, float eps, float qk_scale, void* stream) {
  BBArgs<T> a;
  a.x = static_cast<const T*>(x);
  a.gs = gs;
  a.gb = gb;
  a.w_qkv = static_cast<const T*>(w_qkv);
  a.b_qkv = static_cast<const T*>(b_qkv);
  a.w_proj = static_cast<const T*>(w_proj);
  a.b_proj = static_cast<const T*>(b_proj);
  a.y = static_cast<T*>(y);
  a.stats = stats;
  a.qkv = static_cast<T*>(qkv);
  a.attn = static_cast<T*>(attn);
  a.S = S;
  a.C = C;
  a.nh = nh;
  a.G = G;
  a.bb = bb;
  a.eps = eps;
  a.qk_scale = qk_scale;
  return (int)launch_bb(a, B, (cudaStream_t)stream);
}

}  // namespace

// x, y: (B, S, C) fp32; w_qkv: (C, 3C) with [3, nh, d] output columns;
// b_qkv (3C,); w_proj (C, C); b_proj (C,); gs, gb (C,); stats: (B, G, 2)
// scratch; qkv: (B, S, 3C) and attn: (B, S, C) scratch. Needs B % bb == 0,
// bb >= 2, S % 64 == 0, C % 32 == 0 and d = C / nh with d % 4 == 0, d <= 256.
extern "C" int dxmi_attn_block_bb(const void* x, const float* gs,
                                  const float* gb, const void* w_qkv,
                                  const void* b_qkv, const void* w_proj,
                                  const void* b_proj, void* y, float* stats,
                                  void* qkv, void* attn, int B, int S, int C,
                                  int nh, int G, int bb, float eps,
                                  void* stream) {
  const double d = (double)(C / nh);
  return run<float>(x, gs, gb, w_qkv, b_qkv, w_proj, b_proj, y, stats, qkv,
                    attn, B, S, C, nh, G, bb, eps,
                    (float)(1.0 / sqrt(sqrt(d))), stream);
}

// The same arguments with bf16 x, y, weights, biases and scratch (GN
// parameters and statistics fp32); d <= 128 as K2's bf16 form.
extern "C" int dxmi_attn_block_bb_bf16(const void* x, const float* gs,
                                       const float* gb, const void* w_qkv,
                                       const void* b_qkv, const void* w_proj,
                                       const void* b_proj, void* y,
                                       float* stats, void* qkv, void* attn,
                                       int B, int S, int C, int nh, int G,
                                       int bb, float eps, void* stream) {
  const double d = (double)(C / nh);
  // the TPU body scales by jnp.asarray(d ** -0.25, bf16)
  const float qk = __bfloat162float(
      __float2bfloat16_rn((float)(1.0 / sqrt(sqrt(d)))));
  return run<bf16>(x, gs, gb, w_qkv, b_qkv, w_proj, b_proj, y, stats, qkv,
                   attn, B, S, C, nh, G, bb, eps, qk, stream);
}
