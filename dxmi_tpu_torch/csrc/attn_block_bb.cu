// K7: the attention block over blocks of BB batch elements, fp32 or bf16,
// and K2's fp32 form (bb = 1) on the same launches:
//   y = x + proj(attention(qkv(GroupNorm(x)))) on (B, S, C).
//
// Replaces: dxmi_tpu/ops/attn_block.py:_kernel_bb (run by _pallas_forward
// when bb > 1, public entry fused_attn_block with block_b or
// DXMI_FUSED_ATTN_BB), the Pallas TPU kernel whose one program normalises
// and projects BB elements at once, so that its qkv and proj products run
// over BB * S rows: per-element GroupNorm statistics from one-pass fp32 sums
// over the flattened rows (var = E[x^2] - mean^2), h rounded to the compute
// dtype, one qkv product, per element and head an fp32 softmax over whole
// key rows, normalised before p is rounded, AV rounded, one proj product,
// the residual. The batch block only groups the TPU's work: each element's
// result depends on that element alone.
// Its attention launch is also K2 bf16's core at d > 128 (one head: the
// CIFAR-10 nets' d = 256 blocks in bf16; launch_attn_core_bb, called from
// attn_block.cu). dxmi_attn_block also replaces
// dxmi_tpu/ops/attn_block.py:_kernel (bb = 1, fp32; the CIFAR-10 nets'
// blocks): GroupNorm with two-pass statistics (K1's
// statistics pass, groupnorm.cu) in the plain version's order
// ((x - mean) rstd) gs + gb, then the same qkv, attention and proj
// launches over the whole batch.
//
// Bound on the H100: operations. At the CIFAR-10 training shape (B=128,
// S=256, C=256, one head, fp32) the block does 25.8 GFLOP of fp32 products
// (qkv 12.9, logits 4.3, AV 4.3, proj 4.3), 0.385 ms at the 67 TFLOP/s fp32
// peak, or 0.156 ms as three TF32 products each at 495 TFLOP/s (the
// 3xTF32 split below), against 67 MB of input and output (0.020 ms at
// 3.35 TB/s). K2 at generation's B=100: 20.2 GFLOP, 0.122 ms.
//
// Design: four launches over the whole batch, so that every SM has work at
// any B (E4's sampling chunks are 32 elements):
//   (1) statistics: K7, one warp per (element, group) sums x and x*x in
//       fp32; K2, K1's two-pass statistics pass;
//   (2) qkv: one GEMM over all B * S rows, 128 x 128 tiles of 8 warps, the
//       GroupNorm affine applied while loading x (h rounded to the element
//       type); the epilogue adds the bias and scales q and k by d^-1/4;
//   (3) attention: one block of 16 warps per (element, head, 64 query
//       rows), each warp 16 rows by a quarter of the keys and of the output
//       columns; softmax in two passes over the keys (the row maximum and
//       sum, then p = exp(s - max) / sum rounded to the element type,
//       normalised before rounding as the TPU body) and AV summed in fp32;
//   (4) proj: the GEMM again, bias and residual in the epilogue.
// Every product runs on the tensor cores with mma.sync and fp32
// accumulators. bf16 operands are exact in fp32 sums (m16n8k16). fp32 ones
// take the 3xTF32 split (m16n8k8): a = a_hi + a_lo with a_hi = tf32(a) and
// a_lo = a - a_hi, a b ~ a_hi b_hi + a_hi b_lo + a_lo b_hi, which keeps
// about 21 of the 24 mantissa bits of each product (one-pass TF32 keeps 11
// and fails the fp32 gate). Each k-step's three products are summed from
// zero and added to the fp32 sums outside the tensor core: its own
// accumulation truncates, which over E4's 256-deep sums cost 3e-5 and
// failed the gate. Tiles sit in shared memory as fp32 in both forms; each
// product's fragments are built from them (splitting once per element when
// a tile is stored measured slower: twice the shared-memory traffic).
#include <math.h>

#include "common.cuh"

namespace {

constexpr int GM = 128, GN = 128, GK = 32;  // GEMM tiles: 8 warps of 64 x 32
constexpr int GB_LD = GN + 8;                // W tile row pitch (floats)
constexpr int QT = 64, KT = 64;              // attention: q rows, keys a tile

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
  float* stats;   // K7 (B, 2, C): the GroupNorm scale s_c, then shift t_c
  float* mean_c;  // K2 (B, C): K1's per-channel mean and rstd
  float* rstd_c;
  T* qkv;        // (B, S, 3C)
  T* attn;       // (B, S, C)
  int S, C, nh, G;
  float eps, qk_scale;
};

// ---- tensor-core fragments from fp32 shared tiles ------------------------
// thread (g, t) = (lane / 4, lane % 4) of a warp's mma.sync. T = float:
// m16n8k8 tf32 as hi and lo parts; T = bf16: m16n8k16 bf16.
template <typename T>
struct AFrag;
template <>
struct AFrag<float> {
  unsigned hi[4], lo[4];
};
template <>
struct AFrag<bf16> {
  unsigned r[4];
};
template <typename T>
struct BFrag;
template <>
struct BFrag<float> {
  unsigned hi[2], lo[2];
};
template <>
struct BFrag<bf16> {
  unsigned r[2];
};

template <typename T>
constexpr int kStep = sizeof(T) == 4 ? 8 : 16;  // k columns an mma takes

// a_hi: a rounded to TF32's 10 mantissa bits (to nearest, ties away, as
// cvt.rna) in integer arithmetic; a_lo = a - a_hi, exact, of which the
// tensor core reads the top 19 bits
__device__ __forceinline__ void split(float x, unsigned& hi, unsigned& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// rows 0..15 of a row-major tile at A (lda floats a row), k columns from 0
__device__ __forceinline__ void load_a(AFrag<float>& f, const float* A,
                                       int lda, int g, int t) {
  const float v[4] = {A[g * lda + t], A[(g + 8) * lda + t],
                      A[g * lda + t + 4], A[(g + 8) * lda + t + 4]};
#pragma unroll
  for (int i = 0; i < 4; ++i) split(v[i], f.hi[i], f.lo[i]);
}
__device__ __forceinline__ void load_a(AFrag<bf16>& f, const float* A,
                                       int lda, int g, int t) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 v = *reinterpret_cast<const float2*>(
        A + (g + 8 * (i & 1)) * lda + 2 * t + 8 * (i >> 1));
    f.r[i] = pack_bf16(v.x, v.y);
  }
}

// columns 0..7 of B (k x 8) from 0: NK = true reads element (k, n) at
// B[n * ld + k] (a key-major K tile), else at B[k * ld + n]
template <bool NK>
__device__ __forceinline__ float b_at(const float* B, int ld, int k, int n) {
  return NK ? B[n * ld + k] : B[k * ld + n];
}
template <bool NK>
__device__ __forceinline__ void load_b(BFrag<float>& f, const float* B,
                                       int ld, int g, int t) {
  split(b_at<NK>(B, ld, t, g), f.hi[0], f.lo[0]);
  split(b_at<NK>(B, ld, t + 4, g), f.hi[1], f.lo[1]);
}
template <bool NK>
__device__ __forceinline__ void load_b(BFrag<bf16>& f, const float* B,
                                       int ld, int g, int t) {
#pragma unroll
  for (int i = 0; i < 2; ++i)
    f.r[i] = pack_bf16(b_at<NK>(B, ld, 2 * t + 8 * i, g),
                       b_at<NK>(B, ld, 2 * t + 8 * i + 1, g));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// d = a b, the sums from zero
__device__ __forceinline__ void mma_tf32_0(float (&d)[4],
                                           const unsigned (&a)[4],
                                           unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%10,%10,%10,%10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1),
        "f"(0.f));
}
// d += a b: 3xTF32, the small terms first, summed from zero in the tensor
// core and added to d in fp32 (round to nearest)
__device__ __forceinline__ void mma(float (&d)[4], const AFrag<float>& a,
                                    const BFrag<float>& b) {
  float t[4];
  mma_tf32_0(t, a.lo, b.hi[0], b.hi[1]);
  mma_tf32(t, a.hi, b.lo[0], b.lo[1]);
  mma_tf32(t, a.hi, b.hi[0], b.hi[1]);
#pragma unroll
  for (int i = 0; i < 4; ++i) d[i] += t[i];
}
__device__ __forceinline__ void mma(float (&d)[4], const AFrag<bf16>& a,
                                    const BFrag<bf16>& b) {
  mma_bf16(d, a.r, b.r[0], b.r[1]);
}

// row pitch (floats) of tiles read as A or key-major B (float2 reads in
// bf16), and of tiles read k-major (V): conflict-free fragment loads
template <typename T>
constexpr int kPadA = sizeof(T) == 4 ? 4 : 8;
template <typename T>
constexpr int kPadV = sizeof(T) == 4 ? 8 : 4;

__device__ __forceinline__ void st2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void st2(bf16* p, float a, float b) {
  *reinterpret_cast<unsigned*>(p) = pack_bf16(a, b);
}

// ---- (1) one-pass fp32 sums per (element, group) ------------------------
// then the GroupNorm affine per (element, channel): s_c = gs_c rstd and
// t_c = gb_c - mean s_c, each rounded once, into stats (B, 2, C)
template <typename T>
__global__ void __launch_bounds__(256) bb_stats_kernel(const BBArgs<T> a,
                                                       int B) {
  const int u = blockIdx.x * 8 + (threadIdx.x >> 5), lane = threadIdx.x & 31;
  if (u >= B * a.G) return;
  const int e = u / a.G, g = u - e * a.G;
  const int cg = a.C / a.G, n = a.S * cg;
  const T* xe = a.x + (size_t)e * a.S * a.C + g * cg;
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
  const float mean = s1 / (float)n;
  const float rstd = rsqrtf(s2 / (float)n - mean * mean + a.eps);
  float* st = a.stats + (size_t)e * 2 * a.C + g * cg;
  for (int c = lane; c < cg; c += 32) {
    const float sc = __fmul_rn(a.gs[g * cg + c], rstd);
    st[c] = sc;
    st[a.C + c] = __fsub_rn(a.gb[g * cg + c], __fmul_rn(mean, sc));
  }
}

// ---- (2), (4) out[M, N] = A[M, K] W[K, N] --------------------------------
// kQkv*: A is x with the GroupNorm affine applied on load (kQkvScaleShift:
// x s_c + t_c from stats, K7; kQkvMeanRstd: ((x - mean) rstd) gs + gb, K2),
// the epilogue adds the bias and scales columns < 2C by qk_scale. kProj: A
// is the attention output, the epilogue adds the bias and the residual x.
enum Gemm { kQkvScaleShift = 0, kQkvMeanRstd = 1, kProj = 2 };

template <typename T>
__host__ __device__ constexpr int gemm_smem_bytes() {
  return 2 * (GM * (GK + kPadA<T>) + GK * GB_LD) * 4;
}

template <typename T, int GEMM>
__global__ void __launch_bounds__(256) bb_gemm_kernel(const BBArgs<T> a,
                                                      int M, int N, int K) {
  constexpr bool QKV = GEMM != kProj;
  constexpr int LDA = GK + kPadA<T>;
  extern __shared__ __align__(16) float gsm[];
  float* As = gsm;                 // [2][GM][LDA]
  float* Bs = gsm + 2 * GM * LDA;  // [2][GK][GB_LD]
  const T* A = QKV ? a.x : a.attn;
  const T* W = QKV ? a.w_qkv : a.w_proj;
  const T* bias = QKV ? a.b_qkv : a.b_proj;
  T* out = QKV ? a.qkv : a.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3, wm = warp >> 2, wn = warp & 3;
  const int m0 = blockIdx.y * GM, n0 = blockIdx.x * GN;
  float4 ra[4], rw[4];

  auto load = [&](int k0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = (tid >> 3) + 32 * i, c = k0 + (tid & 7) * 4, m = m0 + r;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (m < M) {
        v = load4(A + (size_t)m * K + c);
        if (GEMM == kQkvMeanRstd) {
          const size_t bc = (size_t)(m / a.S) * K + c;
          const float4 h = gn_affine4(v, ldg4(a.mean_c + bc),
                                      ldg4(a.rstd_c + bc), ldg4(a.gs + c),
                                      ldg4(a.gb + c));
          v = make_float4(round_t<T>(h.x), round_t<T>(h.y), round_t<T>(h.z),
                          round_t<T>(h.w));
        } else if (GEMM == kQkvScaleShift) {
          const float* st = a.stats + (size_t)(m / a.S) * 2 * K + c;
          const float4 sc = *reinterpret_cast<const float4*>(st);
          const float4 sh = *reinterpret_cast<const float4*>(st + K);
          v = make_float4(
              round_t<T>(__fadd_rn(__fmul_rn(v.x, sc.x), sh.x)),
              round_t<T>(__fadd_rn(__fmul_rn(v.y, sc.y), sh.y)),
              round_t<T>(__fadd_rn(__fmul_rn(v.z, sc.z), sh.z)),
              round_t<T>(__fadd_rn(__fmul_rn(v.w, sc.w), sh.w)));
        }
      }
      ra[i] = v;
      const int kr = (tid >> 5) + 8 * i, n = n0 + (tid & 31) * 4;
      rw[i] = n < N ? load4(W + (size_t)(k0 + kr) * N + n)
                    : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  };
  auto store = [&](int st) {
    float* as = As + st * GM * LDA;
    float* bs = Bs + st * GK * GB_LD;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      *reinterpret_cast<float4*>(as + ((tid >> 3) + 32 * i) * LDA +
                                 (tid & 7) * 4) = ra[i];
      *reinterpret_cast<float4*>(bs + ((tid >> 5) + 8 * i) * GB_LD +
                                 (tid & 31) * 4) = rw[i];
    }
  };

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  load(0);
  store(0);
  __syncthreads();
  int st = 0;
  for (int k0 = 0; k0 < K; k0 += GK, st ^= 1) {
    const bool more = k0 + GK < K;
    if (more) load(k0 + GK);
    const float* as = As + st * GM * LDA + wm * 64 * LDA;
    const float* bs = Bs + st * GK * GB_LD + wn * 32;
#pragma unroll
    for (int kk = 0; kk < GK; kk += kStep<T>) {
      AFrag<T> fa[4];
      BFrag<T> fb[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        load_a(fa[i], as + i * 16 * LDA + kk, LDA, g, t);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        load_b<false>(fb[j], bs + kk * GB_LD + j * 8, GB_LD, g, t);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma(acc[i][j], fa[i], fb[j]);
    }
    // the other stage was last read before the previous barrier
    if (more) store(st ^ 1);
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int m = m0 + wm * 64 + i * 16 + g + 8 * half;
      if (m >= M) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = n0 + wn * 32 + j * 8 + 2 * t;
        if (n >= N) continue;
        float u[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          // dt(acc) + dt(bias) in dt, then q, k times dt(d^-1/4) in dt, or
          // the residual added in dt (each a no-op rounding for fp32)
          u[e] = round_t<T>(round_t<T>(acc[i][j][2 * half + e]) +
                            to_f(bias[n + e]));
          if (QKV) {
            if (n + e < 2 * a.C) u[e] = round_t<T>(u[e] * a.qk_scale);
          } else {
            u[e] = round_t<T>(to_f(a.x[(size_t)m * N + n + e]) + u[e]);
          }
        }
        st2(out + (size_t)m * N + n, u[0], u[1]);
      }
    }
}

// ---- (3) softmax(q k^T) v, 64 query rows of one (element, head) ---------
// q and k are pre-scaled. 16 warps: warp (wr, wc) = (w / 4, w % 4) forms
// the logits of rows 16 wr .. + 15 against keys 16 wc .. + 15 of each
// 64-key tile, and the output of the same rows in columns wc D / 4 ..; the
// row statistics of the four key quarters meet in shared memory. D is the
// head width d padded to 64, 128 or 256 (zeros past d).
constexpr int kAttnThreads = 512;

template <typename T, int D>
__host__ __device__ constexpr int attn_smem_bytes() {
  return ((QT + KT) * (D + kPadA<T>) + KT * (D + kPadV<T>) +
          QT * (KT + kPadA<T>) + 2 * 4 * QT) * 4;
}

// fp32 (no rounding of p to wait for): one pass over the keys with an
// online softmax. Per key tile the four key quarters' row maxima meet in
// shared memory; p = exp(s - running max) goes through the P tile
// unnormalised; each warp rescales its output columns and its quarter's
// row sums when the maximum grows, and the quarters' sums meet at the end,
// where o is divided by them. Half the logits of the two-pass form.
template <int D, typename TileIn, typename Scores>
__device__ __forceinline__ void attn_online_f32(
    const BBArgs<float>& a, float* Qs, float* Ks, float* Vs, float* Ps,
    float* red, const float* base, int q0, int e, int h, TileIn& tile_in,
    Scores& scores) {
  constexpr int LQ = D + kPadA<float>, LV = D + kPadV<float>;
  constexpr int LP = KT + kPadA<float>, DW = D / 4;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3, wr = warp >> 2, wc = warp & 3;
  const int S = a.S, C = a.C, d = C / a.nh;
  float m_i[2] = {-INFINITY, -INFINITY}, l_i[2] = {0.f, 0.f};
  float o[DW / 8][4];
#pragma unroll
  for (int j = 0; j < DW / 8; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) o[j][i] = 0.f;
  for (int k0 = 0; k0 < S; k0 += KT) {
    __syncthreads();  // the previous K, V, P tiles and maxima are read
    tile_in(Ks, LQ, base + C, k0);
    tile_in(Vs, LV, base + 2 * C, k0);
    __syncthreads();
    float s[2][4];
    scores(s);
    // this warp's row maxima over its 16 keys, then the tile's
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = fmaxf(fmaxf(s[0][2 * r], s[0][2 * r + 1]),
                       fmaxf(s[1][2 * r], s[1][2 * r + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      if (t == 0) red[wc * QT + wr * 16 + g + 8 * r] = mx;
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = wr * 16 + g + 8 * r;
      float m_new = m_i[r];
#pragma unroll
      for (int c = 0; c < 4; ++c) m_new = fmaxf(m_new, red[c * QT + row]);
      const float alpha = expf(m_i[r] - m_new);
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const float p0 = expf(s[j][2 * r] - m_new);
        const float p1 = expf(s[j][2 * r + 1] - m_new);
        st2(Ps + row * LP + wc * 16 + j * 8 + 2 * t, p0, p1);
        psum += p0 + p1;
      }
      psum += __shfl_xor_sync(0xffffffffu, psum, 1);
      psum += __shfl_xor_sync(0xffffffffu, psum, 2);
      l_i[r] = l_i[r] * alpha + psum;
      m_i[r] = m_new;
#pragma unroll
      for (int j = 0; j < DW / 8; ++j) {
        o[j][2 * r] *= alpha;
        o[j][2 * r + 1] *= alpha;
      }
    }
    __syncthreads();  // the rows' P is whole
    const float* pw = Ps + wr * 16 * LP;
    const float* vw = Vs + wc * DW;
#pragma unroll 2
    for (int kk = 0; kk < KT; kk += kStep<float>) {
      AFrag<float> fa;
      load_a(fa, pw + kk, LP, g, t);
#pragma unroll
      for (int j = 0; j < DW / 8; ++j) {
        BFrag<float> fb;
        load_b<false>(fb, vw + kk * LV + j * 8, LV, g, t);
        mma(o[j], fa, fb);
      }
    }
  }
  // the four quarters' row sums
  __syncthreads();
  if (t == 0)
#pragma unroll
    for (int r = 0; r < 2; ++r)
      red[(4 + wc) * QT + wr * 16 + g + 8 * r] = l_i[r];
  __syncthreads();
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = wr * 16 + g + 8 * r;
    float l = 0.f;
#pragma unroll
    for (int c = 0; c < 4; ++c) l += red[(4 + c) * QT + row];
    float* orow = a.attn + ((size_t)e * S + q0 + row) * C + (size_t)h * d;
#pragma unroll
    for (int j = 0; j < DW / 8; ++j) {
      const int c = wc * DW + j * 8 + 2 * t;
      if (c < d) st2(orow + c, o[j][2 * r] / l, o[j][2 * r + 1] / l);
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kAttnThreads) bb_attn_kernel(
    const BBArgs<T> a) {
  constexpr int LQ = D + kPadA<T>, LV = D + kPadV<T>, LP = KT + kPadA<T>;
  constexpr int DW = D / 4;  // output columns of a warp
  extern __shared__ __align__(16) float asm_[];
  float* Qs = asm_;            // [QT][LQ]
  float* Ks = Qs + QT * LQ;    // [KT][LQ]
  float* Vs = Ks + KT * LQ;    // [KT][LV]
  float* Ps = Vs + KT * LV;    // [QT][LP]: probabilities
  float* red = Ps + QT * LP;   // [2][4][QT]: each quarter's max, sum
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3, wr = warp >> 2, wc = warp & 3;
  const int S = a.S, C = a.C, d = C / a.nh;
  const int q0 = blockIdx.x * QT, h = blockIdx.y, e = blockIdx.z;
  const size_t row3 = 3 * (size_t)C;
  const T* base = a.qkv + (size_t)e * S * row3 + (size_t)h * d;

  // 64 rows of d columns (zeros up to D) from src into dst
  auto tile_in = [&](float* dst, int ld, const T* src, int r0) {
    for (int idx = tid; idx < 64 * (D / 4); idx += kAttnThreads) {
      const int r = idx / (D / 4), c = (idx - r * (D / 4)) * 4;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (c < d) v = load4(src + (size_t)(r0 + r) * row3 + c);
      *reinterpret_cast<float4*>(dst + r * ld + c) = v;
    }
  };
  // s (16 x 16): this warp's rows against its 16 keys of the tile
  auto scores = [&](float (&s)[2][4]) {
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) s[j][i] = 0.f;
    const float* qw = Qs + wr * 16 * LQ;
    const float* kw = Ks + wc * 16 * LQ;
#pragma unroll 4
    for (int kk = 0; kk < D; kk += kStep<T>) {
      AFrag<T> fa;
      load_a(fa, qw + kk, LQ, g, t);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        BFrag<T> fb;
        load_b<true>(fb, kw + j * 8 * LQ + kk, LQ, g, t);
        mma(s[j], fa, fb);
      }
    }
  };

  tile_in(Qs, LQ, base, q0);
  if constexpr (sizeof(T) == 4) {
    attn_online_f32<D>(a, Qs, Ks, Vs, Ps, red, base, q0, e, h, tile_in,
                       scores);
    return;
  }
  // bf16, pass 1: each row's maximum and sum of exp(s - max) over this warp's
  // keys; this thread holds rows g (r = 0) and g + 8 (r = 1) of the warp's,
  // a row's 16 keys spread over a quad of lanes
  float m_i[2] = {-INFINITY, -INFINITY}, l_i[2] = {0.f, 0.f};
  for (int k0 = 0; k0 < S; k0 += KT) {
    __syncthreads();  // the previous key tile is read
    tile_in(Ks, LQ, base + C, k0);
    __syncthreads();
    float s[2][4];
    scores(s);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = fmaxf(fmaxf(s[0][2 * r], s[0][2 * r + 1]),
                       fmaxf(s[1][2 * r], s[1][2 * r + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m_i[r], mx);
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < 2; ++j)
        psum += expf(s[j][2 * r] - m_new) + expf(s[j][2 * r + 1] - m_new);
      psum += __shfl_xor_sync(0xffffffffu, psum, 1);
      psum += __shfl_xor_sync(0xffffffffu, psum, 2);
      l_i[r] = l_i[r] * expf(m_i[r] - m_new) + psum;
      m_i[r] = m_new;
    }
  }
  // the four quarters' statistics into each row's
  if (t == 0)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = wr * 16 + g + 8 * r;
      red[wc * QT + row] = m_i[r];
      red[(4 + wc) * QT + row] = l_i[r];
    }
  __syncthreads();
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = wr * 16 + g + 8 * r;
    float m = red[row];
#pragma unroll
    for (int c = 1; c < 4; ++c) m = fmaxf(m, red[c * QT + row]);
    float l = 0.f;
#pragma unroll
    for (int c = 0; c < 4; ++c)
      l += red[(4 + c) * QT + row] * expf(red[c * QT + row] - m);
    m_i[r] = m;
    l_i[r] = l;
  }

  // pass 2: p = dt(exp(s - max) / sum) through the P tile, o += p v
  float o[DW / 8][4];
#pragma unroll
  for (int j = 0; j < DW / 8; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) o[j][i] = 0.f;
  for (int k0 = 0; k0 < S; k0 += KT) {
    __syncthreads();  // the previous K, V and P tiles are read
    tile_in(Ks, LQ, base + C, k0);
    tile_in(Vs, LV, base + 2 * C, k0);
    __syncthreads();
    float s[2][4];
    scores(s);
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int r = 0; r < 2; ++r)
        st2(Ps + (wr * 16 + g + 8 * r) * LP + wc * 16 + j * 8 + 2 * t,
            round_t<T>(expf(s[j][2 * r] - m_i[r]) / l_i[r]),
            round_t<T>(expf(s[j][2 * r + 1] - m_i[r]) / l_i[r]));
    __syncthreads();  // the rows' P is whole
    const float* pw = Ps + wr * 16 * LP;
    const float* vw = Vs + wc * DW;
#pragma unroll 2
    for (int kk = 0; kk < KT; kk += kStep<T>) {
      AFrag<T> fa;
      load_a(fa, pw + kk, LP, g, t);
#pragma unroll
      for (int j = 0; j < DW / 8; ++j) {
        BFrag<T> fb;
        load_b<false>(fb, vw + kk * LV + j * 8, LV, g, t);
        mma(o[j], fa, fb);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    T* orow = a.attn + ((size_t)e * S + q0 + wr * 16 + g + 8 * r) * C +
              (size_t)h * d;
#pragma unroll
    for (int j = 0; j < DW / 8; ++j) {
      const int c = wc * DW + j * 8 + 2 * t;
      if (c < d)
        st2(orow + c, round_t<T>(o[j][2 * r]), round_t<T>(o[j][2 * r + 1]));
    }
  }
}

// each kernel's shared-memory limit is raised once a process (the
// attribute call costs host time on every launch otherwise)
template <typename T, int D>
cudaError_t launch_attn(const BBArgs<T>& a, int B, cudaStream_t stream) {
  const int smem = attn_smem_bytes<T, D>();
  static const cudaError_t allowed = cudaFuncSetAttribute(
      bb_attn_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (allowed != cudaSuccess) return allowed;
  bb_attn_kernel<T, D>
      <<<dim3(a.S / QT, a.nh, B), kAttnThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T, int GEMM>
cudaError_t launch_gemm(const BBArgs<T>& a, int M, int N,
                        cudaStream_t stream) {
  const int smem = gemm_smem_bytes<T>();
  static const cudaError_t allowed = cudaFuncSetAttribute(
      bb_gemm_kernel<T, GEMM>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (allowed != cudaSuccess) return allowed;
  bb_gemm_kernel<T, GEMM><<<dim3((N + GN - 1) / GN, (M + GM - 1) / GM), 256,
                            smem, stream>>>(a, M, N, a.C);
  return cudaGetLastError();
}

// the shapes launches (2)-(4) take
template <typename T>
bool takes(const BBArgs<T>& a) {
  const int d = a.C / a.nh;
  return a.S % QT == 0 && a.C % a.G == 0 && a.C % GK == 0 && d % 4 == 0 &&
         d <= 256;
}

// launches (2)-(4), the qkv GEMM normalising as QKV_GEMM says
template <typename T, int QKV_GEMM>
cudaError_t launch_block(const BBArgs<T>& a, int B, cudaStream_t stream) {
  const int M = B * a.S, d = a.C / a.nh;
  cudaError_t err = launch_gemm<T, QKV_GEMM>(a, M, 3 * a.C, stream);
  if (err == cudaSuccess)
    err = d <= 64    ? launch_attn<T, 64>(a, B, stream)
          : d <= 128 ? launch_attn<T, 128>(a, B, stream)
                     : launch_attn<T, 256>(a, B, stream);
  if (err == cudaSuccess) err = launch_gemm<T, kProj>(a, M, a.C, stream);
  return err;
}

// K7: its one-pass statistics, then the block
template <typename T>
cudaError_t launch_bb(const BBArgs<T>& a, int B, int bb, cudaStream_t stream) {
  if (bb < 2 || B % bb || !takes(a)) return cudaErrorInvalidValue;
  bb_stats_kernel<T><<<(B * a.G + 7) / 8, 256, 0, stream>>>(a, B);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_block<T, kQkvScaleShift>(a, B, stream);
}

// K2 fp32: K1's two-pass statistics, then the block
cudaError_t launch_k2(const BBArgs<float>& a, int B, cudaStream_t stream) {
  if (!takes(a)) return cudaErrorInvalidValue;
  cudaError_t err = launch_gn_stats(a.x, a.mean_c, a.rstd_c, B, a.S, a.C,
                                    a.G, a.eps, stream);
  if (err != cudaSuccess) return err;
  return launch_block<float, kQkvMeanRstd>(a, B, stream);
}

template <typename T>
BBArgs<T> args(const void* x, const float* gs, const float* gb,
               const void* w_qkv, const void* b_qkv, const void* w_proj,
               const void* b_proj, void* y, void* qkv, void* attn, int S,
               int C, int nh, int G, float eps, float qk_scale) {
  BBArgs<T> a = {};
  a.x = static_cast<const T*>(x);
  a.gs = gs;
  a.gb = gb;
  a.w_qkv = static_cast<const T*>(w_qkv);
  a.b_qkv = static_cast<const T*>(b_qkv);
  a.w_proj = static_cast<const T*>(w_proj);
  a.b_proj = static_cast<const T*>(b_proj);
  a.y = static_cast<T*>(y);
  a.qkv = static_cast<T*>(qkv);
  a.attn = static_cast<T*>(attn);
  a.S = S;
  a.C = C;
  a.nh = nh;
  a.G = G;
  a.eps = eps;
  a.qk_scale = qk_scale;
  return a;
}

float qk_scale_f32(int C, int nh) {
  return (float)(1.0 / sqrt(sqrt((double)(C / nh))));
}

}  // namespace

cudaError_t launch_attn_core_bb(const bf16* qkv, bf16* attn, int B, int S,
                                int C, int nh, cudaStream_t stream) {
  const int d = nh > 0 ? C / nh : 0;
  if (B < 1 || S % QT || nh < 1 || C % nh || d % 8 || d > 256)
    return cudaErrorInvalidValue;
  BBArgs<bf16> a = {};
  a.qkv = const_cast<bf16*>(qkv);
  a.attn = attn;
  a.S = S;
  a.C = C;
  a.nh = nh;
  return d <= 64    ? launch_attn<bf16, 64>(a, B, stream)
         : d <= 128 ? launch_attn<bf16, 128>(a, B, stream)
                    : launch_attn<bf16, 256>(a, B, stream);
}

// x, y: (B, S, C) fp32; w_qkv: (C, 3C) with [3, nh, d] output columns;
// b_qkv (3C,); w_proj (C, C); b_proj (C,); gs, gb (C,); stats: (B, 2, C)
// fp32 scratch; qkv: (B, S, 3C) and attn: (B, S, C) scratch. Needs
// B % bb == 0, bb >= 2, S % 64 == 0, C % 32 == 0 and d = C / nh with
// d % 4 == 0, d <= 256.
extern "C" int dxmi_attn_block_bb(const void* x, const float* gs,
                                  const float* gb, const void* w_qkv,
                                  const void* b_qkv, const void* w_proj,
                                  const void* b_proj, void* y, float* stats,
                                  void* qkv, void* attn, int B, int S, int C,
                                  int nh, int G, int bb, float eps,
                                  void* stream) {
  BBArgs<float> a = args<float>(x, gs, gb, w_qkv, b_qkv, w_proj, b_proj, y,
                                qkv, attn, S, C, nh, G, eps,
                                qk_scale_f32(C, nh));
  a.stats = stats;
  return (int)launch_bb(a, B, bb, (cudaStream_t)stream);
}

// The same arguments with bf16 x, y, weights, biases and scratch (GN
// parameters and statistics fp32).
extern "C" int dxmi_attn_block_bb_bf16(const void* x, const float* gs,
                                       const float* gb, const void* w_qkv,
                                       const void* b_qkv, const void* w_proj,
                                       const void* b_proj, void* y,
                                       float* stats, void* qkv, void* attn,
                                       int B, int S, int C, int nh, int G,
                                       int bb, float eps, void* stream) {
  // the TPU body scales by jnp.asarray(d ** -0.25, bf16)
  const float qk = __bfloat162float(__float2bfloat16_rn(qk_scale_f32(C, nh)));
  BBArgs<bf16> a = args<bf16>(x, gs, gb, w_qkv, b_qkv, w_proj, b_proj, y, qkv,
                              attn, S, C, nh, G, eps, qk);
  a.stats = stats;
  return (int)launch_bb(a, B, bb, (cudaStream_t)stream);
}

// K2 fp32 (bb = 1): x, y: (B, S, C); w_qkv: (C, 3C) with [3, nh, d] output
// columns; b_qkv (3C,); w_proj (C, C); b_proj (C,); gs, gb (C,); mean_c,
// rstd_c: (B, C) fp32 scratch; qkv: (B, S, 3C) and attn: (B, S, C) scratch.
// Needs S % 64 == 0, C % 32 == 0, a shape K1's statistics take and
// d = C / nh with d % 4 == 0, d <= 256.
extern "C" int dxmi_attn_block(const float* x, const float* gs,
                               const float* gb, const float* w_qkv,
                               const float* b_qkv, const float* w_proj,
                               const float* b_proj, float* y, float* mean_c,
                               float* rstd_c, float* qkv, float* attn, int B,
                               int S, int C, int nh, int G, float eps,
                               void* stream) {
  BBArgs<float> a = args<float>(x, gs, gb, w_qkv, b_qkv, w_proj, b_proj, y,
                                qkv, attn, S, C, nh, G, eps,
                                qk_scale_f32(C, nh));
  a.mean_c = mean_c;
  a.rstd_c = rstd_c;
  return (int)launch_k2(a, B, (cudaStream_t)stream);
}
