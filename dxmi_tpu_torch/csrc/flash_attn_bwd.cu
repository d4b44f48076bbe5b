// K4's backward: dq, dk and dv of o = softmax(q k^T * sm_scale) v, bf16,
// and the attention backward core that K6 (attn_block_bwd.cu) shares.
//
// Replaces: JAX's bundled Pallas TPU flash-attention backward, reached by
// jax.grad of dxmi_tpu/ops/attention.py:53 _flash_bnsd:
// _flash_attention_dkv_kernel (flash_attention.py:796, pallas_call :1121)
// and _flash_attention_dq_kernel (:1146, pallas_call :1456), with one kv
// block (block_k = S). Their arithmetic: di = rowsum(o * do) in fp32
// (:273-275); p = exp(s * sm_scale - m) / l in fp32 from the forward's
// residuals; dv += bf16(p)^T do; dp = do v^T; ds = (dp - di) p sm_scale;
// dk += bf16(ds)^T q; dq += bf16(ds) k; fp32 accumulation, dq, dk and dv
// cast to bf16 at the end. The TPU holds a head's whole q, k, v and do in
// VMEM and runs the grid in order.
//
// Bound on the H100: operations. At the ImageNet64 32x32 maps (B=128,
// nh=6, S=1024, d=64) the backward's five S x S x d products (s, dp, dv,
// dk, dq; the two kernels each form s and dp) are 5 * 2 B nh S^2 d =
// 0.52 TFLOP, 0.52 ms at the 989 TFLOP/s bf16 tensor-core peak, against
// 0.81 GB of q, k, v, o, do and dq, dk, dv (0.24 ms at 3.35 TB/s). K4-dkv
// alone does four of them (0.41 TFLOP, 0.42 ms).
//
// Design of K4-dkv in bf16 (attn_bwd_dkv_tc_kernel, tensor cores): a block
// of 4 warps owns 64 keys of one (sample, head), each warp 16 of them. K
// and V are copied once into shared memory (rows D + 8 bf16 apart, so that
// ldmatrix is free of bank conflicts; head dims below D are zero-padded),
// and the block walks over the queries in tiles of 64, q, do, lse and di
// double-buffered with cp.async. Per warp and query tile, on mma.sync
// m16n8k16 (bf16 operands, fp32 accumulators):
//   s^T = K q^T          (q's B fragments by ldmatrix),
//   p = exp(s^T sm_scale - lse) in fp32, packed to bf16 straight from the
//       accumulator registers into A fragments,
//   dv += p^T do         (do's B fragments by ldmatrix.trans),
//   dp^T = V do^T        (do by ldmatrix),
//   ds = p (dp - di) sm_scale in fp32 on the unrounded p, packed to bf16,
//   dk += ds^T q         (q by ldmatrix.trans).
// dk and dv stay in fp32 registers until the epilogue. Every rounding of
// the TPU body is a bf16 operand entering an fp32 sum, which is what
// mma.sync does, so only the order of the fp32 sums differs from the SIMT
// form. Each sum is owned by one warp and taken in a fixed order, with no
// atomics: replays reproduce themselves bit for bit.
//
// Design of K4-dq in bf16 (attn_bwd_dq_tc_kernel, tensor cores), K4-dkv's
// mirror image: query-stationary. A block of 4 warps owns 64 query rows of
// one (sample, head), each warp 16 of them; q and do are copied once and
// each warp keeps their A fragments in registers; K and V stream in tiles
// of 64 keys through two cp.async stages. Per warp and key tile:
//   s = q K^T and dp = do V^T  (K and V B fragments by ldmatrix),
//   p = exp(s sm_scale - lse), ds = p (dp - di) sm_scale in fp32 on the
//       unrounded p, packed to bf16 from the accumulator registers into A
//       fragments,
//   dq += ds K                 (K by ldmatrix.trans).
// dq stays in fp32 registers until the epilogue, which multiplies by
// out_scale_qk and writes the fp32 and/or the bf16 form. Its three
// products are 3 * 2 B nh S^2 d = 0.31 TFLOP at the 32x32 maps, 0.31 ms at
// the bf16 peak; K6's dq pass is the same launch (sm_scale 1, q and k
// pre-scaled, both output forms).
//
// The fp32 instantiations (K6's fp32 form, G3's shape, on no main path)
// keep the first, simple design: fp32 SIMT arithmetic (bf16 tensor cores
// would change the fp32 form's precision).
//   dkv: a block of 256 threads owns 64 keys of one (sample, head) and
//     keeps its K and V tiles and its dk, dv accumulators on chip; it walks
//     over the query rows in tiles of 64 (q, do, lse and di into shared
//     memory), forms the 64 x 64 tiles of s = k q^T and dp = v do^T, p and
//     ds in fp32 and, rounded to the element type, adds p^T do and ds^T q.
//   dq: a block owns 64 query rows and walks over the keys in tiles of 64
//     the same way, adding ds k.
// Each thread holds 4 rows x 4 columns of a 64 x 64 tile (rows 4ty..,
// columns tx + 16j) and 4 rows x d/16 columns of its accumulators.
// di (K4-dkv's first launch): 8 lanes per (sample, position, head) row,
// 16 bytes each, summed by shuffles. K6 runs the same kernels with
// sm_scale 1 on q and k pre-scaled by d^-1/4, fp32 outputs beside the
// rounded ones, and dq, dk times d^-1/4.
#include <math.h>

#include <type_traits>

#include "common.cuh"

namespace {

constexpr int BT = kBwdTile, LDS = BT + 4;

template <int D>
__host__ __device__ constexpr int dkv_smem_floats() {
  return 4 * BT * (D + 4) + 2 * BT * LDS + 2 * BT;
}
template <int D>
__host__ __device__ constexpr int dq_smem_floats() {
  return 4 * BT * (D + 4) + BT * LDS;
}

template <typename T>
__device__ __forceinline__ void put(float* f, T* t, size_t idx, float v) {
  if (f != nullptr) f[idx] = v;
  if (t != nullptr) store_as(t + idx, v);
}

// ---- K4-dkv on the tensor cores (bf16) ----------------------------------
constexpr int TBK = 64, TBQ = 64, kTcThreads = 128;

template <int D>
__host__ __device__ constexpr int dkv_tc_smem_bytes() {
  // K, V; two stages of q and do (bf16); two stages of lse and di (fp32)
  return (2 * TBK + 4 * TBQ) * (D + 8) * 2 + 4 * TBQ * 4;
}

template <int D>
__global__ void __launch_bounds__(kTcThreads)
attn_bwd_dkv_tc_kernel(AttnBwdArgs<bf16> a, int v16) {
  constexpr int LD = D + 8, NK = D / 16, NN = D / 8;
  extern __shared__ __align__(128) unsigned char smem_tc[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_tc);
  bf16* Vs = Ks + TBK * LD;
  bf16* Qs = Vs + TBK * LD;      // [2][TBQ][LD]
  bf16* Os = Qs + 2 * TBQ * LD;  // [2][TBQ][LD]: the output's cotangent
  float* Ls = reinterpret_cast<float*>(Os + 2 * TBQ * LD);  // [2][TBQ]
  float* Ds = Ls + 2 * TBQ;                                  // [2][TBQ]
  const int b = blockIdx.z, h = blockIdx.y, k0 = blockIdx.x * TBK;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int S = a.S, d = a.d;
  const size_t in_base = (size_t)b * S * a.in_stride + (size_t)h * d;
  const size_t do_base = (size_t)b * S * a.dout_stride + (size_t)h * d;
  const size_t st_base = ((size_t)b * a.nh + h) * S;

  auto load_q = [&](int q0, int st) {
    rows_in_bf16<D>(Qs + st * TBQ * LD,
                    a.q + in_base + (size_t)q0 * a.in_stride, a.in_stride, d,
                    v16);
    rows_in_bf16<D>(Os + st * TBQ * LD,
                    a.dout + do_base + (size_t)q0 * a.dout_stride,
                    a.dout_stride, d, v16);
    if (tid < TBQ / 4)
      cp_async16(smem_u32(Ls + st * TBQ + 4 * tid),
                 a.lse + st_base + q0 + 4 * tid, 16);
    else if (tid < TBQ / 2)
      cp_async16(smem_u32(Ds + st * TBQ + 4 * tid - TBQ),
                 a.di + st_base + q0 + 4 * tid - TBQ, 16);
  };

  rows_in_bf16<D>(Ks, a.k + in_base + (size_t)k0 * a.in_stride, a.in_stride,
                  d, v16);
  rows_in_bf16<D>(Vs, a.v + in_base + (size_t)k0 * a.in_stride, a.in_stride,
                  d, v16);
  load_q(0, 0);
  cp_async_commit();

  float dk[NN][4], dv[NN][4];
#pragma unroll
  for (int n = 0; n < NN; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.f;
  const bf16* Kw = Ks + warp * 16 * LD;  // this warp's 16 keys
  const bf16* Vw = Vs + warp * 16 * LD;

  const int n_tiles = S / TBQ;
  for (int it = 0; it < n_tiles; ++it) {
    const int st = it & 1;
    if (it + 1 < n_tiles)  // stage st^1 was last read before the last barrier
      load_q((it + 1) * TBQ, st ^ 1);
    cp_async_commit();
    cp_async_wait<1>();  // this tile's group has landed
    __syncthreads();
    const bf16* Qt = Qs + st * TBQ * LD;
    const bf16* Ot = Os + st * TBQ * LD;
    const float* Lt = Ls + st * TBQ;
    const float* Dt = Ds + st * TBQ;

    // s^T = K q^T: this warp's 16 keys x 64 queries, 8 n-tiles of 8
    // queries; the thread holds keys g (e = 0, 1) and g + 8 (e = 2, 3) and
    // queries 8j + 2t + (e & 1)
    float s[8][4], dp[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < NK; ++kk) {
      unsigned ka[4], va[4];
      ldsm_x4(ka, smem_u32(Kw + (lane & 15) * LD + kk * 16 + (lane >> 4) * 8));
      ldsm_x4(va, smem_u32(Vw + (lane & 15) * LD + kk * 16 + (lane >> 4) * 8));
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int row = (jj * 16 + (lane & 7) + (lane >> 4) * 8) * LD +
                        kk * 16 + ((lane >> 3) & 1) * 8;
        unsigned r[4];
        ldsm_x4(r, smem_u32(Qt + row));
        mma_bf16(s[2 * jj], ka, r[0], r[1]);
        mma_bf16(s[2 * jj + 1], ka, r[2], r[3]);
        // dp^T = V do^T
        ldsm_x4(r, smem_u32(Ot + row));
        mma_bf16(dp[2 * jj], va, r[0], r[1]);
        mma_bf16(dp[2 * jj + 1], va, r[2], r[3]);
      }
    }
    // p = exp(s sm_scale - lse) and ds = p (dp - di) sm_scale in fp32
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int q = 8 * j + 2 * t + (e & 1);
        const float p =
            expf(__fsub_rn(__fmul_rn(s[j][e], a.sm_scale), Lt[q]));
        s[j][e] = p;
        dp[j][e] =
            __fmul_rn(__fmul_rn(__fsub_rn(dp[j][e], Dt[q]), p), a.sm_scale);
      }
    // dv += bf16(p)^T do and dk += bf16(ds)^T q over the tile's 64 queries:
    // the accumulator layout of p and ds is the A fragment layout
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const unsigned pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                              pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                              pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
      const unsigned sa[4] = {pack_bf16(dp[2 * kk][0], dp[2 * kk][1]),
                              pack_bf16(dp[2 * kk][2], dp[2 * kk][3]),
                              pack_bf16(dp[2 * kk + 1][0], dp[2 * kk + 1][1]),
                              pack_bf16(dp[2 * kk + 1][2], dp[2 * kk + 1][3])};
#pragma unroll
      for (int nn = 0; nn < NK; ++nn) {
        const int row = (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD +
                        nn * 16 + (lane >> 4) * 8;
        unsigned r[4];
        ldsm_x4_trans(r, smem_u32(Ot + row));
        mma_bf16(dv[2 * nn], pa, r[0], r[1]);
        mma_bf16(dv[2 * nn + 1], pa, r[2], r[3]);
        ldsm_x4_trans(r, smem_u32(Qt + row));
        mma_bf16(dk[2 * nn], sa, r[0], r[1]);
        mma_bf16(dk[2 * nn + 1], sa, r[2], r[3]);
      }
    }
    __syncthreads();  // the next loads overwrite the stage just read
  }

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const size_t row = ((size_t)b * S + k0 + warp * 16 + g + 8 * half) *
                           a.out_stride + (size_t)h * d;
#pragma unroll
    for (int n = 0; n < NN; ++n) {
      const int c = 8 * n + 2 * t;  // d is even: c < d takes c + 1 too
      if (c >= d) continue;
      const float k0v = dk[n][2 * half] * a.out_scale_qk;
      const float k1v = dk[n][2 * half + 1] * a.out_scale_qk;
      const float v0 = dv[n][2 * half], v1 = dv[n][2 * half + 1];
      if (a.dk_f != nullptr)
        *reinterpret_cast<float2*>(a.dk_f + row + c) = make_float2(k0v, k1v);
      if (a.dv_f != nullptr)
        *reinterpret_cast<float2*>(a.dv_f + row + c) = make_float2(v0, v1);
      if (a.dk_t != nullptr)
        *reinterpret_cast<unsigned*>(a.dk_t + row + c) = pack_bf16(k0v, k1v);
      if (a.dv_t != nullptr)
        *reinterpret_cast<unsigned*>(a.dv_t + row + c) = pack_bf16(v0, v1);
    }
  }
}

// ---- K4-dq on the tensor cores (bf16) -----------------------------------
template <int D>
__host__ __device__ constexpr int dq_tc_smem_bytes() {
  // q, do; two stages of K and V (bf16)
  return (2 * TBQ + 4 * TBK) * (D + 8) * 2;
}

template <int D>
__global__ void __launch_bounds__(kTcThreads)
attn_bwd_dq_tc_kernel(AttnBwdArgs<bf16> a, int v16) {
  constexpr int LD = D + 8, NK = D / 16, NN = D / 8;
  extern __shared__ __align__(128) unsigned char smem_tc[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_tc);
  bf16* Os = Qs + TBQ * LD;      // the output's cotangent
  bf16* Ks = Os + TBQ * LD;      // [2][TBK][LD]
  bf16* Vs = Ks + 2 * TBK * LD;  // [2][TBK][LD]
  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * TBQ;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int S = a.S, d = a.d;
  const size_t in_base = (size_t)b * S * a.in_stride + (size_t)h * d;
  const size_t do_base = (size_t)b * S * a.dout_stride + (size_t)h * d;
  const size_t st_row = ((size_t)b * a.nh + h) * S + q0 + warp * 16 + g;

  auto load_kv = [&](int k0, int st) {
    rows_in_bf16<D>(Ks + st * TBK * LD,
                    a.k + in_base + (size_t)k0 * a.in_stride, a.in_stride, d,
                    v16);
    rows_in_bf16<D>(Vs + st * TBK * LD,
                    a.v + in_base + (size_t)k0 * a.in_stride, a.in_stride, d,
                    v16);
  };

  rows_in_bf16<D>(Qs, a.q + in_base + (size_t)q0 * a.in_stride, a.in_stride,
                  d, v16);
  rows_in_bf16<D>(Os, a.dout + do_base + (size_t)q0 * a.dout_stride,
                  a.dout_stride, d, v16);
  load_kv(0, 0);
  cp_async_commit();
  // the thread's two rows of the warp's 16: g (e = 0, 1) and g + 8 (e = 2, 3)
  const float lse[2] = {a.lse[st_row], a.lse[st_row + 8]};
  const float di[2] = {a.di[st_row], a.di[st_row + 8]};

  float dq[NN][4];
#pragma unroll
  for (int n = 0; n < NN; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[n][e] = 0.f;
  unsigned qa[NK][4], oa[NK][4];  // this warp's q and do A fragments

  const int n_tiles = S / TBK;
  for (int it = 0; it < n_tiles; ++it) {
    const int st = it & 1;
    if (it + 1 < n_tiles)  // stage st^1 was last read before the last barrier
      load_kv((it + 1) * TBK, st ^ 1);
    cp_async_commit();
    cp_async_wait<1>();  // this tile's group (and q, do with the first) landed
    __syncthreads();
    if (it == 0) {
#pragma unroll
      for (int kk = 0; kk < NK; ++kk) {
        const int off = (warp * 16 + (lane & 15)) * LD + kk * 16 +
                        (lane >> 4) * 8;
        ldsm_x4(qa[kk], smem_u32(Qs + off));
        ldsm_x4(oa[kk], smem_u32(Os + off));
      }
    }
    const bf16* Kt = Ks + st * TBK * LD;
    const bf16* Vt = Vs + st * TBK * LD;

    // s = q K^T and dp = do V^T: this warp's 16 queries x 64 keys, 8
    // n-tiles of 8 keys; the thread holds queries g (e = 0, 1) and g + 8
    // (e = 2, 3) and keys 8j + 2t + (e & 1)
    float s[8][4], dp[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < NK; ++kk) {
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int row = (jj * 16 + (lane & 7) + (lane >> 4) * 8) * LD +
                        kk * 16 + ((lane >> 3) & 1) * 8;
        unsigned r[4];
        ldsm_x4(r, smem_u32(Kt + row));
        mma_bf16(s[2 * jj], qa[kk], r[0], r[1]);
        mma_bf16(s[2 * jj + 1], qa[kk], r[2], r[3]);
        ldsm_x4(r, smem_u32(Vt + row));
        mma_bf16(dp[2 * jj], oa[kk], r[0], r[1]);
        mma_bf16(dp[2 * jj + 1], oa[kk], r[2], r[3]);
      }
    }
    // p = exp(s sm_scale - lse) and ds = p (dp - di) sm_scale in fp32, on
    // the unrounded p
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p =
            expf(__fsub_rn(__fmul_rn(s[j][e], a.sm_scale), lse[e >> 1]));
        dp[j][e] = __fmul_rn(__fmul_rn(__fsub_rn(dp[j][e], di[e >> 1]), p),
                             a.sm_scale);
      }
    // dq += bf16(ds) K over the tile's 64 keys: ds's accumulator layout is
    // the A fragment layout; K's B fragments by ldmatrix.trans
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const unsigned sa[4] = {pack_bf16(dp[2 * kk][0], dp[2 * kk][1]),
                              pack_bf16(dp[2 * kk][2], dp[2 * kk][3]),
                              pack_bf16(dp[2 * kk + 1][0], dp[2 * kk + 1][1]),
                              pack_bf16(dp[2 * kk + 1][2], dp[2 * kk + 1][3])};
#pragma unroll
      for (int nn = 0; nn < NK; ++nn) {
        const int row = (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD +
                        nn * 16 + (lane >> 4) * 8;
        unsigned r[4];
        ldsm_x4_trans(r, smem_u32(Kt + row));
        mma_bf16(dq[2 * nn], sa, r[0], r[1]);
        mma_bf16(dq[2 * nn + 1], sa, r[2], r[3]);
      }
    }
    __syncthreads();  // the next loads overwrite the stage just read
  }

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const size_t row = ((size_t)b * S + q0 + warp * 16 + g + 8 * half) *
                           a.out_stride + (size_t)h * d;
#pragma unroll
    for (int n = 0; n < NN; ++n) {
      const int c = 8 * n + 2 * t;  // d is even: c < d takes c + 1 too
      if (c >= d) continue;
      const float v0 = dq[n][2 * half] * a.out_scale_qk;
      const float v1 = dq[n][2 * half + 1] * a.out_scale_qk;
      if (a.dq_f != nullptr)
        *reinterpret_cast<float2*>(a.dq_f + row + c) = make_float2(v0, v1);
      if (a.dq_t != nullptr)
        *reinterpret_cast<unsigned*>(a.dq_t + row + c) = pack_bf16(v0, v1);
    }
  }
}

// ---- the SIMT forms: fp32 K4-dkv and K4-dq (K6's fp32 form) -------------
template <typename T, int D>
__global__ void __launch_bounds__(kBwdThreads)
attn_bwd_dkv_kernel(AttnBwdArgs<T> a) {
  constexpr int LD = D + 4, NI = D / 16;
  extern __shared__ __align__(16) float smem[];
  float* Ks = smem;
  float* Vs = Ks + BT * LD;
  float* Qs = Vs + BT * LD;
  float* Os = Qs + BT * LD;  // the output's cotangent rows
  float* Pt = Os + BT * LD;  // [key][query]: T(p)
  float* St = Pt + BT * LDS;  // [key][query]: T(ds)
  float* Ls = St + BT * LDS;
  float* Ds = Ls + BT;
  const int b = blockIdx.z, h = blockIdx.y, k0 = blockIdx.x * BT;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int S = a.S, d = a.d;
  const size_t in_base = (size_t)b * S * a.in_stride + (size_t)h * d;
  const size_t do_base = (size_t)b * S * a.dout_stride + (size_t)h * d;
  const size_t st_base = ((size_t)b * a.nh + h) * S;

  tile_in<T, D>(Ks, a.k + in_base + (size_t)k0 * a.in_stride, a.in_stride, d);
  tile_in<T, D>(Vs, a.v + in_base + (size_t)k0 * a.in_stride, a.in_stride, d);
  float dk[4][NI], dv[4][NI];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int i = 0; i < NI; ++i) dk[r][i] = dv[r][i] = 0.f;

  for (int q0 = 0; q0 < S; q0 += BT) {
    __syncthreads();  // the previous tile's q, do, p and ds are read
    tile_in<T, D>(Qs, a.q + in_base + (size_t)q0 * a.in_stride, a.in_stride,
                  d);
    tile_in<T, D>(Os, a.dout + do_base + (size_t)q0 * a.dout_stride,
                  a.dout_stride, d);
    if (tid < BT) {
      Ls[tid] = a.lse[st_base + q0 + tid];
      Ds[tid] = a.di[st_base + q0 + tid];
    }
    __syncthreads();
    float s[4][4], dp[4][4];
    tile_dots<D>(s, Ks, Qs, ty, tx);
    tile_dots<D>(dp, Vs, Os, ty, tx);
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int q = tx + 16 * j;
        const float p =
            expf(__fsub_rn(__fmul_rn(s[r][j], a.sm_scale), Ls[q]));
        const float ds =
            __fmul_rn(__fmul_rn(__fsub_rn(dp[r][j], Ds[q]), p), a.sm_scale);
        Pt[(4 * ty + r) * LDS + q] = round_t<T>(p);
        St[(4 * ty + r) * LDS + q] = round_t<T>(ds);
      }
    __syncthreads();
#pragma unroll 4
    for (int q = 0; q < BT; ++q) {
      float pr[4], sr[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        pr[r] = Pt[(4 * ty + r) * LDS + q];
        sr[r] = St[(4 * ty + r) * LDS + q];
      }
#pragma unroll
      for (int i = 0; i < NI; ++i) {
        const float o = Os[q * LD + tx + 16 * i];
        const float qq = Qs[q * LD + tx + 16 * i];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          dv[r][i] = fmaf(pr[r], o, dv[r][i]);
          dk[r][i] = fmaf(sr[r], qq, dk[r][i]);
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const size_t row =
        ((size_t)b * S + k0 + 4 * ty + r) * a.out_stride + (size_t)h * d;
#pragma unroll
    for (int i = 0; i < NI; ++i) {
      const int c = tx + 16 * i;
      if (c < d) {
        put(a.dk_f, a.dk_t, row + c, dk[r][i] * a.out_scale_qk);
        put(a.dv_f, a.dv_t, row + c, dv[r][i]);
      }
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kBwdThreads)
attn_bwd_dq_kernel(AttnBwdArgs<T> a) {
  constexpr int LD = D + 4, NI = D / 16;
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;
  float* Os = Qs + BT * LD;
  float* Ks = Os + BT * LD;
  float* Vs = Ks + BT * LD;
  float* Sm = Vs + BT * LD;  // [query][key]: T(ds)
  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * BT;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int S = a.S, d = a.d;
  const size_t in_base = (size_t)b * S * a.in_stride + (size_t)h * d;
  const size_t do_base = (size_t)b * S * a.dout_stride + (size_t)h * d;
  const size_t st_base = ((size_t)b * a.nh + h) * S + q0;

  tile_in<T, D>(Qs, a.q + in_base + (size_t)q0 * a.in_stride, a.in_stride, d);
  tile_in<T, D>(Os, a.dout + do_base + (size_t)q0 * a.dout_stride,
                a.dout_stride, d);
  float lse[4], di[4], dq[4][NI];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    lse[r] = a.lse[st_base + 4 * ty + r];
    di[r] = a.di[st_base + 4 * ty + r];
#pragma unroll
    for (int i = 0; i < NI; ++i) dq[r][i] = 0.f;
  }

  for (int k0 = 0; k0 < S; k0 += BT) {
    __syncthreads();  // the previous tile's k, v and ds are read
    tile_in<T, D>(Ks, a.k + in_base + (size_t)k0 * a.in_stride, a.in_stride,
                  d);
    tile_in<T, D>(Vs, a.v + in_base + (size_t)k0 * a.in_stride, a.in_stride,
                  d);
    __syncthreads();
    float s[4][4], dp[4][4];
    tile_dots<D>(s, Qs, Ks, ty, tx);
    tile_dots<D>(dp, Os, Vs, ty, tx);
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p =
            expf(__fsub_rn(__fmul_rn(s[r][j], a.sm_scale), lse[r]));
        const float ds =
            __fmul_rn(__fmul_rn(__fsub_rn(dp[r][j], di[r]), p), a.sm_scale);
        Sm[(4 * ty + r) * LDS + tx + 16 * j] = round_t<T>(ds);
      }
    __syncthreads();
#pragma unroll 4
    for (int k = 0; k < BT; ++k) {
      float sr[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) sr[r] = Sm[(4 * ty + r) * LDS + k];
#pragma unroll
      for (int i = 0; i < NI; ++i) {
        const float kk = Ks[k * LD + tx + 16 * i];
#pragma unroll
        for (int r = 0; r < 4; ++r) dq[r][i] = fmaf(sr[r], kk, dq[r][i]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const size_t row =
        ((size_t)b * S + q0 + 4 * ty + r) * a.out_stride + (size_t)h * d;
#pragma unroll
    for (int i = 0; i < NI; ++i) {
      const int c = tx + 16 * i;
      if (c < d) put(a.dq_f, a.dq_t, row + c, dq[r][i] * a.out_scale_qk);
    }
  }
}

// di[b, h, s] = sum_c o[b, s, h, c] * do[b, s, h, c] in fp32 (o and do
// (B, S, nh, d) contiguous, d % 8 == 0, d <= 64): 8 lanes per row, lane l
// takes columns 8l..8l+7, then the 8 partial sums meet by shuffles
__global__ void di_kernel(const bf16* __restrict__ o,
                          const bf16* __restrict__ dout, float* __restrict__ di,
                          int B, int S, int nh, int d) {
  const size_t row = ((size_t)blockIdx.x * blockDim.x + threadIdx.x) >> 3;
  const int c = (threadIdx.x & 7) * 8;
  const bool live = row < (size_t)B * S * nh;
  float acc = 0.f;
  if (live && c < d) {
    float ov[8], dv[8];
    load8(o + row * d + c, ov);
    load8(dout + row * d + c, dv);
#pragma unroll
    for (int j = 0; j < 8; ++j) acc = fmaf(ov[j], dv[j], acc);
  }
#pragma unroll
  for (int off = 4; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (!live || c != 0) return;
  const int h = (int)(row % nh);
  const size_t bs = row / nh;
  const int s = (int)(bs % S), b = (int)(bs / S);
  di[((size_t)b * nh + h) * S + s] = acc;
}

bool bwd_shape_ok(int S, int d, int s1, int s2, int s3) {
  return S % BT == 0 && d % 4 == 0 && d <= 64 && s1 % 4 == 0 &&
         s2 % 4 == 0 && s3 % 4 == 0;
}

template <typename K>
cudaError_t set_smem(K kernel, int bytes) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

}  // namespace

template <typename T>
cudaError_t launch_attn_bwd_dkv(const AttnBwdArgs<T>& a, int B,
                                cudaStream_t stream) {
  if (!bwd_shape_ok(a.S, a.d, a.in_stride, a.dout_stride, a.out_stride))
    return cudaErrorInvalidValue;
  cudaError_t err;
  if constexpr (std::is_same<T, bf16>::value) {
    // bf16: the tensor-core kernel; 16-byte copies where every row and
    // head starts on 16 bytes, 8-byte loads otherwise
    const int v16 = a.d % 8 == 0 && a.in_stride % 8 == 0 &&
                    a.dout_stride % 8 == 0;
    const dim3 grid(a.S / TBK, a.nh, B);
    if (a.d <= 32) {
      const int bytes = dkv_tc_smem_bytes<32>();
      if ((err = set_smem(attn_bwd_dkv_tc_kernel<32>, bytes)) != cudaSuccess)
        return err;
      attn_bwd_dkv_tc_kernel<32><<<grid, kTcThreads, bytes, stream>>>(a, v16);
    } else {
      const int bytes = dkv_tc_smem_bytes<64>();
      if ((err = set_smem(attn_bwd_dkv_tc_kernel<64>, bytes)) != cudaSuccess)
        return err;
      attn_bwd_dkv_tc_kernel<64><<<grid, kTcThreads, bytes, stream>>>(a, v16);
    }
  } else {
    // fp32: the SIMT kernel (its precision is the fp32 form's)
    const dim3 grid(a.S / BT, a.nh, B);
    if (a.d <= 32) {
      const int bytes = dkv_smem_floats<32>() * (int)sizeof(float);
      if ((err = set_smem(attn_bwd_dkv_kernel<T, 32>, bytes)) != cudaSuccess)
        return err;
      attn_bwd_dkv_kernel<T, 32><<<grid, kBwdThreads, bytes, stream>>>(a);
    } else {
      const int bytes = dkv_smem_floats<64>() * (int)sizeof(float);
      if ((err = set_smem(attn_bwd_dkv_kernel<T, 64>, bytes)) != cudaSuccess)
        return err;
      attn_bwd_dkv_kernel<T, 64><<<grid, kBwdThreads, bytes, stream>>>(a);
    }
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_attn_bwd_dq(const AttnBwdArgs<T>& a, int B,
                               cudaStream_t stream) {
  if (!bwd_shape_ok(a.S, a.d, a.in_stride, a.dout_stride, a.out_stride))
    return cudaErrorInvalidValue;
  cudaError_t err;
  if constexpr (std::is_same<T, bf16>::value) {
    // bf16: the tensor-core kernel, loads as K4-dkv's
    const int v16 = a.d % 8 == 0 && a.in_stride % 8 == 0 &&
                    a.dout_stride % 8 == 0;
    const dim3 grid(a.S / TBQ, a.nh, B);
    if (a.d <= 32) {
      const int bytes = dq_tc_smem_bytes<32>();
      if ((err = set_smem(attn_bwd_dq_tc_kernel<32>, bytes)) != cudaSuccess)
        return err;
      attn_bwd_dq_tc_kernel<32><<<grid, kTcThreads, bytes, stream>>>(a, v16);
    } else {
      const int bytes = dq_tc_smem_bytes<64>();
      if ((err = set_smem(attn_bwd_dq_tc_kernel<64>, bytes)) != cudaSuccess)
        return err;
      attn_bwd_dq_tc_kernel<64><<<grid, kTcThreads, bytes, stream>>>(a, v16);
    }
  } else {
    // fp32: the SIMT kernel (its precision is the fp32 form's)
    const dim3 grid(a.S / BT, a.nh, B);
    if (a.d <= 32) {
      const int bytes = dq_smem_floats<32>() * (int)sizeof(float);
      if ((err = set_smem(attn_bwd_dq_kernel<T, 32>, bytes)) != cudaSuccess)
        return err;
      attn_bwd_dq_kernel<T, 32><<<grid, kBwdThreads, bytes, stream>>>(a);
    } else {
      const int bytes = dq_smem_floats<64>() * (int)sizeof(float);
      if ((err = set_smem(attn_bwd_dq_kernel<T, 64>, bytes)) != cudaSuccess)
        return err;
      attn_bwd_dq_kernel<T, 64><<<grid, kBwdThreads, bytes, stream>>>(a);
    }
  }
  return cudaGetLastError();
}

template cudaError_t launch_attn_bwd_dkv<float>(const AttnBwdArgs<float>&,
                                                int, cudaStream_t);
template cudaError_t launch_attn_bwd_dkv<bf16>(const AttnBwdArgs<bf16>&, int,
                                               cudaStream_t);
template cudaError_t launch_attn_bwd_dq<float>(const AttnBwdArgs<float>&, int,
                                               cudaStream_t);
template cudaError_t launch_attn_bwd_dq<bf16>(const AttnBwdArgs<bf16>&, int,
                                              cudaStream_t);

namespace {

AttnBwdArgs<bf16> flash_args(const void* qkv, const void* dout,
                             const float* lse, const float* di, void* dqkv,
                             int S, int nh, int d, float sm_scale) {
  const bf16* in = static_cast<const bf16*>(qkv);
  bf16* out = static_cast<bf16*>(dqkv);
  const int row = 3 * nh * d;
  AttnBwdArgs<bf16> a{};
  a.q = in;
  a.k = in + nh * d;
  a.v = in + 2 * nh * d;
  a.dout = static_cast<const bf16*>(dout);
  a.lse = lse;
  a.di = di;
  a.dq_t = out;
  a.dk_t = out + nh * d;
  a.dv_t = out + 2 * nh * d;
  a.in_stride = row;
  a.dout_stride = nh * d;
  a.out_stride = row;
  a.S = S;
  a.nh = nh;
  a.d = d;
  a.sm_scale = sm_scale;
  a.out_scale_qk = 1.f;
  return a;
}

}  // namespace

// K4-dkv: qkv (B, S, 3, nh, d) bf16, the attention's input; o and dout
// (B, S, nh, d) bf16, its output and that output's cotangent; lse (B, nh, S)
// fp32 from the forward. Writes di (B, nh, S) fp32 scratch, then dk and dv
// into dqkv (B, S, 3, nh, d) bf16 (its q part is left to K4-dq).
extern "C" int dxmi_flash_attn_bwd_dkv(const void* qkv, const void* o,
                                       const void* dout, const float* lse,
                                       float* di, void* dqkv, int B, int S,
                                       int nh, int d, float sm_scale,
                                       void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const size_t rows = (size_t)B * S * nh;
  di_kernel<<<(unsigned)((rows * 8 + 255) / 256), 256, 0, s>>>(
      static_cast<const bf16*>(o), static_cast<const bf16*>(dout), di, B, S,
      nh, d);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return (int)launch_attn_bwd_dkv<bf16>(
      flash_args(qkv, dout, lse, di, dqkv, S, nh, d, sm_scale), B, s);
}

// K4-dq: the same arguments, di as K4-dkv wrote it; writes dq into dqkv.
extern "C" int dxmi_flash_attn_bwd_dq(const void* qkv, const void* dout,
                                      const float* lse, const float* di,
                                      void* dqkv, int B, int S, int nh, int d,
                                      float sm_scale, void* stream) {
  return (int)launch_attn_bwd_dq<bf16>(
      flash_args(qkv, dout, lse, di, dqkv, S, nh, d, sm_scale), B,
      (cudaStream_t)stream);
}
