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
// 0.81 GB of q, k, v, o, do and dq, dk, dv (0.24 ms at 3.35 TB/s).
//
// Design (a first, simple form: fp32 SIMT arithmetic, no tensor cores):
//   di: one thread per (sample, position, head) row.
//   dkv: a block of 256 threads owns 64 keys of one (sample, head) and
//     keeps its K and V tiles and its dk, dv accumulators on chip; it walks
//     over the query rows in tiles of 64 (q, do, lse and di into shared
//     memory), forms the 64 x 64 tiles of s = k q^T and dp = v do^T, p and
//     ds in fp32 and, rounded to the element type, adds p^T do and ds^T q.
//   dq: a block owns 64 query rows and walks over the keys in tiles of 64
//     the same way, adding ds k.
// Every sum is owned by one thread and taken in a fixed order: there are no
// atomics, so replays reproduce themselves bit for bit. Each thread holds 4
// rows x 4 columns of a 64 x 64 tile (rows 4ty.., columns tx + 16j) and 4
// rows x d/16 columns of its accumulators. K6 runs the same kernels with
// sm_scale 1 on q and k pre-scaled by d^-1/4, fp32 outputs beside the
// rounded ones, and dq, dk times d^-1/4.
#include <math.h>

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
// (B, S, nh, d) contiguous)
__global__ void di_kernel(const bf16* __restrict__ o,
                          const bf16* __restrict__ dout, float* __restrict__ di,
                          int B, int S, int nh, int d) {
  const size_t row = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= (size_t)B * S * nh) return;
  const int h = (int)(row % nh);
  const size_t bs = row / nh;
  const int s = (int)(bs % S), b = (int)(bs / S);
  const bf16* op = o + row * d;
  const bf16* dp = dout + row * d;
  float acc = 0.f;
  for (int c = 0; c < d; ++c)
    acc = fmaf(__bfloat162float(op[c]), __bfloat162float(dp[c]), acc);
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
  const dim3 grid(a.S / BT, a.nh, B);
  cudaError_t err;
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
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_attn_bwd_dq(const AttnBwdArgs<T>& a, int B,
                               cudaStream_t stream) {
  if (!bwd_shape_ok(a.S, a.d, a.in_stride, a.dout_stride, a.out_stride))
    return cudaErrorInvalidValue;
  const dim3 grid(a.S / BT, a.nh, B);
  cudaError_t err;
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
  di_kernel<<<(unsigned)((rows + 255) / 256), 256, 0, s>>>(
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
