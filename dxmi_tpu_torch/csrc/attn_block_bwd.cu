// K6: the attention block's fused backward. For
//   y = x + proj(attention(qkv(GroupNorm(x)))) on (B, S, C)
// and the cotangent ct of y it gives dx and the fp32 parameter cotangents
// dgs, dgb (GroupNorm), dW_qkv, db_qkv, dW_proj, db_proj, recomputing every
// forward intermediate from x and the parameters alone.
//
// Replaces: dxmi_tpu/ops/attn_block.py:406 _kernel_bwd (via _pallas_backward
// :558, pallas_call :566), the TPU kernel behind fused_attn_block_train's
// backward. Its arithmetic, which this kernel and its plain version
// (ops/attn_block.py attn_block_bwd_reference) follow: fp32 GroupNorm
// statistics, hp = (x - mean) rstd, h = T(hp gs + gb); qkv = T(h W_qkv) +
// T(b_qkv) rounded, q and k times T(d^-1/4); da = T(ct W_proj^T); per head
// w = softmax(q k^T) in fp32, a = T(T(w) v), dv = T(w)^T da,
// dlg = w (da v^T - rowsum(da v^T w)), dq = T(dlg) k d^-1/4,
// dk = T(dlg)^T q d^-1/4 in fp32; dh = T(dqkv) W_qkv^T in fp32;
// dW_qkv = h^T T(dqkv), db_qkv = sum of the fp32 dqkv, dW_proj = a^T ct,
// db_proj = sum ct; dgs = sum dh hp, dgb = sum dh; the GroupNorm backward
// dx = ct + rstd (dhp - mean_g(dhp) - hp mean_g(dhp hp)) with dhp = dh gs.
// The TPU accumulates the parameter cotangents across its sequential grid
// (program 0 writes, later ones add).
//
// Bound on the H100: operations. At the ImageNet64 32x32 maps (B=128,
// S=1024, C=384, nh=6, bf16) the block's GEMMs (the qkv recompute, da, dh,
// dW_qkv, dW_proj: 11 M C^2 multiply-adds, M = B S) are 0.43 TFLOP and its
// attention products (logits, a, dv, da v^T, dq, dk: 6 B nh S^2 d
// multiply-adds) 0.62 TFLOP: 1.1 ms at 989 TFLOP/s, against 0.3 GB of x,
// ct and dx. (The kernels below form the logits and da v^T again in each
// of their passes.)
//
// Design: the TPU keeps one sample's (S, C) working set and all four weight
// matrices in VMEM; a Hopper block has 227 KB, and blocks run in parallel,
// in no order. So the backward is a sequence of launches, each simple and
// each summing in a fixed order (no atomics: replays are bit for bit the
// same):
//   1. K1's GroupNorm statistics (two-pass fp32, per (sample, channel));
//   2. h = T(hp gs + gb), materialised (M, C) by K1's apply kernel;
//   3. qkv, q and k pre-scaled: K2's own qkv GEMM (launch (b), tensor cores
//      in bf16) on h;
//   4. da = T(ct W_proj^T);
//   5. per (sample, head, 64 query rows): lse of the fp32 logits, then
//      a = T(sum T(w) v) and di = rowsum(w (da v^T)) (bf16), or
//      di = da . (sum w v) (fp32), the same exact rowsum of dw * w;
//   6-7. K4's backward kernels (flash_attn_bwd.cu) with sm_scale 1: dk and
//      dv, then dq, each fp32 and rounded to T into (M, 3C) buffers, dq and
//      dk times d^-1/4;
//   8. dh = T(dqkv) W_qkv^T (fp32 out);
//   9-10. dW_qkv = h^T T(dqkv) and dW_proj = a^T ct, split over M into
//      fixed slices whose fp32 partials are summed in order;
//   11-12. db_qkv and db_proj: column sums in row chunks, then in order;
//   13. per (sample, group): the GroupNorm backward, dx and the per-sample
//      dgs, dgb; then their sum over the samples in order.
// In bf16 the products run on the tensor cores (mma.sync m16n8k16, bf16
// operands, fp32 sums), routed by the element type at compile time: 4, 8,
// 9 and 10 on K2's tensor-core GEMM (attn_block.cu) in the layouts they
// need (B read transposed for da and dh, A read transposed for the weight
// cotangents), 5 on K4's forward core (attn_stats_tc_kernel below), 6 on
// K4-dkv's tensor-core kernel. Only 7, K4-dq, stays SIMT fp32 (a later
// redesign). Every bf16 operand of the TPU body enters an fp32 sum, which
// is what mma.sync does, so only the order of the fp32 sums changes. The
// fp32 form keeps the first, simple design throughout (SIMT fp32 GEMMs,
// statistics and attention kernels): bf16 tensor cores would change its
// precision, which the JAX package holds to 5e-4.
#include <math.h>

#include <type_traits>

#include "common.cuh"

namespace {

// ---- SIMT fp32 GEMM on strided operands, optional split over K ----------
// C[m, n] = sum_k A[m sam + k sak] B[k sbk + n sbn]; block z of the grid
// sums k in [z k_chunk, (z + 1) k_chunk) into C + z M ldc.
constexpr int GM = 128, GN = 128, GK = 8, kGThreads = 256;

template <typename TA, typename TB, typename TC>
__global__ void __launch_bounds__(kGThreads)
gemm_kernel(const TA* __restrict__ A, long long sam, long long sak,
            const TB* __restrict__ Bm, long long sbk, long long sbn,
            TC* __restrict__ Cm, long long ldc, int M, int N, int K,
            int k_chunk) {
  __shared__ __align__(16) float As[GK][GM + 4];
  __shared__ __align__(16) float Bs[GK][GN + 4];
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int m0 = blockIdx.y * GM, n0 = blockIdx.x * GN;
  const int kb = blockIdx.z * k_chunk, ke = min(K, kb + k_chunk);
  Cm += (size_t)blockIdx.z * M * ldc;
  // load order: along the operand's unit stride
  const bool a_mfast = sam == 1, b_nfast = sbn == 1;
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int k0 = kb; k0 < ke; k0 += GK) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int idx = tid + e * kGThreads;
      const int m = a_mfast ? (idx & 127) : (idx >> 3);
      const int k = a_mfast ? (idx >> 7) : (idx & 7);
      const int gm = m0 + m, gk = k0 + k;
      As[k][m] = (gm < M && gk < ke)
                     ? to_f(A[(long long)gm * sam + (long long)gk * sak])
                     : 0.f;
      const int n = b_nfast ? (idx & 127) : (idx >> 3);
      const int kk = b_nfast ? (idx >> 7) : (idx & 7);
      const int gn = n0 + n, gk2 = k0 + kk;
      Bs[kk][n] = (gn < N && gk2 < ke)
                      ? to_f(Bm[(long long)gk2 * sbk + (long long)gn * sbn])
                      : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < GK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&As[kk][ty * 4]);
      const float4 a1 = *reinterpret_cast<const float4*>(&As[kk][64 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Bs[kk][tx * 4]);
      const float4 b1 = *reinterpret_cast<const float4*>(&Bs[kk][64 + tx * 4]);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = m0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + i - 4);
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int n = n0 + (j < 4 ? tx * 4 + j : 64 + tx * 4 + j - 4);
      if (n < N) store_as(Cm + (size_t)m * ldc + n, acc[i][j]);
    }
  }
}

// the length of each of the K slices that a GEMM split `splits` ways
// takes: whole multiples of unit (GK here, 32 for the tensor-core GEMM)
int slice_rows(int K, int splits, int unit) {
  return ((K + splits - 1) / splits + unit - 1) / unit * unit;
}

// the number of K slices that gemm(..., splits) runs
int n_slices(int K, int splits) {
  const int chunk = slice_rows(K, splits, GK);
  return (K + chunk - 1) / chunk;
}

template <typename TA, typename TB, typename TC>
cudaError_t gemm(const TA* A, long long sam, long long sak, const TB* Bm,
                 long long sbk, long long sbn, TC* Cm, int M, int N, int K,
                 int splits, cudaStream_t s) {
  const int chunk = slice_rows(K, splits, GK);
  splits = n_slices(K, splits);
  const dim3 grid((N + GN - 1) / GN, (M + GM - 1) / GM, splits);
  gemm_kernel<TA, TB, TC><<<grid, kGThreads, 0, s>>>(A, sam, sak, Bm, sbk,
                                                     sbn, Cm, N, M, N, K,
                                                     chunk);
  return cudaGetLastError();
}

// out[i] = sum over z < n_parts of part[z n + i], in order of z
__global__ void sum_parts_kernel(const float* __restrict__ part, int n_parts,
                                 long long n, float* __restrict__ out) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float acc = 0.f;
  for (int z = 0; z < n_parts; ++z) acc += part[z * n + i];
  out[i] = acc;
}

cudaError_t sum_parts(const float* part, int n_parts, long long n,
                      float* out, cudaStream_t s) {
  sum_parts_kernel<<<(unsigned)((n + 255) / 256), 256, 0, s>>>(part, n_parts,
                                                                n, out);
  return cudaGetLastError();
}

// part[chunk, c] = sum of in[r, c] over the chunk's rows, in order
template <typename T>
__global__ void colsum_kernel(const T* __restrict__ in, int rows, int cols,
                              int rows_per, float* __restrict__ part) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= cols) return;
  const int r0 = blockIdx.y * rows_per, r1 = min(rows, r0 + rows_per);
  float acc = 0.f;
  for (int r = r0; r < r1; ++r) acc += to_f(in[(size_t)r * cols + c]);
  part[(size_t)blockIdx.y * cols + c] = acc;
}

template <typename T>
cudaError_t colsum(const T* in, int rows, int cols, int chunks, float* part,
                   float* out, cudaStream_t s) {
  const int rows_per = (rows + chunks - 1) / chunks;
  chunks = (rows + rows_per - 1) / rows_per;
  colsum_kernel<T><<<dim3((cols + 255) / 256, chunks), 256, 0, s>>>(
      in, rows, cols, rows_per, part);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return sum_parts(part, chunks, cols, out, s);
}

// ---- 5: forward statistics and output per (sample, head, 64 rows) ------
constexpr int BT = kBwdTile, LDS = BT + 4;

template <int D>
__host__ __device__ constexpr int stats_smem_floats() {
  return 3 * BT * (D + 4) + BT * LDS;
}

// qkv: (B, S, 3C) with q and k pre-scaled; da: (B, S, C). Writes lse and di
// (B, nh, S) and a = T(T(w) v) into (B, S, C).
template <typename T, int D>
__global__ void __launch_bounds__(kBwdThreads)
attn_stats_kernel(const T* __restrict__ qkv, const T* __restrict__ da,
                  float* __restrict__ lse, float* __restrict__ di,
                  T* __restrict__ a_out, int S, int C, int nh) {
  constexpr int LD = D + 4, NI = D / 16;
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;
  float* Ks = Qs + BT * LD;
  float* Vs = Ks + BT * LD;
  float* W = Vs + BT * LD;  // [query][key]: fp32 w
  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * BT;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int d = C / nh, row3 = 3 * C;
  const T* base = qkv + (size_t)b * S * row3 + (size_t)h * d;

  tile_in<T, D>(Qs, base + (size_t)q0 * row3, row3, d);
  float m[4], l[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;  // this thread's share; its 16 lanes share m
  }
  for (int k0 = 0; k0 < S; k0 += BT) {
    __syncthreads();
    tile_in<T, D>(Ks, base + (size_t)k0 * row3 + C, row3, d);
    __syncthreads();
    float s[4][4];
    tile_dots<D>(s, Qs, Ks, ty, tx);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      float mx = fmaxf(fmaxf(s[r][0], s[r][1]), fmaxf(s[r][2], s[r][3]));
#pragma unroll
      for (int o = 8; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float mn = fmaxf(m[r], mx);
      float acc = l[r] * expf(m[r] - mn);
#pragma unroll
      for (int j = 0; j < 4; ++j) acc += expf(s[r][j] - mn);
      l[r] = acc;
      m[r] = mn;
    }
  }
  float L[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    float t = l[r];
#pragma unroll
    for (int o = 8; o > 0; o >>= 1) t += __shfl_xor_sync(0xffffffffu, t, o);
    L[r] = m[r] + logf(t);
  }

  float acc[4][NI], af[4][NI];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int i = 0; i < NI; ++i) acc[r][i] = af[r][i] = 0.f;
  for (int k0 = 0; k0 < S; k0 += BT) {
    __syncthreads();
    tile_in<T, D>(Ks, base + (size_t)k0 * row3 + C, row3, d);
    tile_in<T, D>(Vs, base + (size_t)k0 * row3 + 2 * C, row3, d);
    __syncthreads();
    float s[4][4];
    tile_dots<D>(s, Qs, Ks, ty, tx);
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        W[(4 * ty + r) * LDS + tx + 16 * j] = expf(s[r][j] - L[r]);
    __syncthreads();
#pragma unroll 4
    for (int k = 0; k < BT; ++k) {
      float w[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) w[r] = W[(4 * ty + r) * LDS + k];
#pragma unroll
      for (int i = 0; i < NI; ++i) {
        const float v = Vs[k * LD + tx + 16 * i];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          acc[r][i] = fmaf(round_t<T>(w[r]), v, acc[r][i]);
          af[r][i] = fmaf(w[r], v, af[r][i]);
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int q = q0 + 4 * ty + r;
    const size_t row = ((size_t)b * S + q) * C + (size_t)h * d;
    float t = 0.f;
#pragma unroll
    for (int i = 0; i < NI; ++i) {
      const int c = tx + 16 * i;
      if (c < d) {
        store_as(a_out + row + c, acc[r][i]);
        t = fmaf(to_f(da[row + c]), af[r][i], t);
      }
    }
#pragma unroll
    for (int o = 8; o > 0; o >>= 1) t += __shfl_xor_sync(0xffffffffu, t, o);
    if (tx == 0) {
      const size_t st = ((size_t)b * nh + h) * S + q;
      lse[st] = L[r];
      di[st] = t;
    }
  }
}

// ---- 5 in bf16: the same on the tensor cores ----------------------------
constexpr int kTcThreads = 128;

template <int D>
__host__ __device__ constexpr int stats_tc_smem_bytes() {
  return 6 * BT * (D + 8) * 2;  // q, da; two stages of K and of V (bf16)
}

// Per (sample, head, 64 query rows), 4 warps of 16 rows, on mma.sync
// m16n8k16 with fp32 accumulators (K4's forward core, flash_attn.cu): the q
// and da rows are held as A fragments; pass 1 streams the key tiles, forms
// the logits q k^T and keeps each row's running max and sum, which give
// lse; pass 2 forms the logits again, w = exp(s - lse) in fp32, a += T(w) v
// (w packed to bf16 A fragments, v by ldmatrix.trans) and dp = da v^T (v by
// ldmatrix), and di = rowsum(w dp) in fp32: the TPU body's dwt = da v^T and
// sum(dwt w) (attn_block.py:482-485). K and V tiles are double-buffered
// with cp.async across both passes; head dims below D are zero-padded.
template <int D>
__global__ void __launch_bounds__(kTcThreads)
attn_stats_tc_kernel(const bf16* __restrict__ qkv, const bf16* __restrict__ da,
                     float* __restrict__ lse, float* __restrict__ di,
                     bf16* __restrict__ a_out, int S, int C, int nh,
                     int v16) {
  constexpr int LD = D + 8, NK = D / 16, NN = D / 8;
  extern __shared__ __align__(128) unsigned char smem_tc[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_tc);
  bf16* Das = Qs + BT * LD;
  bf16* Ks = Das + BT * LD;     // [2][BT][LD]
  bf16* Vs = Ks + 2 * BT * LD;  // [2][BT][LD]
  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * BT;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int d = C / nh, row3 = 3 * C;
  const bf16* base = qkv + (size_t)b * S * row3 + (size_t)h * d;

  rows_in_bf16<D>(Qs, base + (size_t)q0 * row3, row3, d, v16);
  rows_in_bf16<D>(Das, da + ((size_t)b * S + q0) * C + (size_t)h * d, C, d,
                  v16);
  rows_in_bf16<D>(Ks, base + C, row3, d, v16);
  cp_async_commit();

  unsigned qa[NK][4], daa[NK][4];
  float acc[NN][4];
#pragma unroll
  for (int n = 0; n < NN; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  // rows g (r = 0) and g + 8 (r = 1) of the warp's 16; l and t are this
  // thread's shares, m is the quad's
  float m_r[2] = {-INFINITY, -INFINITY}, l_r[2] = {0.f, 0.f};
  float L[2] = {0.f, 0.f}, t_r[2] = {0.f, 0.f};

  const int n_tiles = S / BT;
  for (int it = 0; it < 2 * n_tiles; ++it) {
    const int st = it & 1;
    if (it + 1 < 2 * n_tiles) {  // stage st^1 was last read before the last
                                 // barrier
      const bf16* src = base + (size_t)((it + 1) % n_tiles) * BT * row3;
      rows_in_bf16<D>(Ks + (st ^ 1) * BT * LD, src + C, row3, d, v16);
      if (it + 1 >= n_tiles)
        rows_in_bf16<D>(Vs + (st ^ 1) * BT * LD, src + 2 * C, row3, d, v16);
    }
    cp_async_commit();
    cp_async_wait<1>();  // this tile's group has landed
    __syncthreads();
    if (it == 0) {
#pragma unroll
      for (int kk = 0; kk < NK; ++kk) {
        const int off = (warp * 16 + (lane & 15)) * LD + kk * 16 +
                        (lane >> 4) * 8;
        ldsm_x4(qa[kk], smem_u32(Qs + off));
        ldsm_x4(daa[kk], smem_u32(Das + off));
      }
    }

    // logits: this warp's 16 rows x 64 keys, 8 n-tiles of 8 keys
    const bf16* Kt = Ks + st * BT * LD;
    const bf16* Vt = Vs + st * BT * LD;
    const bool pass2 = it >= n_tiles;
    float s[8][4], dp[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < NK; ++kk) {
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int off = (jj * 16 + (lane & 7) + (lane >> 4) * 8) * LD +
                        kk * 16 + ((lane >> 3) & 1) * 8;
        unsigned r[4];
        ldsm_x4(r, smem_u32(Kt + off));
        mma_bf16(s[2 * jj], qa[kk], r[0], r[1]);
        mma_bf16(s[2 * jj + 1], qa[kk], r[2], r[3]);
        if (pass2) {  // dp = da v^T
          ldsm_x4(r, smem_u32(Vt + off));
          mma_bf16(dp[2 * jj], daa[kk], r[0], r[1]);
          mma_bf16(dp[2 * jj + 1], daa[kk], r[2], r[3]);
        }
      }
    }

    if (!pass2) {  // running max and sum of exp(s - max), fp32
      float mx[2] = {m_r[0], m_r[1]};
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        l_r[r] *= expf(m_r[r] - mx[r]);
        m_r[r] = mx[r];
      }
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          l_r[e >> 1] += expf(s[j][e] - m_r[e >> 1]);
    } else {
      if (it == n_tiles) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          float tot = l_r[r];
          tot += __shfl_xor_sync(0xffffffffu, tot, 1);
          tot += __shfl_xor_sync(0xffffffffu, tot, 2);
          L[r] = m_r[r] + logf(tot);
        }
      }
      // w = exp(s - lse) in fp32; di += w dp
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float w = expf(s[j][e] - L[e >> 1]);
          s[j][e] = w;
          t_r[e >> 1] = fmaf(w, dp[j][e], t_r[e >> 1]);
        }
      // a += T(w) v: w's accumulator layout is the A fragment layout
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const unsigned wa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                                pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                                pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                                pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
        for (int nn = 0; nn < NK; ++nn) {
          unsigned r[4];
          ldsm_x4_trans(r, smem_u32(Vt + (kk * 16 + (lane & 7) +
                                          ((lane >> 3) & 1) * 8) * LD +
                                    nn * 16 + (lane >> 4) * 8));
          mma_bf16(acc[2 * nn], wa, r[0], r[1]);
          mma_bf16(acc[2 * nn + 1], wa, r[2], r[3]);
        }
      }
    }
    __syncthreads();  // the next loads overwrite the stage just read
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    t_r[r] += __shfl_xor_sync(0xffffffffu, t_r[r], 1);
    t_r[r] += __shfl_xor_sync(0xffffffffu, t_r[r], 2);
    const int q = q0 + warp * 16 + g + 8 * r;
    if (t == 0) {
      const size_t sti = ((size_t)b * nh + h) * S + q;
      lse[sti] = L[r];
      di[sti] = t_r[r];
    }
    bf16* arow = a_out + ((size_t)b * S + q) * C + (size_t)h * d;
#pragma unroll
    for (int n = 0; n < NN; ++n) {
      const int c = 8 * n + 2 * t;  // d is even: c < d takes c + 1 too
      if (c < d)
        *reinterpret_cast<unsigned*>(arow + c) =
            pack_bf16(acc[n][2 * r], acc[n][2 * r + 1]);
    }
  }
}

// ---- 13: GroupNorm backward per (sample, group) -------------------------
constexpr int kGnThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kGnThreads)
gn_bwd_kernel(const T* __restrict__ x, const T* __restrict__ ct,
              const float* __restrict__ dh, const float* __restrict__ mean_c,
              const float* __restrict__ rstd_c, const float* __restrict__ gs,
              T* __restrict__ dx, float* __restrict__ dgs_part,
              float* __restrict__ dgb_part, int S, int C, int G) {
  __shared__ float red[4][kGnThreads];
  const int g = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const int cg = C / G, R = kGnThreads / cg;
  const bool active = tid < R * cg;
  const int c = g * cg + tid % cg, r0 = tid / cg;
  const size_t bc = (size_t)b * C + c;
  const float mean = active ? mean_c[bc] : 0.f;
  const float rstd = active ? rstd_c[bc] : 0.f;
  const float sc = active ? gs[c] : 0.f;
  float s_dh = 0.f, s_dhhp = 0.f, s1 = 0.f, s2 = 0.f;
  if (active) {
    for (int s = r0; s < S; s += R) {
      const size_t i = ((size_t)b * S + s) * C + c;
      const float hp = __fmul_rn(__fsub_rn(to_f(x[i]), mean), rstd);
      const float dv = dh[i];
      const float dhp = __fmul_rn(dv, sc);
      s_dh += dv;
      s_dhhp = fmaf(dv, hp, s_dhhp);
      s1 += dhp;
      s2 = fmaf(dhp, hp, s2);
    }
  }
  red[0][tid] = s_dh;
  red[1][tid] = s_dhhp;
  red[2][tid] = s1;
  red[3][tid] = s2;
  __syncthreads();
  if (tid < cg) {
    float a = 0.f, e = 0.f;
    for (int r = 0; r < R; ++r) {
      a += red[0][r * cg + tid];
      e += red[1][r * cg + tid];
    }
    dgb_part[(size_t)b * C + g * cg + tid] = a;
    dgs_part[(size_t)b * C + g * cg + tid] = e;
  }
  for (int off = kGnThreads / 2; off > 0; off >>= 1) {
    if (tid < off) {
      red[2][tid] += red[2][tid + off];
      red[3][tid] += red[3][tid + off];
    }
    __syncthreads();
  }
  const float n = (float)S * (float)cg;
  const float g1 = red[2][0] / n, g2 = red[3][0] / n;
  if (!active) return;
  for (int s = r0; s < S; s += R) {
    const size_t i = ((size_t)b * S + s) * C + c;
    const float hp = __fmul_rn(__fsub_rn(to_f(x[i]), mean), rstd);
    const float dhp = __fmul_rn(dh[i], sc);
    const float t = __fsub_rn(__fsub_rn(dhp, g1), __fmul_rn(hp, g2));
    store_as(dx + i, __fadd_rn(to_f(ct[i]), __fmul_rn(rstd, t)));
  }
}

cudaError_t stats(const float* x, float* mean_c, float* rstd_c, int B, int S,
                  int C, int G, float eps, cudaStream_t s) {
  return launch_gn_stats(x, mean_c, rstd_c, B, S, C, G, eps, s);
}
cudaError_t stats(const bf16* x, float* mean_c, float* rstd_c, int B, int S,
                  int C, int G, float eps, cudaStream_t s) {
  return launch_gn_stats_bf16(x, mean_c, rstd_c, B, S, C, G, eps, 0, s);
}

// h = T(((x - mean) rstd) gs + gb): K1's apply, fp32 arithmetic rounded
// once
cudaError_t apply(const float* x, const float* gs, const float* gb,
                  const float* mean_c, const float* rstd_c, float* h, int B,
                  int S, int C, cudaStream_t s) {
  return launch_gn_apply(x, gs, gb, mean_c, rstd_c, h, B, S, C, 0, s);
}
cudaError_t apply(const bf16* x, const float* gs, const float* gb,
                  const float* mean_c, const float* rstd_c, bf16* h, int B,
                  int S, int C, cudaStream_t s) {
  return launch_gn_apply(x, gs, gb, mean_c, rstd_c, h, B, S, C, 0, 0, s);
}

float qk_scale_of(const float*, int d) {
  return (float)(1.0 / sqrt(sqrt((double)d)));
}
float qk_scale_of(const bf16*, int d) {
  return __bfloat162float(
      __float2bfloat16_rn((float)(1.0 / sqrt(sqrt((double)d)))));
}

#define CHECK(expr)                            \
  do {                                         \
    cudaError_t e_ = (expr);                   \
    if (e_ != cudaSuccess) return (int)e_;     \
  } while (0)

template <typename T>
cudaError_t stats_launch(const T* qkv, const T* da, float* lse, float* di,
                         T* at, int B, int S, int C, int nh, cudaStream_t s) {
  const int d = C / nh;
  const dim3 grid(S / BT, nh, B);
  cudaError_t err;
  if constexpr (std::is_same<T, bf16>::value) {
    // bf16: the tensor-core pass; 16-byte copies where heads start on 16
    // bytes (C % 32 == 0 keeps every row there)
    const int v16 = d % 8 == 0;
    if (d <= 32) {
      const int bytes = stats_tc_smem_bytes<32>();
      if ((err = cudaFuncSetAttribute(
               attn_stats_tc_kernel<32>,
               cudaFuncAttributeMaxDynamicSharedMemorySize, bytes)) !=
          cudaSuccess)
        return err;
      attn_stats_tc_kernel<32><<<grid, kTcThreads, bytes, s>>>(
          qkv, da, lse, di, at, S, C, nh, v16);
    } else {
      const int bytes = stats_tc_smem_bytes<64>();
      if ((err = cudaFuncSetAttribute(
               attn_stats_tc_kernel<64>,
               cudaFuncAttributeMaxDynamicSharedMemorySize, bytes)) !=
          cudaSuccess)
        return err;
      attn_stats_tc_kernel<64><<<grid, kTcThreads, bytes, s>>>(
          qkv, da, lse, di, at, S, C, nh, v16);
    }
  } else {
    // fp32: the SIMT pass (its precision is the fp32 form's)
    if (d <= 32) {
      const int bytes = stats_smem_floats<32>() * (int)sizeof(float);
      if ((err = cudaFuncSetAttribute(
               attn_stats_kernel<T, 32>,
               cudaFuncAttributeMaxDynamicSharedMemorySize, bytes)) !=
          cudaSuccess)
        return err;
      attn_stats_kernel<T, 32><<<grid, kBwdThreads, bytes, s>>>(
          qkv, da, lse, di, at, S, C, nh);
    } else {
      const int bytes = stats_smem_floats<64>() * (int)sizeof(float);
      if ((err = cudaFuncSetAttribute(
               attn_stats_kernel<T, 64>,
               cudaFuncAttributeMaxDynamicSharedMemorySize, bytes)) !=
          cudaSuccess)
        return err;
      attn_stats_kernel<T, 64><<<grid, kBwdThreads, bytes, s>>>(
          qkv, da, lse, di, at, S, C, nh);
    }
  }
  return cudaGetLastError();
}

template <typename T>
int run(const T* x, const T* ct, const float* gs, const float* gb,
        const T* wqkv, const T* bqkv, const T* wproj, T* dx, float* dgs,
        float* dgb, float* dwqkv, float* dbqkv, float* dwproj, float* dbproj,
        float* mean_c, float* rstd_c, T* h, T* qkv, T* da, T* at, float* lse,
        float* di, float* dqkv_f, T* dqkv_t, float* dh, float* part, int B,
        int S, int C, int nh, int G, float eps, int splits, int chunks,
        cudaStream_t s) {
  constexpr bool kTc = std::is_same<T, bf16>::value;  // tensor cores
  const int d = C / nh, M = B * S;
  if (S % BT || C % 32 || C % G || C / G > 64 || C % nh || d % 4 || d > 64)
    return (int)cudaErrorInvalidValue;
  CHECK(stats(x, mean_c, rstd_c, B, S, C, G, eps, s));
  CHECK(apply(x, gs, gb, mean_c, rstd_c, h, B, S, C, s));
  CHECK(launch_qkv_gemm(h, wqkv, bqkv, qkv, M, C, qk_scale_of(x, d), s));
  // da[m, c] = sum_j ct[m, j] W_proj[c, j]
  if constexpr (kTc)
    CHECK(launch_hgemm(ct, wproj, nullptr, da, M, C, C, C, false, true, s));
  else
    CHECK(gemm(ct, C, 1, wproj, 1, C, da, M, C, C, 1, s));
  CHECK(stats_launch(qkv, da, lse, di, at, B, S, C, nh, s));

  AttnBwdArgs<T> a{};
  a.q = qkv;
  a.k = qkv + C;
  a.v = qkv + 2 * C;
  a.dout = da;
  a.lse = lse;
  a.di = di;
  a.dq_f = dqkv_f;
  a.dk_f = dqkv_f + C;
  a.dv_f = dqkv_f + 2 * C;
  a.dq_t = dqkv_t;
  a.dk_t = dqkv_t + C;
  a.dv_t = dqkv_t + 2 * C;
  a.in_stride = 3 * C;
  a.dout_stride = C;
  a.out_stride = 3 * C;
  a.S = S;
  a.nh = nh;
  a.d = d;
  a.sm_scale = 1.f;
  a.out_scale_qk = (float)(1.0 / sqrt(sqrt((double)d)));
  CHECK(launch_attn_bwd_dkv<T>(a, B, s));
  CHECK(launch_attn_bwd_dq<T>(a, B, s));

  // dh[m, c] = sum_j dqkv[m, j] W_qkv[c, j]; dW_qkv[c, j] = sum_m h[m, c]
  // dqkv[m, j] and dW_proj[c, j] = sum_m a ct, each over fixed slices of
  // the M rows whose fp32 partials are then summed in order
  int ns;
  if constexpr (kTc) {
    CHECK(launch_hgemm(dqkv_t, wqkv, dh, nullptr, M, C, 3 * C, 3 * C, false,
                       true, s));
    const int rows = slice_rows(M, splits, 32);
    ns = (M + rows - 1) / rows;
    CHECK(launch_hgemm(h, dqkv_t, part, nullptr, C, 3 * C, M, rows, true,
                       false, s));
    CHECK(sum_parts(part, ns, 3LL * C * C, dwqkv, s));
    CHECK(launch_hgemm(at, ct, part, nullptr, C, C, M, rows, true, false, s));
  } else {
    CHECK(gemm(dqkv_t, 3 * C, 1, wqkv, 1, 3 * C, dh, M, C, 3 * C, 1, s));
    ns = n_slices(M, splits);
    CHECK(gemm(h, 1, C, dqkv_t, 3 * C, 1, part, C, 3 * C, M, splits, s));
    CHECK(sum_parts(part, ns, 3LL * C * C, dwqkv, s));
    CHECK(gemm(at, 1, C, ct, C, 1, part, C, C, M, splits, s));
  }
  CHECK(sum_parts(part, ns, (long long)C * C, dwproj, s));
  CHECK(colsum(dqkv_f, M, 3 * C, chunks, part, dbqkv, s));
  CHECK(colsum(ct, M, C, chunks, part, dbproj, s));

  float* dgs_part = part;
  float* dgb_part = part + (size_t)B * C;
  gn_bwd_kernel<T><<<dim3(G, B), kGnThreads, 0, s>>>(
      x, ct, dh, mean_c, rstd_c, gs, dx, dgs_part, dgb_part, S, C, G);
  CHECK(cudaGetLastError());
  CHECK(sum_parts(dgs_part, B, C, dgs, s));
  CHECK(sum_parts(dgb_part, B, C, dgb, s));
  return 0;
}

#undef CHECK

}  // namespace

// K6. x, ct, dx: (B, S, C); w_qkv (C, 3C) with [3, nh, d] output columns,
// b_qkv (3C,), w_proj (C, C), all in x's dtype; gs, gb (C,) fp32. Outputs
// fp32: dgs, dgb (C,), dw_qkv (C, 3C), db_qkv (3C,), dw_proj (C, C),
// db_proj (C,). Scratch: mean_c, rstd_c (B, C) fp32; h, da, a (B, S, C) and
// qkv, dqkv_t (B, S, 3C) in x's dtype; lse, di (B, nh, S), dqkv_f
// (B, S, 3C), dh (B, S, C) fp32; part fp32 of at least
// max(splits * 3C * C, chunks * 3C, 2 B C) floats. splits: the slices of
// the B S rows that the weight GEMMs sum separately; chunks: the row
// chunks of the bias sums. Needs S % 64 == 0, C % 32 == 0, at most 64
// channels per group and d = C / nh with d % 4 == 0, d <= 64.
extern "C" int dxmi_attn_block_bwd(
    const float* x, const float* ct, const float* gs, const float* gb,
    const float* w_qkv, const float* b_qkv, const float* w_proj, float* dx,
    float* dgs, float* dgb, float* dw_qkv, float* db_qkv, float* dw_proj,
    float* db_proj, float* mean_c, float* rstd_c, float* h, float* qkv,
    float* da, float* a, float* lse, float* di, float* dqkv_f,
    float* dqkv_t, float* dh, float* part, int B, int S, int C, int nh,
    int G, float eps, int splits, int chunks, void* stream) {
  return run<float>(x, ct, gs, gb, w_qkv, b_qkv, w_proj, dx, dgs, dgb, dw_qkv,
                    db_qkv, dw_proj, db_proj, mean_c, rstd_c, h, qkv, da, a,
                    lse, di, dqkv_f, dqkv_t, dh, part, B, S, C, nh, G, eps,
                    splits, chunks, (cudaStream_t)stream);
}

// The same with bf16 x, ct, dx, weights, biases and T-typed scratch.
extern "C" int dxmi_attn_block_bwd_bf16(
    const void* x, const void* ct, const float* gs, const float* gb,
    const void* w_qkv, const void* b_qkv, const void* w_proj, void* dx,
    float* dgs, float* dgb, float* dw_qkv, float* db_qkv, float* dw_proj,
    float* db_proj, float* mean_c, float* rstd_c, void* h, void* qkv,
    void* da, void* a, float* lse, float* di, float* dqkv_f, void* dqkv_t,
    float* dh, float* part, int B, int S, int C, int nh, int G, float eps,
    int splits, int chunks, void* stream) {
  return run<bf16>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(ct), gs, gb,
      static_cast<const bf16*>(w_qkv), static_cast<const bf16*>(b_qkv),
      static_cast<const bf16*>(w_proj), static_cast<bf16*>(dx), dgs, dgb,
      dw_qkv, db_qkv, dw_proj, db_proj, mean_c, rstd_c, static_cast<bf16*>(h),
      static_cast<bf16*>(qkv), static_cast<bf16*>(da), static_cast<bf16*>(a),
      lse, di, dqkv_f, static_cast<bf16*>(dqkv_t), dh, part, B, S, C, nh, G,
      eps, splits, chunks, (cudaStream_t)stream);
}
