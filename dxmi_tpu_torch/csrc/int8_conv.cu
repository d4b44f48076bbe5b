// K8: W8A8 convolution, channels-last, int8 x int8 -> int32 on the tensor
// cores.
//
// Replaces: dxmi_tpu/ops/quant.py:68 int8_conv_static (and :53 int8_conv,
// :100 int8_matmul_static, and the int8 mode of ops/phase_up.py:45), which
// the JAX package leaves to XLA: quantise x (x * (1 / s_c) per input
// channel, or x / s per tensor; round half to even; clip to +-127), an
// int8 conv with int32 accumulation (lax.conv_general_dilated with
// preferred_element_type=int32), and the epilogue acc * dq + bias in fp32,
// cast to the output dtype. PyTorch has no CUDA int8 convolution.
//
// Bound on the H100: operations at the wide maps, bytes at the narrow ones.
// The widest ImageNet64 call (B=100, 8x8, 1536 -> 768, 3x3) is 136 G int8
// operations, 0.069 ms at 1,979 TOPS, against 25 MB of bf16 input and
// output (0.007 ms at 3.35 TB/s); the 64x64 maps (192-384 -> 192) do
// 272-543 G operations over 157-236 MB.
//
// Design: K3's implicit GEMM with s8 operands. M = B*H*W output pixels,
// N = Cout, K = kh*kw*Cin. A block of 8 warps owns 128 consecutive output
// pixels x 128 output channels and loops over 32-channel input chunks. For
// each chunk it quantises, once, the window of input pixels that the taps of
// its 128 outputs can reach (flat NHWC indices m0 - W - 1 .. m0 + 128 + W)
// into shared memory as s8, so the int8 activations never go to device
// memory, while the chunk's int8 weights for every tap arrive with
// cp.async. Each warp then runs, per tap, one mma.sync m16n8k32 s8 product
// per 16x8 piece of its 64 x 32 tile with s32 accumulators (exact); ldmatrix
// gathers the A rows from the window at the tap's shift, and a tap that falls
// outside the image reads a row of zeros (the padding). Taps are any stride-1
// kernel up to 3x3 whose output keeps the input's size: the 3x3 SAME convs
// and the four 2x2 phase kernels of the upsampling conv with their
// asymmetric pads, and 1x1. The epilogue converts each int32 sum to fp32
// (round to nearest), multiplies by dq[n], adds the fp32 bias (each rounded
// separately: no fused multiply-add) and writes fp32 or bf16. No wgmma or
// TMA yet.
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int BM = 128, BN = 128, BK = 32;
constexpr int kThreads = 256;  // 8 warps: 2 along M x 4 along N, 64 x 32 each
constexpr int LDR = BK + 16;   // bytes per shared row: 48, ldmatrix conflict-free

// shared-memory bytes: every tap's weights and the window (BM + 2W + 2 rows)
// plus one row of zeros
__host__ __device__ constexpr int smem_bytes(int taps, int W) {
  return taps * BN * LDR + (BM + 2 * W + 3) * LDR;
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
int8_conv_kernel(const T* __restrict__ x, const float* __restrict__ xs,
                 int divide, const int8_t* __restrict__ w,
                 const float* __restrict__ dq, const float* __restrict__ bias,
                 void* __restrict__ y, int y_bf16, int B, int H, int W,
                 int Cin, int Cout, int kh, int kw, int pt, int pl) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int taps = kh * kw;
  unsigned char* Bs = smem;                     // [taps][BN][LDR]
  unsigned char* Xs = smem + taps * BN * LDR;   // [win + 1][LDR]

  const int HW = H * W, M = B * HW;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 2, wn = warp & 3;
  const int win = BM + 2 * W + 2;  // window rows; row `win` holds zeros
  const int q0 = m0 - W - 1;       // flat pixel of window row 0

  for (int c = tid; c < LDR / 4; c += kThreads)
    reinterpret_cast<unsigned*>(Xs + win * LDR)[c] = 0u;

  // this lane's A row in each of the warp's four 16-row tiles
  int py[4], px[4];
  const int r0 = wm * 64 + (lane & 15);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + r0 + i * 16;
    if (m < M) {
      const int rem = m % HW;
      py[i] = rem / W;
      px[i] = rem - py[i] * W;
    } else {
      py[i] = -(1 << 20);  // never inside the image
      px[i] = 0;
    }
  }
  const unsigned xs_base = smem_u32(Xs), bs_base = smem_u32(Bs);
  const int a_koff = (lane >> 4) * 16;
  // B x4: (n 0-7, k 0-15), (n 0-7, k 16-31), (n 8-15, k 0-15), (n 8-15, k 16-31)
  const int b_row = (lane & 7) + ((lane >> 4) << 3);
  const int b_koff = ((lane >> 3) & 1) * 16;

  int acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  for (int k0 = 0; k0 < Cin; k0 += BK) {
    __syncthreads();  // the previous chunk's products are done
    for (int idx = tid; idx < taps * BN * 2; idx += kThreads) {
      const int row = idx >> 1, half = idx & 1;
      const int tap = row / BN, n = row - tap * BN;
      const bool ok = n0 + n < Cout;
      const int8_t* src =
          ok ? w + ((size_t)(n0 + n) * taps + tap) * Cin + k0 + half * 16 : w;
      cp_async16(bs_base + row * LDR + half * 16, src, ok ? 16 : 0);
    }
    cp_async_commit();

    // quantise the window: a thread takes 8 channels of one pixel
    for (int idx = tid; idx < win * (BK / 8); idx += kThreads) {
      const int s = idx >> 2, c8 = (idx & 3) * 8;
      const int q = q0 + s;
      uint2 packed = make_uint2(0u, 0u);
      if (q >= 0 && q < M) {
        float v[8];
        load8(x + (size_t)q * Cin + k0 + c8, v);
        int qi[8];
#pragma unroll
        for (int j = 0; j < 8; ++j)
          qi[j] = quant_i8(divide ? __fdiv_rn(v[j], xs[0])
                                  : __fmul_rn(v[j], xs[k0 + c8 + j]));
        packed.x = pack_s8x4(qi[0], qi[1], qi[2], qi[3]);
        packed.y = pack_s8x4(qi[4], qi[5], qi[6], qi[7]);
      }
      *reinterpret_cast<uint2*>(Xs + s * LDR + c8) = packed;
    }
    cp_async_wait<0>();
    __syncthreads();

#pragma unroll 1
    for (int tap = 0; tap < taps; ++tap) {
      const int ty = tap / kw, tx = tap - ty * kw;
      const int dy = ty - pt, dx = tx - pl;
      const int shift = dy * W + dx + W + 1;
      unsigned a[4][4], b[4][2];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const bool inside = (unsigned)(py[i] + dy) < (unsigned)H &&
                            (unsigned)(px[i] + dx) < (unsigned)W;
        const int slot = inside ? r0 + i * 16 + shift : win;
        ldsm_x4(a[i], xs_base + slot * LDR + a_koff);
      }
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        unsigned r[4];
        ldsm_x4(r, bs_base + (tap * BN + wn * 32 + jj * 16 + b_row) * LDR +
                       b_koff);
        b[2 * jj][0] = r[0];
        b[2 * jj][1] = r[1];
        b[2 * jj + 1][0] = r[2];
        b[2 * jj + 1][1] = r[3];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_s8(acc[i][j], a[i], b[j][0], b[j][1]);
    }
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
        if (n >= Cout) continue;
        float v[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          v[e] = __fmul_rn(__int2float_rn(acc[i][j][2 * half + e]), dq[n + e]);
          if (bias != nullptr) v[e] = __fadd_rn(v[e], bias[n + e]);
        }
        const size_t o = (size_t)m * Cout + n;
        if (y_bf16)
          *reinterpret_cast<unsigned*>(static_cast<bf16*>(y) + o) =
              pack_bf16(v[0], v[1]);
        else
          *reinterpret_cast<float2*>(static_cast<float*>(y) + o) =
              make_float2(v[0], v[1]);
      }
    }
  }
}

template <typename T>
cudaError_t launch(const T* x, const float* xs, int divide, const int8_t* w,
                   const float* dq, const float* bias, void* y, int y_bf16,
                   int B, int H, int W, int Cin, int Cout, int kh, int kw,
                   int pt, int pl, cudaStream_t s) {
  const int smem = smem_bytes(kh * kw, W);
  cudaError_t err = cudaFuncSetAttribute(
      int8_conv_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int M = B * H * W;
  dim3 grid((M + BM - 1) / BM, (Cout + BN - 1) / BN);
  int8_conv_kernel<T><<<grid, kThreads, smem, s>>>(
      x, xs, divide, w, dq, bias, y, y_bf16, B, H, W, Cin, Cout, kh, kw, pt,
      pl);
  return cudaGetLastError();
}

}  // namespace

// x: (B, H, W, Cin) fp32 (x_bf16 == 0) or bf16; xs: (Cin,) fp32 factors
// (divide == 0) or a (1,) fp32 divisor; w: (Cout, kh, kw, Cin) int8; dq:
// (Cout,) fp32; bias: (Cout,) fp32 or null; y: (B, H, W, Cout) fp32 or bf16
// (y_bf16). Stride 1; input pixel (oy + ty - pt, ox + tx - pl) feeds output
// (oy, ox) through tap (ty, tx), zero outside the image; the output keeps
// the input's size, so each tap reaches at most one pixel past the border.
// Needs Cin % 32 == 0, Cout % 8 == 0, kh, kw <= 3, pt, kh - 1 - pt, pl and
// kw - 1 - pl in {0, 1}, and W <= 512.
extern "C" int dxmi_int8_conv(const void* x, int x_bf16, const float* xs,
                              int divide, const void* w, const float* dq,
                              const float* bias, void* y, int y_bf16, int B,
                              int H, int W, int Cin, int Cout, int kh, int kw,
                              int pt, int pl, void* stream) {
  const int pb = kh - 1 - pt, pr = kw - 1 - pl;
  if (Cin % BK || Cout % 8 || kh < 1 || kh > 3 || kw < 1 || kw > 3 ||
      pt < 0 || pt > 1 || pb < 0 || pb > 1 || pl < 0 || pl > 1 || pr < 0 ||
      pr > 1 || W > 512)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int8_t* wi = static_cast<const int8_t*>(w);
  if (x_bf16)
    return (int)launch(static_cast<const bf16*>(x), xs, divide, wi, dq, bias,
                       y, y_bf16, B, H, W, Cin, Cout, kh, kw, pt, pl, s);
  return (int)launch(static_cast<const float*>(x), xs, divide, wi, dq, bias,
                     y, y_bf16, B, H, W, Cin, Cout, kh, kw, pt, pl, s);
}
