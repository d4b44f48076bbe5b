// K3: GroupNorm + SiLU + 3x3 SAME convolution, channels-last.
//
// Replaces: dxmi_tpu/ops/conv_fused.py:_kernel (gn_silu_conv_fused, behind
// fused_gn_silu_conv), the Pallas TPU kernel that normalises a whole
// (Bblk, H, W, C) block in VMEM, rounds it to bf16 into a zero-padded
// scratch and runs the conv as nine shifted (M, Cin) x (Cin, Cout) MXU
// products with fp32 accumulation, plus bias.
//
// Bound on the H100: at the main path's widest call (B=100, 32x32,
// 128 -> 128) the 30 GFLOP of bf16 products take 0.031 ms at the 989
// TFLOP/s tensor-core peak and the 105 MB of fp32 input and output take
// 0.031 ms at 3.35 TB/s, so bytes and operations bound it about equally.
//
// Design: pass 1 is K1's statistics kernel (per-(sample, group) mean and
// rstd, written per channel). Pass 2 is an implicit GEMM with M = B*H*W
// output pixels, N = Cout and K = 9*Cin. A block of 8 warps owns 128
// consecutive output pixels x 128 output channels and loops over 32-channel
// input chunks. For each chunk it normalises, once, the window of input
// pixels that the 9 taps of its 128 outputs can reach (flat NHWC indices
// m0 - W - 1 .. m0 + 128 + W): GN and SiLU in fp32, rounded to bf16 (as
// conv_fused.py:57 does), into shared memory, so the normalised map is
// never stored to device memory. The chunk's weights for all 9 taps arrive
// with cp.async meanwhile. Each warp then runs, per tap, bf16 mma.sync
// m16n8k16 products with fp32 accumulators on a 64 x 32 piece; ldmatrix
// gathers the A rows from the window at the tap's shift, and a tap that
// falls outside the image reads a row of zeros (the SAME padding). The
// epilogue adds the bias and writes fp32 straight from the accumulators.
// Two blocks share an SM, so one block's loads overlap the other's
// products; no wgmma or TMA yet.
#include "common.cuh"

namespace {

constexpr int BM = 128, BN = 128, BK = 32;
constexpr int kThreads = 256;  // 8 warps: 2 along M x 4 along N, 64 x 32 each
constexpr int LDH = BK + 8;    // bf16 per window row: 80 B, ldmatrix conflict-free
constexpr int LDB = BN + 8;    // bf16 per weight row: 272 B
constexpr int kWeightBytes = 9 * BK * LDB * 2;

// shared-memory bytes for an image width W: 9 taps of weights, the window
// (BM + 2W + 2 rows) and one row of zeros
__host__ __device__ constexpr int conv_smem_bytes(int W) {
  return kWeightBytes + (BM + 2 * W + 3) * LDH * 2;
}

__global__ void __launch_bounds__(kThreads, 2)
gn_silu_conv3x3_kernel(const float* __restrict__ x,
                       const float* __restrict__ gs,
                       const float* __restrict__ gb,
                       const __nv_bfloat16* __restrict__ w,
                       const float* __restrict__ bias,
                       const float* __restrict__ mean_c,
                       const float* __restrict__ rstd_c,
                       float* __restrict__ y, int B, int H, int W, int Cin,
                       int Cout) {
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* Bs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Hs = Bs + 9 * BK * LDB;

  const int HW = H * W, M = B * HW;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 2, wn = warp & 3;
  const int win = BM + 2 * W + 2;  // window rows; row `win` holds zeros
  const int q0 = m0 - W - 1;       // flat pixel of window row 0

  for (int c = tid; c < LDH; c += kThreads)
    Hs[win * LDH + c] = __float2bfloat16(0.f);

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
  const unsigned hs_base = smem_u32(Hs), bs_base = smem_u32(Bs);
  const int a_koff = (lane >> 4) * 8;
  const int b_row = (lane & 7) + ((lane >> 3) & 1) * 8;
  const int b_col = wn * 32 + (lane >> 4) * 8;

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  for (int k0 = 0; k0 < Cin; k0 += BK) {
    __syncthreads();  // the previous chunk's products are done
    for (int idx = tid; idx < 9 * BK * (BN / 8); idx += kThreads) {
      const int row = idx / (BN / 8), n8 = (idx - row * (BN / 8)) * 8;
      const int tap = row / BK, k = row - tap * BK;
      const bool ok = n0 + n8 < Cout;
      const __nv_bfloat16* src =
          ok ? w + ((size_t)tap * Cin + k0 + k) * Cout + n0 + n8 : w;
      cp_async16(bs_base + (row * LDB + n8) * 2, src, ok ? 16 : 0);
    }
    asm volatile("cp.async.commit_group;\n" ::);

    for (int idx = tid; idx < win * (BK / 4); idx += kThreads) {
      const int s = idx >> 3, c4 = (idx & 7) * 4;
      const int q = q0 + s;
      uint2 packed = make_uint2(0u, 0u);
      if (q >= 0 && q < M) {
        const int c = k0 + c4;
        const size_t bc = (size_t)(q / HW) * Cin + c;
        const float4 t = gn_affine4(ldg4(x + (size_t)q * Cin + c),
                                    ldg4(mean_c + bc), ldg4(rstd_c + bc),
                                    ldg4(gs + c), ldg4(gb + c));
        packed.x = pack_bf16(silu(t.x), silu(t.y));
        packed.y = pack_bf16(silu(t.z), silu(t.w));
      }
      *reinterpret_cast<uint2*>(Hs + s * LDH + c4) = packed;
    }
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncthreads();

#pragma unroll 1
    for (int tap = 0; tap < 9; ++tap) {
      const int dy = tap / 3 - 1, dx = tap - (tap / 3) * 3 - 1;
      const int shift = dy * W + dx + W + 1;
      unsigned a_addr[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const bool inside = (unsigned)(py[i] + dy) < (unsigned)H &&
                            (unsigned)(px[i] + dx) < (unsigned)W;
        const int slot = inside ? r0 + i * 16 + shift : win;
        a_addr[i] = hs_base + (slot * LDH + a_koff) * 2;
      }
#pragma unroll
      for (int kk = 0; kk < BK; kk += 16) {
        unsigned a[4][4], b[4][2];
#pragma unroll
        for (int i = 0; i < 4; ++i) ldsm_x4(a[i], a_addr[i] + kk * 2);
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
          unsigned r[4];
          ldsm_x4_trans(r, bs_base + ((tap * BK + kk + b_row) * LDB + b_col +
                                      jj * 16) * 2);
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
        if (n < Cout) {
          *reinterpret_cast<float2*>(y + (size_t)m * Cout + n) =
              make_float2(acc[i][j][2 * half] + bias[n],
                          acc[i][j][2 * half + 1] + bias[n + 1]);
        }
      }
    }
  }
}

}  // namespace

// w: (3, 3, Cin, Cout) bf16; mean_c, rstd_c: (B, Cin) scratch. Needs
// Cin % 32 == 0, Cin % G == 0, Cout % 8 == 0 and W <= 512 (the window's
// shared memory).
extern "C" int dxmi_gn_silu_conv3x3(const float* x, const float* gs,
                                    const float* gb, const void* w,
                                    const float* bias, float* y, float* mean_c,
                                    float* rstd_c, int B, int H, int W,
                                    int Cin, int Cout, int G, float eps,
                                    void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err =
      launch_gn_stats(x, mean_c, rstd_c, B, H * W, Cin, G, eps, s);
  if (err != cudaSuccess) return (int)err;
  const int smem = conv_smem_bytes(W);
  err = cudaFuncSetAttribute(gn_silu_conv3x3_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return (int)err;
  const int M = B * H * W;
  dim3 grid((M + BM - 1) / BM, (Cout + BN - 1) / BN);
  gn_silu_conv3x3_kernel<<<grid, kThreads, smem, s>>>(
      x, gs, gb, reinterpret_cast<const __nv_bfloat16*>(w), bias, mean_c,
      rstd_c, y, B, H, W, Cin, Cout);
  return (int)cudaGetLastError();
}
