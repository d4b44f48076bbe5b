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
// Bound on the H100: operations at every main-path shape (B = 100). The
// widest 3x3 conv (8x8, 1536 -> 768) is 136 G int8 operations, 0.069 ms at
// 1,979 TOPS, against 40 MB of bf16 x and y and int8 weights (0.012 ms at
// 3.35 TB/s); a 64x64 conv (384 -> 192, 3x3) 543 G, 0.275 ms, against
// 472 MB (0.141 ms); a 2x2 phase conv on the 32x32 grid (384 -> 384)
// 121 G, 0.061 ms, against 157 MB (0.047 ms). The 64x64 maps carry the
// most time (chip_smoke.py's E2-int8 table by shape): 15 of the 81 convs
// of a forward, 6.25 T operations, and 40% of the first design's time.
//
// Design: an implicit GEMM on the Hopper tensor cores, wgmma
// m64n192k32.s32.s8.s8 with both operands in shared memory (s32 sums:
// exact). M runs over the positions of the zero-padded image (Hp = H + kh
// - 1 by Wp = W + kw - 1, output (oy, ox) at padded position (oy, ox)), so
// that every tap (ty, tx) reads the same window shifted by ty Wp + tx rows
// and one matrix descriptor per tap addresses it; the padded border rows
// are computed and dropped (1.06x the work at 64x64, 1.13x at 32x32, 1.56x
// at 8x8). A block of 4 warpgroups owns BM = 256 consecutive positions
// (64 each) x BN = 192 output channels (96 s32 accumulators a thread);
// at maps of at most 64 pixels, where the grid is small, 3 warpgroups
// own 192 (more blocks, no register spills). It walks over the input
// channels in chunks of 128 raw bytes a pixel (64 bf16 or 32 fp32
// channels):
//   - The chunk's window (positions m0 .. m0 + BM - 1 + (kh - 1) Wp + kw - 1)
//     arrives raw by cp.async one chunk ahead and is quantised once into an
//     int8 window at the chunk's start, so the int8 activations never go to
//     device memory. BN = 192 covers the whole Cout of the 64x64 maps, so
//     each of their pixels is quantised once; 192 divides 384, 576 and 768,
//     so no N tile runs half empty, and the smaller maps quantise their
//     (L2-resident) x 2-4 times. A separate quantise pass would write and
//     read back M * Cin int8 bytes, and the C interface has no scratch.
//   - The weights stream per (chunk, kernel row) step, the row's kw taps x
//     192 channels of the chunk, through a ring of NSW = 4 cp.async stages
//     two steps ahead, issued after the step's products: one barrier and
//     2 kw wgmma a warpgroup per step. BM = 256 halves the weight traffic
//     from L2 against 128-row tiles, which bounded the first designs.
//   - Shared memory holds the int8 window and the weights K-major without
//     swizzle: 8-row x 16-byte core matrices, one 16-byte plane per 16
//     channels (the descriptors' leading offset), rows 16 bytes apart.
// Taps are any stride-1 kernel up to 3x3 whose output keeps the input's
// size: the 3x3 SAME convs, the four 2x2 phase kernels of the upsampling
// conv with their asymmetric pads, and 1x1 (no padding, no waste). A chunk
// past Cin (Cin = 96 in 64-channel chunks) is zero-filled, in x and in the
// weights. The epilogue converts each int32 sum to fp32 (round to
// nearest), multiplies by dq[n], adds the fp32 bias (each rounded
// separately: no fused multiply-add) and writes fp32 or bf16. One block a
// SM (up to ~220 KB of shared memory; 128 registers a thread at 4
// warpgroups, which spills ~120 bytes). Where the window of a wide image
// does not fit, bf16 takes 32-channel chunks (W > 89) and steps of one
// tap (fp32 at W > 365).
//
// Stride 2 (the U-Net's Downsample: pad (0, 1), then a VALID 3x3 stride-2
// conv): the window of a chunk is built as four parity planes of the
// padded image, plane (py, px) holding pixel (2 yq + py - pt, 2 xq + px -
// pl) at grid position (yq, xq), and M runs over the positions of the
// output grid extended by (kh - 1) / 2 rows and (kw - 1) / 2 columns. Tap
// (ty, tx) of output (oy, ox) reads plane (ty % 2, tx % 2) at (oy + ty /
// 2, ox + tx / 2): a shifted window again, so one descriptor per tap
// serves, 9 taps and no wasted products; only the extended grid's border
// rows are computed and dropped (1.13x the work at a 16x16 output, 1.27x
// at 8x8, 1.56x at 4x4). The four planes of raw and int8 rows take 4x the
// window's shared memory, so bf16 runs 32-channel chunks and fp32 three
// warpgroups.
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int BN = 192;  // output channels of a block; 64 positions a warpgroup
constexpr int NSW = 4;  // weight stages in the ring, loads NSW - 2 steps ahead
constexpr int kMaxSmem = 232448;  // a block's shared memory on the H100

// cp.async.wait_group with a count known only at run time (0..8)
__device__ __forceinline__ void cp_async_wait_upto(int n) {
  switch (n) {
    case 0: cp_async_wait<0>(); break;
    case 1: cp_async_wait<1>(); break;
    case 2: cp_async_wait<2>(); break;
    case 3: cp_async_wait<3>(); break;
    case 4: cp_async_wait<4>(); break;
    case 5: cp_async_wait<5>(); break;
    case 6: cp_async_wait<6>(); break;
    case 7: cp_async_wait<7>(); break;
    default: cp_async_wait<8>(); break;
  }
}

// eight consecutive fp32 or bf16 elements of shared memory as fp32
__device__ __forceinline__ void smem8(const float* p, float (&v)[8]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}
__device__ __forceinline__ void smem8(const bf16* p, float (&v)[8]) {
  const uint4 r = *reinterpret_cast<const uint4*>(p);
  const bf16* e = reinterpret_cast<const bf16*>(&r);
#pragma unroll
  for (int j = 0; j < 8; ++j) v[j] = __bfloat162float(e[j]);
}

// d (the warpgroup's 64 x 192 s32 tile) += A (64 x 32 s8) B^T (192 x 32 s8)
__device__ __forceinline__ void wgmma_s8_m64n192k32(int (&d)[96], uint64_t da,
                                                   uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %98, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95}, %96, %97, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
        "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]),
        "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]),
        "+r"(d[54]), "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]), "+r"(d[64]), "+r"(d[65]),
        "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]),
        "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]), "+r"(d[76]), "+r"(d[77]),
        "+r"(d[78]), "+r"(d[79]), "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]),
        "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87]), "+r"(d[88]), "+r"(d[89]),
        "+r"(d[90]), "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95])
      : "l"(da), "l"(db), "r"(1));
}

// taps a weight stage holds: a kernel row, or one tap
template <bool ROW>
__host__ __device__ constexpr int stage_taps() {
  return ROW ? 3 : 1;
}

// shared-memory bytes at window rows win for S x S parity planes: the raw
// window, its int8 copy (BK / 16 planes of 16 bytes a row) and the weight
// ring
template <typename T, int BK, bool ROW, int S>
__host__ __device__ constexpr int smem_bytes(int win) {
  return S * S * ((win + 7) & ~7) * (BK * (int)sizeof(T) + BK) +
         NSW * stage_taps<ROW>() * BN * BK;
}

// S: the stride (1, or 2 through the parity planes); the output is Ho x Wo,
// M runs over the grid of Hg x Wg positions (the output grid extended by
// the taps' reach, (k - 1) / S)
template <typename T, int BK, bool ROW, int NWG, int S>
__global__ void __launch_bounds__(128 * NWG, 1)
int8_conv_kernel(const T* __restrict__ x, const float* __restrict__ xs,
                 int divide, const int8_t* __restrict__ w,
                 const float* __restrict__ dq, const float* __restrict__ bias,
                 void* __restrict__ y, int y_bf16, int B, int H, int W,
                 int Cin, int Cout, int kh, int kw, int pt, int pl, int Ho,
                 int Wo) {
  constexpr int BM = 64 * NWG, kThreads = 128 * NWG;
  constexpr int NP = S * S;                 // parity planes of the window
  constexpr int RAW = BK * (int)sizeof(T);  // raw bytes of a pixel's chunk
  constexpr int EPP = 16 / (int)sizeof(T);  // elements per 16-byte copy
  constexpr int G = BK / 8;                 // 8-channel groups of a chunk
  constexpr int KC = BK / 16;               // 16-byte planes of a chunk
  constexpr int STAGE = stage_taps<ROW>() * KC * BN * 16;
  extern __shared__ __align__(128) unsigned char smem[];
  const int taps = kh * kw;
  const int Hp = Ho + (kh - 1) / S, Wp = Wo + (kw - 1) / S;
  const int HWp = Hp * Wp, Mp = B * HWp;
  const int win = BM + (kh - 1) / S * Wp + (kw - 1) / S;  // window rows
  const int winr = (win + 7) & ~7;              // rows of an int8 plane
  unsigned char* Rs = smem;                  // [NP][winr][RAW]: raw x
  unsigned char* Xs = Rs + NP * winr * RAW;  // [NP][KC][winr][16]: int8 x
  unsigned char* Ws = Xs + NP * KC * winr * 16;  // [NSW][taps][KC][BN][16]
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int tid = threadIdx.x, wg = tid >> 7;
  const int tps = ROW ? kw : 1, spc = taps / tps;  // taps a step, steps a chunk
  const int n_chunks = (Cin + BK - 1) / BK, steps = n_chunks * spc;

  // the raw window of a chunk, plane by plane; the padding, positions past
  // the batch and channels past Cin are zeros
  auto load_x = [&](int chunk) {
#pragma unroll
    for (int q = 0; q < NP; ++q) {
      const int py = q / S, px = q % S;
      for (int idx = tid; idx < win * (RAW / 16); idx += kThreads) {
        const int s = idx / (RAW / 16), pc = idx - s * (RAW / 16);
        const int p = m0 + s, ch = chunk * BK + pc * EPP;
        const int b = p / HWp, r = p - b * HWp, yp = r / Wp;
        const int iy = S * yp + py - pt, ix = S * (r - yp * Wp) + px - pl;
        const bool ok = p < Mp && (unsigned)iy < (unsigned)H &&
                        (unsigned)ix < (unsigned)W && ch < Cin;
        cp_async16(smem_u32(Rs + (q * winr + s) * RAW + pc * 16),
                   ok ? x + (((size_t)b * H + iy) * W + ix) * Cin + ch : x,
                   ok ? 16 : 0);
      }
    }
  };
  // step i = (chunk, taps tps * (i % spc) ..): their weights into stage
  // i % NSW
  auto load_w = [&](int i) {
    if (i >= steps) return;
    const int chunk = i / spc, tap0 = (i - chunk * spc) * tps;
    unsigned char* dst = Ws + (i % NSW) * STAGE;
    for (int idx = tid; idx < tps * BN * KC; idx += kThreads) {
      const int r = idx / KC, kc = idx - r * KC;
      const int tt = r / BN, n = r - tt * BN;
      const int ch = chunk * BK + kc * 16;
      const bool ok = n0 + n < Cout && ch < Cin;
      cp_async16(smem_u32(dst + ((tt * KC + kc) * BN + n) * 16),
                 ok ? w + ((size_t)(n0 + n) * taps + tap0 + tt) * Cin + ch
                    : w,
                 ok ? 16 : 0);
    }
  };
  // the raw window into int8 (round half to even, clip): a thread takes the
  // same 8 channels of every pixel it quantises (kThreads % G == 0)
  auto quantise = [&](int chunk) {
    const int c8 = (tid % G) * 8, k0 = chunk * BK;
    float f[8];
#pragma unroll
    for (int j = 0; j < 8; ++j)
      f[j] = divide ? xs[0] : (k0 + c8 + j < Cin ? xs[k0 + c8 + j] : 0.f);
#pragma unroll
    for (int q = 0; q < NP; ++q) {
      unsigned char* dst =
          Xs + (q * KC + (c8 >> 4)) * winr * 16 + (c8 & 15);
      const unsigned char* src = Rs + q * winr * RAW;
      for (int s = tid / G; s < win; s += kThreads / G) {
        float v[8];
        smem8(reinterpret_cast<const T*>(src + s * RAW) + c8, v);
        int qi[8];
#pragma unroll
        for (int j = 0; j < 8; ++j)
          qi[j] = quant_i8(divide ? __fdiv_rn(v[j], f[j])
                                  : __fmul_rn(v[j], f[j]));
        *reinterpret_cast<uint2*>(dst + s * 16) =
            make_uint2(pack_s8x4(qi[0], qi[1], qi[2], qi[3]),
                       pack_s8x4(qi[4], qi[5], qi[6], qi[7]));
      }
    }
  };

  int acc[96];
#pragma unroll
  for (int j = 0; j < 96; ++j) acc[j] = 0;

  // cp.async groups: the prologue commits W(0)..W(NSW - 3), the first with
  // the raw window of chunk 0; step i commits W(i + NSW - 2), with the raw
  // window of the next chunk at a chunk's first step. So W(i) is group i.
  load_x(0);
  load_w(0);
  cp_async_commit();
  for (int i = 1; i < NSW - 2; ++i) {
    load_w(i);
    cp_async_commit();
  }
  const unsigned xs_base = smem_u32(Xs) + wg * 64 * 16;
  for (int c = 0; c < n_chunks; ++c) {
    wgmma_wait<0>();  // this warpgroup's products are done with the window
    // the raw window of chunk c: group 0, or the group of step (c - 1) spc,
    // which NSW - 3 or spc - 1 later groups follow
    if (c == 0)
      cp_async_wait<NSW - 3>();
    else
      cp_async_wait_upto(spc - 1);
    __syncthreads();  // the raw window is in; every warpgroup is done
    quantise(c);
#pragma unroll 1
    for (int st = 0; st < spc; ++st) {
      const int i = c * spc + st;
      cp_async_wait<NSW - 3>();  // W(i) has landed
      fence_async_smem();
      __syncthreads();  // W(i) and the int8 window visible to wgmma; the
                        // products of step i - 2 are done (wait_group 1)
      wgmma_fence();
#pragma unroll 1
      for (int tt = 0; tt < tps; ++tt) {
        const int tap = st * tps + tt, ty = tap / kw, tx = tap - ty * kw;
        // plane (ty % S, tx % S), shifted by (ty / S, tx / S)
        const unsigned a0 =
            xs_base + ((ty % S) * S + tx % S) * KC * winr * 16 +
            ((ty / S) * Wp + tx / S) * 16;
        const unsigned b0 = smem_u32(Ws + (i % NSW) * STAGE) + tt * KC * BN * 16;
#pragma unroll
        for (int ks = 0; ks < BK / 32; ++ks)
          wgmma_s8_m64n192k32(
              acc, gmma_desc(a0 + 2 * ks * winr * 16, winr * 16, 128),
              gmma_desc(b0 + 2 * ks * BN * 16, BN * 16, 128));
      }
      wgmma_commit();
      // the loads after the products: stage (i - 2) % NSW, whose products
      // are done, and (at a chunk's first step) the raw window, quantised
      load_w(i + NSW - 2);
      if (st == 0 && c + 1 < n_chunks) load_x(c + 1);
      cp_async_commit();
      wgmma_wait<1>();
    }
  }
  wgmma_wait<0>();
#pragma unroll
  for (int j = 0; j < 96; ++j) fence_operand(acc[j]);

  // acc[4j + e]: row 16 warp + g + 8 (e >> 1), column 8j + 2t + (e & 1)
  const int lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int rw = wg * 64 + ((tid & 127) >> 5) * 16 + g;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int p = m0 + rw + 8 * half;
    const int b = p / HWp, r = p - b * HWp, oy = r / Wp, ox = r - oy * Wp;
    if (p >= Mp || oy >= Ho || ox >= Wo) continue;
    const size_t o = (((size_t)b * Ho + oy) * Wo + ox) * Cout;
#pragma unroll
    for (int j = 0; j < 24; ++j) {
      const int n = n0 + 8 * j + 2 * t;
      if (n >= Cout) continue;
      float v[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        v[e] = __fmul_rn(__int2float_rn(acc[4 * j + 2 * half + e]),
                         dq[n + e]);
        if (bias != nullptr) v[e] = __fadd_rn(v[e], bias[n + e]);
      }
      if (y_bf16)
        *reinterpret_cast<unsigned*>(static_cast<bf16*>(y) + o + n) =
            pack_bf16(v[0], v[1]);
      else
        *reinterpret_cast<float2*>(static_cast<float*>(y) + o + n) =
            make_float2(v[0], v[1]);
    }
  }
}

// the problem of one call: the operands, the shape and the padding
struct ConvArgs {
  const float* xs;
  int divide;
  const int8_t* w;
  const float* dq;
  const float* bias;
  void* y;
  int y_bf16, B, H, W, Cin, Cout, kh, kw, pt, pl, Ho, Wo;
};

// launch form <T, BK, ROW, NWG, S> if its shared memory fits (false if not)
template <typename T, int BK, bool ROW, int NWG, int S>
bool try_launch(const T* x, const ConvArgs& a, cudaStream_t s,
                cudaError_t* err) {
  constexpr int BM = 64 * NWG;
  const int Wp = a.Wo + (a.kw - 1) / S;
  const int smem = smem_bytes<T, BK, ROW, S>(BM + (a.kh - 1) / S * Wp +
                                             (a.kw - 1) / S);
  if (smem > kMaxSmem) return false;
  *err = cudaFuncSetAttribute(int8_conv_kernel<T, BK, ROW, NWG, S>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              smem);
  if (*err != cudaSuccess) return true;
  const long long Mp = (long long)a.B * (a.Ho + (a.kh - 1) / S) * Wp;
  dim3 grid((unsigned)((Mp + BM - 1) / BM), (a.Cout + BN - 1) / BN);
  int8_conv_kernel<T, BK, ROW, NWG, S><<<grid, 128 * NWG, smem, s>>>(
      x, a.xs, a.divide, a.w, a.dq, a.bias, a.y, a.y_bf16, a.B, a.H, a.W,
      a.Cin, a.Cout, a.kh, a.kw, a.pt, a.pl, a.Ho, a.Wo);
  *err = cudaGetLastError();
  return true;
}

// stride 1: the first of these forms whose shared memory fits, launched: 3
// warpgroups at maps of at most 64 pixels, else 4; 128 raw bytes a pixel
// (64 bf16 or 32 fp32 channels) in kernel-row steps, then 32 bf16
// channels, then one-tap steps
cudaError_t launch(const bf16* x, const ConvArgs& a, cudaStream_t s) {
  cudaError_t err = cudaErrorInvalidValue;
  if (a.H * a.W <= 64 && try_launch<bf16, 64, true, 3, 1>(x, a, s, &err))
    return err;
  if (!try_launch<bf16, 64, true, 4, 1>(x, a, s, &err))
    try_launch<bf16, 32, true, 4, 1>(x, a, s, &err);
  return err;
}
cudaError_t launch(const float* x, const ConvArgs& a, cudaStream_t s) {
  cudaError_t err = cudaErrorInvalidValue;
  if (a.H * a.W <= 64 && try_launch<float, 32, true, 3, 1>(x, a, s, &err))
    return err;
  if (!try_launch<float, 32, true, 4, 1>(x, a, s, &err))
    try_launch<float, 32, false, 4, 1>(x, a, s, &err);
  return err;
}

// stride 2 (four parity planes): bf16 in 32-channel chunks on 4
// warpgroups, fp32 on 3; kernel-row steps, then one-tap steps
cudaError_t launch_s2(const bf16* x, const ConvArgs& a, cudaStream_t s) {
  cudaError_t err = cudaErrorInvalidValue;
  if (!try_launch<bf16, 32, true, 4, 2>(x, a, s, &err))
    try_launch<bf16, 32, false, 4, 2>(x, a, s, &err);
  return err;
}
cudaError_t launch_s2(const float* x, const ConvArgs& a, cudaStream_t s) {
  cudaError_t err = cudaErrorInvalidValue;
  if (!try_launch<float, 32, true, 3, 2>(x, a, s, &err))
    try_launch<float, 32, false, 3, 2>(x, a, s, &err);
  return err;
}

bool pads_ok(int kh, int kw, int pt, int pb, int pl, int pr) {
  return kh >= 1 && kh <= 3 && kw >= 1 && kw <= 3 && pt >= 0 && pt <= 1 &&
         pb >= 0 && pb <= 1 && pl >= 0 && pl <= 1 && pr >= 0 && pr <= 1;
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
  if (Cin % 32 || Cout % 8 || !pads_ok(kh, kw, pt, kh - 1 - pt, pl,
                                       kw - 1 - pl) || W > 512)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const ConvArgs a{xs, divide, static_cast<const int8_t*>(w), dq, bias, y,
                   y_bf16, B, H, W, Cin, Cout, kh, kw, pt, pl, H, W};
  if (x_bf16) return (int)launch(static_cast<const bf16*>(x), a, s);
  return (int)launch(static_cast<const float*>(x), a, s);
}

// The same conv at stride 2, padded by pt, pb rows and pl, pr columns (each
// 0 or 1): input pixel (2 oy + ty - pt, 2 ox + tx - pl) feeds output (oy,
// ox) through tap (ty, tx); y is (B, Ho, Wo, Cout) with Ho = (H + pt + pb -
// kh) / 2 + 1 and Wo likewise. Needs Cin % 32 == 0, Cout % 8 == 0, kh, kw
// <= 3, Ho, Wo >= 1 and W <= 128.
extern "C" int dxmi_int8_conv_s2(const void* x, int x_bf16, const float* xs,
                                 int divide, const void* w, const float* dq,
                                 const float* bias, void* y, int y_bf16,
                                 int B, int H, int W, int Cin, int Cout,
                                 int kh, int kw, int pt, int pl, int pb,
                                 int pr, void* stream) {
  const int Ho = (H + pt + pb - kh) / 2 + 1, Wo = (W + pl + pr - kw) / 2 + 1;
  if (Cin % 32 || Cout % 8 || !pads_ok(kh, kw, pt, pb, pl, pr) ||
      H + pt + pb < kh || W + pl + pr < kw || W > 128)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const ConvArgs a{xs, divide, static_cast<const int8_t*>(w), dq, bias, y,
                   y_bf16, B, H, W, Cin, Cout, kh, kw, pt, pl, Ho, Wo};
  if (x_bf16) return (int)launch_s2(static_cast<const bf16*>(x), a, s);
  return (int)launch_s2(static_cast<const float*>(x), a, s);
}
