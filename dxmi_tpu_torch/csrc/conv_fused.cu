// K3: GroupNorm + SiLU + 3x3 SAME convolution, channels-last.
//
// Replaces: dxmi_tpu/ops/conv_fused.py:_kernel (gn_silu_conv_fused, behind
// fused_gn_silu_conv), the Pallas TPU kernel that normalises a whole
// (Bblk, H, W, C) block in VMEM, rounds it to bf16 into a zero-padded
// scratch and runs the conv as nine shifted (M, Cin) x (Cin, Cout) MXU
// products with fp32 accumulation, plus bias.
//
// Bound on the H100: operations. At the main path's widest call (B = 100,
// 32x32, 128 -> 128) the 30 GFLOP of bf16 products take 0.031 ms at the
// 989 TFLOP/s tensor-core peak and the 105 MB of fp32 input and output
// 0.031 ms at 3.35 TB/s; GN and SiLU add ~1 fp32 exp and division an input
// element, which the SIMT pipes must run beside the products.
//
// Design: pass 1 is K1's statistics kernel (per-(sample, group) mean and
// rstd, written per channel). Pass 2 is an implicit GEMM on the Hopper
// tensor cores, bf16 wgmma m64n128k16 with fp32 sums, both operands in
// shared memory:
//   - M runs over the positions of the zero-padded image (Hp = H + 2 by
//     Wp = W + 2; output (oy, ox) at padded position (oy, ox)), so tap
//     (dy, dx) reads the same window shifted by dy Wp + dx rows and one
//     matrix descriptor a tap addresses it. The window is K-major without
//     swizzle (8-row x 16-byte core matrices, one 16-byte plane per 8
//     channels, the descriptors' leading offset), so a shift by any row
//     count is a valid descriptor. The padded border rows are computed and
//     dropped (1.13x the products at 32x32, 1.27x at 16x16).
//   - A block has four warpgroups (64 x 128 sums each, 64 registers of
//     the 128 a thread may hold; a fifth warp would cap a sub-partition's
//     warps at 96 registers and spill): BM = 256 positions by
//     BN = 128 channels where Cout <= 128, BM = 128 by BN = 256 (two
//     warpgroups a 128-channel half) above. So a block covers all of
//     Cout on the main path, and each window pixel is normalised once a
//     launch (twice where the halo of two blocks overlaps).
//   - The input channels run in chunks of BK (64; 32 or 16 where a wide
//     image's window would not fit). The window of chunk c + 1 (GN + SiLU
//     of the raw fp32 x in the plain version's order with the statistics
//     of pass 1, rounded once to bf16; zeros outside the image and past
//     Cin) is filled by the block's threads into the second of two window
//     buffers while chunk c's products run: each tap step issues its wgmma
//     group, copies one 8-channel item of x by cp.async into the thread's
//     32-byte slot in shared memory (not registers, which the 64
//     accumulators and the chunk's GroupNorm scale and bias hold),
//     normalises the item copied a step before and waits for the previous
//     group. The normalised map never goes to device memory.
//   - Thread 0 streams the bf16 weights by TMA, one (tap, chunk) stage of
//     BK rows x BN columns a step (a 3-d tensor map over (Cout, Cin, 9):
//     rows past Cin arrive as zeros), 128-byte swizzled, through a ring of
//     NS stages with full and empty mbarriers, NS - 2 steps ahead, so that
//     it waits only for a stage that every warpgroup freed a step ago. The
//     weight panel streams from L2 with every tile; BM = 256 halves that
//     traffic against 128-position tiles.
//   - Epilogue: the sums go through a shared-memory staging tile (rows
//     BN + 8 floats apart, conflict-free) and whole output rows leave by
//     16-byte stores, border positions skipped, the bias added there.
//   - Where a launch has few tiles for the SMs (the 4x4 and 8x8 maps) the
//     chunks split into slices (grid.z) by a cost model of waves x steps
//     (conv_plan), each slice written as an fp32 partial; a second launch
//     sums the slices in order and adds the bias. No atomics: each output
//     is one fixed order of sums, so a replay is bit-equal.
#include <stdint.h>

#include <algorithm>

#include "tma.cuh"

namespace {

constexpr int kMaxSmem = 232448;   // a block's shared memory on the H100
constexpr int kMaxItems = 8;       // window items a thread fills a chunk
constexpr int kConsumers = 4;      // warpgroups
constexpr int NT = 128 * kConsumers;

// d (the warpgroup's 64 x 128 fp32 sums) += A (64 x 16 bf16, K-major, from
// the window) B (16 x 128 bf16, N-major through the transpose flag)
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t da,
                                                 uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db));
}
// GN + SiLU of one element in the plain version's fp32 order:
// u = ((x - mean) rstd) scale + bias, then u / (1 + exp(-u))
__device__ __forceinline__ float gn_silu1(float v, float m, float r, float s,
                                          float b) {
  const float u = __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(v, m), r), s), b);
  return __fdividef(u, 1.f + __expf(-u));
}

__device__ __forceinline__ void st_shared16(unsigned addr, uint4 v) {
  asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(addr),
               "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w)
               : "memory");
}
__device__ __forceinline__ float4 ld_shared4(unsigned addr) {
  float4 v;
  asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(addr)
               : "memory");
  return v;
}

// n / d for 0 <= n < 2^31 by a multiply-high and a shift (division by an
// invariant integer), with the magic numbers made on the host
struct FastDiv {
  unsigned mul;
  int shift;
  FastDiv() = default;
  explicit FastDiv(int d) {
    shift = 0;
    while ((1u << shift) < (unsigned)d) ++shift;
    mul = (unsigned)((((1ull << 32) * ((1ull << shift) - (unsigned)d)) /
                      (unsigned)d) + 1);
  }
  __device__ __forceinline__ int div(int n) const {
    return (int)((__umulhi((unsigned)n, mul) + (unsigned)n) >> shift);
  }
};

// The block's shape: WM warpgroups along M by 4 / WM along N, 64 x 128
// sums each; BK channels a chunk.
template <int BK, int WM>
struct Cfg {
  static constexpr int WN = kConsumers / WM, BM = 64 * WM, BN = 128 * WN;
  static constexpr int PL = BK / 8;         // 16-byte planes of a row
  static constexpr int PAD = 64 / BK;       // 16-byte units after a plane:
                                            // a quarter warp's stores fall
                                            // on 8 bank groups
  static constexpr int BOX = BK * 128;      // 64 weight columns x BK rows
  static constexpr int STAGE = 2 * WN * BOX;
  // weight stages in the ring; a step loads the stage NS - 2 steps ahead
  static constexpr int NS = STAGE <= 16384 ? 6 : 4;
  static constexpr int RAW = 2 * NT * 32;   // two raw x items a thread
  static constexpr int LDS = BN + 8;        // the epilogue's staging rows
  __host__ __device__ static int win(int W) { return BM + 2 * (W + 2) + 2; }
  // bytes between planes (the A descriptors' leading offset)
  __host__ __device__ static int plane(int W) {
    return (((win(W) + 7) & ~7) + PAD) * 16;
  }
  __host__ __device__ static int smem(int W) {
    const int body = NS * STAGE + 2 * PL * plane(W) + RAW;
    const int staging = BM * LDS * 4;
    return 1024 + 128 + (body > staging ? body : staging);
  }
};

struct ConvArgs {
  const float* x;
  const float* gs;
  const float* gb;
  const float* bias;
  const float* mean_c;
  const float* rstd_c;
  float* out;  // y, or the slices' partials (slices > 1)
  int B, H, W, Cin, Cout, cpi, slices;  // cpi: chunks a slice
  long long slice_elems;                // B H W Cout
  FastDiv hwp, wp;                      // (H + 2) (W + 2), W + 2
};

// Block (m tile, n tile, slice z) runs the chunks z cpi .. (z + 1) cpi - 1.
template <int BK, int WM>
__global__ void __launch_bounds__(NT, 1)
conv3x3_kernel(const __grid_constant__ CUtensorMap tw, const ConvArgs a) {
  using C = Cfg<BK, WM>;
  constexpr int NS = C::NS;
  extern __shared__ __align__(1024) unsigned char smem[];
  const unsigned raw = smem_u32(smem);
  const unsigned bars = raw;  // full[NS], empty[NS]
  const unsigned ring = (raw + 128 + 1023) & ~1023u;
  const int Wp = a.W + 2, HWp = (a.H + 2) * Wp, Mp = a.B * HWp;
  const int win = C::win(a.W), PS = C::plane(a.W);
  const unsigned windows = ring + NS * C::STAGE;
  const unsigned xslots = windows + 2 * C::PL * PS;
  const int m0 = blockIdx.x * C::BM, n0 = blockIdx.y * C::BN;
  const int c0 = blockIdx.z * a.cpi, steps = a.cpi * 9;
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (NS + s); };
  // thread 0 loads the weights of step k = (chunk c0 + k / 9, tap k % 9)
  // into stage k % NS once every warpgroup is done with step k - NS; boxes
  // wholly past Cout are skipped (their columns are never stored)
  const int nbox = min(2 * C::WN, (a.Cout - n0 + 63) / 64);
  auto load_w = [&](int k) {
    if (k >= steps) return;
    const int s = k % NS;
    if (k >= NS) mbar_wait(empty(s), (k / NS - 1) & 1);
    mbar_expect_tx(full(s), nbox * C::BOX);
    for (int bx = 0; bx < nbox; ++bx)
      tma_load_3d(ring + s * C::STAGE + bx * C::BOX, &tw, full(s),
                  n0 + 64 * bx, (c0 + k / 9) * BK, k % 9);
  };

  if (threadIdx.x == 0) {
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                     reinterpret_cast<uint64_t>(&tw))
                 : "memory");
    for (int s = 0; s < NS; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int k = 0; k < NS - 2; ++k) load_w(k);
  }
  __syncthreads();

  // warpgroup wg: rows 64 wm .., columns 128 wn .. of the tile
  const int t = threadIdx.x, wg = t >> 7;
  const int wm = wg / C::WN, wn = wg % C::WN;
  // the window fill: thread t takes plane t % PL of rows t / PL + j NT / PL
  const int fp = t % C::PL;
  const int n_items = (win * C::PL + NT - 1) / NT;
  auto window = [&](int buf) { return windows + buf * C::PL * PS; };
  // item j of chunk's window: its 8 raw channels (two 16-byte copies) and
  // the (sample, channel) index of its statistics, or -1 for a row of
  // zeros (outside the image, past the batch or past Cin)
  auto source = [&](int chunk, int j, const float*& src) {
    const int s = t / C::PL + j * (NT / C::PL), ch = chunk * BK + 8 * fp;
    const int q = m0 + s;
    src = a.x;
    if (s >= win || ch >= a.Cin || q >= Mp) return -1;
    const int b = a.hwp.div(q), r = q - b * HWp, yp = a.wp.div(r);
    const int iy = yp - 1, ix = r - yp * Wp - 1;
    if ((unsigned)iy >= (unsigned)a.H || (unsigned)ix >= (unsigned)a.W)
      return -1;
    src = a.x + (((size_t)b * a.H + iy) * a.W + ix) * a.Cin + ch;
    return b * a.Cin + ch;
  };
  // the GroupNorm scale and bias of this thread's 8 channels of a chunk
  struct Affine {
    float4 s0, s1, b0, b1;
  };
  auto affine = [&](int chunk) {
    const int ch = min(chunk * BK + 8 * fp, a.Cin - 8);
    return Affine{ldg4(a.gs + ch), ldg4(a.gs + ch + 4), ldg4(a.gb + ch),
                  ldg4(a.gb + ch + 4)};
  };
  // item j normalised and rounded into window buffer buf, from its raw
  // channels lo, hi
  auto put = [&](int j, int bc, float4 lo, float4 hi, const Affine& f,
                 unsigned buf) {
    const int s = t / C::PL + j * (NT / C::PL);
    if (s >= win) return;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (bc >= 0) {
      const float4 m0v = ldg4(a.mean_c + bc), m1v = ldg4(a.mean_c + bc + 4);
      const float4 r0v = ldg4(a.rstd_c + bc), r1v = ldg4(a.rstd_c + bc + 4);
      v.x = pack_bf16(gn_silu1(lo.x, m0v.x, r0v.x, f.s0.x, f.b0.x),
                      gn_silu1(lo.y, m0v.y, r0v.y, f.s0.y, f.b0.y));
      v.y = pack_bf16(gn_silu1(lo.z, m0v.z, r0v.z, f.s0.z, f.b0.z),
                      gn_silu1(lo.w, m0v.w, r0v.w, f.s0.w, f.b0.w));
      v.z = pack_bf16(gn_silu1(hi.x, m1v.x, r1v.x, f.s1.x, f.b1.x),
                      gn_silu1(hi.y, m1v.y, r1v.y, f.s1.y, f.b1.y));
      v.w = pack_bf16(gn_silu1(hi.z, m1v.z, r1v.z, f.s1.z, f.b1.z),
                      gn_silu1(hi.w, m1v.w, r1v.w, f.s1.w, f.b1.w));
    }
    st_shared16(buf + fp * PS + s * 16, v);
  };

  // the first chunk's window, all of a thread's items in flight at once
  {
    const Affine f0 = affine(c0);
    float4 lo[kMaxItems], hi[kMaxItems];
    int bc[kMaxItems];
#pragma unroll
    for (int j = 0; j < kMaxItems; ++j) {
      if (j >= n_items) continue;
      const float* src;
      bc[j] = source(c0, j, src);
      lo[j] = hi[j] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (bc[j] >= 0) {
        lo[j] = ldg4(src);
        hi[j] = ldg4(src + 4);
      }
    }
#pragma unroll
    for (int j = 0; j < kMaxItems; ++j)
      if (j < n_items) put(j, bc[j], lo[j], hi[j], f0, window(0));
  }
  fence_async_smem();
  __syncthreads();

  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  const unsigned a_rows = wm * 64 * 16;  // this warpgroup's first row
  const unsigned slot0 = xslots + t * 32, slot1 = slot0 + NT * 32;
  for (int cc = 0; cc < a.cpi; ++cc) {
    const int buf = cc & 1;
    const bool more = cc + 1 < a.cpi;
    const unsigned wa = window(buf) + a_rows, wnext = window(buf ^ 1);
    const Affine f1 = affine(c0 + cc + 1);
    int bcs[2];
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int k = cc * 9 + tap, s = k % NS;
      mbar_wait(full(s), (k / NS) & 1);
      const unsigned a0 = wa + ((tap / 3) * Wp + tap % 3) * 16;
      const unsigned b0 = ring + s * C::STAGE + wn * 2 * C::BOX;
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < BK / 16; ++ks)
        wgmma_m64n128k16(acc, gmma_desc(a0 + 2 * ks * PS, PS, 128),
                         gmma_desc(b0 + ks * 16 * 128, C::BOX, 1024, 1));
      wgmma_commit();
      // under this tap's products, the next window: item tap's raw x
      // copied into this thread's slot tap % 2 (a cp.async group a tap),
      // item tap - 1 (copied a tap ago) normalised into the window
      if (more) {
        if (tap < kMaxItems && tap < n_items) {
          const float* src;
          bcs[tap & 1] = source(c0 + cc + 1, tap, src);
          const int n = bcs[tap & 1] >= 0 ? 16 : 0;
          const unsigned slot = tap & 1 ? slot1 : slot0;
          cp_async16(slot, src, n);
          cp_async16(slot + 16, src + 4, n);
        }
        cp_async_commit();
        if (tap >= 1 && tap - 1 < n_items) {
          cp_async_wait<1>();
          const unsigned slot = (tap - 1) & 1 ? slot1 : slot0;
          put(tap - 1, bcs[(tap - 1) & 1], ld_shared4(slot),
              ld_shared4(slot + 16), f1, wnext);
        }
      }
      wgmma_wait<1>();  // the previous step's group is done: free its stage
      if (k > 0 && (t & 127) == 0) mbar_arrive(empty((k - 1) % NS));
      if (t == 0) load_w(k + NS - 2);
      // every warpgroup is done with the last chunk's window, which the
      // fill overwrites from tap 1 on
      if (tap == 0 && more) __syncthreads();
    }
    if (more) {
      fence_async_smem();
      __syncthreads();  // the next window is in, for every warpgroup
    }
  }
  wgmma_wait<0>();
#pragma unroll
  for (int i = 0; i < 64; ++i) fence_operand(acc[i]);
  __syncthreads();  // every product is done: the staging tile reuses it all

  // acc[4j + e]: row 16 warp + g + 8 (e >> 1), column 8j + 2q + (e & 1)
  float* stg = reinterpret_cast<float*>(smem + (ring - raw));
  {
    const int lane = t & 31, g = lane >> 2, q = lane & 3;
    const int row = wm * 64 + ((t & 127) >> 5) * 16 + g;
    float* p0 = stg + row * C::LDS + wn * 128 + 2 * q;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      *reinterpret_cast<float2*>(p0 + 8 * j) =
          make_float2(acc[4 * j], acc[4 * j + 1]);
      *reinterpret_cast<float2*>(p0 + 8 * C::LDS + 8 * j) =
          make_float2(acc[4 * j + 2], acc[4 * j + 3]);
    }
  }
  __syncthreads();
  // whole rows out, 16 bytes a thread, border positions skipped, the bias
  // added (one slice) or the slice's partial
  constexpr int C4 = C::BN / 4;
  const int c4 = t % C4, n = n0 + 4 * c4;
  if (n >= a.Cout) return;
  float4 bv = make_float4(0.f, 0.f, 0.f, 0.f);
  if (a.slices == 1) bv = ldg4(a.bias + n);
  float* out = a.out + (size_t)blockIdx.z * a.slice_elems;
  for (int r = t / C4; r < C::BM; r += NT / C4) {
    const int p = m0 + r;
    if (p >= Mp) break;
    const int b = a.hwp.div(p), rr = p - b * HWp, oy = a.wp.div(rr);
    const int ox = rr - oy * Wp;
    if (oy >= a.H || ox >= a.W) continue;
    const float4 v =
        *reinterpret_cast<const float4*>(stg + r * C::LDS + 4 * c4);
    *reinterpret_cast<float4*>(
        out + (((size_t)b * a.H + oy) * a.W + ox) * a.Cout + n) =
        make_float4(__fadd_rn(v.x, bv.x), __fadd_rn(v.y, bv.y),
                    __fadd_rn(v.z, bv.z), __fadd_rn(v.w, bv.w));
  }
}

// y = (the slices' partials summed in slice order) + bias, 16 bytes a
// thread
__global__ void __launch_bounds__(256)
conv3x3_reduce_kernel(const float4* __restrict__ part,
                      const float4* __restrict__ bias, float4* __restrict__ y,
                      long long n4, int cout4, int slices) {
  for (long long i = blockIdx.x * 256LL + threadIdx.x; i < n4;
       i += (long long)gridDim.x * 256) {
    float4 v = part[i];
    for (int z = 1; z < slices; ++z) {
      const float4 p = part[z * n4 + i];
      v = make_float4(__fadd_rn(v.x, p.x), __fadd_rn(v.y, p.y),
                      __fadd_rn(v.z, p.z), __fadd_rn(v.w, p.w));
    }
    const float4 b = __ldg(bias + i % cout4);
    y[i] = make_float4(__fadd_rn(v.x, b.x), __fadd_rn(v.y, b.y),
                       __fadd_rn(v.z, b.z), __fadd_rn(v.w, b.w));
  }
}

struct ConvPlan {
  int bk, wm, slices, m_tiles, n_tiles, n_chunks;
};

template <int BK, int WM>
int smem_of(int W) {
  return Cfg<BK, WM>::smem(W);
}
int smem_of(int bk, int wm, int W) {
  if (wm == 4)
    return bk == 64 ? smem_of<64, 4>(W) : bk == 32 ? smem_of<32, 4>(W)
                                                   : smem_of<16, 4>(W);
  return bk == 64 ? smem_of<64, 2>(W) : bk == 32 ? smem_of<32, 2>(W)
                                                 : smem_of<16, 2>(W);
}

// A block's fixed cost beyond its steps (the first window's fill, the
// epilogue) and the sum of split slices, in tap steps: the cost model of
// the slices
constexpr int kTileSteps = 18, kReduceSteps = 3;

// The block shape (BM = 256 by 128 channels where Cout <= 128, else 128 by
// 256), the chunk (the widest of 64, 32, 16 channels whose window a thread
// fills in at most kMaxItems items and whose buffers fit), the slices of
// the chunks (a count that divides them: the one with the fewest waves of
// blocks over the SMs x (steps a block + kTileSteps), plus kReduceSteps
// when it splits; the fewer on a tie).
bool conv_plan(int B, int H, int W, int Cin, int Cout, int sms,
               ConvPlan* p) {
  if (B < 1 || H < 1 || W < 1 || W > 512 || Cin < 32 || Cin % 32 ||
      Cout < 8 || Cout % 8)
    return false;
  const int wm = Cout > 128 ? 2 : 4, bm = 64 * wm, bn = 128 * (4 / wm);
  const int bks[3] = {64, 32, 16};
  for (int bk : bks) {
    const int win = bm + 2 * (W + 2) + 2;
    if (win * bk > kMaxItems * NT * 8 || smem_of(bk, wm, W) > kMaxSmem)
      continue;
    const long long mp = (long long)B * (H + 2) * (W + 2);
    p->bk = bk;
    p->wm = wm;
    p->m_tiles = (int)((mp + bm - 1) / bm);
    p->n_tiles = (Cout + bn - 1) / bn;
    p->n_chunks = (Cin + bk - 1) / bk;
    const long long tiles = (long long)p->m_tiles * p->n_tiles;
    long long best = -1;
    sms = std::max(sms, 1);
    for (int sl = 1; sl <= p->n_chunks; ++sl) {
      if (p->n_chunks % sl) continue;
      const long long rounds = (tiles * sl + sms - 1) / sms;
      const long long cost = rounds * (p->n_chunks / sl * 9 + kTileSteps) +
                             (sl > 1 ? kReduceSteps : 0);
      if (best < 0 || cost < best) {
        best = cost;
        p->slices = sl;
      }
    }
    return true;
  }
  return false;
}

int sm_count() {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess)
    return 0;
  return sms;
}

// the weights (9, Cin, Cout) bf16 as a 3-d tensor map (Cout fastest) with
// boxes of 64 columns x bk rows x one tap, 128-byte swizzle; rows past Cin
// and columns past Cout read zeros
bool encode_weights(CUtensorMap* map, const void* w, int Cin, int Cout,
                    int bk) {
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)Cout, (cuuint64_t)Cin, 9};
  const cuuint64_t strides[2] = {(cuuint64_t)Cout * 2,
                                 (cuuint64_t)Cin * Cout * 2};
  const cuuint32_t box[3] = {64, (cuuint32_t)bk, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(w),
            dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int BK, int WM>
cudaError_t launch_conv(const CUtensorMap& tw, const ConvArgs& a,
                        const ConvPlan& p, cudaStream_t s) {
  using C = Cfg<BK, WM>;
  const int smem = C::smem(a.W);
  const cudaError_t err = cudaFuncSetAttribute(
      conv3x3_kernel<BK, WM>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  conv3x3_kernel<BK, WM>
      <<<dim3(p.m_tiles, p.n_tiles, a.slices), NT, smem, s>>>(tw, a);
  return cudaGetLastError();
}

cudaError_t launch_conv(const CUtensorMap& tw, const ConvArgs& a,
                        const ConvPlan& p, cudaStream_t s) {
  if (p.wm == 4)
    return p.bk == 64   ? launch_conv<64, 4>(tw, a, p, s)
           : p.bk == 32 ? launch_conv<32, 4>(tw, a, p, s)
                        : launch_conv<16, 4>(tw, a, p, s);
  return p.bk == 64   ? launch_conv<64, 2>(tw, a, p, s)
         : p.bk == 32 ? launch_conv<32, 2>(tw, a, p, s)
                      : launch_conv<16, 2>(tw, a, p, s);
}

}  // namespace

// K3's plan for a shape: out = {chunk channels, BM, slices}.
extern "C" int dxmi_conv_plan(int B, int H, int W, int Cin, int Cout,
                              int* out) {
  ConvPlan p;
  if (!conv_plan(B, H, W, Cin, Cout, sm_count(), &p))
    return (int)cudaErrorInvalidValue;
  out[0] = p.bk;
  out[1] = 64 * p.wm;
  out[2] = p.slices;
  return 0;
}

// w: (3, 3, Cin, Cout) bf16; mean_c, rstd_c: (B, Cin) scratch; part:
// (slices, B, H, W, Cout) fp32 scratch when slices > 1 (else unused).
// slices: the plan's (dxmi_conv_plan; any count that divides the plan's
// chunks runs). Needs Cin % 32 == 0, Cin % G == 0, Cout % 8 == 0,
// W <= 512 and 16-byte aligned tensors.
extern "C" int dxmi_gn_silu_conv3x3(const float* x, const float* gs,
                                    const float* gb, const void* w,
                                    const float* bias, float* y, float* mean_c,
                                    float* rstd_c, float* part, int B, int H,
                                    int W, int Cin, int Cout, int G, float eps,
                                    int slices, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int sms = sm_count();
  ConvPlan p;
  if (!conv_plan(B, H, W, Cin, Cout, sms, &p) || slices < 1 ||
      p.n_chunks % slices || (slices > 1 && part == nullptr))
    return (int)cudaErrorInvalidValue;
  CUtensorMap tw;
  if (!encode_weights(&tw, w, Cin, Cout, p.bk))
    return (int)cudaErrorInvalidValue;
  cudaError_t err =
      launch_gn_stats(x, mean_c, rstd_c, B, H * W, Cin, G, eps, s);
  if (err != cudaSuccess) return (int)err;
  const long long elems = (long long)B * H * W * Cout;
  const ConvArgs a{x,    gs,   gb,   bias, mean_c, rstd_c, slices > 1 ? part : y,
                   B,    H,    W,    Cin,  Cout,   p.n_chunks / slices,
                   slices, elems, FastDiv((H + 2) * (W + 2)), FastDiv(W + 2)};
  err = launch_conv(tw, a, p, s);
  if (err != cudaSuccess || slices == 1) return (int)err;
  const long long n4 = elems / 4;
  const long long blocks =
      std::min<long long>((n4 + 255) / 256, 8LL * std::max(sms, 1));
  conv3x3_reduce_kernel<<<(unsigned)blocks, 256, 0, s>>>(
      reinterpret_cast<const float4*>(part),
      reinterpret_cast<const float4*>(bias), reinterpret_cast<float4*>(y), n4,
      Cout / 4, slices);
  return (int)cudaGetLastError();
}
