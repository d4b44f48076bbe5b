// K1: GroupNorm(+SiLU) over a channels-last (B, HW, C) fp32 or bf16 tensor,
// and the GroupNorm statistics that K2, K3, K5 and K6 start from.
//
// Replaces: dxmi_tpu/ops/groupnorm.py:_kernel (run by _forward under
// fused_group_norm), the Pallas TPU kernel that holds a whole sample in
// VMEM, takes one-pass s1/s2 statistics through a one-hot group-mask
// matmul, then normalises, applies the affine and optionally SiLU: x read
// once, y written once.
//
// Bound on the H100: memory. The work is ~10-20 flops per element against
// 8 (fp32) or 4 (bf16) bytes moved, far below the ~20 flop/byte at which
// fp32 arithmetic would limit it. The least traffic is the TPU kernel's:
// one read of x and one write of y.
//
// Design: a (sample, slab of whole groups) slice is split by pixel rows over
// the CTAs of a thread-block cluster (1-8 CTAs). The route is chosen by
// shape in one place, gn_plan:
//   on-chip: each CTA copies its rows of the slab into shared memory with
//     16-byte cp.async copies, all in flight at once, in four row chunks
//     that the first statistics sweep follows as they land (48 KB a CTA,
//     three or four CTAs an SM, or 96 KB and two); takes the statistics
//     from there; the CTAs of the cluster add their partial sums per group
//     through distributed shared memory; then each CTA normalises its rows
//     from shared memory and writes y. x is read once, y written once.
//   split (a slice too large for the cluster): the same statistics pass
//     reads its rows from device memory (16-byte loads, four rows in flight
//     a thread, twice for two-pass statistics), writes per-channel mean and
//     rstd, and the vectorised apply kernel normalises.
// Thread (rr, v) of a CTA owns the v-th 16-byte vector of the slab's rows
// rr, rr + RP, ... (RP = kThreads / vectors a row), keeps one fp32 partial
// per channel of the vector in registers (a vector may straddle two
// groups), and sums its rows in order. The CTA adds the partials of its RP
// row lanes in order per channel, then the channels of each group in
// order; the cluster adds the CTAs' group sums in rank order. No atomics:
// a replay is bit-equal.
// Statistics: 'fp32' two-pass (mean, then the sum of (x - mean)^2, the
// plain version's default); or the bf16_onepass statistics of the JAX
// package (groupnorm.py:66-90): s1 and s2 of x and x*x (rounded to the
// input dtype) in fp32, mean and var rounded to the input dtype. Apply:
// fp32 arithmetic (x - mean) (rstd scale) + bias and SiLU u / (1 +
// exp(-u)) from the exp2 and reciprocal approximations, rounded once; or,
// for bf16_onepass on bf16, XLA's bf16 steps, each rounded to bf16, in
// bf16x2 instructions. With the plain version's exact fp32 order and IEEE
// exp and division per element, the arithmetic, not the memory, limited
// the kernel on the H100.
#include <algorithm>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kApplyThreads = 256;
constexpr int kMaxSlabGroups = 64;  // groups a slab holds at most
constexpr int kMaxCluster = 8;      // the portable cluster size
// a CTA's rows of x on the on-chip route, tried in order: with the row
// lanes' partial sums (<= 8 KB) three or four CTAs of the first fit in an
// SM's 228 KB, so that one CTA's loads overlap another's arithmetic and
// stores; two of the second, for the slices the first cannot take
constexpr int kTileBytes[2] = {48 * 1024, 96 * 1024};
// the narrowest slab row of a sample cut into several
constexpr int kMinSlabBytes = 64;
// the tile arrives in this many row chunks, the first statistics sweep
// following them
constexpr int kChunks = 4;

struct GnPlan {
  int hold;   // 1: on-chip (the slice held in shared memory), 0: split
  int slabs;  // slabs of whole groups a sample is cut into (C / slabs each)
  int cs;     // CTAs of a cluster, each HW / cs rows of a slab
};

// The route of K1 and of the statistics pass for (HW, C, G) of esize-byte
// elements. On-chip: for each tile budget in turn, the widest slab (whole
// rows first; a narrower slab only of whole 16-byte vectors and at least
// kMinSlabBytes a row) and then the smallest cluster whose tiles fit.
// Split: the widest slab whose row vectors the threads cover, and the
// largest cluster that divides HW. false: neither route takes the shape (C
// not a multiple of G or of a 16-byte vector, or no slab of at most
// kMaxSlabGroups groups whose row vectors kThreads cover).
bool gn_plan(int HW, int C, int G, int esize, GnPlan* p) {
  const int ve = 16 / esize;
  if (HW < 1 || G < 1 || C % G || C % ve) return false;
  auto slab_ok = [&](int slabs) {
    const int sc = C / slabs;
    return G % slabs == 0 && sc % ve == 0 && sc / ve <= kThreads &&
           G / slabs <= kMaxSlabGroups;
  };
  for (const int budget : kTileBytes)
    for (int slabs = 1; slabs <= G; ++slabs) {
      const int bytes = C / slabs * esize;
      if (!slab_ok(slabs) || (slabs > 1 && bytes < kMinSlabBytes)) continue;
      for (int cs = 1; cs <= kMaxCluster; cs *= 2)
        if (HW % cs == 0 && (long long)(HW / cs) * bytes <= budget) {
          *p = GnPlan{1, slabs, cs};
          return true;
        }
    }
  for (int slabs = 1; slabs <= G; ++slabs)
    if (slab_ok(slabs)) {
      int cs = kMaxCluster;
      while (HW % cs) cs /= 2;
      *p = GnPlan{0, slabs, cs};
      return true;
    }
  return false;
}

// ---- 16-byte vectors ------------------------------------------------------
__device__ __forceinline__ void unpack16(uint4 r, float (&f)[4]) {
  f[0] = __uint_as_float(r.x);
  f[1] = __uint_as_float(r.y);
  f[2] = __uint_as_float(r.z);
  f[3] = __uint_as_float(r.w);
}
__device__ __forceinline__ void unpack16(uint4 r, float (&f)[8]) {
  const bf16* e = reinterpret_cast<const bf16*>(&r);
#pragma unroll
  for (int j = 0; j < 8; ++j) f[j] = __bfloat162float(e[j]);
}
__device__ __forceinline__ uint4 pack16(const float (&f)[4]) {
  return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                    __float_as_uint(f[2]), __float_as_uint(f[3]));
}
__device__ __forceinline__ uint4 pack16(const float (&f)[8]) {
  return make_uint4(pack_bf16(f[0], f[1]), pack_bf16(f[2], f[3]),
                    pack_bf16(f[4], f[5]), pack_bf16(f[6], f[7]));
}

// ---- the normalised output ----------------------------------------------
// fp32 arithmetic, rounded once to the element type by the caller:
// u = (v - m) rs + b with rs = rstd * scale, then SiLU u / (1 + exp(-u))
__device__ __forceinline__ float gn_f32(float v, float m, float rs, float b,
                                        int silu_on) {
  const float u = fmaf(v - m, rs, b);
  return silu_on ? __fdividef(u, 1.f + __expf(-u)) : u;
}
// bf16x2 arithmetic, each result rounded to bf16 on its own (the asm keeps
// the compiler from contracting a product and a sum into one rounding)
__device__ __forceinline__ unsigned bsub2(unsigned a, unsigned b) {
  unsigned d;
  asm("sub.rn.bf16x2 %0, %1, %2;\n" : "=r"(d) : "r"(a), "r"(b));
  return d;
}
__device__ __forceinline__ unsigned badd2(unsigned a, unsigned b) {
  unsigned d;
  asm("add.rn.bf16x2 %0, %1, %2;\n" : "=r"(d) : "r"(a), "r"(b));
  return d;
}
__device__ __forceinline__ unsigned bmul2(unsigned a, unsigned b) {
  unsigned d;
  asm("mul.rn.bf16x2 %0, %1, %2;\n" : "=r"(d) : "r"(a), "r"(b));
  return d;
}
__device__ __forceinline__ float2 unpack_bf16(unsigned w) {
  return make_float2(__uint_as_float(w << 16),
                     __uint_as_float(w & 0xffff0000u));
}

// bf16_onepass on bf16 (a pair of channels): every operation rounded to
// bf16 as XLA rounds it, ((x - m) r) s + b and XLA's bf16 sigmoid
// 1 / (1 + exp(-u)); mean, rstd, scale and bias already bf16
__device__ __forceinline__ unsigned gn_bf16_step(unsigned x, unsigned m,
                                                 unsigned r, unsigned s,
                                                 unsigned b, int silu_on) {
  unsigned u = badd2(bmul2(bmul2(bsub2(x, m), r), s), b);
  if (silu_on) {
    const float2 uf = unpack_bf16(u);
    const float2 den = unpack_bf16(
        badd2(0x3f803f80u, pack_bf16(__expf(-uf.x), __expf(-uf.y))));
    u = bmul2(u, pack_bf16(__fdividef(1.f, den.x), __fdividef(1.f, den.y)));
  }
  return u;
}

// x * x of each element, rounded to the element type
__device__ __forceinline__ void squares(uint4 r, float (&f)[4]) {
  unpack16(r, f);
#pragma unroll
  for (int j = 0; j < 4; ++j) f[j] *= f[j];
}
__device__ __forceinline__ void squares(uint4 r, float (&f)[8]) {
  unpack16(make_uint4(bmul2(r.x, r.x), bmul2(r.y, r.y), bmul2(r.z, r.z),
                      bmul2(r.w, r.w)),
           f);
}

__device__ __forceinline__ void cp_async_wait_n(int n) {
  switch (n) {
    case 0: cp_async_wait<0>(); break;
    case 1: cp_async_wait<1>(); break;
    case 2: cp_async_wait<2>(); break;
    default: cp_async_wait<3>(); break;
  }
}

// ---- the cluster ----------------------------------------------------------
__device__ __forceinline__ int cluster_rank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return (int)r;
}
__device__ __forceinline__ int cluster_ctas() {
  unsigned n;
  asm volatile("mov.u32 %0, %%cluster_nctarank;\n" : "=r"(n));
  return (int)n;
}
// every thread of every CTA of the cluster arrives, then waits; a thread's
// shared-memory writes before its arrive are seen after the wait
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}
// *p in the shared memory of the cluster's CTA `rank`
__device__ __forceinline__ float ld_rank(const float* p, int rank) {
  unsigned addr;
  float v;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(addr)
               : "r"(smem_u32(p)), "r"(rank));
  asm volatile("ld.shared::cluster.f32 %0, [%1];\n"
               : "=f"(v)
               : "r"(addr)
               : "memory");
  return v;
}

template <typename T>
struct GnArgs {
  const T* x;
  T* y;  // written when apply (on-chip route only)
  const float* scale;
  const float* bias;
  float* mean_c;  // (B, C), written when !apply
  float* rstd_c;
  int HW, C, G, slabs;
  float eps;
  int onepass, apply, silu;
};

// The apply of one row vector (VE channels) with this thread's constants:
// fp32 arithmetic (m, rs = rstd scale, b per channel) rounded once, or, for
// bf16_onepass on bf16, stepwise bf16 (m2, r2, s2, b2 per channel pair).
template <typename T>
struct ApplyConsts;
template <>
struct ApplyConsts<float> {
  float m[4], rs[4], b[4];
  __device__ __forceinline__ uint4 operator()(uint4 raw, int silu_on,
                                              int) const {
    float f[4];
    unpack16(raw, f);
#pragma unroll
    for (int e = 0; e < 4; ++e)
      f[e] = gn_f32(f[e], m[e], rs[e], b[e], silu_on);
    return pack16(f);
  }
};
template <>
struct ApplyConsts<bf16> {
  float m[8], rs[8], b[8];
  unsigned m2[4], r2[4], s2[4], b2[4];  // bf16 pairs
  __device__ __forceinline__ uint4 operator()(uint4 raw, int silu_on,
                                              int stepwise) const {
    if (stepwise)
      return make_uint4(
          gn_bf16_step(raw.x, m2[0], r2[0], s2[0], b2[0], silu_on),
          gn_bf16_step(raw.y, m2[1], r2[1], s2[1], b2[1], silu_on),
          gn_bf16_step(raw.z, m2[2], r2[2], s2[2], b2[2], silu_on),
          gn_bf16_step(raw.w, m2[3], r2[3], s2[3], b2[3], silu_on));
    float f[8];
    unpack16(raw, f);
#pragma unroll
    for (int e = 0; e < 8; ++e)
      f[e] = gn_f32(f[e], m[e], rs[e], b[e], silu_on);
    return pack16(f);
  }
};

// channel c's constants into slot e (j = e / 2, the pair's half e % 2)
__device__ __forceinline__ void set_consts(ApplyConsts<float>& k, int e,
                                           float m, float r, float s,
                                           float b) {
  k.m[e] = m;
  k.rs[e] = r * s;
  k.b[e] = b;
}
__device__ __forceinline__ void set_consts(ApplyConsts<bf16>& k, int e,
                                           float m, float r, float s,
                                           float b) {
  k.m[e] = m;
  k.rs[e] = r * s;
  k.b[e] = b;
  bf16* m2 = reinterpret_cast<bf16*>(k.m2);
  bf16* r2 = reinterpret_cast<bf16*>(k.r2);
  bf16* s2 = reinterpret_cast<bf16*>(k.s2);
  bf16* b2 = reinterpret_cast<bf16*>(k.b2);
  m2[e] = __float2bfloat16_rn(m);
  r2[e] = __float2bfloat16_rn(r);
  s2[e] = __float2bfloat16_rn(s);
  b2[e] = __float2bfloat16_rn(b);
}

// grid (slabs * cs, B), clusters of cs CTAs along x; dynamic shared
// memory: the tile (HOLD) and the row lanes' partials
template <typename T, bool HOLD>
__global__ void __launch_bounds__(kThreads) gn_kernel(const GnArgs<T> a) {
  constexpr int VE = 16 / sizeof(T);
  extern __shared__ __align__(16) unsigned char gn_smem[];
  __shared__ float cpart[2][kMaxSlabGroups];  // this CTA's group sums
  __shared__ float gmean[kMaxSlabGroups], grstd[kMaxSlabGroups];
  const int cs = cluster_ctas(), rank = cluster_rank();
  const int slab = blockIdx.x / cs, b = blockIdx.y, tid = threadIdx.x;
  const int SC = a.C / a.slabs, GS = a.G / a.slabs, cg = a.C / a.G;
  const int NV = SC / VE, RP = kThreads / NV, R = a.HW / cs;
  const int v = tid % NV, rr = tid / NV;
  const bool active = rr < RP;
  // element offset of this CTA's first row, first channel of the slab
  const size_t base =
      ((size_t)b * a.HW + (size_t)rank * R) * a.C + (size_t)slab * SC;
  T* tile = reinterpret_cast<T*>(gn_smem);  // [R][SC]
  float* part = reinterpret_cast<float*>(
      gn_smem + (HOLD ? (size_t)R * SC * sizeof(T) : 0));  // [RP][SC]
  // the tile in nch chunks of CR rows, each its own cp.async group
  const int nch = HOLD && R % kChunks == 0 ? kChunks : 1, CR = R / nch;

  if (HOLD) {
    for (int k = 0; k < nch; ++k) {
      for (int i = tid; i < CR * NV; i += kThreads) {
        const int r = k * CR + i / NV, c = (i % NV) * VE;
        cp_async16(smem_u32(tile + r * SC + c),
                   a.x + base + (size_t)r * a.C + c, 16);
      }
      cp_async_commit();
    }
  }
  // this thread's vector of row r
  auto row = [&](int r) {
    if (HOLD) return *reinterpret_cast<const uint4*>(tile + r * SC + v * VE);
    return __ldg(reinterpret_cast<const uint4*>(a.x + base + (size_t)r * a.C +
                                                v * VE));
  };
  // per-channel sums over this thread's rows in [lo, hi), in row order:
  // centred == 0 adds x to p and (onepass) x*x rounded to T to q;
  // centred == 1 adds (x - mu)^2 to p
  float p[VE], q[VE], mu[VE];
#pragma unroll
  for (int e = 0; e < VE; ++e) p[e] = q[e] = 0.f;
  auto sweep = [&](int centred, int lo, int hi) {
    if (!active) return;
    int r = rr;
    if (r < lo) r += (lo - r + RP - 1) / RP * RP;
    constexpr int U = HOLD ? 1 : 4;  // rows in flight from device memory
    for (; r < hi; r += U * RP) {
      uint4 raw[U];
#pragma unroll
      for (int u = 0; u < U; ++u)
        if (r + u * RP < hi) raw[u] = row(r + u * RP);
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (r + u * RP >= hi) break;
        float f[VE];
        unpack16(raw[u], f);
        if (centred) {
#pragma unroll
          for (int e = 0; e < VE; ++e) {
            const float dv = f[e] - mu[e];
            p[e] = fmaf(dv, dv, p[e]);
          }
        } else {
#pragma unroll
          for (int e = 0; e < VE; ++e) p[e] += f[e];
          if (a.onepass) {
            squares(raw[u], f);
#pragma unroll
            for (int e = 0; e < VE; ++e) q[e] += f[e];
          }
        }
      }
    }
  };
  // this CTA's sum per group of the per-thread sums s, into cpart[slot]:
  // the row lanes per channel, then the channels of each group, in order
  auto reduce = [&](const float (&s)[VE], int slot) {
    __syncthreads();  // part is no longer read
    if (active)
#pragma unroll
      for (int e = 0; e < VE; ++e) part[rr * SC + v * VE + e] = s[e];
    __syncthreads();
    for (int c = tid; c < SC; c += kThreads) {
      float t = 0.f;
      for (int l = 0; l < RP; ++l) t += part[l * SC + c];
      part[c] = t;
    }
    __syncthreads();
    for (int gl = tid; gl < GS; gl += kThreads) {
      float t = 0.f;
      for (int k = 0; k < cg; ++k) t += part[gl * cg + k];
      cpart[slot][gl] = t;
    }
  };
  // the cluster's sum of group gl, in rank order
  auto total = [&](int slot, int gl) {
    float t = 0.f;
    for (int k = 0; k < cs; ++k) t += ld_rank(&cpart[slot][gl], k);
    return t;
  };

  const float n = (float)a.HW * (float)cg;
  for (int k = 0; k < nch; ++k) {  // the first sweep follows the chunks in
    if (HOLD) {
      cp_async_wait_n(nch - 1 - k);
      __syncthreads();
    }
    sweep(0, k * CR, (k + 1) * CR);
  }
  reduce(p, 0);
  if (a.onepass) reduce(q, 1);
  cluster_arrive();
  cluster_wait();
  if (a.onepass) {
    for (int gl = tid; gl < GS; gl += kThreads) {
      const float m = total(0, gl) / n;
      const float var = round_t<T>(fmaxf(total(1, gl) / n - m * m, 0.f));
      gmean[gl] = round_t<T>(m);
      grstd[gl] = round_t<T>(
          1.f / sqrtf(round_t<T>(var + round_t<T>(a.eps))));
    }
  } else {
    for (int gl = tid; gl < GS; gl += kThreads) gmean[gl] = total(0, gl) / n;
    __syncthreads();
    if (active)
#pragma unroll
      for (int e = 0; e < VE; ++e) {
        mu[e] = gmean[(v * VE + e) / cg];
        p[e] = 0.f;
      }
    sweep(1, 0, R);
    reduce(p, 1);
    cluster_arrive();
    cluster_wait();
    for (int gl = tid; gl < GS; gl += kThreads)
      grstd[gl] = 1.f / sqrtf(total(1, gl) / n + a.eps);
  }
  cluster_arrive();  // this CTA has read the others' sums
  __syncthreads();

  if (HOLD && a.apply) {
    if (active) {
      ApplyConsts<T> kc;
#pragma unroll
      for (int e = 0; e < VE; ++e) {
        const int cl = v * VE + e, c = slab * SC + cl;
        set_consts(kc, e, gmean[cl / cg], grstd[cl / cg], a.scale[c],
                   a.bias[c]);
      }
      const int stepwise = sizeof(T) == 2 && a.onepass;
      for (int rw = rr; rw < R; rw += RP)
        *reinterpret_cast<uint4*>(a.y + base + (size_t)rw * a.C + v * VE) =
            kc(row(rw), a.silu, stepwise);
    }
  } else if (!a.apply && rank == 0) {
    const size_t bc = (size_t)b * a.C + (size_t)slab * SC;
    for (int c = tid; c < SC; c += kThreads) {
      a.mean_c[bc + c] = gmean[c / cg];
      a.rstd_c[bc + c] = grstd[c / cg];
    }
  }
  cluster_wait();  // no CTA leaves while another reads its sums
}

// the most dynamic shared memory a launch asks for: a tile and the row
// lanes' partials (at most kThreads vectors of 8 fp32 sums)
constexpr int kMaxSmem = kTileBytes[1] + kThreads * 8 * (int)sizeof(float);

// raises gn_kernel's shared-memory limit to kMaxSmem, once a process (the
// attribute call costs host time on every launch otherwise)
template <typename T, bool HOLD>
cudaError_t allow_smem() {
  static const cudaError_t err = cudaFuncSetAttribute(
      gn_kernel<T, HOLD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kMaxSmem);
  return err;
}

template <typename T>
cudaError_t launch(const GnArgs<T>& a, int B, const GnPlan& p,
                   cudaStream_t stream) {
  const int sc = a.C / p.slabs, rp = kThreads / (sc * (int)sizeof(T) / 16);
  const size_t smem =
      (p.hold ? (size_t)(a.HW / p.cs) * sc * sizeof(T) : 0) +
      (size_t)rp * sc * sizeof(float);
  void (*kern)(const GnArgs<T>) =
      p.hold ? gn_kernel<T, true> : gn_kernel<T, false>;
  cudaError_t err = p.hold ? allow_smem<T, true>() : allow_smem<T, false>();
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.slabs * p.cs, B);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = p.cs;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kern, a);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_stats(const T* x, float* mean_c, float* rstd_c, int B,
                         int HW, int C, int G, float eps, int onepass,
                         cudaStream_t stream) {
  GnPlan p;
  if (!gn_plan(HW, C, G, sizeof(T), &p)) return cudaErrorInvalidValue;
  const GnArgs<T> a{x,  nullptr, nullptr, nullptr, mean_c, rstd_c, HW,
                    C,  G,       p.slabs, eps,     onepass, 0,     0};
  return launch(a, B, p, stream);
}

// ---- the split route's apply (and K6's) ---------------------------------
// grid (blocks, B): the threads of sample blockIdx.y stride over its 16-byte
// vectors by a multiple of the vectors a row, so that each thread keeps its
// channels' constants for all its rows
template <typename T>
__global__ void __launch_bounds__(kApplyThreads)
gn_apply_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                const float* __restrict__ bias,
                const float* __restrict__ mean_c,
                const float* __restrict__ rstd_c, T* __restrict__ y, int HW,
                int C, int silu_on, int stepwise) {
  constexpr int VE = 16 / sizeof(T);
  const int NV = C / VE, b = blockIdx.y;
  const int stride = gridDim.x * blockDim.x / NV * NV;
  const int i0 = blockIdx.x * blockDim.x + threadIdx.x;
  if (i0 >= stride) return;
  const int c = (i0 % NV) * VE;
  ApplyConsts<T> kc;
#pragma unroll
  for (int e = 0; e < VE; ++e)
    set_consts(kc, e, mean_c[(size_t)b * C + c + e],
               rstd_c[(size_t)b * C + c + e], scale[c + e], bias[c + e]);
  const uint4* xv = reinterpret_cast<const uint4*>(x + (size_t)b * HW * C);
  uint4* yv = reinterpret_cast<uint4*>(y + (size_t)b * HW * C);
  const long long n = (long long)HW * NV;
  for (long long i = i0; i < n; i += stride)
    yv[i] = kc(__ldg(xv + i), silu_on, sizeof(T) == 2 && stepwise);
}

template <typename T>
cudaError_t launch_apply(const T* x, const float* scale, const float* bias,
                         const float* mean_c, const float* rstd_c, T* y,
                         int B, int HW, int C, int silu, int stepwise,
                         cudaStream_t stream) {
  constexpr int VE = 16 / sizeof(T);
  if (C % VE || B < 1) return cudaErrorInvalidValue;
  const long long nv = (long long)HW * (C / VE);
  // about 16 blocks an SM over the batch, at least one row of vectors
  long long blocks = (nv + kApplyThreads - 1) / kApplyThreads;
  blocks = std::min(blocks, std::max(132LL * 16 / B, 1LL));
  blocks = std::max(blocks, (long long)(C / VE + kApplyThreads - 1) /
                                kApplyThreads);
  gn_apply_kernel<T><<<dim3((unsigned)blocks, B), kApplyThreads, 0, stream>>>(
      x, scale, bias, mean_c, rstd_c, y, HW, C, silu, stepwise);
  return cudaGetLastError();
}

template <typename T>
int forward(const T* x, const float* scale, const float* bias, T* y,
            float* mean_c, float* rstd_c, int B, int HW, int C, int G,
            float eps, int silu, int onepass, cudaStream_t stream) {
  GnPlan p;
  if (!gn_plan(HW, C, G, sizeof(T), &p)) return (int)cudaErrorInvalidValue;
  const GnArgs<T> a{x,      y,   scale,   bias,   mean_c, rstd_c, HW,
                    C,      G,   p.slabs, eps,    onepass, p.hold, silu};
  cudaError_t err = launch(a, B, p, stream);
  if (err != cudaSuccess || p.hold) return (int)err;
  return (int)launch_apply(x, scale, bias, mean_c, rstd_c, y, B, HW, C, silu,
                           onepass, stream);
}

}  // namespace

cudaError_t launch_gn_stats(const float* x, float* mean_c, float* rstd_c,
                            int B, int HW, int C, int G, float eps,
                            cudaStream_t stream) {
  return launch_stats<float>(x, mean_c, rstd_c, B, HW, C, G, eps, 0, stream);
}

cudaError_t launch_gn_stats_bf16(const bf16* x, float* mean_c, float* rstd_c,
                                 int B, int HW, int C, int G, float eps,
                                 int onepass, cudaStream_t stream) {
  return launch_stats<bf16>(x, mean_c, rstd_c, B, HW, C, G, eps, onepass,
                            stream);
}

cudaError_t launch_gn_apply(const float* x, const float* scale,
                            const float* bias, const float* mean_c,
                            const float* rstd_c, float* y, int B, int HW,
                            int C, int silu, cudaStream_t stream) {
  return launch_apply(x, scale, bias, mean_c, rstd_c, y, B, HW, C, silu, 0,
                      stream);
}

cudaError_t launch_gn_apply(const bf16* x, const float* scale,
                            const float* bias, const float* mean_c,
                            const float* rstd_c, bf16* y, int B, int HW,
                            int C, int silu, int stepwise,
                            cudaStream_t stream) {
  return launch_apply(x, scale, bias, mean_c, rstd_c, y, B, HW, C, silu,
                      stepwise, stream);
}

// x, y: (B, HW, C) fp32 (is_bf16 == 0) or bf16; scale, bias: (C,) fp32;
// mean_c, rstd_c: (B, C) scratch (the split route's statistics); onepass
// selects the bf16_onepass statistics (for fp32 x: one-pass fp32
// statistics).
extern "C" int dxmi_gn_forward(const void* x, const float* scale,
                               const float* bias, void* y, float* mean_c,
                               float* rstd_c, int B, int HW, int C, int G,
                               float eps, int silu, int is_bf16, int onepass,
                               void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (!is_bf16)
    return forward(static_cast<const float*>(x), scale, bias,
                   static_cast<float*>(y), mean_c, rstd_c, B, HW, C, G, eps,
                   silu, onepass, s);
  return forward(static_cast<const bf16*>(x), scale, bias,
                 static_cast<bf16*>(y), mean_c, rstd_c, B, HW, C, G, eps,
                 silu, onepass, s);
}

// The route gn_plan chooses for (HW, C, G) of esize-byte elements, into
// out[0..2] = (on-chip 1 / split 0, slabs, CTAs a cluster); a non-zero
// return: neither route takes the shape.
extern "C" int dxmi_gn_plan(int HW, int C, int G, int esize, int* out) {
  GnPlan p;
  if (!gn_plan(HW, C, G, esize, &p)) return (int)cudaErrorInvalidValue;
  out[0] = p.hold;
  out[1] = p.slabs;
  out[2] = p.cs;
  return 0;
}
