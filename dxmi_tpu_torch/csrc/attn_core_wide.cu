// The attention core of K2 and K7 in bf16 at 128 < d <= 256, any head
// count: per (sample, head) o = bf16(p v) with p = bf16(exp(s - m) / l),
// s = q k^T in fp32, and m and l each row's maximum and sum of exp(s - m)
// over all keys. q and k arrive scaled by the bf16 d^-1/4 in the qkv GEMM's
// epilogue (sm_scale 1).
//
// Replaces: the attention part of dxmi_tpu/ops/attn_block.py:_kernel (:225,
// bb = 1) and :_kernel_bb (:261) in bf16 at d > 128 (the CIFAR-10 nets'
// one head of d = 256): an fp32 softmax over whole key rows, normalised
// before p is rounded to bf16 (_softmax_rows(lg).astype(dt), :103-117,
// :162), p v summed in fp32 and rounded. K4 (flash_attn.cu), the core at
// d <= 128, rounds p before normalising it (its online form cannot
// normalise first); this core keeps the TPU body's order.
//
// Bound on the H100: bytes. At (B = 100, S = 256, one head of d = 256) it
// reads q, k and v and writes o, 52.4 MB, 0.0157 ms at 3.35 TB/s; its
// products (q k^T and p v) are 6.7 GFLOP, 0.0068 ms at 989 TFLOP/s, and the
// second pass over the keys adds 3.4 GFLOP.
//
// Design (K4's warp-specialised form with a second pass over the keys):
//   - A work item is NCW x 64 query rows of one (sample, head): NCW = 2
//     consumer warpgroups of 64 rows each, sharing the K and V tiles, when
//     S % 128 == 0, else one. The kernel is persistent, one block a SM
//     walking over the items with the q tiles fastest, so that the blocks at
//     work share a head's K and V in L2.
//   - One producer thread loads every tile by TMA (cp.async.bulk.tensor)
//     through the (B, S, nh, d) views of the qkv buffer (rows 3C apart,
//     heads d apart; the columns past d read as zeros up to D, the head
//     width padded to 192 or 256): the item's q rows, then pass 1's K tiles
//     of 64 keys, then pass 2's K and V tiles in turn, each into the next
//     slot of a ring as deep as shared memory allows (4 slots of 32 KB at
//     D = 256 with two consumers), guarded by full and empty mbarriers. A
//     tile lands as D / 64 boxes of 64 rows x 128 bytes with the 128-byte
//     swizzle, which wgmma reads directly: bf16 in shared memory, nothing
//     converted or repacked.
//   - Pass 1: per key tile each consumer warpgroup forms its 64 x 64 fp32
//     logits with wgmma (q and K from shared memory, K-major) and updates
//     each row's running maximum and sum of exp(s - max) (a row's 64 keys
//     spread over a quad of lanes: the maximum is shared across the quad
//     each tile, the partial sums are summed across it at the end), so that
//     m and l are the rows' exact maximum and sum.
//   - Pass 2: per key tile the logits again, p = bf16(exp(s - m) (1 / l))
//     from the accumulator registers, whose layout is wgmma's A-register
//     layout, and p v with wgmma, p from registers and V from shared memory
//     through an MN-major descriptor, one group a 64-column block of o.
//     Tile j's logits and tile j - 1's p v are in flight together while
//     tile j's p is formed, p alternating between two register sets as in
//     K4.
//   - The exponentials are 2^(s log2 e - m log2 e) on ex2.approx (2 ulp),
//     and p is scaled by the reciprocal of l, in place of expf and a
//     division per element, which the special-function unit and the ALUs
//     could not hide behind the products; p moves by a few fp32 ulps and
//     is still normalised before it is rounded.
//   - o leaves by TMA through two 64-column staging boxes per consumer
//     (128-byte swizzle), in place of 4-byte stores in the accumulator's
//     layout, half a 32-byte sector each.
//   - Registers: the 64 x D fp32 output of a consumer takes D / 2 a thread
//     (128 at D = 256), beside 32 of logits and 32 of p; with two consumers
//     the producer warpgroup gives its registers to them (setmaxnreg).
// Fixed sum orders and no atomics: a replay is bit-equal.
#include <math.h>

#include "tma.cuh"

namespace {

constexpr unsigned kBox = 64 * 128;  // a box: 64 rows x 128 bytes

// ---- wgmma groups, bf16 operands, fp32 accumulators --------------------
// One inline-asm block per group: the predicates and descriptors are formed
// first, then come the fence, the products and the commit.
// d (64 x 64) = q K^T over D / 16 k-steps, q and K in shared memory
// (K-major) as D / 64 boxes each, so that k-step kk starts (kk / 4) 8192 +
// (kk % 4) 32 bytes in (descriptor units of 16 bytes: (kk / 4) 512 +
// (kk % 4) 2): dq and dk describe k-step 0. The first product overwrites d.
template <int D>
__device__ __forceinline__ void wgmma_logits(float (&d)[32], uint64_t dq,
                                             uint64_t dk);

template <>
__device__ __forceinline__ void wgmma_logits<192>(float (&d)[32], uint64_t dq,
                                                  uint64_t dk) {
  asm volatile(
      "{\n.reg .pred p0, p1;\n.reg .b64 q1, k1, q2, k2, q3, k3, q4, k4, q5, k5, q6, k6, q7, k7, q8, k8, q9, k9, q10, k10, q11, k11;\n"
      "setp.ne.b32 p0, 0, 0;\nsetp.ne.b32 p1, 1, 0;\n"
      "add.s64 q1, %32, 2;\nadd.s64 k1, %33, 2;\n"
      "add.s64 q2, %32, 4;\nadd.s64 k2, %33, 4;\n"
      "add.s64 q3, %32, 6;\nadd.s64 k3, %33, 6;\n"
      "add.s64 q4, %32, 512;\nadd.s64 k4, %33, 512;\n"
      "add.s64 q5, %32, 514;\nadd.s64 k5, %33, 514;\n"
      "add.s64 q6, %32, 516;\nadd.s64 k6, %33, 516;\n"
      "add.s64 q7, %32, 518;\nadd.s64 k7, %33, 518;\n"
      "add.s64 q8, %32, 1024;\nadd.s64 k8, %33, 1024;\n"
      "add.s64 q9, %32, 1026;\nadd.s64 k9, %33, 1026;\n"
      "add.s64 q10, %32, 1028;\nadd.s64 k10, %33, 1028;\n"
      "add.s64 q11, %32, 1030;\nadd.s64 k11, %33, 1030;\n"
      "wgmma.fence.sync.aligned;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p0, 1, 1, 0, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, q1, k1, p1, 1, 1, 0, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, q2, k2, p1, 1, 1, 0, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, q3, k3, p1, 1, 1, 0, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, q4, k4, p1, 1, 1, 0, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, q5, k5, p1, 1, 1, 0, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, q6, k6, p1, 1, 1, 0, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, q7, k7, p1, 1, 1, 0, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, q8, k8, p1, 1, 1, 0, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, q9, k9, p1, 1, 1, 0, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, q10, k10, p1, 1, 1, 0, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, q11, k11, p1, 1, 1, 0, 0;\n"
      "wgmma.commit_group.sync.aligned;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(dq), "l"(dk)
      : "memory");
}

template <>
__device__ __forceinline__ void wgmma_logits<256>(float (&d)[32], uint64_t dq,
                                                  uint64_t dk) {
  asm volatile(
      "{\n.reg .pred p0, p1;\n.reg .b64 q1, k1, q2, k2, q3, k3, q4, k4, q5, k5, q6, k6, q7, k7, q8, k8, q9, k9, q10, k10, q11, k11, q12, k12, q13, k13, q14, k14, q15, k15;\n"
      "setp.ne.b32 p0, 0, 0;\nsetp.ne.b32 p1, 1, 0;\n"
      "add.s64 q1, %32, 2;\nadd.s64 k1, %33, 2;\n"
      "add.s64 q2, %32, 4;\nadd.s64 k2, %33, 4;\n"
      "add.s64 q3, %32, 6;\nadd.s64 k3, %33, 6;\n"
      "add.s64 q4, %32, 512;\nadd.s64 k4, %33, 512;\n"
      "add.s64 q5, %32, 514;\nadd.s64 k5, %33, 514;\n"
      "add.s64 q6, %32, 516;\nadd.s64 k6, %33, 516;\n"
      "add.s64 q7, %32, 518;\nadd.s64 k7, %33, 518;\n"
      "add.s64 q8, %32, 1024;\nadd.s64 k8, %33, 1024;\n"
      "add.s64 q9, %32, 1026;\nadd.s64 k9, %33, 1026;\n"
      "add.s64 q10, %32, 1028;\nadd.s64 k10, %33, 1028;\n"
      "add.s64 q11, %32, 1030;\nadd.s64 k11, %33, 1030;\n"
      "add.s64 q12, %32, 1536;\nadd.s64 k12, %33, 1536;\n"
      "add.s64 q13, %32, 1538;\nadd.s64 k13, %33, 1538;\n"
      "add.s64 q14, %32, 1540;\nadd.s64 k14, %33, 1540;\n"
      "add.s64 q15, %32, 1542;\nadd.s64 k15, %33, 1542;\n"
      "wgmma.fence.sync.aligned;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p0, 1, 1, 0, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, q1, k1, p1, 1, 1, 0, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, q2, k2, p1, 1, 1, 0, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, q3, k3, p1, 1, 1, 0, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, q4, k4, p1, 1, 1, 0, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, q5, k5, p1, 1, 1, 0, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, q6, k6, p1, 1, 1, 0, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, q7, k7, p1, 1, 1, 0, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, q8, k8, p1, 1, 1, 0, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, q9, k9, p1, 1, 1, 0, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, q10, k10, p1, 1, 1, 0, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, q11, k11, p1, 1, 1, 0, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, q12, k12, p1, 1, 1, 0, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, q13, k13, p1, 1, 1, 0, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, q14, k14, p1, 1, 1, 0, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, q15, k15, p1, 1, 1, 0, 0;\n"
      "wgmma.commit_group.sync.aligned;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(dq), "l"(dk)
      : "memory");
}

// d (64 x 64: one 64-column block of o) += p V over a tile of 64 keys: p
// from registers (a[kk], each warp's A fragments of keys 16 kk ..), V from
// shared memory through an MN-major descriptor dv of keys 0 .. 15, key step
// kk 16 rows (2048 bytes, 128 descriptor units) further.
__device__ __forceinline__ void wgmma_pv_block(float* d,
                                               const unsigned (&a)[4][4],
                                               uint64_t dv) {
  asm volatile(
      "{\n.reg .pred p1;\n.reg .b64 v1, v2, v3;\nsetp.ne.b32 p1, 1, 0;\n"
      "add.s64 v1, %48, 128;\nadd.s64 v2, %48, 256;\nadd.s64 v3, %48, 384;\n"
      "wgmma.fence.sync.aligned;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %48, p1, 1, 1, 1;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%36, %37, %38, %39}, v1, p1, 1, 1, 1;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%40, %41, %42, %43}, v2, p1, 1, 1, 1;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%44, %45, %46, %47}, v3, p1, 1, 1, 1;\n"
      "wgmma.commit_group.sync.aligned;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0][0]), "r"(a[0][1]), "r"(a[0][2]), "r"(a[0][3]), "r"(a[1][0]), "r"(a[1][1]), "r"(a[1][2]), "r"(a[1][3]), "r"(a[2][0]), "r"(a[2][1]), "r"(a[2][2]), "r"(a[2][3]), "r"(a[3][0]), "r"(a[3][1]), "r"(a[3][2]), "r"(a[3][3]), "l"(dv)
      : "memory");
}

// The shared memory at padded head width D with NCW consumers: the q rows
// (NCW x D / 64 boxes), a ring of NS slots of one 64-row K or V tile each,
// each consumer's staging boxes for o (SB boxes of 64 rows x 64 columns),
// the mbarriers (full[NS], empty[NS], q full, q empty) and slack to align
// the tiles on 1024 bytes (the swizzle pattern's period).
template <int D, int NCW>
struct Core {
  static constexpr int NB = D / 64, SB = 2;
  static constexpr unsigned TILE = NB * kBox;
  static constexpr unsigned Q = NCW * TILE;
  static constexpr unsigned STAGE = NCW * SB * kBox;
  static constexpr int FIT =
      (232448 - 1024 - Q - STAGE - 8 * (2 * 8 + 2)) / TILE;
  static constexpr int NS = FIT < 8 ? FIT : 8;
  static constexpr int SMEM =
      1024 + Q + NS * TILE + STAGE + 8 * (2 * NS + 2);
};

struct CoreShape {
  int S, nh, n_items;
};

constexpr float kLog2e = 1.4426950408889634f;

// Persistent: block i takes work items i, i + gridDim.x, ..., an item being
// NCW x 64 query rows of one (sample, head), q tiles fastest.
template <int D, int NCW>
__global__ void __launch_bounds__(128 * (NCW + 1), 1)
attn_core_wide_kernel(const __grid_constant__ CUtensorMap tq,
                      const __grid_constant__ CUtensorMap tk,
                      const __grid_constant__ CUtensorMap tv,
                      const __grid_constant__ CUtensorMap to,
                      const CoreShape p) {
  using G = Core<D, NCW>;
  constexpr int NB = G::NB, NS = G::NS, SB = G::SB;
  extern __shared__ unsigned char smem_raw[];
  const unsigned q_s = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const unsigned k_s = q_s + G::Q;
  const unsigned stg = k_s + NS * G::TILE;
  const unsigned bars = stg + G::STAGE;
  const unsigned q_full = bars + 16 * NS, q_empty = q_full + 8;
  auto slot = [&](int s) { return k_s + s * G::TILE; };
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (NS + s); };
  const int n_qt = p.S / (64 * NCW), n_tiles = p.S / 64;
  // the warpgroup, broadcast from lane 0 so that ptxas sees it warp-uniform
  // and forms the wgmma descriptors derived from it in uniform registers
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x >> 7, 0);

  if (threadIdx.x == 0) {
    for (int s = 0; s < NS; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), NCW);
    }
    mbar_init(q_full, 1);
    mbar_init(q_empty, NCW);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == NCW) {
    // producer: one thread issues every copy, running into the next item
    // while the consumers finish this one. Tile u of the block goes to slot
    // u % NS; an item's tiles are pass 1's K_0 .. K_{n-1}, then pass 2's
    // K_0, V_0, K_1, V_1, ...
    if constexpr (NCW == 2)
      asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 128 * NCW) {
      int u = 0, n = 0;  // tiles and items so far
      for (int w = blockIdx.x; w < p.n_items; w += gridDim.x, ++n) {
        const int qt = w % n_qt, h = (w / n_qt) % p.nh, b = w / (n_qt * p.nh);
        if (n > 0) mbar_wait(q_empty, (n - 1) & 1);  // last item's q is read
        mbar_expect_tx(q_full, G::Q);
        for (int r = 0; r < NCW; ++r)
          for (int c = 0; c < NB; ++c)
            tma_load_4d(q_s + (r * NB + c) * kBox, &tq, q_full, c * 64, h,
                        (qt * NCW + r) * 64, b);
        for (int i = 0; i < 3 * n_tiles; ++i, ++u) {
          const int s = u % NS;
          if (u >= NS)  // the consumers are done with tile u - NS
            mbar_wait(empty(s), (u / NS - 1) & 1);
          const bool is_v = i >= n_tiles && ((i - n_tiles) & 1);
          const int j = i < n_tiles ? i : (i - n_tiles) >> 1;
          mbar_expect_tx(full(s), G::TILE);
          for (int c = 0; c < NB; ++c)
            tma_load_4d(slot(s) + c * kBox, is_v ? &tv : &tk, full(s), c * 64,
                        h, j * 64, b);
        }
      }
    }
  } else {
    // consumer warpgroup wg: q rows 64 wg .. + 63 of the item, a warp's 16
    // rows as wgmma's accumulator layout: this thread holds rows g and
    // g + 8 of its warp's, columns 8 n + 2 t + {0, 1} in registers
    // 4 n + {0, 1} (row g) and 4 n + {2, 3} (row g + 8)
    if constexpr (NCW == 2)
      asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int t = threadIdx.x & 127, warp = t >> 5, lane = t & 31;
    const uint64_t dq = gmma_desc(q_s + wg * G::TILE, 16, 1024, 1);
    const unsigned stg_wg = stg + wg * SB * kBox;
    float acc[D / 2], sc[32];
    unsigned pa[4][4], pb[4][4];  // p as bf16 A fragments, two sets
    // rows g and g + 8: the maximum (log2 units of the logits), the sum
    // of 2^(s log2 e - max), then its reciprocal
    float m_r[2], l_r[2];

    auto wait_full = [&](int v) { mbar_wait(full(v % NS), (v / NS) & 1); };
    auto release = [&](int v) {
      if (t == 0) mbar_arrive(empty(v % NS));
    };
    auto logits = [&](int v) {
      wgmma_logits<D>(sc, dq, gmma_desc(slot(v % NS), 16, 1024, 1));
    };
    // acc += p V of tile v, p from pc: one group per 64-column block
    auto pv = [&](int v, const unsigned (&pc)[4][4]) {
#pragma unroll
      for (int c = 0; c < NB; ++c)
        wgmma_pv_block(acc + 32 * c, pc,
                       gmma_desc(slot(v % NS) + c * kBox, kBox, 1024, 1));
    };
    // p = bf16(2^(s log2 e - max) / sum) of the logits into pn
    auto probs = [&](unsigned (&pn)[4][4]) {
#pragma unroll
      for (int i = 0; i < 32; ++i) fence_operand(sc[i]);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 8 * kk + 2 * e, r = e & 1;
          pn[kk][e] =
              pack_bf16(fast_exp2(fmaf(sc[i], kLog2e, -m_r[r])) * l_r[r],
                        fast_exp2(fmaf(sc[i + 1], kLog2e, -m_r[r])) * l_r[r]);
        }
    };

    int u = 0, n = 0;
    for (int w = blockIdx.x; w < p.n_items; w += gridDim.x, ++n) {
      const int qt = w % n_qt, h = (w / n_qt) % p.nh, b = w / (n_qt * p.nh);
      mbar_wait(q_full, n & 1);

      // pass 1: each row's maximum and sum over all keys
      m_r[0] = m_r[1] = -INFINITY;
      l_r[0] = l_r[1] = 0.f;
      for (int j = 0; j < n_tiles; ++j, ++u) {
        wait_full(u);
        logits(u);
        wgmma_wait<0>();
        release(u);
#pragma unroll
        for (int i = 0; i < 32; ++i) fence_operand(sc[i]);
        float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
        for (int i = 0; i < 32; ++i)
          mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sc[i]);
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
          const float m_new = fmaxf(m_r[r], mx[r] * kLog2e);
          l_r[r] *= fast_exp2(m_r[r] - m_new);
          m_r[r] = m_new;
        }
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const int r = (i >> 1) & 1;
          l_r[r] += fast_exp2(fmaf(sc[i], kLog2e, -m_r[r]));
        }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        l_r[r] += __shfl_xor_sync(0xffffffffu, l_r[r], 1);
        l_r[r] += __shfl_xor_sync(0xffffffffu, l_r[r], 2);
        l_r[r] = 1.f / l_r[r];
      }

      // pass 2: tile j's K is tile u0 + 2 j of the block, its V the next
#pragma unroll
      for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
      const int u0 = u;
      wait_full(u0);
      logits(u0);
      wgmma_wait<0>();
      release(u0);
      if (n_tiles == 1 && t == 0) mbar_arrive(q_empty);
      probs(pa);
      // tile j's logits and tile j - 1's p v (from pc) in flight together,
      // then tile j's p into pn while p v runs
      auto step = [&](int j, const unsigned (&pc)[4][4],
                      unsigned (&pn)[4][4]) {
        const int uk = u0 + 2 * j;
        wait_full(uk - 1);
        wait_full(uk);
        logits(uk);
        pv(uk - 1, pc);
        wgmma_wait<NB>();  // the logits are in
        release(uk);
        if (j == n_tiles - 1 && t == 0) mbar_arrive(q_empty);
        probs(pn);
        wgmma_wait<0>();  // p v of tile j - 1 is done: its V slot is free
#pragma unroll
        for (int i = 0; i < D / 2; ++i) fence_operand(acc[i]);
        release(uk - 1);
      };
      int j = 1;
      for (; j + 1 < n_tiles; j += 2) {
        step(j, pa, pb);
        step(j + 1, pb, pa);
      }
      const int last = u0 + 2 * n_tiles - 1;  // the last tile's V
      if (j < n_tiles) {
        step(j, pa, pb);
        wait_full(last);
        pv(last, pb);
      } else {
        wait_full(last);
        pv(last, pa);
      }
      wgmma_wait<0>();
#pragma unroll
      for (int i = 0; i < D / 2; ++i) fence_operand(acc[i]);
      release(last);
      u = last + 1;

      // o = bf16(acc) by TMA through this warpgroup's SB staging boxes, SB
      // 64-column boxes at a time (128-byte swizzle: 16-byte chunk j of row
      // r at chunk j ^ (r % 8)); TMA leaves the columns past d unwritten
      const int g = lane >> 2;
      unsigned char* my = smem_raw + (stg_wg - smem_u32(smem_raw)) +
                          (warp * 16 + g) * 128 + 4 * (lane & 3);
#pragma unroll
      for (int c0 = 0; c0 < NB; c0 += SB) {
        if (t == 0) bulk_wait<true>();  // the last store has read the boxes
        asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
#pragma unroll
        for (int c = c0; c < c0 + SB && c < NB; ++c)
#pragma unroll
          for (int jj = 0; jj < 8; ++jj)
#pragma unroll
            for (int hh = 0; hh < 2; ++hh) {
              const int i = 32 * c + 4 * jj + 2 * hh;
              *reinterpret_cast<unsigned*>(my + (c - c0) * kBox +
                                           8 * hh * 128 + ((jj ^ g) << 4)) =
                  pack_bf16(acc[i], acc[i + 1]);
            }
        fence_async_smem();
        asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
        if (t == 0) {
          for (int c = c0; c < c0 + SB && c < NB; ++c)
            tma_store_4d(&to, stg_wg + (c - c0) * kBox, c * 64, h,
                         qt * 64 * NCW + wg * 64, b);
          bulk_commit();
        }
      }
    }
    if (t == 0) bulk_wait<false>();
  }
}

// each instantiation's shared-memory limit is raised once a process (the
// attribute call costs host time on every launch otherwise)
template <int D, int NCW>
cudaError_t launch(const bf16* qkv, bf16* o, int B, int S, int C, int nh,
                   int sms, cudaStream_t stream) {
  using G = Core<D, NCW>;
  const int d = C / nh;
  const CUtensorMapSwizzle sw = CU_TENSOR_MAP_SWIZZLE_128B;
  CUtensorMap tq, tk, tv, to;
  if (!encode_view(&tq, qkv, B, S, nh, d, 3 * C, 64, 64, sw) ||
      !encode_view(&tk, qkv + C, B, S, nh, d, 3 * C, 64, 64, sw) ||
      !encode_view(&tv, qkv + 2 * C, B, S, nh, d, 3 * C, 64, 64, sw) ||
      !encode_view(&to, o, B, S, nh, d, C, 64, 64, sw))
    return cudaErrorInvalidValue;
  static const cudaError_t allowed = cudaFuncSetAttribute(
      attn_core_wide_kernel<D, NCW>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, G::SMEM);
  if (allowed != cudaSuccess) return allowed;
  const int n_items = S / (64 * NCW) * nh * B;
  attn_core_wide_kernel<D, NCW>
      <<<n_items < sms ? n_items : sms, 128 * (NCW + 1), G::SMEM, stream>>>(
          tq, tk, tv, to, CoreShape{S, nh, n_items});
  return cudaGetLastError();
}

}  // namespace

cudaError_t launch_attn_core_wide(const bf16* qkv, bf16* attn, int B, int S,
                                  int C, int nh, cudaStream_t stream) {
  const int d = nh > 0 && C % nh == 0 ? C / nh : 0;
  // TMA: 16-byte aligned bases and strides (d % 8 == 0 makes C one)
  if (B < 1 || S < 64 || S % 64 || d <= 128 || d > 256 || d % 8 ||
      (uintptr_t)qkv % 16 || (uintptr_t)attn % 16)
    return cudaErrorInvalidValue;
  int dev, sms;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const bool two = S % 128 == 0;
  if (d <= 192)
    return two ? launch<192, 2>(qkv, attn, B, S, C, nh, sms, stream)
               : launch<192, 1>(qkv, attn, B, S, C, nh, sms, stream);
  return two ? launch<256, 2>(qkv, attn, B, S, C, nh, sms, stream)
             : launch<256, 1>(qkv, attn, B, S, C, nh, sms, stream);
}

// qkv: (B, S, 3C) bf16 with [3, nh, d] columns, q and k pre-scaled; attn:
// (B, S, C) bf16. Needs S % 64 == 0 and d = C / nh with 128 < d <= 256,
// d % 8 == 0.
extern "C" int dxmi_attn_core_wide(const void* qkv, void* attn, int B, int S,
                                   int C, int nh, void* stream) {
  return (int)launch_attn_core_wide(static_cast<const bf16*>(qkv),
                                    static_cast<bf16*>(attn), B, S, C, nh,
                                    (cudaStream_t)stream);
}
