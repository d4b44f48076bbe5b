#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (dxmi_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the repository root on a machine with a CUDA card and nvcc. It
needs torch and numpy only (no JAX, PyYAML or msgpack: configs are read by
the port's own YAML reader). Phases, each printed with its seconds; any
failure exits non-zero naming the phase:

  B  build every kernel from dxmi_tpu_torch/csrc (one bounded nvcc process
     per source, all started together) and print -Xptxas -v (registers,
     shared memory, spills);
  K  hold each kernel against its plain PyTorch version at the full-width
     CIFAR-10 and ImageNet64 shapes (K3 at every conv shape of the CIFAR-10
     net and at E4's batches 128 and 32, each replayed bit-equal; K1 also
     on either side of its route
     gate at 6, 12, 24 and 48 channels a group, bf16 in both statistics
     modes and fp32, replayed bit-equal; K2 fp32 at batch 100, 128 and 32,
     K2 bf16 at the ImageNet64 maps and at E3's batch 128, K5 at the
     ImageNet64 and LSUN's C=1024 maps, each replayed bit-equal; K4's
     logsumexp, the backward kernels K4-dkv, K4-dq and K6 at the ImageNet64
     maps at E3's batch 128, K4-dkv/dq also chained from the plain forward,
     K6 also at the ADM fixture's fp32 shape, and both at the tensor-core
     kernels' edges (S = 64; head dims 24, 32, 36, 40); K4 at its wgmma
     kernel's edges (S = 64, 256, 1024; d = 24, 32, 40, 64, 128; views of one
     qkv buffer and three tensors; with lse); K7 fp32 at E4's shape at batch
     128 and 32, bb 2 and 4, bf16 at ImageNet64's 16x16 map and at E4's
     shape with two heads; K8 at the CIFAR-10 net's int8 shapes, its
     stride-2 form at the three Downsample maps in fp32 and bf16, exact and
     replayed bit-equal; K1 at the CIFAR-10 net's bf16 shapes, 4 to 16
     channels a group, both statistics modes, replayed bit-equal, with its
     route; K3 on bf16 x at every conv shape of E-bf16 and at E4-levers'
     batches 128 and 64 at the 32x32 and 4x4 maps (the small maps in
     slices), K2 bf16 at the 16x16 blocks' one head of d = 256 at batch
     100, 128 and 64 and at two heads of d = 256 at batch 100, K7 bf16 at
     d = 256 at batch 128 and 64, bb 4, and the wide attention core alone
     at the d = 256 shapes of batch 100, each against its plain version and
     replayed bit-equal);
  T  time each kernel, its plain version and one PyTorch library call with
     CUDA events, device time (K4 at each shape the main paths launch it
     at; K2 fp32 beside K7 at bb 2 and 4 on the same inputs at batch 100,
     128 and 32; K6's fp32 form at G3's shape); and K2 bf16 and K5 at each
     of their main-path maps split by launch (torch.profiler: statistics,
     GN apply or quantise, qkv GEMM, core, proj GEMM), K2 bf16 at d = 256
     and K7 bf16 at E4's shape, bb 4, the same way, and K3 at one shape
     of each map size (weight cast, statistics, conv, the sum of split
     slices), each beside its bound; K8 (both forms) at the CIFAR-10
     net's int8 shapes beside torch._int_mm on the im2col matrix; K3 on
     bf16 x, K2 bf16 and K7 bf16 at d = 256 and the wide attention core
     beside their library compositions (cuDNN's bf16 conv; GN + matmul +
     SDPA; SDPA);
  T-bwd the device time of each launch of one K6 bf16 call and one K4-dkv
     call at the 32x32 map at batch 128 (torch.profiler);
  G  replay the trained reference fixture (tests/fixtures/torch_rundir_t10)
     with its injected noise through the kernels, unfused and fused;
  G-int8 the CIFAR fixture under --int8: calibration from injected draws
     and the int8 step means, against the JAX package's (tests/
     torch_fixtures/cifar_int8_golden.npz), gated as G2-int8;
  G-bf16 the CIFAR fixture in bf16 (generate_cifar10 --dtype bf16), fused
     and unfused, each step's mean against the JAX package's bf16 ones
     (tests/torch_fixtures/cifar_bf16_golden.npz) within twice JAX's own
     bf16 effect;
  E  generate 2 batches of 100 CIFAR-10 samples at T=10 at the full width of
     configs/cifar10/T10.yaml with seeded random weights, and check that the
     main path launched each kernel the expected number of times;
  E-int8 the same net under int8: (a) generate_cifar10 --int8 with an fp32
     and a bf16 torso (calibrated on 2 x 64 trajectories), 2 batches of 100,
     and (b) bench.py's configuration (bf16, the attention 1x1s in bf16,
     merged qkv, max-free softmax, phase upsample, bf16_onepass statistics;
     calibrated on 1 x 8) through sample_many, 2 batches of 96; the launches
     of K1 and of both K8 forms checked, img/s beside E's, K8's and K1's
     shares of a profiled trajectory and K8's time by shape beside its
     bound and torch._int_mm on an im2col matrix of the shape;
  E-bf16 the same net in bf16 without int8 (generate_cifar10 --dtype
     bf16: K3 bf16, K2 bf16 at d = 256, K1 bf16), 2 batches of 100, the
     launches checked, img/s, a profiled trajectory's device time, idle
     share and K3's and K2's shares beside E's;
  G2 replay the trained ADM fixture (tests/fixtures/torch_rundir_adm_t10)
     with its injected noise and labels, einsum and fused attention;
  G2-int8 the ADM fixture under --int8: calibration from injected draws and
     the int8 step means, against the JAX package's (tests/torch_fixtures/
     adm_int8_golden.npz);
  E2 generate 2 batches of 100 ImageNet64 samples at T=10 at the full width
     of configs/imagenet64/T10.yaml (bf16) with seeded random weights, with
     fused and with flash attention, checking the launches of each path;
  E2-int8 the same under --int8 (W8A8 static, calibrated first as the CLI
     does), through K5 and K8, with K8's share of a profiled trajectory and
     K8's time by shape, and E2's img/s beside its own;
  G3 one DxMITrainerCond iteration (update_f_v + update_sampler) on the
     ADM fixture with injected draws, einsum and fused_train (K2 forward, K6
     backward, fp32), against the JAX package's (tests/torch_fixtures/
     adm_train_golden.npz);
  E3 DxMI training at the full width of configs/imagenet64/T10.yaml (bf16,
     seeded random weights, the structured fake pool): 3 steps with flash
     attention (K4 forward, K4-dkv, K4-dq) and 3 with fused_train (K2, K6),
     checking the launches per step, finite metrics and no skipped update,
     the backward kernels' share of a profiled step, and the first
     minibatch's gradient by einsum, flash and fused_train,
     whole and per group of the attention blocks' parameters;
  G4 one DxMITrainer iteration on the CIFAR fixture with the JAX trainer's
     trajectory, permutation, noise and dropout masks, einsum and fused
     attention at bb 2 (K7), with and without K3, against the JAX package's
     (tests/torch_fixtures/cifar_train_golden.npz);
  E4 DxMI training at the full width of configs/cifar10/T10.yaml (fp32,
     batch 128, seeded weights, fake_cifar): 3 steps with fused attention at
     bb 1 (K2) and 3 at DXMI_FUSED_ATTN_BB=4 (K7), checking the launches per
     step, finite metrics and the first minibatch's gradient by einsum,
     fused bb 1 and fused bb 4, whole and per group of the attention
     blocks' parameters;
  E4-levers train_cifar10 --fast_levers at the same config (bf16 sampler
     and value torso, batch 128 sampled in 2 chunks of 64): 3 steps at bb 1
     (K2 bf16 at d = 256) and 2 at bb 4 (K7 bf16), the launches per step,
     finite metrics, s/step with its phase split, peak memory and a
     profiled step's idle share;
  T-K1 K1's time at each shape that E-int8, E2 (fused, flash), E3 (flash,
     fused_train) and E4 launched it at, with its launches per trajectory or
     step (counted in those phases), its route and its bound;
  T-K3 K3's time at each shape that E and E4 launched it at, with its
     launches per trajectory or step (counted in those phases), its bound,
     its library and its plain time (without E and E4 in the run: at every
     conv shape of the CIFAR-10 net at batch 100, 32 and 128, no launches);
  C  run the generation CLIs (generate_cifar10 and generate_large, each
     with and without --int8; generate_cifar10 --dtype bf16) as
     subprocesses on the fixture run dirs with --save_npz, and hold each
     npz to the in-process samples; then
     train_image_large for 2 steps on a shrunken config and generate_large
     on the run dir it wrote, and the same with train_cifar10 and
     generate_cifar10.

`python3 chip_smoke.py --phases B,T-bwd` runs the phases named (here the
build and the backward kernels' breakdown) and prints no kernels record and
no last line.

The line before the last line is the card's name and power limit from
nvidia-smi, the one before it the kernels' JSON record, and the last line is
{"ok": true, "device": {...}}.
"""
from __future__ import annotations

import collections
import contextlib
import faulthandler
import json
import os
import subprocess
import sys
import time
import traceback
import zlib

import numpy as np
import torch
import torch.nn.functional as F

from dxmi_tpu_torch import (generate_cifar10, generate_large, train_cifar10,
                            train_image_large)
from dxmi_tpu_torch.config import instantiate, load_yaml, merge
from dxmi_tpu_torch.generate_cifar10 import (generate, load_sampler,
                                             sample_batches, to_uint8)
from dxmi_tpu_torch.models.unet_adm import AttentionBlockADM
from dxmi_tpu_torch.ops import _lib, conv_fused
from dxmi_tpu_torch.ops.attention import (flash_bwd_dkv, flash_bwd_dq,
                                          flash_fwd_kernel,
                                          flash_mha, flash_mha_bwd,
                                          flash_mha_fwd,
                                          flash_mha_reference,
                                          flash_mha_reference_bwd,
                                          flash_mha_reference_fwd,
                                          flash_reference_dkv,
                                          flash_reference_dq)
from dxmi_tpu_torch.data.cifar10 import EpochLoader, fake_cifar
from dxmi_tpu_torch.models.unet_small import AttnBlock
from dxmi_tpu_torch.ops.attn_block import (BWD_MAX_SLICES,
                                           BWD_ROWS_PER_CHUNK,
                                           BWD_ROWS_PER_SLICE, attn_block,
                                           attn_block_bb,
                                           attn_block_bb_reference,
                                           attn_block_bwd,
                                           attn_block_bwd_reference,
                                           attn_block_int8,
                                           attn_block_int8_plain,
                                           attn_block_reference,
                                           attn_core_reference,
                                           attn_core_wide, prep_int8_mats,
                                           resolve_block_b)
from dxmi_tpu_torch.ops.conv_fused import gn_silu_conv, gn_silu_conv_reference
from dxmi_tpu_torch.ops.groupnorm import (group_norm,
                                          group_norm_silu_reference, route)
from dxmi_tpu_torch.ops.quant import (SAME_3X3, calib_channel_scale,
                                      int8_conv_apply, int8_conv_reference,
                                      out_size, prepare_conv_static)
from dxmi_tpu_torch.runtime import select_device
from dxmi_tpu_torch.samplers import sample_many
from dxmi_tpu_torch.trainers.buffer import from_d_sample
from dxmi_tpu_torch.trainers.dxmi import DxMITrainer, train_step
from dxmi_tpu_torch.trainers.dxmi_cond import DxMITrainerCond
from dxmi_tpu_torch.utils.checkpoint import (load_sampler_state,
                                             load_value_state)

REPO = os.path.dirname(os.path.abspath(__file__))
FIXTURE_DIR = os.path.join(REPO, "tests", "fixtures", "torch_rundir_t10")
ADM_FIXTURE_DIR = os.path.join(REPO, "tests", "fixtures",
                               "torch_rundir_adm_t10")
WATCHDOG_S = 1100

CIFAR10_CONFIG = os.path.join(REPO, "configs", "cifar10", "T10.yaml")
IMAGENET64_CONFIG = os.path.join(REPO, "configs", "imagenet64", "T10.yaml")
INT8_GOLDEN = os.path.join(REPO, "tests", "torch_fixtures",
                           "adm_int8_golden.npz")
CIFAR_INT8_GOLDEN = os.path.join(REPO, "tests", "torch_fixtures",
                                 "cifar_int8_golden.npz")
TRAIN_GOLDEN = os.path.join(REPO, "tests", "torch_fixtures",
                            "adm_train_golden.npz")
BATCH, N_BATCHES, T = 100, 2, 10


def fixture_config():
    """tests/fixtures/torch_rundir_t10/config.yaml, read by the port's YAML
    reader (the card has no PyYAML)."""
    return load_yaml(os.path.join(FIXTURE_DIR, "config.yaml"))


def cifar10_t10():
    """The generation half of configs/cifar10/T10.yaml (full width)."""
    cfg = load_yaml(CIFAR10_CONFIG)
    return {k: cfg[k] for k in ("sampler_net", "sampler")}


def adm_fixture_config():
    """tests/fixtures/torch_rundir_adm_t10/config.yaml."""
    return load_yaml(os.path.join(ADM_FIXTURE_DIR, "config.yaml"))


def imagenet64_t10():
    """The generation half of configs/imagenet64/T10.yaml (full width,
    bf16)."""
    cfg = load_yaml(IMAGENET64_CONFIG)
    return {k: cfg[k] for k in ("diffusion", "sampler")}


# Kernel launches per UNetADM forward at that config (36 ResBlocks, 22
# attention blocks: 7 at 32x32, 7 at 16x16, 8 at 8x8; tests/
# test_torch_unet_adm.py counts them on the CPU): with attn_impl='fused' K1
# runs the 72 ResBlock norms and out.0, K2 every attention block; with
# 'flash' K1 also runs the 22 attention norms and K4 the 32x32 maps (the
# 16x16 and 8x8 maps take the einsum path).
ADM_LAUNCHES_PER_FORWARD = {
    "fused": {"gn_silu_bf16": 73, "attn_block_bf16": 22},
    "flash": {"gn_silu_bf16": 95, "flash_attn": 7},
    # --int8 (static, fused): K5 every attention block, K8 the 72 ResBlock
    # 3x3 convs with each of the 3 up-blocks' first conv as 4 phase convs
    "int8": {"gn_silu_bf16": 73, "attn_block_i8": 22, "int8_conv": 81},
}
# Calibration's full-precision forwards under --int8 (2 rounds of 10 steps
# at 8 samples): K1 runs the attention norms too, K4 the 32x32 maps.
ADM_CALIB_LAUNCHES = {"gn_silu_bf16": 95 * 20, "flash_attn": 7 * 20}

# Kernel launches per UNetSmall forward at that config (fuse_gn_conv=True,
# attn_impl='fused'): K1 = norm_out + the 4x4 mid block's norm, K3 = conv1
# and conv2 of 22 ResnetBlocks, K2 = the 5 attention blocks at 16x16.
LAUNCHES_PER_FORWARD = {"gn_silu": 2, "gn_silu_conv3x3": 44, "attn_block": 5}
# The same net in bf16 without int8 (generate_cifar10 --dtype bf16, E-bf16):
# the same layers, K3 on bf16 activations, K2 bf16 at the 16x16 blocks' one
# head of d = 256 (the wide attention core).
BF16_LAUNCHES_PER_FORWARD = {"gn_silu_bf16": 2, "gn_silu_conv3x3_bf16": 44,
                             "attn_block_bf16_d256": 5}
# E-int8's launches a forward of the full-width CIFAR-10 net: (a) --int8
# (fp32 or bf16 torso; K1 at all 51 GroupNorms, K8 at the 57 ResnetBlock
# convs, the 3 Upsample convs and the 24 attention 1x1s, and its stride-2
# form at the 3 Downsample convs) and (b) bench.py's configuration (the
# attention 1x1s in bf16, each phase Upsample as 4 K8 launches)
CIFAR_INT8_LAUNCHES_PER_FORWARD = {
    "a_fp32": {"gn_silu": 51, "int8_conv": 84, "int8_conv_s2": 3},
    "a_bf16": {"gn_silu_bf16": 51, "int8_conv": 84, "int8_conv_s2": 3},
    "b": {"gn_silu_bf16": 51, "int8_conv": 69, "int8_conv_s2": 3},
}

# H100 SXM peaks (NVIDIA data sheet, dense): memory rate, fp32 outside the
# tensor cores, bf16 and int8 tensor cores. An fp32-accurate product on the
# tensor cores is three TF32 products (the 3xTF32 split of K2 fp32 and K7)
# at 495 TFLOP/s, faster than fp32 outside them: such products are bounded
# at 495 / 3 TFLOP/s.
HBM_BYTES_S = 3.35e12
FP32_FLOPS = 67e12
BF16_FLOPS = 989e12
INT8_OPS = 1979e12
TF32X3_FLOPS = 495e12 / 3

# Stated tolerances |kernel - plain| <= ATOL + RTOL * |plain|. K1 and K2 are
# fp32 with another summation order (the JAX package's fp32 kernel test
# holds 2e-5). K3 rounds its conv operands to bf16 like its plain version,
# but one fp32 ulp of difference in GN+SiLU can move an operand across a
# bf16 rounding boundary, and each such flip moves one product by
# 2^-8 |w h|; with |w h| up to ~0.5 at these inputs, a few flips in one
# output reach ~2e-3 (1.8e-3 measured on the H100). A wrong tap, channel
# or border moves outputs by 1e-1 or more.
#
# K1 on bf16 (both statistics modes) rounds to bf16 where its plain version
# does, so the two differ only where another order of the fp32 sums, or
# another libm rounding of rsqrt or exp, moves a value across a bf16
# rounding boundary: a flipped mean or rstd moves a whole group by one
# ulp, and each later rounding step can add one. 2e-2 + 2e-2 |plain| is about
# five ulps (2^-8 relative) at the outputs' scale, inside the JAX package's
# 3e-2 * max|ref| for its bf16 statistics modes (tests/test_groupnorm.py).
TOL = {"gn_silu": (2e-5, 2e-5), "gn_silu_conv3x3": (5e-3, 5e-3),
       "attn_block": (2e-5, 2e-5), "gn_silu_bf16": (2e-2, 2e-2),
       "attn_block_bb": (2e-5, 2e-5)}
# K2 on bf16, two gates. (1) The JAX package's own criterion for its bf16
# kernel, mean |kernel - reference| / mean |reference| < 2e-2 (tests/
# test_attn_block.py:103). (2) Element by element on the attention part
# P = y - x alone, since x dominates y: |kernel - plain| <= one bf16 ulp of
# |y| (the residual add rounds both) + 2^-4 (|P| + mean |P|). Another order
# of the fp32 sums flips roundings of h, q, k, v, a and the proj, each by
# 2^-8 relative; P moves by a few of them (a fifth of the 2^-4 term in a
# float64-order replica, tests/test_torch_chip_checks.py). A dropped 64-key
# tile, a q/k scale 3% off or uniform weights exceed it several times over.
ATTN_BF16_MEAN_REL = 2e-2
ATTN_BF16_P_REL = 2.0 ** -4


def bf16_ulp(t):
    """The bf16 ulp of |t| (8 significant bits), elementwise, in fp32."""
    e = torch.frexp(t.float().abs().clamp_min(2.0 ** -126))[1]
    return torch.ldexp(torch.ones_like(t, dtype=torch.float32), e - 8)


def attn_bf16_check(out, ref, x, what):
    """Hold K2's bf16 output to its plain version (both gates above).
    Returns (mean rel err, max abs err, worst share): the share is an
    element's error beyond one ulp over its 2^-4 term, and over 1 fails."""
    out, ref, x = out.float(), ref.float(), x.float()
    err = (out - ref).abs()
    rel = (err.mean() / ref.abs().mean()).item()
    p = (ref - x).abs()
    share = ((err - bf16_ulp(torch.maximum(out.abs(), ref.abs())))
             .clamp_min(0) / (ATTN_BF16_P_REL * (p + p.mean())))
    bad = int((share > 1).sum())
    if not torch.isfinite(out).all() or rel >= ATTN_BF16_MEAN_REL or bad:
        raise AssertionError(f"{what}: mean rel err {rel:.3e} (tol "
                             f"{ATTN_BF16_MEAN_REL:g}), {bad} elements over "
                             f"the limit (worst {share.max().item():.3f})")
    return rel, err.max().item(), share.max().item()


def flash_check(out, ref, q, k, v, sm_scale, what):
    """Hold K4 to its plain version, row by row. The kernel rounds each p
    to bf16 before normalising, the plain version after: each moves a term
    p_i v_i by at most 2^-9 p_i |v_i|, so the outputs differ by at most
    2^-8 sum_i p_i |v_i| (times 1 + 2^-4 for the fp32 sums and exp), plus
    one ulp of the output from its two bf16 roundings. Returns (max abs err,
    worst share): an element's error beyond one ulp over its row's term,
    over 1 fails."""
    out, ref = out.float(), ref.float()
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * sm_scale
    pv = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(logits, dim=-1),
                      v.float().abs())
    del logits
    err = (out - ref).abs()
    share = ((err - bf16_ulp(torch.maximum(out.abs(), ref.abs())))
             .clamp_min(0) / (2.0 ** -8 * (1 + 2.0 ** -4) * pv))
    bad = int((share > 1).sum())
    if not torch.isfinite(out).all() or bad:
        raise AssertionError(f"{what}: {bad} elements over the limit (worst "
                             f"{share.max().item():.3f})")
    return err.max().item(), share.max().item()
# K5, the int8 attention block, against its plain version. Its int8
# products are exact, but the GN statistics (another fp32 summation order)
# and the attention core (K2's fp32 core; in bf16 K4's, which rounds p
# before normalising) move the values that are quantised by an fp32 ulp or
# a bf16 rounding, and an element that lies at a rounding boundary then
# flips by one int8 level. One level of one proj input moves output column n
# by up to 127 swp[n] (the largest |w * sa_p| of the column), far more than
# the rounding noise, so each gate has a base limit for the elements no flip
# reached and, beyond it, one such level:
#   fp32: base 2e-4 + 2e-4 |plain|, the JAX package's own limit for
#         _kernel_i8 against its oracle (tests/test_attn_block.py:335);
#   bf16: K2's two gates (ATTN_BF16_MEAN_REL on the mean relative error;
#         base one bf16 ulp of |y| + 2^-4 (|P| + mean |P|) on P = y - x);
# and at most ATTN_I8_FLIP_SHARE of the elements may exceed their base (the
# rows a flip reached: one flip of a proj input reaches about half of its
# row, 0.9% of a (64, 64) element). A wrong dequantisation scale, a missing
# clip or a dropped key tile moves whole columns or rows by more than a level
# (tests/test_torch_chip_checks.py shows each failing on the CPU).
ATTN_I8_FP32_TOL = 2e-4
ATTN_I8_FLIP_SHARE = 2e-2


def calibrated_attn_scales(x, gs, gb, w_qkv, b_qkv, num_heads, eps=1e-5):
    """sa_q and sa_p as calibration records them for this input:
    calib_channel_scale of the fp32 GN output and of the fp32 attention
    output (so that 0.5% of each activation clips, as in sampling)."""
    B, S, C = x.shape
    d = C // num_heads
    g = x.float().reshape(B, S, 32, C // 32)
    mean = g.mean(dim=(1, 3), keepdim=True)
    var = (g - mean).square().mean(dim=(1, 3), keepdim=True)
    h = ((g - mean) * torch.rsqrt(var + eps)).reshape(B, S, C) * gs + gb
    q, k, v = (h @ w_qkv.float() + b_qkv.float()).reshape(
        B, S, 3, num_heads, d).permute(2, 0, 3, 1, 4)
    a = F.scaled_dot_product_attention(q, k, v, scale=d ** -0.5)
    a = a.transpose(1, 2).reshape(B * S, C)
    return (calib_channel_scale(h.reshape(-1, C)), calib_channel_scale(a))


def attn_i8_check(out, ref, x, mats, what):
    """Hold K5 to its plain version (the gates above). Returns (max abs
    err, share of elements over their base limit, worst element beyond its
    base in int8 levels of its column): over 1 level, or too many elements
    over the base, fails."""
    fp32 = x.dtype == torch.float32
    out, ref, x = out.float(), ref.float(), x.float()
    err = (out - ref).abs()
    level = 127.0 * mats.swp.float()
    if fp32:
        base = ATTN_I8_FP32_TOL + ATTN_I8_FP32_TOL * ref.abs()
        rel = 0.0
    else:
        rel = (err.mean() / ref.abs().mean()).item()
        p = (ref - x).abs()
        base = (bf16_ulp(torch.maximum(out.abs(), ref.abs()))
                + ATTN_BF16_P_REL * (p + p.mean()))
    over = (err - base).clamp_min(0)
    share = (over > 0).float().mean().item()
    worst = (over / level).max().item()
    if not torch.isfinite(out).all() or rel >= ATTN_BF16_MEAN_REL \
            or share > ATTN_I8_FLIP_SHARE or worst > 1:
        raise AssertionError(
            f"{what}: over the limit: {share:.2%} of the elements over their "
            f"base limit (at most {ATTN_I8_FLIP_SHARE:.0%}), worst "
            f"{worst:.3f} int8 levels beyond it (at most 1), mean rel err "
            f"{rel:.3e}")
    return err.max().item(), share, worst


# Fixture replay: per-step mean against golden.npz. Unfused (K1, K2) at the
# JAX golden test's 5e-4; fused (K3's bf16 operands) at 2e-2, about three
# times the 6.2e-3 that the same bf16 arithmetic shows on the CPU.
REPLAY_TOL = {False: 5e-4, True: 2e-2}
# E2: mean |fused - flash| of the same seeds' samples (std ~0.47). The two
# paths round differently (K2's fp32 statistics and max-subtracting softmax
# against K1's bf16 one-pass statistics, K4 and the bf16 einsum maps), so
# the trajectories part by bf16 noise: 0.0031 on the H100. The limit is
# about three times that; a fault in one path's kernel moves it further.
E2_FUSED_FLASH_MEAN = 1e-2

INFO = {
    "gn_silu": ("dxmi_tpu_torch/csrc/groupnorm.cu",
                "dxmi_tpu/ops/groupnorm.py:157"),
    "gn_silu_conv3x3": ("dxmi_tpu_torch/csrc/conv_fused.cu",
                        "dxmi_tpu/ops/conv_fused.py:36"),
    "attn_block": ("dxmi_tpu_torch/csrc/attn_block.cu",
                   "dxmi_tpu/ops/attn_block.py:225"),
    "gn_silu_bf16": ("dxmi_tpu_torch/csrc/groupnorm.cu",
                     "dxmi_tpu/ops/groupnorm.py:157"),
    "attn_block_bf16": ("dxmi_tpu_torch/csrc/attn_block.cu",
                        "dxmi_tpu/ops/attn_block.py:225"),
    "flash_attn": ("dxmi_tpu_torch/csrc/flash_attn.cu",
                   "dxmi_tpu/ops/attention.py:53"),
    "attn_block_i8": ("dxmi_tpu_torch/csrc/attn_block_i8.cu",
                      "dxmi_tpu/ops/attn_block.py:353"),
    "int8_conv": ("dxmi_tpu_torch/csrc/int8_conv.cu",
                  "dxmi_tpu/ops/quant.py:68"),
    "int8_conv_s2": ("dxmi_tpu_torch/csrc/int8_conv.cu",
                     "dxmi_tpu/ops/quant.py:68 (stride 2, the Downsample "
                     "of dxmi_tpu/models/unet_small.py:456)"),
    "flash_attn_bwd_dkv": (
        "dxmi_tpu_torch/csrc/flash_attn_bwd.cu",
        "jax/experimental/pallas/ops/tpu/flash_attention.py:796 "
        "(jax.grad of dxmi_tpu/ops/attention.py:53)"),
    "flash_attn_bwd_dq": (
        "dxmi_tpu_torch/csrc/flash_attn_bwd.cu",
        "jax/experimental/pallas/ops/tpu/flash_attention.py:1146 "
        "(jax.grad of dxmi_tpu/ops/attention.py:53)"),
    "attn_block_bwd_bf16": ("dxmi_tpu_torch/csrc/attn_block_bwd.cu",
                            "dxmi_tpu/ops/attn_block.py:406"),
    "attn_block_bb": ("dxmi_tpu_torch/csrc/attn_block_bb.cu",
                      "dxmi_tpu/ops/attn_block.py:261"),
    "gn_silu_conv3x3_bf16": ("dxmi_tpu_torch/csrc/conv_fused.cu",
                             "dxmi_tpu/ops/conv_fused.py:36 (bf16 x)"),
    "attn_block_bf16_d256": ("dxmi_tpu_torch/csrc/attn_block.cu",
                             "dxmi_tpu/ops/attn_block.py:225 (bf16, one "
                             "head of d = 256)"),
    "attn_block_bb_bf16": ("dxmi_tpu_torch/csrc/attn_block.cu",
                           "dxmi_tpu/ops/attn_block.py:261 (bf16, d = 256)"),
}


def adm_int8_calib_draws(seed):
    """The injected draws of the ADM fixture's int8 calibration (two rounds
    of eight samples, T=10, 4 classes, sigma_max 80), NCHW float32, from a
    numpy seed: x0 (2, 8, 3, 16, 16), eps (2, 10, 8, 3, 16, 16), y (2, 8).
    tests/torch_fixtures/make_adm_int8_golden.py feeds JAX the same."""
    rs = np.random.RandomState(seed)
    x0 = rs.randn(2, 8, 3, 16, 16).astype(np.float32) * np.float32(80.0)
    eps = rs.randn(2, 10, 8, 3, 16, 16).astype(np.float32)
    return x0, eps, rs.randint(0, 4, size=(2, 8)).astype(np.int64)


def cifar_int8_calib_draws(seed):
    """The injected draws of the CIFAR fixture's int8 calibration (two
    rounds of 16 samples, T=10), NCHW float32, from a numpy seed: x0 (2, 16,
    3, 16, 16) and eps (2, 10, 16, 3, 16, 16).
    tests/torch_fixtures/make_cifar_int8_golden.py feeds JAX the same."""
    rs = np.random.RandomState(seed)
    return (rs.randn(2, 16, 3, 16, 16).astype(np.float32),
            rs.randn(2, 10, 16, 3, 16, 16).astype(np.float32))


def direction(name, shape):
    """A fixed standard-normal direction for the tensor ``name`` (float64,
    seeded by the name's CRC-32): the golden keeps each parameter update's
    dot product with it."""
    return np.random.RandomState(zlib.crc32(name.encode())).standard_normal(
        shape)


def adm_train_replay(golden, device, attn_impl="einsum"):
    """One DxMITrainerCond iteration of the port on the ADM fixture with the
    case, data, trajectory and draws of ``golden`` (TRAIN_GOLDEN's arrays):
    update_f_v, then update_sampler with the golden's permutation and
    noise. Returns the arrays the golden keeps (``metric/*``, ``log_betas``,
    the update norms and projections), computed the same way."""
    cfg = adm_fixture_config()
    state = load_sampler_state(os.path.join(ADM_FIXTURE_DIR, "sampler.pth"))
    sampler = generate_large.load_sampler(cfg, state, device,
                                          attn_impl=attn_impl,
                                          up_impl="resize", gn_stats="fp32")
    value = instantiate(cfg["value"]).to(device)
    value.load_state_dict(load_value_state(os.path.join(ADM_FIXTURE_DIR,
                                                        "value.pth")))
    tcfg = {k: v for k, v in cfg["trainer"].items() if k != "_target_"}
    trainer = DxMITrainerCond(
        **{**tcfg, "batchsize": int(golden["case/batchsize"])})
    trainer.set_models(sampler, value, lr=float(golden["case/lr"]),
                       v_lr=float(golden["case/v_lr"]),
                       beta_lr=float(golden["case/beta_lr"]))

    def t(name, dtype=None):
        a = torch.from_numpy(np.asarray(golden[name])).to(device)
        return a if dtype is None else a.to(dtype)

    # the trainer reads no policy means: the golden does not keep them
    l_sample = t("l_sample")
    buf = from_d_sample({"l_sample": l_sample,
                         "mean": torch.zeros_like(l_sample[1:]),
                         "sigma": t("sigma"), "logp": t("logp"),
                         "entropy": t("entropy"), "y": t("traj_y")})

    def params():
        return {k: v.detach().double().cpu().clone() for k, v in
                [*value.state_dict().items(),
                 *(("s:net." + k, v)
                   for k, v in sampler.net.state_dict().items())]}

    before = params()
    m = trainer.update_f_v(t("img"), buf, y=t("y"))
    m.update(trainer.update_sampler(buf, perm=t("perm"),
                                    noise=list(t("noise"))))
    out = {f"metric/{k}": v.float().cpu().numpy() for k, v in m.items()}
    out["log_betas"] = sampler.log_betas.detach().cpu().numpy()
    after = params()
    for key, b in before.items():
        tag, name = ("s", key[2:]) if key.startswith("s:") else ("v", key)
        delta = (after[key] - b).numpy()
        out[f"{tag}norm/{name}"] = np.float64(np.linalg.norm(delta))
        out[f"{tag}proj/{name}"] = np.float64(
            (delta * direction(name, delta.shape)).sum())
    out["nan_guard_skips"] = trainer.nan_guard_skips
    return out


CIFAR_TRAIN_GOLDEN = os.path.join(REPO, "tests", "torch_fixtures",
                                  "cifar_train_golden.npz")


def golden_dropout_masks(golden, device):
    """The golden's dropout keep masks (bool, NCHW) in call order."""
    out = []
    for i in range(len([k for k in golden if k.startswith("dropout/")])):
        shape = tuple(int(n) for n in golden[f"dropout_shape/{i:02d}"])
        bits = np.unpackbits(golden[f"dropout/{i:02d}"])[:int(np.prod(shape))]
        out.append(torch.from_numpy(bits.reshape(shape).astype(bool)).to(
            device))
    return out


def cifar_train_replay(golden, device, attn_impl="einsum", fuse=False,
                       block_b=None, levers=False):
    """One DxMITrainer iteration of the port on the CIFAR fixture with the
    case, data, trajectory and draws of ``golden`` (CIFAR_TRAIN_GOLDEN's
    arrays, dropout masks included): update_f_v, then update_sampler with
    the golden's permutation, noise and masks. ``attn_impl``, ``fuse``
    (fuse_gn_conv) and ``block_b`` choose the net's paths; ``levers``
    builds the nets as ``train_cifar10 --fast_levers`` does. Returns the
    arrays the golden keeps, computed the same way."""
    cfg = fixture_config()
    state = load_sampler_state(os.path.join(FIXTURE_DIR, "sampler_best.pth"))
    lever = ({k: v for k, v in train_cifar10.LEVER_NET.items()
              if k != "dtype"} if levers else {})
    sampler = load_sampler(cfg, state, device, dtype="bf16" if levers
                           else "fp32", fuse_gn_conv=fuse,
                           attn_impl=attn_impl, block_b=block_b, **lever)
    vcfg = cfg["value"]
    if levers:
        vcfg = {**vcfg, "net": {**vcfg["net"],
                                **train_cifar10.LEVER_VALUE_NET}}
    value = instantiate(vcfg).to(device)
    value.load_state_dict(load_value_state(os.path.join(FIXTURE_DIR,
                                                        "value_best.pth")))
    tcfg = {k: v for k, v in cfg["trainer"].items() if k != "_target_"}
    trainer = DxMITrainer(**{**tcfg, "batchsize": int(golden["case/batchsize"]),
                             "n_timesteps": sampler.n_timesteps})
    trainer.set_models(sampler, value, lr=float(golden["case/lr"]),
                       v_lr=float(golden["case/v_lr"]),
                       beta_lr=float(golden["case/beta_lr"]))

    def t(name):
        return torch.from_numpy(np.asarray(golden[name])).to(device)

    # the trainer reads no policy means: the golden does not keep them
    l_sample = t("l_sample")
    buf = from_d_sample({"l_sample": l_sample,
                         "mean": torch.zeros_like(l_sample[1:]),
                         "sigma": t("sigma"), "logp": t("logp"),
                         "entropy": t("entropy")})

    def params():
        return {k: v.detach().double().cpu().clone() for k, v in
                [*value.state_dict().items(),
                 *(("s:net." + k, v)
                   for k, v in sampler.net.state_dict().items())]}

    before = params()
    m = trainer.update_f_v(t("img"), buf)
    sampler.net.inject_dropout_masks(golden_dropout_masks(golden, device))
    m.update(trainer.update_sampler(buf, perm=t("perm"),
                                    noise=list(t("noise"))))
    left = len(sampler.net.dropout_masks.queue)
    sampler.net.inject_dropout_masks(None)
    if left:
        raise AssertionError(f"{left} injected dropout masks not used")
    out = {f"metric/{k}": v.float().cpu().numpy() for k, v in m.items()}
    out["log_betas"] = sampler.log_betas.detach().cpu().numpy()
    after = params()
    for key, b in before.items():
        tag, name = ("s", key[2:]) if key.startswith("s:") else ("v", key)
        delta = (after[key] - b).numpy()
        out[f"{tag}norm/{name}"] = np.float64(np.linalg.norm(delta))
        out[f"{tag}proj/{name}"] = np.float64(
            (delta * direction(name, delta.shape)).sum())
    out["nan_guard_skips"] = trainer.nan_guard_skips
    return out


class PhaseError(Exception):
    pass


PHASES = ("B", "K", "T", "T-bwd", "G", "G-int8", "G-bf16", "E", "E-int8",
          "E-bf16", "G2", "G2-int8", "E2", "E2-int8", "G3", "E3", "G4", "E4",
          "E4-levers", "T-K1", "T-K3", "C")


def run_phase(name, fn):
    t0 = time.perf_counter()
    try:
        out = fn()
        torch.cuda.synchronize()
    except Exception as e:
        traceback.print_exc()
        raise PhaseError(f"phase {name} failed: {e}") from e
    print(f"phase {name}: ok in {time.perf_counter() - t0:.1f} s", flush=True)
    return out


def randn(gen, *shape, scale=1.0, shift=0.0):
    return torch.randn(shape, generator=gen, device="cuda") * scale + shift


def max_err(a, b, name):
    atol, rtol = TOL[name]
    err = (a - b).abs()
    bad = err > atol + rtol * b.abs()
    if not torch.isfinite(a).all() or bad.any():
        raise AssertionError(f"{name}: {int(bad.sum())} elements off, max "
                             f"abs err {err.max().item():.3e}")
    return err.max().item()


# ---- the kernels' cases at the main path's shapes ----------------------

def gn_case(gen, B, HW, C, silu):
    x = randn(gen, B, HW, C, scale=2.0, shift=0.5)
    return (x, randn(gen, C, scale=0.1, shift=1.0), randn(gen, C, scale=0.1),
            32, 1e-6, silu)


def conv_case(gen, B, R, Cin, Cout, W=None):
    """K3's arguments for a (B, R, W or R, Cin) input."""
    return (randn(gen, B, R, W or R, Cin, scale=2.0, shift=0.5),
            randn(gen, Cin, scale=0.1, shift=1.0), randn(gen, Cin, scale=0.1),
            randn(gen, 3, 3, Cin, Cout, scale=(9 * Cin) ** -0.5),
            randn(gen, Cout, scale=0.1), 32, 1e-6)


def conv_bf16_check(out, ref, what):
    """Hold K3 on bf16 x to its plain version: TOL["gn_silu_conv3x3"] (the
    operand flips of the fp32 form) plus one bf16 ulp of |y|, since such a
    flip or another fp32 sum order can move y's one rounding across a
    boundary (1.5e-3 beyond the ulp at most on an H100 80GB HBM3 at
    700 W, PERF.md); returns the max abs err."""
    atol, rtol = TOL["gn_silu_conv3x3"]
    out, ref = out.float(), ref.float()
    err = (out - ref).abs()
    lim = bf16_ulp(torch.maximum(out.abs(), ref.abs())) + atol + rtol * ref.abs()
    bad = err > lim
    if not torch.isfinite(out).all() or bad.any():
        raise AssertionError(f"{what}: {int(bad.sum())} elements off, max abs "
                             f"err {err.max().item():.3e}")
    return err.max().item()


def conv_check(out, ref, what):
    """Hold K3 to its plain version at TOL["gn_silu_conv3x3"] (reasoned
    there); returns the max abs err."""
    try:
        return max_err(out, ref, "gn_silu_conv3x3")
    except AssertionError as e:
        raise AssertionError(f"{what}: {e}") from None


def conv_work(B, H, W, Cin, Cout, esize=4):
    """(bytes, ops) of one K3 call: x read once, the fp32 kernel and the
    GroupNorm and bias parameters read once, y written once (x and y of
    ``esize`` bytes); the conv's bf16 products and ~11 fp32 operations of
    GN and SiLU an input element."""
    M = B * H * W
    return ((M * Cin + M * Cout) * esize
            + (9 * Cin * Cout + 2 * Cin + Cout) * 4,
            {"bf16": 2 * M * Cout * 9 * Cin, "fp32": 11 * M * Cin})


def conv_library(a):
    """One PyTorch call chain for K3's function on the same inputs
    (F.group_norm, F.silu, a cuDNN bf16 conv), K3's library yardstick."""
    x_nchw = a[0].permute(0, 3, 1, 2)
    w_lib = a[3].permute(3, 2, 0, 1).to(torch.bfloat16).contiguous(
        memory_format=torch.channels_last)
    b_lib = a[4].to(torch.bfloat16)
    gs, gb = a[1].to(x_nchw.dtype), a[2].to(x_nchw.dtype)
    return lambda: F.conv2d(  # noqa: E731
        F.silu(F.group_norm(x_nchw, 32, gs, gb, 1e-6)).bfloat16(),
        w_lib, b_lib, padding=1)


def attn_case(gen, B, S, C):
    return (randn(gen, B, S, C, scale=2.0, shift=0.5),
            randn(gen, C, scale=0.1, shift=1.0), randn(gen, C, scale=0.1),
            randn(gen, C, 3 * C, scale=C ** -0.5), randn(gen, 3 * C, scale=0.1),
            randn(gen, C, C, scale=C ** -0.5), randn(gen, C, scale=0.1))


# GroupNorm inputs of K1 and K3 on the main path: norm_out (32x32, C=128,
# SiLU) and the mid attention norm (4x4, C=256); every (res, Cin, Cout) of
# the 22 ResnetBlocks' convs; the 16x16 attention blocks.
GN_SHAPES = [(BATCH, 1024, 128, True), (BATCH, 16, 256, False)]
CONV_SHAPES = [(BATCH, 32, 128, 128), (BATCH, 32, 384, 128),
               (BATCH, 32, 256, 128), (BATCH, 16, 128, 256),
               (BATCH, 16, 256, 256), (BATCH, 16, 512, 256),
               (BATCH, 16, 384, 256), (BATCH, 8, 256, 256),
               (BATCH, 8, 512, 256), (BATCH, 4, 256, 256),
               (BATCH, 4, 512, 256)]
# K2 fp32 at generation's batch and at E4's training batch and sampling
# chunk (the timed row is the first)
ATTN_SHAPES = [(BATCH, 256, 256), (128, 256, 256), (32, 256, 256)]
# ImageNet64 (bf16): K1 at the widest decoder input (8x8, C=1536, 48 channels
# per group) and the 64x64 maps (C=192), both statistics modes; K2 at the
# three attention maps; K4 at the 32x32 maps.
ADM_GN_SHAPES = [(BATCH, 4096, 192, True), (BATCH, 64, 1536, True)]
GN_MODES = ("bf16_onepass", "fp32")
ADM_ATTN_SHAPES = [(BATCH, 1024, 384, 6), (BATCH, 256, 576, 9),
                   (BATCH, 64, 768, 12)]
# K2 bf16 also at E3 fused_train's forward (training.batchsize 128, 32x32)
E3_ATTN_SHAPE = (128, 1024, 384, 6)
FLASH_SHAPES = [(BATCH, 1024, 6, 64)]
# K4's other launches on the main paths: the cores of K2 bf16 and K5 at the
# 16x16 and 8x8 maps, and E3's training forward at batch 128
FLASH_TIME_SHAPES = [(BATCH, 256, 9, 64), (BATCH, 64, 12, 64),
                     (128, 1024, 6, 64)]


# K5 (int8 attention block): fp32 at the trained ADM fixture's 8x8 map (batch
# 8), bf16 at ImageNet64's three maps and at LSUN's C=1024 maps, which only
# the int8 gate admits. K8 (int8 conv): the widest ImageNet64 3x3 conv
# (8x8, 1536 -> 768), the 32x32 up-block's four 2x2 phase convs, a 64x64
# conv, fixture convs in fp32 (static, and dynamic: a scalar scale), the
# commonest 64x64 and 16x16 convs, and Cin = 96 in bf16 (half of the last
# 64-channel chunk).
I8_ATTN_SHAPES = [(8, 64, 64, 2, torch.float32),
                  (BATCH, 1024, 384, 6, torch.bfloat16),
                  (BATCH, 256, 576, 9, torch.bfloat16),
                  (BATCH, 64, 768, 12, torch.bfloat16),
                  (BATCH, 256, 1024, 16, torch.bfloat16)]
PHASE_PADS = [((1, 0), (1, 0)), ((1, 0), (0, 1)), ((0, 1), (1, 0)),
              ((0, 1), (0, 1))]
I8_CONV_SHAPES = ([(BATCH, 8, 1536, 768, SAME_3X3, torch.bfloat16, False)]
                  + [(BATCH, 32, 384, 384, pad, torch.bfloat16, False)
                     for pad in PHASE_PADS]
                  + [(BATCH, 64, 384, 192, SAME_3X3, torch.bfloat16, False),
                     (8, 16, 96, 32, SAME_3X3, torch.float32, False),
                     (8, 16, 96, 32, SAME_3X3, torch.float32, True),
                     (BATCH, 64, 192, 192, SAME_3X3, torch.bfloat16, False),
                     (BATCH, 16, 576, 576, SAME_3X3, torch.bfloat16, False),
                     (8, 16, 96, 64, SAME_3X3, torch.bfloat16, False)])

# K8 at the CIFAR-10 net's int8 shapes (E-int8), as conv_i8_case's
# arguments with the kernel size and stride: the stride-2 Downsample convs
# on the (0, 1)-padded maps (33, 17, 9 -> 16, 8, 4) in fp32 ((a)'s torso)
# and bf16 ((b) at batch 96), the first the kernels record's row; then
# stride-1 convs: 3x3 at 32x32 (the widest decoder input, 384) and 4x4, the
# attention 1x1s at 16x16, a nin_shortcut 1x1 and a 2x2 phase conv of (b)'s
# 16x16 -> 32x32 Upsample.
VALID = ((0, 0), (0, 0))
CIFAR_I8_CONV_SHAPES = (
    [(BATCH, R, C, C, VALID, torch.float32, False, 3, 2)
     for R, C in ((33, 128), (17, 256), (9, 256))]
    + [(96, R, C, C, VALID, torch.bfloat16, False, 3, 2)
       for R, C in ((33, 128), (17, 256), (9, 256))]
    + [(BATCH, 32, 128, 128, SAME_3X3, torch.float32, False, 3, 1),
       (BATCH, 32, 384, 128, SAME_3X3, torch.float32, False, 3, 1),
       (BATCH, 16, 256, 256, VALID, torch.float32, False, 1, 1),
       (BATCH, 4, 512, 256, SAME_3X3, torch.float32, False, 3, 1),
       (96, 32, 128, 128, SAME_3X3, torch.bfloat16, False, 3, 1),
       (96, 32, 384, 128, VALID, torch.bfloat16, False, 1, 1),
       (96, 16, 256, 256, PHASE_PADS[0], torch.bfloat16, False, 2, 1)])
# K1 at the CIFAR-10 net's bf16 shapes (E-int8's (a) bf16 and (b)): every
# (HW, C) of its GroupNorms, 4, 8, 12 and 16 channels a group, at batch 100
# and 96, both statistics modes
CIFAR_GN_BF16_SHAPES = [
    (B, HW, C, silu) for B in (BATCH, 96)
    for HW, C, silu in ((1024, 128, True), (1024, 256, True),
                        (1024, 384, True), (1024, 128, False),
                        (256, 256, True), (256, 384, True), (256, 512, True),
                        (256, 256, False), (64, 256, True), (64, 512, True),
                        (16, 256, True), (16, 512, True))]


def attn_i8_case(gen, B, S, C, nh, dtype):
    """attn_case's distributions in ``dtype`` with the activation scales
    that calibration records for them; returns the wrapper's arguments."""
    x, gs, gb, wq, bq, wp, bp = attn_case(gen, B, S, C)
    sa_q, sa_p = calibrated_attn_scales(x, gs, gb, wq, bq, nh)
    return (x.to(dtype), gs, gb, prep_int8_mats(wq, wp, sa_q, sa_p), bq, bp)


def conv_i8_case(gen, B, R, Cin, Cout, pad, dtype, dynamic, k=None,
                 stride=1):
    """An NHWC input and prepared int8 weights of a k x k conv (3x3 at SAME
    padding, else 2x2, unless ``k`` is given): per-channel activation
    scales at the input's 0.995 quantile, or (dynamic) a scalar max / 127;
    ``stride`` is passed on."""
    x = randn(gen, B, R, R, Cin, scale=2.0, shift=0.3).to(dtype)
    kh = k or (3 if pad == SAME_3X3 else 2)
    w = randn(gen, kh, kh, Cin, Cout, scale=(kh * kh * Cin) ** -0.5)
    if dynamic:
        a = torch.clamp(x.float().abs().amax(), min=1e-8) / 127.0
    else:
        a = calib_channel_scale(x.reshape(-1, Cin))
    b = randn(gen, Cout, scale=0.1)
    return x, prepare_conv_static(w, a), b, pad, dtype, stride


def k8_library(x, q, pad, stride=1):
    """K8's library call: torch._int_mm on the int8 im2col matrix (built
    here, outside the timed call) and the int8 weights; returns the call."""
    B, H, W, Cin = x.shape
    Cout, kh, kw, _ = q.w_i8.shape
    (pt, pb), (pl, pr) = pad
    Ho, Wo = out_size(H, W, kh, kw, pad, stride)
    xq = x.float() / q.xscale if q.divide else x.float() * q.xscale
    xi = torch.clamp(torch.round(xq), -127, 127)
    cols = F.pad(xi.permute(0, 3, 1, 2), (pl, pr, pt, pb))
    cols = torch.stack([cols[:, :, ty:ty + stride * (Ho - 1) + 1:stride,
                             tx:tx + stride * (Wo - 1) + 1:stride]
                        for ty in range(kh) for tx in range(kw)], -1)
    cols = cols.permute(0, 2, 3, 4, 1).reshape(B * Ho * Wo, -1).to(torch.int8)
    w = q.w_i8.reshape(Cout, -1).t()
    return lambda: torch._int_mm(cols, w)


def k8_work(B, Ho, Wo, Cin, Cout, kh, kw, H, W, esize_x, esize_y):
    """(bytes, ops) of one K8 call: x read once, y written once, the int8
    weights and the fp32 scales and bias; the int8 products over the output
    positions, the quantising and the epilogue in fp32."""
    M, K = B * Ho * Wo, kh * kw * Cin
    nbytes = (B * H * W * Cin * esize_x + M * Cout * esize_y + Cout * K
              + (Cin + 2 * Cout) * 4)
    return nbytes, {"int8": 2 * M * Cout * K,
                    "fp32": 2 * B * H * W * Cin + 3 * M * Cout}


def gn_bf16_case(gen, B, HW, C, silu, stats):
    return (randn(gen, B, HW, C, scale=2.0, shift=0.5).bfloat16(),
            randn(gen, C, scale=0.1, shift=1.0), randn(gen, C, scale=0.1),
            32, 1e-5, silu, stats)


def attn_bf16_case(gen, B, S, C):
    x, gs, gb, *w = attn_case(gen, B, S, C)
    return (x.bfloat16(), gs, gb, *(t.bfloat16() for t in w))


def flash_case(gen, B, S, nh, d):
    return (*(randn(gen, B, S, nh, d).bfloat16() for _ in range(3)),
            d ** -0.5)


# ---- the training slice: K4-dkv, K4-dq, K6, G3, E3 -----------------------

TRAIN_BATCH = 128  # training.batchsize of configs/imagenet64/T10.yaml
# Phase K holds the backward kernels at E3's shapes (batch 128), where K6's
# wrapper takes 32, 8 and 2 slices of the rows for its weight GEMMs and
# 128, 32 and 8 chunks for its bias sums at the 32x32, 16x16 and 8x8 maps.
#
# K4's logsumexp (the training residual of the forward) against the plain
# version's, fp32: |kernel - plain| <= FLASH_LSE_ATOL. Both take
# lse = m + log(sum exp(s - m)) over fp32 logits s of bf16 q, k, and differ
# by the order of the fp32 sums: a logit (64 exact products) by at most
# 64 * 2^-24 * sum |q k| * sm_scale, about 2e-5 at these inputs, and the
# sum of 1024 terms in [0, 1] by at most 1024 * 2^-24 = 6e-5 of itself, so
# 6e-5 in lse; 1e-4 holds both (1.4e-6 measured on the H100, 9.5e-7 on a
# CPU replica of the kernel's sums). An ln/log2 unit slip moves lse (~7.4 here)
# by 30% (about 2), one off by log 2 by 0.69, another row's value by the
# rows' spread (~0.1) (tests/test_torch_chip_checks.py).
FLASH_LSE_ATOL = 1e-4
# K4-dkv and K4-dq on the card, against their plain versions at the 32x32
# maps, from the kernel forward's o and lse (the same inputs on both sides).
# Both follow the TPU bodies' roundings (p and ds rounded to bf16 before
# their products, fp32 sums, the gradients rounded once), so they differ
# only by another order of the fp32 sums and exp: a rounding of p or ds
# flips where a value lies at a bf16 boundary (rare), and the final
# rounding of a sum can land one ulp apart. Two gates per gradient: mean
# |kernel - plain| / mean |plain| below 2^-10 (3.4e-8 measured on the H100
# at batch 128), and element by element at most two bf16 ulps of the larger
# of the two plus 2^-5 mean |plain| (an element near zero that a flipped
# term 2^-8 |p do| reached: 0.006 of the mean at worst between the plain
# version and JAX's kernel on the CPU, tests/test_torch_flash_bwd.py). dk
# and dv swapped, a dropped 64-key tile or di left out move the mean error
# by 1/16 or more (tests/test_torch_chip_checks.py).
FLASH_BWD_MEAN_REL = 2.0 ** -10
# The chain: kernel forward and backward against the plain forward and
# backward, so that a wrong logsumexp or o cannot pass by entering both
# sides. K4 rounds p before it normalises, so about half of o's elements
# lie one bf16 ulp from the plain o, and di = rowsum(o do) moves with
# them: dq and dk move by 6.8e-4 of their mean on the CPU (a replica of
# K4's forward, tests/test_torch_chip_checks.py test_flash_bwd_chain_check)
# and on the H100, dv by 6e-6. The chain's gate is the mean alone, at 2^-8, almost six times
# that; lse off by log 2 doubles p and every dv.
FLASH_CHAIN_MEAN_REL = 2.0 ** -8
# K6 on bf16: its recompute of h and qkv takes fp32 statistics in another
# order (two-pass where the TPU body is one-pass), so a few elements of h,
# qkv, w and dlg round the other way, and each moves the sums it enters by
# 2^-8 of its term: mean |kernel - plain| / mean |plain| of each parameter
# cotangent below 5e-3 (3.8e-4 at worst measured on the H100 at batch
# 128), of dx below 1e-3 (1.7e-4 at batch 16: dx sums terms that both
# round alike), and max |kernel - plain| below 2^-4 max |plain| (6.3e-3 at
# batch 16-32). The cotangent ct
# is drawn with a mean (0.5) as a loss gives, so that the GroupNorm
# backward's mean terms matter: without the hp mean(dhp hp) term dx moves
# by 1.7e-3 or more, without mean(dhp) by 4e-2; dgs and dgb swapped or a
# dropped key tile move a parameter cotangent by 10% or more
# (tests/test_torch_chip_checks.py). On fp32: the JAX package's own limits
# for its backward kernel, 5e-4 + 5e-4 |plain| (tests/test_attn_block.py:
# 466).
ATTN_BWD_BF16_MEAN_REL = 5e-3
ATTN_BWD_BF16_DX_MEAN_REL = 1e-3
ATTN_BWD_BF16_MAX_REL = 2.0 ** -4
ATTN_BWD_FP32_TOL = 5e-4
ATTN_BWD_NAMES = ("dx", "dgs", "dgb", "dw_qkv", "db_qkv", "dw_proj", "db_proj")
# The main path's shapes, then the tensor-core kernels' edges: K4-dkv and
# K4-dq at d = 32, d = 40 and d = 24 (zero-padded to 64 and 32 in shared
# memory) inside the flash gate; K6 (whose dq pass is K4-dq) at a single
# 64-row tile with d = 32, at d = 40 and d = 24 (padded head dims), and at
# d = 36, whose heads start off 16 bytes (8-byte loads).
FLASH_BWD_SHAPES = [(TRAIN_BATCH, 1024, 6, 64), (16, 512, 4, 32),
                    (16, 512, 3, 40), (16, 512, 4, 24)]
ATTN_BWD_SHAPES = [(TRAIN_BATCH, 1024, 384, 6, torch.bfloat16),
                   (TRAIN_BATCH, 256, 576, 9, torch.bfloat16),
                   (TRAIN_BATCH, 64, 768, 12, torch.bfloat16),
                   (8, 64, 64, 2, torch.float32),
                   (16, 64, 256, 8, torch.bfloat16),
                   (16, 128, 320, 8, torch.bfloat16),
                   (16, 256, 192, 8, torch.bfloat16),
                   (16, 64, 288, 8, torch.bfloat16)]


def flash_lse_check(lse, ref, what):
    """Hold K4's logsumexp to the plain version's; returns max abs err."""
    err = (lse - ref).abs().max().item()
    if not torch.isfinite(lse).all() or not err <= FLASH_LSE_ATOL:
        raise AssertionError(f"{what}: logsumexp {err:.3e} from the plain "
                             f"version's (tol {FLASH_LSE_ATOL:g})")
    return err


def flash_bwd_check(out, ref, what, mean_rel=FLASH_BWD_MEAN_REL,
                    elementwise=True):
    """Hold one K4 gradient to its plain version (the gates above; the
    chain's: ``mean_rel=FLASH_CHAIN_MEAN_REL, elementwise=False``); returns
    (mean rel err, max abs err)."""
    out, ref = out.float(), ref.float()
    err = (out - ref).abs()
    rel = (err.mean() / ref.abs().mean()).item()
    bad = 0
    if elementwise:
        limit = (2 * bf16_ulp(torch.maximum(out.abs(), ref.abs()))
                 + 2.0 ** -5 * ref.abs().mean())
        bad = int((err > limit).sum())
    if not torch.isfinite(out).all() or not rel < mean_rel or bad:
        raise AssertionError(f"{what}: mean rel err {rel:.3e} (tol "
                             f"{mean_rel:.3e}), {bad} elements over the "
                             "limit")
    return rel, err.max().item()


def attn_bwd_check(outs, refs, dtype, what):
    """Hold K6's seven cotangents to its plain version; returns the worst
    (mean rel err, max abs err) over them."""
    worst = (0.0, 0.0)
    for name, out, ref in zip(ATTN_BWD_NAMES, outs, refs):
        out, ref = out.float(), ref.float()
        err = (out - ref).abs()
        rel = (err.mean() / ref.abs().mean()).item()
        if dtype == torch.float32:
            ok = bool((err <= ATTN_BWD_FP32_TOL
                       + ATTN_BWD_FP32_TOL * ref.abs()).all())
        else:
            limit = (ATTN_BWD_BF16_DX_MEAN_REL if name == "dx"
                     else ATTN_BWD_BF16_MEAN_REL)
            ok = (rel < limit and err.max().item()
                  <= ATTN_BWD_BF16_MAX_REL * ref.abs().max().item())
        if not torch.isfinite(out).all() or not ok:
            raise AssertionError(f"{what} {name}: mean rel err {rel:.3e}, "
                                 f"max abs err {err.max().item():.3e} of "
                                 f"max |plain| {ref.abs().max().item():.3e}")
        worst = (max(worst[0], rel), max(worst[1], err.max().item()))
    return worst


def flash_bwd_case(gen, B, S, nh, d):
    """qkv, o, lse and a cotangent do of the 32x32 attention (bf16)."""
    qkv = randn(gen, B, S, 3, nh, d).bfloat16()
    sm = d ** -0.5
    o, lse = flash_mha_fwd(qkv, sm)
    return qkv, o, lse, randn(gen, B, S, nh, d).bfloat16(), sm


def attn_bwd_case(gen, B, S, C, dtype):
    """x, ct and the parameters of an attention block (weights, biases and
    x in ``dtype``, GroupNorm parameters fp32)."""
    x, gs, gb, wq, bq, wp, _ = attn_case(gen, B, S, C)
    ct = randn(gen, B, S, C, shift=0.5)
    return (x.to(dtype), ct.to(dtype), gs, gb, wq.to(dtype), bq.to(dtype),
            wp.to(dtype))


def phase_kernels_train(gen, errs):
    """K for the backward kernels (adds to ``errs``)."""
    for shape in FLASH_BWD_SHAPES:
        qkv, o, lse, do, sm = flash_bwd_case(gen, *shape)
        q, k, v = qkv.unbind(2)
        o_p, lse_p = flash_mha_reference_fwd(q, k, v, sm)
        lse_err = flash_lse_check(lse, lse_p, f"flash_attn lse {shape}")
        _, share = flash_check(o, o_p, q, k, v, sm, f"flash_attn o {shape}")
        print(f"  K flash_attn with logsumexp {shape}: lse max abs err "
              f"{lse_err:.3e} (tol {FLASH_LSE_ATOL:g}); o at {share:.3f} of "
              "its limit")
        got = flash_mha_bwd(qkv, o, lse, do, sm)
        ref = flash_mha_reference_bwd(qkv, o, lse, do, sm)
        chain = flash_mha_reference_bwd(qkv, o_p, lse_p, do, sm)
        del o_p, lse_p
        for i, name in ((1, "dk"), (2, "dv"), (0, "dq")):
            what = f"flash_attn_bwd {name} {shape}"
            rel, err = flash_bwd_check(got[:, :, i], ref[:, :, i], what)
            crel, _ = flash_bwd_check(got[:, :, i], chain[:, :, i],
                                      f"{what} chained",
                                      mean_rel=FLASH_CHAIN_MEAN_REL,
                                      elementwise=False)
            kernel = "flash_attn_bwd_dq" if i == 0 else "flash_attn_bwd_dkv"
            errs[kernel] = max(errs.get(kernel, 0.0), err)
            print(f"  K {kernel} {name} {shape}: mean rel err {rel:.3e} (tol "
                  f"{FLASH_BWD_MEAN_REL:.3e}), max abs err {err:.3e}; "
                  f"chained from the plain forward {crel:.3e} (tol "
                  f"{FLASH_CHAIN_MEAN_REL:.3e})")
        del ref, chain
        again = flash_mha_bwd(qkv, o, lse, do, sm)
        if not torch.equal(got, again):
            raise AssertionError("flash_attn_bwd: a replay differs")
        del qkv, o, lse, do, got, again
        torch.cuda.empty_cache()
    for B, S, C, nh, dt in ATTN_BWD_SHAPES:
        a = attn_bwd_case(gen, B, S, C, dt)
        outs = attn_block_bwd(*a, nh)
        refs = attn_block_bwd_reference(*a, nh)
        what = f"attn_block_bwd {(B, S, C, nh)} {str(dt)[6:]}"
        rel, err = attn_bwd_check(outs, refs, dt, what)
        again = attn_block_bwd(*a, nh)
        if not all(torch.equal(u, v) for u, v in zip(outs, again)):
            raise AssertionError(f"{what}: a replay differs")
        name = "attn_block_bwd_bf16" if dt == torch.bfloat16 \
            else "attn_block_bwd"
        errs[name] = max(errs.get(name, 0.0), err)
        M = B * S
        print(f"  K {what}: worst mean rel err {rel:.3e}, max abs err "
              f"{err:.3e} over dx and the six parameter cotangents; replay "
              f"bit-equal; "
              f"{max(1, min(BWD_MAX_SLICES, M // BWD_ROWS_PER_SLICE))} "
              f"slices, {-(-M // BWD_ROWS_PER_CHUNK)} chunks")
        del a, outs, refs, again
        torch.cuda.empty_cache()


def train_time_rows(gen):
    """T rows of K4-dkv, K4-dq (at the 32x32 map, batch 128) and K6 bf16
    (the three maps at batch 128; the first is the recorded row). Library
    yardsticks: the backward alone of autograd through
    F.scaled_dot_product_attention (one call gives dq, dk and dv), and of
    the library composition that K2's row times."""
    rows = {}
    B, S, nh, d = TRAIN_BATCH, 1024, 6, 64
    qkv, o, lse, do, sm = flash_bwd_case(gen, B, S, nh, d)
    di, dqkv = flash_bwd_dkv(qkv, o, lse, do, sm)
    qt, kt, vt = (qkv[:, :, i].transpose(1, 2).detach().clone()
                  .requires_grad_(True) for i in range(3))
    ot = F.scaled_dot_product_attention(qt, kt, vt, scale=sm)
    dot = do.transpose(1, 2).contiguous()
    lib_ms = time_ms(lambda: torch.autograd.grad(
        ot, (qt, kt, vt), dot, retain_graph=True))
    n, st = B * S * nh * d, B * nh * S
    rows["flash_attn_bwd_dkv"] = dict(
        ms=time_ms(lambda: flash_bwd_dkv(qkv, o, lse, do, sm, dqkv)),
        plain_ms=time_ms(lambda: flash_reference_dkv(qkv, o, lse, do, sm),
                         iters=3, warmup=1),
        library_ms=lib_ms,
        # q, k, v, o, do read, lse read, di written, dk, dv written
        bytes=(5 * n + 2 * n) * 2 + 2 * st * 4,
        # s, dp, dv and dk products; exp and ds per logit; di
        ops={"bf16": 4 * 2 * B * nh * S * S * d,
             "fp32": 6 * B * nh * S * S + 2 * n})
    rows["flash_attn_bwd_dq"] = dict(
        ms=time_ms(lambda: flash_bwd_dq(qkv, do, lse, di, dqkv, sm)),
        plain_ms=time_ms(lambda: flash_reference_dq(qkv, o, lse, do, sm),
                         iters=3, warmup=1),
        library_ms=lib_ms,
        # q, k, v, do read, lse and di read, dq written
        bytes=5 * n * 2 + 2 * st * 4,
        ops={"bf16": 3 * 2 * B * nh * S * S * d,
             "fp32": 6 * B * nh * S * S})
    del qkv, o, lse, do, di, dqkv, qt, kt, vt, ot, dot
    torch.cuda.empty_cache()
    for i, (S, C, nh) in enumerate([(1024, 384, 6), (256, 576, 9),
                                    (64, 768, 12)]):
        a = attn_bwd_case(gen, TRAIN_BATCH, S, C, torch.bfloat16)
        x, ct, gs, gb, wq, bq, wp = a
        d = C // nh
        xl = x.detach().clone().requires_grad_(True)
        pl = [t.detach().clone().requires_grad_(True)
              for t in (gs, gb, wq, bq, wp)]

        def library_fwd():
            g = F.group_norm(xl.transpose(1, 2), 32, pl[0].bfloat16(),
                             pl[1].bfloat16(), 1e-5).transpose(1, 2)
            q, k, v = (g @ pl[2] + pl[3]).reshape(
                TRAIN_BATCH, S, 3, nh, d).permute(2, 0, 3, 1, 4)
            o = F.scaled_dot_product_attention(q, k, v, scale=d ** -0.5)
            return xl + o.transpose(1, 2).reshape(TRAIN_BATCH, S, C) @ pl[4]

        y = library_fwd()
        M = TRAIN_BATCH * S
        name = ("attn_block_bwd_bf16" if i == 0 else
                f"attn_block_bwd_bf16 {(TRAIN_BATCH, S, C, nh)}")
        rows[name] = dict(
            ms=time_ms(lambda: attn_block_bwd(*a, nh), iters=10),
            plain_ms=time_ms(lambda: attn_block_bwd_reference(*a, nh),
                             iters=2, warmup=1),
            library_ms=time_ms(lambda: torch.autograd.grad(
                y, [xl, *pl], ct, retain_graph=True), iters=10),
            # x, ct read and dx written (bf16); weights read; fp32
            # cotangents of every parameter written
            bytes=3 * M * C * 2 + 4 * C * C * 2 + (4 * C * C + 6 * C) * 4,
            # qkv recompute, da, dh, dW_qkv, dW_proj (11 M C^2 multiply-
            # adds); logits, a, dv, da v^T, dq, dk (6 B nh S^2 d); softmax
            # and its backward (~8 per logit); GroupNorm forward and
            # backward (~20 per element)
            ops={"bf16": 2 * 11 * M * C * C + 2 * 6 * TRAIN_BATCH * nh * S
                 * S * d, "fp32": 8 * TRAIN_BATCH * nh * S * S + 20 * M * C})
        del a, x, ct, xl, pl, y
        torch.cuda.empty_cache()
    rows["attn_block_bwd"] = k6_fp32_time_row(gen)
    return rows


def k6_fp32_time_row(gen):
    """T row of K6's fp32 form (SIMT) at G3's shape, the ADM fixture's 8x8
    map at batch 8 (8, 64, 64, nh 2). Library yardstick: the backward alone
    of autograd through F.group_norm, the matmuls and SDPA in fp32."""
    B, S, C, nh = 8, 64, 64, 2
    a = attn_bwd_case(gen, B, S, C, torch.float32)
    x, ct, gs, gb, wq, bq, wp = a
    d = C // nh
    xl = x.detach().clone().requires_grad_(True)
    pl = [t.detach().clone().requires_grad_(True)
          for t in (gs, gb, wq, bq, wp)]
    g = F.group_norm(xl.transpose(1, 2), 32, pl[0], pl[1],
                     1e-5).transpose(1, 2)
    q, k, v = (g @ pl[2] + pl[3]).reshape(B, S, 3, nh, d).permute(
        2, 0, 3, 1, 4)
    o = F.scaled_dot_product_attention(q, k, v, scale=d ** -0.5)
    y = xl + o.transpose(1, 2).reshape(B, S, C) @ pl[4]
    M = B * S
    return dict(
        ms=time_ms(lambda: attn_block_bwd(*a, nh)),
        plain_ms=time_ms(lambda: attn_block_bwd_reference(*a, nh)),
        library_ms=time_ms(lambda: torch.autograd.grad(
            y, [xl, *pl], ct, retain_graph=True)),
        # x, ct read and dx written; weights read; the fp32 cotangents of
        # every parameter written
        bytes=3 * M * C * 4 + 4 * C * C * 4 + (4 * C * C + 6 * C) * 4,
        # the products of the bf16 row, on the fp32 units
        ops={"fp32": 2 * 11 * M * C * C + 2 * 6 * B * nh * S * S * d
             + 8 * B * nh * S * S + 20 * M * C})


def bwd_breakdown(gen):
    """Device time of each launch of one K6 bf16 call at the 32x32 map
    (batch 128) and of one K4-dkv call at the same map, after a warm-up
    call: the split that PERF.md's K6 breakdown records."""
    a = attn_bwd_case(gen, TRAIN_BATCH, 1024, 384, torch.bfloat16)
    attn_block_bwd(*a, 6)
    torch.cuda.synchronize()
    profile_run(lambda: attn_block_bwd(*a, 6),
                f"K6 bf16 {(TRAIN_BATCH, 1024, 384, 6)}, one call", top=20,
                width=150)
    del a
    qkv, o, lse, do, sm = flash_bwd_case(gen, TRAIN_BATCH, 1024, 6, 64)
    flash_bwd_dkv(qkv, o, lse, do, sm)
    torch.cuda.synchronize()
    profile_run(lambda: flash_bwd_dkv(qkv, o, lse, do, sm),
                f"K4-dkv {(TRAIN_BATCH, 6, 1024, 64)}, one call", width=150)
    torch.cuda.empty_cache()


# G3: the port's DxMITrainerCond iteration on the ADM fixture against the
# JAX package's (TRAIN_GOLDEN), both fp32. The trainer's metrics (every
# loss, value, cost and entropy, per step too) within 1e-3 of each
# vector's largest (2.2e-5 measured on the CPU); the value update (norm and
# projection of each tensor's change) within 1e-3 over all tensors
# together (5e-6 on the CPU); log_betas within 1e-5. The sampler net's
# update passes RAdam's steps 6-10, m / sqrt(v), which turn a gradient at
# the noise floor into a step of +-lr: so each tensor's update norm and
# projection within 5% of its own plus 1% of the largest over the tensors
# (0.24 of that limit on the CPU, einsum and fused_train).
G3_METRIC_REL = 1e-3
G3_VALUE_REL = 1e-3
G3_BETAS_ABS = 1e-5
G3_SAMPLER_REL, G3_SAMPLER_FLOOR = 0.05, 0.01


def train_golden_check(port, golden, what):
    """The G3 gates; returns (worst metric rel err, value rel err, worst
    sampler share of its limit)."""
    worst_m = 0.0
    for k in golden:
        if k.startswith("metric/"):
            a, b = (np.asarray(x, np.float64) for x in (port[k], golden[k]))
            rel = np.abs(a - b).max() / max(np.abs(b).max(), 1e-12)
            if not np.isfinite(a).all() or rel > G3_METRIC_REL:
                raise AssertionError(f"{what} {k}: {a} vs JAX {b}")
            worst_m = max(worst_m, rel)
    b_err = np.abs(port["log_betas"] - golden["log_betas"]).max()
    if b_err > G3_BETAS_ABS:
        raise AssertionError(f"{what}: log_betas {b_err:.3e} from JAX's")
    v_rel = 0.0
    for kind in ("vnorm/", "vproj/"):
        ks = [k for k in golden if k.startswith(kind)]
        a = np.array([port[k] for k in ks])
        b = np.array([golden[k] for k in ks])
        v_rel = max(v_rel, np.linalg.norm(a - b) / np.linalg.norm(b))
    if not v_rel <= G3_VALUE_REL:
        raise AssertionError(f"{what}: value update {v_rel:.3e} from JAX's")
    share = 0.0
    for kind in ("snorm/", "sproj/"):
        ks = [k for k in golden if k.startswith(kind)]
        a = np.array([port[k] for k in ks])
        b = np.array([golden[k] for k in ks])
        lim = G3_SAMPLER_REL * np.abs(b) + G3_SAMPLER_FLOOR * np.abs(b).max()
        s = np.abs(a - b) / lim
        if not np.isfinite(a).all() or s.max() > 1:
            i = int(np.argmax(s))
            raise AssertionError(f"{what}: {ks[i]} {a[i]:.4e} vs JAX "
                                 f"{b[i]:.4e}")
        share = max(share, float(s.max()))
    if port["nan_guard_skips"]:
        raise AssertionError(f"{what}: {port['nan_guard_skips']} updates "
                             "skipped")
    return worst_m, v_rel, share


def phase_train_replay():
    golden = dict(np.load(TRAIN_GOLDEN))
    out = {}
    for impl in ("einsum", "fused_train"):
        _lib.reset_launches()
        port = adm_train_replay(golden, "cuda", impl)
        used = {k for k, v in _lib.LAUNCHES.items() if v}
        want = {"gn_silu"} | ({"attn_block", "attn_block_bwd"}
                              if impl == "fused_train" else set())
        if used != want:
            raise AssertionError(f"G3 {impl}: launched {used}, expected "
                                 f"{want}")
        m, v, s = train_golden_check(port, golden, f"G3 {impl}")
        print(f"  G3 {impl}: metrics within {m:.3e} (tol {G3_METRIC_REL:g})"
              f", value update {v:.3e} (tol {G3_VALUE_REL:g}), sampler "
              f"updates at {s:.3f} of their limit; d_loss "
              f"{float(port['metric/ebm/d_loss_']):.5f}, sampler_loss "
              f"{float(port['metric/sampler/sampler_loss_']):.5f}; kernels "
              f"{sorted(used)} {dict(_lib.LAUNCHES)}")
        out[impl] = port
    return out


# E3 launches per training step at configs/imagenet64/T10.yaml: the
# sampling phase runs T=10 forwards, the sampler update G = T B / B = 10
# minibatches of one forward and one backward each (no use_checkpoint), so
# 20 forwards and 10 backwards. flash: K4 at the 7 maps of 32x32, K1 at
# the 95 norms of each forward; fused_train: K2 and K6 at all 22 attention
# blocks (every map passes fused_attn_bwd_available), K1 at the 73 others.
TRAIN_FORWARDS, TRAIN_BACKWARDS, E3_STEPS = 20, 10, 3
TRAIN_LAUNCHES_PER_STEP = {
    "flash": {"gn_silu_bf16": 95 * TRAIN_FORWARDS,
              "flash_attn": 7 * TRAIN_FORWARDS,
              "flash_attn_bwd_dkv": 7 * TRAIN_BACKWARDS,
              "flash_attn_bwd_dq": 7 * TRAIN_BACKWARDS},
    "fused_train": {"gn_silu_bf16": 73 * TRAIN_FORWARDS,
                    "attn_block_bf16": 22 * TRAIN_FORWARDS,
                    "attn_block_bwd_bf16": 22 * TRAIN_BACKWARDS},
}
# The device time of the backward kernels in E3's profiled step, by kernel
# name: K4-dkv (its tensor-core kernel and di) and K4-dq on the flash path;
# K6's launches on fused_train but for K1's GroupNorm statistics and apply,
# which K6 shares with K1's forward launches (two of K6's launches, ~0.4 of
# 8.9 ms at the 32x32 map).
E3_SHARES = {
    "flash": {"K4-dkv": ("attn_bwd_dkv_tc_kernel", "di_kernel"),
              "K4-dq": ("attn_bwd_dq_tc_kernel",)},
    "fused_train": {"K6 (less K1's GroupNorm launches)": (
        "attn_stats_tc_kernel", "attn_bwd_dkv_tc_kernel",
        "attn_bwd_dq_tc_kernel", "hgemm_kernel<0, 0,", "hgemm_kernel<0, 2,",
        "hgemm_kernel<0, 3,", "gn_bwd_kernel", "colsum_kernel",
        "sum_parts_kernel")},
}
# Wiring: from one state, batch and noise, the first sampler minibatch's
# gradient by einsum (bf16 softmax at every map), flash and fused_train.
# The three differ by bf16 roundings placed differently (the einsum path
# rounds its softmax to bf16, K2 and K4 keep it fp32; K2 and K6 recompute
# GroupNorm in fp32): 0.0017-0.0020 of the gradient's norm pairwise on the
# H100. Two gates per pair. (1) The whole gradient within E3_GRAD_REL, ten
# times that. (2) Each group of the attention blocks' leaves (one leaf, e.g.
# qkv.weight, over the blocks of one width, i.e. one map) within
# E3_GROUP_REL of its own norm: a cotangent wired to the wrong input or
# dropped moves its group by its whole norm, but the whole gradient only by
# that group's share of it. On the CPU at a shrunken width in fp32
# (tests/test_torch_chip_checks.py test_wiring_check) dk and dv swapped in
# FlashAttention, dgs and dgb swapped and db_proj dropped in
# FusedAttnBlockTrain read 1.57, 1.74 and 1.00 on their worst group, but
# 0.047, 0.0081 and 0.0041 on the whole gradient (the last two pass gate
# 1). E3_GROUP_REL is a quarter of the smallest group reading; at full
# width in bf16 the worst group reads 0.0021 on the H100.
E3_GRAD_REL = 0.02
E3_GROUP_REL = 0.25
# rows of the first minibatch in the wiring check (the einsum path holds bf16
# logits of every 32x32 map for the backward)
E3_GRAD_ROWS = 32
E3_PAIRS = (("flash", "einsum"), ("fused_train", "einsum"),
            ("fused_train", "flash"))


def imagenet64_train_config():
    """configs/imagenet64/T10.yaml with its dataset config merged."""
    return merge(load_yaml(IMAGENET64_CONFIG), load_yaml(os.path.join(
        REPO, "configs", "imagenet64", "imagenet64.yaml")))


def build_trainer(cfg, attn_impl, batchsize, device="cuda"):
    """The CLI's sampler (seed weights), value and DxMITrainerCond."""
    tr = cfg["training"]
    seed = int(tr["seed"])
    sampler = train_image_large.build_sampler(
        cfg, torch.device(device), seed, attn_impl=attn_impl)
    with torch.device(device):
        value = instantiate(cfg["value"])
    trainer = instantiate(cfg["trainer"], batchsize=batchsize,
                          n_timesteps=cfg["sampler"]["n_timesteps"])
    trainer.set_models(sampler, value, lr=float(tr["lr"]),
                       v_lr=float(tr["v_lr"]),
                       beta_lr=float(tr.get("beta_lr") or tr["lr"]))
    return trainer


def e3_grads(cfg, batchsize, rows, device="cuda"):
    """The first sampler minibatch's gradient (net and log_betas, fp32) of
    the seed-0 state under each attention path, on the same buffer rows,
    step noise and labels: {impl: [gradient per parameter]}, and each
    attention-block parameter's group (``attention_groups``)."""
    grads = {}
    gen = torch.Generator(device=device).manual_seed(5)
    trainer = build_trainer(cfg, "einsum", batchsize, device)
    with torch.no_grad():
        d = trainer.sampler.sample(rows, generator=gen)
    flat = from_d_sample(d).flat()
    idx = torch.randperm(flat["state"].shape[0], generator=gen,
                         device=device)[:rows]
    noise = torch.randn(flat["state"][idx].shape, generator=gen,
                        device=device)
    for impl in ("einsum", "flash", "fused_train"):
        for m in trainer.sampler.net.modules():
            if hasattr(m, "attn_impl"):
                m.attn_impl = impl
        loss = trainer.minibatch_loss(flat, idx, noise)[0]
        grads[impl] = [g.float() for g in trainer.sampler_grads(loss)]
    groups = attention_groups(trainer.sampler.net)
    del trainer
    if device == "cuda":
        torch.cuda.empty_cache()
    return grads, groups


def attention_groups(net):
    """Parameter index (in ``net.parameters()`` order) -> group of the
    attention blocks' leaves: the leaf's name and the block's width, e.g.
    "qkv.weight C=384" (at ImageNet64 the width names the map: 384 the
    32x32 maps, 576 the 16x16, 768 the 8x8)."""
    blocks = {name: m.norm.weight.shape[0] for name, m in net.named_modules()
              if isinstance(m, AttentionBlockADM)}
    groups = {}
    for i, (name, _) in enumerate(net.named_parameters()):
        for prefix, C in blocks.items():
            if name.startswith(prefix + "."):
                groups[i] = f"{name[len(prefix) + 1:]} C={C}"
    return groups


def wiring_readings(ga, gb, groups):
    """|g_a - g_b| / |g_b| over the whole gradient, and the worst of it
    over the attention groups (with that group's name)."""
    def rel(ia):
        a = torch.cat([ga[i].reshape(-1) for i in ia])
        b = torch.cat([gb[i].reshape(-1) for i in ia])
        return ((a - b).norm() / b.norm()).item()

    by_group = {}
    for i, g in groups.items():
        by_group.setdefault(g, []).append(i)
    worst = max((rel(ia), g) for g, ia in by_group.items())
    return rel(range(len(ga))), worst[0], worst[1]


def wiring_check(grads, groups, pairs=E3_PAIRS, what="E3"):
    """The wiring gates over ``pairs``; returns a line per pair."""
    lines = []
    for a, b in pairs:
        whole, worst, group = wiring_readings(grads[a], grads[b], groups)
        lines.append(f"|g_{a} - g_{b}| / |g_{b}| = {whole:.4f} (tol "
                     f"{E3_GRAD_REL:g}), worst attention group {group} "
                     f"{worst:.4f} (tol {E3_GROUP_REL:g})")
        if not (whole < E3_GRAD_REL and worst < E3_GROUP_REL):
            raise AssertionError(f"{what} wiring: {lines[-1]}")
    return lines


def phase_train(k1_log):
    """E3 (see the module docstring)."""
    cfg = imagenet64_train_config()
    B = TRAIN_BATCH
    out = {}
    for impl in ("flash", "fused_train"):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        trainer = build_trainer(cfg, impl, B)
        n_params = sum(p.numel() for p in trainer.sampler.parameters())
        data = train_image_large.fake_data(
            cfg, trainer.sampler, 1024, B, int(cfg["training"]["seed"]),
            torch.device("cuda"))
        gen = torch.Generator(device="cuda").manual_seed(0)
        steps = []
        for i in range(E3_STEPS):
            x, y = next(data)
            _lib.reset_launches()
            t0 = time.perf_counter()
            with k1_shapes(k1_log, f"E3 {impl}", 1, "step") if i == 0 else \
                    contextlib.nullcontext():
                m = train_image_large.train_step(trainer, x, y, gen)
            wall = time.perf_counter() - t0
            got = dict(_lib.LAUNCHES)
            if got != TRAIN_LAUNCHES_PER_STEP[impl]:
                raise AssertionError(f"E3 {impl} step {i}: launches {got}, "
                                     f"expected "
                                     f"{TRAIN_LAUNCHES_PER_STEP[impl]}")
            bad = [k for k, v in m.items() if not k.startswith("time/")
                   and not torch.isfinite(torch.as_tensor(v)).all()]
            if bad:
                raise AssertionError(f"E3 {impl} step {i}: non-finite {bad}")
            steps.append((wall, m))
            print(f"  E3 {impl} step {i}: {wall:.3f} s (sample "
                  f"{m['time/sample']:.3f}, update_f_v "
                  f"{m['time/update_f_v']:.3f}, update_sampler "
                  f"{m['time/update_sampler']:.3f}); d_loss "
                  f"{float(m['ebm/d_loss_']):.4f}, v_loss "
                  f"{float(m['ebm/v_loss_']):.4f}, sampler_loss "
                  f"{float(m['sampler/sampler_loss_']):.4f}", flush=True)
        if trainer.nan_guard_skips:
            raise AssertionError(f"E3 {impl}: {trainer.nan_guard_skips} "
                                 "updates skipped by the non-finite guard")
        peak = torch.cuda.max_memory_allocated()
        later = [w for w, _ in steps[1:]]
        phases = {k: np.mean([m[f"time/{k}"] for _, m in steps[1:]])
                  for k in ("sample", "update_f_v", "update_sampler")}
        print(f"  E3 {impl}: {n_params} sampler parameters, batch {B}; "
              f"{np.mean(later):.3f} s/step over steps 1-{E3_STEPS - 1} "
              f"(sample {phases['sample']:.3f}, update_f_v "
              f"{phases['update_f_v']:.3f}, update_sampler "
              f"{phases['update_sampler']:.3f}); launches per step "
              f"{TRAIN_LAUNCHES_PER_STEP[impl]} as expected; nan-guard "
              f"skips 0; peak allocated {peak / 2**30:.2f} GiB", flush=True)
        x, y = next(data)
        profile_run(lambda: train_image_large.train_step(trainer, x, y, gen),
                    f"E3 {impl} profile, one training step", top=16,
                    shares=E3_SHARES[impl])
        out[impl] = TRAIN_LAUNCHES_PER_STEP[impl]
        del trainer, data
        torch.cuda.empty_cache()
    for line in wiring_check(*e3_grads(cfg, B, E3_GRAD_ROWS)):
        print(f"  E3 wiring: {line}")
    return out


# G4: one DxMITrainer iteration on the CIFAR fixture (fp32, batch 8, lr
# 1e-4, beta_lr 1e-3, v_lr 1e-3) against CIFAR_TRAIN_GOLDEN, the JAX
# iteration with its trajectory, permutation, step noise and dropout masks.
# Two forms of the net. (1) Convolutions unfused (cuDNN in fp32) with
# einsum attention, and with fused attention at bb 2 (K7): G3's gates; on
# the CPU the port reads 6.9e-6 on the metrics, 7.1e-6 on the value update
# and 0.028 of the sampler limit. (2) Fused attention at bb 2 with K3: K3's
# forward rounds its conv operands to bf16 where JAX's CPU run keeps fp32
# (its fused_gn_silu_conv is the fp32 reference off the TPU), and Adam's
# first step turns that into sign flips of small gradient elements, so the
# update's projections move: on the CPU the metrics read 5.7e-4, the
# sampler update's norms 1e-4 and its projections 0.056 relative (L2 over
# all tensors). Gates: metrics 2e-3, each of the two sampler vectors 0.2
# relative, the value update and log_betas as G3.
G4_CASES = (("einsum", False, None), ("fused", False, 2), ("fused", True, 2))
G4_K3_METRIC_REL = 2e-3
G4_K3_SAMPLER_REL = 0.2


def k3_golden_check(port, golden, what):
    """G4's gates for the K3 form; returns (worst metric rel err, worst
    sampler vector rel err)."""
    worst_m = 0.0
    for k in golden:
        if k.startswith("metric/"):
            a, b = (np.asarray(x, np.float64) for x in (port[k], golden[k]))
            rel = np.abs(a - b).max() / max(np.abs(b).max(), 1e-12)
            if not np.isfinite(a).all() or rel > G4_K3_METRIC_REL:
                raise AssertionError(f"{what} {k}: {a} vs JAX {b}")
            worst_m = max(worst_m, rel)
    if np.abs(port["log_betas"] - golden["log_betas"]).max() > G3_BETAS_ABS:
        raise AssertionError(f"{what}: log_betas off JAX's")
    worst_s = 0.0
    for kind, lim in (("vnorm/", G3_VALUE_REL), ("vproj/", G3_VALUE_REL),
                      ("snorm/", G4_K3_SAMPLER_REL),
                      ("sproj/", G4_K3_SAMPLER_REL)):
        ks = [k for k in golden if k.startswith(kind)]
        a = np.array([port[k] for k in ks])
        b = np.array([golden[k] for k in ks])
        rel = np.linalg.norm(a - b) / np.linalg.norm(b)
        if not np.isfinite(a).all() or rel > lim:
            raise AssertionError(f"{what}: {kind} update {rel:.3e} from "
                                 f"JAX's (tol {lim:g})")
        if kind.startswith("s"):
            worst_s = max(worst_s, rel)
    return worst_m, worst_s


def g4_kernels(attn_impl, fuse, block_b):
    """The kernels a G4 case launches."""
    return ({"gn_silu"} | ({"gn_silu_conv3x3"} if fuse else set())
            | ({"attn_block_bb" if (block_b or 1) > 1 else "attn_block"}
               if attn_impl == "fused" else set()))


def phase_cifar_train_replay():
    golden = dict(np.load(CIFAR_TRAIN_GOLDEN))
    for impl, fuse, bb in G4_CASES:
        what = f"G4 {impl} bb {bb} fuse_gn_conv={fuse}"
        _lib.reset_launches()
        port = cifar_train_replay(golden, "cuda", impl, fuse, bb)
        used = {k for k, v in _lib.LAUNCHES.items() if v}
        if used != g4_kernels(impl, fuse, bb):
            raise AssertionError(f"{what}: launched {used}, expected "
                                 f"{g4_kernels(impl, fuse, bb)}")
        if fuse:
            m, srel = k3_golden_check(port, golden, what)
            line = (f"metrics within {m:.3e} (tol {G4_K3_METRIC_REL:g}), "
                    f"sampler update {srel:.3e} (tol {G4_K3_SAMPLER_REL:g})")
        else:
            m, v, sh = train_golden_check(port, golden, what)
            line = (f"metrics within {m:.3e} (tol {G3_METRIC_REL:g}), value "
                    f"update {v:.3e} (tol {G3_VALUE_REL:g}), sampler updates "
                    f"at {sh:.3f} of their limit")
        print(f"  {what}: {line}; d_loss "
              f"{float(port['metric/ebm/d_loss_']):.5f}, sampler_loss "
              f"{float(port['metric/sampler/sampler_loss_']):.5f}; kernels "
              f"{dict(_lib.LAUNCHES)}")


# E4 launches per training step at configs/cifar10/T10.yaml (batch 128,
# trajectory sampling in 4 chunks of 32): 40 forwards of the net in eval
# mode (K1 at norm_out and the 4x4 mid attention's norm, K3 at both convs of
# the 22 ResnetBlocks, K2 or K7 at the 5 attention blocks at 16x16) and one
# minibatch forward in training mode (dropout unfuses each block's second
# GN+conv: K1 also at the 22 norm2, K3 at the 22 conv1). The backward runs
# the plain versions' vjps. tests/test_torch_cifar_train.py counts these
# from the net on the CPU.
E4_STEPS, E4_SAMPLE_FORWARDS = 3, 40
E4_LAUNCHES_PER_STEP = {
    bb: {"gn_silu": 2 * E4_SAMPLE_FORWARDS + 24,
         "gn_silu_conv3x3": 44 * E4_SAMPLE_FORWARDS + 22,
         ("attn_block" if bb == 1 else "attn_block_bb"):
             5 * (E4_SAMPLE_FORWARDS + 1)}
    for bb in (1, 4)}
# Wiring, as E3's: the first minibatch's gradient (128 rows, one set of
# dropout masks) by einsum, fused bb 1 and fused bb 4 pairwise within
# E3_GRAD_REL of its norm, and each group of the attention blocks'
# parameters (a leaf over the 16x16 blocks, or the 4x4 mid block) within
# E3_GROUP_REL of its own: K2 and K7 share the fp32 reference's backward, so
# the three differ by fp32 orders and K3's bf16 roundings on inputs moved by
# them; a cotangent returned to the wrong input moves its group by its norm.
E4_PAIRS = (("fused_bb1", "einsum"), ("fused_bb4", "einsum"),
            ("fused_bb4", "fused_bb1"))


def cifar10_train_config():
    """configs/cifar10/T10.yaml with its dataset config merged."""
    return merge(load_yaml(CIFAR10_CONFIG), load_yaml(os.path.join(
        REPO, "configs", "cifar10", "cifar10.yaml")))


def cifar_attention_groups(net):
    """Parameter index -> group of the attention blocks' leaves: the leaf
    and the map ("qkv.weight 16x16", "proj_out.bias 4x4"). The q, k and v
    convs form one group, as the ADM nets' qkv conv does: k's bias alone
    has no gradient in exact arithmetic (the softmax ignores a shift of a
    row's logits), so its own group would hold rounding noise only."""
    groups = {}
    for i, (name, _) in enumerate(net.named_parameters()):
        for mod_name, m in net.named_modules():
            if isinstance(m, AttnBlock) and name.startswith(mod_name + "."):
                where = "4x4" if mod_name.startswith("mid.") else "16x16"
                leaf = name[len(mod_name) + 1:]
                if leaf.split(".")[0] in ("q", "k", "v"):
                    leaf = "qkv." + leaf.split(".")[1]
                groups[i] = f"{leaf} {where}"
    return groups


def e4_grads(cfg, device="cuda"):
    """The first sampler minibatch's gradient under each attention path from
    one state, buffer rows, step noise and dropout masks."""
    gen = torch.Generator(device=device).manual_seed(5)
    sampler, _, trainer = train_cifar10.build(cfg, torch.device(device),
                                              int(cfg["training"]["seed"]))
    B = trainer.batchsize
    with torch.no_grad():
        d = sampler.sample(B, generator=gen)
    flat = from_d_sample(d).flat()
    idx = torch.randperm(flat["state"].shape[0], generator=gen,
                         device=device)[:B]
    noise = torch.randn(flat["state"][idx].shape, generator=gen,
                        device=device)
    grads, masks = {}, None
    for name, impl, bb in (("einsum", "einsum", None),
                           ("fused_bb1", "fused", 1),
                           ("fused_bb4", "fused", 4)):
        for m in sampler.net.modules():
            if isinstance(m, AttnBlock):
                m.attn_impl, m.block_b = impl, bb
        if masks is None:
            sampler.net.record_dropout_masks(True)
        else:
            sampler.net.inject_dropout_masks(masks)
        loss = trainer.minibatch_loss(flat, idx, noise)[0]
        grads[name] = [g.float() for g in trainer.sampler_grads(loss)]
        if masks is None:
            masks = sampler.net.record_dropout_masks(False)
        sampler.net.inject_dropout_masks(None)
    groups = cifar_attention_groups(sampler.net)
    del trainer, sampler
    torch.cuda.empty_cache()
    return grads, groups


def phase_cifar_train(k1_log, k3_log):
    """E4 (see the module docstring)."""
    cfg = cifar10_train_config()
    seed = int(cfg["training"]["seed"])
    out = {}
    for bb in (1, 4):
        os.environ["DXMI_FUSED_ATTN_BB"] = str(bb)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        sampler, _, trainer = train_cifar10.build(cfg, torch.device("cuda"),
                                                  seed)
        n_params = sum(p.numel() for p in sampler.parameters())
        loader = EpochLoader(fake_cifar(1024, seed), trainer.batchsize, seed)
        batches = loader.epoch(0)
        gen = torch.Generator(device="cuda").manual_seed(seed)
        want = E4_LAUNCHES_PER_STEP[bb]
        steps = []
        for i in range(E4_STEPS):
            x = train_cifar10.to_device_batch(next(batches)[0], "cuda")
            _lib.reset_launches()
            t0 = time.perf_counter()
            logged = i == 0 and bb == 1
            with (k1_shapes(k1_log, "E4", 1, "step") if logged
                  else contextlib.nullcontext()), \
                    (k3_shapes(k3_log, "E4", 1, "step") if logged
                     else contextlib.nullcontext()):
                m = train_step(trainer, x, None, gen, n_generator=1)
            wall = time.perf_counter() - t0
            got = dict(_lib.LAUNCHES)
            if got != want:
                raise AssertionError(f"E4 bb {bb} step {i}: launches {got}, "
                                     f"expected {want}")
            bad = [k for k, v in m.items() if not k.startswith("time/")
                   and not torch.isfinite(torch.as_tensor(v)).all()]
            if bad:
                raise AssertionError(f"E4 bb {bb} step {i}: non-finite {bad}")
            steps.append((wall, m))
            print(f"  E4 bb {bb} step {i}: {wall:.3f} s (sample "
                  f"{m['time/sample']:.3f}, update_f_v "
                  f"{m['time/update_f_v']:.3f}, update_sampler "
                  f"{m['time/update_sampler']:.3f}); d_loss "
                  f"{float(m['ebm/d_loss_']):.4f}, v_loss "
                  f"{float(m['ebm/v_loss_']):.4f}, sampler_loss "
                  f"{float(m['sampler/sampler_loss_']):.4f}", flush=True)
        peak = torch.cuda.max_memory_allocated()
        later = [w for w, _ in steps[1:]]
        phases = {k: np.mean([m[f"time/{k}"] for _, m in steps[1:]])
                  for k in ("sample", "update_f_v", "update_sampler")}
        print(f"  E4 bb {bb}: {n_params} sampler parameters, batch "
              f"{trainer.batchsize} in {trainer.sample_chunks} sampling "
              f"chunks; {np.mean(later):.3f} s/step over steps 1-"
              f"{E4_STEPS - 1} (sample {phases['sample']:.3f}, update_f_v "
              f"{phases['update_f_v']:.3f}, update_sampler "
              f"{phases['update_sampler']:.3f}); launches per step {want} as "
              f"on the CPU; peak allocated {peak / 2**30:.2f} GiB",
              flush=True)
        x = train_cifar10.to_device_batch(next(batches)[0], "cuda")
        profile_run(lambda: train_step(trainer, x, None, gen, n_generator=1),
                    f"E4 bb {bb} profile, one training step", top=12)
        out[bb] = want
        del trainer, sampler
    os.environ.pop("DXMI_FUSED_ATTN_BB", None)
    for line in wiring_check(*e4_grads(cfg), pairs=E4_PAIRS, what="E4"):
        print(f"  E4 wiring: {line}")
    return out


# E4-levers: train_cifar10 --fast_levers at configs/cifar10/T10.yaml (batch
# 128, the trajectory in 2 chunks of 64): 20 sampling forwards and one
# training forward a step, as E4's, in bf16: K1 bf16 at norm_out and the 4x4
# attention norm (and the 22 norm2 in training, where dropout unfuses the
# second pair), K3 bf16 at both convs of the 22 ResnetBlocks (conv1 only in
# training), K2 bf16 at d = 256 (bb 1) or K7 bf16 (DXMI_FUSED_ATTN_BB=4) at
# the 5 blocks at 16x16. tests/test_torch_cifar_levers.py counts these from
# the net on the CPU.
E4_LEVERS_SAMPLE_FORWARDS = 20
E4_LEVERS_STEPS = {1: 3, 4: 2}
E4_LEVERS_LAUNCHES_PER_STEP = {
    bb: {"gn_silu_bf16": 2 * E4_LEVERS_SAMPLE_FORWARDS + 24,
         "gn_silu_conv3x3_bf16": 44 * E4_LEVERS_SAMPLE_FORWARDS + 22,
         ("attn_block_bf16_d256" if bb == 1 else "attn_block_bb_bf16"):
             5 * (E4_LEVERS_SAMPLE_FORWARDS + 1)}
    for bb in (1, 4)}


def phase_cifar_train_levers():
    """E4-levers (see above): 3 steps at bb 1 (s/step over steps 1-2 with
    its phase split, peak memory, a profiled step's idle share) and 2 at
    bb 4, each step's launches and finite metrics checked."""
    cfg = cifar10_train_config()
    seed = int(cfg["training"]["seed"])
    out = {}
    for bb, n_steps in E4_LEVERS_STEPS.items():
        os.environ["DXMI_FUSED_ATTN_BB"] = str(bb)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        sampler, _, trainer = train_cifar10.build(
            cfg, torch.device("cuda"), seed, levers=True)
        if trainer.sample_chunks != E4_BATCH // LEVERS_CHUNK:
            raise AssertionError(f"E4-levers: {trainer.sample_chunks} "
                                 "sampling chunks")
        loader = EpochLoader(fake_cifar(1024, seed), trainer.batchsize, seed)
        batches = loader.epoch(0)
        gen = torch.Generator(device="cuda").manual_seed(seed)
        want = E4_LEVERS_LAUNCHES_PER_STEP[bb]
        steps = []
        for i in range(n_steps):
            x = train_cifar10.to_device_batch(next(batches)[0], "cuda")
            _lib.reset_launches()
            t0 = time.perf_counter()
            m = train_step(trainer, x, None, gen, n_generator=1)
            wall = time.perf_counter() - t0
            got = dict(_lib.LAUNCHES)
            if got != want:
                raise AssertionError(f"E4-levers bb {bb} step {i}: launches "
                                     f"{got}, expected {want}")
            bad = [k for k, v in m.items() if not k.startswith("time/")
                   and not torch.isfinite(torch.as_tensor(v)).all()]
            if bad or trainer.nan_guard_skips:
                raise AssertionError(f"E4-levers bb {bb} step {i}: non-finite"
                                     f" {bad}")
            steps.append((wall, m))
            print(f"  E4-levers bb {bb} step {i}: {wall:.3f} s (sample "
                  f"{m['time/sample']:.3f}, update_f_v "
                  f"{m['time/update_f_v']:.3f}, update_sampler "
                  f"{m['time/update_sampler']:.3f}); d_loss "
                  f"{float(m['ebm/d_loss_']):.4f}, v_loss "
                  f"{float(m['ebm/v_loss_']):.4f}, sampler_loss "
                  f"{float(m['sampler/sampler_loss_']):.4f}", flush=True)
        peak = torch.cuda.max_memory_allocated()
        later = [w for w, _ in steps[1:]]
        phases = {k: np.mean([m[f"time/{k}"] for _, m in steps[1:]])
                  for k in ("sample", "update_f_v", "update_sampler")}
        print(f"  E4-levers bb {bb}: batch {trainer.batchsize} in "
              f"{trainer.sample_chunks} sampling chunks; {np.mean(later):.3f} "
              f"s/step over steps 1-{n_steps - 1} (sample "
              f"{phases['sample']:.3f}, update_f_v {phases['update_f_v']:.3f},"
              f" update_sampler {phases['update_sampler']:.3f}); launches per "
              f"step {want} as on the CPU; peak allocated "
              f"{peak / 2**30:.2f} GiB", flush=True)
        if bb == 1:
            x = train_cifar10.to_device_batch(next(batches)[0], "cuda")
            profile_run(lambda: train_step(trainer, x, None, gen,
                                           n_generator=1),
                        "E4-levers bb 1 profile, one training step", top=12)
        out[bb] = want
        del trainer, sampler
    os.environ.pop("DXMI_FUSED_ATTN_BB", None)
    return out


def phase_build():
    proc = _lib.build(verbose=True)
    for line in (proc.stdout + proc.stderr).splitlines():
        if any(k in line for k in ("registers", "spill", "Compiling entry",
                                   "smem", "warning", "error")):
            print("  ptxas:", line.strip())
    _lib.lib()


def phase_kernels(gen):
    errs = {}
    errs["gn_silu"] = max(
        max_err(group_norm(*a), group_norm_silu_reference(*a), "gn_silu")
        for a in (gn_case(gen, *s) for s in GN_SHAPES))
    errs["gn_silu_conv3x3"] = phase_kernels_conv(gen)
    errs["attn_block"] = 0.0
    for shape in ATTN_SHAPES:
        a = attn_case(gen, *shape)
        out = attn_block(*a, num_heads=1, eps=1e-6)
        err = max_err(out, attn_block_reference(*a, num_heads=1, eps=1e-6),
                      "attn_block")
        if not torch.equal(out, attn_block(*a, num_heads=1, eps=1e-6)):
            raise AssertionError(f"attn_block {shape}: a replay differs")
        print(f"  K attn_block {shape}: max abs err vs plain {err:.3e}; "
              "replay bit-equal")
        errs["attn_block"] = max(errs["attn_block"], err)
    errs["gn_silu_bf16"] = max(
        max_err(group_norm(*a).float(), group_norm_silu_reference(*a).float(),
                "gn_silu_bf16")
        for a in (gn_bf16_case(gen, *sh, mode) for sh in ADM_GN_SHAPES
                  for mode in GN_MODES))
    for k in ("gn_silu", "gn_silu_conv3x3", "attn_block", "gn_silu_bf16"):
        print(f"  K {k}: max abs err vs plain {errs[k]:.3e} "
              f"(tol {TOL[k][0]:g} + {TOL[k][1]:g}*|plain|)")
    worst = 0.0
    for B, S, C, nh in ADM_ATTN_SHAPES + [E3_ATTN_SHAPE]:
        a = attn_bf16_case(gen, B, S, C)
        out = attn_block(*a, num_heads=nh)
        ref = attn_block_reference(*a, num_heads=nh)
        rel, err, share = attn_bf16_check(out, ref, a[0],
                                          f"attn_block_bf16 {(B, S, C, nh)}")
        del ref
        if not torch.equal(out, attn_block(*a, num_heads=nh)):
            raise AssertionError(f"attn_block_bf16 {(B, S, C, nh)}: a replay "
                                 "differs")
        print(f"  K attn_block_bf16 {(B, S, C, nh)}: mean rel err {rel:.3e} "
              f"(tol {ATTN_BF16_MEAN_REL:g}), max abs err {err:.3e}, worst "
              f"element beyond one ulp at {share:.3f} of its limit; replay "
              "bit-equal")
        worst = max(worst, err)
    errs["attn_block_bf16"] = worst
    for shape in FLASH_SHAPES:
        q, k, v, sm = flash_case(gen, *shape)
        err, share = flash_check(flash_mha(q, k, v, sm),
                                 flash_mha_reference(q, k, v, sm), q, k, v,
                                 sm, f"flash_attn {shape}")
        print(f"  K flash_attn {shape}: max abs err {err:.3e}, worst element "
              f"beyond one ulp at {share:.3f} of its row's limit")
        errs["flash_attn"] = err
    errs["attn_block_i8"] = 0.0
    for B, S, C, nh, dt in I8_ATTN_SHAPES:
        x, gs, gb, mats, bq, bp = attn_i8_case(gen, B, S, C, nh, dt)
        what = f"attn_block_i8 {(B, S, C, nh)} {str(dt)[6:]}"
        out = attn_block_int8(x, gs, gb, mats, bq, bp, nh)
        err, share, worst = attn_i8_check(
            out, attn_block_int8_plain(x, gs, gb, mats, bq, bp, nh), x, mats,
            what)
        if not torch.equal(out, attn_block_int8(x, gs, gb, mats, bq, bp, nh)):
            raise AssertionError(f"{what}: a replay differs")
        print(f"  K {what}: max abs err {err:.3e}, {share:.3%} of elements "
              f"over their base limit (tol {ATTN_I8_FLIP_SHARE:.0%}), worst "
              f"{worst:.3f} int8 levels beyond it (tol 1); replay bit-equal")
        errs["attn_block_i8"] = max(errs["attn_block_i8"], err)
    errs["int8_conv"] = 0.0
    for shape in I8_CONV_SHAPES:
        x, q, b, pad, dt, _ = conv_i8_case(gen, *shape)
        err = (int8_conv_apply(x, q, b, pad, dt).float()
               - int8_conv_reference(x, q, b, pad, dt).float()).abs().max()
        err = err.item()
        print(f"  K int8_conv {shape[:4]} pad {pad} {str(dt)[6:]}"
              f"{' dynamic' if shape[-1] else ''}: max abs err {err:g} "
              "(must be 0: exact int32 sums, elementwise epilogue)")
        if err != 0:
            raise AssertionError(f"int8_conv {shape}: max abs err {err}")
    phase_kernels_cifar_int8(gen, errs)
    phase_kernels_gn_routes(gen, errs)
    phase_kernels_flash_edges(gen, errs)
    phase_kernels_train(gen, errs)
    phase_kernels_bb(gen, errs)
    phase_kernels_bf16(gen, errs)
    return errs


# The CIFAR-10 bf16 forms: K3 on bf16 x at every conv shape of E-bf16
# (batch 100) and at E4-levers' training batch 128 and sampling chunk 64 at
# the 32x32 and 4x4 maps (the small maps sum their reduction's slices
# before the one rounding); K2 bf16 at the 16x16 blocks' one head of d =
# 256 at batch 100, at E4's 128 and at E4-levers' chunk 64, and at two heads
# of d = 256 at batch 100; K7 bf16 at d = 256 at E4-levers' batch 128 and
# chunk 64, bb 4; the wide core alone at batch 100, one and two heads (K4's
# gate, flash_check, which allows for another rounding of p); each replayed
# bit-equal.
K3_BF16_SHAPES = CONV_SHAPES + [(128, 32, 128, 128), (64, 32, 128, 128),
                                (128, 4, 512, 256), (64, 4, 512, 256)]


def phase_kernels_bf16(gen, errs):
    errs["gn_silu_conv3x3_bf16"] = 0.0
    for B, R, Cin, Cout in K3_BF16_SHAPES:
        a = list(conv_case(gen, B, R, Cin, Cout))
        a[0] = a[0].bfloat16()
        out = gn_silu_conv(*a)
        what = f"gn_silu_conv3x3_bf16 {(B, R, Cin, Cout)}"
        if out.dtype != torch.bfloat16:
            raise AssertionError(f"{what}: output {out.dtype}")
        err = conv_bf16_check(out, gn_silu_conv_reference(*a), what)
        if not torch.equal(out, gn_silu_conv(*a)):
            raise AssertionError(f"{what}: a replay differs")
        slices = conv_fused.plan(B, R, R, Cin, Cout).slices
        print(f"  K {what} ({slices} slice{'s' if slices > 1 else ''}): max "
              f"abs err vs plain {err:.3e} (tol {TOL['gn_silu_conv3x3'][0]:g}"
              f" + {TOL['gn_silu_conv3x3'][1]:g}*|plain| + one bf16 ulp); "
              "replay bit-equal")
        errs["gn_silu_conv3x3_bf16"] = max(errs["gn_silu_conv3x3_bf16"], err)
        del a, out
    for name, shapes in (("attn_block_bf16_d256", K2_D256_SHAPES),
                         ("attn_block_bb_bf16", BB_D256_SHAPES)):
        errs[name] = 0.0
        for B, S, C, nh, bb in shapes:
            a = attn_bf16_case(gen, B, S, C)
            _lib.reset_launches()
            if bb == 1:
                run = lambda: attn_block(*a, num_heads=nh, eps=1e-6)  # noqa
                ref = attn_block_reference(*a, num_heads=nh, eps=1e-6)
            else:
                run = lambda: attn_block_bb(*a, num_heads=nh,  # noqa
                                            eps=1e-6, bb=bb)
                ref = attn_block_bb_reference(*a, num_heads=nh, eps=1e-6,
                                              bb=bb)
            out = run()
            if dict(_lib.LAUNCHES) != {name: 1}:
                raise AssertionError(f"{name} {(B, S, C, nh)}: launched "
                                     f"{dict(_lib.LAUNCHES)}")
            what = f"{name} {(B, S, C)} nh {nh} bb {bb}"
            rel, err, share = attn_bf16_check(out, ref, a[0], what)
            if not torch.equal(out, run()):
                raise AssertionError(f"{what}: a replay differs")
            print(f"  K {what}: mean rel err {rel:.3e} (tol "
                  f"{ATTN_BF16_MEAN_REL:g}), max abs err {err:.3e}, worst "
                  f"element beyond one ulp at {share:.3f} of its limit; "
                  "replay bit-equal")
            errs[name] = max(errs[name], err)
            del a, out, ref
    for B, S, C, nh in CORE_SHAPES:
        qkv = core_case(gen, B, S, C, nh)
        out = attn_core_wide(qkv, nh)
        q, k, v = qkv.reshape(B, S, 3, nh, C // nh).unbind(2)
        what = f"attn_core_wide {(B, S, C, nh)}"
        err, share = flash_check(out.reshape(q.shape),
                                 attn_core_reference(qkv, nh).reshape(q.shape),
                                 q, k, v, 1.0, what)
        if not torch.equal(out, attn_core_wide(qkv, nh)):
            raise AssertionError(f"{what}: a replay differs")
        print(f"  K {what}: max abs err {err:.3e}, worst element beyond one "
              f"ulp at {share:.3f} of its row's limit; replay bit-equal")
        del qkv, out, q, k, v


def phase_kernels_cifar_int8(gen, errs):
    """K8 at the CIFAR-10 net's int8 shapes, stride 1 and 2 (exact: max abs
    err 0) and K1 at its bf16 shapes in both statistics modes (TOL), each
    replayed bit-equal; K1's route at each shape (gn_plan, which raises for
    a shape neither route takes)."""
    errs["int8_conv_s2"] = 0.0
    for shape in CIFAR_I8_CONV_SHAPES:
        x, q, b, pad, dt, stride = conv_i8_case(gen, *shape)
        out = int8_conv_apply(x, q, b, pad, dt, stride=stride)
        err = (out.float() - int8_conv_reference(
            x, q, b, pad, dt, stride).float()).abs().max().item()
        what = (f"int8_conv{'_s2' if stride == 2 else ''} {shape[:4]} "
                f"{shape[7]}x{shape[7]} pad {pad} {str(dt)[6:]}")
        if err != 0:
            raise AssertionError(f"{what}: max abs err {err}")
        if not torch.equal(out, int8_conv_apply(x, q, b, pad, dt,
                                                stride=stride)):
            raise AssertionError(f"{what}: a replay differs")
        print(f"  K {what}: out {tuple(out.shape)}, max abs err {err:g} "
              "(must be 0); replay bit-equal")
        del x, out
    worst = 0.0
    for B, HW, C, silu in CIFAR_GN_BF16_SHAPES:
        err = 0.0
        for mode in GN_MODES:
            a = gn_bf16_case(gen, B, HW, C, silu, mode)
            out = group_norm(*a)
            err = max(err, max_err(out.float(), group_norm_silu_reference(
                *a).float(), "gn_silu_bf16"))
            if not torch.equal(out, group_norm(*a)):
                raise AssertionError(f"gn_silu_bf16 {(B, HW, C)} {mode}: a "
                                     "replay differs")
        worst = max(worst, err)
        r = route(HW, C, 32, torch.bfloat16)
        print(f"  K gn_silu_bf16 {(B, HW, C)}{' +SiLU' if silu else ''} "
              f"({C // 32} channels a group), both modes: max abs err "
              f"{err:.3e}; {'on-chip' if r.on_chip else 'split'} ({r.slabs} "
              f"slabs, clusters of {r.cluster}); replay bit-equal")
    errs["gn_silu_bf16"] = max(errs["gn_silu_bf16"], worst)


# K3 at every main-path shape of E (batch 100) and at E4's training batch
# 128 and sampling chunk 32 at the 32x32 and 4x4 maps (at 4x4 the conv
# splits its reduction into slices), each replayed bit-equal.
K3_CHECK_SHAPES = CONV_SHAPES + [(128, 32, 128, 128), (32, 32, 128, 128),
                                 (128, 4, 512, 256), (32, 4, 512, 256)]


def phase_kernels_conv(gen):
    worst = 0.0
    for shape in K3_CHECK_SHAPES:
        a = conv_case(gen, *shape)
        out = gn_silu_conv(*a)
        err = conv_check(out, gn_silu_conv_reference(*a),
                         f"gn_silu_conv3x3 {shape}")
        if not torch.equal(out, gn_silu_conv(*a)):
            raise AssertionError(f"gn_silu_conv3x3 {shape}: a replay "
                                 "differs")
        print(f"  K gn_silu_conv3x3 {shape}: max abs err vs plain {err:.3e};"
              " replay bit-equal")
        worst = max(worst, err)
    return worst


# K1 on either side of its route gate (gn_plan in csrc/groupnorm.cu): for
# 6, 12, 24 and 48 channels a group, the largest map (a power of two of
# pixels) that the on-chip route takes and the next, which takes the split
# route, in bf16 (both statistics modes) and fp32, each against its plain
# version and replayed bit-equal.
GN_ROUTE_BATCH = 4
GN_ROUTE_GROUP_WIDTHS = (6, 12, 24, 48)


def gn_route_edges(C, dtype):
    """(HW on-chip, HW split): the largest on-chip map and the next one."""
    hw = 64
    while route(2 * hw, C, 32, dtype).on_chip:
        hw *= 2
    return hw, 2 * hw


def phase_kernels_gn_routes(gen, errs):
    for cg in GN_ROUTE_GROUP_WIDTHS:
        C = 32 * cg
        for dt, name, modes in ((torch.bfloat16, "gn_silu_bf16", GN_MODES),
                                (torch.float32, "gn_silu", ("fp32",))):
            if C % (16 // torch.tensor([], dtype=dt).element_size()):
                continue
            for hw, on_chip in zip(gn_route_edges(C, dt), (True, False)):
                r = route(hw, C, 32, dt)
                if r.on_chip != on_chip:
                    raise AssertionError(f"K1 {(hw, C)}: route {r}")
                for mode in modes:
                    a = (randn(gen, GN_ROUTE_BATCH, hw, C, scale=2.0,
                               shift=0.5).to(dt),
                         randn(gen, C, scale=0.1, shift=1.0),
                         randn(gen, C, scale=0.1), 32, 1e-5, True, mode)
                    out = group_norm(*a)
                    err = max_err(out.float(),
                                  group_norm_silu_reference(*a).float(), name)
                    if not torch.equal(out, group_norm(*a)):
                        raise AssertionError(f"{name} {(hw, C)} {mode}: a "
                                             "replay differs")
                    errs[name] = max(errs[name], err)
                    print(f"  K {name} {(GN_ROUTE_BATCH, hw, C)} {mode}, "
                          f"{'on-chip' if on_chip else 'split'} ({r.slabs} "
                          f"slabs, clusters of {r.cluster}): max abs err "
                          f"{err:.3e}; replay bit-equal")


# K4 at the edges of its wgmma kernel, under flash_check and its logsumexp
# gate: both tile forms (S = 64: one consumer warpgroup and 64-key tiles;
# S % 128 == 0: two warpgroups taking turns, 128-key tiles), every padded
# head width (d = 24, 32 in D = 32 with the 64-byte swizzle; 40, 64 in
# D = 64; 128 in two 64-column blocks), q, k and v as views of one
# (B, S, 3, nh, d) buffer (flash training; K2's and K5's (B, S, 3C) qkv has
# the same strides) and as three tensors of their own.
FLASH_EDGE_SHAPES = [(8, S, 3, d) for S in (64, 256, 1024)
                     for d in (24, 32, 40, 64, 128)]


def flash_views(gen, B, S, nh, d, layout):
    if layout == "qkv":
        return randn(gen, B, S, 3, nh, d).bfloat16().unbind(2)
    return tuple(randn(gen, B, S, nh, d).bfloat16() for _ in range(3))


def phase_kernels_flash_edges(gen, errs):
    for B, S, nh, d in FLASH_EDGE_SHAPES:
        worst = [0.0, 0.0, 0.0]
        for layout in ("qkv", "separate"):
            q, k, v = flash_views(gen, B, S, nh, d, layout)
            sm = d ** -0.5
            what = f"flash_attn {(B, S, nh, d)} {layout}"
            lse = torch.empty((B, nh, S), device="cuda", dtype=torch.float32)
            out = flash_fwd_kernel(q, k, v, sm, lse)
            ref, ref_lse = flash_mha_reference_fwd(q, k, v, sm)
            err, share = flash_check(out, ref, q, k, v, sm, what)
            lerr = flash_lse_check(lse, ref_lse, what)
            worst = [max(a, b) for a, b in zip(worst, (err, share, lerr))]
        errs["flash_attn"] = max(errs["flash_attn"], worst[0])
        print(f"  K flash_attn {(B, S, nh, d)} qkv views and separate, with "
              f"lse: max abs err {worst[0]:.3e}, worst element at "
              f"{worst[1]:.3f} of its row's limit, lse {worst[2]:.2e} (tol "
              f"{FLASH_LSE_ATOL:g})")


# K7 (the batch-blocked attention block): fp32 at E4's shape (the 16x16
# blocks of the full-width CIFAR-10 net) at E4's batch 128 and its sampling
# chunk of 32, at the batch blocks E4 and T use, K2 fp32's limit; bf16 at
# ImageNet64's 16x16 map, where the clamp gives bb 2, and at E4's shape
# with two heads (d = 128), at K2 bf16's gates. A replay is bit-equal (no
# atomics).
E4_BATCH = 128  # training.batchsize of configs/cifar10/T10.yaml
E4_CHUNK = 32  # its trajectory is sampled in chunks of 32
LEVERS_CHUNK = 64  # E4-levers samples its trajectory in chunks of 64
# (B, S, C, nh, bb) of K2 bf16 (bb 1) and K7 bf16 at d = 256, and (B, S, C,
# nh) of the wide attention core alone
K2_D256_SHAPES = [(BATCH, 256, 256, 1, 1), (E4_BATCH, 256, 256, 1, 1),
                  (LEVERS_CHUNK, 256, 256, 1, 1), (BATCH, 256, 512, 2, 1)]
BB_D256_SHAPES = [(E4_BATCH, 256, 256, 1, 4), (LEVERS_CHUNK, 256, 256, 1, 4)]
CORE_SHAPES = [(BATCH, 256, 256, 1), (BATCH, 256, 512, 2)]
BB_SHAPES = [(B, 256, 256, 1, bb) for B in (E4_BATCH, E4_CHUNK)
             for bb in (2, 4)]
BB_BF16_SHAPES = ([(BATCH, 256, 576, 9, resolve_block_b(BATCH, 256, 576, 4))]
                  + [(B, 256, 256, 2, bb) for B in (E4_BATCH, E4_CHUNK)
                     for bb in (2, 4)])


def phase_kernels_bb(gen, errs):
    errs["attn_block_bb"] = 0.0
    for B, S, C, nh, bb in BB_SHAPES:
        a = attn_case(gen, B, S, C)
        out = attn_block_bb(*a, num_heads=nh, eps=1e-6, bb=bb)
        err = max_err(out, attn_block_bb_reference(*a, num_heads=nh, eps=1e-6,
                                                   bb=bb), "attn_block_bb")
        same = torch.equal(out, attn_block_bb(*a, num_heads=nh, eps=1e-6,
                                              bb=bb))
        if not same:
            raise AssertionError(f"attn_block_bb {(B, S, C, nh, bb)}: a "
                                 "replay differs")
        print(f"  K attn_block_bb {(B, S, C, nh)} bb {bb}: max abs err vs "
              f"plain {err:.3e} (tol {TOL['attn_block_bb'][0]:g} + "
              f"{TOL['attn_block_bb'][1]:g}*|plain|); replay bit-equal")
        errs["attn_block_bb"] = max(errs["attn_block_bb"], err)
    for B, S, C, nh, bb in BB_BF16_SHAPES:
        a = attn_bf16_case(gen, B, S, C)
        what = f"attn_block_bb_bf16 {(B, S, C, nh)} bb {bb}"
        out = attn_block_bb(*a, num_heads=nh, bb=bb)
        rel, err, share = attn_bf16_check(
            out, attn_block_bb_reference(*a, num_heads=nh, bb=bb), a[0], what)
        if not torch.equal(out, attn_block_bb(*a, num_heads=nh, bb=bb)):
            raise AssertionError(f"{what}: a replay differs")
        print(f"  K {what}: mean rel err {rel:.3e} (tol "
              f"{ATTN_BF16_MEAN_REL:g}), max abs err {err:.3e}, worst element "
              f"beyond one ulp at {share:.3f} of its limit; replay bit-equal")
        del a, out


# time_ms measures device time: the card first spins for ~20 ms
# (torch.cuda._sleep) while the host queues the timed launches, so that a
# wrapper's host time between launches, which at the smallest shapes
# exceeds the kernel's, does not count as the kernel's.
SPIN_CYCLES = 40_000_000


def time_ms(fn, iters=20, warmup=3):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SPIN_CYCLES)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def phase_times(gen):
    """ms, plain_ms, library_ms and bound_ms of each kernel at its widest
    main-path shape; inputs of K1 and K3 (52 MB each) exceed the 50 MB L2."""
    rows = {}

    B, HW, C, silu = GN_SHAPES[0]
    a = gn_case(gen, B, HW, C, silu)
    x_nchw = a[0].reshape(B, 32, 32, C).permute(0, 3, 1, 2)
    n = B * HW * C
    rows["gn_silu"] = dict(
        ms=time_ms(lambda: group_norm(*a)),
        plain_ms=time_ms(lambda: group_norm_silu_reference(*a)),
        library_ms=time_ms(lambda: F.silu(F.group_norm(x_nchw, 32, a[1], a[2],
                                                       1e-6))),
        # one fp32 read and one write; ~7 flops of GN and 4 of SiLU each
        bytes=2 * n * 4 + 2 * C * 4, ops={"fp32": 11 * n})

    B, R, Cin, Cout = CONV_SHAPES[0]
    a = conv_case(gen, B, R, Cin, Cout)
    nbytes, ops = conv_work(B, R, R, Cin, Cout)
    rows["gn_silu_conv3x3"] = dict(
        ms=time_ms(lambda: gn_silu_conv(*a)),
        plain_ms=time_ms(lambda: gn_silu_conv_reference(*a)),
        library_ms=time_ms(conv_library(a)), bytes=nbytes, ops=ops)
    del a

    rows.update(attn_fp32_time_rows(gen))
    rows.update(adm_time_rows(gen))
    rows.update(int8_time_rows(gen))
    rows.update(cifar_int8_time_rows(gen))
    attn_block_splits(gen)
    conv_splits(gen)
    rows.update(train_time_rows(gen))
    rows.update(bf16_time_rows(gen))
    peaks = {"fp32": FP32_FLOPS, "bf16": BF16_FLOPS, "int8": INT8_OPS,
             "tf32x3": TF32X3_FLOPS}
    for name, r in rows.items():
        t_bytes = r["bytes"] / HBM_BYTES_S * 1e3
        t_ops = sum(v / peaks[k] for k, v in r.pop("ops").items()) * 1e3
        r["bound_ms"] = max(t_bytes, t_ops)
        r["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
        print(f"  T {name}: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f}"
              f" ms, library {r['library_ms']:.4f} ms, bound "
              f"{r['bound_ms']:.4f} ms ({r['bound_by']}: bytes "
              f"{t_bytes:.4f} ms, ops {t_ops:.4f} ms)")
    return rows


def bf16_time_rows(gen):
    """T rows of the CIFAR-10 bf16 forms at their widest main-path shapes:
    K3 on bf16 x (100, 32x32, 128->128) beside F.group_norm + F.silu +
    cuDNN's bf16 conv; K2 bf16 at (100, 256, 256), one head of d = 256, and
    K7 bf16 at E4's (128, 256, 256) bb 4, beside GN + torch.matmul + SDPA
    at d = 256 in bf16."""
    rows = {}
    B, R, Cin, Cout = K3_BF16_SHAPES[0]
    a = list(conv_case(gen, B, R, Cin, Cout))
    a[0] = a[0].bfloat16()
    nbytes, ops = conv_work(B, R, R, Cin, Cout, esize=2)
    rows["gn_silu_conv3x3_bf16"] = dict(
        ms=time_ms(lambda: gn_silu_conv(*a)),
        plain_ms=time_ms(lambda: gn_silu_conv_reference(*a)),
        library_ms=time_ms(conv_library(a)), bytes=nbytes, ops=ops)
    del a
    for name, (B, S, C, _, bb) in (
            ("attn_block_bf16_d256", K2_D256_SHAPES[0]),
            ("attn_block_bb_bf16", BB_D256_SHAPES[0])):
        a = attn_bf16_case(gen, B, S, C)
        x, gs, gb, wqkv, bqkv, wp, bp = a

        def library_attn():
            g = F.group_norm(x.transpose(1, 2), 32, gs.bfloat16(),
                             gb.bfloat16(), 1e-6).transpose(1, 2)
            q, k, v = (g @ wqkv + bqkv).split(C, dim=-1)
            return x + F.scaled_dot_product_attention(q, k, v) @ wp + bp

        if bb == 1:
            ms = time_ms(lambda: attn_block(*a, num_heads=1, eps=1e-6))
            plain = time_ms(lambda: attn_block_reference(*a, num_heads=1,
                                                         eps=1e-6))
        else:
            ms = time_ms(lambda: attn_block_bb(*a, num_heads=1, eps=1e-6,
                                               bb=bb))
            plain = time_ms(lambda: attn_block_bb_reference(
                *a, num_heads=1, eps=1e-6, bb=bb), iters=3, warmup=1)
        rows[name] = dict(
            ms=ms, plain_ms=plain, library_ms=time_ms(library_attn),
            bytes=(2 * B * S * C + 4 * C * C + 4 * C) * 2 + 2 * C * 4,
            ops={"bf16": 2 * B * S * C * 3 * C + 4 * B * S * S * C
                 + 2 * B * S * C * C, "fp32": 5 * B * S * S})
        del a, x
    B, S, C, nh = CORE_SHAPES[0]
    qkv = core_case(gen, B, S, C, nh)
    q, k, v = (t.transpose(1, 2) for t in
               qkv.reshape(B, S, 3, nh, C // nh).unbind(2))
    rows["attn_core_wide"] = dict(
        ms=time_ms(lambda: attn_core_wide(qkv, nh)),
        plain_ms=time_ms(lambda: attn_core_reference(qkv, nh)),
        library_ms=time_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, scale=1.0)),
        **core_work(B, S, C, nh))
    del qkv, q, k, v
    return rows


def core_case(gen, B, S, C, nh):
    """A (B, S, 3C) bf16 qkv buffer as the qkv GEMM leaves it: q and k
    scaled by d^-1/4 (logits of unit scale), v of unit scale."""
    qkv = randn(gen, B, S, 3 * C)
    qkv[..., :2 * C] *= (C // nh) ** -0.25
    return qkv.bfloat16()


def core_work(B, S, C, nh):
    """Bytes (q, k, v read, o written) and operations (q k^T and p v once;
    ~5 flops of softmax per logit) of the attention core."""
    return dict(bytes=4 * B * S * C * 2,
                ops={"bf16": 4 * B * S * S * C, "fp32": 5 * B * nh * S * S})


def library_attn_block(x, gs, gb, wqkv, bqkv, wp, bp):
    """The fp32 single-head block from PyTorch calls (F.group_norm, matmuls,
    SDPA), the yardstick of K2 fp32 and K7."""
    C = x.shape[-1]
    g = F.group_norm(x.transpose(1, 2), 32, gs, gb, 1e-6).transpose(1, 2)
    q, k, v = (g @ wqkv + bqkv).split(C, dim=-1)
    o = F.scaled_dot_product_attention(q, k, v)
    return x + o @ wp + bp


def attn_fp32_work(B, S, C):
    """Bytes and operations of the fp32 single-head block: x read, y
    written, the weights; the qkv, logits, AV and proj products as 3xTF32
    tensor-core products; ~5 flops of softmax per logit."""
    return dict(bytes=(2 * B * S * C + 4 * C * C + 5 * C) * 4,
                ops={"tf32x3": 2 * B * S * C * 3 * C + 4 * B * S * S * C
                     + 2 * B * S * C * C, "fp32": 5 * B * S * S})


def attn_fp32_time_rows(gen):
    """K2 fp32 (bb 1) and K7 (bb 2 and 4) on the same inputs at each of
    ATTN_SHAPES, beside K2's plain version and the library. The record
    keeps K2's row at the first shape and K7's (bb 4, E4's setting, against
    its own plain version) at E4's batch; the bound counts the block's
    products, the same work whatever the batch block."""
    rows = {}
    for B, S, C in ATTN_SHAPES:
        a = attn_case(gen, B, S, C)
        t = {name: time_ms(fn) for name, fn in (
            ("K2", lambda: attn_block(*a, num_heads=1, eps=1e-6, block_b=1)),
            ("K7 bb 2", lambda: attn_block_bb(*a, num_heads=1, eps=1e-6,
                                              bb=2)),
            ("K7 bb 4", lambda: attn_block_bb(*a, num_heads=1, eps=1e-6,
                                              bb=4)),
            ("plain", lambda: attn_block_reference(*a, num_heads=1,
                                                   eps=1e-6)),
            ("library", lambda: library_attn_block(*a)))}
        print(f"  T attn_block {(B, S, C)}: "
              + ", ".join(f"{k} {v:.4f} ms" for k, v in t.items())
              + " on the same inputs")
        rows.setdefault("attn_block", dict(
            ms=t["K2"], plain_ms=t["plain"], library_ms=t["library"],
            **attn_fp32_work(B, S, C)))
        if B == E4_BATCH:
            rows["attn_block_bb"] = dict(
                ms=t["K7 bb 4"], library_ms=t["library"],
                plain_ms=time_ms(lambda: attn_block_bb_reference(
                    *a, num_heads=1, eps=1e-6, bb=4), iters=3, warmup=1),
                **attn_fp32_work(B, S, C))
    return rows


def adm_time_rows(gen):
    """T rows of the ImageNet64 kernel forms. The first row of each form
    (its widest main-path shape; K1 in the entry's default bf16_onepass
    mode) is the one the JSON record keeps; the others are printed."""
    rows = {}
    for (B, HW, C, silu) in ADM_GN_SHAPES:
        for mode in GN_MODES:
            a = gn_bf16_case(gen, B, HW, C, silu, mode)
            R = int(HW ** 0.5)
            x_nchw = a[0].reshape(B, R, R, C).permute(0, 3, 1, 2)
            s16, b16 = a[1].bfloat16(), a[2].bfloat16()
            n = B * HW * C
            name = ("gn_silu_bf16" if not rows else
                    f"gn_silu_bf16 {(B, HW, C)} {mode}")
            rows[name] = dict(
                ms=time_ms(lambda: group_norm(*a)),
                plain_ms=time_ms(lambda: group_norm_silu_reference(*a)),
                library_ms=time_ms(lambda: F.silu(F.group_norm(
                    x_nchw, 32, s16, b16, 1e-5))),
                # one bf16 read and one write; ~7 flops of GN and 4 of SiLU
                bytes=2 * n * 2 + 2 * C * 4, ops={"fp32": 11 * n})
    for i, (B, S, C, nh) in enumerate(ADM_ATTN_SHAPES):
        a = attn_bf16_case(gen, B, S, C)
        x, gs, gb, wqkv, bqkv, wp, bp = a
        d = C // nh

        def library_attn():
            g = F.group_norm(x.transpose(1, 2), 32, gs.bfloat16(),
                             gb.bfloat16(), 1e-5).transpose(1, 2)
            q, k, v = (g @ wqkv + bqkv).reshape(B, S, 3, nh, d).permute(
                2, 0, 3, 1, 4)
            o = F.scaled_dot_product_attention(q, k, v, scale=d ** -0.5)
            return x + o.transpose(1, 2).reshape(B, S, C) @ wp + bp

        name = "attn_block_bf16" if i == 0 else f"attn_block_bf16 {(B, S, C, nh)}"
        rows[name] = dict(
            ms=time_ms(lambda: attn_block(*a, num_heads=nh)),
            plain_ms=time_ms(lambda: attn_block_reference(*a, num_heads=nh)),
            library_ms=time_ms(library_attn),
            bytes=(2 * B * S * C + 4 * C * C + 4 * C) * 2 + 2 * C * 4,
            # qkv, logits, AV and proj products; ~5 flops of softmax per logit
            ops={"bf16": 2 * B * S * C * 3 * C + 4 * B * S * S * C
                 + 2 * B * S * C * C, "fp32": 5 * B * nh * S * S})
    for i, (B, S, nh, d) in enumerate(FLASH_SHAPES + FLASH_TIME_SHAPES):
        if i == 0:  # flash_mha on three tensors, the E2 flash path's call
            q, k, v, sm = flash_case(gen, B, S, nh, d)
            name = "flash_attn"
        else:  # views of one qkv buffer, as K2 bf16, K5 and training
            q, k, v = flash_views(gen, B, S, nh, d, "qkv")
            sm = d ** -0.5
            name = f"flash_attn {(B, S, nh, d)}"
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        rows[name] = dict(
            ms=time_ms(lambda: flash_fwd_kernel(q, k, v, sm)),
            plain_ms=time_ms(lambda: flash_mha_reference(q, k, v, sm)),
            library_ms=time_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, scale=sm)),
            bytes=4 * B * S * nh * d * 2,
            ops={"bf16": 4 * B * nh * S * S * d, "fp32": 5 * B * nh * S * S})
    return rows


def int8_time_rows(gen):
    """T rows of K5 (bf16, the ImageNet64 32x32 map first, then the other
    maps, printed) and K8 (the widest ImageNet64 conv, then the phase and
    64x64 convs). Library yardsticks: K5, the same block from PyTorch calls
    (bf16 GN, the int8 products as torch._int_mm, SDPA); K8, one
    torch._int_mm on the im2col matrix (built outside the timed call)."""
    rows = {}
    for i, (B, S, C, nh, dt) in enumerate(I8_ATTN_SHAPES[1:]):
        a = attn_i8_case(gen, B, S, C, nh, dt)
        x, gs, gb, m, bq, bp = a
        d = C // nh

        def library_attn():
            g = F.group_norm(x.transpose(1, 2), 32, gs.bfloat16(),
                             gb.bfloat16(), 1e-5).transpose(1, 2)
            hq = torch.clamp(torch.round(g.float() * m.isa_q), -127,
                             127).to(torch.int8).reshape(B * S, C)
            qkv = (torch._int_mm(hq, m.wq.t()).float() * m.swq + bq).bfloat16()
            q, k, v = qkv.reshape(B, S, 3, nh, d).permute(2, 0, 3, 1, 4)
            o = F.scaled_dot_product_attention(q, k, v, scale=d ** -0.5)
            aq = torch.clamp(torch.round(o.transpose(1, 2).reshape(
                B * S, C).float() * m.isa_p), -127, 127).to(torch.int8)
            y = (torch._int_mm(aq, m.wp.t()).float() * m.swp + bp).bfloat16()
            return x + y.reshape(B, S, C)

        name = "attn_block_i8" if i == 0 else \
            f"attn_block_i8 {(B, S, C, nh)}"
        rows[name] = dict(
            ms=time_ms(lambda: attn_block_int8(*a, nh)),
            plain_ms=time_ms(lambda: attn_block_int8_plain(*a, nh), iters=3,
                             warmup=1),
            library_ms=time_ms(library_attn),
            # x read, y written (bf16); int8 weights; fp32 scales and biases
            bytes=2 * B * S * C * 2 + 4 * C * C + (3 * C * 3 + C * 3) * 4,
            ops={"int8": 2 * B * S * C * 4 * C, "bf16": 4 * B * S * S * C,
                 "fp32": 5 * B * nh * S * S + 8 * B * S * C})
    for i, shape in enumerate(I8_CONV_SHAPES[:2] + I8_CONV_SHAPES[5:6]):
        x, q, b, pad, dt, _ = conv_i8_case(gen, *shape)
        B, R, Cin, Cout = shape[:4]
        kh = q.w_i8.shape[1]
        nbytes, ops = k8_work(B, R, R, Cin, Cout, kh, kh, R, R,
                              x.element_size(), x.element_size())
        name = "int8_conv" if i == 0 else f"int8_conv {shape[:4]} pad {pad}"
        rows[name] = dict(
            ms=time_ms(lambda: int8_conv_apply(x, q, b, pad, dt)),
            plain_ms=time_ms(lambda: int8_conv_reference(x, q, b, pad, dt),
                             iters=3, warmup=1),
            library_ms=time_ms(k8_library(x, q, pad)), bytes=nbytes, ops=ops)
    return rows


def cifar_int8_time_rows(gen):
    """T rows of K8 at the CIFAR-10 net's int8 shapes (the stride-2 form's
    record row first), each beside its plain version and torch._int_mm on
    the im2col matrix; and of K1 at the widest CIFAR-10 bf16 map in E-int8
    (a)'s fp32 statistics and (b)'s bf16_onepass, beside its plain version
    and F.group_norm + F.silu."""
    rows = {}
    for B, mode in ((BATCH, "fp32"), (96, "bf16_onepass")):
        a = gn_bf16_case(gen, B, 1024, 128, True, mode)
        x_nchw = a[0].reshape(B, 32, 32, 128).permute(0, 3, 1, 2)
        s16, b16 = a[1].bfloat16(), a[2].bfloat16()
        n = B * 1024 * 128
        rows[f"gn_silu_bf16 CIFAR {(B, 1024, 128)} {mode}"] = dict(
            ms=time_ms(lambda: group_norm(*a)),
            plain_ms=time_ms(lambda: group_norm_silu_reference(*a)),
            library_ms=time_ms(lambda: F.silu(F.group_norm(
                x_nchw, 32, s16, b16, 1e-5))),
            bytes=2 * n * 2 + 2 * 128 * 4, ops={"fp32": 11 * n})
    for i, shape in enumerate(CIFAR_I8_CONV_SHAPES):
        x, q, b, pad, dt, stride = conv_i8_case(gen, *shape)
        B, R, Cin, Cout = shape[:4]
        k = shape[7]
        Ho, Wo = out_size(R, R, k, k, pad, stride)
        name = ("int8_conv_s2" if i == 0
                else f"int8_conv{'_s2' if stride == 2 else ''} CIFAR "
                f"{(B, R, Cin, Cout)} {k}x{k} pad {pad} {str(dt)[6:]}")
        nbytes, ops = k8_work(B, Ho, Wo, Cin, Cout, k, k, R, R,
                              x.element_size(), x.element_size())
        rows[name] = dict(
            ms=time_ms(lambda: int8_conv_apply(x, q, b, pad, dt,
                                               stride=stride)),
            plain_ms=time_ms(lambda: int8_conv_reference(x, q, b, pad, dt,
                                                         stride),
                             iters=3, warmup=1),
            library_ms=time_ms(k8_library(x, q, pad, stride)),
            bytes=nbytes, ops=ops)
        del x
    return rows


# The launches of one K2 bf16 or K5 (bf16) call after K1's statistics, in
# order, as (label, kernel name part, bytes, ops) given (B, S, C, nh) and
# the GEMMs' operand size (2: bf16, 1: int8). Bytes: each input read once,
# each output written once; the GEMMs' weights with their inputs.
def attn_block_launches(B, S, C, nh, es):
    M = B * S
    work = core_work(B, S, C, nh)
    core = (("core (K4)", "flash_fwd_kernel") if C // nh <= 128 else
            ("core (wide)", "attn_core_wide_kernel")) + (work["bytes"],
                                                         work["ops"])
    gemm = "int8" if es == 1 else "bf16"
    qkv = ("qkv GEMM", "gemm_kernel", M * C * es + 3 * C * C * es + M * 3 * C * 2,
           {gemm: 2 * M * C * 3 * C})
    proj = ("proj GEMM", "gemm_kernel", M * C * es + C * C * es + 2 * M * C * 2,
            {gemm: 2 * M * C * C})
    if es == 2:
        return [("GN apply", "prep_kernel", 2 * M * C * 2, {}), qkv, core,
                proj]
    return [("GN + quantise", "prep_kernel", M * C * 3, {}), qkv, core,
            ("quantise", "prep_kernel", M * C * 3, {}), proj]


def launch_split(fn, n_launches, reps=5):
    """Device time of each launch of one ``fn`` call after K1's statistics,
    averaged over the calls of ``reps`` whose launches the trace holds
    (torch.profiler), and the statistics' total: (statistics ms, [(kernel,
    ms) per launch]), or None when it holds no call whole."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    evs = sorted((e for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA),
                 key=lambda e: e.time_range.start)
    calls, cur = [], None
    for e in evs:  # a call starts with K1's statistics kernels
        stats = e.name.startswith("void (anonymous namespace)::gn_")
        if stats and (cur is None or cur[1]):
            cur = [[], []]
            calls.append(cur)
        if cur is not None:
            cur[1 if cur[1] or not stats else 0].append(
                (e.name, e.time_range.elapsed_us() / 1e3))
    calls = [c for c in calls if len(c[1]) == n_launches]
    if not calls:
        return None
    st = sum(sum(ms for _, ms in c[0]) for c in calls) / len(calls)
    return st, [(calls[0][1][i][0],
                 sum(c[1][i][1] for c in calls) / len(calls))
                for i in range(n_launches)]


def attn_block_splits(gen):
    """T: K2 bf16 at the three ImageNet64 maps and at the CIFAR-10 16x16
    blocks' d = 256, K7 bf16 at E4's (128, 256, 256) bb 4 and K5 (bf16) at
    the ImageNet64 maps and LSUN's C = 1024 map, split by launch, each
    beside its bound."""
    peaks = {"bf16": BF16_FLOPS, "int8": INT8_OPS, "fp32": FP32_FLOPS}
    cases = [("K2 bf16", (B, S, C, nh), 2) for B, S, C, nh in ADM_ATTN_SHAPES]
    cases += [("K2 bf16", K2_D256_SHAPES[0][:4], 2),
              ("K7 bf16 bb 4", BB_D256_SHAPES[0][:4], 2)]
    cases += [("K5", sh[:4], 1) for sh in I8_ATTN_SHAPES[1:]]
    for label, (B, S, C, nh), es in cases:
        if label.startswith("K7"):
            a = attn_bf16_case(gen, B, S, C)
            fn = lambda: attn_block_bb(*a, num_heads=nh, bb=4)  # noqa: E731
        elif es == 2:
            a = attn_bf16_case(gen, B, S, C)
            fn = lambda: attn_block(*a, num_heads=nh)  # noqa: E731
        else:
            a = attn_i8_case(gen, B, S, C, nh, torch.bfloat16)
            fn = lambda: attn_block_int8(*a, nh)  # noqa: E731
        parts = attn_block_launches(B, S, C, nh, es)
        split = launch_split(fn, len(parts))
        if split is None:
            print(f"  T split {label} {(B, S, C, nh)}: not measured (the "
                  "trace lost launches)")
            continue
        st, times = split
        out = [f"statistics {st:.4f} (bound "
               f"{B * S * C * 2 / HBM_BYTES_S * 1e3:.4f} bytes)"]
        for (name, part, nbytes, ops), (kernel, ms) in zip(parts, times):
            if part not in kernel:
                raise AssertionError(f"{label}: launch {name} ran {kernel}")
            t_bytes = nbytes / HBM_BYTES_S * 1e3
            t_ops = sum(v / peaks[k] for k, v in ops.items()) * 1e3
            bound = max(t_bytes, t_ops)
            out.append(f"{name} {ms:.4f} (bound {bound:.4f} "
                       f"{'bytes' if t_bytes >= t_ops else 'ops'}; ops "
                       f"{t_ops:.4f}, {bound / ms:.0%} of bound)")
        print(f"  T split {label} {(B, S, C, nh)}, ms: " + " | ".join(out))
        del a


# K3's launches (profiler kernel-name substrings, checked in this order) and
# (bytes, ops) of each: the bf16 copy of the weights, K1's statistics pass,
# the conv, and the sum of its split slices when it splits
K3_PARTS = (("reduce", "conv3x3_reduce"), ("conv", "conv3x3"),
            ("statistics", "::gn_"), ("weight cast", ""))
K3_SPLIT_SHAPES = [(BATCH, 32, 128, 128), (BATCH, 16, 256, 256),
                   (BATCH, 8, 256, 256), (BATCH, 4, 256, 256)]


def k3_launch_work(part, B, R, Cin, Cout, slices):
    M = B * R * R
    if part == "weight cast":
        return 9 * Cin * Cout * 6, {}
    if part == "statistics":
        return M * Cin * 4, {}
    if part == "reduce":
        return (slices + 1) * M * Cout * 4, {}
    return ((M * Cin + slices * M * Cout + 2 * B * Cin) * 4
            + 9 * Cin * Cout * 2, {"bf16": 2 * M * Cout * 9 * Cin,
                                   "fp32": 11 * M * Cin})


def conv_splits(gen, reps=5):
    """T: K3 at one shape of each map size split by launch (torch.profiler
    device time, a call's launches of each kind summed and averaged over
    ``reps`` calls), each beside its bound."""
    peaks = {"bf16": BF16_FLOPS, "fp32": FP32_FLOPS}
    for shape in K3_SPLIT_SHAPES:
        a = conv_case(gen, *shape)
        gn_silu_conv(*a)
        torch.cuda.synchronize()
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                gn_silu_conv(*a)
            torch.cuda.synchronize()
        ms, n = collections.Counter(), collections.Counter()
        for e in prof.events():
            if e.device_type != torch.autograd.DeviceType.CUDA:
                continue
            part = next(p for p, key in K3_PARTS if key in e.name)
            ms[part] += e.time_range.elapsed_us() / 1e3 / reps
            n[part] += 1
        if not ms["conv"]:
            print(f"  T split K3 {shape}: not measured (the trace holds no "
                  "conv launch)")
            continue
        slices = (conv_fused.plan(shape[0], shape[1], shape[1], *shape[2:])
                  .slices if n["reduce"] else 1)
        out = []
        for part, _ in reversed(K3_PARTS):
            if not n[part]:
                continue
            nbytes, ops = k3_launch_work(part, *shape, slices)
            t_bytes = nbytes / HBM_BYTES_S * 1e3
            t_ops = sum(v / peaks[k] for k, v in ops.items()) * 1e3
            bound = max(t_bytes, t_ops)
            out.append(f"{part} {ms[part]:.4f} x{n[part] / reps:g} (bound "
                       f"{bound:.4f} {'bytes' if t_bytes >= t_ops else 'ops'};"
                       f" {bound / ms[part]:.0%} of bound)")
        print(f"  T split K3 {shape}, ms: " + " | ".join(out)
              + f"; sum {sum(ms.values()):.4f}")
        del a


def phase_replay():
    golden = np.load(os.path.join(FIXTURE_DIR, "golden.npz"))
    state = load_sampler_state(os.path.join(FIXTURE_DIR, "sampler_best.pth"))
    errs = {}
    for fuse in (False, True):
        _lib.reset_launches()
        sampler = load_sampler(fixture_config(), state, "cuda",
                               fuse_gn_conv=fuse)
        x = torch.from_numpy(golden["x0"]).cuda()
        worst = 0.0
        with torch.no_grad():
            for t in range(sampler.n_timesteps):
                out = sampler.sample_step(
                    x, t, noise=torch.from_numpy(golden["eps"][t]).cuda())
                ref_mean = golden["means"][t]
                err = float(np.abs(out["mean"].cpu().numpy() - ref_mean).max())
                worst = max(worst, err)
                if err > REPLAY_TOL[fuse]:
                    raise AssertionError(f"fuse_gn_conv={fuse} step {t}: "
                                         f"mean err {err:.3e}")
                np.testing.assert_allclose(
                    out["sigma"].cpu().numpy().reshape(-1, 1, 1, 1),
                    golden["sigmas"][t], rtol=1e-5, atol=1e-7)
                x = torch.from_numpy(ref_mean + golden["sigmas"][t]
                                     * golden["eps"][t]).cuda()
        used = {k for k, v in _lib.LAUNCHES.items() if v}
        want = {"gn_silu", "attn_block"} | ({"gn_silu_conv3x3"} if fuse
                                            else set())
        if used != want:
            raise AssertionError(f"fuse_gn_conv={fuse}: launched {used}, "
                                 f"expected {want}")
        errs[fuse] = worst
        print(f"  G fuse_gn_conv={fuse}: max per-step mean err {worst:.3e} "
              f"(tol {REPLAY_TOL[fuse]:g}), kernels {sorted(used)}")
    return errs


def phase_generate(k3_log, rates):
    # warm-up outside the counted run (cuDNN plans, allocator)
    cfg = cifar10_t10()
    generate(cfg, None, BATCH, BATCH, "cuda", seed=1)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _lib.reset_launches()
    t0 = time.perf_counter()
    with k3_shapes(k3_log, "E", N_BATCHES, "trajectory"):
        x = generate(cfg, None, BATCH * N_BATCHES, BATCH, "cuda", seed=0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(_lib.LAUNCHES)
    if tuple(x.shape) != (BATCH * N_BATCHES, 3, 32, 32):
        raise AssertionError(f"samples of shape {tuple(x.shape)}")
    if not torch.isfinite(x).all():
        raise AssertionError("non-finite samples")
    want = {k: v * T * N_BATCHES for k, v in LAUNCHES_PER_FORWARD.items()}
    if launches != want:
        raise AssertionError(f"launches {launches}, expected {want}")
    peak = torch.cuda.max_memory_allocated()

    sampler = load_sampler(cfg, None, "cuda", seed=0)
    sample_batches(sampler, BATCH, BATCH, seed=2)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sample_batches(sampler, BATCH * N_BATCHES, BATCH, seed=3)
    torch.cuda.synchronize()
    steady = time.perf_counter() - t0
    rates["E"] = BATCH * N_BATCHES / steady
    print(f"  E launches {launches} (expected {want})")
    print(f"  E generate(): {x.shape[0]} samples in {wall:.3f} s with setup "
          f"({x.shape[0] / wall:.1f} img/s); sampling alone "
          f"{BATCH * N_BATCHES / steady:.1f} img/s; samples in "
          f"[{x.min().item():.3f}, {x.max().item():.3f}], std "
          f"{x.std().item():.3f}; peak allocated {peak / 2**20:.1f} MiB")
    rates["E profile"] = profile_run(
        lambda: sample_batches(sampler, BATCH, BATCH, seed=4),
        f"E profile, one trajectory of {BATCH}")
    return launches


def phase_generate_bf16(rates):
    """E-bf16: generate_cifar10 --dtype bf16's net (configs/cifar10/T10.yaml
    at full width, bf16 without int8, the port's fused defaults, random
    weights from a seed): 2 batches of 100 at T=10 with the launches of each
    kernel checked, img/s, a profiled trajectory's device time, idle share
    and K3's and K2's shares, beside E's fp32 figures from the same run."""
    cfg = cifar10_t10()
    generate(cfg, None, BATCH, BATCH, "cuda", seed=1, dtype="bf16")  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _lib.reset_launches()
    t0 = time.perf_counter()
    x = generate(cfg, None, BATCH * N_BATCHES, BATCH, "cuda", seed=0,
                 dtype="bf16")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(_lib.LAUNCHES)
    want = {k: v * T * N_BATCHES for k, v in BF16_LAUNCHES_PER_FORWARD.items()}
    if tuple(x.shape) != (BATCH * N_BATCHES, 3, 32, 32):
        raise AssertionError(f"E-bf16: samples of shape {tuple(x.shape)}")
    if not torch.isfinite(x).all():
        raise AssertionError("E-bf16: non-finite samples")
    if launches != want:
        raise AssertionError(f"E-bf16: launches {launches}, expected {want}")
    peak = torch.cuda.max_memory_allocated()
    x32 = generate(cfg, None, BATCH * N_BATCHES, BATCH, "cuda", seed=0)
    sampler = load_sampler(cfg, None, "cuda", seed=0, dtype="bf16")
    sample_batches(sampler, BATCH, BATCH, seed=2)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sample_batches(sampler, BATCH * N_BATCHES, BATCH, seed=3)
    torch.cuda.synchronize()
    rates["E-bf16"] = BATCH * N_BATCHES / (time.perf_counter() - t0)
    print(f"  E-bf16 launches a forward {BF16_LAUNCHES_PER_FORWARD}; "
          f"{launches} in 2 trajectories (expected {want})")
    print(f"  E-bf16 generate(): {x.shape[0]} samples in {wall:.3f} s with "
          f"setup ({x.shape[0] / wall:.1f} img/s); sampling alone "
          f"{rates['E-bf16']:.2f} img/s; samples in [{x.min().item():.3f}, "
          f"{x.max().item():.3f}], std {x.std().item():.3f}, mean |bf16 - "
          f"fp32| over the same seeds and weights "
          f"{(x - x32).abs().mean().item():.4f}; peak allocated "
          f"{peak / 2**20:.1f} MiB")
    prof = profile_run(
        lambda: sample_batches(sampler, BATCH, BATCH, seed=4),
        f"E-bf16 profile, one trajectory of {BATCH}", top=12,
        shares={"K3 (its conv launches)": ("conv3x3_",),
                "K2 (less K1's statistics)": ("prep_kernel", "gemm_kernel",
                                              "attn_core_wide_kernel"),
                "K1 (and K3's and K2's statistics)": ("gn_",)})
    e, e_prof = rates.get("E"), rates.get("E profile")
    if prof is not None:
        print(f"  E-bf16: {prof[0]:.2f} ms of device time a trajectory, idle "
              f"{1 - prof[0] / prof[1]:.1%}, {rates['E-bf16']:.2f} img/s; E "
              "(fp32) in this run: "
              + ("not run" if e is None or e_prof is None else
                 f"{e_prof[0]:.2f} ms, idle {1 - e_prof[0] / e_prof[1]:.1%}, "
                 f"{e:.2f} img/s"))
    del sampler
    torch.cuda.empty_cache()
    return launches


def profile_run(fn, label, top=12, width=90, shares=None):
    """Device time by kernel over one call of ``fn`` (torch.profiler), and
    the device's idle share of the wall time; kernel names cut to
    ``width`` characters. ``shares`` maps a label to the substrings of the
    kernel names it sums (the device time of one of the port's kernels
    over all its launches)."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = []
    for ev in prof.key_averages():
        dev_us = getattr(ev, "self_device_time_total",
                         getattr(ev, "self_cuda_time_total", 0))
        if dev_us > 0 and ev.device_type == torch.autograd.DeviceType.CUDA:
            rows.append((dev_us / 1e3, ev.count, ev.key))
    total = sum(r[0] for r in rows)
    if total == 0:
        print(f"  {label}: device time not measured (no CUDA events)")
        return None
    print(f"  {label}: device busy {total:.2f} ms of {wall_ms:.2f} ms wall "
          f"(idle {1 - total / wall_ms:.1%})")
    for ms, count, key in sorted(rows, reverse=True)[:top]:
        print(f"    {ms:9.3f} ms {ms / total:6.1%} x{count:<5d} {key[:width]}")
    for name, keys in (shares or {}).items():
        ms = sum(r[0] for r in rows if any(k in r[2] for k in keys))
        print(f"    {name}: {ms:.3f} ms, {ms / total:.1%} of the device's "
              f"busy time, {ms / wall_ms:.1%} of the wall time")
    return total, wall_ms


# E-int8: the CIFAR-10 net at full width under int8, (a) generate_cifar10
# --int8 with an fp32 and a bf16 torso (calibrated on 2 x 64 trajectories)
# and (b) bench.py's configuration at batch 96 through sample_many
E_INT8_PATHS = ("a_fp32", "a_bf16", "b")


def cifar_int8_sampler(path, seed=0):
    """E-int8's sampler for ``path``, seed-``seed`` weights, calibrated as
    its entry does."""
    if path == "b":
        return generate_cifar10.bench_sampler("cuda", seed)
    return load_sampler(cifar10_t10(), None, "cuda", seed, int8=True,
                        dtype=path[2:])


def phase_generate_int8(k1_log, rates):
    """E-int8 for each path: the sampler built and calibrated (setup, its
    launches counted: K1 alone, the int8 layers run full precision), a
    warm-up trajectory, then N_BATCHES trajectories with the launches
    counted (and K1's shapes for T-K1), then sampling alone, a profiled
    trajectory with K8's and K1's shares of its device time, and K8's time
    by shape over one more. Returns the launches of each path."""
    out, samples = {}, {}
    for path in E_INT8_PATHS:
        B = generate_cifar10.BENCH_BATCH if path == "b" else BATCH
        calib_forwards = T * (generate_cifar10.BENCH_CALIB["n_rounds"]
                              if path == "b" else
                              generate_cifar10.CALIB_N_ROUNDS)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        _lib.reset_launches()
        t0 = time.perf_counter()
        sampler = cifar_int8_sampler(path)
        torch.cuda.synchronize()
        setup = time.perf_counter() - t0
        calib = dict(_lib.LAUNCHES)

        def run(n, seed):
            if path == "b":
                gen = torch.Generator(device="cuda").manual_seed(seed)
                return sample_many(sampler, n, B, gen).reshape(n * B, 3, 32,
                                                               32)
            return sample_batches(sampler, n * B, B, seed)

        run(1, 1)
        torch.cuda.synchronize()
        _lib.reset_launches()
        t0 = time.perf_counter()
        with k1_shapes(k1_log, f"E-int8 {path}", N_BATCHES,
                       f"trajectory of {B}"):
            x = run(N_BATCHES, 0)
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = dict(_lib.LAUNCHES)
        peak = torch.cuda.max_memory_allocated()
        gn = "gn_silu" if path == "a_fp32" else "gn_silu_bf16"
        want_calib = {gn: CIFAR_INT8_LAUNCHES_PER_FORWARD[path][gn]
                      * calib_forwards}
        want = {k: v * T * N_BATCHES
                for k, v in CIFAR_INT8_LAUNCHES_PER_FORWARD[path].items()}
        if tuple(x.shape) != (B * N_BATCHES, 3, 32, 32):
            raise AssertionError(f"E-int8 {path}: samples of shape "
                                 f"{tuple(x.shape)}")
        if not torch.isfinite(x).all():
            raise AssertionError(f"E-int8 {path}: non-finite samples")
        if got != want or calib != want_calib:
            raise AssertionError(f"E-int8 {path}: launches {got} (calibration"
                                 f" {calib}), expected {want} ({want_calib})")
        t0 = time.perf_counter()
        run(N_BATCHES, 3)
        torch.cuda.synchronize()
        rates[f"E-int8 {path}"] = B * N_BATCHES / (time.perf_counter() - t0)
        samples[path] = x.cpu()
        print(f"  E-int8 {path}: calibration launches {calib} (expected "
              f"{want_calib}); sampling launches {got} (expected {want})")
        print(f"  E-int8 {path}: load + calibration {setup:.3f} s; "
              f"{x.shape[0]} samples in {wall:.3f} s ({x.shape[0] / wall:.2f}"
              f" img/s, warm); sampling alone {rates[f'E-int8 {path}']:.2f} "
              f"img/s; samples in [{x.min().item():.3f}, "
              f"{x.max().item():.3f}], std {x.std().item():.3f}; peak "
              f"allocated {peak / 2**20:.1f} MiB")
        profile_run(lambda: run(1, 4),
                    f"E-int8 {path} profile, one trajectory of {B}", top=12,
                    shares={"K8": ("int8_conv_kernel",),
                            "K1": ("gn_kernel", "gn_apply_kernel")})
        k8_shape_times(lambda: run(1, 5), f"E-int8 {path}, batch {B},",
                       library=True)
        del sampler
        torch.cuda.empty_cache()
        out[path] = got
    d = (samples["a_bf16"] - samples["a_fp32"]).abs().mean().item()
    e = rates.get("E")
    print(f"  E-int8 img/s (sampling alone): (a) fp32 "
          f"{rates['E-int8 a_fp32']:.2f}, (a) bf16 "
          f"{rates['E-int8 a_bf16']:.2f}, (b) at batch "
          f"{generate_cifar10.BENCH_BATCH} {rates['E-int8 b']:.2f}; E (fp32, "
          f"fused) in this run {'not run' if e is None else f'{e:.2f}'}; "
          f"mean |(a) bf16 - (a) fp32| over the same seeds {d:.4f} (sample "
          f"std {samples['a_fp32'].std().item():.3f})")
    return out


# G-bf16: the trained CIFAR fixture in bf16 (generate_cifar10 --dtype bf16)
# against the JAX package's bf16 step means (tests/torch_fixtures/
# cifar_bf16_golden.npz; each step from the golden's own state). A bf16 net
# amplifies single flipped roundings, so two bf16 arithmetics (and the same
# one under another fp32 sum order) differ about as much as bf16 differs
# from fp32: on the CPU the port's means are 1.11-1.13 times JAX's own bf16
# effect (its bf16 means against its fp32 ones from the same state) away
# from JAX's, unfused and fused, in the mean and at the largest element
# (tests/test_torch_cifar_bf16_golden.py). The gate: per step, the mean and
# the largest error within BF16_REPLAY_SHARE times the mean and the largest
# effect. A wrong kernel output (a K3 without its bias: 11.5x) lands far
# beyond.
CIFAR_BF16_GOLDEN = os.path.join(REPO, "tests", "torch_fixtures",
                                 "cifar_bf16_golden.npz")
BF16_REPLAY_SHARE = 2.0


def cifar_bf16_replay(device, fuse=True):
    """The CIFAR fixture's sampler in bf16 (fused defaults, or with
    ``fuse`` False unfused and einsum: the JAX entry's arithmetic), each
    step from CIFAR_BF16_GOLDEN's state with the fixture's noise. Returns
    the worst per-step (mean error / mean effect, largest error / largest
    effect) and the kernels launched; raises past BF16_REPLAY_SHARE."""
    golden = np.load(CIFAR_BF16_GOLDEN)
    gold = np.load(os.path.join(FIXTURE_DIR, "golden.npz"))
    state = load_sampler_state(os.path.join(FIXTURE_DIR, "sampler_best.pth"))
    sampler = load_sampler(fixture_config(), state, device, dtype="bf16",
                           fuse_gn_conv=fuse,
                           attn_impl="fused" if fuse else "einsum")
    _lib.reset_launches()
    x = torch.from_numpy(gold["x0"]).to(device)
    worst = [0.0, 0.0]
    with torch.no_grad():
        for t in range(sampler.n_timesteps):
            noise = torch.from_numpy(gold["eps"][t]).to(device)
            mean = sampler.sample_step(x, t, noise=noise)["mean"]
            err = np.abs(mean.cpu().numpy() - golden["means"][t])
            eff = np.abs(golden["means"][t] - golden["means_fp32"][t])
            ratios = (err.mean() / eff.mean(), err.max() / eff.max())
            worst = [max(a, float(b)) for a, b in zip(worst, ratios)]
            if max(ratios) > BF16_REPLAY_SHARE:
                raise AssertionError(
                    f"bf16 fuse_gn_conv={fuse} step {t}: error {ratios[0]:.3f}"
                    f" (mean) and {ratios[1]:.3f} (largest) times the bf16 "
                    f"effect (tol {BF16_REPLAY_SHARE:g})")
            x = torch.from_numpy(golden["means"][t] + gold["sigmas"][t]
                                 * gold["eps"][t]).to(device)
    return worst, {k for k, v in _lib.LAUNCHES.items() if v}


def phase_replay_bf16():
    """G-bf16 (see CIFAR_BF16_GOLDEN): fused (K3 bf16, K2 bf16 at the
    fixture's d = 64, K1 bf16) and unfused, each with its kernels."""
    out = {}
    for fuse in (True, False):
        worst, used = cifar_bf16_replay("cuda", fuse)
        want = ({"gn_silu_bf16", "gn_silu_conv3x3_bf16", "attn_block_bf16"}
                if fuse else {"gn_silu_bf16"})
        if used != want:
            raise AssertionError(f"G-bf16 fuse_gn_conv={fuse}: launched "
                                 f"{sorted(used)}, expected {sorted(want)}")
        print(f"  G-bf16 fuse_gn_conv={fuse}: worst step error "
              f"{worst[0]:.3f} (mean) and {worst[1]:.3f} (largest) times "
              f"JAX's bf16 effect (tol {BF16_REPLAY_SHARE:g}); kernels "
              f"{sorted(used)}")
        out[fuse] = worst
    return out


def phase_replay_int8():
    """G-int8: the trained CIFAR fixture under --int8 (fp32 net: K8 at every
    ResnetBlock conv, attention 1x1 and Upsample conv, its stride-2 form at
    the Downsample, K1 at every GroupNorm): calibration from the golden's
    injected draws against JAX's scales, then the int8 step means with
    JAX's scales against JAX's (G2-int8's gates), the full-precision step
    from the same state the unfused fp32 net (JAX's arithmetic)."""
    golden = dict(np.load(CIFAR_INT8_GOLDEN))
    gold = dict(np.load(os.path.join(FIXTURE_DIR, "golden.npz")))
    state = load_sampler_state(os.path.join(FIXTURE_DIR, "sampler_best.pth"))
    cfg = fixture_config()
    sampler = load_sampler(cfg, state, "cuda", quant_int8="static")
    fp_sampler = load_sampler(cfg, state, "cuda", fuse_gn_conv=False,
                              attn_impl="einsum")
    x0, eps = cifar_int8_calib_draws(int(golden["calib_seed"]))
    sampler.calibrate_quant(n_sample=x0.shape[1], n_rounds=x0.shape[0],
                            x0=torch.from_numpy(x0).cuda(),
                            eps=torch.from_numpy(eps).cuda())
    ours = {k: v.clone() for k, v in sampler.net.state_dict().items()}
    want = load_int8_golden_scales(sampler.net, golden)
    worst_scale = max(float((ours[k].cpu() - v).abs().max() / v.abs().max())
                      for k, v in want.items())
    if not worst_scale <= INT8_SCALE_REL:
        raise AssertionError(f"calibrated scales {worst_scale:.3e} from "
                             "JAX's")
    _lib.reset_launches()
    steps, final = replay_int8(sampler, fp_sampler, golden, gold, "cuda")
    used = {k for k, v in _lib.LAUNCHES.items() if v}
    print(f"  G-int8: {len(want)} calibrated scales within {worst_scale:.3e}"
          f" of JAX's (tol {INT8_SCALE_REL:g})")
    print("  G-int8: per-step mean err / int8 effect "
          + " ".join(f"{r:.3f}" for r, _, _ in steps)
          + f" (tol {INT8_STEP_RATIO:g}); median err / int8 effect "
          + " ".join(f"{m:.3f}" for _, m, _ in steps)
          + f" (average tol {INT8_MEDIAN_RATIO:g}); max abs err "
          + " ".join(f"{e:.2e}" for _, _, e in steps)
          + f"; final {final:.3e}; kernels {sorted(used)}")
    worst, median = check_int8_replay(steps)
    print(f"  G-int8: worst mean ratio {worst:.3f}, median ratio averaged "
          f"over the steps {median:.4f}")
    if used != {"gn_silu", "int8_conv", "int8_conv_s2"}:
        raise AssertionError(f"launched {used}")
    return worst


def phase_replay_adm():
    """The trained ADM fixture's trajectory (fp32, nh 2 at 8x8, d 32): each
    step restarted from the golden mean with the golden eps and labels; the
    limits of tests/test_golden_adm_fixture.py (per-step mean 5e-3, sigma
    1e-5 rel, final sample 5e-3)."""
    golden = np.load(os.path.join(ADM_FIXTURE_DIR, "golden.npz"))
    state = load_sampler_state(os.path.join(ADM_FIXTURE_DIR, "sampler.pth"))
    y = torch.from_numpy(golden["y"]).long().cuda()
    errs = {}
    for impl in ("einsum", "fused"):
        _lib.reset_launches()
        sampler = generate_large.load_sampler(
            adm_fixture_config(), state, "cuda", attn_impl=impl,
            up_impl="resize", gn_stats="fp32")
        x = torch.from_numpy(golden["x_init"]).cuda()
        worst = 0.0
        with torch.no_grad():
            for t in range(sampler.n_timesteps):
                eps = torch.from_numpy(golden["eps"][t]).cuda()
                out = sampler.sample_step(x, t, noise=eps, y=y)
                err = float(np.abs(out["mean"].cpu().numpy()
                                   - golden["means"][t]).max())
                worst = max(worst, err)
                if err > 5e-3:
                    raise AssertionError(f"attn_impl={impl} step {t}: mean "
                                         f"err {err:.3e}")
                np.testing.assert_allclose(
                    out["sigma"].cpu().numpy().reshape(-1, 1, 1, 1),
                    golden["sigmas"][t], rtol=1e-5, atol=1e-6)
                x = torch.from_numpy(golden["means"][t] + golden["sigmas"][t]
                                     * golden["eps"][t]).cuda()
        final = float(np.abs(out["sample"].cpu().numpy()
                             - golden["final"]).max())
        if final > 5e-3:
            raise AssertionError(f"attn_impl={impl}: final err {final:.3e}")
        used = {k for k, v in _lib.LAUNCHES.items() if v}
        want = {"gn_silu"} | ({"attn_block"} if impl == "fused" else set())
        if used != want:
            raise AssertionError(f"attn_impl={impl}: launched {used}, "
                                 f"expected {want}")
        errs[impl] = worst
        print(f"  G2 attn_impl={impl}: max per-step mean err {worst:.3e} "
              f"(tol 5e-3), final {final:.3e}, kernels {sorted(used)}")
    return errs


# G2-int8: the port's int8 step means against JAX's (INT8_GOLDEN), each step
# restarted from the golden state. An int8 trajectory amplifies fp32 noise:
# a value at a rounding boundary flips by one int8 level, and on the CPU a
# 1e-7 relative perturbation of the port's own input already moves a step
# mean by up to 0.16 (7e-3 on average over its elements). Each step is read
# against the effect of int8 itself, the distance between JAX's int8 step
# and the port's full-precision step from the same state, in two ways:
# - INT8_STEP_RATIO: per step, the mean error over the elements is at most
#   half the mean int8 effect (the port on the CPU: 0.03-0.23). Running in
#   full precision, or a kernel fault, fails it.
# - INT8_MEDIAN_RATIO: averaged over the steps, the median error over the
#   elements is at most 0.1 of the median int8 effect. Rounding flips under
#   fp32 noise move a minority of the elements, so the median barely sees
#   them (the port on the CPU: 0.011-0.030, its input as given and under
#   six 1e-7 perturbations); a layer wired wrong moves them all. Planted
#   on the CPU, attention blocks left in full precision read 0.253, the
#   phase up-block in full precision 0.258, one conv's scale doubled 0.262
#   and left at zero 7.85 (tests/test_torch_adm_int8_golden.py).
# The calibrated scales agree with JAX's within 1e-4 of each buffer's
# largest (5e-6 on the CPU: the quantile of |x| barely moves with fp32
# noise). tests/torch_fixtures/int8_cpu_report.py prints the CPU figures.
INT8_STEP_RATIO = 0.5
INT8_MEDIAN_RATIO = 0.1
INT8_SCALE_REL = 1e-4


def replay_int8(sampler, fp_sampler, golden, gold, device):
    """Per-step (mean ratio, median ratio, max abs err) of an int8 sampler
    against the golden int8 step means, each step from the golden state
    (``gold``: a fixture's golden.npz, ADM with labels or CIFAR without);
    the ratios are the error's mean (median) over the elements over the
    mean (median) distance of the full-precision step."""
    y = (torch.from_numpy(gold["y"]).long().to(device) if "y" in gold
         else None)
    x = torch.from_numpy(gold["x_init"] if "x_init" in gold
                         else gold["x0"]).to(device)
    out = []
    with torch.no_grad():
        for t in range(sampler.n_timesteps):
            eps = torch.from_numpy(gold["eps"][t]).to(device)
            step = sampler.sample_step(x, t, noise=eps, y=y)
            mean = step["mean"].cpu().numpy()
            fp = fp_sampler.sample_step(x, t, noise=eps, y=y)["mean"]
            ref = golden["means"][t]
            err = np.abs(mean - ref)
            effect = np.abs(fp.cpu().numpy() - ref)
            out.append((float(err.mean() / effect.mean()),
                        float(np.median(err) / np.median(effect)),
                        float(err.max())))
            x = torch.from_numpy(ref + gold["sigmas"][t]
                                 * gold["eps"][t]).to(device)
    final = float(np.abs(step["sample"].cpu().numpy()
                         - golden["final"]).max())
    return out, final


def check_int8_replay(steps):
    """G2-int8's gates on ``replay_adm_int8``'s readings; returns (worst
    per-step mean ratio, median ratio averaged over the steps) or raises."""
    worst = max(r for r, _, _ in steps)
    median = float(np.mean([m for _, m, _ in steps]))
    if not worst <= INT8_STEP_RATIO:
        raise AssertionError(f"int8 step means {worst:.3f} of the int8 "
                             "effect from JAX's")
    if not median <= INT8_MEDIAN_RATIO:
        raise AssertionError(f"int8 step means' median error {median:.3f} "
                             "of the int8 effect from JAX's")
    return worst, median


def load_int8_golden_scales(net, golden):
    scales = {k[len("scale/"):]: torch.from_numpy(v)
              for k, v in golden.items() if k.startswith("scale/")}
    _, unexpected = net.load_state_dict(scales, strict=False)
    if unexpected:
        raise AssertionError(f"golden scales with no buffer: {unexpected}")
    net.prepare_int8()
    return scales


def phase_replay_adm_int8():
    """The trained ADM fixture under --int8 (fp32 net: K5 in fp32 at the
    8x8 maps, K8 at every ResBlock conv, four phase convs in the up-block):
    calibration from the golden's injected draws against JAX's scales, then
    the int8 step means with JAX's scales against JAX's (both gates
    above)."""
    golden = dict(np.load(INT8_GOLDEN))
    gold = np.load(os.path.join(ADM_FIXTURE_DIR, "golden.npz"))
    state = load_sampler_state(os.path.join(ADM_FIXTURE_DIR, "sampler.pth"))
    cfg = adm_fixture_config()
    sampler = generate_large.load_sampler(cfg, state, "cuda", int8=True)
    fp_sampler = generate_large.load_sampler(cfg, state, "cuda")
    x0, eps, ys = adm_int8_calib_draws(int(golden["calib_seed"]))
    sampler.calibrate_quant(n_sample=x0.shape[1], n_rounds=x0.shape[0],
                            x0=torch.from_numpy(x0).cuda(),
                            eps=torch.from_numpy(eps).cuda(),
                            y=torch.from_numpy(ys).cuda())
    ours = {k: v.clone() for k, v in sampler.net.state_dict().items()}
    want = load_int8_golden_scales(sampler.net, golden)
    worst_scale = max(float((ours[k].cpu() - v).abs().max() / v.abs().max())
                      for k, v in want.items())
    if not worst_scale <= INT8_SCALE_REL:
        raise AssertionError(f"calibrated scales {worst_scale:.3e} from "
                             "JAX's")
    _lib.reset_launches()
    steps, final = replay_int8(sampler, fp_sampler, golden, gold, "cuda")
    used = {k for k, v in _lib.LAUNCHES.items() if v}
    print(f"  G2-int8: {len(want)} calibrated scales within {worst_scale:.3e}"
          f" of JAX's (tol {INT8_SCALE_REL:g})")
    print("  G2-int8: per-step mean err / int8 effect "
          + " ".join(f"{r:.3f}" for r, _, _ in steps)
          + f" (tol {INT8_STEP_RATIO:g}); median err / int8 effect "
          + " ".join(f"{m:.3f}" for _, m, _ in steps)
          + f" (average tol {INT8_MEDIAN_RATIO:g}); max abs err "
          + " ".join(f"{e:.2e}" for _, _, e in steps)
          + f"; final {final:.3e}; kernels {sorted(used)}")
    worst, median = check_int8_replay(steps)
    print(f"  G2-int8: worst mean ratio {worst:.3f}, median ratio averaged "
          f"over the steps {median:.4f}")
    if used != {"gn_silu", "attn_block", "attn_block_i8", "int8_conv"}:
        raise AssertionError(f"launched {used}")
    return worst


def phase_cli():
    """The generation CLIs as a user runs them, in subprocesses on the card,
    on the fixture run dirs (config.yaml through the port's YAML reader,
    --save_npz streaming): generate_cifar10 (also --int8 and --dtype bf16),
    generate_large, generate_large --int8. Each npz is held to the in-process samples of the same seed,
    within one uint8 level (another process may get another cuDNN
    algorithm); the labels equal."""
    out_dir = os.path.join(REPO, "build", "chip_smoke_cli")
    os.makedirs(out_dir, exist_ok=True)
    runs = [("generate_cifar10", FIXTURE_DIR, (), 4),
            ("generate_cifar10", FIXTURE_DIR, ("--int8",), 4),
            ("generate_cifar10", FIXTURE_DIR, ("--dtype", "bf16"), 4),
            ("generate_large", ADM_FIXTURE_DIR, (), 8),
            ("generate_large", ADM_FIXTURE_DIR, ("--int8",), 8)]
    for module, run_dir, extra, bs in runs:
        path = os.path.join(out_dir, f"{module}{''.join(extra)}.npz")
        if os.path.exists(path):
            os.remove(path)
        cmd = [sys.executable, "-m", f"dxmi_tpu_torch.{module}", "--log_dir",
               run_dir, "--n_generate", "8", "--batchsize", str(bs),
               "--save_npz", path, *extra]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True,
                              timeout=300,
                              env=dict(os.environ, PYTHONPATH=REPO))
        if proc.returncode != 0:
            raise AssertionError(f"{' '.join(cmd[2:])} failed:\n"
                                 f"{proc.stdout}{proc.stderr}")
        got = np.load(path)
        state = load_sampler_state(os.path.join(
            run_dir, "sampler_best.pth" if module == "generate_cifar10"
            else "sampler.pth"))
        if module == "generate_cifar10":
            x, y = generate(fixture_config(), state, 8, bs, "cuda",
                            int8="--int8" in extra,
                            dtype="bf16" if "bf16" in extra else "fp32"), None
        else:
            x, y = generate_large.generate(adm_fixture_config(), state, 8,
                                           bs, "cuda", int8=bool(extra))
        want = to_uint8(x)
        diff = int(np.abs(got["arr_0"].astype(np.int16) - want).max())
        if got["arr_0"].shape != want.shape or diff > 1:
            raise AssertionError(f"{module} {extra}: npz {got['arr_0'].shape}"
                                 f" {diff} uint8 levels from the in-process "
                                 "samples")
        if y is not None and not np.array_equal(got["arr_1"], y.numpy()):
            raise AssertionError(f"{module} {extra}: labels differ")
        last = proc.stdout.strip().splitlines()[-2:]
        print(f"  C {module} {' '.join(extra)}: {time.perf_counter() - t0:.1f}"
              f" s, npz {got['arr_0'].shape} {got['arr_0'].dtype} within "
              f"{diff} uint8 level of in-process; {' | '.join(last)}")
    train_cli(out_dir)
    cifar_train_cli(out_dir)


# train_cifar10 on a shrunken config (32 channels, mult (1, 2), one res
# block, attention at 16x16 with C=64, value nh 16, batch 8): fused
# attention through K2, K3 where dropout is inactive.
SHRUNK_CIFAR_ARGS = [
    "--sampler_net.ch", "32", "--sampler_net.ch_mult", "[1,2]",
    "--sampler_net.num_res_blocks", "1", "--sampler_net.attn_resolutions",
    "[16]", "--value.net.nh", "16", "--training.batchsize", "8",
    "--training.log_every", "1"]


def cifar_train_cli_commands(run, device="cuda"):
    """train_cifar10 (2 steps, fake data) and generate_cifar10 on the run
    dir it writes, relative to the working directory of both."""
    train = [sys.executable, "-m", "dxmi_tpu_torch.train_cifar10",
             "--config", CIFAR10_CONFIG, "--dataset",
             os.path.join(REPO, "configs", "cifar10", "cifar10.yaml"),
             "--run", run, "--fake_data", "--max_steps", "2", "--device",
             device, *SHRUNK_CIFAR_ARGS]
    log_dir = os.path.join("results", "cifar10", "T10", run)
    gen = [sys.executable, "-m", "dxmi_tpu_torch.generate_cifar10",
           "--log_dir", log_dir, "--sampler", "last", "--n_generate", "8",
           "--batchsize", "8", "--device", device, "--save_npz",
           os.path.join(log_dir, "samples.npz")]
    return train, gen, log_dir


def cifar_train_cli(out_dir):
    """train_cifar10 for 2 steps in a subprocess, then generate_cifar10 on
    its run dir: the training log and samples of the run's shape."""
    train, gen, log_dir = cifar_train_cli_commands("chip_smoke")
    for cmd in (train, gen):
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, cwd=out_dir, capture_output=True,
                              text=True, timeout=300,
                              env=dict(os.environ, PYTHONPATH=REPO))
        if proc.returncode != 0:
            raise AssertionError(f"{' '.join(cmd[2:4])} failed:\n"
                                 f"{proc.stdout[-3000:]}{proc.stderr[-3000:]}")
        lines = proc.stdout.strip().splitlines()
        print(f"  C {cmd[2]}: {time.perf_counter() - t0:.1f} s; "
              f"{' | '.join(l for l in lines if l.startswith(('iter', 'epoch')))}"
              f" {' | '.join(lines[-2:])}")
    got = np.load(os.path.join(out_dir, log_dir, "samples.npz"))
    if got["arr_0"].shape != (8, 32, 32, 3):
        raise AssertionError(f"generate_cifar10 on the trained run dir: npz "
                             f"{got['arr_0'].shape}")


# train_image_large on a shrunken ImageNet64 config (16x16, 32 channels, one
# res block, attention at 8x8 with 2 heads, 4 classes, fp32, value nh 16,
# batch 8): the ADM fixture's shape, so fused_train sends its attention
# blocks through K2 and K6 in fp32.
SHRUNK_TRAIN_ARGS = [
    "--diffusion.image_size", "16", "--diffusion.num_channels", "32",
    "--diffusion.num_res_blocks", "1", "--diffusion.attention_resolutions",
    "8", "--diffusion.channel_mult", "1,2", "--diffusion.num_head_channels",
    "-1", "--diffusion.num_heads", "2", "--diffusion.num_classes", "4",
    "--diffusion.use_fp16", "False", "--sampler.sample_shape", "[3,16,16]",
    "--sampler.num_classes", "4", "--value.net.nh", "16",
    "--training.batchsize", "8", "--training.log_every", "1"]


def train_cli_commands(run, device="cuda"):
    """The training CLI (2 steps) and the generation CLI on the run dir it
    writes, relative to the working directory of both."""
    train = [sys.executable, "-m", "dxmi_tpu_torch.train_image_large",
             "--config", IMAGENET64_CONFIG, "--dataset",
             os.path.join(REPO, "configs", "imagenet64", "imagenet64.yaml"),
             "--run", run, "--fake_data", "--fake_data_size", "32",
             "--max_steps", "2", "--attn_impl", "fused_train", "--device",
             device, *SHRUNK_TRAIN_ARGS]
    log_dir = os.path.join("results", "imagenet64", "T10", run)
    gen = [sys.executable, "-m", "dxmi_tpu_torch.generate_large", "--log_dir",
           log_dir, "--sampler", "last", "--n_generate", "8", "--batchsize",
           "8", "--device", device, "--save_npz",
           os.path.join(log_dir, "samples.npz")]
    return train, gen, log_dir


def train_cli(out_dir):
    """train_image_large for 2 steps in a subprocess, then generate_large
    on its run dir: the training log, no skipped update, finite samples."""
    train, gen, log_dir = train_cli_commands("chip_smoke")
    outs = []
    for cmd in (train, gen):
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, cwd=out_dir, capture_output=True,
                              text=True, timeout=300,
                              env=dict(os.environ, PYTHONPATH=REPO))
        if proc.returncode != 0:
            raise AssertionError(f"{' '.join(cmd[2:4])} failed:\n"
                                 f"{proc.stdout[-3000:]}{proc.stderr[-3000:]}")
        lines = proc.stdout.strip().splitlines()
        outs.append(proc.stdout)
        print(f"  C {cmd[2]}: {time.perf_counter() - t0:.1f} s; "
              f"{' | '.join(l for l in lines if l.startswith('iter'))} "
              f"{' | '.join(lines[-2:])}")
    if "nan-guard skips: 0" not in outs[0]:
        raise AssertionError("train_image_large skipped an update")
    got = np.load(os.path.join(out_dir, log_dir, "samples.npz"))
    if got["arr_0"].shape != (8, 16, 16, 3) or got["arr_1"].shape != (8,):
        raise AssertionError(f"generate_large on the trained run dir: npz "
                             f"{got['arr_0'].shape}")


def phase_generate_adm(k1_log):
    """ImageNet64 T=10 at full width (bf16, ~296M parameters drawn on the
    card from a seed), fused and flash attention: a warm-up batch, then
    2 batches through generate() (setup included) with the launches counted,
    then 2 batches of sampling alone, then a profiled trajectory. Returns
    the launches of each path, the fused path's samples and each path's
    img/s of sampling alone."""
    cfg = imagenet64_t10()
    launches, samples, rates = {}, {}, {}
    for impl in ("fused", "flash"):
        generate_large.generate(cfg, None, BATCH, BATCH, "cuda", seed=1,
                                attn_impl=impl)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        _lib.reset_launches()
        t0 = time.perf_counter()
        with k1_shapes(k1_log, f"E2 {impl}", N_BATCHES,
                       "trajectory of 100"):
            x, y = generate_large.generate(cfg, None, BATCH * N_BATCHES,
                                           BATCH, "cuda", seed=0,
                                           attn_impl=impl)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = dict(_lib.LAUNCHES)
        peak = torch.cuda.max_memory_allocated()
        check_adm_samples(x, y, impl)
        want = {k: v * T * N_BATCHES
                for k, v in ADM_LAUNCHES_PER_FORWARD[impl].items()}
        if got != want:
            raise AssertionError(f"{impl}: launches {got}, expected {want}")
        sampler = generate_large.load_sampler(cfg, None, "cuda", seed=0,
                                              attn_impl=impl)
        steady = time_sampling(sampler)
        rates[impl] = BATCH * N_BATCHES / steady
        n_params = sum(p.numel() for p in sampler.net.parameters())
        print(f"  E2 {impl}: launches {got} (expected {want})")
        print(f"  E2 {impl}: generate(): {x.shape[0]} samples in {wall:.3f} s"
              f" with setup ({x.shape[0] / wall:.2f} img/s); sampling alone "
              f"{BATCH * N_BATCHES / steady:.2f} img/s; {n_params} "
              f"parameters; samples in [{x.min().item():.3f}, "
              f"{x.max().item():.3f}], std {x.std().item():.3f}; peak "
              f"allocated {peak / 2**20:.1f} MiB")
        profile_run(lambda: generate_large.sample_batches(sampler, BATCH,
                                                          BATCH, seed=4),
                    f"E2 {impl} profile, one trajectory of {BATCH}", top=16)
        del sampler
        torch.cuda.empty_cache()
        launches[impl], samples[impl] = got, x
    d = (samples["fused"] - samples["flash"]).abs().mean().item()
    print(f"  E2 mean |fused - flash| over the same seeds: {d:.4f} (tol "
          f"{E2_FUSED_FLASH_MEAN:g}; sample std "
          f"{samples['fused'].std().item():.3f})")
    if not d < E2_FUSED_FLASH_MEAN:
        raise AssertionError(f"E2: fused and flash samples {d:.4f} apart")
    return launches, samples["fused"], rates


def check_adm_samples(x, y, what):
    if tuple(x.shape) != (BATCH * N_BATCHES, 3, 64, 64):
        raise AssertionError(f"{what}: samples of shape {tuple(x.shape)}")
    if not torch.isfinite(x).all():
        raise AssertionError(f"{what}: non-finite samples")
    if y is None or int(y.min()) < 0 or int(y.max()) >= 1000:
        raise AssertionError(f"{what}: labels out of range")


def time_sampling(sampler):
    """Seconds of N_BATCHES batches of sampling alone, after a warm-up
    batch."""
    generate_large.sample_batches(sampler, BATCH, BATCH, seed=2)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    generate_large.sample_batches(sampler, BATCH * N_BATCHES, BATCH, seed=3)
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def phase_generate_adm_int8(fused, rates):
    """E2 under --int8 (W8A8 static, fused attention): a warm-up through
    generate(); then load_sampler, which draws the seed-0 weights and
    calibrates on 2 x 10 full-precision steps at 8 samples as the CLI does
    (setup), and 2 batches of 100 with the launches counted; then sampling
    alone, a profiled trajectory with K8's share of its device time, and
    K8's time per shape over one more trajectory. ``fused`` and ``rates``:
    E2's fused samples of the same seeds and its img/s (None when E2 did
    not run)."""
    cfg = imagenet64_t10()
    generate_large.generate(cfg, None, BATCH, BATCH, "cuda", seed=1,
                            int8=True)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _lib.reset_launches()
    t0 = time.perf_counter()
    sampler = generate_large.load_sampler(cfg, None, "cuda", seed=0,
                                          int8=True)
    torch.cuda.synchronize()
    setup = time.perf_counter() - t0
    calib = dict(_lib.LAUNCHES)
    _lib.reset_launches()
    x, y = generate_large.sample_batches(sampler, BATCH * N_BATCHES, BATCH,
                                         seed=0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = dict(_lib.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    check_adm_samples(x, y, "int8")
    want = {k: v * T * N_BATCHES
            for k, v in ADM_LAUNCHES_PER_FORWARD["int8"].items()}
    if got != want:
        raise AssertionError(f"int8: launches {got}, expected {want}")
    if calib != ADM_CALIB_LAUNCHES:
        raise AssertionError(f"int8 calibration: launches {calib}, expected "
                             f"{ADM_CALIB_LAUNCHES}")
    steady = time_sampling(sampler)
    print(f"  E2-int8: calibration launches {calib} (expected "
          f"{ADM_CALIB_LAUNCHES}); sampling launches {got} (expected {want})")
    near = ("" if fused is None else "; mean |int8 - fused bf16| over the "
            f"same seeds {(x - fused).abs().mean().item():.4f}")
    beside = ("" if rates is None else f" (E2 in this run: fused "
              f"{rates['fused']:.2f}, flash {rates['flash']:.2f} img/s)")
    print(f"  E2-int8: load + calibration {setup:.3f} s; {x.shape[0]} samples"
          f" in {wall:.3f} s with setup ({x.shape[0] / wall:.2f} img/s); "
          f"sampling alone {BATCH * N_BATCHES / steady:.2f} img/s{beside}; "
          f"samples in [{x.min().item():.3f}, {x.max().item():.3f}], std "
          f"{x.std().item():.3f}; peak allocated {peak / 2**20:.1f} MiB"
          f"{near}")
    profile_run(lambda: generate_large.sample_batches(sampler, BATCH, BATCH,
                                                      seed=4),
                f"E2-int8 profile, one trajectory of {BATCH}", top=16,
                shares={"K8": ("int8_conv_kernel",)})
    k8_shape_times(lambda: generate_large.sample_batches(
        sampler, BATCH, BATCH, seed=5), f"E2-int8, batch {BATCH},")
    del sampler
    torch.cuda.empty_cache()
    return got


def k8_shape_times(run, label, library=False):
    """K8's device time per shape over ``run()`` (one trajectory): CUDA
    events around each launch of either form (the shape read from the C
    call's arguments), summed per (stride, map, Cin -> Cout, kernel size),
    with the launches and the bound of each shape (int8 operations at
    INT8_OPS or bytes at HBM_BYTES_S, the larger, ``k8_work``); with
    ``library``, also torch._int_mm's time on an int8 im2col matrix of
    the shape (time_ms)."""
    lib = _lib.lib()
    calls = []

    def timed(name, stride):
        launch = getattr(lib, name)

        def fn(*args):
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
            start.record()
            code = launch(*args)
            end.record()
            # x_bf16, y_bf16, B, H, W, Cin, Cout, kh, kw, pt, pl (, pb, pr)
            pads = (args[16], args[18], args[17], args[19]) if stride == 2 \
                else (args[16], args[14] - 1 - args[16], args[17],
                      args[15] - 1 - args[17])
            calls.append(((stride, args[1], args[8], *args[9:16], *pads),
                          start, end))
            return code
        return launch, fn

    hooks = {"dxmi_int8_conv": timed("dxmi_int8_conv", 1),
             "dxmi_int8_conv_s2": timed("dxmi_int8_conv_s2", 2)}
    for name, (_, fn) in hooks.items():
        setattr(lib, name, fn)
    try:
        run()
        torch.cuda.synchronize()
    finally:
        for name, (launch, _) in hooks.items():
            setattr(lib, name, launch)
    shapes = {}
    for key, start, end in calls:
        n, ms = shapes.get(key, (0, 0.0))
        shapes[key] = (n + 1, ms + start.elapsed_time(end))
    total = sum(ms for _, ms in shapes.values())
    print(f"  {label} K8 by shape, one trajectory (CUDA events around each "
          f"launch): {len(calls)} launches, {total:.3f} ms")
    for key, (n, ms) in sorted(shapes.items(), key=lambda kv: -kv[1][1]):
        stride, xb, yb, B, H, W, Cin, Cout, kh, kw, pt, pb, pl, pr = key
        Ho, Wo = out_size(H, W, kh, kw, ((pt, pb), (pl, pr)), stride)
        nbytes, ops = k8_work(B, Ho, Wo, Cin, Cout, kh, kw, H, W,
                              2 if xb else 4, 2 if yb else 4)
        t_ops = ops["int8"] / INT8_OPS * 1e3
        t_bytes = nbytes / HBM_BYTES_S * 1e3
        lib_txt = ""
        if library:
            cols = torch.randint(-127, 128, (B * Ho * Wo, kh * kw * Cin),
                                 dtype=torch.int8, device="cuda")
            w = torch.randint(-127, 128, (Cout, kh * kw * Cin),
                              dtype=torch.int8, device="cuda").t()
            lib_ms = time_ms(lambda: torch._int_mm(cols, w))
            lib_txt = f", library {lib_ms:.4f} ms ({ms / n / lib_ms:.1f}x it)"
            del cols, w
        print(f"    ({B}, {H}x{W}, {Cin}->{Cout}) {kh}x{kw} stride {stride}"
              f"{' bf16' if xb else ' fp32'}: {n} launches, {ms:.3f} ms "
              f"({ms / total:.1%}), {ms / n:.4f} ms each, bound "
              f"{max(t_ops, t_bytes):.4f} ms "
              f"({'operations' if t_ops >= t_bytes else 'bytes'}), "
              f"{ms / n / max(t_ops, t_bytes):.1f}x it{lib_txt}")


# ---- K1 by shape on the main paths ---------------------------------------

@contextlib.contextmanager
def k1_shapes(log, label, runs, unit):
    """Count K1's launches by shape (read from the C call's arguments) into
    ``log[label]`` = (launches by (B, HW, C, bf16, onepass, silu), runs,
    unit) while the block runs ``runs`` times one ``unit``."""
    lib = _lib.lib()
    launch = lib.dxmi_gn_forward
    seen = collections.Counter()

    def counted(*args):
        # x, scale, bias, y, mean_c, rstd_c, B, HW, C, G, eps, silu,
        # is_bf16, onepass, stream
        seen[(args[6], args[7], args[8], args[12], args[13], args[11])] += 1
        return launch(*args)

    lib.dxmi_gn_forward = counted
    try:
        yield
    finally:
        lib.dxmi_gn_forward = launch
    log[label] = (seen, runs, unit)


def k1_shape_table(gen, log):
    """T-K1: K1's time at each shape E2, E3 and E4 launched it at (recorded
    into ``log`` by k1_shapes in those phases), with its launches per
    trajectory or step, its route, its bound (one read and one write of x
    at HBM_BYTES_S) and the K1 time per trajectory or step that these
    give."""
    if not log:
        print("  T-K1: no shapes recorded (E2, E3, E4 did not run)")
        return
    times = {}
    for label, (seen, runs, unit) in log.items():
        n_all = sum(seen.values()) / runs
        total = 0.0
        lines = []
        for key, n in sorted(seen.items()):
            B, HW, C, bf16, onepass, silu = key
            dt = torch.bfloat16 if bf16 else torch.float32
            mode = GN_MODES[0] if onepass else "fp32"
            if key not in times:
                a = (randn(gen, B, HW, C, scale=2.0, shift=0.5).to(dt),
                     randn(gen, C, scale=0.1, shift=1.0),
                     randn(gen, C, scale=0.1), 32, 1e-5, bool(silu), mode)
                times[key] = time_ms(lambda: group_norm(*a))
                del a
            ms = times[key]
            bound = 2 * B * HW * C * (2 if bf16 else 4) / HBM_BYTES_S * 1e3
            r = route(HW, C, 32, dt)
            total += n / runs * ms
            lines.append(
                f"    ({B}, {HW}, {C}) {'bf16' if bf16 else 'fp32'} {mode}"
                f"{' +SiLU' if silu else ''}: {n / runs:g} launches, "
                f"{'on-chip' if r.on_chip else 'split'} ({r.slabs} slabs, "
                f"clusters of {r.cluster}), {ms:.4f} ms each, bound "
                f"{bound:.4f} ms (bytes), {ms / bound:.2f}x it, "
                f"{n / runs * ms:.3f} ms a {unit}")
        print(f"  T-K1 {label}: {n_all:g} launches a {unit}, K1 "
              f"{total:.3f} ms a {unit} at these times")
        for line in lines:
            print(line)


# ---- K3 by shape on the main paths ---------------------------------------

@contextlib.contextmanager
def k3_shapes(log, label, runs, unit):
    """Count K3's launches by (B, H, W, Cin, Cout) (read from the wrapper's
    arguments) into ``log[label]`` = (launches by shape, runs, unit) while
    the block runs ``runs`` times one ``unit``."""
    fwd = conv_fused._gn_silu_conv_forward
    seen = collections.Counter()

    def counted(x, gn_scale, gn_bias, kernel, *rest):
        if x.is_cuda:
            seen[(*x.shape, kernel.shape[-1])] += 1
        return fwd(x, gn_scale, gn_bias, kernel, *rest)

    conv_fused._gn_silu_conv_forward = counted
    try:
        yield
    finally:
        conv_fused._gn_silu_conv_forward = fwd
    log[label] = (seen, runs, unit)


# T-K3's shapes when E and E4 did not run in the same call: every conv shape
# of the CIFAR-10 net at E's batch 100 and E4's 32 (sampling) and 128
# (training)
K3_TIME_SHAPES = [(B, R, R, Cin, Cout) for B in (BATCH, E4_CHUNK, E4_BATCH)
                  for _, R, Cin, Cout in CONV_SHAPES]


def k3_shape_table(gen, log):
    """T-K3: K3's time at each shape E and E4 launched it at (recorded into
    ``log`` by k3_shapes), with its launches per trajectory or step, its
    bound (bytes or operations, conv_work), its library and plain times and
    the K3 time per trajectory or step that these give; without E and E4,
    the same at K3_TIME_SHAPES with no launches."""
    peaks = {"fp32": FP32_FLOPS, "bf16": BF16_FLOPS}
    if not log:
        log = {"(E and E4 not run)": (
            collections.Counter({s: 0 for s in K3_TIME_SHAPES}), 1, "call")}
    times = {}
    for label, (seen, runs, unit) in log.items():
        total, lines = 0.0, []
        for key, n in sorted(seen.items()):
            B, H, W, Cin, Cout = key
            if key not in times:
                a = conv_case(gen, B, H, Cin, Cout, W)
                times[key] = (time_ms(lambda: gn_silu_conv(*a)),
                              time_ms(conv_library(a)),
                              time_ms(lambda: gn_silu_conv_reference(*a)))
                del a
            ms, lib_ms, plain_ms = times[key]
            nbytes, ops = conv_work(B, H, W, Cin, Cout)
            t_bytes = nbytes / HBM_BYTES_S * 1e3
            t_ops = sum(v / peaks[k] for k, v in ops.items()) * 1e3
            bound = max(t_bytes, t_ops)
            total += n / runs * ms
            lines.append(
                f"    ({B}, {H}, {W}, {Cin}->{Cout}): {n / runs:g} launches, "
                f"{ms:.4f} ms each, library {lib_ms:.4f}, plain "
                f"{plain_ms:.4f}, bound {bound:.4f} ms "
                f"({'bytes' if t_bytes >= t_ops else 'operations'}), "
                f"{ms / bound:.2f}x it, {n / runs * ms:.3f} ms a {unit}")
        print(f"  T-K3 {label}: {sum(seen.values()) / runs:g} launches a "
              f"{unit}, K3 {total:.3f} ms a {unit} at these times")
        for line in lines:
            print(line)


def nvidia_smi():
    proc = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60)
    if proc.returncode != 0 or not proc.stdout.strip():
        raise RuntimeError(f"nvidia-smi failed: {proc.stderr}")
    return proc.stdout.strip().splitlines()[0].strip()


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "false)", file=sys.stderr)
        return 2
    only = None
    if len(sys.argv) == 3 and sys.argv[1] == "--phases":
        only = sys.argv[2].split(",")
        if not set(only) <= set(PHASES):
            print(f"chip_smoke: phases {only}, known {PHASES}",
                  file=sys.stderr)
            return 2
    elif sys.argv[1:]:
        print("usage: chip_smoke.py [--phases B,T,...]", file=sys.stderr)
        return 2
    faulthandler.dump_traceback_later(WATCHDOG_S, exit=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}",
          flush=True)
    select_device("cuda")  # fp32 products in the plain versions (no TF32)
    gen = torch.Generator(device="cuda").manual_seed(0)
    res = {}
    k1_log = {}  # K1's launches by shape in E-int8, E2, E3, E4, for T-K1
    rates = {}  # img/s of E and E-int8's paths
    k3_log = {}  # K3's launches by shape in E and E4, for T-K3

    def step(name, fn):
        if only is None or name in only:
            res[name] = run_phase(name, fn)

    try:
        step("B", phase_build)
        step("K", lambda: phase_kernels(gen))
        step("T", lambda: phase_times(gen))
        step("T-bwd", lambda: bwd_breakdown(gen))
        step("G", phase_replay)
        step("G-int8", phase_replay_int8)
        step("G-bf16", phase_replay_bf16)
        step("E", lambda: phase_generate(k3_log, rates))
        step("E-int8", lambda: phase_generate_int8(k1_log, rates))
        step("E-bf16", lambda: phase_generate_bf16(rates))
        step("G2", phase_replay_adm)
        step("G2-int8", phase_replay_adm_int8)
        step("E2", lambda: phase_generate_adm(k1_log))
        e2 = res.get("E2", (None, None, None))
        step("E2-int8", lambda: phase_generate_adm_int8(e2[1], e2[2]))
        step("G3", phase_train_replay)
        step("E3", lambda: phase_train(k1_log))
        step("G4", phase_cifar_train_replay)
        step("E4", lambda: phase_cifar_train(k1_log, k3_log))
        step("E4-levers", phase_cifar_train_levers)
        step("T-K1", lambda: k1_shape_table(gen, k1_log))
        step("T-K3", lambda: k3_shape_table(gen, k3_log))
        step("C", phase_cli)
        smi = nvidia_smi()
    except PhaseError as e:
        print(str(e), file=sys.stderr, flush=True)
        return 1
    if only is not None:  # a partial run: no record of the kernels
        print(smi)
        return 0
    errs, times, train, cifar = res["K"], res["T"], res["E3"], res["E4"]
    launches, int8 = res["E"], res["E2-int8"]
    adm = res["E2"][0]
    launches.update(gn_silu_bf16=adm["fused"]["gn_silu_bf16"],
                    attn_block_bf16=adm["fused"]["attn_block_bf16"],
                    flash_attn=adm["flash"]["flash_attn"],
                    attn_block_i8=int8["attn_block_i8"],
                    int8_conv=int8["int8_conv"],
                    **{k: train["flash"][k] for k in
                       ("flash_attn_bwd_dkv", "flash_attn_bwd_dq")},
                    attn_block_bwd_bf16=train["fused_train"][
                        "attn_block_bwd_bf16"],
                    attn_block_bb=cifar[4]["attn_block_bb"],
                    int8_conv_s2=res["E-int8"]["a_fp32"]["int8_conv_s2"],
                    **{k: res["E-bf16"][k] for k in ("gn_silu_conv3x3_bf16",
                                                    "attn_block_bf16_d256")},
                    attn_block_bb_bf16=res["E4-levers"][4][
                        "attn_block_bb_bf16"])
    kernels = []
    for name, (src, replaces) in INFO.items():
        r = times[name]
        kernels.append({"name": name, "route": "cuda", "source": src,
                        "replaces": replaces, "launches": launches[name],
                        "max_abs_err": errs[name], "ms": r["ms"],
                        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                        "bound_by": r["bound_by"],
                        "library_ms": r["library_ms"]})
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    faulthandler.cancel_dump_traceback_later()
    return 0


if __name__ == "__main__":
    sys.exit(main())
