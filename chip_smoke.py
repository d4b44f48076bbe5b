#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (dxmi_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the repository root on a machine with a CUDA card and nvcc. It
needs torch and numpy only (no JAX, YAML or msgpack). Phases, each printed
with its seconds; any failure exits non-zero naming the phase:

  B  build every kernel from dxmi_tpu_torch/csrc (one bounded nvcc process
     per source, all started together) and print -Xptxas -v (registers,
     shared memory, spills);
  K  hold each kernel against its plain PyTorch version at the full-width
     CIFAR-10 and ImageNet64 shapes;
  T  time each kernel, its plain version and one PyTorch library call with
     CUDA events;
  G  replay the trained reference fixture (tests/fixtures/torch_rundir_t10)
     with its injected noise through the kernels, unfused and fused;
  E  generate 2 batches of 100 CIFAR-10 samples at T=10 at the full width of
     configs/cifar10/T10.yaml with seeded random weights, and check that the
     main path launched each kernel the expected number of times;
  G2 replay the trained ADM fixture (tests/fixtures/torch_rundir_adm_t10)
     with its injected noise and labels, einsum and fused attention;
  E2 generate 2 batches of 100 ImageNet64 samples at T=10 at the full width
     of configs/imagenet64/T10.yaml (bf16) with seeded random weights, with
     fused and with flash attention, checking the launches of each path.

The line before the last line is the card's name and power limit from
nvidia-smi, the one before it the kernels' JSON record, and the last line is
{"ok": true, "device": {...}}.
"""
from __future__ import annotations

import faulthandler
import json
import os
import subprocess
import sys
import time
import traceback

import numpy as np
import torch
import torch.nn.functional as F

from dxmi_tpu_torch import generate_large
from dxmi_tpu_torch.generate_cifar10 import (generate, load_sampler,
                                             sample_batches)
from dxmi_tpu_torch.ops import _lib
from dxmi_tpu_torch.ops.attention import flash_mha, flash_mha_reference
from dxmi_tpu_torch.ops.attn_block import attn_block, attn_block_reference
from dxmi_tpu_torch.ops.conv_fused import gn_silu_conv, gn_silu_conv_reference
from dxmi_tpu_torch.ops.groupnorm import group_norm, group_norm_silu_reference
from dxmi_tpu_torch.runtime import select_device
from dxmi_tpu_torch.utils.checkpoint import load_sampler_state

REPO = os.path.dirname(os.path.abspath(__file__))
FIXTURE_DIR = os.path.join(REPO, "tests", "fixtures", "torch_rundir_t10")
ADM_FIXTURE_DIR = os.path.join(REPO, "tests", "fixtures",
                               "torch_rundir_adm_t10")
WATCHDOG_S = 1100

# tests/fixtures/torch_rundir_t10/config.yaml as PyYAML reads it (the card
# needs no YAML; tests/test_torch_imports.py holds the two equal).
FIXTURE_CONFIG = {
    "sampler_net": {"_target_": "models.DxMI.unet_small.Model",
                    "resolution": 16, "in_channels": 3, "out_ch": 3,
                    "ch": 32, "ch_mult": [1, 2], "num_res_blocks": 1,
                    "attn_resolutions": [8], "dropout": 0.1},
    "sampler": {"_target_": "models.DxMI.var_sampler.VARSampler",
                "n_timesteps": 10, "sample_shape": [3, 16, 16],
                "trainable_beta": "fix_last"},
    "energy": None,
    "value": {"_target_": "models.value.TimeIndependentValue",
              "net": {"_target_": "models.modules.IGEBMEncoderV2",
                      "in_chan": 3, "out_chan": 1, "use_spectral_norm": False,
                      "keepdim": False, "out_activation": "linear",
                      "avg_pool_dim": 1, "learn_out_scale": True, "nh": 32}},
    "trainer": {"_target_": "models.DxMI.trainer.DxMI_Trainer", "tau1": 0.1,
                "tau2": 0.01, "gamma": 1, "use_sampler_beta": True,
                "time_cost": 0, "adavelreg": 0.99, "entropy_in_value": None,
                "velocity_in_value": None, "time_cost_sig": True},
    "training": {"batchsize": 32, "lr": "1e-4", "v_lr": "1e-4",
                 "beta_lr": "1e-3", "seed": 7},
    "data": {"name": "cifar10"},
}

# The generation half of configs/cifar10/T10.yaml (full width).
CIFAR10_T10 = {
    "sampler_net": {"_target_": "dxmi_tpu.models.unet_small.UNetSmall",
                    "resolution": 32, "in_channels": 3, "out_ch": 3,
                    "ch": 128, "ch_mult": [1, 2, 2, 2], "num_res_blocks": 2,
                    "attn_resolutions": [16], "dropout": 0.1},
    "sampler": {"_target_": "dxmi_tpu.samplers.var.VARSampler",
                "n_timesteps": 10, "sample_shape": [3, 32, 32],
                "trainable_beta": "fix_last"},
}
BATCH, N_BATCHES, T = 100, 2, 10

# tests/fixtures/torch_rundir_adm_t10/config.yaml as PyYAML reads it
# (tests/test_torch_imports.py holds the two equal).
ADM_FIXTURE_CONFIG = {
    "diffusion": {"sigma_min": 0.002, "sigma_max": 80.0, "image_size": 16,
                  "num_channels": 32, "num_res_blocks": 1, "num_heads": 2,
                  "num_heads_upsample": -1, "num_head_channels": -1,
                  "attention_resolutions": "8", "channel_mult": "1,2",
                  "dropout": 0.0, "class_cond": True, "num_classes": 4,
                  "use_checkpoint": False, "use_scale_shift_norm": True,
                  "resblock_updown": True, "use_fp16": False,
                  "use_new_attention_order": False, "learn_sigma": False,
                  "weight_schedule": "uniform", "distillation": False},
    "sampler": {"sample_shape": [3, 16, 16], "n_timesteps": 10,
                "class_cond": True, "num_classes": 4,
                "trainable_beta": "fix_last", "sigma_min": 0.002,
                "sigma_max": 80.0},
    "trainer": {"_target_": "models.DxMI.trainer.DxMI_Trainer_Cond",
                "tau1": 0.1, "tau2": 0.01, "gamma": 1, "n_timesteps": 10,
                "use_sampler_beta": True, "adavelreg": 0.99,
                "entropy_in_value": None, "velocity_in_value": None,
                "value_grad_clip": True, "time_cost": 0,
                "skip_sampler_tau": 3, "time_cost_sig": 1},
    "value": {"_target_": "models.value.TimeIndependentValue",
              "net": {"_target_": "models.modules.IGEBMEncoderV2",
                      "in_chan": 3, "out_chan": 1, "use_spectral_norm": False,
                      "keepdim": False, "out_activation": "linear",
                      "avg_pool_dim": 1, "learn_out_scale": True, "nh": 32}},
    "training": {"seed": 11, "batchsize": 16},
    "data": {"name": "adm_fixture_synthetic", "image_size": 16,
             "class_cond": True, "n_class": 4},
}

# The generation half of configs/imagenet64/T10.yaml (full width, bf16).
IMAGENET64_T10 = {
    "diffusion": {"sigma_min": 0.002, "sigma_max": 80.0, "image_size": 64,
                  "num_channels": 192, "num_res_blocks": 3, "num_heads": 4,
                  "num_heads_upsample": -1, "num_head_channels": 64,
                  "attention_resolutions": "32,16,8", "channel_mult": "",
                  "dropout": 0.0, "class_cond": True, "use_checkpoint": False,
                  "use_scale_shift_norm": True, "resblock_updown": True,
                  "use_fp16": True, "use_new_attention_order": False,
                  "learn_sigma": False, "weight_schedule": "uniform",
                  "distillation": False},
    "sampler": {"sample_shape": [3, 64, 64], "n_timesteps": 10,
                "class_cond": True, "num_classes": 1000,
                "trainable_beta": "fix_last", "sigma_min": 0.002,
                "sigma_max": 80.0},
}

# Kernel launches per UNetADM forward at that config (36 ResBlocks, 22
# attention blocks: 7 at 32x32, 7 at 16x16, 8 at 8x8; tests/
# test_torch_unet_adm.py counts them on the CPU): with attn_impl='fused' K1
# runs the 72 ResBlock norms and out.0, K2 every attention block; with
# 'flash' K1 also runs the 22 attention norms and K4 the 32x32 maps (the
# 16x16 and 8x8 maps take the einsum path).
ADM_LAUNCHES_PER_FORWARD = {
    "fused": {"gn_silu_bf16": 73, "attn_block_bf16": 22},
    "flash": {"gn_silu_bf16": 95, "flash_attn": 7},
}

# Kernel launches per UNetSmall forward at that config (fuse_gn_conv=True,
# attn_impl='fused'): K1 = norm_out + the 4x4 mid block's norm, K3 = conv1
# and conv2 of 22 ResnetBlocks, K2 = the 5 attention blocks at 16x16.
LAUNCHES_PER_FORWARD = {"gn_silu": 2, "gn_silu_conv3x3": 44, "attn_block": 5}

# H100 SXM peaks (NVIDIA data sheet, dense): memory rate, fp32 outside the
# tensor cores, bf16 tensor cores.
HBM_BYTES_S = 3.35e12
FP32_FLOPS = 67e12
BF16_FLOPS = 989e12

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
       "attn_block": (2e-5, 2e-5), "gn_silu_bf16": (2e-2, 2e-2)}
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
}


class PhaseError(Exception):
    pass


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


def conv_case(gen, B, R, Cin, Cout):
    return (randn(gen, B, R, R, Cin, scale=2.0, shift=0.5),
            randn(gen, Cin, scale=0.1, shift=1.0), randn(gen, Cin, scale=0.1),
            randn(gen, 3, 3, Cin, Cout, scale=(9 * Cin) ** -0.5),
            randn(gen, Cout, scale=0.1), 32, 1e-6)


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
ATTN_SHAPES = [(BATCH, 256, 256)]
# ImageNet64 (bf16): K1 at the widest decoder input (8x8, C=1536, 48 channels
# per group) and the 64x64 maps (C=192), both statistics modes; K2 at the
# three attention maps; K4 at the 32x32 maps.
ADM_GN_SHAPES = [(BATCH, 4096, 192, True), (BATCH, 64, 1536, True)]
GN_MODES = ("bf16_onepass", "fp32")
ADM_ATTN_SHAPES = [(BATCH, 1024, 384, 6), (BATCH, 256, 576, 9),
                   (BATCH, 64, 768, 12)]
FLASH_SHAPES = [(BATCH, 1024, 6, 64)]


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
    errs["gn_silu_conv3x3"] = max(
        max_err(gn_silu_conv(*a), gn_silu_conv_reference(*a),
                "gn_silu_conv3x3")
        for a in (conv_case(gen, *s) for s in CONV_SHAPES))
    errs["attn_block"] = max(
        max_err(attn_block(*a, num_heads=1, eps=1e-6),
                attn_block_reference(*a, num_heads=1, eps=1e-6), "attn_block")
        for a in (attn_case(gen, *s) for s in ATTN_SHAPES))
    errs["gn_silu_bf16"] = max(
        max_err(group_norm(*a).float(), group_norm_silu_reference(*a).float(),
                "gn_silu_bf16")
        for a in (gn_bf16_case(gen, *sh, mode) for sh in ADM_GN_SHAPES
                  for mode in GN_MODES))
    for k in ("gn_silu", "gn_silu_conv3x3", "attn_block", "gn_silu_bf16"):
        print(f"  K {k}: max abs err vs plain {errs[k]:.3e} "
              f"(tol {TOL[k][0]:g} + {TOL[k][1]:g}*|plain|)")
    worst = 0.0
    for B, S, C, nh in ADM_ATTN_SHAPES:
        a = attn_bf16_case(gen, B, S, C)
        out = attn_block(*a, num_heads=nh)
        ref = attn_block_reference(*a, num_heads=nh)
        rel, err, share = attn_bf16_check(out, ref, a[0],
                                          f"attn_block_bf16 {(B, S, C, nh)}")
        print(f"  K attn_block_bf16 {(B, S, C, nh)}: mean rel err {rel:.3e} "
              f"(tol {ATTN_BF16_MEAN_REL:g}), max abs err {err:.3e}, worst "
              f"element beyond one ulp at {share:.3f} of its limit")
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
    return errs


def time_ms(fn, iters=20, warmup=3):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
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
    x_nchw = a[0].permute(0, 3, 1, 2)
    w_lib = a[3].permute(3, 2, 0, 1).to(torch.bfloat16).contiguous(
        memory_format=torch.channels_last)
    b_lib = a[4].to(torch.bfloat16)
    M = B * R * R
    rows["gn_silu_conv3x3"] = dict(
        ms=time_ms(lambda: gn_silu_conv(*a)),
        plain_ms=time_ms(lambda: gn_silu_conv_reference(*a)),
        library_ms=time_ms(lambda: F.conv2d(
            F.silu(F.group_norm(x_nchw, 32, a[1], a[2], 1e-6)).bfloat16(),
            w_lib, b_lib, padding=1)),
        bytes=(M * Cin + 9 * Cin * Cout + M * Cout + 2 * Cin + Cout) * 4,
        ops={"bf16": 2 * M * Cout * 9 * Cin, "fp32": 11 * M * Cin})

    B, S, C = ATTN_SHAPES[0]
    a = attn_case(gen, B, S, C)
    x, gs, gb, wqkv, bqkv, wp, bp = a

    def library_attn():
        g = F.group_norm(x.transpose(1, 2), 32, gs, gb, 1e-6).transpose(1, 2)
        q, k, v = (g @ wqkv + bqkv).split(C, dim=-1)
        o = F.scaled_dot_product_attention(q, k, v)
        return x + o @ wp + bp

    rows["attn_block"] = dict(
        ms=time_ms(lambda: attn_block(*a, num_heads=1, eps=1e-6)),
        plain_ms=time_ms(lambda: attn_block_reference(*a, num_heads=1,
                                                      eps=1e-6)),
        library_ms=time_ms(library_attn),
        bytes=(2 * B * S * C + 4 * C * C + 5 * C) * 4,
        # qkv, logits, AV and proj products; ~5 flops of softmax per logit
        ops={"fp32": 2 * B * S * C * 3 * C + 4 * B * S * S * C
             + 2 * B * S * C * C + 5 * B * S * S})

    rows.update(adm_time_rows(gen))
    peaks = {"fp32": FP32_FLOPS, "bf16": BF16_FLOPS}
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
    for i, (B, S, nh, d) in enumerate(FLASH_SHAPES):
        q, k, v, sm = flash_case(gen, B, S, nh, d)
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        name = "flash_attn" if i == 0 else f"flash_attn {(B, S, nh, d)}"
        rows[name] = dict(
            ms=time_ms(lambda: flash_mha(q, k, v, sm)),
            plain_ms=time_ms(lambda: flash_mha_reference(q, k, v, sm)),
            library_ms=time_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, scale=sm)),
            bytes=4 * B * S * nh * d * 2,
            ops={"bf16": 4 * B * nh * S * S * d, "fp32": 5 * B * nh * S * S})
    return rows


def phase_replay():
    golden = np.load(os.path.join(FIXTURE_DIR, "golden.npz"))
    state = load_sampler_state(os.path.join(FIXTURE_DIR, "sampler_best.pth"))
    errs = {}
    for fuse in (False, True):
        _lib.reset_launches()
        sampler = load_sampler(FIXTURE_CONFIG, state, "cuda",
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


def phase_generate():
    # warm-up outside the counted run (cuDNN plans, allocator)
    generate(CIFAR10_T10, None, BATCH, BATCH, "cuda", seed=1)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _lib.reset_launches()
    t0 = time.perf_counter()
    x = generate(CIFAR10_T10, None, BATCH * N_BATCHES, BATCH, "cuda", seed=0)
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

    sampler = load_sampler(CIFAR10_T10, None, "cuda", seed=0)
    sample_batches(sampler, BATCH, BATCH, seed=2)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sample_batches(sampler, BATCH * N_BATCHES, BATCH, seed=3)
    torch.cuda.synchronize()
    steady = time.perf_counter() - t0
    print(f"  E launches {launches} (expected {want})")
    print(f"  E generate(): {x.shape[0]} samples in {wall:.3f} s with setup "
          f"({x.shape[0] / wall:.1f} img/s); sampling alone "
          f"{BATCH * N_BATCHES / steady:.1f} img/s; samples in "
          f"[{x.min().item():.3f}, {x.max().item():.3f}], std "
          f"{x.std().item():.3f}; peak allocated {peak / 2**20:.1f} MiB")
    profile_run(lambda: sample_batches(sampler, BATCH, BATCH, seed=4),
                f"E profile, one trajectory of {BATCH}")
    return launches


def profile_run(fn, label, top=12):
    """Device time by kernel over one call of ``fn`` (torch.profiler), and
    the device's idle share of the wall time."""
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
        return
    print(f"  {label}: device busy {total:.2f} ms of {wall_ms:.2f} ms wall "
          f"(idle {1 - total / wall_ms:.1%})")
    for ms, count, key in sorted(rows, reverse=True)[:top]:
        print(f"    {ms:9.3f} ms {ms / total:6.1%} x{count:<5d} {key[:90]}")


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
            ADM_FIXTURE_CONFIG, state, "cuda", attn_impl=impl,
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


def phase_generate_adm():
    """ImageNet64 T=10 at full width (bf16, ~296M parameters drawn on the
    card from a seed), fused and flash attention: a warm-up batch, then
    2 batches through generate() (setup included) with the launches counted,
    then 2 batches of sampling alone, then a profiled trajectory."""
    launches, samples = {}, {}
    for impl in ("fused", "flash"):
        generate_large.generate(IMAGENET64_T10, None, BATCH, BATCH, "cuda",
                                seed=1, attn_impl=impl)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        _lib.reset_launches()
        t0 = time.perf_counter()
        x, y = generate_large.generate(IMAGENET64_T10, None,
                                       BATCH * N_BATCHES, BATCH, "cuda",
                                       seed=0, attn_impl=impl)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = dict(_lib.LAUNCHES)
        peak = torch.cuda.max_memory_allocated()
        if tuple(x.shape) != (BATCH * N_BATCHES, 3, 64, 64):
            raise AssertionError(f"{impl}: samples of shape {tuple(x.shape)}")
        if not torch.isfinite(x).all():
            raise AssertionError(f"{impl}: non-finite samples")
        if y is None or int(y.min()) < 0 or int(y.max()) >= 1000:
            raise AssertionError(f"{impl}: labels out of range")
        want = {k: v * T * N_BATCHES
                for k, v in ADM_LAUNCHES_PER_FORWARD[impl].items()}
        if got != want:
            raise AssertionError(f"{impl}: launches {got}, expected {want}")
        sampler = generate_large.load_sampler(IMAGENET64_T10, None, "cuda",
                                              seed=0, attn_impl=impl)
        generate_large.sample_batches(sampler, BATCH, BATCH, seed=2)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        generate_large.sample_batches(sampler, BATCH * N_BATCHES, BATCH,
                                      seed=3)
        torch.cuda.synchronize()
        steady = time.perf_counter() - t0
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
    return launches


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
    faulthandler.dump_traceback_later(WATCHDOG_S, exit=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}",
          flush=True)
    select_device("cuda")  # fp32 products in the plain versions (no TF32)
    gen = torch.Generator(device="cuda").manual_seed(0)
    try:
        run_phase("B", phase_build)
        errs = run_phase("K", lambda: phase_kernels(gen))
        times = run_phase("T", lambda: phase_times(gen))
        run_phase("G", phase_replay)
        launches = run_phase("E", phase_generate)
        run_phase("G2", phase_replay_adm)
        adm = run_phase("E2", phase_generate_adm)
        smi = nvidia_smi()
    except PhaseError as e:
        print(str(e), file=sys.stderr, flush=True)
        return 1
    launches.update(gn_silu_bf16=adm["fused"]["gn_silu_bf16"],
                    attn_block_bf16=adm["fused"]["attn_block_bf16"],
                    flash_attn=adm["flash"]["flash_attn"])
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
