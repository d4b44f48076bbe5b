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
     kernels' edges (S = 64; head dims 24, 32, 36, 40); K6 fp32 on its
     one-launch route at batch 1, 3, 8, 64 and 128, one, two and four heads
     and C = 32, and on the multi-launch route just past that route's limit
     (C = 96, S = 128, d = 8), each replayed bit-equal and counted on its
     route; K4 at its wgmma
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
     100, 128 and 64 and at two heads of d = 256 at batch 100, K2 fp32 at
     the 8x8 map of conv16 (two heads of d = 32) at E5's batch 64 and
     G3's 8, counted on its route, K1 at every GroupNorm shape of the
     full-width NCSN++ (fp32 and bf16, SiLU off) at batch 100 and 128 and
     K8 at every NCSN++ int8 conv shape at batch 100, LSUN-Bedroom 256's
     shapes (K1 on its split route at every GroupNorm of the 256x256 and
     128x128 maps, both statistics modes, SiLU on and off; K2 bf16 and K5
     at the 32x32 blocks, (100, 1024, 512) with 8 heads, K5 at the 8x8
     ones, (100, 64, 1024) with 16 heads; K4 at (100, 1024, 8, 64) and
     its training forms at E9's batch; K8 at every int8 conv of the
     256x256 and 128x128 maps; the plain versions of K1 and K8 over batch
     chunks), K7 bf16 at
     d = 256 at batch 128 and 64, bb 4, and the wide attention core alone
     at the d = 256 shapes of batch 100, train_anomaly's shapes at batch 32
     (K1, K3 at every GN+conv pair of its policy and value, those at one
     channel a group included, K2 fp32 at (32, 1024, 64) and (32, 256,
     128), and K1 at one channel a group), each against its plain version
     and replayed bit-equal);
  T  time each kernel, its plain version and one PyTorch library call with
     CUDA events, device time (K4 at each shape the main paths launch it
     at; K2 fp32 beside K7 at bb 2 and 4 on the same inputs at batch 100,
     128 and 32; K6's fp32 form at G3's and E5's shapes on its one-launch
     route and at (128, 1024, 384), nh 6, on the multi-launch one); and K2
     bf16 and K5 at each
     of their main-path maps split by launch (torch.profiler: statistics,
     GN apply or quantise, qkv GEMM, core, proj GEMM), K2 bf16 at d = 256
     and K7 bf16 at E4's shape, bb 4, the same way, and K3 at one shape
     of each map size (weight cast, statistics, conv, the sum of split
     slices), each beside its bound; K8 (both forms) at the CIFAR-10
     net's int8 shapes beside torch._int_mm on the im2col matrix; K3 on
     bf16 x, K2 bf16 and K7 bf16 at d = 256 and the wide attention core
     beside their library compositions (cuDNN's bf16 conv; GN + matmul +
     SDPA; SDPA); and at LSUN's shapes K1 on the split route (both
     statistics modes), K2 bf16, K5 (32x32 and 8x8), K4, K4-dkv, K4-dq
     and K8 (256x256, 256 -> 256 and the widest decoder input) beside
     their bounds and library calls; at train_anomaly's shapes K1 (the
     policy's norm_out, and at one channel a group), K3 at one channel a
     group and K2 fp32 at its two maps, beside their library calls; K4
     and K4-dkv/dq at E12's ImageNet64 training shape at batch 16;
  T-bwd the device time of each launch of one K6 fp32 call at G3's and E5's
     shapes (8 and 64, 64, 64, nh 2), and of one K6 bf16 call and one
     K4-dkv call at the 32x32 map at batch 128 (torch.profiler);
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
     seeded random weights, the structured fake pool): 2 steps with flash
     attention (K4 forward, K4-dkv, K4-dq) and 2 with fused_train (K2, K6),
     checking the launches per step, finite metrics and no skipped update,
     the backward kernels' share of a profiled step, and the first
     minibatch's gradient by einsum, flash and fused_train,
     whole and per group of the attention blocks' parameters;
  G5 the port's EDMSampler with runs_conv/pre_edm16.msgpack (the
     pretrained net of configs/imagenet64/conv16.yaml) loaded by its own
     msgpack reader, einsum and fused attention, against the JAX package's
     trajectory from the same file (tests/torch_fixtures/edm16_golden.npz)
     under the fp32 ADM goldens' limits;
  E5 DxMI training at the full width of configs/imagenet64/conv16.yaml
     (fp32, batch 64) from runs_conv/pre_edm16.msgpack: 3 steps with its
     default einsum attention and 3 with fused_train (K2 fp32, K6 fp32 on
     its one-launch route), the file's tensors loaded bit for bit and no
     random-init warning, launches per step, finite metrics, s/step and a
     profiled step's device time, idle share and K6's share (the entry
     itself runs in C's conv16 resume chain);
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
  G6 the small NCSN++ of DDGAN_SMALL (numpy-made weights, conv2 and
     proj_out non-zero) in a T=4 DDGANSampler with injected draws, against
     the JAX package's step means (tests/torch_fixtures/ddgan_golden.npz):
     fp32 per element, bf16 and --int8 (bf16, attention 1x1s in bf16)
     against JAX's own bf16 effect, fp32 static int8 under G-int8's gates,
     and calibrate_quant's scales against JAX's;
  G7 one DxMITrainer iteration of configs/cifar10/T4_ddgan.yaml's trainer
     (value_resample) on that net with the JAX trainer's draws, against
     tests/torch_fixtures/ddgan_train_golden.npz under G4's limits;
  E6 generate_cifar10's DDGAN paths at NCSNppArgs' full width (47.9 M
     parameters, seeded weights), 2 trajectories of 100 at T=4 each: fp32,
     bf16 (the default) and --int8 (calibrated on 2 x 64); launches (K1 63
     and K8 75 a forward), img/s, a profiled trajectory's device time and
     idle share, K8 by shape, and each step of a trajectory against the
     plain versions of K1 and K8 on the card;
  E7 train_cifar10 on T4_ddgan.yaml at full width (fp32, batch 128 in 4
     sampling chunks, value_resample): 3 steps from seeded weights, the
     launches per step, finite metrics, s/step by phase, peak memory and a
     profiled step's idle share;
  G8 the LSUN goldens (tests/torch_fixtures/lsun_golden.npz,
     lsun_int8_golden.npz, lsun_train_golden.npz): a small UNetADM of
     LSUN's structure (LSUN_SMALL, numpy-made weights) in T4.yaml's
     EDMSampler, each step from the golden's fp32 states, fp32 (K1, K2
     fp32) per element, bf16 (generate_large's path) against JAX's own
     bf16 effect, fp32 --int8 (K1, K5, K8) calibrated against JAX's scales
     and its steps under G-int8's mean gate and the nudged median gate; then one iteration of T4_wide.yaml's trainer with a small
     Wide-ResNet value, the metrics against JAX's and the plain versions';
  E8 generate_large on configs/lsun/T4.yaml at full width (526,304,771
     parameters, 256x256, seeded weights), 2 trajectories of 100 at T=4
     on fused (the default), flash and --int8: launches by kernel and by
     shape, img/s, a profiled trajectory's device time and idle share, each
     step against the plain versions (at 10 samples);
  E9 train_image_large on configs/lsun/T4.yaml (IGEBM value) and
     T4_wide.yaml (Wide-ResNet value) at full width with --attn_impl flash
     at batch 16 (32 does not fit the card): 2 steps each, launches,
     finite metrics, s/step by phase, peak memory, the last step profiled;
     then the wiring check of flash against einsum;
  E10 value-guided generation (sample_guidance) at full width: CIFAR-10
     T=10 fp32, 2 x 100 with the seeded IGEBM value, and ImageNet64 T=10
     bf16 fused, 1 x 100 through the Cond trainer (labels drawn); launches
     counted, each guided step held against the kernels' plain versions
     on the same state and noise (fp32 per element within G's fused
     limit, bf16 within twice the bf16 effect at 10 samples);
  G9 one DxMITrainerEV iteration of train_anomaly's nets at a small width
     with a spectral-norm energy (numpy-made weights, K1 and K2 fp32)
     against tests/torch_fixtures/ev_golden.npz: metrics within 1e-3, f's
     u and sigma after the iteration within 1e-4, the updates' norms read;
  E11 train_anomaly at its defaults (image 64, batch 32, T = 10) through
     its main(): 3 iterations from a tensor file (launches of K1, K3 and
     K2 fp32 counted, and by shape for T-K1 and T-K3) and 3 with
     --spectral_norm from a PNG folder of 64x64 and 256x256 images, the
     run directories' files, --score of that run on two PNG directories;
     at one iteration's inputs each forward of the policy and the value
     against the kernels' plain versions; s/iter, peak memory and the
     idle share of a profiled iteration;
  G10 the distillation golden (tests/torch_fixtures/distill_golden.npz,
     the JAX package's, numpy-made weights, JAX's draws replayed): on a
     small class-conditional UNetADM in fp32 (K1) the training,
     consistency (distillation and training) and progdist losses at l2
     and l1, l2-32 on its 64x64 form, each within 1e-4 of JAX's; the seven
     karras_sample solvers and heun with churn within 2e-5 + 2e-5
     relative, or twice the move that two 2^-22 nudges of the initial
     state make in JAX's own samples (recorded in the golden) where that
     is larger; one pretrain_ddpm update (UNetSmall, JAX's dropout masks)
     and one pretrain_ddgan update (the small NCSN++), their losses within
     1e-4, their gradient norms read; flax's initialisers drawn on the
     card against JAX's init_params' statistics;
  E12 the ImageNet64 T10 net (bf16, flash: K1, K4, K4-dkv/dq, seeded
     weights) at batch 16: one Adam step each of training_losses,
     consistency distillation (teacher the drawn net, target its EMA,
     update_ema after the step), consistency training and progdist
     (launches per step checked), then each karras_sample solver for 10
     steps (img/s, launches); each loss, the dsm step's gradient norms
     and each solver's 10 steps at batch 16 (K4-dkv/dq at the step's
     shape) against the kernels' plain versions within twice the bf16
     effect (its entries run in C);
  T-K1 K1 at each shape that E-int8, E2 (fused, flash), E3 (flash,
     fused_train), E5 (einsum, fused_train), E4, E6, E7, E8, E9, E11 and
     E12 (its dsm step, pretrain_edm's) launched it at, held
     against its plain version under K's gate, with its time, its launches
     per trajectory or step (counted in those phases), its route and its
     bound;
  T-K3 K3's time at each shape that E, E4 and E11 launched it at, with its
     launches per trajectory or step (counted in those phases), its bound,
     its library and its plain time (without E and E4 in the run: at every
     conv shape of the CIFAR-10 net at batch 100, 32 and 128, no launches);
  C  run the generation CLIs (generate_cifar10 and generate_large, each
     with and without --int8; generate_cifar10 --dtype bf16) as
     subprocesses on the fixture run dirs with --save_npz, and hold each
     npz to the in-process samples; and
     train_image_large for 2 steps on a shrunken config and generate_large
     on the run dir it wrote, and the same with train_cifar10 and
     generate_cifar10, on T10.yaml and on T4_ddgan.yaml (NCSN++ at a small
     width; the npz within one uint8 level of the in-process samples); the
     resume chains: train_cifar10 on T10.yaml at full width and
     train_image_large on conv16.yaml from its pretrained file
     (--save_state_every 1) for 2 steps, then --resume to 3 in a fresh
     process (train_state.msgpack: its parameter leaves equal to the first
     run's *_last.pth bit for bit, the optimizer counts equal to the steps
     taken, JAX's "resumed full train state" line, finite metrics), then
     generate_cifar10 / generate_large --guidance_scale 0.1 on the run
     dirs; train_2d for 300 iterations after 200 of pretraining (its
     curve's JSON); train_image_large on conv16.yaml from a PNG folder of
     class-prefixed 64x64 images with --data_workers 2 for 2 steps;
     E12's entries at full width for 3 steps each, pretrain_ddpm (batch
     128), pretrain_ddgan (batch 128) and pretrain_edm (T10.yaml, batch 16,
     flax's initialisers): their losses, s/step after the first, peak
     memory and launches per step, and each file loaded into the port's
     training entry bit for bit; the subprocesses five at a time;
  F  FID and the evaluator at full width in a temporary working directory
     whose datasets/ holds the proxy files of dxmi_tpu_torch/fid/proxy.py
     (the seed-0 synthetic Inception weights; statistics over 4096
     fake_cifar images): the FID Inception against the JAX evaluator's
     golden (tests/torch_fixtures/fid_golden.npz: pool3, the sFID tap, the
     IS probabilities, within 1e-3 of the feature scale + 1e-4) and its
     img/s at batch 100 with a profile of one batch; train_cifar10 on
     configs/cifar10/T10.yaml for 2 steps with the FID at epoch 0 on 3200
     samples (sampler_best written with fid, epoch, iter); generate_cifar10
     --sampler best -n 3200 --eval_fid --save_npz (every PNG decodes to the
     npz); the evaluator on that npz against the statistics' images as a
     reference npz (IS, FID, sFID, precision and recall finite, its FID
     within 1e-6 relative of generate_cifar10's); each FID's sampling,
     Inception and Frechet seconds and the Frechet route; peak memory.

`python3 chip_smoke.py --phases B,T-bwd` runs the phases named (here the
build and the backward kernels' breakdown) and prints no kernels record and
no last line.

The line before the last line is the card's name and power limit from
nvidia-smi, the one before it the kernels' JSON record, and the last line is
{"ok": true, "device": {...}}.
"""
from __future__ import annotations

import collections
import concurrent.futures
import contextlib
import faulthandler
import io
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
import traceback
import zlib

import numpy as np
import torch
import torch.nn.functional as F

from dxmi_tpu_torch import (generate_cifar10, generate_large, train_anomaly,
                            train_cifar10, train_image_large)
from dxmi_tpu_torch.config import instantiate, load_yaml, merge
from dxmi_tpu_torch.generate_cifar10 import (generate, load_sampler,
                                             sample_batches, to_uint8)
from dxmi_tpu_torch.models.ncsnpp import NCSNpp, NCSNppArgs
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
from dxmi_tpu_torch import evaluator
from dxmi_tpu_torch.data.cifar10 import EpochLoader, fake_cifar
from dxmi_tpu_torch.fid import proxy
from dxmi_tpu_torch.fid.inception import (build_inception,
                                          load_fid_inception_params)
from dxmi_tpu_torch.data.synthetic import structured_class_images
from dxmi_tpu_torch.models.unet_small import AttnBlock
from dxmi_tpu_torch.ops.attn_block import (BWD_MAX_SLICES,
                                           BWD_ROWS_PER_CHUNK,
                                           BWD_ROWS_PER_SLICE, attn_block,
                                           bwd_small_takes,
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
from dxmi_tpu_torch.samplers.ddgan import DDGANSampler
from dxmi_tpu_torch.trainers.buffer import from_d_sample
from dxmi_tpu_torch.trainers.dxmi import DxMITrainer, train_step
from dxmi_tpu_torch.trainers.dxmi_cond import DxMITrainerCond
from dxmi_tpu_torch.trainers.dxmi_ev import DxMITrainerEV
from dxmi_tpu_torch.utils.checkpoint import (load_sampler_state,
                                             load_value_state)
from dxmi_tpu_torch.utils import msgpack as port_msgpack
from dxmi_tpu_torch.utils.train_state import flax_path, sn_buffers
from dxmi_tpu_torch.utils.png import read_png

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
# configs/imagenet64/conv16.yaml (the Cond family's convergence recipe,
# CONVERGENCE.md §8) and its training.pretrained_path, a flax msgpack file
# of the JAX package read by the port's own reader; the golden of G5
CONV16_CONFIG = os.path.join(REPO, "configs", "imagenet64", "conv16.yaml")
CONV16_CKPT = os.path.join(REPO, "runs_conv", "pre_edm16.msgpack")
EDM16_GOLDEN = os.path.join(REPO, "tests", "torch_fixtures",
                            "edm16_golden.npz")


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
    "attn_block_bwd_small": ("dxmi_tpu_torch/csrc/attn_block_bwd_small.cu",
                             "dxmi_tpu/ops/attn_block.py:406 (fp32, S = 64, "
                             "C <= 64)"),
    # the same kernels at the DDGAN generator's (NCSN++) shapes, E6's paths
    "gn_silu_ncsnpp": ("dxmi_tpu_torch/csrc/groupnorm.cu",
                       "dxmi_tpu/ops/groupnorm.py:157 (NCSN++, SiLU off, "
                       "fp32)"),
    "gn_silu_bf16_ncsnpp": ("dxmi_tpu_torch/csrc/groupnorm.cu",
                            "dxmi_tpu/ops/groupnorm.py:157 (NCSN++, SiLU "
                            "off, bf16)"),
    "int8_conv_ncsnpp": ("dxmi_tpu_torch/csrc/int8_conv.cu",
                         "dxmi_tpu/ops/quant.py:68 (NCSN++ --int8)"),
    # the same kernels at LSUN-Bedroom 256's shapes (configs/lsun/T4.yaml):
    # E8's generation paths and E9's training
    "gn_silu_bf16_lsun": ("dxmi_tpu_torch/csrc/groupnorm.cu",
                          "dxmi_tpu/ops/groupnorm.py:157 (bf16, the split "
                          "route at LSUN's 256x256 maps)"),
    "attn_block_bf16_lsun": ("dxmi_tpu_torch/csrc/attn_block.cu",
                             "dxmi_tpu/ops/attn_block.py:225 (bf16, LSUN's "
                             "32x32 blocks, 8 heads of 64)"),
    "attn_block_i8_lsun": ("dxmi_tpu_torch/csrc/attn_block_i8.cu",
                           "dxmi_tpu/ops/attn_block.py:353 (LSUN's 32x32 "
                           "blocks)"),
    "flash_attn_lsun": ("dxmi_tpu_torch/csrc/flash_attn.cu",
                        "dxmi_tpu/ops/attention.py:53 (LSUN's 32x32 map)"),
    "flash_attn_bwd_dkv_lsun": (
        "dxmi_tpu_torch/csrc/flash_attn_bwd.cu",
        "jax/experimental/pallas/ops/tpu/flash_attention.py:796 (jax.grad "
        "of dxmi_tpu/ops/attention.py:53 at LSUN's 32x32 map)"),
    "flash_attn_bwd_dq_lsun": (
        "dxmi_tpu_torch/csrc/flash_attn_bwd.cu",
        "jax/experimental/pallas/ops/tpu/flash_attention.py:1146 (jax.grad "
        "of dxmi_tpu/ops/attention.py:53 at LSUN's 32x32 map)"),
    "int8_conv_lsun": ("dxmi_tpu_torch/csrc/int8_conv.cu",
                       "dxmi_tpu/ops/quant.py:68 (LSUN --int8, 256x256 "
                       "maps)"),
    # the same kernels at train_anomaly's shapes (E11, image 64, batch 32)
    "gn_silu_anomaly": ("dxmi_tpu_torch/csrc/groupnorm.cu",
                        "dxmi_tpu/ops/groupnorm.py:157 (fp32, the policy's "
                        "norm_out at 64x64)"),
    "gn_silu_conv3x3_anomaly": ("dxmi_tpu_torch/csrc/conv_fused.cu",
                                "dxmi_tpu/ops/conv_fused.py:36 (fp32, one "
                                "channel a group: the value's 64x64 level)"),
    "attn_block_anomaly": ("dxmi_tpu_torch/csrc/attn_block_bb.cu",
                           "dxmi_tpu/ops/attn_block.py:225 (fp32, the "
                           "value's mid block, S = 1024, C = 64)"),
    "attn_block_anomaly_16": ("dxmi_tpu_torch/csrc/attn_block_bb.cu",
                              "dxmi_tpu/ops/attn_block.py:225 (fp32, the "
                              "policy's 16x16 blocks, C = 128)"),
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
    ``cond_train_replay``."""
    cfg = adm_fixture_config()
    state = load_sampler_state(os.path.join(ADM_FIXTURE_DIR, "sampler.pth"))
    sampler = generate_large.load_sampler(cfg, state, device,
                                          attn_impl=attn_impl,
                                          up_impl="resize", gn_stats="fp32")
    value = instantiate(cfg["value"]).to(device)
    value.load_state_dict(load_value_state(os.path.join(ADM_FIXTURE_DIR,
                                                        "value.pth")))
    return cond_train_replay(sampler, value, cfg["trainer"], golden, device)


def cond_train_replay(sampler, value, trainer_cfg, golden, device):
    """One DxMITrainerCond iteration (``trainer_cfg``) of ``sampler`` and
    ``value`` with the case, data, trajectory and draws of ``golden``:
    update_f_v, then update_sampler with the golden's permutation and
    noise (labels where the golden has them). Returns the arrays the golden
    keeps (``metric/*``, ``log_betas``, the update norms and projections),
    computed the same way."""
    tcfg = {k: v for k, v in trainer_cfg.items() if k != "_target_"}
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
    labels = "y" in golden
    buf = from_d_sample({"l_sample": l_sample,
                         "mean": torch.zeros_like(l_sample[1:]),
                         "sigma": t("sigma"), "logp": t("logp"),
                         "entropy": t("entropy"),
                         "y": t("traj_y") if labels else None})

    def params():
        return {k: v.detach().double().cpu().clone() for k, v in
                [*value.state_dict().items(),
                 *(("s:net." + k, v)
                   for k, v in sampler.net.state_dict().items())]}

    before = params()
    m = trainer.update_f_v(t("img"), buf, y=t("y") if labels else None)
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


def golden_dropout_masks(golden, device, prefix=""):
    """The golden's dropout keep masks (bool, NCHW) in call order, under
    ``<prefix>dropout/NN``."""
    out = []
    for i in range(len([k for k in golden
                        if k.startswith(f"{prefix}dropout/")])):
        shape = tuple(int(n) for n in
                      golden[f"{prefix}dropout_shape/{i:02d}"])
        bits = np.unpackbits(golden[f"{prefix}dropout/{i:02d}"])[
            :int(np.prod(shape))]
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
          "E-bf16", "G2", "G2-int8", "E2", "E2-int8", "G3", "E3", "G5", "E5",
          "G4", "E4", "E4-levers", "G6", "G7", "E6", "E7", "G8", "E8", "E9",
          "E10", "G9", "E11", "G10", "E12", "T-K1", "T-K3", "C", "F")


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
# chunk (the timed row is the first); and at conv16's 8x8 map (S = 64, C =
# 64, two heads of d = 32) at E5's batch 64 and G3's 8
ATTN_SHAPES = [(BATCH, 256, 256), (128, 256, 256), (32, 256, 256)]
ATTN_NH2_SHAPES = [(64, 64, 64, 2), (8, 64, 64, 2)]
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
    here in int8, outside the timed call: float windows would take 60 GB at
    LSUN's 256x256 maps) and the int8 weights; returns the call."""
    B, H, W, Cin = x.shape
    Cout, kh, kw, _ = q.w_i8.shape
    (pt, pb), (pl, pr) = pad
    Ho, Wo = out_size(H, W, kh, kw, pad, stride)
    xq = x.float() / q.xscale if q.divide else x.float() * q.xscale
    xi = torch.clamp(torch.round(xq), -127, 127).to(torch.int8)
    del xq
    xp = F.pad(xi, (0, 0, pl, pr, pt, pb))
    del xi
    cols = torch.empty(B, Ho, Wo, kh * kw, Cin, dtype=torch.int8,
                       device=x.device)
    for ty in range(kh):
        for tx in range(kw):
            cols[:, :, :, ty * kw + tx] = xp[
                :, ty:ty + stride * (Ho - 1) + 1:stride,
                tx:tx + stride * (Wo - 1) + 1:stride]
    del xp
    cols = cols.reshape(B * Ho * Wo, kh * kw * Cin)
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


# K6 fp32's one-launch route (S = 64, C = 32 or 64, d = 16, 32 or 64): batch
# 1, 3, 8, 64 and 128, one, two and four heads at C = 64, C = 32 (one and
# two heads); then the first shapes past its limit (C = 96, S = 128, d = 8),
# which take the multi-launch route
K6_SMALL_SHAPES = [(B, 64, 64, 2) for B in (1, 3, 8, 64, 128)] + [
    (8, 64, 64, 1), (8, 64, 64, 4), (8, 64, 32, 1), (8, 64, 32, 2)]
K6_PAST_SMALL = [(8, 64, 96, 2), (8, 128, 64, 2), (8, 64, 64, 8)]


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
    for shape in K6_SMALL_SHAPES + K6_PAST_SMALL:
        for name, err in k6_fp32_route_check(gen, *shape).items():
            errs[name] = max(errs.get(name, 0.0), err)


def k6_fp32_route_check(gen, B, S, C, nh):
    """K6 fp32 at (B, S, C, nh) against its plain version under its gate
    (5e-4 + 5e-4 rel on all seven cotangents), bit-equal on replay, through
    the route ``bwd_small_takes`` names (two calls counted there and none on
    the other route); returns {route's counter: max abs err}."""
    a = attn_bwd_case(gen, B, S, C, torch.float32)
    small = bwd_small_takes(S, C, nh, torch.float32)
    name = "attn_block_bwd_small" if small else "attn_block_bwd"
    other = "attn_block_bwd" if small else "attn_block_bwd_small"
    before = _lib.LAUNCHES[name], _lib.LAUNCHES[other]
    outs = attn_block_bwd(*a, nh)
    refs = attn_block_bwd_reference(*a, nh)
    what = f"{name} {(B, S, C, nh)} fp32"
    rel, err = attn_bwd_check(outs, refs, torch.float32, what)
    again = attn_block_bwd(*a, nh)
    if not all(torch.equal(u, v) for u, v in zip(outs, again)):
        raise AssertionError(f"{what}: a replay differs")
    got = _lib.LAUNCHES[name] - before[0], _lib.LAUNCHES[other] - before[1]
    if got != (2, 0):
        raise AssertionError(f"{what}: {got[0]} calls counted on its route, "
                             f"{got[1]} on the other, expected 2 and 0")
    worst = max(((o - r).abs() / (ATTN_BWD_FP32_TOL * (1 + r.abs()))).max()
                .item() for o, r in zip(outs, refs))
    print(f"  K {what}: worst mean rel err {rel:.3e}, max abs err {err:.3e}"
          f", worst element at {worst:.3f} of its limit; replay bit-equal")
    return {name: err}


def flash_bwd_time_rows(gen, B, S, nh, d, suffix=""):
    """T rows of K4-dkv and K4-dq at (B, S, nh, d) (bf16), named with
    ``suffix``. Library yardstick: the backward alone of autograd through
    F.scaled_dot_product_attention (one call gives dq, dk and dv)."""
    rows = {}
    qkv, o, lse, do, sm = flash_bwd_case(gen, B, S, nh, d)
    di, dqkv = flash_bwd_dkv(qkv, o, lse, do, sm)
    qt, kt, vt = (qkv[:, :, i].transpose(1, 2).detach().clone()
                  .requires_grad_(True) for i in range(3))
    ot = F.scaled_dot_product_attention(qt, kt, vt, scale=sm)
    dot = do.transpose(1, 2).contiguous()
    lib_ms = time_ms(lambda: torch.autograd.grad(
        ot, (qt, kt, vt), dot, retain_graph=True))
    n, st = B * S * nh * d, B * nh * S
    rows["flash_attn_bwd_dkv" + suffix] = dict(
        ms=time_ms(lambda: flash_bwd_dkv(qkv, o, lse, do, sm, dqkv)),
        plain_ms=time_ms(lambda: flash_reference_dkv(qkv, o, lse, do, sm),
                         iters=3, warmup=1),
        library_ms=lib_ms,
        # q, k, v, o, do read, lse read, di written, dk, dv written
        bytes=(5 * n + 2 * n) * 2 + 2 * st * 4,
        # s, dp, dv and dk products; exp and ds per logit; di
        ops={"bf16": 4 * 2 * B * nh * S * S * d,
             "fp32": 6 * B * nh * S * S + 2 * n})
    rows["flash_attn_bwd_dq" + suffix] = dict(
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
    return rows


def train_time_rows(gen):
    """T rows of K4-dkv, K4-dq (at the 32x32 map, batch 128) and K6 bf16
    (the three maps at batch 128; the first is the recorded row). Library
    yardsticks: the backward alone of autograd through
    F.scaled_dot_product_attention (one call gives dq, dk and dv), and of
    the library composition that K2's row times."""
    rows = flash_bwd_time_rows(gen, TRAIN_BATCH, 1024, 6, 64)
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
    rows["attn_block_bwd_small"] = k6_fp32_time_row(gen, *K6_FP32_G3)
    rows[f"attn_block_bwd_small {K6_FP32_E5}"] = k6_fp32_time_row(
        gen, *K6_FP32_E5)
    rows[f"attn_block_bwd fp32 {K6_FP32_LARGE}"] = k6_fp32_time_row(
        gen, *K6_FP32_LARGE, iters=3)
    return rows


# K6 fp32 rows: G3's shape (the ADM fixture's 8x8 map at batch 8), E5's
# (configs/imagenet64/conv16.yaml's 8x8 map at batch 64), and one shape of
# the multi-launch route, the largest that fused_attn_bwd_available admits
# (S * C = 1024 * 384)
K6_FP32_G3, K6_FP32_E5 = (8, 64, 64, 2), (64, 64, 64, 2)
K6_FP32_LARGE = (128, 1024, 384, 6)


def k6_fp32_time_row(gen, B=8, S=64, C=64, nh=2, iters=20):
    """T row of K6's fp32 form at (B, S, C, nh). Library yardstick: the
    backward alone of autograd through F.group_norm, the matmuls and SDPA
    in fp32 (TF32 off for the matmuls and cuDNN, ``select_device``)."""
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
        ms=time_ms(lambda: attn_block_bwd(*a, nh), iters=iters),
        plain_ms=time_ms(lambda: attn_block_bwd_reference(*a, nh),
                         iters=max(2, iters // 4), warmup=1),
        library_ms=time_ms(lambda: torch.autograd.grad(
            y, [xl, *pl], ct, retain_graph=True), iters=iters),
        # x, ct read and dx written; weights read; the fp32 cotangents of
        # every parameter written
        bytes=3 * M * C * 4 + 4 * C * C * 4 + (4 * C * C + 6 * C) * 4,
        # the products of the bf16 row, on the fp32 units
        ops={"fp32": 2 * 11 * M * C * C + 2 * 6 * B * nh * S * S * d
             + 8 * B * nh * S * S + 20 * M * C})


def bwd_breakdown(gen):
    """Device time of each launch of one K6 fp32 call at G3's and E5's
    shapes, then of one K6 bf16 call at the 32x32 map (batch 128) and of
    one K4-dkv call at the same map, each after a warm-up call: the splits
    that PERF.md's K6 rows record."""
    for B, S, C, nh in (K6_FP32_G3, K6_FP32_E5):
        a = attn_bwd_case(gen, B, S, C, torch.float32)
        attn_block_bwd(*a, nh)
        torch.cuda.synchronize()
        profile_run(lambda: attn_block_bwd(*a, nh),
                    f"K6 fp32 {(B, S, C, nh)}, one call", top=24, width=150)
        del a
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


def train_golden_check(port, golden, what, gate_updates=True):
    """The G3 gates; returns (worst metric rel err, value rel err, worst
    sampler share of its limit). Without ``gate_updates`` the updates'
    norms and projections are read, not gated."""
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
    if gate_updates and not v_rel <= G3_VALUE_REL:
        raise AssertionError(f"{what}: value update {v_rel:.3e} from JAX's")
    share = 0.0
    for kind in ("snorm/", "sproj/"):
        ks = [k for k in golden if k.startswith(kind)]
        a = np.array([port[k] for k in ks])
        b = np.array([golden[k] for k in ks])
        lim = G3_SAMPLER_REL * np.abs(b) + G3_SAMPLER_FLOOR * np.abs(b).max()
        s = np.abs(a - b) / lim
        if not np.isfinite(a).all() or (gate_updates and s.max() > 1):
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
        want = {"gn_silu"} | ({"attn_block", "attn_block_bwd_small"}
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
# E3 runs 2 steps since the LSUN phases (E8, E9) joined the script, the
# second profiled (its wall ends before the trace is read back): step 1
# alone gives s/step, so that the whole run stays inside its time limit
TRAIN_FORWARDS, TRAIN_BACKWARDS, E3_STEPS = 20, 10, 2
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


def e3_grads(cfg, batchsize, rows, device="cuda",
             impls=("einsum", "flash", "fused_train")):
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
    for impl in impls:
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
            with k1_shapes(k1_log, f"E3 {impl}", 1, "step") if i == 0 else \
                    contextlib.nullcontext():
                wall, m = training_step(
                    lambda: train_image_large.train_step(trainer, x, y, gen),
                    i, E3_STEPS, f"E3 {impl}", E3_SHARES[impl], top=16)
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
        out[impl] = got
        del trainer, data
        torch.cuda.empty_cache()
    for line in wiring_check(*e3_grads(cfg, B, E3_GRAD_ROWS)):
        print(f"  E3 wiring: {line}")
    return out


# E5: DxMI training on configs/imagenet64/conv16.yaml at the config's full
# width (16x16 images, 828,003 sampler parameters, fp32, batch 64) from its
# pretrained CONV16_CKPT: 3 steps with the config's default attention
# (einsum) and 3 with fused_train (K2 fp32 forward, K6 fp32 on its one-launch
# route: 4 attention blocks, all at the 8x8 map, S = 64, C = 64, two heads).
# A step runs 20 forwards and 10 backwards (as E3); K1 takes the 25 norms of
# a forward, or the 21 outside the attention blocks (counted on the CPU).
E5_BATCH, E5_STEPS = 64, 3
E5_LAUNCHES_PER_STEP = {
    "einsum": {"gn_silu": 25 * TRAIN_FORWARDS},
    "fused_train": {"gn_silu": 21 * TRAIN_FORWARDS,
                    "attn_block": 4 * TRAIN_FORWARDS,
                    "attn_block_bwd_small": 4 * TRAIN_BACKWARDS},
}
E5_SHARES = {"einsum": None, "fused_train": {
    "K6 fp32 (both launches)": ("bwd_sample_kernel", "sum_samples_kernel")}}


def e5_sampler_check(trainer, log, want):
    """The pretrained file was loaded (the entry's line, no random-init
    WARNING) and the sampler holds its tensors bit for bit."""
    if "WARNING" in log or f"pretrained EDM loaded from {CONV16_CKPT}" \
            not in log:
        raise AssertionError(f"E5: the sampler was not loaded from "
                             f"{CONV16_CKPT}:\n{log}")
    got = trainer.sampler.state_dict()
    bad = [k for k, v in want.items()
           if not torch.equal(got[k].cpu(), v.float())]
    if bad:
        raise AssertionError(f"E5: {len(bad)} tensors differ from the file's,"
                             f" e.g. {bad[:3]}")


def phase_conv16_train(k1_log):
    """E5 (see the module docstring); returns the launches counted in the
    last step of each form."""
    if not os.path.exists(CONV16_CKPT):
        raise AssertionError(f"{CONV16_CKPT} is missing")
    cfg = conv16_config()
    cfg["training"]["pretrained_path"] = CONV16_CKPT
    want = load_sampler_state(CONV16_CKPT, net="unet_adm")
    seed = int(cfg["training"]["seed"])
    out = {}
    for impl in ("einsum", "fused_train"):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        log = io.StringIO()
        with contextlib.redirect_stdout(log):
            trainer = build_trainer(cfg, None if impl == "einsum" else impl,
                                    E5_BATCH)
        e5_sampler_check(trainer, log.getvalue(), want)
        n_params = sum(p.numel() for p in trainer.sampler.parameters())
        data = train_image_large.fake_data(cfg, trainer.sampler, 1024,
                                           E5_BATCH, seed,
                                           torch.device("cuda"))
        gen = torch.Generator(device="cuda").manual_seed(0)
        walls = []
        for i in range(E5_STEPS):
            x, y = next(data)
            _lib.reset_launches()
            t0 = time.perf_counter()
            with k1_shapes(k1_log, f"E5 {impl}", 1, "step") if i == 0 else \
                    contextlib.nullcontext():
                m = train_image_large.train_step(trainer, x, y, gen)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            got = dict(_lib.LAUNCHES)
            if got != E5_LAUNCHES_PER_STEP[impl]:
                raise AssertionError(f"E5 {impl} step {i}: launches {got}, "
                                     f"expected {E5_LAUNCHES_PER_STEP[impl]}")
            bad = [k for k, v in m.items() if not k.startswith("time/")
                   and not torch.isfinite(torch.as_tensor(v)).all()]
            if bad:
                raise AssertionError(f"E5 {impl} step {i}: non-finite {bad}")
            print(f"  E5 {impl} step {i}: {walls[-1]:.3f} s; d_loss "
                  f"{float(m['ebm/d_loss_']):.4f}, sampler_loss "
                  f"{float(m['sampler/sampler_loss_']):.4f}", flush=True)
        if trainer.nan_guard_skips:
            raise AssertionError(f"E5 {impl}: {trainer.nan_guard_skips} "
                                 "updates skipped by the non-finite guard")
        print(f"  E5 {impl}: {n_params} sampler parameters from "
              f"{os.path.relpath(CONV16_CKPT, REPO)}, batch {E5_BATCH}; "
              f"{np.mean(walls[1:]):.4f} s/step over steps 1-{E5_STEPS - 1};"
              f" launches per step {E5_LAUNCHES_PER_STEP[impl]} as expected;"
              f" peak allocated "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB",
              flush=True)
        x, y = next(data)
        profile_run(lambda: train_image_large.train_step(trainer, x, y, gen),
                    f"E5 {impl} profile, one training step", top=10,
                    shares=E5_SHARES[impl])
        out[impl] = got
        del trainer, data
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
    for B, S, C, nh in ATTN_NH2_SHAPES:
        a = attn_case(gen, B, S, C)
        before = _lib.LAUNCHES["attn_block"]
        out = attn_block(*a, num_heads=nh, eps=1e-6)
        if _lib.LAUNCHES["attn_block"] != before + 1:
            raise AssertionError(f"attn_block {(B, S, C, nh)}: not counted as "
                                 "K2 fp32")
        err = max_err(out, attn_block_reference(*a, num_heads=nh, eps=1e-6),
                      "attn_block")
        if not torch.equal(out, attn_block(*a, num_heads=nh, eps=1e-6)):
            raise AssertionError(f"attn_block {(B, S, C, nh)}: a replay "
                                 "differs")
        print(f"  K attn_block {(B, S, C, nh)}: max abs err vs plain "
              f"{err:.3e}; replay bit-equal")
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
    phase_kernels_ddgan(gen, errs)
    phase_kernels_lsun(gen, errs)
    phase_kernels_anomaly(gen, errs)
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
    rows.update(ddgan_time_rows(gen))
    rows.update(lsun_time_rows(gen))
    rows.update(anomaly_time_rows(gen))
    rows.update(e12_time_rows(gen))
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
        name = "attn_block_bf16" if i == 0 else f"attn_block_bf16 {(B, S, C, nh)}"
        rows[name] = attn_bf16_row(gen, B, S, C, nh)
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
        name = "attn_block_i8" if i == 0 else \
            f"attn_block_i8 {(B, S, C, nh)}"
        rows[name] = attn_i8_row(gen, B, S, C, nh, dt)
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
    over all its launches). Only the device's activity is recorded, not the
    host's operators, so the host runs at its own speed while it is traced
    (reading a training step's host events back takes tens of seconds)."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_name = collections.defaultdict(lambda: [0.0, 0])
    spans = []
    for ev in prof.events():  # the kernels' own events, summed by name
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            by_name[ev.name][0] += ev.time_range.elapsed_us() / 1e3
            by_name[ev.name][1] += 1
            spans.append((ev.time_range.start, ev.time_range.end))
    rows = [(ms, n, name) for name, (ms, n) in by_name.items() if ms > 0]
    # busy time: the union of the kernels' spans (a library may run some
    # on streams of its own, side by side: cuDNN's fp32 FFT convolutions)
    total, end = 0.0, float("-inf")
    for a, b in sorted(spans):
        if b > end:
            total += (b - max(a, end)) / 1e3
            end = b
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


def training_step(run, i, n, label, shares, top=12):
    """Step ``i`` of ``n`` of a training phase: ``run()`` returns its
    metrics; the last step is profiled (``profile_run``), its wall ending
    before its trace is read back. Returns (wall s, metrics)."""
    t0 = time.perf_counter()
    if i < n - 1:
        m = run()
        return time.perf_counter() - t0, m
    out = []
    prof = profile_run(lambda: out.append(run()), f"{label} profile, step "
                       f"{i}", top=top, shares=shares)
    return (time.perf_counter() - t0 if prof is None else prof[1] / 1e3,
            out[0])


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


# The fp32 ADM goldens' limits (tests/test_golden_adm_fixture.py): each
# step's mean within 5e-3, its sigma within 1e-5 rel, the final sample
# within 5e-3.
ADM_MEAN_ATOL, ADM_SIGMA_RTOL = 5e-3, 1e-5


def adm_golden_replay(sampler, golden, device, what):
    """Each step of ``golden`` (x_init, eps, y, means, sigmas, final)
    restarted from the golden state, under the fp32 ADM goldens' limits;
    returns (worst step mean err, final err)."""
    y = torch.from_numpy(np.asarray(golden["y"])).long().to(device)
    x = torch.from_numpy(golden["x_init"]).to(device)
    worst = 0.0
    with torch.no_grad():
        for t in range(sampler.n_timesteps):
            eps = torch.from_numpy(golden["eps"][t]).to(device)
            out = sampler.sample_step(x, t, noise=eps, y=y)
            err = float(np.abs(out["mean"].cpu().numpy()
                               - golden["means"][t]).max())
            worst = max(worst, err)
            if err > ADM_MEAN_ATOL:
                raise AssertionError(f"{what} step {t}: mean err {err:.3e}")
            np.testing.assert_allclose(
                out["sigma"].cpu().numpy().reshape(-1, 1, 1, 1),
                golden["sigmas"][t], rtol=ADM_SIGMA_RTOL, atol=1e-6)
            x = torch.from_numpy(golden["means"][t] + golden["sigmas"][t]
                                 * golden["eps"][t]).to(device)
    final = float(np.abs(out["sample"].cpu().numpy() - golden["final"]).max())
    if final > ADM_MEAN_ATOL:
        raise AssertionError(f"{what}: final err {final:.3e}")
    return worst, final


def phase_replay_adm():
    """The trained ADM fixture's trajectory (fp32, nh 2 at 8x8, d 32): each
    step restarted from the golden mean with the golden eps and labels
    (``adm_golden_replay``)."""
    golden = np.load(os.path.join(ADM_FIXTURE_DIR, "golden.npz"))
    state = load_sampler_state(os.path.join(ADM_FIXTURE_DIR, "sampler.pth"))
    errs = {}
    for impl in ("einsum", "fused"):
        _lib.reset_launches()
        sampler = generate_large.load_sampler(
            adm_fixture_config(), state, "cuda", attn_impl=impl,
            up_impl="resize", gn_stats="fp32")
        worst, final = adm_golden_replay(sampler, golden, "cuda",
                                         f"attn_impl={impl}")
        used = {k for k, v in _lib.LAUNCHES.items() if v}
        want = {"gn_silu"} | ({"attn_block"} if impl == "fused" else set())
        if used != want:
            raise AssertionError(f"attn_impl={impl}: launched {used}, "
                                 f"expected {want}")
        errs[impl] = worst
        print(f"  G2 attn_impl={impl}: max per-step mean err {worst:.3e} "
              f"(tol {ADM_MEAN_ATOL:g}), final {final:.3e}, kernels "
              f"{sorted(used)}")
    return errs


# G5: the JAX package's EDMSampler from CONV16_CKPT (its fp32 net, einsum
# attention) on an injected trajectory (EDM16_GOLDEN, built by tests/
# torch_fixtures/make_edm16_golden.py): batch 4, T = 10, labels 0-3, x_init
# and the per-step noise drawn by ``edm16_draws`` from the golden's seed.
EDM16_BATCH = 4


def edm16_draws(seed, n=EDM16_BATCH, steps=T, shape=(3, 16, 16),
                sigma_max=80.0, num_classes=4):
    """G5's injected draws from a numpy seed (numpy's legacy generator is
    the same on every host): x_init = sigma_max N(0, 1) (n, *shape), eps
    (steps, n, *shape) and the labels 0, 1, ... modulo ``num_classes``."""
    rs = np.random.RandomState(seed)
    x_init = (rs.randn(n, *shape) * sigma_max).astype(np.float32)
    eps = rs.randn(steps, n, *shape).astype(np.float32)
    return x_init, eps, np.arange(n, dtype=np.int64) % num_classes


def conv16_config():
    """configs/imagenet64/conv16.yaml with its dataset config merged, read
    by the port's YAML reader."""
    return merge(load_yaml(CONV16_CONFIG), load_yaml(os.path.join(
        REPO, "configs", "imagenet64", "imagenet64.yaml")))


def edm16_golden():
    """EDM16_GOLDEN with its draws: the arrays ``adm_golden_replay`` reads."""
    gold = dict(np.load(EDM16_GOLDEN))
    gold["x_init"], gold["eps"], gold["y"] = edm16_draws(int(gold["seed"]))
    return gold


def phase_replay_edm16():
    """G5: the port's EDMSampler with CONV16_CKPT loaded by its msgpack
    reader, against the JAX package's trajectory under the fp32 ADM goldens'
    limits, with einsum and fused (K2 fp32) attention."""
    if not os.path.exists(CONV16_CKPT):
        raise AssertionError(f"{CONV16_CKPT} is missing")
    state = load_sampler_state(CONV16_CKPT, net="unet_adm")
    gold = edm16_golden()
    errs = {}
    for impl in ("einsum", "fused"):
        _lib.reset_launches()
        sampler = generate_large.load_sampler(
            conv16_config(), state, "cuda", attn_impl=impl, up_impl="resize",
            gn_stats="fp32")
        worst, final = adm_golden_replay(sampler, gold, "cuda",
                                         f"G5 attn_impl={impl}")
        used = {k for k, v in _lib.LAUNCHES.items() if v}
        want = {"gn_silu"} | ({"attn_block"} if impl == "fused" else set())
        if used != want:
            raise AssertionError(f"G5 attn_impl={impl}: launched {used}, "
                                 f"expected {want}")
        errs[impl] = worst
        print(f"  G5 attn_impl={impl}: {len(state)} tensors from "
              f"{os.path.relpath(CONV16_CKPT, REPO)}; max per-step mean err "
              f"{worst:.3e} (tol {ADM_MEAN_ATOL:g}), final {final:.3e}, "
              f"kernels {sorted(used)}")
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


# CLI subprocesses at a time in phase C (five since E12's entries joined
# its pool; this process empties its cache of the card's memory first)
CLI_WORKERS = 5


def fixture_cli(out_dir, module, run_dir, extra, bs):
    """One generation CLI on a fixture run dir, in a subprocess; the npz's
    path, the seconds and the last two lines of its output."""
    path = os.path.join(out_dir, f"{module}{''.join(extra)}.npz")
    if os.path.exists(path):
        os.remove(path)
    cmd = [sys.executable, "-m", f"dxmi_tpu_torch.{module}", "--log_dir",
           run_dir, "--n_generate", "8", "--batchsize", str(bs),
           "--save_npz", path, *extra]
    if module == "generate_cifar10":  # its PNGs, off the fixture dir
        cmd += ["--save_dir", path[:-4] + "_png"]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True,
                          timeout=300, env=dict(os.environ, PYTHONPATH=REPO))
    if proc.returncode != 0:
        raise AssertionError(f"{' '.join(cmd[2:])} failed:\n"
                             f"{proc.stdout}{proc.stderr}")
    return path, time.perf_counter() - t0, proc.stdout.strip().splitlines()[-2:]


def phase_cli():
    """The generation CLIs as a user runs them, in subprocesses on the card,
    on the fixture run dirs (config.yaml through the port's YAML reader,
    --save_npz streaming): generate_cifar10 (also --int8 and --dtype bf16),
    generate_large, generate_large --int8; the training CLIs followed by
    generation on the run dirs they write; and the resume chains
    (``resume_chains``: a training CLI, the same with --resume, then guided
    generation on the run dir). The subprocesses run
    ``CLI_WORKERS`` at a time (each spends most of its seconds starting).
    Each npz is held to the in-process samples of the same seed, within one
    uint8 level (another process may get another cuDNN algorithm); the
    labels equal."""
    out_dir = os.path.join(REPO, "build", "chip_smoke_cli")
    os.makedirs(out_dir, exist_ok=True)
    # the subprocesses need the card's memory that this process's caching
    # allocator still holds from the phases before (with E12's entries in
    # its pool, the whole script's C ran out of it without this)
    held = torch.cuda.memory_reserved() / 2 ** 30
    torch.cuda.empty_cache()
    print(f"  C: this process held {held:.2f} GiB of the card's memory in "
          f"its cache, {torch.cuda.memory_reserved() / 2 ** 30:.2f} GiB "
          "after emptying it", flush=True)
    runs = [("generate_cifar10", FIXTURE_DIR, (), 4),
            ("generate_cifar10", FIXTURE_DIR, ("--int8",), 4),
            ("generate_cifar10", FIXTURE_DIR, ("--dtype", "bf16"), 4),
            ("generate_large", ADM_FIXTURE_DIR, (), 8),
            ("generate_large", ADM_FIXTURE_DIR, ("--int8",), 8)]
    with concurrent.futures.ThreadPoolExecutor(CLI_WORKERS) as pool:
        trained = [pool.submit(resume_chain, out_dir, *chain)
                   for chain in resume_chains()]
        trained += [pool.submit(fn, out_dir) for fn in
                    (train_cli, cifar_train_cli, ddgan_train_cli, twod_cli,
                     folder_train_cli)]
        entries = {name: pool.submit(e12_entry, name)
                   for name in E12_ENTRIES}
        clis = [pool.submit(fixture_cli, out_dir, *run) for run in runs]
        done = [f.result() for f in clis]
        for f in trained:
            f.result()
        entries = {name: f.result() for name, f in entries.items()}
    e12_entries(entries)
    for (module, run_dir, extra, bs), (path, secs, last) in zip(runs, done):
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
        print(f"  C {module} {' '.join(extra)}: {secs:.1f} s, npz "
              f"{got['arr_0'].shape} {got['arr_0'].dtype} within {diff} uint8 "
              f"level of in-process; {' | '.join(last)}")


# Phase C's resume chains: a training entry at its config's full width for 2
# steps, the same with --resume to 3 (a fresh process that restores
# train_state.msgpack), then guided generation on the run dir they leave.
# After the first run the state file's parameter leaves are its
# sampler_last.pth and value_last.pth bit for bit (flax layout) and its
# optimizer counts the steps taken; the resumed run prints the JAX entry's
# line with the saved iteration; every logged metric is finite. The conv16
# chain's first run is also E5's check of the entry itself: the pretrained
# file loaded with no random-init warning, no update skipped by the
# non-finite guard.
GUIDE_SCALE = 0.1


def resume_chains():
    """(name, train command, its --resume follow-up, guided generation
    command, run dir, optimizer counts after 2 and after 3 steps) of
    train_cifar10 on configs/cifar10/T10.yaml (full width, batch 128: the
    sampler's two Adam counts, then the value's: 1 + T steps an iteration)
    and of train_image_large on conv16.yaml from its pretrained file with
    --save_state_every 1 (the guard's two int32 counters, two RAdam
    counts of a full sweep of T minibatches an iteration, the value's
    Adam)."""
    run = "chip_resume"
    cifar = [sys.executable, "-m", "dxmi_tpu_torch.train_cifar10",
             "--config", CIFAR10_CONFIG, "--dataset",
             os.path.join(REPO, "configs", "cifar10", "cifar10.yaml"),
             "--run", run, "--fake_data", "--training.log_every", "1",
             "--max_steps", "2"]
    cifar_dir = os.path.join("results", "cifar10", "T10", run)
    conv = [sys.executable, "-m", "dxmi_tpu_torch.train_image_large",
            "--config", CONV16_CONFIG, "--dataset",
            os.path.join(REPO, "configs", "imagenet64", "imagenet64.yaml"),
            "--run", run, "--fake_data", "--fake_data_size", "1024",
            "--data.name", "adm_conv16", "--training.pretrained_path",
            CONV16_CKPT, "--attn_impl", "fused_train", "--save_state_every",
            "1", "--training.log_every", "1", "--max_steps", "2"]
    conv_dir = os.path.join("results", "adm_conv16", "conv16", run)

    def gen(module, run_dir, n):
        return [sys.executable, "-m", f"dxmi_tpu_torch.{module}",
                "--log_dir", run_dir, "--sampler", "last", "--n_generate",
                str(n), "--batchsize", str(n), "--guidance_scale",
                str(GUIDE_SCALE), "--save_npz",
                os.path.join(run_dir, "guided.npz")]

    return [("train_cifar10", cifar, cifar[:-1] + ["3", "--resume"],
             gen("generate_cifar10", cifar_dir, BATCH), cifar_dir,
             ([2, 2, 2 * (1 + T)], [3, 3, 3 * (1 + T)])),
            ("train_image_large", conv, conv[:-1] + ["3", "--resume"],
             gen("generate_large", conv_dir, 64), conv_dir,
             ([0, 0, 2 * T, 2 * T, 2 * (1 + T)],
              [0, 0, 3 * T, 3 * T, 3 * (1 + T)]))]


def run_cli(cmd, out_dir, what):
    """One CLI in a subprocess from ``out_dir``: (stdout lines, seconds)."""
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=out_dir, capture_output=True, text=True,
                          timeout=300, env=dict(os.environ, PYTHONPATH=REPO))
    if proc.returncode != 0:
        raise AssertionError(f"{what} failed:\n{proc.stdout[-3000:]}"
                             f"{proc.stderr[-3000:]}")
    return proc.stdout.strip().splitlines(), time.perf_counter() - t0


def finite_iters(lines, what):
    """The logged iterations; each one's d_loss and sampler_loss finite."""
    iters = []
    for line in lines:
        if line.startswith("iter "):
            vals = [float(tok.split("=")[1]) for tok in line.split()
                    if tok.startswith(("d_loss=", "sampler_loss="))]
            if len(vals) != 2 or not np.isfinite(vals).all():
                raise AssertionError(f"{what}: {line}")
            iters.append(int(line.split()[1]))
    return iters


def state_counts(state):
    """The int32 scalars of a train state, in order: the optimizers'
    counters."""
    return [int(a) for a in (state["leaves"][str(i)]
                             for i in range(len(state["leaves"])))
            if isinstance(a, np.ndarray) and a.dtype == np.int32
            and a.ndim == 0]


def state_params_are_last(run_dir, state):
    """The state's first leaves are the run's ``sampler_last.pth`` (its
    log_betas, then the net in flax order) and ``value_last.pth``, bit for
    bit in flax's layout; returns their count."""
    cfg = load_yaml(os.path.join(run_dir, "config.yaml"))
    with torch.device("meta"):
        if "diffusion" in cfg:
            d = {k: v for k, v in cfg["diffusion"].items() if k not in (
                "sigma_min", "sigma_max", "weight_schedule", "distillation")}
            net = train_image_large.create_unet_adm(**d)
        else:
            net = instantiate(cfg["sampler_net"])
        value = instantiate(cfg["value"])
    want = []
    for name, module in (("sampler", net), ("value", value)):
        sd = torch.load(os.path.join(run_dir, f"{name}_last.pth"),
                        weights_only=True)["state_dict"]
        if "log_betas" in sd:
            want.append(sd.pop("log_betas"))
        for (_, axes), k in sorted((flax_path(module, k, v.dim()), k)
                                   for k, v in sd.items()):
            want.append(sd[k].permute(axes) if axes else sd[k])
    for i, w in enumerate(want):
        got = np.asarray(state["leaves"][str(i)])
        if got.tobytes() != w.contiguous().numpy().tobytes():
            raise AssertionError(f"{run_dir}: state leaf {i} is not the "
                                 "run's *_last.pth tensor")
    return len(want)


def resume_chain(out_dir, name, first, resume, gen, run_dir, counts):
    run_dir = os.path.join(out_dir, run_dir)
    shutil.rmtree(run_dir, ignore_errors=True)
    path = os.path.join(run_dir, "train_state.msgpack")
    lines, s1 = run_cli(first, out_dir, name)
    it1 = finite_iters(lines, name)
    if "--training.pretrained_path" in first and (
            f"pretrained EDM loaded from {CONV16_CKPT}" not in lines
            or "nan-guard skips: 0" not in lines
            or any(l.startswith("WARNING") for l in lines)):
        raise AssertionError(f"{name}: the pretrained file not loaded, or "
                             f"an update skipped:\n{lines[-5:]}")
    state = port_msgpack.read(path)
    n = state_params_are_last(run_dir, state)
    if state_counts(state) != counts[0]:
        raise AssertionError(f"{name}: counts {state_counts(state)} after 2 "
                             f"steps, expected {counts[0]}")
    lines, s2 = run_cli(resume, out_dir, f"{name} --resume")
    it2 = finite_iters(lines, f"{name} --resume")
    resumed = [l for l in lines if l.startswith("resumed full train state")]
    if not resumed or not resumed[0].endswith("iter 2") or it2 != [2]:
        raise AssertionError(f"{name} --resume: {resumed} iterations {it2}")
    got = state_counts(port_msgpack.read(path))
    if got != counts[1]:
        raise AssertionError(f"{name} --resume: counts {got}, expected "
                             f"{counts[1]}")
    lines, s3 = run_cli(gen, out_dir, f"{gen[2]} --guidance_scale")
    npz = np.load(os.path.join(run_dir, "guided.npz"))["arr_0"]
    if (f"value-guided sampling, scale={GUIDE_SCALE}" not in lines
            or npz.shape[0] != int(gen[gen.index("--n_generate") + 1])):
        raise AssertionError(f"{gen[2]} --guidance_scale: {lines[-3:]}, "
                             f"npz {npz.shape}")
    print(f"  C {name} resume chain: {s1:.1f} + {s2:.1f} s (iterations "
          f"{it1} then {it2}; '{resumed[0]}'; {n} parameter leaves equal to "
          f"*_last.pth; counts {counts[0]} -> {got}); {gen[2]} "
          f"--guidance_scale {GUIDE_SCALE}: {s3:.1f} s, npz {npz.shape}, "
          f"pixel std {npz.std():.2f}")


# Phase E10: value-guided generation (``sample_guidance``) at full width:
# CIFAR-10 T=10 (fp32, the port's default kernels), 2 x 100 with the seeded
# IGEBM value, and ImageNet64 T=10 (bf16, fused), 1 x 100 through the Cond
# trainer (labels drawn): launches counted (a forward's launches each step:
# the value's gradient runs no kernel), each step from the kernels' state
# held against the kernels' plain versions on the same state and noise: fp32
# per element within G's fused limit (REPLAY_TOL, K3's bf16 operands), bf16
# within BF16_REPLAY_SHARE of the bf16 effect (E8's gate, at
# LSUN_PLAIN_BATCH samples). The guidance term itself is held the same way,
# each against its own scale: it is small beside the sample (the seeded
# value's gradient times 0.1 sigma), so the sample's gate cannot see it.
# fp32: its distance from the plain step's within GUIDE_REL of the plain
# step's norm (a dropped, doubled or sigma-less term is 1 or more of it;
# the kernels' roundings move it only through the leaky-ReLU units of the
# value that they flip); bf16: its mean distance within BF16_REPLAY_SHARE
# of the bf16 effect on it, as the sample.
GUIDE_REL = 0.1


def plain_kernels_cifar():
    """The UNetSmall path with the plain versions of K1, K3 and K2 on the
    card."""
    from dxmi_tpu_torch.models import unet_small as us
    stack = contextlib.ExitStack()
    for name, fn in (("group_norm", group_norm_silu_reference),
                     ("gn_silu_conv", gn_silu_conv_reference),
                     ("attn_block", lambda *a, block_b=None, **k:
                      attn_block_reference(*a, **k))):
        stack.enter_context(_patched(us, name, fn))
    return stack


def guide_trainer(cfg, sampler, seed=1):
    """The config's trainer bound to ``sampler`` and the config's value
    drawn from ``seed`` (no optimizer), guiding at GUIDE_SCALE."""
    torch.manual_seed(seed)
    value = instantiate(cfg["value"]).cuda().eval()
    trainer = instantiate(cfg["trainer"], batchsize=BATCH, n_timesteps=T)
    trainer.sampler, trainer.value = sampler, value
    trainer.guidance_scale = GUIDE_SCALE
    return trainer


def guided_run(trainer, n_batches, want_per_forward, what):
    _lib.reset_launches()
    gen = torch.Generator(device="cuda").manual_seed(0)
    t0 = time.perf_counter()
    outs = [trainer.sample_guidance(BATCH, generator=gen)
            for _ in range(n_batches)]
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    got = dict(_lib.LAUNCHES)
    want = {k: v * T * n_batches for k, v in want_per_forward.items()}
    if got != want:
        raise AssertionError(f"E10 {what}: launches {got}, expected {want}")
    for out in outs:
        if not (torch.isfinite(out["sample"]).all()
                and torch.isfinite(out["logp_on_traj"]).all()):
            raise AssertionError(f"E10 {what}: non-finite samples")
        if not out["guidance"].abs().max() > 0:
            raise AssertionError(f"E10 {what}: no guidance")
    g = torch.stack([o["guidance"] for o in outs]).abs().mean().item()
    print(f"  E10 {what}: {n_batches} x {BATCH} guided in {secs:.3f} s "
          f"({n_batches * BATCH / secs:.1f} img/s), launches {got}, mean "
          f"|guidance| {g:.3e}, sample std "
          f"{torch.cat([o['sample'] for o in outs]).std().item():.3f}")
    return outs


def phase_guidance():
    cfg = load_yaml(CIFAR10_CONFIG)
    sampler = load_sampler(cfg, None, "cuda", seed=0)
    trainer = guide_trainer(cfg, sampler)
    trainer.sample_guidance(BATCH, generator=torch.Generator(
        device="cuda").manual_seed(5))  # warm-up
    guided_run(trainer, N_BATCHES, LAUNCHES_PER_FORWARD, "CIFAR-10 fp32")
    gen = torch.Generator(device="cuda").manual_seed(7)
    x = torch.randn((BATCH, 3, 32, 32), generator=gen, device="cuda")
    worst, worst_g = 0.0, 0.0
    for t in range(T):
        noise = torch.randn(x.shape, generator=gen, device="cuda")
        step = trainer.guided_step(x, t, GUIDE_SCALE, noise)
        with plain_kernels_cifar():
            ref = trainer.guided_step(x, t, GUIDE_SCALE, noise)
        err = (step["sample"] - ref["sample"]).abs().max().item()
        err_g = ((step["guidance"] - ref["guidance"]).norm()
                 / ref["guidance"].norm()).item()
        worst, worst_g = max(worst, err), max(worst_g, err_g)
        if err > REPLAY_TOL[True] or not err_g <= GUIDE_REL:
            raise AssertionError(f"E10 CIFAR-10 step {t}: {err:.3e} from "
                                 f"the plain versions, guidance {err_g:.3e}"
                                 " of its norm")
        x = step["sample"]
    print(f"  E10 CIFAR-10: each guided step against the plain versions "
          f"{worst:.3e} at most (tol {REPLAY_TOL[True]:g}), its guidance "
          f"{worst_g:.3e} of the plain step's norm at most (tol "
          f"{GUIDE_REL:g})")
    del trainer, sampler
    torch.cuda.empty_cache()

    cfg = load_yaml(IMAGENET64_CONFIG)
    gcfg = {k: cfg[k] for k in ("diffusion", "sampler")}
    sampler = generate_large.load_sampler(gcfg, None, "cuda", seed=0)
    trainer = guide_trainer(cfg, sampler)
    outs = guided_run(trainer, 1, ADM_LAUNCHES_PER_FORWARD["fused"],
                      "ImageNet64 bf16 fused")
    y = outs[0]["y"]
    if y is None or int(y.min()) < 0 or int(y.max()) >= 1000:
        raise AssertionError("E10 ImageNet64: labels out of range")
    fp = generate_large.load_sampler(
        merge(gcfg, {"diffusion": {"use_fp16": False}}), None, "cuda", 0)
    rs = np.random.RandomState(10)
    n = LSUN_PLAIN_BATCH
    x = torch.from_numpy(rs.randn(n, 3, 64, 64).astype(np.float32)
                         * 80.0).cuda()
    yy = torch.from_numpy(rs.randint(0, 1000, n)).cuda()
    worst = [0.0, 0.0, 0.0]
    for t in range(T):
        noise = torch.from_numpy(rs.randn(n, 3, 64, 64).astype(
            np.float32)).cuda()
        step = trainer.guided_step(x, t, GUIDE_SCALE, noise, y=yy)
        with plain_kernels_adm():
            ref = trainer.guided_step(x, t, GUIDE_SCALE, noise, y=yy)
            trainer.sampler = fp
            full = trainer.guided_step(x, t, GUIDE_SCALE, noise, y=yy)
            trainer.sampler = sampler
        eff = (ref["sample"] - full["sample"]).abs()
        err = (step["sample"] - ref["sample"]).abs()
        err_g = (step["guidance"] - ref["guidance"]).abs().mean() / (
            ref["guidance"] - full["guidance"]).abs().mean()
        worst = [max(worst[0], (err.mean() / eff.mean()).item()),
                 max(worst[1], (err.max() / eff.max()).item()),
                 max(worst[2], err_g.item())]
        x = step["sample"]
    if not max(worst) <= BF16_REPLAY_SHARE:
        raise AssertionError(f"E10 ImageNet64: {worst} of the bf16 effect "
                             "from the plain versions (sample mean, "
                             "largest; guidance mean)")
    print(f"  E10 ImageNet64: each guided step against the plain versions "
          f"at {n} samples: mean {worst[0]:.3f}, largest {worst[1]:.3f} of "
          f"the bf16 effect, its guidance mean {worst[2]:.3f} of the bf16 "
          f"effect on it (limit {BF16_REPLAY_SHARE:g})")
    del trainer, sampler, fp
    torch.cuda.empty_cache()


# Phase F: FID and the evaluator at full width, in a temporary working
# directory whose datasets/ holds the proxy files (fid/proxy.py: the seed-0
# synthetic Inception weights, statistics over fake_cifar), never the repo's
FID_GOLDEN = os.path.join(REPO, "tests", "torch_fixtures", "fid_golden.npz")
# 32 batches of 100: four whole chunks of 8 trajectories, above the 2048
# samples below which the samples' covariance is singular
FID_SAMPLES, FID_BATCH = 3200, 100
FID_REF_N, FID_REF_SEED = 4096, 112233  # the proxy's fake_cifar statistics
# JAX's own cross-framework limit for the FID Inception, 1e-3 of the
# feature scale + 1e-4 (tests/test_inception_load.py)
FID_REL, FID_ABS = 1e-3, 1e-4
FID_SAME_REL = 1e-6  # the evaluator's FID against generate_cifar10's


def run_entry(module, argv):
    """``module.main()`` in this process with ``argv``; its stdout."""
    buf, old = io.StringIO(), sys.argv
    sys.argv = [module.__name__, *argv]
    try:
        with contextlib.redirect_stdout(buf):
            module.main()
    finally:
        sys.argv = old
    return buf.getvalue()


def fid_lines(out, what):
    """The value of an entry's ``FID:`` line and its ``FID time:`` line;
    raises when FID was skipped."""
    lines = out.splitlines()
    fid = [l for l in lines if l.startswith("FID: ")]
    split = [l for l in lines if l.startswith("FID time: ")]
    if len(fid) != 1 or len(split) != 1:
        raise AssertionError(f"{what}: FID not computed:\n{out[-3000:]}")
    return float(fid[0].split()[1]), split[0]


def fid_golden_check(model):
    """The port's FID Inception on the card against the JAX evaluator's
    outputs under the same weights (tests/torch_fixtures/fid_golden.npz)."""
    gold = np.load(FID_GOLDEN)
    fc_w, fc_b = (model.fc.weight.detach().cpu().numpy().T,
                  model.fc.bias.detach().cpu().numpy())
    worst = 0.0
    for key in ("x32", "x64"):
        dev = next(model.parameters()).device
        with torch.no_grad():
            out = {k: v.cpu().numpy() for k, v in model.taps(
                torch.from_numpy(gold[key].transpose(0, 3, 1, 2).copy())
                .to(dev)).items()}
        logits = out["pool3"] @ fc_w + fc_b
        e = np.exp(logits - logits.max(axis=1, keepdims=True))
        out["probs"] = e / e.sum(axis=1, keepdims=True)
        for name in ("pool3", "spatial", "probs"):
            ref = gold[f"{key}_{name}"]
            err = float(np.abs(out[name] - ref).max())
            lim = FID_REL * float(np.abs(ref).mean()) + FID_ABS
            if not err < lim:
                raise AssertionError(f"F Inception {key} {name}: {err:.3e} "
                                     f"from JAX's (limit {lim:.3e})")
            worst = max(worst, err / lim)
            print(f"  F Inception {key} {name}: {err:.3e} from JAX's "
                  f"({err / lim:.4f} of the limit)")
    return worst


def inception_rate(model):
    """Inception's img/s at batch 100 on 32x32 inputs (fp32, TF32 off) and
    a profile of one batch."""
    x = torch.rand(FID_BATCH, 3, 32, 32, device="cuda")
    with torch.no_grad():
        ms = time_ms(lambda: model(x), iters=5, warmup=2)
        profile_run(lambda: model(x), "F Inception, one batch of 100",
                    top=8)
    rate = FID_BATCH / ms * 1e3
    print(f"  F Inception: {ms:.2f} ms a batch of {FID_BATCH}, {rate:.1f} "
          "img/s (fp32, TF32 off)")
    return rate


def phase_fid(device="cuda", n=FID_SAMPLES, batch=FID_BATCH,
              ref_n=FID_REF_N, train_args=()):
    """FID and the evaluator through the entries at full width (CIFAR-10
    T=10), in a temporary working directory: the Inception against JAX's
    golden, its img/s; the proxy files; train_cifar10 for 2 steps with the
    FID at epoch 0 on 3200 samples (sampler_best written with its fid);
    generate_cifar10 --sampler best -n 3200 --eval_fid --save_npz (the PNGs
    decode to the npz); the evaluator on that npz against a reference npz
    of the proxy's images (IS, FID, sFID, precision, recall finite; its FID
    equal to generate_cifar10's). ``device``, the sizes and the training
    overrides let the CPU rehearse the phase at a small width."""

    cuda = device == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    out = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_fid_") as work, \
            contextlib.chdir(work):
        t0 = time.perf_counter()
        wpath = proxy.write_weights("datasets")
        model = build_inception(load_fid_inception_params(wpath),
                                torch.device(device))
        t1 = time.perf_counter()
        out["golden"] = fid_golden_check(model)
        if cuda:
            out["img_s"] = inception_rate(model)
        t2 = time.perf_counter()
        proxy.write_cifar_stats("datasets", model, ref_n, FID_REF_SEED, batch)
        np.savez("ref.npz", arr_0=fake_cifar(ref_n, FID_REF_SEED).images)
        del model
        print(f"  F proxy files: weights {t1 - t0:.1f} s, statistics of "
              f"{ref_n} images and the reference npz "
              f"{time.perf_counter() - t2:.1f} s; golden and img/s "
              f"{t2 - t1:.1f} s")

        t0 = time.perf_counter()
        log = run_entry(train_cifar10, [
            "--config", CIFAR10_CONFIG, "--dataset",
            os.path.join(REPO, "configs", "cifar10", "cifar10.yaml"),
            "--run", "fid", "--fake_data", "--max_steps", "2", "--device",
            device, "--training.n_fid_samples", str(n),
            "--training.sampling_batchsize", str(batch), *train_args])
        fid_train, split = fid_lines(log, "train_cifar10")
        run = os.path.join("results", "cifar10", "T10", "fid")
        best = torch.load(os.path.join(run, "sampler_best.pth"),
                          weights_only=True)
        meta = {k: v for k, v in best.items() if k != "state_dict"}
        if meta != {"fid": fid_train, "epoch": 0, "iter": 0} \
                or "done: 2 iters" not in log:
            raise AssertionError(f"train_cifar10: sampler_best meta {meta}, "
                                 f"FID {fid_train}")
        print(f"  F train_cifar10 (2 steps, FID at epoch 0 on {n}): "
              f"{time.perf_counter() - t0:.1f} s; FID "
              f"{fid_train}; {split}; sampler_best meta fid/epoch/iter ok")

        t0 = time.perf_counter()
        log = run_entry(generate_cifar10, [
            "--log_dir", run, "--sampler", "best", "-n", str(n),
            "--batchsize", str(batch), "--eval_fid", "--save_npz",
            "samples.npz", "--device", device])
        fid_gen, split = fid_lines(log, "generate_cifar10")
        arr = np.load("samples.npz")["arr_0"]
        pngs = os.path.join(run, "generated_best")
        if len(arr) != n or any(
                not np.array_equal(read_png(os.path.join(pngs, f"0_{i}.png")),
                                   arr[i]) for i in range(n)):
            raise AssertionError("generate_cifar10: the PNGs do not decode "
                                 "to the npz")
        print(f"  F generate_cifar10 --eval_fid (-n {n}): "
              f"{time.perf_counter() - t0:.1f} s; FID {fid_gen}; {split}; "
              f"{n} PNGs decode to the npz")

        t0 = time.perf_counter()
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            ev = evaluator.evaluate(
                "ref.npz", "samples.npz",
                evaluator.build_extractors(wpath, device), batch, device)
        names = ("IS", "FID", "sFID", "precision", "recall")
        if not all(k in ev and np.isfinite(ev[k]) for k in names):
            raise AssertionError(f"evaluator: {ev}")
        rel = abs(ev["FID"] - fid_gen) / abs(fid_gen)
        if not rel <= FID_SAME_REL:
            raise AssertionError(f"evaluator FID {ev['FID']} against "
                                 f"generate_cifar10's {fid_gen}: {rel:.3e}")
        print(f"  F evaluator: {time.perf_counter() - t0:.1f} s; "
              + ", ".join(f"{k} {ev[k]}" for k in names)
              + f"; FID {ev['FID_route']} {ev['FID_seconds']:.3f} s, sFID "
              f"{ev['sFID_route']} {ev['sFID_seconds']:.3f} s; FID "
              f"{rel:.3e} from generate_cifar10's")
    if cuda:
        out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
        print(f"  F peak memory {out['peak_gib']:.2f} GiB")
    return out


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
    """T-K1: K1 at each shape E-int8, E2, E3, E5 and E4 launched it at
    (recorded into ``log`` by k1_shapes in those phases), held against its
    plain version under K's gate (``gn_silu`` or ``gn_silu_bf16``), with its
    time, its launches per trajectory or step, its route, its bound (one
    read and one write of x at HBM_BYTES_S) and the K1 time per trajectory
    or step that these give; returns the max abs errors by counter."""
    errs = {}
    if not log:
        print("  T-K1: no shapes recorded (E-int8, E2, E3, E5, E4 did not "
              "run)")
        return errs
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
                name = "gn_silu_bf16" if bf16 else "gn_silu"
                err = max_err(group_norm(*a).float(), gn_plain(*a).float(),
                              name)
                errs[name] = max(errs.get(name, 0.0), err)
                times[key] = time_ms(lambda: group_norm(*a)), err
                del a
            ms, err = times[key]
            bound = 2 * B * HW * C * (2 if bf16 else 4) / HBM_BYTES_S * 1e3
            r = route(HW, C, 32, dt)
            total += n / runs * ms
            lines.append(
                f"    ({B}, {HW}, {C}) {'bf16' if bf16 else 'fp32'} {mode}"
                f"{' +SiLU' if silu else ''}: max abs err vs plain "
                f"{err:.3e}; {n / runs:g} launches, "
                f"{'on-chip' if r.on_chip else 'split'} ({r.slabs} slabs, "
                f"clusters of {r.cluster}), {ms:.4f} ms each, bound "
                f"{bound:.4f} ms (bytes), {ms / bound:.2f}x it, "
                f"{n / runs * ms:.3f} ms a {unit}")
        print(f"  T-K1 {label}: {n_all:g} launches a {unit}, K1 "
              f"{total:.3f} ms a {unit} at these times")
        for line in lines:
            print(line)
    return errs


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


# ---- DDGAN: NCSN++ and DDGANSampler (configs/cifar10/T4_ddgan.yaml) -----

T4_DDGAN_CONFIG = os.path.join(REPO, "configs", "cifar10", "T4_ddgan.yaml")
DDGAN_GOLDEN = os.path.join(REPO, "tests", "torch_fixtures",
                            "ddgan_golden.npz")
DDGAN_TRAIN_GOLDEN = os.path.join(REPO, "tests", "torch_fixtures",
                                  "ddgan_train_golden.npz")
# the goldens' small NCSN++: every module kind of the full net (ResBlocks
# plain, down and up, attention at 8x8, the input pyramid, the z mapping) at
# widths K1 and K8 take on the card (C 32 to 128, a multiple of 32)
DDGAN_SMALL = dict(image_size=16, nf=32, ch_mult=(1, 2), num_res_blocks=1,
                   attn_resolutions=(8,), nz=16, z_emb_dim=32)
DDGAN_T, DDGAN_BATCH, DDGAN_SEED = 4, 4, 5
# E6's paths (NCSNpp options at NCSNppArgs' defaults: generate_cifar10
# --dtype fp32, the bf16 default, --int8) and their launches per forward.
# K1 at the 56 AdaGNs of the 28 ResBlocks, the 6 attention GroupNorms and
# norm_out (63): JAX divides each block's sum by the numpy scalar sqrt(2),
# which promotes bf16 to fp32, so in bf16 the residual stream is fp32 and
# only the 28 norm2s and the first block's norm1 see bf16 activations. K8
# at the 56 3x3 convs and the 19 1x1 shortcuts (75; the 24 attention 1x1s
# stay bf16 under quant_skip_attn, as the JAX entry keeps them).
DDGAN_PATHS = {"fp32": {}, "bf16": dict(dtype=torch.bfloat16),
               "int8": dict(dtype=torch.bfloat16, quant_int8="static",
                            quant_skip_attn=True)}
DDGAN_LAUNCHES_PER_FORWARD = {
    "fp32": {"gn_silu": 63},
    "bf16": {"gn_silu": 34, "gn_silu_bf16": 29},
    "int8": {"gn_silu": 34, "gn_silu_bf16": 29, "int8_conv": 75}}


def ddgan_small_state(seed=DDGAN_SEED):
    """numpy-made weights of the small NCSN++ (port names), so that the
    card rebuilds them without the golden storing them: kernels N(0,
    1/fan_in), conv2 and proj_out included (flax starts both at zero, which
    would hide every fault upstream of them in a residual branch), biases
    0.1 N(0, 1), GroupNorm scales 1 + 0.1 N(0, 1)."""
    rs = np.random.RandomState(seed)
    out = {}
    for k, v in NCSNpp(NCSNppArgs(**DDGAN_SMALL)).state_dict().items():
        shape = tuple(v.shape)
        if len(shape) == 1:  # a 1-D weight is a GroupNorm scale
            a = float(k.endswith(".weight")) + 0.1 * rs.randn(*shape)
        else:
            a = rs.randn(*shape) / np.sqrt(np.prod(shape[1:]))
        out[k] = torch.from_numpy(a.astype(np.float32))
    return out


def ddgan_draws(seed, n=DDGAN_BATCH, steps=DDGAN_T, shape=(3, 16, 16),
                nz=DDGAN_SMALL["nz"], rounds=None):
    """Injected draws from a numpy seed: x0 (n, *shape), z (steps, n, nz),
    eps (steps, n, *shape); with ``rounds`` each gains a leading rounds
    axis (calibration)."""
    rs = np.random.RandomState(seed)
    lead = () if rounds is None else (rounds,)
    x0 = rs.randn(*lead, n, *shape).astype(np.float32)
    z = rs.randn(*lead, steps, n, nz).astype(np.float32)
    eps = rs.randn(*lead, steps, n, *shape).astype(np.float32)
    return x0, z, eps


def ddgan_small_sampler(device, dtype=torch.float32, **net_kw):
    """The small NCSN++ (``ddgan_small_state``) in a T=4 DDGANSampler
    (fix_last, the schedule's initial sigmas), eval mode on ``device``;
    ``net_kw`` go to NCSNpp (quant_int8, quant_skip_attn)."""
    net = NCSNpp(NCSNppArgs(**DDGAN_SMALL), dtype=dtype, **net_kw)
    missing, unexpected = net.load_state_dict(ddgan_small_state(),
                                              strict=False)
    if unexpected or any(not k.endswith("act_scale") for k in missing):
        raise AssertionError(f"small NCSN++: missing {missing}, unexpected "
                             f"{unexpected}")
    sampler = DDGANSampler(net, DDGAN_T, (3, 16, 16))
    return sampler.to(device).eval()


DDGAN_FP32_TOL = (2e-5, 2e-5)  # the fp32 kernels' limit (TOL), per element


def _golden_draws(gold, device, rounds=None):
    seed = int(gold["seed"]) + (0 if rounds is None else 1)
    return [torch.from_numpy(a).to(device)
            for a in ddgan_draws(seed, rounds=rounds)]


def ddgan_small_replay(device):
    """G6's readings and gates on DDGAN_GOLDEN (the small NCSN++): (a) the
    fp32 trajectory with the golden's draws, each step mean within
    DDGAN_FP32_TOL of JAX's; (b) bf16, each step from JAX's bf16 state,
    within BF16_REPLAY_SHARE of JAX's own bf16 effect (mean and largest);
    (c) the fp32 net with static int8 everywhere calibrated on the
    golden's calibration draws, its scales within INT8_SCALE_REL of each
    buffer's largest where JAX's init scales do not win; (d) the bf16 net
    with static int8 and quant_skip_attn (``generate_cifar10 --int8``),
    calibrated the same way (its scales read against JAX's), then with
    JAX's scales loaded each step from JAX's int8 state under G-int8's
    gates. Returns the readings."""
    gold = dict(np.load(DDGAN_GOLDEN))
    x0, z, eps = _golden_draws(gold, device)
    cal = dict(zip(("x0", "z", "eps"), _golden_draws(gold, device, 2)))
    out = {}
    with torch.no_grad():
        d = ddgan_small_sampler(device).sample(DDGAN_BATCH, x0=x0, eps=eps,
                                               z=z)
        atol, rtol = DDGAN_FP32_TOL
        ref = torch.from_numpy(gold["fp32/means"]).to(device)
        err = (d["mean"] - ref).abs()
        if not (err <= atol + rtol * ref.abs()).all():
            raise AssertionError(f"DDGAN fp32 step means {err.max():.3e} "
                                 "from JAX's")
        out["fp32"] = float(err.max())

        s16 = ddgan_small_sampler(device, torch.bfloat16)
        worst = [0.0, 0.0]
        for t in range(DDGAN_T):
            x = torch.from_numpy(gold["bf16/l_sample"][t]).to(device)
            mean = s16.sample_step(x, t, eps[t], z=z[t])["mean"]
            err = np.abs(mean.cpu().numpy() - gold["bf16/means"][t])
            eff = np.abs(gold["bf16/means"][t] - gold["bf16/means_fp32"][t])
            ratios = (err.mean() / eff.mean(), err.max() / eff.max())
            worst = [max(a, float(b)) for a, b in zip(worst, ratios)]
        if max(worst) > BF16_REPLAY_SHARE:
            raise AssertionError(f"DDGAN bf16 steps {worst} times JAX's own "
                                 f"bf16 effect (tol {BF16_REPLAY_SHARE:g})")
        out["bf16"] = worst

    s8 = ddgan_small_sampler(device, quant_int8="static")
    s8.calibrate_quant(n_sample=DDGAN_BATCH, n_rounds=2, **cal)
    state = s8.net.state_dict()
    n_won, n_all, worst = 0, 0, 0.0
    for key in (k for k in gold if k.startswith("calib32/scale/")):
        name = key[len("calib32/scale/"):]
        want = torch.from_numpy(gold[key])
        keep = ~(torch.from_numpy(gold[f"calib32/init/{name}"]) > want)
        n_won += int((~keep).sum())
        n_all += want.numel()
        rel = float(((state[name].cpu() - want).abs() * keep).max()
                    / want.abs().max())
        worst = max(worst, rel)
    if not worst <= INT8_SCALE_REL:
        raise AssertionError(f"DDGAN fp32 calibration {worst:.3e} from JAX's"
                             f" (tol {INT8_SCALE_REL:g})")
    out["calib32"] = (worst, n_won, n_all)
    load_ddgan_scales(s8.net, gold, "calib32")
    steps = _int8_steps(s8, gold, "int832", eps, z)
    if device == "cpu":
        out["int832"] = check_int8_replay(steps)
    else:
        # the card's fp32 convs and products round otherwise than the CPU's,
        # which flips int8 roundings in this small net, the kernels' plain
        # versions alike: against JAX the mean gate, and the kernels against
        # their plain versions on the card under both
        worst = max(r for r, _, _ in steps)
        if not worst <= INT8_STEP_RATIO:
            raise AssertionError(f"DDGAN fp32 int8 steps {worst:.3f} of the "
                                 "int8 effect from JAX's")
        fp = ddgan_small_sampler(device)
        states = [torch.from_numpy(a).to(device)
                  for a in gold["int832/l_sample"][:DDGAN_T]]
        out["int832"] = (worst, check_int8_replay(
            int8_against_plain(s8, fp, states, eps, z)))

    s8 = ddgan_small_sampler(device, torch.bfloat16, quant_int8="static",
                             quant_skip_attn=True)
    s8.calibrate_quant(n_sample=DDGAN_BATCH, n_rounds=2, **cal)
    state = {k: v.clone() for k, v in s8.net.state_dict().items()}
    scales = load_ddgan_scales(s8.net, gold, "int8")
    out["calib_bf16"] = max(float((state[k].cpu() - v).abs().max()
                                  / v.abs().max()) for k, v in scales.items())
    worst = [0.0, 0.0]
    with torch.no_grad():
        for t in range(DDGAN_T):
            x = torch.from_numpy(gold["int8/l_sample"][t]).to(device)
            mean = s8.sample_step(x, t, eps[t], z=z[t])["mean"].cpu().numpy()
            ref, ref32 = gold["int8/means"][t], gold["int8/means_fp32"][t]
            noise = np.abs(ref - ref32).mean()
            ratios = (np.abs(mean - ref).mean() / noise,
                      np.abs(mean - ref32).mean() / noise)
            worst = [max(a, float(b)) for a, b in zip(worst, ratios)]
    if worst[0] > INT8_BF16_SHARE or worst[1] > INT8_FP32_SHARE:
        raise AssertionError(f"DDGAN bf16 int8 steps {worst} times JAX's "
                             f"own bf16 effect under int8 (tol "
                             f"{INT8_BF16_SHARE:g}, {INT8_FP32_SHARE:g})")
    out["int8_bf16"] = worst
    return out


# a bf16 int8 net: every rounding flip of bf16 can cross an int8 boundary,
# so it is read as tests/test_torch_unet_small_int8.py reads its bf16 int8
# nets, against JAX's own bf16 effect under int8 (its bf16 int8 step mean
# against its fp32 int8 one with the same scales, from the same state):
# within twice that of JAX's bf16 int8 mean, 1.5 times of its fp32 one
INT8_BF16_SHARE, INT8_FP32_SHARE = 2.0, 1.5


def load_ddgan_scales(net, gold, tag):
    """Load the golden's ``{tag}/scale/*`` into ``net``'s scale buffers
    (they must cover every one) and quantise its weights; returns them."""
    scales = {k[len(tag) + 7:]: torch.from_numpy(v)
              for k, v in gold.items() if k.startswith(f"{tag}/scale/")}
    if set(scales) != {k for k in net.state_dict() if k.endswith("act_scale")}:
        raise AssertionError(f"DDGAN {tag}: the golden's scales and the "
                             "net's buffers differ")
    net.load_state_dict(scales, strict=False)
    net.prepare_int8()
    return scales


def int8_against_plain(sampler, fp_sampler, states, eps, z):
    """``replay_int8``'s per-step readings of an int8 sampler's kernels
    against their plain versions on the same ``states``: the error over
    the int8 effect, |plain full precision - plain int8| (``fp_sampler``
    without int8, same weights)."""
    steps = []
    with torch.no_grad():
        for t, x in enumerate(states):
            mean = sampler.sample_step(x, t, eps[t], z=z[t])["mean"]
            with plain_kernels():
                ref = sampler.sample_step(x, t, eps[t], z=z[t])["mean"]
                fp = fp_sampler.sample_step(x, t, eps[t], z=z[t])["mean"]
            err, eff = (mean - ref).abs().cpu(), (fp - ref).abs().cpu()
            steps.append((float(err.mean() / eff.mean()),
                          float(err.median() / eff.median()),
                          float(err.max())))
    return steps


def _int8_steps(sampler, gold, tag, eps, z):
    """``replay_int8``'s per-step readings on the golden's ``tag``
    trajectory: each step from JAX's state, against the int8 effect
    |JAX full-precision - JAX int8| at that state."""
    steps = []
    with torch.no_grad():
        for t in range(DDGAN_T):
            x = torch.from_numpy(gold[f"{tag}/l_sample"][t]).to(
                eps.device)
            mean = sampler.sample_step(x, t, eps[t], z=z[t])["mean"]
            ref = gold[f"{tag}/means"][t]
            err = np.abs(mean.cpu().numpy() - ref)
            effect = np.abs(gold[f"{tag}/means_fp"][t] - ref)
            steps.append((float(err.mean() / effect.mean()),
                          float(np.median(err) / np.median(effect)),
                          float(err.max())))
    return steps


# G7: one DxMITrainer iteration of T4_ddgan.yaml's trainer (value_resample)
# on the small NCSN++ and a small IGEBM value (nh 16), both numpy-made
DDGAN_VALUE_NH = 16


def small_value(cfg, seed=DDGAN_SEED + 2):
    """``cfg``'s value net at width DDGAN_VALUE_NH with numpy-made weights
    (kernels N(0, 1/fan_in), biases 0.1 N(0, 1)), on the CPU."""
    vcfg = {**cfg["value"], "net": {**cfg["value"]["net"],
                                    "nh": DDGAN_VALUE_NH}}
    value = instantiate(vcfg)
    rs = np.random.RandomState(seed)
    state = {}
    for k, v in value.state_dict().items():
        shape = tuple(v.shape)
        a = (0.1 * rs.randn(*shape) if len(shape) == 1
             else rs.randn(*shape) / np.sqrt(np.prod(shape[1:])))
        state[k] = torch.from_numpy(a.astype(np.float32))
    value.load_state_dict(state)
    return value


def dxmi_train_replay(sampler, value, cfg, golden, device):
    """One DxMITrainer iteration of ``cfg``'s trainer (value_resample on)
    with the case, data, trajectory and draws of ``golden``: update_f_v
    with the golden's resample draws (``resample/noise``, ``resample/z``
    where the sampler has latents, in sweep order), then update_sampler with
    its permutation, noise and z. Returns the arrays the golden keeps,
    computed the same way."""
    tcfg = {k: v for k, v in cfg["trainer"].items() if k != "_target_"}
    trainer = DxMITrainer(**{**tcfg, "batchsize": int(golden["case/batchsize"]),
                             "n_timesteps": sampler.n_timesteps})
    trainer.set_models(sampler, value, lr=float(golden["case/lr"]),
                       v_lr=float(golden["case/v_lr"]),
                       beta_lr=float(golden["case/beta_lr"]))

    def t(name):
        return torch.from_numpy(np.asarray(golden[name])).to(device)

    l_sample = t("l_sample")
    buf = from_d_sample({"l_sample": l_sample,
                         "mean": torch.zeros_like(l_sample[1:]),
                         "sigma": t("sigma"), "logp": t("logp"),
                         "entropy": t("entropy")})
    latents = "z" in golden
    noise = t("resample/noise")
    zs = t("resample/z") if latents else [None] * len(noise)
    resample = [{"noise": n, **({} if z is None else {"z": z})}
                for n, z in zip(noise, zs)]

    def params():
        return {k: v.detach().double().cpu().clone() for k, v in
                [*value.state_dict().items(),
                 *(("s:net." + k, v)
                   for k, v in sampler.net.state_dict().items())]}

    before = params()
    m = trainer.update_f_v(t("img"), buf, resample=resample)
    m.update(trainer.update_sampler(buf, perm=t("perm"),
                                    noise=list(t("noise")),
                                    z=list(t("z")) if latents else None))
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


def ddgan_train_replay(device):
    """G7's port side: the small NCSN++ sampler and value on ``device``,
    one iteration against DDGAN_TRAIN_GOLDEN; returns (port arrays,
    golden)."""
    golden = dict(np.load(DDGAN_TRAIN_GOLDEN))
    cfg = load_yaml(T4_DDGAN_CONFIG)
    sampler = ddgan_small_sampler(device)
    value = small_value(cfg).to(device)
    return dxmi_train_replay(sampler, value, cfg, golden, device), golden


# ---- DDGAN on the card: K1 and K8 at NCSN++'s shapes, G6, G7, E6, E7 -----

@contextlib.contextmanager
def _patched(mod, name, fn):
    old = getattr(mod, name)
    setattr(mod, name, fn)
    try:
        yield
    finally:
        setattr(mod, name, old)


def ddgan_shape_counts(path, batch=1):
    """K1's and K8's launches by shape in one forward of the full-width
    NCSN++ on ``path`` (DDGAN_PATHS), read on the meta device with the
    wrappers replaced by recorders: {("gn", HW, C, bf16): n, ("k8", H, W,
    Cin, Cout, k, x_bf16): n}."""
    from dxmi_tpu_torch.models import ncsnpp as ncsnpp_mod
    from dxmi_tpu_torch.ops import quant as quant_mod
    counts = collections.Counter()

    def gn(x, scale, bias, G, eps, silu, stats="fp32"):
        B, C = x.shape[0], x.shape[-1]
        counts[("gn", x.numel() // (B * C), C, x.dtype == torch.bfloat16)] += 1
        return torch.empty_like(x)

    def k8(x, q, bias, padding, out_dtype, stride=1):
        B, H, W, Cin = x.shape
        counts[("k8", H, W, Cin, q.w_i8.shape[0], q.w_i8.shape[1],
                x.dtype == torch.bfloat16)] += 1
        return torch.empty(B, H, W, q.w_i8.shape[0], dtype=out_dtype,
                           device=x.device)

    with torch.device("meta"):
        net = NCSNpp(**DDGAN_PATHS[path])
    with _patched(ncsnpp_mod, "group_norm", gn), \
            _patched(quant_mod, "int8_conv_apply", k8), torch.no_grad():
        net(torch.empty(batch, 3, 32, 32, device="meta"),
            torch.empty(batch, device="meta"),
            torch.empty(batch, 100, device="meta"))
    return counts


def launches_of(counts):
    """The launches per forward by counter name of ``ddgan_shape_counts``."""
    out = collections.Counter()
    for key, n in counts.items():
        out["int8_conv" if key[0] == "k8" else
            "gn_silu_bf16" if key[3] else "gn_silu"] += n
    return dict(out)


def ncsnpp_gn_case(gen, B, HW, C, bf16):
    """K1's arguments at an NCSN++ GroupNorm: min(C // 4, 32) groups, eps
    1e-6, SiLU off, fp32 statistics, a random affine."""
    return (randn(gen, B, HW, C, scale=2.0, shift=0.5).to(
                torch.bfloat16 if bf16 else torch.float32),
            randn(gen, C, scale=0.1, shift=1.0), randn(gen, C, scale=0.1),
            max(min(C // 4, 32), 1), 1e-6, False, "fp32")


def ncsnpp_k8_case(gen, B, H, Cin, Cout, k, bf16):
    """K8's arguments at an NCSN++ int8 conv (stride 1, SAME, x in the
    dtype the net gives it, calibrated per-channel scales, bf16 out)."""
    pad = SAME_3X3 if k == 3 else ((0, 0), (0, 0))
    x, q, b, _, _, _ = conv_i8_case(
        gen, B, H, Cin, Cout, pad, torch.bfloat16 if bf16 else torch.float32,
        False, k=k)
    return x, q, b, pad, torch.bfloat16


def phase_kernels_ddgan(gen, errs):
    """K1 at every GroupNorm shape of the full-width NCSN++ (fp32 and bf16
    torsos) at batch 100 and 128, and K8 at every int8 conv shape of the
    --int8 torso at batch 100, each against its plain version (K1 under
    TOL, K8 exact) and replayed bit-equal, with K1's route."""
    gn_keys = sorted({k for p in DDGAN_PATHS for k in ddgan_shape_counts(p)
                      if k[0] == "gn"})
    k8_keys = sorted(k for k in ddgan_shape_counts("int8") if k[0] == "k8")
    for name in ("gn_silu_ncsnpp", "gn_silu_bf16_ncsnpp", "int8_conv_ncsnpp"):
        errs[name] = 0.0
    for B in (BATCH, E4_BATCH):
        for _, HW, C, bf16 in gn_keys:
            a = ncsnpp_gn_case(gen, B, HW, C, bf16)
            name = "gn_silu_bf16" if bf16 else "gn_silu"
            out = group_norm(*a)
            err = max_err(out.float(), group_norm_silu_reference(*a).float(),
                          name)
            if not torch.equal(out, group_norm(*a)):
                raise AssertionError(f"{name} NCSN++ {(B, HW, C)}: a replay "
                                     "differs")
            errs[f"{name}_ncsnpp"] = max(errs[f"{name}_ncsnpp"], err)
            r = route(HW, C, a[3], a[0].dtype)
            print(f"  K {name} NCSN++ {(B, HW, C)} G {a[3]}: max abs err "
                  f"{err:.3e}; {'on-chip' if r.on_chip else 'split'} "
                  f"({r.slabs} slabs, clusters of {r.cluster}); replay "
                  "bit-equal")
            del a, out
    for _, H, W, Cin, Cout, k, bf16 in k8_keys:
        x, q, b, pad, dt = ncsnpp_k8_case(gen, BATCH, H, Cin, Cout, k, bf16)
        out = int8_conv_apply(x, q, b, pad, dt)
        err = (out.float() - int8_conv_reference(x, q, b, pad, dt).float()
               ).abs().max().item()
        what = (f"int8_conv NCSN++ {(BATCH, H, Cin, Cout)} {k}x{k} "
                f"{'bf16' if bf16 else 'fp32'} x")
        if err != 0:
            raise AssertionError(f"{what}: max abs err {err}")
        if not torch.equal(out, int8_conv_apply(x, q, b, pad, dt)):
            raise AssertionError(f"{what}: a replay differs")
        print(f"  K {what}: max abs err {err:g} (must be 0); replay "
              "bit-equal")
        del x, out


def ddgan_time_rows(gen):
    """T rows of K1 (fp32 and bf16) and K8 at their most launched NCSN++
    shapes, beside the plain version and the library call (F.group_norm;
    torch._int_mm on the im2col matrix)."""
    rows = {}
    for path, bf16 in (("fp32", False), ("bf16", True)):
        counts = ddgan_shape_counts(path)
        _, HW, C, _ = max((k for k in counts if k[0] == "gn"
                           and k[3] == bf16),
                          key=lambda k: (counts[k], k[1] * k[2]))
        a = ncsnpp_gn_case(gen, BATCH, HW, C, bf16)
        R = int(round(HW ** 0.5))
        x_nchw = a[0].reshape(BATCH, R, R, C).permute(0, 3, 1, 2)
        s, b = (t.to(a[0].dtype) for t in a[1:3])
        n = BATCH * HW * C
        rows[f"gn_silu{'_bf16' if bf16 else ''}_ncsnpp"] = dict(
            shape=(BATCH, HW, C),
            ms=time_ms(lambda: group_norm(*a)),
            plain_ms=time_ms(lambda: group_norm_silu_reference(*a)),
            library_ms=time_ms(lambda: F.group_norm(x_nchw, a[3], s, b,
                                                    1e-6)),
            bytes=2 * n * a[0].element_size() + 2 * C * 4,
            ops={"fp32": 7 * n})
        del a, x_nchw
    counts = ddgan_shape_counts("int8")
    _, H, W, Cin, Cout, k, bf16 = max(
        (k for k in counts if k[0] == "k8"),
        key=lambda k: (counts[k], k[1] * k[3] * k[4] * k[5] ** 2))
    x, q, b, pad, dt = ncsnpp_k8_case(gen, BATCH, H, Cin, Cout, k, bf16)
    nbytes, ops = k8_work(BATCH, H, W, Cin, Cout, k, k, H, W,
                          x.element_size(), 2)
    rows["int8_conv_ncsnpp"] = dict(
        shape=(BATCH, H, W, Cin, Cout, k),
        ms=time_ms(lambda: int8_conv_apply(x, q, b, pad, dt)),
        plain_ms=time_ms(lambda: int8_conv_reference(x, q, b, pad, dt),
                         iters=3, warmup=1),
        library_ms=time_ms(k8_library(x, q, pad)), bytes=nbytes, ops=ops)
    return rows


def phase_replay_ddgan():
    """G6: ``ddgan_small_replay`` on the card (K1 fp32 and bf16, K8 at the
    small net's shapes), each path's kernels counted."""
    _lib.reset_launches()
    out = ddgan_small_replay("cuda")
    used = {k for k, v in _lib.LAUNCHES.items() if v}
    if used != {"gn_silu", "gn_silu_bf16", "int8_conv"}:
        raise AssertionError(f"G6: launched {sorted(used)}")
    worst, n_won, n_all = out["calib32"]
    print(f"  G6 fp32: step means within {out['fp32']:.3e} of JAX's (tol "
          f"{DDGAN_FP32_TOL[0]:g} + {DDGAN_FP32_TOL[1]:g}*|JAX|); bf16: worst "
          f"step {out['bf16'][0]:.3f} (mean) and {out['bf16'][1]:.3f} "
          f"(largest) of JAX's own bf16 effect (tol {BF16_REPLAY_SHARE:g})")
    print(f"  G6 int8: fp32 calibration {worst:.3e} of each buffer's largest "
          f"from JAX's (tol {INT8_SCALE_REL:g}; {n_won} of {n_all} channels "
          f"where JAX's init scales win left out); fp32 int8 steps' mean "
          f"error {out['int832'][0]:.3f} of the int8 effect from JAX's (tol "
          f"{INT8_STEP_RATIO:g}), the kernels against their plain versions "
          f"{out['int832'][1][0]:.3f} (mean) and {out['int832'][1][1]:.3f} "
          f"(median; tol {INT8_STEP_RATIO:g}, {INT8_MEDIAN_RATIO:g}); "
          f"bf16 --int8 steps {out['int8_bf16'][0]:.3f} "
          f"and {out['int8_bf16'][1]:.3f} of JAX's own bf16 effect under int8 "
          f"(tol {INT8_BF16_SHARE:g}, {INT8_FP32_SHARE:g}); bf16 calibration "
          f"{out['calib_bf16']:.3e} from JAX's (read, no gate); kernels "
          f"{dict(_lib.LAUNCHES)}")
    return out


# G7's updates on the card: the small IGEBM value's fp32 convs run on
# cuDNN, whose algorithms round otherwise than the CPU's (and its backward
# need not repeat itself bit for bit), and Adam's first steps turn that into
# sign flips of near-zero gradient elements, in the value update and,
# through the value, in the sampler's: against JAX's, 5.4e-3 and 6.0e-3
# relative in the value update, K1 and its plain version alike (5e-6 on
# the CPU); the kernels against their plain versions, 3.1e-4 in one run and
# 3.1e-3 in another (an H100 80GB HBM3 at 700 W, PERF.md). So on the card
# the metrics are held to JAX's and to the plain versions' (G3_METRIC_REL)
# and the updates read; tests/test_torch_ddgan_train.py holds the updates
# on the CPU under G4's limits.


def phase_train_replay_ddgan():
    """G7: one value_resample iteration against DDGAN_TRAIN_GOLDEN on the
    card (K1 in every forward of the small NCSN++), and the same iteration
    with K1's plain version: the metrics held to both, the updates read
    (see above)."""
    with plain_kernels():
        plain, _ = ddgan_train_replay("cuda")
    _lib.reset_launches()
    port, golden = ddgan_train_replay("cuda")
    used = {k for k, v in _lib.LAUNCHES.items() if v}
    if used != {"gn_silu"}:
        raise AssertionError(f"G7: launched {sorted(used)}")
    m, v, sh = train_golden_check(port, golden, "G7", gate_updates=False)
    km, kv, ksh = train_golden_check(port, plain, "G7 kernels against plain",
                                     gate_updates=False)
    print(f"  G7 against its plain version on the card: metrics within "
          f"{km:.3e} (tol {G3_METRIC_REL:g}); read, not gated: value update "
          f"{kv:.3e}, sampler updates at {ksh:.3f} of G4's limit")
    print(f"  G7: metrics within {m:.3e} (tol {G3_METRIC_REL:g}); read, "
          f"not gated: value update {v:.3e} from JAX's, sampler updates at "
          f"{sh:.3f} of G4's limit; d_loss "
          f"{float(port['metric/ebm/d_loss_']):.5f}, running_cost "
          f"{float(port['metric/ebm/running_cost_']):.5f}, sampler_loss "
          f"{float(port['metric/sampler/sampler_loss_']):.5f}; kernels "
          f"{dict(_lib.LAUNCHES)}")
    return m


def t4_ddgan_config():
    """configs/cifar10/T4_ddgan.yaml with its dataset config merged."""
    return merge(load_yaml(T4_DDGAN_CONFIG), load_yaml(os.path.join(
        REPO, "configs", "cifar10", "cifar10.yaml")))


def plain_kernels():
    """The NCSN++ path with K1's and K8's plain versions on the card (each
    takes its wrapper's arguments)."""
    from dxmi_tpu_torch.models import ncsnpp as ncsnpp_mod
    from dxmi_tpu_torch.ops import quant as quant_mod
    stack = contextlib.ExitStack()
    stack.enter_context(_patched(ncsnpp_mod, "group_norm",
                                 group_norm_silu_reference))
    stack.enter_context(_patched(quant_mod, "int8_conv_apply",
                                 int8_conv_reference))
    return stack


def e6_plain_check(path, sampler, fp_sampler):
    """Each of the T steps from the kernels' state of one trajectory of
    100, the kernels against their plain versions on the same state and
    draws: fp32 per element within DDGAN_FP32_TOL; bf16 and --int8 (a bf16
    torso) the G-bf16 rule against the bf16 effect, the plain step's
    distance from the plain fp32 step (for --int8 the fp32 net with the
    same int8 layers and scales): K1 bf16 rounds once where its plain
    version rounds too, and under int8 each such flip can cross an int8
    boundary. Returns the readings."""
    x, z, eps = (torch.from_numpy(a).cuda() for a in ddgan_draws(
        11, BATCH, DDGAN_T, (3, 32, 32), 100))
    states = [x]
    with torch.no_grad():
        for t in range(DDGAN_T - 1):
            states.append(sampler.sample_step(states[-1], t, eps[t],
                                              z=z[t])["sample"])
    worst = [0.0, 0.0]
    with torch.no_grad():
        for t, x in enumerate(states):
            mean = sampler.sample_step(x, t, eps[t], z=z[t])["mean"]
            with plain_kernels():
                ref = sampler.sample_step(x, t, eps[t], z=z[t])["mean"]
                if path != "fp32":
                    fp = fp_sampler.sample_step(x, t, eps[t], z=z[t])["mean"]
            err = (mean - ref).abs()
            if path == "fp32":
                atol, rtol = DDGAN_FP32_TOL
                if not (err <= atol + rtol * ref.abs()).all():
                    raise AssertionError(f"E6 fp32 step {t}: {err.max():.3e} "
                                         "from the plain versions")
                worst[0] = max(worst[0], err.max().item())
            else:
                eff = (ref - fp).abs()
                worst = [max(worst[0], (err.mean() / eff.mean()).item()),
                         max(worst[1], (err.max() / eff.max()).item())]
    if path != "fp32" and max(worst) > BF16_REPLAY_SHARE:
        raise AssertionError(f"E6 {path}: {worst} of the bf16 effect from "
                             "the plain versions")
    return worst


def phase_generate_ddgan(k1_log, rates):
    """E6: generate_cifar10's DDGAN paths at NCSNppArgs' full width with
    weights drawn from seed 0: fp32 (--dtype fp32), bf16 (the default) and
    --int8 (bf16, attention 1x1s in bf16, calibrated on 2 x 64). Each: the
    launches of calibration and of N_BATCHES trajectories of BATCH (K1's
    shapes for T-K1) against DDGAN_LAUNCHES_PER_FORWARD, img/s of sampling
    alone, a profiled trajectory (device time, idle share, K1's and K8's
    shares), K8's time by shape (int8), and every step of one trajectory
    against the plain versions (``e6_plain_check``). Returns the launches
    of each path."""
    cfg = t4_ddgan_config()
    T4 = cfg["sampler"]["n_timesteps"]
    out, fp32_sampler = {}, None
    for path in DDGAN_PATHS:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        _lib.reset_launches()
        t0 = time.perf_counter()
        sampler = load_sampler(cfg, None, "cuda", 0, int8=path == "int8",
                               dtype="fp32" if path == "fp32" else "bf16")
        torch.cuda.synchronize()
        setup = time.perf_counter() - t0
        calib = dict(_lib.LAUNCHES)
        per = DDGAN_LAUNCHES_PER_FORWARD[path]
        want_calib = ({k: v * T4 * generate_cifar10.CALIB_N_ROUNDS
                       for k, v in per.items() if k != "int8_conv"}
                      if path == "int8" else {})
        if calib != want_calib:
            raise AssertionError(f"E6 {path}: calibration launches {calib}, "
                                 f"expected {want_calib}")
        sample_batches(sampler, BATCH, BATCH, 1)
        torch.cuda.synchronize()
        _lib.reset_launches()
        t0 = time.perf_counter()
        with k1_shapes(k1_log, f"E6 {path}", N_BATCHES,
                       f"trajectory of {BATCH}"):
            x = sample_batches(sampler, N_BATCHES * BATCH, BATCH, 0)
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = dict(_lib.LAUNCHES)
        want = {k: v * T4 * N_BATCHES for k, v in per.items()}
        if got != want:
            raise AssertionError(f"E6 {path}: launches {got}, expected "
                                 f"{want}")
        if tuple(x.shape) != (N_BATCHES * BATCH, 3, 32, 32) or \
                not torch.isfinite(x).all() or x.abs().max() > 1.5:
            raise AssertionError(f"E6 {path}: samples {tuple(x.shape)} in "
                                 f"[{x.min():.3f}, {x.max():.3f}]")
        peak = torch.cuda.max_memory_allocated()
        t0 = time.perf_counter()
        sample_batches(sampler, N_BATCHES * BATCH, BATCH, 3)
        torch.cuda.synchronize()
        sampling = time.perf_counter() - t0
        rates[f"E6 {path}"] = N_BATCHES * BATCH / sampling
        print(f"  E6 {path}: load{' + calibration' if path == 'int8' else ''}"
              f" {setup:.3f} s (launches {calib}); {N_BATCHES} x {BATCH} "
              f"samples in {wall:.3f} s, launches {got} = "
              f"{ {k: v for k, v in per.items()} } a forward x {T4} steps x "
              f"{N_BATCHES}; sampling alone {sampling:.3f} s, "
              f"{rates[f'E6 {path}']:.2f} img/s, "
              f"{sampling / N_BATCHES * 1e3:.1f} ms a trajectory (host); "
              f"samples in [{x.min().item():.3f}, {x.max().item():.3f}], std "
              f"{x.std().item():.3f}; peak allocated {peak / 2**20:.1f} MiB",
              flush=True)
        profile_run(lambda: sample_batches(sampler, BATCH, BATCH, 4),
                    f"E6 {path} profile, one trajectory of {BATCH}", top=10,
                    shares={"K1": ("gn_kernel", "gn_apply_kernel"),
                            "K8": ("int8_conv_kernel",)})
        if path == "int8":
            k8_shape_times(lambda: sample_batches(sampler, BATCH, BATCH, 5),
                           f"E6 {path}, batch {BATCH},", library=True)
        if path == "fp32":
            fp32_sampler = sampler
        reading = e6_plain_check(path, sampler,
                                 e6_reference(path, sampler, fp32_sampler))
        print(f"  E6 {path}: kernels against their plain versions, each step "
              f"of a trajectory from the kernels' state: {reading}", flush=True)
        out[path] = got
    return out


def e6_reference(path, sampler, fp32_sampler):
    """The reference of ``e6_plain_check``'s effect: none for fp32; for
    bf16 the fp32 sampler (same weights); for int8 the fp32 net with the
    int8 sampler's weights, int8 layers and scales."""
    if path != "int8":
        return None if path == "fp32" else fp32_sampler
    ref = DDGANSampler(NCSNpp(quant_int8="static", quant_skip_attn=True),
                       DDGAN_T, (3, 32, 32))
    ref.load_state_dict(sampler.state_dict())
    ref.cuda().eval()
    ref.net.prepare_int8()
    return ref


# E7: train_cifar10 on T4_ddgan.yaml at full width (fp32, batch 128 sampled
# in 4 chunks of 32, value_resample on), weights drawn from the seed (the
# pretrained file stays off the card). A step: 4 chunks x T sampling
# forwards, T resampled policy steps in update_f_v (batch 128, no
# gradient), one training forward of 128 in update_sampler (its backward
# differentiates K1's plain version and launches nothing): 21 forwards of
# 63 K1 launches.
E7_STEPS = 3


def phase_ddgan_train(k1_log):
    """E7 (see above): 3 steps, each one's launches and finite metrics
    checked; s/step over steps 1-2 with its phase split, peak memory, a
    profiled step's device time and idle share."""
    cfg = t4_ddgan_config()
    seed = int(cfg["training"]["seed"])
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    sampler, _, trainer = train_cifar10.build(cfg, torch.device("cuda"), seed)
    T4 = sampler.n_timesteps
    forwards = T4 * trainer.sample_chunks + T4 + 1
    want = {"gn_silu": DDGAN_LAUNCHES_PER_FORWARD["fp32"]["gn_silu"]
            * forwards}
    loader = EpochLoader(fake_cifar(1024, seed), trainer.batchsize, seed)
    batches = loader.epoch(0)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    steps = []
    for i in range(E7_STEPS):
        x = train_cifar10.to_device_batch(next(batches)[0], "cuda")
        _lib.reset_launches()
        t0 = time.perf_counter()
        with (k1_shapes(k1_log, "E7", 1, "step") if i == 0
              else contextlib.nullcontext()):
            m = train_step(trainer, x, None, gen, n_generator=1)
        wall = time.perf_counter() - t0
        got = dict(_lib.LAUNCHES)
        if got != want:
            raise AssertionError(f"E7 step {i}: launches {got}, expected "
                                 f"{want}")
        bad = [k for k, v in m.items() if not k.startswith("time/")
               and not torch.isfinite(torch.as_tensor(v)).all()]
        if bad:
            raise AssertionError(f"E7 step {i}: non-finite {bad}")
        steps.append((wall, m))
        print(f"  E7 step {i}: {wall:.3f} s (sample {m['time/sample']:.3f}, "
              f"update_f_v {m['time/update_f_v']:.3f}, update_sampler "
              f"{m['time/update_sampler']:.3f}); d_loss "
              f"{float(m['ebm/d_loss_']):.4f}, running_cost "
              f"{float(m['ebm/running_cost_']):.4f}, sampler_loss "
              f"{float(m['sampler/sampler_loss_']):.4f}", flush=True)
    peak = torch.cuda.max_memory_allocated()
    later = [w for w, _ in steps[1:]]
    phases = {k: np.mean([mm[f"time/{k}"] for _, mm in steps[1:]])
              for k in ("sample", "update_f_v", "update_sampler")}
    print(f"  E7: {sum(p.numel() for p in sampler.net.parameters())} sampler "
          f"parameters, batch {trainer.batchsize} in {trainer.sample_chunks} "
          f"sampling chunks, value_resample {trainer.value_resample}; "
          f"{np.mean(later):.3f} s/step over steps 1-{E7_STEPS - 1} (sample "
          f"{phases['sample']:.3f}, update_f_v {phases['update_f_v']:.3f}, "
          f"update_sampler {phases['update_sampler']:.3f}); K1 launches per "
          f"step {want['gn_silu']} ({forwards} forwards of 63); peak "
          f"allocated {peak / 2**30:.2f} GiB",
          flush=True)
    x = train_cifar10.to_device_batch(next(batches)[0], "cuda")
    profile_run(lambda: train_step(trainer, x, None, gen, n_generator=1),
                "E7 profile, one training step", top=10,
                shares={"K1": ("gn_kernel", "gn_apply_kernel")})
    return want


# the DDGAN CLIs at a small width (nf 32, mult (1, 2), one res block,
# attention at 16x16, value nh 16, batch 8)
SHRUNK_DDGAN_ARGS = [
    "--sampler_net.config.nf", "32", "--sampler_net.config.ch_mult", "[1,2]",
    "--sampler_net.config.num_res_blocks", "1",
    "--sampler_net.config.attn_resolutions", "[16]", "--value.net.nh", "16",
    "--training.batchsize", "8", "--training.log_every", "1",
    "--training.fid_epoch", "None"]


def ddgan_train_cli(out_dir):
    """train_cifar10 on T4_ddgan.yaml (2 steps) in a subprocess, then
    generate_cifar10 (its bf16 default) on the run dir it wrote; the npz
    within one uint8 level of the in-process samples of the same seed."""
    run = "chip_smoke_ddgan"
    log_dir = os.path.join(out_dir, "results", "cifar10", "T4_ddgan", run)
    npz = os.path.join(log_dir, "samples.npz")
    train = [sys.executable, "-m", "dxmi_tpu_torch.train_cifar10",
             "--config", T4_DDGAN_CONFIG, "--dataset",
             os.path.join(REPO, "configs", "cifar10", "cifar10.yaml"),
             "--run", run, "--fake_data", "--max_steps", "2",
             *SHRUNK_DDGAN_ARGS]
    gen = [sys.executable, "-m", "dxmi_tpu_torch.generate_cifar10",
           "--log_dir", log_dir, "--sampler", "last", "--n_generate", "8",
           "--batchsize", "8", "--save_npz", npz]
    for cmd in (train, gen):
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, cwd=out_dir, capture_output=True,
                              text=True, timeout=300,
                              env=dict(os.environ, PYTHONPATH=REPO))
        if proc.returncode != 0:
            raise AssertionError(f"{' '.join(cmd[2:4])} failed:\n"
                                 f"{proc.stdout[-3000:]}{proc.stderr[-3000:]}")
        lines = proc.stdout.strip().splitlines()
        print(f"  C {cmd[2]} (DDGAN): {time.perf_counter() - t0:.1f} s; "
              f"{' | '.join(l for l in lines if l.startswith('iter'))} "
              f"{' | '.join(lines[-2:])}")
    got = np.load(npz)["arr_0"]
    cfg = load_yaml(os.path.join(log_dir, "config.yaml"))
    state = load_sampler_state(os.path.join(log_dir, "sampler_last.pth"))
    want = to_uint8(generate(cfg, state, 8, 8, "cuda"))
    diff = int(np.abs(got.astype(np.int16) - want).max())
    if got.shape != want.shape or diff > 1:
        raise AssertionError(f"generate_cifar10 on the DDGAN run dir: npz "
                             f"{got.shape} {diff} uint8 levels from the "
                             "in-process samples")
    print(f"  C generate_cifar10 (DDGAN run dir, bf16 default): npz "
          f"{got.shape} within {diff} uint8 level of in-process")


# ---- LSUN-Bedroom 256 at T=4: K1's split route, K2, K4, K5, K8 ---------

LSUN_T4_CONFIG = os.path.join(REPO, "configs", "lsun", "T4.yaml")
LSUN_T4_WIDE_CONFIG = os.path.join(REPO, "configs", "lsun", "T4_wide.yaml")
LSUN_DATA_CONFIG = os.path.join(REPO, "configs", "lsun", "bedroom.yaml")
# E8's paths: generate_large's defaults (fused attention, phase upsample,
# bf16_onepass statistics), --attn_impl flash, and --int8 (calibrated on 2
# x 8 trajectories, as the JAX entry)
LSUN_PATHS = {"fused": dict(attn_impl="fused"),
              "flash": dict(attn_impl="flash"),
              "int8": dict(attn_impl="fused", int8=True)}
LSUN_SIZE = 256
LSUN_TRAIN_BATCH = 16


def lsun_t4():
    """The generation half of configs/lsun/T4.yaml (full width, bf16)."""
    cfg = load_yaml(LSUN_T4_CONFIG)
    return {k: cfg[k] for k in ("diffusion", "sampler")}


def lsun_train_config(path=LSUN_T4_CONFIG):
    """An LSUN training config with configs/lsun/bedroom.yaml merged."""
    return merge(load_yaml(path), load_yaml(LSUN_DATA_CONFIG))


def lsun_net(path, device="meta", use_fp16=True):
    """The T4 sampler's UNetADM on ``path`` (LSUN_PATHS) as generate_large
    builds it, without weights."""
    from dxmi_tpu_torch.models.unet_adm import create_unet_adm
    dcfg = dict(lsun_t4()["diffusion"], use_fp16=use_fp16)
    for k in ("sigma_min", "sigma_max", "weight_schedule", "distillation"):
        dcfg.pop(k, None)
    opts = LSUN_PATHS[path]
    with torch.device(device):
        return create_unet_adm(**dcfg, attn_impl=opts["attn_impl"],
                               up_impl="phase", gn_stats="bf16_onepass",
                               quant_int8="static" if opts.get("int8")
                               else False)


def lsun_shape_counts(path, batch=1):
    """The kernels' launches by shape in one forward of the full-width T4
    net on ``path``, read on the meta device with the wrappers replaced by
    recorders: {("gn", HW, C, silu): n, ("k2", S, C, nh): n, ("k5", S, C,
    nh): n, ("k4", S, nh, d): n, ("k8", H, W, Cin, Cout, kh, kw, pads): n}.
    The flash path's are also E9's training forward's (no route of
    UNetADM looks at the gradient mode but fused_train's)."""
    from dxmi_tpu_torch.models import unet_adm as adm
    from dxmi_tpu_torch.ops import phase_up as phase_mod
    from dxmi_tpu_torch.ops import quant as quant_mod
    counts = collections.Counter()

    def gn(x, scale, bias, G, eps, silu, stats="fp32"):
        B, C = x.shape[0], x.shape[-1]
        counts[("gn", x.numel() // (B * C), C, bool(silu))] += 1
        return torch.empty_like(x)

    def k2(x, *a, **k):
        counts[("k2", x.shape[1], x.shape[2], a[6])] += 1
        return torch.empty_like(x)

    def k5(x, gs, gb, mats, bq, bp, nh, eps=1e-5):
        counts[("k5", x.shape[1], x.shape[2], nh)] += 1
        return torch.empty_like(x)

    def k4(q, k, v, sm):
        counts[("k4", q.shape[1], q.shape[2], q.shape[3])] += 1
        return torch.empty_like(q)

    def k8(x, q, bias, padding, out_dtype, stride=1):
        B, H, W, Cin = x.shape
        Cout, kh, kw, _ = q.w_i8.shape
        counts[("k8", H, W, Cin, Cout, kh, kw,
                tuple(tuple(p) for p in padding))] += 1
        return torch.empty(B, H, W, Cout, dtype=out_dtype, device=x.device)

    net = lsun_net(path).cast_weights()
    with _patched(adm, "group_norm", gn), _patched(adm, "attn_block", k2), \
            _patched(adm, "attn_block_int8", k5), \
            _patched(adm, "flash_mha", k4), \
            _patched(quant_mod, "int8_conv_apply", k8), \
            _patched(phase_mod, "int8_conv_apply", k8), torch.no_grad():
        net(torch.empty(batch, 3, LSUN_SIZE, LSUN_SIZE, device="meta"),
            torch.empty(batch, device="meta"))
    return counts


def lsun_launches(counts):
    """Launches a forward by counter name of ``lsun_shape_counts``."""
    names = {"gn": "gn_silu_bf16", "k2": "attn_block_bf16",
             "k5": "attn_block_i8", "k4": "flash_attn", "k8": "int8_conv"}
    out = collections.Counter()
    for key, n in counts.items():
        out[names[key[0]]] += n
    return dict(out)


# The plain versions that take K1's and K8's arguments, in batch chunks of
# at most PLAIN_CHUNK_ELEMS input elements: at LSUN's 256x256 maps one
# plain call on the whole batch (fp32 temporaries of x, 13-20 GB each at
# batch 100, and K8's float64 windows) would not fit beside the card's
# other tensors. Every sample's result is the same as in one call.
PLAIN_CHUNK_ELEMS = 1 << 27


def _chunks(B, per_sample):
    n = max(1, min(B, PLAIN_CHUNK_ELEMS // max(per_sample, 1)))
    return [(i, min(B, i + n)) for i in range(0, B, n)]


def gn_plain(x, *a):
    """group_norm_silu_reference over batch chunks of x."""
    return torch.cat([group_norm_silu_reference(x[i:j], *a)
                      for i, j in _chunks(x.shape[0], x[0].numel())])


def k8_plain(x, q, *a):
    """int8_conv_reference over batch chunks of x (by its window size)."""
    per = x[0].numel() * q.w_i8.shape[1] * q.w_i8.shape[2] // 2
    return torch.cat([int8_conv_reference(x[i:j], q, *a)
                      for i, j in _chunks(x.shape[0], per)])


def plain_kernels_adm():
    """The UNetADM path with the plain versions of K1, K2, K4, K5 and K8 on
    the card (K1 and K8 over batch chunks)."""
    from dxmi_tpu_torch.models import unet_adm as adm
    from dxmi_tpu_torch.ops import phase_up as phase_mod
    from dxmi_tpu_torch.ops import quant as quant_mod
    stack = contextlib.ExitStack()
    for mod, name, fn in ((adm, "group_norm", gn_plain),
                          (adm, "attn_block", attn_block_reference),
                          (adm, "attn_block_int8", attn_block_int8_plain),
                          (adm, "flash_mha", flash_mha_reference),
                          (quant_mod, "int8_conv_apply", k8_plain),
                          (phase_mod, "int8_conv_apply", k8_plain)):
        stack.enter_context(_patched(mod, name, fn))
    return stack


# Phase K at LSUN's shapes (batch 100, generation; batch LSUN_TRAIN_BATCH
# for K4's training forms): K1 at every GroupNorm of 128x128 and larger
# maps (the split route), in both statistics modes; K2 bf16 and K5 at the
# 32x32 blocks (S = 1024, C = 512, 8 heads), K5 at the 16x16 and 8x8 ones
# (C = 1024, 16 heads); K4 at the 32x32 map (8 heads of 64) in generation
# and its training forward and backward; K8 at every int8 conv of the
# 256x256 and 128x128 maps: each against its plain version and replayed
# bit-equal.
LSUN_BIG_HW = 128 * 128
LSUN_ATTN_SHAPES = [(BATCH, 1024, 512, 8)]
LSUN_I8_ATTN_SHAPES = [(BATCH, 1024, 512, 8), (BATCH, 64, 1024, 16)]


def lsun_gn_keys():
    """(HW, C, silu) of every K1 shape of the three E8 paths and E9 at
    128x128 and larger."""
    keys = set()
    for path in LSUN_PATHS:
        keys |= {k[1:] for k in lsun_shape_counts(path) if k[0] == "gn"}
    return sorted(k for k in keys if k[0] >= LSUN_BIG_HW)


def lsun_k8_keys():
    """(H, W, Cin, Cout, kh, kw, pads) of --int8's K8 shapes at 128x128
    and larger maps."""
    return sorted(k[1:] for k in lsun_shape_counts("int8")
                  if k[0] == "k8" and k[1] * k[2] >= LSUN_BIG_HW)


def lsun_k8_case(gen, B, H, Cin, Cout, kh, pads):
    """K8's arguments at an LSUN int8 conv: bf16 x, per-channel scales at
    the input's 0.995 quantile (on a sample of the rows), bf16 out."""
    x = randn(gen, B, H, H, Cin, scale=2.0, shift=0.3).bfloat16()
    w = randn(gen, kh, kh, Cin, Cout, scale=(kh * kh * Cin) ** -0.5)
    a = calib_channel_scale(x[:2].reshape(-1, Cin))
    return x, prepare_conv_static(w, a), randn(gen, Cout, scale=0.1), pads


def phase_kernels_lsun(gen, errs):
    """Phase K at LSUN's shapes (see above); adds to ``errs``."""
    for name in ("gn_silu_bf16_lsun", "attn_block_bf16_lsun",
                 "attn_block_i8_lsun", "flash_attn_lsun",
                 "flash_attn_bwd_dkv_lsun", "flash_attn_bwd_dq_lsun",
                 "int8_conv_lsun"):
        errs[name] = 0.0
    for HW, C, silu in lsun_gn_keys():
        for mode in GN_MODES:
            a = gn_bf16_case(gen, BATCH, HW, C, silu, mode)
            out = group_norm(*a)
            err = max_err(out.float(), gn_plain(*a).float(), "gn_silu_bf16")
            if not torch.equal(out, group_norm(*a)):
                raise AssertionError(f"gn_silu_bf16 LSUN {(BATCH, HW, C)}: a "
                                     "replay differs")
            r = route(HW, C, 32, torch.bfloat16)
            errs["gn_silu_bf16_lsun"] = max(errs["gn_silu_bf16_lsun"], err)
            print(f"  K gn_silu_bf16 LSUN {(BATCH, HW, C)} {mode}"
                  f"{' +SiLU' if silu else ''}: max abs err {err:.3e}; "
                  f"{'on-chip' if r.on_chip else 'split'} ({r.slabs} slabs, "
                  f"clusters of {r.cluster}); replay bit-equal")
            del a, out
            torch.cuda.empty_cache()
    for B, S, C, nh in LSUN_ATTN_SHAPES:
        a = attn_bf16_case(gen, B, S, C)
        out = attn_block(*a, num_heads=nh)
        rel, err, share = attn_bf16_check(
            out, attn_block_reference(*a, num_heads=nh), a[0],
            f"attn_block_bf16 LSUN {(B, S, C, nh)}")
        if not torch.equal(out, attn_block(*a, num_heads=nh)):
            raise AssertionError(f"attn_block_bf16 LSUN {(B, S, C, nh)}: a "
                                 "replay differs")
        errs["attn_block_bf16_lsun"] = max(errs["attn_block_bf16_lsun"], err)
        print(f"  K attn_block_bf16 LSUN {(B, S, C, nh)}: mean rel err "
              f"{rel:.3e} (tol {ATTN_BF16_MEAN_REL:g}), max abs err {err:.3e},"
              f" worst element at {share:.3f} of its limit; replay bit-equal")
        del a, out
    for B, S, C, nh in LSUN_I8_ATTN_SHAPES:
        x, gs, gb, mats, bq, bp = attn_i8_case(gen, B, S, C, nh,
                                               torch.bfloat16)
        what = f"attn_block_i8 LSUN {(B, S, C, nh)}"
        out = attn_block_int8(x, gs, gb, mats, bq, bp, nh)
        err, share, worst = attn_i8_check(
            out, attn_block_int8_plain(x, gs, gb, mats, bq, bp, nh), x, mats,
            what)
        if not torch.equal(out, attn_block_int8(x, gs, gb, mats, bq, bp, nh)):
            raise AssertionError(f"{what}: a replay differs")
        errs["attn_block_i8_lsun"] = max(errs["attn_block_i8_lsun"], err)
        print(f"  K {what}: max abs err {err:.3e}, {share:.3%} of elements "
              f"over their base limit, worst {worst:.3f} int8 levels beyond "
              "it; replay bit-equal")
        del x, out
    q, k, v, sm = flash_case(gen, BATCH, 1024, 8, 64)
    out = flash_mha(q, k, v, sm)
    err, share = flash_check(out, flash_mha_reference(q, k, v, sm), q, k, v,
                             sm, "flash_attn LSUN")
    if not torch.equal(out, flash_mha(q, k, v, sm)):
        raise AssertionError("flash_attn LSUN: a replay differs")
    errs["flash_attn_lsun"] = err
    print(f"  K flash_attn LSUN {(BATCH, 1024, 8, 64)}: max abs err "
          f"{err:.3e}, worst element at {share:.3f} of its row's limit; "
          "replay bit-equal")
    del q, k, v, out
    lsun_flash_bwd_check(gen, errs)
    for H, W, Cin, Cout, kh, kw, pads in lsun_k8_keys():
        x, qw, b, pad = lsun_k8_case(gen, BATCH, H, Cin, Cout, kh, pads)
        out = int8_conv_apply(x, qw, b, pad, torch.bfloat16)
        what = f"int8_conv LSUN {(BATCH, H, Cin, Cout)} {kh}x{kw} pad {pad}"
        err = (out.float() - k8_plain(x, qw, b, pad, torch.bfloat16).float()
               ).abs().max().item()
        if err != 0:
            raise AssertionError(f"{what}: max abs err {err}")
        if not torch.equal(out, int8_conv_apply(x, qw, b, pad,
                                                torch.bfloat16)):
            raise AssertionError(f"{what}: a replay differs")
        print(f"  K {what}: max abs err {err:g} (must be 0); replay "
              "bit-equal")
        del x, out
        torch.cuda.empty_cache()


def lsun_flash_bwd_check(gen, errs):
    """K4's training forms at the 32x32 map at E9's batch: the forward
    with its logsumexp, K4-dkv and K4-dq against their plain versions
    (FLASH_BWD_MEAN_REL, element-wise as phase K's training shapes), and
    a replay bit-equal."""
    shape = (LSUN_TRAIN_BATCH, 1024, 8, 64)
    qkv, o, lse, do, sm = flash_bwd_case(gen, *shape)
    q, k, v = qkv.unbind(2)
    o_p, lse_p = flash_mha_reference_fwd(q, k, v, sm)
    lse_err = flash_lse_check(lse, lse_p, f"flash_attn lse LSUN {shape}")
    flash_check(o, o_p, q, k, v, sm, f"flash_attn o LSUN {shape}")
    del o_p, lse_p
    got = flash_mha_bwd(qkv, o, lse, do, sm)
    ref = flash_mha_reference_bwd(qkv, o, lse, do, sm)
    for i, name in ((1, "dk"), (2, "dv"), (0, "dq")):
        rel, err = flash_bwd_check(got[:, :, i], ref[:, :, i],
                                   f"flash_attn_bwd {name} LSUN {shape}")
        kernel = ("flash_attn_bwd_dq_lsun" if i == 0
                  else "flash_attn_bwd_dkv_lsun")
        errs[kernel] = max(errs[kernel], err)
        print(f"  K {kernel} {name} {shape}: mean rel err {rel:.3e} (tol "
              f"{FLASH_BWD_MEAN_REL:.3e}), max abs err {err:.3e}")
    if not torch.equal(got, flash_mha_bwd(qkv, o, lse, do, sm)):
        raise AssertionError("flash_attn_bwd LSUN: a replay differs")
    print(f"  K flash_attn LSUN with logsumexp {shape}: lse max abs err "
          f"{lse_err:.3e}; backward replay bit-equal")
    del qkv, o, lse, do, got, ref
    torch.cuda.empty_cache()


def lsun_time_rows(gen):
    """T rows at LSUN's shapes: K1 on the split route at the most launched
    256x256 shape of E8 fused (bf16_onepass) and in fp32 statistics; K2
    bf16 and K5 at the 32x32 blocks, K5 at the 8x8 ones; K4 at the 32x32
    map; K4-dkv and K4-dq at E9's batch; K8 at the 256x256 3x3 conv
    (256 -> 256) and at the widest decoder input. The plain versions of K1
    and K8 run over batch chunks (``gn_plain``, ``k8_plain``)."""
    rows = {}
    counts = lsun_shape_counts("fused")
    _, HW, C, silu = max((k for k in counts if k[0] == "gn"
                          and k[1] == LSUN_SIZE * LSUN_SIZE),
                         key=lambda k: (counts[k], k[2]))
    for mode in GN_MODES:
        a = gn_bf16_case(gen, BATCH, HW, C, silu, mode)
        x_nchw = a[0].reshape(BATCH, LSUN_SIZE, LSUN_SIZE, C).permute(
            0, 3, 1, 2)
        s16, b16 = a[1].bfloat16(), a[2].bfloat16()
        n = BATCH * HW * C
        act = F.silu if silu else (lambda t: t)
        name = ("gn_silu_bf16_lsun" if mode == GN_MODES[0]
                else f"gn_silu_bf16_lsun {(BATCH, HW, C)} {mode}")
        rows[name] = dict(
            shape=(BATCH, HW, C), ms=time_ms(lambda: group_norm(*a)),
            plain_ms=time_ms(lambda: gn_plain(*a), iters=3, warmup=1),
            library_ms=time_ms(lambda: act(F.group_norm(
                x_nchw, 32, s16, b16, 1e-5))),
            bytes=2 * n * 2 + 2 * C * 4, ops={"fp32": 11 * n})
        del a, x_nchw
        torch.cuda.empty_cache()
    rows["attn_block_bf16_lsun"] = attn_bf16_row(gen, *LSUN_ATTN_SHAPES[0])
    for i, shape in enumerate(LSUN_I8_ATTN_SHAPES):
        name = ("attn_block_i8_lsun" if i == 0
                else f"attn_block_i8_lsun {shape}")
        rows[name] = attn_i8_row(gen, *shape, torch.bfloat16)
    rows["flash_attn_lsun"] = flash_time_row(gen, BATCH, 1024, 8, 64)
    rows.update(flash_bwd_time_rows(gen, LSUN_TRAIN_BATCH, 1024, 8, 64,
                                    "_lsun"))
    k8_keys = lsun_k8_keys()
    first = (LSUN_SIZE, LSUN_SIZE, 256, 256, 3, 3, SAME_3X3)
    widest = max((k for k in k8_keys if k[0] == LSUN_SIZE),
                 key=lambda k: (k[2], k[4]))
    for name, key in (("int8_conv_lsun", first),
                      (f"int8_conv_lsun {widest[:4]}", widest)):
        H, W, Cin, Cout, kh, kw, pads = key
        x, qw, b, pad = lsun_k8_case(gen, BATCH, H, Cin, Cout, kh, pads)
        nbytes, ops = k8_work(BATCH, H, W, Cin, Cout, kh, kw, H, W, 2, 2)
        ms = time_ms(lambda: int8_conv_apply(x, qw, b, pad, torch.bfloat16))
        plain = time_ms(lambda: k8_plain(x, qw, b, pad, torch.bfloat16),
                        iters=1, warmup=1)
        lib = k8_library(x, qw, pad)
        rows[name] = dict(shape=(BATCH, H, W, Cin, Cout, kh), ms=ms,
                          plain_ms=plain, library_ms=time_ms(lib),
                          bytes=nbytes, ops=ops)
        del x, lib
        torch.cuda.empty_cache()
    return rows


def attn_bf16_row(gen, B, S, C, nh):
    """T row of K2 bf16 at (B, S, C, nh). Library yardstick: the same block
    from PyTorch calls (bf16 GN, matmuls, SDPA)."""
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

    return dict(
        ms=time_ms(lambda: attn_block(*a, num_heads=nh)),
        plain_ms=time_ms(lambda: attn_block_reference(*a, num_heads=nh),
                         iters=3, warmup=1),
        library_ms=time_ms(library_attn),
        bytes=(2 * B * S * C + 4 * C * C + 4 * C) * 2 + 2 * C * 4,
        # qkv, logits, AV and proj products; ~5 flops of softmax per logit
        ops={"bf16": 2 * B * S * C * 3 * C + 4 * B * S * S * C
             + 2 * B * S * C * C, "fp32": 5 * B * nh * S * S})


def attn_i8_row(gen, B, S, C, nh, dt):
    """T row of K5 at (B, S, C, nh) in ``dt``. Library yardstick: the same
    block from PyTorch calls (bf16 GN, the int8 products as
    torch._int_mm, SDPA)."""
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

    return dict(
        ms=time_ms(lambda: attn_block_int8(*a, nh)),
        plain_ms=time_ms(lambda: attn_block_int8_plain(*a, nh), iters=3,
                         warmup=1),
        library_ms=time_ms(library_attn),
        # x read, y written (bf16); int8 weights; fp32 scales and biases
        bytes=2 * B * S * C * 2 + 4 * C * C + (3 * C * 3 + C * 3) * 4,
        ops={"int8": 2 * B * S * C * 4 * C, "bf16": 4 * B * S * S * C,
             "fp32": 5 * B * nh * S * S + 8 * B * S * C})


# ---- the LSUN goldens' small nets (G8; tests/test_torch_lsun.py) --------

LSUN_GOLDEN = os.path.join(REPO, "tests", "torch_fixtures",
                           "lsun_golden.npz")
LSUN_INT8_GOLDEN = os.path.join(REPO, "tests", "torch_fixtures",
                                "lsun_int8_golden.npz")
LSUN_TRAIN_GOLDEN = os.path.join(REPO, "tests", "torch_fixtures",
                                 "lsun_train_golden.npz")
# configs/lsun/T4.yaml's UNetADM structure at a small width: six levels
# (64 down to 2), one ResBlock a level with resblock_updown, no scale-shift,
# unconditional, attention at the 16x16, 8x8 and 4x4 maps (downsample rates
# 4, 8, 16, as "32,16,8" at 256) with heads of num_head_channels 32 (2, 2
# and 4 heads): K2 and K5 take the 16x16 and 8x8 maps, the 4x4 one takes
# the einsum path; 32 channels is the narrowest that GroupNorm(32) takes.
LSUN_SMALL = dict(image_size=64, in_channels=3, model_channels=32,
                  out_channels=3, num_res_blocks=1,
                  attention_resolutions=(4, 8, 16),
                  channel_mult=(1, 1, 2, 2, 4, 4), num_classes=None,
                  num_heads=4, num_head_channels=32,
                  use_scale_shift_norm=False, resblock_updown=True)
LSUN_BATCH, LSUN_SEED = 2, 20
# the goldens' paths of the small net: fp32 (the default einsum; on the card
# fused, K2 fp32), bf16 as generate_large runs it, and fp32 --int8 as the
# ADM fixture's int8 golden
LSUN_SMALL_PATHS = {
    "fp32": dict(),
    "bf16": dict(dtype=torch.bfloat16, softmax_f32=False, attn_impl="fused",
                 up_impl="phase", gn_stats="bf16_onepass"),
    "int8": dict(attn_impl="fused", up_impl="phase", gn_stats="bf16_onepass",
                 quant_int8="static", quant_attn="static"),
}
# the small Wide-ResNet value of the training golden
LSUN_SMALL_WRN = dict(depth=10, widen_factor=1, norm="group4",
                      num_classes=1)


def lsun_small_sampler_cfg():
    """configs/lsun/T4.yaml's sampler section at the small net's size."""
    cfg = dict(load_yaml(LSUN_T4_CONFIG)["sampler"])
    size = LSUN_SMALL["image_size"]
    cfg["sample_shape"] = [3, size, size]
    return cfg


def numpy_state(module, seed):
    """numpy-made weights of ``module`` (its state-dict names): kernels
    N(0, 1/fan_in), the zero-initialised ones included (flax and the
    reference start out_layers.3, proj_out and out.2 at zero, which would
    hide every fault upstream of them in a residual branch), biases 0.1
    N(0, 1), GroupNorm scales 1 + 0.1 N(0, 1)."""
    rs = np.random.RandomState(seed)
    out = {}
    for k, v in module.state_dict().items():
        shape = tuple(v.shape)
        if len(shape) == 1:  # a 1-D weight is a GroupNorm scale
            a = float(k.endswith(".weight")) + 0.1 * rs.randn(*shape)
        else:
            a = rs.randn(*shape) / np.sqrt(np.prod(shape[1:]))
        out[k] = torch.from_numpy(np.asarray(a, dtype=np.float32))
    return out


def lsun_small_state(seed=LSUN_SEED):
    """The small LSUN net's numpy-made weights (port names)."""
    from dxmi_tpu_torch.models.unet_adm import UNetADM
    return numpy_state(UNetADM(**LSUN_SMALL), seed)


def lsun_small_sampler(device, path="fp32", **net_kw):
    """The small LSUN net (``lsun_small_state``) on ``path``
    (LSUN_SMALL_PATHS; ``net_kw`` overrides) in T4.yaml's EDMSampler (T=4,
    stochastic_last, rho 4, the schedule's initial sigmas), eval mode on
    ``device``, weights cast as generate_large casts them."""
    from dxmi_tpu_torch.models.unet_adm import QUANT_SCALE_NAMES, UNetADM
    from dxmi_tpu_torch.samplers.edm import EDMSampler, KarrasDenoiser
    net = UNetADM(**LSUN_SMALL, **{**LSUN_SMALL_PATHS[path], **net_kw})
    missing, unexpected = net.load_state_dict(lsun_small_state(),
                                              strict=False)
    if unexpected or any(not k.endswith(QUANT_SCALE_NAMES) for k in missing):
        raise AssertionError(f"small LSUN net: missing {missing}, "
                             f"unexpected {unexpected}")
    sampler = EDMSampler(net, KarrasDenoiser(sigma_min=0.002, sigma_max=80.0),
                         **lsun_small_sampler_cfg())
    sampler.to(device).eval()
    net.cast_weights()
    return sampler


def lsun_draws(seed, n=LSUN_BATCH, steps=4, rounds=None):
    """Injected draws from a numpy seed at the small net's size: x0 (n, 3,
    64, 64) times sigma_max 80 and eps (steps, n, 3, 64, 64); with
    ``rounds`` each gains a leading rounds axis (calibration)."""
    rs = np.random.RandomState(seed)
    lead = () if rounds is None else (rounds,)
    size = LSUN_SMALL["image_size"]
    x0 = rs.randn(*lead, n, 3, size, size).astype(np.float32) * np.float32(
        80.0)
    eps = rs.randn(*lead, steps, n, 3, size, size).astype(np.float32)
    return x0, eps


def lsun_states(gold, eps):
    """The fp32 golden trajectory's states x_0 .. x_{T-1} (numpy): x0, then
    each step's mean plus its sigma times its noise."""
    x0, _ = lsun_draws(int(gold["seed"]))
    states = [x0]
    for t in range(len(gold["fp32/means"]) - 1):
        states.append(gold["fp32/means"][t] + gold["sigmas"][t] * eps[t])
    return states


def lsun_small_value(seed=LSUN_SEED + 2):
    """T4_wide.yaml's value (TimeIndependentValue over a WideResNet) at
    LSUN_SMALL_WRN's size with numpy-made weights, on the CPU."""
    cfg = load_yaml(LSUN_T4_WIDE_CONFIG)["value"]
    value = instantiate({**cfg, "net": {**cfg["net"], **LSUN_SMALL_WRN}})
    value.load_state_dict(numpy_state(value, seed))
    return value


UPDATE_FAMILIES = ("vnorm/", "vproj/", "snorm/", "sproj/")


def pack_update_families(arrays):
    """The per-tensor update norms and projections of a training golden
    (``vnorm/<name>`` ...) as one names array and one values array per
    family, to keep a golden of a deep net small."""
    out = {k: v for k, v in arrays.items()
           if not k.startswith(UPDATE_FAMILIES)}
    for fam in UPDATE_FAMILIES:
        keys = [k for k in arrays if k.startswith(fam)]
        out[f"pack/{fam}names"] = np.array([k[len(fam):] for k in keys])
        out[f"pack/{fam}values"] = np.array([arrays[k] for k in keys],
                                            np.float64)
    return out


def lsun_train_golden(path=None):
    """LSUN_TRAIN_GOLDEN's arrays with the families unpacked and the data
    batch rebuilt from its seed (``img``), as ``dxmi_train_replay``-style
    replays and ``train_golden_check`` read a golden."""
    packed = dict(np.load(path or LSUN_TRAIN_GOLDEN))
    out = {k: v for k, v in packed.items() if not k.startswith("pack/")}
    for fam in UPDATE_FAMILIES:
        for name, val in zip(packed[f"pack/{fam}names"],
                             packed[f"pack/{fam}values"]):
            out[f"{fam}{name}"] = np.float64(val)
    size = LSUN_SMALL["image_size"]
    img, _ = structured_class_images(int(out["case/batchsize"]), size, 1,
                                     seed=int(out["data_seed"]))
    out["img"] = np.ascontiguousarray(img.transpose(0, 3, 1, 2))
    return out


def lsun_train_replay(device, attn_impl="einsum"):
    """G8's trainer: the small LSUN sampler (fp32, ``attn_impl``, in
    training mode as the trainer runs it) and the small Wide-ResNet value
    on ``device``, one iteration of T4_wide.yaml's trainer against
    LSUN_TRAIN_GOLDEN (``cond_train_replay``); returns (port arrays,
    golden)."""
    golden = lsun_train_golden()
    sampler = lsun_small_sampler(device, attn_impl=attn_impl).train()
    value = lsun_small_value().to(device)
    cfg = load_yaml(LSUN_T4_WIDE_CONFIG)
    return cond_train_replay(sampler, value, cfg["trainer"], golden,
                             device), golden


# train_image_large on the LSUN configs at a small width (the goldens' net
# structure: six levels at 64x64, 32 channels, one ResBlock a level,
# attention at 32x32, 16x16 and 8x8 by heads of 32 channels; fp32; batch 4)
# and the value override each config's net takes
SHRUNK_LSUN_ARGS = [
    "--diffusion.image_size", "64", "--diffusion.num_channels", "32",
    "--diffusion.num_res_blocks", "1", "--diffusion.channel_mult",
    "1,1,2,2,4,4", "--diffusion.num_head_channels", "32",
    "--diffusion.use_fp16", "False", "--sampler.sample_shape", "[3,64,64]",
    "--training.batchsize", "4", "--training.log_every", "1"]
SHRUNK_LSUN_VALUE = {"IGEBMEncoder": ["--value.net.nh", "16"],
                     "WideResNet": ["--value.net.depth", "10",
                                    "--value.net.widen_factor", "1"]}


def lsun_cli_commands(config, run, device="cuda"):
    """(train command, generate command, run dir relative to the working
    directory) of train_image_large on an LSUN ``config`` for 2 steps at
    the small width above, then generate_large on the run dir it writes
    (8 samples, --save_npz)."""
    name = os.path.basename(config).split(".")[0]
    value = load_yaml(config)["value"]["net"]["_target_"].rsplit(".", 1)[1]
    log_dir = os.path.join("results", "lsun_bedroom", name, run)
    dev = ["--device", device]
    train = [sys.executable, "-m", "dxmi_tpu_torch.train_image_large",
             "--config", config, "--dataset", LSUN_DATA_CONFIG, "--run", run,
             "--fake_data", "--fake_data_size", "16", "--max_steps", "2",
             *dev, *SHRUNK_LSUN_ARGS, *SHRUNK_LSUN_VALUE[value]]
    gen = [sys.executable, "-m", "dxmi_tpu_torch.generate_large",
           "--log_dir", log_dir, "--sampler", "last", "--n_generate", "8",
           "--batchsize", "4", "--save_npz",
           os.path.join(log_dir, "samples.npz"), *dev]
    return train, gen, log_dir


LSUN_FP32_TOL = (2e-5, 2e-5)  # the fp32 kernels' limit (TOL), per element
# The small LSUN net under fp32 static int8 is chaotic: its 30 ResBlocks
# each carry an fp32 rounding of an activation across an int8 level now and
# then, and each flip grows through the blocks that follow. A nudge of
# every element of its input state by N(0, 1) LSUN_NUDGE of itself (about
# the distance between the port's and JAX's fp32 activations, 1e-7 to 1e-6
# relative through the net) moves the port's own int8 step means by
# 0.18-0.21 of the int8 effect (mean and median on an H100 at 700 W), as
# far as they sit from JAX's (0.14-0.20 on the CPU and the card; the
# card's kernels sit as far from their plain versions, 0.13-0.17); the
# trained ADM fixture's shallow net reads 0.0002. A single nudge does not
# always spread: one of 2^-24 (an ulp) left a step's median at 0.003, one
# of 2^-22 another at 1/8 of JAX's error. So the median gate of G-int8 is
# read against the largest of LSUN_NUDGES nudges: each step's median
# error from JAX's within LSUN_INT8_NUDGE_SHARE times the median distance
# between the port's step from the state and from a nudged state; the mean
# gate (INT8_STEP_RATIO of the int8 effect) stays.
LSUN_NUDGE, LSUN_NUDGES = 2.0 ** -20, 2
LSUN_INT8_NUDGE_SHARE = 2.0


def check_lsun_int8(steps):
    """The gates above on per-step (mean error / int8 effect, median error
    / median nudge distance, max abs err); returns the worst of each."""
    worst = max(r for r, _, _ in steps)
    nudge = max(m for _, m, _ in steps)
    if not worst <= INT8_STEP_RATIO:
        raise AssertionError(f"LSUN int8 step means {worst:.3f} of the int8 "
                             f"effect from JAX's (tol {INT8_STEP_RATIO:g})")
    if not nudge <= LSUN_INT8_NUDGE_SHARE:
        raise AssertionError(f"LSUN int8 step means' median error {nudge:.3f}"
                             " times the nudge's (tol "
                             f"{LSUN_INT8_NUDGE_SHARE:g})")
    return worst, nudge


def lsun_small_replay(device):
    """G8's sampler readings and gates on LSUN_GOLDEN and LSUN_INT8_GOLDEN
    (the small LSUN net), each step from the golden's fp32 states: (a) fp32
    (fused: K1 and K2 fp32 on the card, their plain versions on the CPU;
    and einsum) within LSUN_FP32_TOL of JAX's per element; (b) bf16 as
    generate_large runs it within BF16_REPLAY_SHARE of JAX's own bf16
    effect (the mean and the largest error over those of JAX's bf16 means
    from its fp32 ones); (c) fp32 --int8 calibrated on the golden's draws,
    its scales within INT8_SCALE_REL of JAX's, then with JAX's scales each
    step under ``check_lsun_int8``. Returns the readings."""
    gold = dict(np.load(LSUN_GOLDEN))
    gold8 = dict(np.load(LSUN_INT8_GOLDEN))
    _, eps = lsun_draws(int(gold["seed"]))
    states = [torch.from_numpy(s).to(device)
              for s in lsun_states(gold, eps)]
    eps = torch.from_numpy(eps).to(device)
    out = {}

    def means(sampler, xs=states):
        with torch.no_grad():
            return [sampler.sample_step(x, t, eps[t])["mean"].cpu().numpy()
                    for t, x in enumerate(xs)]

    ref32 = gold["fp32/means"]
    atol, rtol = LSUN_FP32_TOL
    fp = None
    for impl in ("fused", "einsum"):
        s32 = lsun_small_sampler(device, attn_impl=impl)
        got = np.stack(means(s32))
        err = np.abs(got - ref32)
        if not (err <= atol + rtol * np.abs(ref32)).all():
            raise AssertionError(f"LSUN fp32 {impl} step means "
                                 f"{err.max():.3e} from JAX's")
        out[f"fp32 {impl}"] = float(err.max())
        fp = fp if fp is not None else s32

    got = np.stack(means(lsun_small_sampler(device, "bf16")))
    worst = [0.0, 0.0]
    for t in range(len(got)):
        err = np.abs(got[t] - gold["bf16/means"][t])
        eff = np.abs(gold["bf16/means"][t] - ref32[t])
        ratios = (err.mean() / eff.mean(), err.max() / eff.max())
        worst = [max(a, float(b)) for a, b in zip(worst, ratios)]
    if max(worst) > BF16_REPLAY_SHARE:
        raise AssertionError(f"LSUN bf16 steps {worst} times JAX's own bf16 "
                             f"effect (tol {BF16_REPLAY_SHARE:g})")
    out["bf16"] = worst

    s8 = lsun_small_sampler(device, "int8")
    cx0, ceps = (torch.from_numpy(a).to(device) for a in lsun_draws(
        int(gold8["calib_seed"]), rounds=2))
    s8.calibrate_quant(n_sample=cx0.shape[1], n_rounds=2, x0=cx0, eps=ceps)
    ours = {k: v.clone() for k, v in s8.net.state_dict().items()}
    want = load_int8_golden_scales(s8.net, gold8)
    out["calib"] = max(float((ours[k].cpu() - v).abs().max()
                             / v.abs().max()) for k, v in want.items())
    if not out["calib"] <= INT8_SCALE_REL:
        raise AssertionError(f"LSUN int8 calibration {out['calib']:.3e} "
                             f"from JAX's (tol {INT8_SCALE_REL:g})")
    got8, ref8 = np.stack(means(s8)), gold8["int8/means"]
    gen = torch.Generator(device=device).manual_seed(1)
    nudge = np.zeros(len(got8))
    for _ in range(LSUN_NUDGES):
        nudged = [x + x.abs() * LSUN_NUDGE * torch.randn(
            x.shape, generator=gen, device=device) for x in states]
        far = np.abs(np.stack(means(s8, nudged)) - got8)
        nudge = np.maximum(nudge, np.median(far.reshape(len(far), -1), 1))
    steps = []
    for t in range(len(got8)):
        err, effect = np.abs(got8[t] - ref8[t]), np.abs(ref32[t] - ref8[t])
        steps.append((float(err.mean() / effect.mean()),
                      float(np.median(err) / nudge[t]), float(err.max())))
    out["int8"] = check_lsun_int8(steps)
    return out


def phase_replay_lsun():
    """G8: the LSUN goldens on the card. ``lsun_small_replay`` (K1 and K2
    fp32 under fused, K1 bf16 and K2 bf16 on the bf16 path, K1, K5 fp32 and
    K8 under --int8), then one iteration of T4_wide.yaml's trainer with
    the small Wide-ResNet value against LSUN_TRAIN_GOLDEN with K1 and with
    its plain version: the metrics held to both under G3_METRIC_REL, the
    updates read (the value's fp32 cuDNN convs round otherwise than the
    CPU's, as in G7; tests/test_torch_lsun.py gates them on the CPU)."""
    _lib.reset_launches()
    out = lsun_small_replay("cuda")
    used = {k for k, v in _lib.LAUNCHES.items() if v}
    want = {"gn_silu", "attn_block", "gn_silu_bf16", "attn_block_bf16",
            "attn_block_i8", "int8_conv"}
    if used != want:
        raise AssertionError(f"G8: launched {sorted(used)}, expected "
                             f"{sorted(want)}")
    print(f"  G8 fp32: step means within {out['fp32 fused']:.3e} (fused, K1 "
          f"and K2 fp32) and {out['fp32 einsum']:.3e} (einsum) of JAX's (tol "
          f"{LSUN_FP32_TOL[0]:g} + {LSUN_FP32_TOL[1]:g}*|JAX|); bf16 "
          f"(generate_large's path): worst step {out['bf16'][0]:.3f} (mean) "
          f"and {out['bf16'][1]:.3f} (largest) of JAX's own bf16 effect (tol "
          f"{BF16_REPLAY_SHARE:g}); fp32 --int8: calibration "
          f"{out['calib']:.3e} of each buffer's largest from JAX's (tol "
          f"{INT8_SCALE_REL:g}), step means {out['int8'][0]:.3f} of the int8 "
          f"effect from JAX's (tol {INT8_STEP_RATIO:g}), median error "
          f"{out['int8'][1]:.3f} times the nudge's (tol "
          f"{LSUN_INT8_NUDGE_SHARE:g}); kernels {dict(_lib.LAUNCHES)}")
    with plain_kernels_adm():
        plain, _ = lsun_train_replay("cuda")
    _lib.reset_launches()
    port, golden = lsun_train_replay("cuda")
    used = {k for k, v in _lib.LAUNCHES.items() if v}
    if used != {"gn_silu"}:
        raise AssertionError(f"G8 trainer: launched {sorted(used)}")
    m, v, sh = train_golden_check(port, golden, "G8 trainer",
                                  gate_updates=False)
    km, kv, ksh = train_golden_check(port, plain, "G8 trainer against plain",
                                     gate_updates=False)
    print(f"  G8 trainer (T4_wide.yaml, small WRN value): metrics within "
          f"{m:.3e} of JAX's and {km:.3e} of the plain versions' (tol "
          f"{G3_METRIC_REL:g}); read, not gated: value update {v:.3e} / "
          f"{kv:.3e}, sampler updates at {sh:.3f} / {ksh:.3f} of G4's "
          f"limit; d_loss {float(port['metric/ebm/d_loss_']):.5f}, "
          f"sampler_loss {float(port['metric/sampler/sampler_loss_']):.5f}; "
          f"kernels {dict(_lib.LAUNCHES)}")
    return out


# E8: generate_large on configs/lsun/T4.yaml at full width (526,304,771
# parameters, 256x256, bf16, weights drawn from seed 0: the pretrained
# file is not in the repository), N_BATCHES trajectories of BATCH on each
# of LSUN_PATHS. Each step of one trajectory is held against the kernels'
# plain versions at LSUN_PLAIN_BATCH samples (the plain fp32 net of that
# batch holds ~2 GB a tensor at the 256x256 maps): bf16 and --int8 within
# BF16_REPLAY_SHARE of the bf16 effect, the plain step's distance from the
# plain fp32 net's (for --int8 the fp32 net with the same int8 layers and
# scales), as E6.
LSUN_PLAIN_BATCH = 10
LSUN_SHARES = {"K1": ("gn_kernel", "gn_apply_kernel"),
               "K4 (K2's core too)": ("flash_fwd_kernel",),
               "K8": ("int8_conv_kernel",)}


def lsun_fp_reference(path, sampler):
    """The full-precision reference of ``e8_plain_check``: the fp32 net
    with ``sampler``'s weights, for --int8 with its int8 layers and
    scales."""
    if path != "int8":
        return generate_large.load_sampler(
            merge(lsun_t4(), {"diffusion": {"use_fp16": False}}), None,
            "cuda", 0, attn_impl=LSUN_PATHS[path]["attn_impl"])
    from dxmi_tpu_torch.samplers.edm import EDMSampler, KarrasDenoiser
    ref = EDMSampler(lsun_net("int8", "cuda", use_fp16=False),
                     KarrasDenoiser(sigma_min=0.002, sigma_max=80.0),
                     **lsun_t4()["sampler"]).cuda().eval()
    ref.load_state_dict(sampler.state_dict())
    ref.net.prepare_int8()
    return ref


def e8_plain_check(path, sampler):
    """Each of the T steps from the kernels' state of one trajectory of
    LSUN_PLAIN_BATCH: the kernels against their plain versions on the same
    state and noise, read against the bf16 effect (see above); returns
    (worst mean share, worst largest share)."""
    fp = lsun_fp_reference(path, sampler)
    rs = np.random.RandomState(8)
    shape = (LSUN_PLAIN_BATCH, 3, LSUN_SIZE, LSUN_SIZE)
    x = torch.from_numpy(rs.randn(*shape).astype(np.float32) * 80.0).cuda()
    eps = torch.from_numpy(rs.randn(sampler.n_timesteps, *shape).astype(
        np.float32)).cuda()
    worst = [0.0, 0.0]
    with torch.no_grad():
        for t in range(sampler.n_timesteps):
            step = sampler.sample_step(x, t, eps[t])
            with plain_kernels_adm():
                ref = sampler.sample_step(x, t, eps[t])["mean"]
                eff = (ref - fp.sample_step(x, t, eps[t])["mean"]).abs()
            err = (step["mean"] - ref).abs()
            worst = [max(worst[0], (err.mean() / eff.mean()).item()),
                     max(worst[1], (err.max() / eff.max()).item())]
            x = step["sample"]
    del fp
    torch.cuda.empty_cache()
    if max(worst) > BF16_REPLAY_SHARE:
        raise AssertionError(f"E8 {path}: {worst} of the bf16 effect from "
                             "the plain versions")
    return worst


def phase_generate_lsun(k1_log, rates):
    """E8 (see above): each path's launches (calibration's too) against
    ``lsun_shape_counts``, finite samples of the config's shape, img/s of
    sampling alone and with setup, peak memory, a profiled trajectory's
    device time, idle share and the kernels' shares (K8's time by shape is
    phase T's at LSUN's two widest convs: one more trajectory here would
    cost the run ~5 s), and each step against the plain versions. Returns
    the launches of each path."""
    cfg = lsun_t4()
    T4 = cfg["sampler"]["n_timesteps"]
    out = {}
    for path, opts in LSUN_PATHS.items():
        per_shape = lsun_shape_counts(path)
        per = lsun_launches(per_shape)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        _lib.reset_launches()
        t0 = time.perf_counter()
        sampler = generate_large.load_sampler(cfg, None, "cuda", 0, **opts)
        torch.cuda.synchronize()
        setup = time.perf_counter() - t0
        calib = dict(_lib.LAUNCHES)
        want_calib = ({k: v * T4 * generate_large.CALIB_N_ROUNDS for k, v in
                       lsun_launches(lsun_shape_counts("flash")).items()}
                      if opts.get("int8") else {})
        if calib != want_calib:
            raise AssertionError(f"E8 {path}: calibration launches {calib}, "
                                 f"expected {want_calib}")
        generate_large.sample_batches(sampler, BATCH, BATCH, 1)
        torch.cuda.synchronize()
        _lib.reset_launches()
        t0 = time.perf_counter()
        with k1_shapes(k1_log, f"E8 {path}", N_BATCHES,
                       f"trajectory of {BATCH}"):
            x, _ = generate_large.sample_batches(sampler, N_BATCHES * BATCH,
                                                 BATCH, 0)
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = dict(_lib.LAUNCHES)
        want = {k: v * T4 * N_BATCHES for k, v in per.items()}
        if got != want:
            raise AssertionError(f"E8 {path}: launches {got}, expected "
                                 f"{want}")
        if tuple(x.shape) != (N_BATCHES * BATCH, 3, LSUN_SIZE, LSUN_SIZE) \
                or not torch.isfinite(x).all():
            raise AssertionError(f"E8 {path}: samples {tuple(x.shape)}, "
                                 f"finite {bool(torch.isfinite(x).all())}")
        peak = torch.cuda.max_memory_allocated()
        # at ~3.4 s a trajectory the shape count's hook (a Python call per K1
        # launch, 768 of them) costs nothing that shows: the counted run is
        # the sampling alone
        sampling, n = wall, N_BATCHES * BATCH
        rates[f"E8 {path}"] = n / sampling
        shapes = ", ".join(f"{k[0]}{k[1:]} x{v}" for k, v in
                           sorted(per_shape.items(), key=str))
        print(f"  E8 {path}: {sum(p.numel() for p in sampler.net.parameters())}"
              f" parameters; load{' + calibration' if opts.get('int8') else ''}"
              f" {setup:.3f} s (launches {calib}); launches {got} = {per} a "
              f"forward x {T4} steps x {N_BATCHES}; sampling alone "
              f"{sampling:.3f} s, {rates[f'E8 {path}']:.2f} img/s, "
              f"{sampling / N_BATCHES * 1e3:.1f} ms a trajectory (host); with "
              f"setup {n / (setup + wall):.2f} img/s; samples in "
              f"[{x.min().item():.3f}, {x.max().item():.3f}], std "
              f"{x.std().item():.3f}; peak allocated {peak / 2**30:.2f} GiB",
              flush=True)
        print(f"  E8 {path} launches a forward by shape: {shapes}")
        profile_run(lambda: generate_large.sample_batches(sampler, BATCH,
                                                          BATCH, 4),
                    f"E8 {path} profile, one trajectory of {BATCH}", top=12,
                    shares=LSUN_SHARES)
        worst = e8_plain_check(path, sampler)
        print(f"  E8 {path}: kernels against their plain versions, each step "
              f"of a trajectory of {LSUN_PLAIN_BATCH} from the kernels' "
              f"state: {worst[0]:.3f} (mean) and {worst[1]:.3f} (largest) of "
              f"the bf16 effect (tol {BF16_REPLAY_SHARE:g})", flush=True)
        out[path] = got
        del sampler, x
        torch.cuda.empty_cache()
    return out


# E9: train_image_large on configs/lsun/T4.yaml (IGEBM value) and
# T4_wide.yaml (Wide-ResNet value) at full width with --attn_impl flash,
# bf16 sampler, weights drawn from the seed, the structured fake pool:
# LSUN_TRAIN_BATCH per step (the reference trains on 4 GPUs at 16 each;
# 32 does not fit the card's 80 GB, PERF.md). A step samples T forwards and
# sweeps the buffer's T minibatches, one forward and one backward each: 8
# forwards of 101 K1 and 5 K4 launches, 4 backwards of 5 K4-dkv and K4-dq;
# the value nets launch none of the port's kernels (the IGEBM has no norm,
# the Wide-ResNet's norms are F.group_norm). Then the wiring check on the
# first minibatch (flash against einsum, E3's gates) at LSUN_GRAD_ROWS.
# The last step is the profiled one (device activity alone is traced).
# 2 steps, the second profiled, to keep the whole script inside its limit
LSUN_TRAIN_STEPS, LSUN_GRAD_ROWS = 2, 8
LSUN_TRAIN_SHARES = {"K1": ("gn_kernel", "gn_apply_kernel"),
                     "K4": ("flash_fwd_kernel",),
                     "K4-dkv": ("attn_bwd_dkv_tc_kernel", "di_kernel"),
                     "K4-dq": ("attn_bwd_dq_tc_kernel",)}


def phase_lsun_train(k1_log):
    """E9 (see above): per config 3 steps, each one's launches, finite
    metrics and no skipped update; s/step over steps 1-2 with its phase
    split, peak memory and a profiled step; the wiring check once (the
    sampler is the same in both configs). Returns the launches a step."""
    T4 = lsun_t4()["sampler"]["n_timesteps"]
    fwd = lsun_launches(lsun_shape_counts("flash"))
    want = {"gn_silu_bf16": fwd["gn_silu_bf16"] * 2 * T4,
            "flash_attn": fwd["flash_attn"] * 2 * T4,
            "flash_attn_bwd_dkv": fwd["flash_attn"] * T4,
            "flash_attn_bwd_dq": fwd["flash_attn"] * T4}
    for label, path in (("T4", LSUN_T4_CONFIG),
                        ("T4_wide", LSUN_T4_WIDE_CONFIG)):
        cfg = lsun_train_config(path)
        B = LSUN_TRAIN_BATCH
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        trainer = build_trainer(cfg, "flash", B)
        data = train_image_large.fake_data(
            cfg, trainer.sampler, 256, B, int(cfg["training"]["seed"]),
            torch.device("cuda"))
        gen = torch.Generator(device="cuda").manual_seed(0)
        steps = []
        for i in range(LSUN_TRAIN_STEPS):
            x, y = next(data)
            _lib.reset_launches()
            with k1_shapes(k1_log, f"E9 {label}", 1, "step") if i == 0 else \
                    contextlib.nullcontext():
                wall, m = training_step(
                    lambda: train_image_large.train_step(trainer, x, y, gen),
                    i, LSUN_TRAIN_STEPS, f"E9 {label}", LSUN_TRAIN_SHARES)
            got = dict(_lib.LAUNCHES)
            if got != want:
                raise AssertionError(f"E9 {label} step {i}: launches {got}, "
                                     f"expected {want}")
            bad = [k for k, v in m.items() if not k.startswith("time/")
                   and not torch.isfinite(torch.as_tensor(v)).all()]
            if bad:
                raise AssertionError(f"E9 {label} step {i}: non-finite {bad}")
            steps.append((wall, m))
            print(f"  E9 {label} step {i}: {wall:.3f} s (sample "
                  f"{m['time/sample']:.3f}, update_f_v "
                  f"{m['time/update_f_v']:.3f}, update_sampler "
                  f"{m['time/update_sampler']:.3f}); d_loss "
                  f"{float(m['ebm/d_loss_']):.4f}, v_loss "
                  f"{float(m['ebm/v_loss_']):.4f}, sampler_loss "
                  f"{float(m['sampler/sampler_loss_']):.4f}", flush=True)
        if trainer.nan_guard_skips:
            raise AssertionError(f"E9 {label}: {trainer.nan_guard_skips} "
                                 "updates skipped by the non-finite guard")
        peak = torch.cuda.max_memory_allocated()
        phases = {k: np.mean([mm[f"time/{k}"] for _, mm in steps[1:]])
                  for k in ("sample", "update_f_v", "update_sampler")}
        print(f"  E9 {label}: {type(trainer.value.net).__name__} value "
              f"({sum(p.numel() for p in trainer.value.parameters())} "
              f"parameters), batch {B}; "
              f"{np.mean([w for w, _ in steps[1:]]):.3f} s/step over steps "
              f"1-{LSUN_TRAIN_STEPS - 1} (sample {phases['sample']:.3f}, "
              f"update_f_v {phases['update_f_v']:.3f}, update_sampler "
              f"{phases['update_sampler']:.3f}); launches per step {want}; "
              f"nan-guard skips 0; peak allocated {peak / 2**30:.2f} GiB",
              flush=True)
        del trainer, data
        torch.cuda.empty_cache()
        if label == "T4":
            grads, groups = e3_grads(cfg, B, LSUN_GRAD_ROWS,
                                     impls=("einsum", "flash"))
            for line in wiring_check(grads, groups, (("flash", "einsum"),),
                                     "E9"):
                print(f"  E9 wiring: {line}")
            del grads
            torch.cuda.empty_cache()
    return want


# ---- the anomaly entry (train_anomaly) and the 2D experiment ---------------

# train_anomaly at its defaults (train_anomaly.py:40-58): image 64, batch 32,
# T = 10. K1, K3 and K2 (fp32) launches of one forward of its nets: the
# policy (UNetSmall ch 64, ch_mult (1, 2, 2), attention at 16x16) K1 at
# norm_out, K3 at the 22 GN+conv pairs, K2 at the 4 blocks of 16x16; the
# value (UNetSmallEncoder ch 32, ch_mult (1, 2)) K3 at its 8 pairs (those
# of the 64x64 level at one channel a group) and K2 at the mid block of
# 32x32 (its head's GroupNorm is flax's nn.GroupNorm in JAX, F.group_norm
# here). One EV iteration runs the policy T times to sample, T times in the
# TD sweep and once in update_sampler, the value twice a TD step and once in
# update_sampler. tests/test_torch_unet_encoder.py counts these on the CPU.
ANOMALY_SIZE, ANOMALY_BATCH, ANOMALY_T = 64, 32, 10
ANOMALY_POLICY_LAUNCHES = {"gn_silu": 1, "gn_silu_conv3x3": 22,
                           "attn_block": 4}
ANOMALY_VALUE_LAUNCHES = {"gn_silu_conv3x3": 8, "attn_block": 1}
E11_POLICY_FORWARDS = 2 * ANOMALY_T + 1
E11_VALUE_FORWARDS = 2 * ANOMALY_T + 1
E11_ITERS = 3
# the energy's spectral-norm buffers (u and sigma of the stem and of the 15
# convs of its six blocks, skips included)
E11_SN_BUFFERS = 32
E11_LAUNCHES_PER_ITER = {
    k: E11_POLICY_FORWARDS * ANOMALY_POLICY_LAUNCHES.get(k, 0)
    + E11_VALUE_FORWARDS * ANOMALY_VALUE_LAUNCHES.get(k, 0)
    for k in ("gn_silu", "gn_silu_conv3x3", "attn_block")}
# the record's rows: K1 at the policy's norm_out (B, H*W, C); K3 at the
# value's 64x64 level, one channel a group (B, H, W, Cin, Cout); K2 fp32 at
# the value's mid block and at the policy's 16x16 blocks (B, S, C). K1 at
# one channel a group is checked and timed too (no net of the path has
# such a GroupNorm outside K3).
ANOMALY_K1 = (ANOMALY_BATCH, 4096, 64)
ANOMALY_K1_ONE = (ANOMALY_BATCH, 4096, 32)
ANOMALY_K3 = (ANOMALY_BATCH, 64, 64, 32, 32)
ANOMALY_K2 = {"attn_block_anomaly": (ANOMALY_BATCH, 1024, 64),
              "attn_block_anomaly_16": (ANOMALY_BATCH, 256, 128)}
# E11's gates on each forward against the kernels' plain versions on the
# card: the policy's eps by E's fused limit (REPLAY_TOL[True], max abs),
# the value's output by E4's wiring limit relative to its scale
E11_VALUE_REL = 2e-2
# G9: one EV iteration of train_anomaly's nets at a small width (image 16,
# T = 4, batch 4, the policy ch 64, the value ch 32, the energy nh 8 with
# spectral norm; numpy-made weights, ev_small_trainer) against the JAX
# trainer's (tests/torch_fixtures/make_ev_golden.py): metrics within
# G3_METRIC_REL, f's u and sigma after the iteration within G9_SN_ABS (f's
# power iteration after its Adam step: fp32 sums in another order; a wrong
# update order or a missed store moves them by 1e-2 or more); the updates'
# norms are read. The nets run K1 and K2 fp32 (fuse_gn_conv off, as JAX's
# fp32 composition: K3's bf16 operands would move the metrics by ~1e-3).
EV_GOLDEN = os.path.join(REPO, "tests", "torch_fixtures", "ev_golden.npz")
EV_SMALL = dict(image_size=16, n_timesteps=4, nh=8, ch=64)
EV_BATCH, EV_SEED = 4, 23
EV_HP = dict(tau1=0.01, tau2=0.01, lr=1e-5, v_lr=1e-4, f_lr=1e-4)
G9_SN_ABS = 1e-4


def ev_small_trainer(spectral_norm, device, seed=EV_SEED, **net_kw):
    """G9's trainer: ``train_anomaly.build`` at EV_SMALL with numpy-made
    weights from ``seed`` (``numpy_state``; spectral-norm sigmas 1), the
    schedule's initial sigmas, DxMITrainerEV with EV_HP."""
    _, sampler, value, energy = train_anomaly.build(
        EV_SMALL["image_size"], EV_SMALL["n_timesteps"], nh=EV_SMALL["nh"],
        ch=EV_SMALL["ch"], spectral_norm=spectral_norm, **net_kw)
    for i, m in enumerate((sampler.net, value, energy)):
        sd = numpy_state(m, seed + i)
        m.load_state_dict({k: torch.ones(()) if k.endswith(".sigma") else v
                           for k, v in sd.items()})
    for m in (sampler, value, energy):
        m.to(device)
    tr = DxMITrainerEV(batchsize=EV_BATCH, tau1=EV_HP["tau1"],
                       tau2=EV_HP["tau2"],
                       n_timesteps=EV_SMALL["n_timesteps"],
                       use_sampler_beta=True, adavelreg=0.99)
    tr.set_models(sampler, value, energy, lr=EV_HP["lr"], v_lr=EV_HP["v_lr"],
                  f_lr=EV_HP["f_lr"])
    return tr


def ev_replay(golden, device, **net_kw):
    """The port's side of G9: ``ev_small_trainer`` with spectral norm, one
    update_f_v and one update_sampler on the golden's trajectory, data and
    draws. Returns the metrics (``metric/...``), f's spectral-norm buffers
    after (``sn/...``) and the norm of each net's update (``update/...``)."""
    tr = ev_small_trainer(bool(golden["case/spectral_norm"]), device,
                          **net_kw)

    def t(name):
        return torch.from_numpy(np.asarray(golden[name])).to(device)

    l_sample = t("l_sample")
    buf = from_d_sample({"l_sample": l_sample,
                         "mean": torch.zeros_like(l_sample[1:]),
                         "sigma": t("sigma"), "logp": t("logp"),
                         "entropy": t("entropy")})
    nets = {"f": tr.energy, "v": tr.value, "s": tr.sampler.net}
    before = {k: [p.detach().clone() for p in n.parameters()]
              for k, n in nets.items()}
    m = tr.update_f_v(t("img"), buf, noise=list(t("td_noise")))
    m.update(tr.update_sampler(buf, perm=t("perm"), noise=list(t("noise"))))
    out = {f"metric/{k}": v.float().cpu().numpy() for k, v in m.items()}
    for k, b in sn_buffers(tr.energy):
        out[f"sn/{k}"] = b.cpu().numpy()
    for k, n in nets.items():
        out[f"update/{k}"] = np.float64(sum(
            float(((p.detach() - p0) ** 2).sum())
            for p, p0 in zip(n.parameters(), before[k])) ** 0.5)
    return out


def ev_golden_check(port, golden, what):
    """G9's gates; returns (worst metric rel err, worst u/sigma abs err)."""
    worst_m = worst_sn = 0.0
    for k in golden:
        a = port.get(k)
        if k.startswith("metric/"):
            a, b = (np.asarray(x, np.float64) for x in (a, golden[k]))
            rel = np.abs(a - b).max() / max(np.abs(b).max(), 1e-12)
            if not np.isfinite(a).all() or rel > G3_METRIC_REL:
                raise AssertionError(f"{what} {k}: {a} vs JAX {b}")
            worst_m = max(worst_m, rel)
        elif k.startswith("sn/"):
            err = float(np.abs(a - golden[k]).max())
            if not err <= G9_SN_ABS:
                raise AssertionError(f"{what} {k}: {err:.3e} from JAX's")
            worst_sn = max(worst_sn, err)
    return worst_m, worst_sn


def phase_replay_ev():
    """G9 (see EV_GOLDEN)."""
    golden = dict(np.load(EV_GOLDEN))
    _lib.reset_launches()
    port = ev_replay(golden, "cuda", fuse_gn_conv=False)
    used = {k for k, v in _lib.LAUNCHES.items() if v}
    if used != {"gn_silu", "attn_block"}:
        raise AssertionError(f"G9: launched {dict(_lib.LAUNCHES)}")
    m, sn = ev_golden_check(port, golden, "G9")
    upd = ", ".join(f"{k} {port[f'update/{k}']:.4e} (JAX "
                    f"{float(golden[f'update/{k}']):.4e})" for k in "fvs")
    print(f"  G9: metrics within {m:.3e} of JAX's (tol {G3_METRIC_REL:g}), "
          f"f's u and sigma within {sn:.3e} (tol {G9_SN_ABS:g}); update "
          f"norms (read) {upd}; kernels {dict(_lib.LAUNCHES)}")


def anomaly_shapes():
    """K1, K3 and K2 calls by shape of one forward of the policy and one of
    the value of ``train_anomaly.build`` at full width, counted from the
    nets' wrapper calls on the CPU (batch 1): {'policy'|'value': Counter of
    ('gn', HW, C) | ('conv', H, W, Cin, Cout) | ('attn', S, C)}."""
    from dxmi_tpu_torch.models import unet_small as us
    counts = {}
    nets = train_anomaly.build(ANOMALY_SIZE, ANOMALY_T)
    for tag, net in (("policy", nets[0].eval()), ("value", nets[2])):
        seen = collections.Counter()
        stack = contextlib.ExitStack()

        def wrap(name, key):
            fn = getattr(us, name)

            def counted(*a, **k):
                seen[key(*a)] += 1
                return fn(*a, **k)
            stack.enter_context(_patched(us, name, counted))

        wrap("group_norm", lambda x, *a: ("gn", x.shape[1] * x.shape[2],
                                          x.shape[3]))
        wrap("gn_silu_conv", lambda x, s, b, w, *a: ("conv", *x.shape[1:],
                                                     w.shape[-1]))
        wrap("attn_block", lambda x, *a: ("attn", *x.shape[1:]))
        with stack, torch.no_grad():
            net(torch.zeros(1, 3, ANOMALY_SIZE, ANOMALY_SIZE),
                torch.zeros(1))
        counts[tag] = seen
    return counts


def phase_kernels_anomaly(gen, errs):
    """K1, K3 and K2 (fp32) at every shape of train_anomaly's nets at batch
    32, and K1 at one channel a group, each against its plain version under
    TOL (K3 by conv_check) and replayed bit-equal."""
    for name in ("gn_silu_anomaly", "gn_silu_conv3x3_anomaly", *ANOMALY_K2):
        errs[name] = 0.0
    keys = {("gn", *ANOMALY_K1_ONE[1:])}
    for seen in anomaly_shapes().values():
        keys |= set(seen)
    B = ANOMALY_BATCH
    for key in sorted(keys):
        one = False  # a GroupNorm of one channel a group
        if key[0] == "gn":
            a = gn_case(gen, B, key[1], key[2], True)
            out = group_norm(*a)
            err = max_err(out, group_norm_silu_reference(*a), "gn_silu")
            again, row = group_norm(*a), "gn_silu_anomaly"
            what = f"gn_silu {(B, *key[1:])}"
            one = key[2] == 32
        elif key[0] == "conv":
            _, H, W, Cin, Cout = key
            a = conv_case(gen, B, H, Cin, Cout, W)
            out = gn_silu_conv(*a)
            err = conv_check(out, gn_silu_conv_reference(*a),
                             f"gn_silu_conv3x3 anomaly {key}")
            again, row = gn_silu_conv(*a), "gn_silu_conv3x3_anomaly"
            what = f"gn_silu_conv3x3 {(B, H, W, Cin, Cout)}"
            one = Cin == 32
        else:
            _, S, C = key
            a = attn_case(gen, B, S, C)
            out = attn_block(*a, num_heads=1, eps=1e-6, block_b=1)
            err = max_err(out, attn_block_reference(*a, num_heads=1,
                                                    eps=1e-6), "attn_block")
            again = attn_block(*a, num_heads=1, eps=1e-6, block_b=1)
            row = ("attn_block_anomaly" if (S, C) == (1024, 64)
                   else "attn_block_anomaly_16")
            what = f"attn_block fp32 {(B, S, C)}"
        if not torch.equal(out, again):
            raise AssertionError(f"K anomaly {what}: a replay differs")
        errs[row] = max(errs[row], err)
        print(f"  K anomaly {what}{' (one channel a group)' if one else ''}"
              f": max abs err {err:.3e}; replay bit-equal")
        del a, out, again


def anomaly_time_rows(gen):
    """T rows of the anomaly shapes (ANOMALY_K1, ANOMALY_K3, ANOMALY_K2),
    beside the plain versions and the library calls; K1 at one channel a
    group printed beside them."""
    rows = {}
    for shape, name in ((ANOMALY_K1, "gn_silu_anomaly"),
                        (ANOMALY_K1_ONE, None)):
        B, HW, C = shape
        a = gn_case(gen, B, HW, C, True)
        x_nchw = a[0].reshape(B, 64, 64, C).permute(0, 3, 1, 2)
        n = B * HW * C
        r = dict(ms=time_ms(lambda: group_norm(*a)),
                 plain_ms=time_ms(lambda: group_norm_silu_reference(*a)),
                 library_ms=time_ms(lambda: F.silu(F.group_norm(
                     x_nchw, 32, a[1], a[2], 1e-6))),
                 bytes=2 * n * 4 + 2 * C * 4, ops={"fp32": 11 * n})
        if name is None:
            bound = r["bytes"] / HBM_BYTES_S * 1e3
            print(f"  T gn_silu {shape} (one channel a group): kernel "
                  f"{r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, library "
                  f"{r['library_ms']:.4f} ms, bound {bound:.4f} ms (bytes)")
        else:
            rows[name] = r
        del a, x_nchw
    B, H, W, Cin, Cout = ANOMALY_K3
    a = conv_case(gen, B, H, Cin, Cout, W)
    nbytes, ops = conv_work(B, H, W, Cin, Cout)
    rows["gn_silu_conv3x3_anomaly"] = dict(
        ms=time_ms(lambda: gn_silu_conv(*a)),
        plain_ms=time_ms(lambda: gn_silu_conv_reference(*a)),
        library_ms=time_ms(conv_library(a)), bytes=nbytes, ops=ops)
    del a
    for name, (B, S, C) in ANOMALY_K2.items():
        a = attn_case(gen, B, S, C)
        rows[name] = dict(
            ms=time_ms(lambda: attn_block(*a, num_heads=1, eps=1e-6,
                                          block_b=1)),
            plain_ms=time_ms(lambda: attn_block_reference(*a, num_heads=1,
                                                          eps=1e-6)),
            library_ms=time_ms(lambda: library_attn_block(*a)),
            **attn_fp32_work(B, S, C))
        del a
    return rows


@contextlib.contextmanager
def k2_shapes(log, label, runs, unit):
    """K2 fp32's launches by (B, S, C) into ``log[label]`` while the block
    runs ``runs`` times one ``unit`` (as k3_shapes)."""
    from dxmi_tpu_torch.ops import attn_block as ab
    fwd = ab._attn_block_forward
    seen = collections.Counter()

    def counted(x, *rest):
        if x.is_cuda:
            seen[tuple(x.shape)] += 1
        return fwd(x, *rest)

    ab._attn_block_forward = counted
    try:
        yield
    finally:
        ab._attn_block_forward = fwd
    log[label] = (seen, runs, unit)


def anomaly_images(n, size, seed):
    """``n`` structured RGB images (uint8 NHWC) at ``size``, the training
    distribution of E11 (the class pool of --fake_data, one class)."""
    x, _ = structured_class_images(n, size, 1, seed=seed)
    return np.round((x + 1) * 127.5).clip(0, 255).astype(np.uint8)


def write_anomaly_data(root):
    """E11's inputs under ``root``: a tensor file of 64 images (uint8 NCHW,
    the MVTec layout's train_data.pth), a PNG folder of 32 images at 64x64
    and 32 at 256x256 (the loader halves those twice by BOX), and two PNG
    directories to score, 16 nominal images at 64x64 and 16 noise images
    at 128x128 (resized by the score's bilinear)."""
    from dxmi_tpu_torch.utils.png import write_png
    paths = {k: os.path.join(root, k) for k in ("tensor", "folder", "in",
                                                  "out")}
    for p in paths.values():
        os.makedirs(p)
    torch.save(torch.from_numpy(anomaly_images(64, 64, 1).transpose(
        0, 3, 1, 2).copy()), os.path.join(paths["tensor"], "train_data.pth"))
    for i, img in enumerate([*anomaly_images(32, 64, 2),
                             *anomaly_images(32, 256, 3)]):
        write_png(os.path.join(paths["folder"], f"{i:03d}.png"), img)
    for i, img in enumerate(anomaly_images(16, 64, 4)):
        write_png(os.path.join(paths["in"], f"{i:03d}.png"), img)
    rs = np.random.RandomState(5)
    for i in range(16):
        write_png(os.path.join(paths["out"], f"{i:03d}.png"),
                  rs.randint(0, 256, (128, 128, 3)).astype(np.uint8))
    return paths


def e11_forward_checks(tr, x):
    """Each forward of the policy and the value at one iteration's inputs
    against the kernels' plain versions on the card (E's and E4's gates);
    returns (worst policy abs err, worst value rel err)."""
    gen = torch.Generator(device="cuda").manual_seed(3)
    worst = [0.0, 0.0]
    with torch.no_grad():
        for t in range(ANOMALY_T):
            s = torch.randn(x.shape, generator=gen, device="cuda")
            tvec = torch.full((x.shape[0],), t, device="cuda")
            eps = tr.sampler.net(s, tr.sampler.tau[tvec])
            v = tr.value(s, tvec)
            with plain_kernels_cifar():
                eps_p = tr.sampler.net(s, tr.sampler.tau[tvec])
                v_p = tr.value(s, tvec)
            e = (eps - eps_p).abs().max().item()
            r = ((v - v_p).abs().max() / v_p.abs().max().clamp_min(1e-6)
                 ).item()
            if not (e <= REPLAY_TOL[True] and r <= E11_VALUE_REL):
                raise AssertionError(f"E11 t {t}: policy {e:.3e}, value "
                                     f"{r:.3e} from the plain versions")
            worst = [max(worst[0], e), max(worst[1], r)]
    return worst


def phase_anomaly(k1_log, k3_log, k2_log):
    """E11: train_anomaly at its defaults (image 64, batch 32, T = 10) on
    the card. (1) ``python -m dxmi_tpu_torch.train_anomaly`` (its ``main``)
    for E11_ITERS iterations from a tensor file, launches counted (K1, K3,
    K2 by shape into the logs of T-K1 and T-K3), and with --spectral_norm
    from a PNG folder of 64x64 and 256x256 images; their run directories'
    files; --score of the spectral-norm run on two PNG directories. (2) At
    one iteration's inputs each forward of the policy and the value against
    the kernels' plain versions. (3) s/iter over iterations 1-2 of a
    trainer of the entry, peak memory, the third iteration profiled (idle
    share)."""
    cwd = os.getcwd()
    launches = {}
    with tempfile.TemporaryDirectory() as tmp:
        paths = write_anomaly_data(tmp)
        os.chdir(tmp)
        try:
            for run, data, extra in (("a", paths["tensor"], []),
                                     ("b", paths["folder"],
                                      ["--spectral_norm"])):
                argv = ["--data_dir", data, "--n_iter", str(E11_ITERS),
                        "--log_every", "1", "--run", run, *extra]
                _lib.reset_launches()
                t0 = time.perf_counter()
                logged = run == "a"
                with (k1_shapes(k1_log, "E11", E11_ITERS, "iteration")
                      if logged else contextlib.nullcontext()), \
                        (k3_shapes(k3_log, "E11", E11_ITERS, "iteration")
                         if logged else contextlib.nullcontext()), \
                        (k2_shapes(k2_log, "E11", E11_ITERS, "iteration")
                         if logged else contextlib.nullcontext()):
                    train_anomaly.main(argv)
                torch.cuda.synchronize()
                secs = time.perf_counter() - t0
                got = dict(_lib.LAUNCHES)
                want = {k: v * E11_ITERS
                        for k, v in E11_LAUNCHES_PER_ITER.items()}
                if got != want:
                    raise AssertionError(f"E11 {run}: launches {got}, "
                                         f"expected {want}")
                run_dir = os.path.join("results", "anomaly", run)
                files = sorted(os.listdir(run_dir))
                if files != ["config.yaml", "energy_last.pth",
                             "sampler_last.pth", "value_last.pth"]:
                    raise AssertionError(f"E11 {run}: run dir {files}")
                sd = torch.load(os.path.join(run_dir, "energy_last.pth"))[
                    "state_dict"]
                n_sn = sum(k.endswith((".u", ".sigma")) for k in sd)
                if n_sn != (E11_SN_BUFFERS if extra else 0) or not all(
                        torch.isfinite(v).all() for v in sd.values()):
                    raise AssertionError(f"E11 {run}: {n_sn} spectral-norm "
                                         "buffers in energy_last.pth")
                launches[run] = got
                src = ("PNG folder, --spectral_norm" if extra
                       else "tensor file")
                print(f"  E11 {run} ({src}): {E11_ITERS} iterations in "
                      f"{secs:.1f} s with set-up, launches {got}, run dir "
                      f"{files}, {n_sn} spectral-norm buffers")
            score = train_anomaly.main([
                "--score", "--log_dir", os.path.join("results", "anomaly",
                                                     "b"),
                "--in_dir", paths["in"], "--out_dir", paths["out"]])
            if not all(0 <= score[k] <= 1 for k in ("auroc", "aupr")):
                raise AssertionError(f"E11 score: {score}")
            print(f"  E11 --score (spectral-norm run, 16 nominal 64x64 "
                  f"against 16 noise 128x128 images): AUROC "
                  f"{score['auroc']:.4f}, AUPR {score['aupr']:.4f}")
        finally:
            os.chdir(cwd)

    args = train_anomaly.parser().parse_args(["--fake_data"])
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    tr = train_anomaly.make_trainer(args, torch.device("cuda"))
    data = train_anomaly.data_batches(args)
    gen = torch.Generator(device="cuda").manual_seed(0)
    x = train_anomaly.to_device(next(data)[0], torch.device("cuda"))
    pe, vr = e11_forward_checks(tr, x)
    print(f"  E11 forwards against the plain versions: policy {pe:.3e} "
          f"(tol {REPLAY_TOL[True]:g}), value {vr:.3e} of its scale (tol "
          f"{E11_VALUE_REL:g})")
    walls = []
    shares = {"K3 (its conv launches)": ("conv3x3_",),
              "K2 fp32 (less K1's statistics)": ("bb_gemm", "bb_attn"),
              "K1 (and K3's and K2's statistics)": ("gn_", "bb_stats")}
    for i in range(3):
        x = train_anomaly.to_device(next(data)[0], torch.device("cuda"))
        wall, m = training_step(
            lambda: train_step(tr, x, None, gen, n_generator=1), i, 3,
            "E11", shares)
        if not all(torch.isfinite(torch.as_tensor(v)).all()
                   for k, v in m.items() if not k.startswith("time/")):
            raise AssertionError(f"E11 iteration {i}: non-finite metrics")
        walls.append((wall, m))
    later = walls[1:]
    print(f"  E11: {np.mean([w for w, _ in later]):.3f} s/iter over "
          f"iterations 1-2 (sample "
          f"{np.mean([m['time/sample'] for _, m in later]):.3f}, update_f_v "
          f"{np.mean([m['time/update_f_v'] for _, m in later]):.3f}, "
          f"update_sampler "
          f"{np.mean([m['time/update_sampler'] for _, m in later]):.3f}); "
          f"peak allocated {torch.cuda.max_memory_allocated() / 2**30:.2f} "
          f"GiB; policy {sum(p.numel() for p in tr.sampler.net.parameters())}"
          f", value {sum(p.numel() for p in tr.value.parameters())}, energy "
          f"{sum(p.numel() for p in tr.energy.parameters())} parameters")
    del tr
    torch.cuda.empty_cache()
    return launches["a"]


def anomaly_launches(k1_log, k3_log, k2_log):
    """The record's launches of the anomaly rows: those of E11's counted
    run (E11_ITERS iterations of the entry) at each row's shape."""
    B, HW, C = ANOMALY_K1
    return {"gn_silu_anomaly": k1_log["E11"][0][(B, HW, C, 0, 0, 1)],
            "gn_silu_conv3x3_anomaly": k3_log["E11"][0][ANOMALY_K3],
            **{name: k2_log["E11"][0][shape]
               for name, shape in ANOMALY_K2.items()}}


# Phase C's runs of this slice: train_2d at its defaults for C_2D_ITERS
# iterations after 200 of pretraining (the curve every 100, its JSON), and
# train_image_large on conv16.yaml from a PNG folder of class-prefixed
# 64x64 images (4 classes; the loader halves them to the config's 16x16,
# data.image_size) with --data_workers 2 for 2 steps
C_2D_ITERS = 300


def twod_cli(out_dir):
    curve = os.path.join(out_dir, "curve_2d.json")
    cmd = [sys.executable, "-m", "dxmi_tpu_torch.train_2d", "--n_iter",
           str(C_2D_ITERS), "--pretrain_iters", "200", "--eval_every", "100",
           "--curve_out", curve, "--out", os.path.join(out_dir, "2d")]
    lines, secs = run_cli(cmd, out_dir, "train_2d")
    got = json.load(open(curve))["curve"]
    if [p["iter"] for p in got] != list(range(0, C_2D_ITERS + 1, 100)) or \
            not np.isfinite([p["loglik"] for p in got]).all():
        raise AssertionError(f"train_2d: curve {got}")
    print(f"  C train_2d: {secs:.1f} s, curve "
          + ", ".join(f"{p['iter']}: {p['loglik']:.4f}" for p in got)
          + f"; {lines[-3]}")


def folder_train_cli(out_dir):
    from dxmi_tpu_torch.utils.png import write_png
    folder = os.path.join(out_dir, "imagenet_png")
    shutil.rmtree(folder, ignore_errors=True)
    os.makedirs(folder)
    x, y = structured_class_images(64, 64, 4, seed=9)
    for i, (img, c) in enumerate(zip(x, y)):
        write_png(os.path.join(folder, f"c{c}_{i:03d}.png"),
                  np.round((img + 1) * 127.5).clip(0, 255).astype(np.uint8))
    run = "chip_folder"
    cmd = [sys.executable, "-m", "dxmi_tpu_torch.train_image_large",
           "--config", CONV16_CONFIG, "--dataset",
           os.path.join(REPO, "configs", "imagenet64", "imagenet64.yaml"),
           "--run", run, "--data.name", "adm_conv16_png", "--data.data_dir",
           folder, "--data.image_size", "16", "--data.cachefile",
           os.path.join(out_dir, "imagenet_png.cache"),
           "--training.pretrained_path", CONV16_CKPT, "--data_workers", "2",
           "--training.log_every", "1", "--max_steps", "2"]
    lines, secs = run_cli(cmd, out_dir, "train_image_large (PNG folder)")
    iters = finite_iters(lines, "train_image_large (PNG folder)")
    run_dir = os.path.join(out_dir, "results", "adm_conv16_png", "conv16",
                           run)
    if iters != [0, 1] or not os.path.exists(os.path.join(
            run_dir, "sampler_last.pth")):
        raise AssertionError(f"train_image_large (PNG folder): iterations "
                             f"{iters}, run dir {run_dir}")
    print(f"  C train_image_large conv16 from a PNG folder (64 images of 4 "
          f"classes, --data_workers 2): {secs:.1f} s, iterations {iters}")


# ---- G10 and E12: the distillation losses, karras_sample and the
# pretraining entries -----------------------------------------------------

DISTILL_GOLDEN = os.path.join(REPO, "tests", "torch_fixtures",
                              "distill_golden.npz")
# the small class-conditional ADM of the distillation golden (fp32, einsum
# attention at the 8x8 map, numpy-made weights), and its 64x64 form for
# l2-32
DISTILL_SMALL = dict(image_size=16, in_channels=3, model_channels=32,
                     out_channels=3, num_res_blocks=1,
                     attention_resolutions=(2,), channel_mult=(1, 2),
                     num_classes=4, num_heads=2, use_scale_shift_norm=True,
                     resblock_updown=True, dropout=0.1)
DISTILL_ROLES = ("online", "target", "teacher")
DISTILL_SEED, DISTILL_BATCH, DISTILL_SCALES = 24, 4, 8
# name: (loss, loss_norm, image size, with a teacher, training mode);
# KarrasDenoiser(weight_schedule='karras') throughout
DISTILL_CASES = {
    "dsm": ("training", "l2", 16, False, True),
    "cd_l2": ("consistency", "l2", 16, True, True),
    "cd_l1": ("consistency", "l1", 16, True, False),
    "ct_l2": ("consistency", "l2", 16, False, False),
    "ct_l1": ("consistency", "l1", 16, False, True),
    "pd_l2": ("progdist", "l2", 16, True, False),
    "pd_l1": ("progdist", "l1", 16, True, True),
    "cd_l2-32": ("consistency", "l2-32", 64, True, False),
}
# karras_sample's cases on the small net: steps, batch, options
KARRAS_STEPS, KARRAS_BATCH = 4, 2
KARRAS_CASES = {"onestep": {}, "heun": {}, "euler": {}, "ancestral": {},
                "dpm": {}, "multistep": {}, "progdist": {},
                "heun_churn": dict(s_churn=2.0, s_tmin=0.05, s_tmax=50.0)}
# one pretrain_ddpm update at a small width (ch 32, the script's structure)
DDPM_CH, DDPM_BATCH, DDPM_LR, DDPM_T = 32, 4, 2e-4, 10
G10_LOSS_REL = 1e-4       # losses against JAX's
G10_SAMPLE = (2e-5, 2e-5)  # samples: the fp32 limit (abs, rel)
# heun's 4 steps from sigma 80 amplify rounding: nudging the initial state
# by 2^-22 of itself (two ulps) moves JAX's own samples by about the fp32
# limit on the CPU, and the card's cuDNN convs read 1.12 of it against
# JAX's. The golden records that move (``karras/<case>/move``, JAX's runs
# from two such nudges), and a sample is held to the fp32 limit, or to
# twice JAX's recorded move where that is larger (G8's rule for a chaotic
# path, read from the reference and not from the code under test).
KARRAS_NUDGE, KARRAS_NUDGE_FACTOR = 2.0 ** -22, 2.0


def distill_net(size, role, device="cpu", **over):
    """The small ADM at ``size`` (``over`` overrides DISTILL_SMALL) with
    numpy-made weights for ``role`` (DISTILL_ROLES) on ``device``."""
    from dxmi_tpu_torch.models.unet_adm import UNetADM
    net = UNetADM(**dict(DISTILL_SMALL, image_size=size, **over))
    net.load_state_dict(numpy_state(net, DISTILL_SEED
                                    + DISTILL_ROLES.index(role)
                                    + (10 if size != 16 else 0)))
    return net.to(device)


def distill_inputs(name, seed, size=None):
    """The numpy-made inputs of case ``name`` (at its image size, or
    ``size``): x_start (NHWC in (-1, 1)), labels and, for the training
    loss, the noise levels (EDM's lognormal)."""
    kind, _, case_size, _, _ = DISTILL_CASES[name]
    size = size or case_size
    B = 2 if size == 64 else DISTILL_BATCH
    rs = np.random.RandomState(seed)
    x = np.tanh(rs.randn(B, size, size, 3)).astype(np.float32)
    y = rs.randint(0, DISTILL_SMALL["num_classes"], B)
    sigmas = (np.exp(rs.randn(B) * 1.2 - 1.2).astype(np.float32)
              if kind == "training" else None)
    return x, y, sigmas


def tanh_batch(seed, B, size):
    """A numpy-made image batch (NHWC in (-1, 1))."""
    rs = np.random.RandomState(seed)
    return np.tanh(rs.randn(B, size, size, 3)).astype(np.float32)


def distill_diffusion(loss_norm="l2"):
    from dxmi_tpu_torch.samplers.edm import KarrasDenoiser
    return KarrasDenoiser(weight_schedule="karras", loss_norm=loss_norm)


def distill_case(gold, name, device, nets=None, size=None):
    """The port's per-sample loss of case ``name`` on its inputs
    (``distill_inputs`` of the golden's seed, at ``size`` when given) and
    the golden's JAX draws (noise, scale indices and, in training mode,
    dropout masks), the nets in ``nets`` or ``distill_net``'s; returns
    (loss tensor (B,), the online net)."""
    from dxmi_tpu_torch.trainers import distill
    kind, norm, case_size, teacher, train = DISTILL_CASES[name]
    nets = nets or {r: distill_net(case_size, r, device)
                    for r in DISTILL_ROLES}
    x, y, sigmas = (torch.from_numpy(np.asarray(a)).to(device)
                    if a is not None else None for a in
                    distill_inputs(name, int(gold[f"{name}/key"]), size))
    x = x.permute(0, 3, 1, 2).contiguous()

    def t(key):
        return torch.from_numpy(np.asarray(gold[f"{name}/{key}"])).to(device)

    masks = (golden_dropout_masks(gold, device, f"{name}/") if train
             else None)
    kw = dict(y=y, noise=t("noise"), train=train, dropout_masks=masks)
    diff = distill_diffusion(norm)
    if kind == "training":
        out = distill.training_losses(diff, nets["online"], x, sigmas, **kw)
    elif kind == "consistency":
        out = distill.consistency_losses(
            diff, nets["online"], nets["target"], x, DISTILL_SCALES,
            teacher_net=nets["teacher"] if teacher else None,
            indices=t("indices"), **kw)
    else:
        out = distill.progdist_losses(
            diff, nets["online"], x, DISTILL_SCALES,
            teacher_net=nets["teacher"], indices=t("indices"), **kw)
    return out["loss"], nets["online"]


def karras_case(gold, name, device, net=None):
    """The port's ``karras_sample`` of case ``name`` from the golden's
    initial state and noise (NCHW samples)."""
    from dxmi_tpu_torch.samplers.edm import karras_sample
    net = net or distill_net(16, "online", device)
    sampler = "heun" if name == "heun_churn" else name

    def t(key):
        return torch.from_numpy(np.asarray(gold[f"karras/{name}/{key}"])).to(
            device)

    y = np.random.RandomState(int(gold[f"karras/{name}/key"])).randint(
        0, DISTILL_SMALL["num_classes"], KARRAS_BATCH)
    return karras_sample(distill_diffusion(), net, tuple(t("x").shape),
                         KARRAS_STEPS, sampler,
                         y=torch.from_numpy(y).to(device), x=t("x"),
                         noise=t("noise"), **KARRAS_CASES[name])


def ddpm_small(device, fuse=False):
    """pretrain_ddpm's sampler at DDPM_CH with numpy-made weights, einsum
    attention and unfused convs (JAX's arithmetic), or the entry's fused
    attention and K3 (``fuse``)."""
    from dxmi_tpu_torch import pretrain_ddpm
    kw = (dict(attn_impl="fused", fuse_gn_conv=True) if fuse
          else dict(attn_impl="einsum", fuse_gn_conv=False))
    sampler = pretrain_ddpm.build(DDPM_CH, DDPM_T, torch.device(device),
                                  None, **kw)
    sampler.net.load_state_dict(numpy_state(sampler.net, DISTILL_SEED + 5))
    return sampler


def ddpm_update_replay(gold, device, fuse=False):
    """One pretrain_ddpm update of the port on the golden's batch, step
    indices, noise and JAX's dropout masks: (loss, {name: gradient norm},
    {name: update norm})."""
    from dxmi_tpu_torch import pretrain_ddpm
    from dxmi_tpu_torch.trainers.optim import Adam
    sampler = ddpm_small(device, fuse)

    def t(key):
        return torch.from_numpy(np.asarray(gold[f"ddpm/{key}"])).to(device)

    names = [n for n, _ in sampler.net.named_parameters()]
    params = [p for _, p in sampler.net.named_parameters()]
    before = [p.detach().clone() for p in params]
    x = torch.from_numpy(tanh_batch(int(gold["ddpm/key"]), DDPM_BATCH, 32))
    sampler.net.inject_dropout_masks(golden_dropout_masks(gold, device,
                                                          "ddpm/"))
    loss = pretrain_ddpm.eps_loss(sampler, x.permute(0, 3, 1, 2).to(device),
                                  t("i"), t("eps"))
    left = len(sampler.net.dropout_masks.queue)
    sampler.net.inject_dropout_masks(None)
    if left:
        raise AssertionError(f"{left} injected dropout masks not used")
    grads = torch.autograd.grad(loss, params)
    Adam(params, DDPM_LR).step(grads)
    return (float(loss.detach()),
            {n: float(g.norm()) for n, g in zip(names, grads)},
            {n: float((p.detach() - b).norm()) for n, p, b in
             zip(names, params, before)})


def ddgan_update_replay(gold, device):
    """One pretrain_ddgan update's loss of the port on the golden's small
    NCSN++ batch and draws: (loss, {name: gradient norm})."""
    from dxmi_tpu_torch import pretrain_ddgan
    net = NCSNpp(NCSNppArgs(**DDGAN_SMALL))
    net.load_state_dict(ddgan_small_state())
    net.to(device)

    def t(key):
        return torch.from_numpy(np.asarray(gold[f"ddgan/{key}"])).to(device)

    a_bar = torch.from_numpy(pretrain_ddgan.alpha_bar(DDGAN_T)).to(device)
    x = torch.from_numpy(tanh_batch(int(gold["ddgan/key"]), DISTILL_BATCH,
                                    DDGAN_SMALL["image_size"]))
    loss = pretrain_ddgan.x0_loss(net, a_bar,
                                  x.permute(0, 3, 1, 2).to(device),
                                  t("ti"), t("eps"), t("z"))
    names = [n for n, _ in net.named_parameters()]
    grads = torch.autograd.grad(loss, list(net.parameters()))
    return float(loss.detach()), {n: float(g.norm())
                                  for n, g in zip(names, grads)}


INIT_STD_REL = 0.05  # the flax initialisers' std against JAX's init_params


def init_samplers(device, generator):
    """The three samplers of the golden's ``init/`` stats, their nets drawn
    by ``models/flax_init.py`` from ``generator`` on ``device``."""
    from dxmi_tpu_torch import pretrain_ddgan, pretrain_ddpm
    from dxmi_tpu_torch.models.flax_init import flax_init_
    from dxmi_tpu_torch.models.unet_adm import UNetADM
    from dxmi_tpu_torch.samplers.edm import EDMSampler, KarrasDenoiser
    dev = torch.device(device)
    with dev:
        adm = EDMSampler(UNetADM(**DISTILL_SMALL), KarrasDenoiser(), 10,
                         (3, 16, 16), class_cond=True, num_classes=4,
                         trainable_beta="fix_last")
    flax_init_(adm.net, generator)
    return {"unet_small": pretrain_ddpm.build(DDPM_CH, 10, dev, generator),
            "unet_adm": adm,
            "ncsnpp": pretrain_ddgan.build(4, dev, generator,
                                           NCSNppArgs(**DDGAN_SMALL))}


def flax_init_check(gold, device):
    """The port's flax initialisers against the golden's stats of JAX's
    ``init_params``, per parameter: the same flax paths and shapes, the
    same shares of exact zeros and ones, the std within INIT_STD_REL (or
    four standard errors of two draws' difference, 4 / sqrt(n), for
    tensors under 6400 elements), and every lecun_normal kernel truncated
    at two of its standard deviations. Returns the worst std error as a
    share of its limit."""
    from dxmi_tpu_torch.models.flax_init import TRUNC_STD
    from dxmi_tpu_torch.utils.train_state import flax_tree
    gen = torch.Generator(device=device).manual_seed(DISTILL_SEED)
    worst = 0.0
    for kind, sampler in init_samplers(device, gen).items():
        flat = {}

        def walk(node, prefix):
            for k, v in node.items():
                if isinstance(v, dict):
                    walk(v, prefix + (k,))
                else:
                    flat["/".join(prefix + (k,))] = v
        walk(flax_tree(sampler), ())
        paths = [str(p) for p in gold[f"init/{kind}/paths"]]
        if sorted(paths) != sorted(flat):
            raise AssertionError(f"{kind}: the parameters differ from "
                                 f"JAX's: {sorted(set(paths) ^ set(flat))}")
        for path, shape, (std, zeros, ones, top) in zip(
                paths, gold[f"init/{kind}/shapes"],
                gold[f"init/{kind}/stats"]):
            a = flat[path].astype(np.float64)
            if a.shape != tuple(int(n) for n in shape if n >= 0):
                raise AssertionError(f"{kind} {path}: shape {a.shape}")
            if (a == 0).mean() != zeros or (a == 1).mean() != ones:
                raise AssertionError(f"{kind} {path}: zeros or ones differ "
                                     "from JAX's")
            if std > 0:
                lim = max(INIT_STD_REL, 4 / np.sqrt(a.size))
                err = abs(a.std() / std - 1)
                if err > lim:
                    raise AssertionError(f"{kind} {path}: std {a.std():.4g} "
                                         f"vs JAX's {std:.4g}")
                worst = max(worst, err / lim)
            if path.endswith("kernel") and std > 0:
                bound = 2 * np.sqrt(1.0 / np.prod(a.shape[:-1])) / TRUNC_STD
                if max(np.abs(a).max(), top) > bound * (1 + 1e-6):
                    raise AssertionError(f"{kind} {path}: not truncated at "
                                         "two standard deviations")
    return worst


def distill_golden_check(gold, device):
    """G10's gates on ``device``: each loss within G10_LOSS_REL of JAX's,
    each sample within G10_SAMPLE, or KARRAS_NUDGE_FACTOR times JAX's
    recorded nudged move where larger; the pretrain_ddpm and
    pretrain_ddgan updates' losses within G10_LOSS_REL, their gradient (and
    ddpm's update) norms read; the flax initialisers against JAX's
    (``flax_init_check``). Returns the readings (each sample's as a share
    of the fp32 limit, and JAX's move under ``karras_move/``)."""
    worst = {}
    for name in DISTILL_CASES:
        got = distill_case(gold, name, device)[0].detach().cpu().numpy()
        want = gold[f"{name}/loss"]
        rel = float(np.abs(got - want).max() / np.abs(want).max())
        if not np.isfinite(got).all() or rel > G10_LOSS_REL:
            raise AssertionError(f"G10 {name}: loss {got} vs JAX {want}")
        worst[name] = rel
    net = distill_net(16, "online", device)
    for name in KARRAS_CASES:
        got = karras_case(gold, name, device, net).cpu().numpy()
        want = gold[f"karras/{name}/out"]
        lim = G10_SAMPLE[0] + G10_SAMPLE[1] * np.abs(want)
        share = float((np.abs(got - want) / lim).max())
        moved = float((gold[f"karras/{name}/move"] / lim).max())
        allowed = max(1.0, KARRAS_NUDGE_FACTOR * moved)
        worst[f"karras_move/{name}"] = moved
        if not np.isfinite(got).all() or share > allowed:
            raise AssertionError(f"G10 karras {name}: {share:.2f} of the "
                                 f"fp32 limit (allowed {allowed:.2f})")
        worst[f"karras/{name}"] = share
    loss, gn, un = ddpm_update_replay(gold, device)
    rel = abs(loss - float(gold["ddpm/loss"])) / float(gold["ddpm/loss"])
    if rel > G10_LOSS_REL:
        raise AssertionError(f"G10 pretrain_ddpm loss {loss} vs JAX "
                             f"{float(gold['ddpm/loss'])}")
    worst["ddpm/loss"] = rel
    for what, got, key in (("grad", gn, "gnorm/"), ("update", un, "unorm/")):
        a = np.array([got[n] for n in sorted(got)])
        b = np.array([gold[f"ddpm/{key}{n}"] for n in sorted(got)])
        worst[f"ddpm/{what}"] = float(np.linalg.norm(a - b)
                                      / np.linalg.norm(b))
    loss, gn = ddgan_update_replay(gold, device)
    rel = abs(loss - float(gold["ddgan/loss"])) / float(gold["ddgan/loss"])
    if rel > G10_LOSS_REL:
        raise AssertionError(f"G10 pretrain_ddgan loss {loss} vs JAX "
                             f"{float(gold['ddgan/loss'])}")
    worst["ddgan/loss"] = rel
    a = np.array([gn[n] for n in sorted(gn)])
    b = np.array([gold[f"ddgan/gnorm/{n}"] for n in sorted(gn)])
    worst["ddgan/grad"] = float(np.linalg.norm(a - b) / np.linalg.norm(b))
    worst["init"] = flax_init_check(gold, device)
    return worst


def phase_replay_distill():
    """G10 (see above)."""
    gold = dict(np.load(DISTILL_GOLDEN))
    worst = distill_golden_check(gold, "cuda")
    losses = max(v for k, v in worst.items() if k in DISTILL_CASES)
    samples = {k[7:]: round(v, 3) for k, v in worst.items()
               if k.startswith("karras/")}
    nudges = {k[12:]: round(v, 3) for k, v in worst.items()
              if k.startswith("karras_move/")}
    print(f"  G10: {len(DISTILL_CASES)} losses, worst {losses:.2e} "
          f"relative (gate {G10_LOSS_REL:g}); karras_sample against JAX, "
          f"in fp32 limits: {samples}; two nudges of the initial state by "
          f"2^-22 of itself move JAX's by {nudges} (golden); "
          f"pretrain_ddpm update: loss {worst['ddpm/loss']:.2e} relative, "
          f"gradient norms {worst['ddpm/grad']:.2e} and update norms "
          f"{worst['ddpm/update']:.2e} from JAX's (read); pretrain_ddgan "
          f"update: loss {worst['ddgan/loss']:.2e}, gradient norms "
          f"{worst['ddgan/grad']:.2e} (read); flax initialisers on the card's "
          f"generator: worst std {worst['init']:.2f} of its limit",
          flush=True)
    return worst


# E12: the ImageNet64 T10 net (bf16, flash: K1, K4 and its backward) through
# one Adam step of each distillation loss at batch 16 and karras_sample's
# seven solvers for 10 steps, each loss, the dsm step's gradients and each
# solver's 10 steps then held against the plain versions at the path's own
# batch of 16 (K4-dkv/dq's shape in the step): at 10 samples, E8's count,
# cuDNN runs the T10 net's fp32 convs on its FFT route, ~116k complex GEMM
# launches and ~1.0 s a forward on the H100 against ~0.3 s at 16, which
# made the fp32 references most of E12's time; the three pretraining
# entries run as subprocesses in C's pool, 3 steps each, at full width
E12_BATCH, E12_SCALES, E12_SOLVER_STEPS, E12_STEPS = 16, 40, 10, 3
E12_LR, E12_EMA = 2e-4, 0.95
# forwards a step of each loss makes (online, teachers, target); one backward
E12_FORWARDS = {"dsm": 1, "cd": 4, "ct": 2, "pd": 3}
# forwards of each solver over 10 steps (heun and dpm skip their second
# evaluation on the last step, to sigma 0)
E12_SOLVER_FORWARDS = {"onestep": 1, "heun": 19, "euler": 10,
                       "ancestral": 10, "dpm": 19, "multistep": 10,
                       "progdist": 10}
E12_DIR = os.path.join(REPO, "build", "chip_smoke_e12")


def flash_time_row(gen, B, S, nh, d):
    """T row of K4's forward at (B, S, nh, d) bf16; library yardstick:
    F.scaled_dot_product_attention."""
    q, k, v, sm = flash_case(gen, B, S, nh, d)
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    return dict(
        shape=(B, S, nh, d), ms=time_ms(lambda: flash_fwd_kernel(q, k, v, sm)),
        plain_ms=time_ms(lambda: flash_mha_reference(q, k, v, sm), iters=3,
                         warmup=1),
        library_ms=time_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, scale=sm)),
        bytes=4 * B * S * nh * d * 2,
        ops={"bf16": 4 * B * nh * S * S * d, "fp32": 5 * B * nh * S * S})


def e12_time_rows(gen):
    """T rows of K4 and K4-dkv/dq at E12's (and pretrain_edm's) ImageNet64
    training shape, batch 16 (the 32x32 map: 6 heads of 64)."""
    rows = {"flash_attn_e12": flash_time_row(gen, E12_BATCH, 1024, 6, 64)}
    rows.update(flash_bwd_time_rows(gen, E12_BATCH, 1024, 6, 64, "_e12"))
    return rows


def e12_launches(forwards, backwards):
    per = ADM_LAUNCHES_PER_FORWARD["flash"]
    out = {k: v * forwards for k, v in per.items()}
    if backwards:
        out.update(flash_attn_bwd_dkv=7 * backwards,
                   flash_attn_bwd_dq=7 * backwards)
    return out


@contextlib.contextmanager
def compute_dtype(nets, dtype):
    """The UNetADMs ``nets`` computing in ``dtype`` (their fp32 parameters
    cast where used), for the fp32 references of the bf16 effect."""
    old = [n.dtype for n in nets]
    for n in nets:
        n.dtype = dtype
    try:
        yield
    finally:
        for n, d in zip(nets, old):
            n.dtype = d


def e12_loss(kind, nets, diff, x, y, draws):
    """The per-sample loss of ``kind`` (E12_FORWARDS) in training mode with
    the draws given (noise, and the scale indices or sigmas)."""
    from dxmi_tpu_torch.trainers import distill
    kw = dict(y=y, noise=draws["noise"], train=True)
    if kind == "dsm":
        return distill.training_losses(diff, nets["online"], x,
                                       draws["sigmas"], **kw)["loss"]
    if kind == "pd":
        return distill.progdist_losses(diff, nets["online"], x, E12_SCALES,
                                       teacher_net=nets["teacher"],
                                       indices=draws["indices"],
                                       **kw)["loss"]
    return distill.consistency_losses(
        diff, nets["online"], nets["target"], x, E12_SCALES,
        teacher_net=nets["teacher"] if kind == "cd" else None,
        indices=draws["indices"], **kw)["loss"]


def e12_draws(kind, n, gen=None, rs=None):
    """A loss's draws at batch ``n``: from the card's generator ``gen``,
    or from numpy's ``rs`` (the plain-version check)."""
    shape = (n, 3, 64, 64)
    if rs is not None:
        noise = torch.from_numpy(rs.randn(*shape).astype(np.float32)).cuda()
        u = rs.randn(n).astype(np.float32)
        idx = rs.randint(0, E12_SCALES - 1, n)
        sig, idx = torch.from_numpy(u).cuda(), torch.from_numpy(idx).cuda()
    else:
        noise = torch.randn(shape, generator=gen, device="cuda")
        sig = torch.randn((n,), generator=gen, device="cuda")
        idx = torch.randint(0, E12_SCALES - 1, (n,), generator=gen,
                            device="cuda")
    return {"noise": noise, "sigmas": torch.exp(sig * 1.2 - 1.2),
            "indices": idx}


@contextlib.contextmanager
def plain_fp32(*nets):
    """The plain versions with the UNetADMs ``nets`` computing in fp32: the
    reference that the bf16 effect is read against."""
    with plain_kernels_adm(), compute_dtype(nets, torch.float32):
        yield


def e12_grad_shares(nets, diff, images, labels, rs):
    """(mean, largest) share of the bf16 effect by which the dsm step's
    gradient norms (one per parameter of the online net) move from the
    plain versions', at batch E12_BATCH on numpy draws: the backward
    through K1 and K4-dkv/dq at the step's shapes."""
    idx = rs.randint(0, len(images), E12_BATCH)
    x = torch.from_numpy(images[idx].transpose(0, 3, 1, 2).copy()).cuda()
    y = torch.from_numpy(labels[idx].astype(np.int64)).cuda()
    draws = e12_draws("dsm", E12_BATCH, rs=rs)
    params = list(nets["online"].parameters())

    def norms():
        loss = e12_loss("dsm", nets, diff, x, y, draws).mean()
        grads = torch.autograd.grad(loss, params)
        return torch.stack([g.float().norm() for g in grads])

    out = norms()
    with plain_kernels_adm():
        plain = norms()
    with plain_fp32(*nets.values()):
        full = norms()
    return bf16_share(out, plain, full)


def bf16_share(out, plain, full):
    """(mean, largest) of |out - plain| as shares of the bf16 effect
    |plain - full|."""
    err, eff = (out - plain).abs(), (plain - full).abs()
    return ((err.mean() / eff.mean()).item(),
            (err.max() / eff.max()).item())


def phase_pretrain_distill(k1_log):
    """E12 (see above): the distillation steps and the solvers; their
    launches by step and solver (K1's by shape of the dsm step, the
    pretrain_edm step, into ``k1_log`` for T-K1)."""
    import copy

    from dxmi_tpu_torch.samplers.edm import karras_sample
    from dxmi_tpu_torch.trainers.optim import Adam
    from dxmi_tpu_torch.trainers.pretrain import adam_step
    from dxmi_tpu_torch.utils.ema import update_ema
    t_phase = time.perf_counter()
    cfg = imagenet64_train_config()
    seed = int(cfg["training"]["seed"])
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    sampler = train_image_large.build_sampler(cfg, torch.device("cuda"),
                                              seed)
    diff = sampler.diffusion
    nets = {"online": sampler.net, "teacher": copy.deepcopy(sampler.net),
            "target": copy.deepcopy(sampler.net)}
    for role in ("teacher", "target"):
        nets[role].requires_grad_(False)
    opt = Adam(list(sampler.net.parameters()), E12_LR)
    images, labels = structured_class_images(256, 64, 1000, seed=seed)
    rs = np.random.RandomState(seed)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    launches = {}
    torch.cuda.synchronize()
    print(f"  E12 build: {time.perf_counter() - t_phase:.1f} s", flush=True)
    for kind, fwd in E12_FORWARDS.items():
        idx = rs.randint(0, len(images), E12_BATCH)
        x = torch.from_numpy(images[idx].transpose(0, 3, 1, 2).copy()).cuda()
        y = torch.from_numpy(labels[idx].astype(np.int64)).cuda()
        draws = e12_draws(kind, E12_BATCH, gen)
        _lib.reset_launches()
        t0 = time.perf_counter()
        with (k1_shapes(k1_log, "E12", 1, "step") if kind == "dsm"
              else contextlib.nullcontext()):
            loss = e12_loss(kind, nets, diff, x, y, draws).mean()
            adam_step(opt, loss)
        if kind == "cd":
            update_ema(nets["target"], sampler.net, E12_EMA)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = dict(_lib.LAUNCHES)
        want = e12_launches(fwd, 1)
        if got != want:
            raise AssertionError(f"E12 {kind}: launches {got}, expected "
                                 f"{want}")
        if not torch.isfinite(loss):
            raise AssertionError(f"E12 {kind}: loss {loss}")
        launches[kind] = got
        print(f"  E12 {kind} step at batch {E12_BATCH}: {wall:.3f} s, loss "
              f"{float(loss):.4f}, launches {got}", flush=True)

    n = E12_BATCH
    rs = np.random.RandomState(seed + 1)
    idx = rs.randint(0, len(images), n)
    x = torch.from_numpy(images[idx].transpose(0, 3, 1, 2).copy()).cuda()
    y = torch.from_numpy(labels[idx].astype(np.int64)).cuda()
    worst = {}
    t_check = time.perf_counter()
    with torch.no_grad():
        for kind in E12_FORWARDS:
            draws = e12_draws(kind, n, rs=rs)
            out = e12_loss(kind, nets, diff, x, y, draws)
            with plain_kernels_adm():
                plain = e12_loss(kind, nets, diff, x, y, draws)
            with plain_fp32(*nets.values()):
                full = e12_loss(kind, nets, diff, x, y, draws)
            worst[kind] = bf16_share(out, plain, full)
        torch.cuda.synchronize()
        print(f"  E12 the losses' plain-version checks: "
              f"{time.perf_counter() - t_check:.1f} s", flush=True)
    t_check = time.perf_counter()
    worst["dsm_grad"] = e12_grad_shares(nets, diff, images, labels, rs)
    torch.cuda.synchronize()
    print(f"  E12 the dsm step's gradient norms at batch {E12_BATCH} "
          f"against the plain versions ({time.perf_counter() - t_check:.1f}"
          f" s): {worst['dsm_grad'][0]:.3f} (mean) and "
          f"{worst['dsm_grad'][1]:.3f} (largest) of the bf16 effect",
          flush=True)
    with torch.no_grad():
        for solver, fwd in E12_SOLVER_FORWARDS.items():
            t_solver = time.perf_counter()
            _lib.reset_launches()
            t0 = time.perf_counter()
            s = karras_sample(diff, sampler.net, (E12_BATCH, 3, 64, 64),
                              E12_SOLVER_STEPS, solver,
                              y=torch.from_numpy(rs.randint(
                                  0, 1000, E12_BATCH)).cuda(),
                              generator=gen)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            got = dict(_lib.LAUNCHES)
            if got != e12_launches(fwd, 0) or not torch.isfinite(s).all():
                raise AssertionError(f"E12 karras_sample {solver}: launches "
                                     f"{got}, expected "
                                     f"{e12_launches(fwd, 0)}")
            launches[solver] = got
            x0 = torch.from_numpy(rs.randn(n, 3, 64, 64).astype(
                np.float32) * 80.0).cuda()
            noise = torch.from_numpy(rs.randn(
                E12_SOLVER_STEPS, n, 3, 64, 64).astype(np.float32)).cuda()
            kw = dict(y=y, x=x0, noise=noise)
            runs = {}
            for what, ctx in (("kernels", contextlib.nullcontext),
                              ("plain", plain_kernels_adm),
                              ("fp32", lambda: plain_fp32(sampler.net))):
                t0 = time.perf_counter()
                with ctx():
                    runs[what] = karras_sample(diff, sampler.net, x0.shape,
                                               E12_SOLVER_STEPS, solver,
                                               **kw)
                torch.cuda.synchronize()
                runs[what + "_s"] = time.perf_counter() - t0
            worst[solver] = bf16_share(runs["kernels"], runs["plain"],
                                       runs["fp32"])
            print(f"  E12 karras_sample {solver} "
                  f"({time.perf_counter() - t_solver:.1f} s): {E12_BATCH} x "
                  f"{E12_SOLVER_STEPS} steps in {secs:.3f} s "
                  f"({E12_BATCH / secs:.1f} img/s), {fwd} forwards, "
                  f"launches {got}; at {n} samples against the plain "
                  f"versions {worst[solver][0]:.3f} (mean) and "
                  f"{worst[solver][1]:.3f} (largest) of the bf16 effect "
                  f"(kernels {runs['kernels_s']:.2f} s, plain "
                  f"{runs['plain_s']:.2f} s, fp32 {runs['fp32_s']:.2f} s)",
                  flush=True)
    for kind in E12_FORWARDS:
        print(f"  E12 {kind} loss at {n} samples against the plain versions:"
              f" {worst[kind][0]:.3f} (mean) and {worst[kind][1]:.3f} "
              f"(largest) of the bf16 effect", flush=True)
    bad = {k: v for k, v in worst.items() if max(v) > BF16_REPLAY_SHARE}
    if bad:
        raise AssertionError(f"E12: {bad} of the bf16 effect from the plain "
                             f"versions (limit {BF16_REPLAY_SHARE:g})")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"  E12: {time.perf_counter() - t_phase:.1f} s, peak allocated "
          f"{peak:.2f} GiB", flush=True)
    del sampler, nets, opt
    torch.cuda.empty_cache()
    return launches


# the entries as a user runs them, at full width, 3 steps each
E12_ENTRIES = {
    "pretrain_ddpm": ["--fake_data", "--batch", "128"],
    "pretrain_ddgan": ["--fake_data", "--batch", "128"],
    "pretrain_edm": ["--config", IMAGENET64_CONFIG, "--batch", "16"],
}


def e12_entry(name):
    """One pretraining entry in a subprocess (phase C's pool): (its
    output's lines, its file, its seconds)."""
    os.makedirs(E12_DIR, exist_ok=True)
    out = os.path.join(E12_DIR, f"{name}.msgpack")
    cmd = [sys.executable, "-m", f"dxmi_tpu_torch.{name}", "--out", out,
           "--steps", str(E12_STEPS), "--log_every", "1",
           *E12_ENTRIES[name]]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=E12_DIR, capture_output=True, text=True,
                          timeout=600, env=dict(os.environ, PYTHONPATH=REPO))
    if proc.returncode != 0:
        raise AssertionError(f"{name} failed:\n{proc.stdout}{proc.stderr}")
    return proc.stdout.splitlines(), out, time.perf_counter() - t0


def entry_timing(lines, name):
    """(s/step after the first, peak GiB, launches over the run) from the
    entry's timing line."""
    line = [ln for ln in lines if ln.startswith("pretrain timing:")]
    if len(line) != 1:
        raise AssertionError(f"{name}: no timing line")
    text = line[0]
    rate = float(text.split(" s/step")[0].rsplit(", ", 1)[1])
    peak = float(text.split("peak allocated ")[1].split(" GiB")[0])
    return rate, peak, json.loads(text.split(f"over {E12_STEPS} steps ")[1])


def e12_entries(runs):
    """The entries' runs (``e12_entry``'s results by name, from C's pool):
    JAX's log lines, finite losses, the kernels' launches per step; each
    file loaded into the port's training entry bit for bit:
    train_cifar10's build on T10.yaml and T4_ddgan.yaml,
    train_image_large's build_sampler on T10.yaml."""
    from dxmi_tpu_torch.utils.train_state import flax_tree
    tags = {"pretrain_ddpm": "eps-loss", "pretrain_ddgan": "x0-mse",
            "pretrain_edm": "edm-loss"}
    want = {"pretrain_ddpm": ("gn_silu", "gn_silu_conv3x3", "attn_block"),
            "pretrain_ddgan": ("gn_silu",),
            "pretrain_edm": ("gn_silu_bf16", "flash_attn",
                             "flash_attn_bwd_dkv", "flash_attn_bwd_dq")}
    out = {}
    for name, (lines, path, wall) in runs.items():
        losses = [float(ln.split()[-1]) for ln in lines if tags[name] in ln]
        if len(losses) != E12_STEPS or not np.isfinite(losses).all():
            raise AssertionError(f"{name}: losses {losses}")
        rate, peak, got = entry_timing(lines, name)
        if sorted(got) != sorted(want[name]) or any(
                v % E12_STEPS for v in got.values()):
            raise AssertionError(f"{name}: launches {got}")
        per = {k: v // E12_STEPS for k, v in got.items()}
        out[name] = per
        if name == "pretrain_edm":
            cfg = merge(imagenet64_train_config(),
                        {"training": {"pretrained_path": path}})
            sampler = train_image_large.build_sampler(
                cfg, torch.device("cuda"), 0)
        else:
            cfg = (cifar10_train_config() if name == "pretrain_ddpm"
                   else t4_ddgan_config())
            cfg = merge(cfg, {"training": {"sampler_ckpt": path}})
            sampler = train_cifar10.build(cfg, torch.device("cuda"), 0)[0]
        stored = port_msgpack.read(path)
        if stored["meta"] != {"pretrain_steps": E12_STEPS}:
            raise AssertionError(f"{name}: meta {stored['meta']}")
        got_tree = flax_tree(sampler)

        def same(a, b):
            if isinstance(b, dict):
                return a.keys() == b.keys() and all(same(a[k], b[k])
                                                    for k in b)
            return np.array_equal(np.asarray(a), np.asarray(b))
        if not same(got_tree, stored["params"]):
            raise AssertionError(f"{name}: the file does not load bit for "
                                 "bit into the training entry")
        del sampler
        torch.cuda.empty_cache()
        print(f"  C {name} (E12's entries): {losses[0]:.4f} -> "
              f"{losses[-1]:.4f}; {rate:.4f} s/step after the first (C's "
              f"other subprocesses sharing the card), peak allocated "
              f"{peak:.2f} GiB, launches per step {per}; {wall:.1f} s in its "
              f"process; its file loads into the training entry bit for bit",
              flush=True)
    return out


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
    k1_log = {}  # K1's launches by shape in E-int8, E2, E3, E5, E4, for T-K1
    rates = {}  # img/s of E and E-int8's paths
    k3_log = {}  # K3's launches by shape in E, E4 and E11, for T-K3
    k2_log = {}  # K2 fp32's launches by shape in E11

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
        step("G5", phase_replay_edm16)
        step("E5", lambda: phase_conv16_train(k1_log))
        step("G4", phase_cifar_train_replay)
        step("E4", lambda: phase_cifar_train(k1_log, k3_log))
        step("E4-levers", phase_cifar_train_levers)
        step("G6", phase_replay_ddgan)
        step("G7", phase_train_replay_ddgan)
        step("E6", lambda: phase_generate_ddgan(k1_log, rates))
        step("E7", lambda: phase_ddgan_train(k1_log))
        step("G8", phase_replay_lsun)
        step("E8", lambda: phase_generate_lsun(k1_log, rates))
        step("E9", lambda: phase_lsun_train(k1_log))
        step("E10", phase_guidance)
        step("G9", phase_replay_ev)
        step("E11", lambda: phase_anomaly(k1_log, k3_log, k2_log))
        step("G10", phase_replay_distill)
        step("E12", lambda: phase_pretrain_distill(k1_log))
        step("T-K1", lambda: k1_shape_table(gen, k1_log))
        step("T-K3", lambda: k3_shape_table(gen, k3_log))
        step("C", phase_cli)
        step("F", phase_fid)
        smi = nvidia_smi()
    except PhaseError as e:
        print(str(e), file=sys.stderr, flush=True)
        return 1
    if only is not None:  # a partial run: no record of the kernels
        print(smi)
        return 0
    errs, times, train, cifar = res["K"], res["T"], res["E3"], res["E4"]
    for name, err in res["T-K1"].items():  # K1 at the main paths' shapes
        errs[name] = max(errs[name], err)
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
                        "attn_block_bb_bf16"],
                    attn_block_bwd_small=res["E5"]["fused_train"][
                        "attn_block_bwd_small"],
                    gn_silu_ncsnpp=res["E6"]["fp32"]["gn_silu"],
                    gn_silu_bf16_ncsnpp=res["E6"]["bf16"]["gn_silu_bf16"],
                    int8_conv_ncsnpp=res["E6"]["int8"]["int8_conv"],
                    gn_silu_bf16_lsun=res["E8"]["fused"]["gn_silu_bf16"],
                    attn_block_bf16_lsun=res["E8"]["fused"][
                        "attn_block_bf16"],
                    attn_block_i8_lsun=res["E8"]["int8"]["attn_block_i8"],
                    flash_attn_lsun=res["E8"]["flash"]["flash_attn"],
                    flash_attn_bwd_dkv_lsun=res["E9"]["flash_attn_bwd_dkv"],
                    flash_attn_bwd_dq_lsun=res["E9"]["flash_attn_bwd_dq"],
                    int8_conv_lsun=res["E8"]["int8"]["int8_conv"],
                    **anomaly_launches(k1_log, k3_log, k2_log))
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
