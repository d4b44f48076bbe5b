"""``train_cifar10 --fast_levers``: one ``DxMITrainer`` iteration of the port
under the levers (sampler net in bf16 with the bf16 max-free softmax, the
phase upsample and bf16_onepass statistics; value torso in bf16) on the
trained CIFAR fixture against the JAX package's
(tests/torch_fixtures/cifar_levers_golden.npz, rebuilt by
make_cifar_levers_golden.py), with JAX's trajectory, permutation, noise and
dropout masks replayed; the overrides the entry applies; the CLI.

The gates (``LEVERS``), each with its reading on the CPU:
- the metrics: each vector within 5e-2 of its largest |value| (2.0e-2 at
  most, ``ebm/v_loss_``, a small difference of two bf16 values) and the
  median over the vectors within 2e-3 (2.6e-4);
- the value update (one Adam step on the bf16 torso's gradient): the
  median of the tensors' update norms within 1.5e-3 relative (5.2e-4), the
  projections on fixed directions within 4e-2 in l2 (1.8e-2);
- the sampler update: the median of its tensors' update norms within 2e-3
  (2.6e-4); its projections within 0.5 in l2 (0.19-0.29): Adam's first
  step moves each element by the rate times the sign of its gradient, and
  bf16 noise flips the sign of the elements whose gradient is near 0;
- log_betas within 1e-5 (0 measured).
The port's fp32 iteration (no levers) reads 1.53 and 1.3e-2 on the metrics,
2.9e-3 and 6.7e-2 on the value update, so the gates see levers left off.
Einsum unfused is the JAX entry's own arithmetic; the fused defaults (K3's
and K2's plain versions in bf16) read the same but for the sampler
projections (0.19-0.22), under the same gates. The launch tables that
chip_smoke.py checks in E-bf16 and E4-levers are counted here from the
full-width net."""
import os
import subprocess

import numpy as np
import pytest
import torch

import chip_smoke
from dxmi_tpu_torch import train_cifar10
from dxmi_tpu_torch.config import instantiate
from dxmi_tpu_torch.generate_cifar10 import generate, to_uint8
from dxmi_tpu_torch.models import unet_small
from dxmi_tpu_torch.ops.attn_block import resolve_block_b
from dxmi_tpu_torch.utils.checkpoint import load_sampler_state
from torch_fixtures import make_cifar_levers_golden

LEVERS = dict(metric_max=5e-2, metric_median=2e-3, v_norm_median=1.5e-3,
              v_proj=4e-2, s_norm_median=2e-3, s_proj=0.5, log_betas=1e-5)


@pytest.fixture(scope="module")
def golden():
    return dict(np.load(make_cifar_levers_golden.GOLDEN))


def readings(port, golden):
    """The gates' readings of a replay (``chip_smoke.cifar_train_replay``)
    against the golden."""
    ms = [k for k in golden if k.startswith("metric/")
          and k != "metric/per_step/t"]
    mrel = [np.abs(port[k] - golden[k]).max() / np.abs(golden[k]).max()
            for k in ms]
    out = {"metric_max": max(mrel), "metric_median": np.median(mrel),
           "log_betas": np.abs(port["log_betas"]
                               - golden["log_betas"]).max()}
    for tag in ("v", "s"):
        norms = [k for k in golden if k.startswith(f"{tag}norm/")]
        out[f"{tag}_norm_median"] = np.median(
            [abs(port[k] - golden[k]) / abs(golden[k]) for k in norms])
        proj = [k for k in golden if k.startswith(f"{tag}proj/")]
        out[f"{tag}_proj"] = np.sqrt(
            sum((port[k] - golden[k]) ** 2 for k in proj)
            / sum(golden[k] ** 2 for k in proj))
    return out


@pytest.mark.parametrize("impl,fuse", [("einsum", False), ("fused", True)])
def test_levers_iteration_matches_jax(golden, impl, fuse):
    port = chip_smoke.cifar_train_replay(golden, "cpu", impl, fuse,
                                         levers=True)
    got = readings(port, golden)
    over = {k: v for k, v in got.items() if v > LEVERS[k]}
    assert not over, (over, got)
    assert port["nan_guard_skips"] == 0


def test_levers_gates_see_an_fp32_iteration(golden):
    port = chip_smoke.cifar_train_replay(golden, "cpu", "einsum", False)
    got = readings(port, golden)
    assert got["metric_max"] > LEVERS["metric_max"]
    assert got["metric_median"] > LEVERS["metric_median"]
    assert got["v_norm_median"] > LEVERS["v_norm_median"]


def test_levers_build(monkeypatch):
    """``build(..., levers=True)`` applies JAX's overrides
    (``train_cifar10.py:164-174``): every layer of the sampler net in bf16
    with the max-free bf16 softmax, the phase upsample and bf16_onepass
    GroupNorm statistics, the value torso in bf16, parameters fp32, and 64
    samples a sampling chunk at batch 128 (32 without the levers);
    DXMI_TRAIN_LEVERS=1 turns them on as the flag does."""
    cfg = chip_smoke.cifar10_train_config()
    cfg["sampler_net"].update(ch=32, ch_mult=[1, 2], num_res_blocks=1,
                              attn_resolutions=[16])
    cfg["value"]["net"]["nh"] = 16
    sampler, value, trainer = train_cifar10.build(cfg, torch.device("cpu"),
                                                  0, levers=True)
    net = sampler.net
    assert net.dtype == torch.bfloat16 and value.net.dtype == torch.bfloat16
    attn = [m for m in net.modules() if type(m).__name__ == "AttnBlock"]
    assert attn and all(not m.softmax_f32 and m.softmax_nomax
                        for m in attn)
    assert all(m.phase for m in net.modules()
               if type(m).__name__ == "Upsample")
    assert all(m.gn_stats == "bf16_onepass" for m in net.modules()
               if type(m).__name__ == "GroupNorm32")
    assert all(p.dtype == torch.float32 for p in [*sampler.parameters(),
                                                  *value.parameters()])
    assert trainer.sample_chunks == 128 // train_cifar10.LEVER_SAMPLE_CHUNK
    _, value, trainer = train_cifar10.build(cfg, torch.device("cpu"), 0)
    assert value.net.dtype == torch.float32
    assert trainer.sample_chunks == 128 // train_cifar10.SAMPLE_CHUNK
    assert not train_cifar10.levers_on(False)
    monkeypatch.setenv("DXMI_TRAIN_LEVERS", "1")
    assert train_cifar10.levers_on(False)


def test_fast_levers_cli_then_generate_bf16(tmp_path):
    """train_cifar10 --fast_levers --fake_data --device cpu for 2 steps at
    chip_smoke's shrunken config, then generate_cifar10 --dtype bf16 on the
    run dir it writes: finite losses, and the in-process bf16 samples of the
    saved sampler within one uint8 level."""
    train, gen, log_dir = chip_smoke.cifar_train_cli_commands("levers",
                                                              device="cpu")
    env = dict(os.environ, PYTHONPATH=chip_smoke.REPO, OMP_NUM_THREADS="2")
    proc = subprocess.run(train + ["--fast_levers"], cwd=tmp_path,
                          capture_output=True, text=True, timeout=600,
                          env=env)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "fast_levers:" in proc.stdout
    iters = [line for line in proc.stdout.splitlines()
             if line.startswith("iter ")]
    assert len(iters) == 2 and "nan" not in " ".join(iters)
    proc = subprocess.run(gen + ["--dtype", "bf16"], cwd=tmp_path,
                          capture_output=True, text=True, timeout=300,
                          env=env)
    assert proc.returncode == 0, proc.stderr[-3000:]
    got = np.load(tmp_path / log_dir / "samples.npz")["arr_0"]
    run = tmp_path / log_dir
    state = load_sampler_state(str(run / "sampler_last.pth"))
    cfg = chip_smoke.load_yaml(str(run / "config.yaml"))
    want = to_uint8(generate(cfg, state, 8, 8, "cpu", dtype="bf16"))
    assert got.shape == want.shape == (8, 32, 32, 3)
    assert np.abs(got.astype(np.int16) - want).max() <= 1


def _bf16_launches(monkeypatch, net, B, train):
    """The kernel launches of one forward at batch ``B``, counted on the
    meta device under the names the wrappers count them by on the card."""
    counts = {}

    def count(name):
        counts[name] = counts.get(name, 0) + 1

    def gn(x, *a, **kw):
        count("gn_silu_bf16" if x.dtype == torch.bfloat16 else "gn_silu")
        return torch.empty_like(x)

    def conv(x, gs, gb, k, b, *a):
        count("gn_silu_conv3x3_bf16" if x.dtype == torch.bfloat16
              else "gn_silu_conv3x3")
        return torch.empty(*x.shape[:3], k.shape[-1], dtype=x.dtype,
                           device=x.device)

    def attn(x, *a, block_b=None, **kw):
        Bx, S, C = x.shape
        bf16 = x.dtype == torch.bfloat16
        if resolve_block_b(Bx, S, C, block_b) > 1:
            count("attn_block_bb_bf16" if bf16 else "attn_block_bb")
        else:
            count(("attn_block_bf16_d256" if C > 128 else "attn_block_bf16")
                  if bf16 else "attn_block")
        return torch.empty_like(x)

    monkeypatch.setattr(unet_small, "group_norm", gn)
    monkeypatch.setattr(unet_small, "gn_silu_conv", conv)
    monkeypatch.setattr(unet_small, "attn_block", attn)
    net.train(train)
    with torch.no_grad():
        net(torch.empty(B, 3, 32, 32, device="meta"),
            torch.empty(B, device="meta"))
    return counts


def test_e_bf16_launch_table(monkeypatch):
    """chip_smoke.BF16_LAUNCHES_PER_FORWARD: generate_cifar10 --dtype bf16's
    full-width net (configs/cifar10/T10.yaml) at batch 100."""
    cfg = chip_smoke.cifar10_t10()
    with torch.device("meta"):
        net = instantiate(cfg["sampler_net"], dtype=torch.bfloat16)
    assert (_bf16_launches(monkeypatch, net, chip_smoke.BATCH, False)
            == chip_smoke.BF16_LAUNCHES_PER_FORWARD)


@pytest.mark.parametrize("bb", [1, 4])
def test_e4_levers_launch_table(monkeypatch, bb):
    """chip_smoke.E4_LEVERS_LAUNCHES_PER_STEP from the full-width net under
    the levers: E4_LEVERS_SAMPLE_FORWARDS eval forwards at the sampling
    chunk's 64 and one training-mode forward at the minibatch's 128, under
    DXMI_FUSED_ATTN_BB=bb."""
    monkeypatch.setenv("DXMI_FUSED_ATTN_BB", str(bb))
    cfg = chip_smoke.cifar10_train_config()
    with torch.device("meta"):
        net = instantiate(cfg["sampler_net"], **train_cifar10.LEVER_NET)
    fwd = _bf16_launches(monkeypatch, net, chip_smoke.LEVERS_CHUNK, False)
    trn = _bf16_launches(monkeypatch, net, chip_smoke.E4_BATCH, True)
    assert cfg["training"]["batchsize"] == chip_smoke.E4_BATCH
    assert chip_smoke.E4_BATCH // chip_smoke.LEVERS_CHUNK * 10 \
        == chip_smoke.E4_LEVERS_SAMPLE_FORWARDS
    want = {k: v * chip_smoke.E4_LEVERS_SAMPLE_FORWARDS + trn.get(k, 0)
            for k, v in fwd.items()}
    assert want == chip_smoke.E4_LEVERS_LAUNCHES_PER_STEP[bb]
