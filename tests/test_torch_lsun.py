"""The LSUN-Bedroom 256 T=4 slice's sampler on the CPU against dxmi_tpu: a
small UNetADM of LSUN's structure (six levels, resblock_updown, no
scale-shift, unconditional, attention at three maps by num_head_channels)
in T4.yaml's EDMSampler, fp32, bf16 and fp32 --int8, against the committed
goldens that chip_smoke.py (phase G8) replays on the card and that
tests/torch_fixtures/make_lsun_golden.py rebuilds; the full-width T4 net's
parameter tree against JAX's; and the kernels' routes and launches of E8's
paths and E9's training forward at LSUN's shapes (on the meta device)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from dxmi_tpu.models.unet_adm import create_unet_adm as jax_create_unet_adm
from dxmi_tpu.ops import attention as jax_attention
from dxmi_tpu.ops import attn_block as jax_attn_block
from dxmi_tpu_torch.ops.attention import flash_available
from dxmi_tpu_torch.ops.attn_block import (fused_attn_available,
                                           fused_attn_bwd_available)
from dxmi_tpu_torch.utils.convert import adm_leaf
from torch_fixtures import make_lsun_golden, rebuild_checks


@pytest.fixture(scope="module")
def replay():
    """chip_smoke.lsun_small_replay on the CPU (it raises past a gate)."""
    return chip_smoke.lsun_small_replay("cpu")


def test_golden_rebuilds_from_jax():
    """The committed goldens are what the JAX package computes today, each
    path from the committed fp32 states: fp32 means and sigmas within the
    fp32 rebuild limit (rebuild_checks); the bf16 means within half of
    G8's share of JAX's own bf16 effect and the int8 means within G8's
    mean gate of the int8 effect (a rounding flip of a bf16 or int8 net
    moves whole regions of a step: both paths are chaotic at this depth);
    the calibrated scales within rebuild_checks' limit."""
    gold = dict(np.load(chip_smoke.LSUN_GOLDEN))
    gold8 = dict(np.load(chip_smoke.LSUN_INT8_GOLDEN))
    built, built8 = make_lsun_golden.build(teacher=gold)
    assert set(built) == set(gold) and set(built8) == set(gold8)
    rebuild_checks.check_fp32_rebuild(
        {k: built[k] for k in ("seed", "sigmas", "fp32/means")},
        {k: gold[k] for k in ("seed", "sigmas", "fp32/means")})
    for t, (a, ref) in enumerate(zip(built["bf16/means"],
                                     gold["bf16/means"])):
        eff = np.abs(ref - gold["fp32/means"][t]).mean()
        assert np.abs(a - ref).mean() <= chip_smoke.BF16_REPLAY_SHARE / 2 \
            * eff, t
    for t, (a, ref) in enumerate(zip(built8["int8/means"],
                                     gold8["int8/means"])):
        eff = np.abs(ref - gold["fp32/means"][t]).mean()
        assert np.abs(a - ref).mean() <= chip_smoke.INT8_STEP_RATIO * eff, t
    for k, v in gold8.items():
        if k.startswith("scale/"):
            assert np.abs(built8[k] - v).max() <= rebuild_checks.FP32_REL \
                * np.abs(v).max(), k


@pytest.mark.parametrize("impl", ["fused", "einsum"])
def test_fp32_matches_jax(replay, impl):
    """Each step mean of the fp32 net (fused: K2's plain version; einsum)
    within 2e-5 + 2e-5 |JAX| of JAX's einsum net (4.2e-5 at most at means
    of up to ~25: the fp32 kernels' limit)."""
    assert replay[f"fp32 {impl}"] < 1e-3


def test_bf16_matches_jax(replay):
    """generate_large's bf16 path (bf16 softmax, K2's bf16 plain version at
    the 16x16 and 8x8 maps, phase upsampling, bf16_onepass statistics)
    within twice JAX's own bf16 effect, mean and largest (0.98 and 1.34
    measured)."""
    assert max(replay["bf16"]) <= chip_smoke.BF16_REPLAY_SHARE


def test_int8_matches_jax(replay):
    """fp32 --int8 (K8's and K5's plain versions): calibration within
    INT8_SCALE_REL of JAX's scales; with JAX's scales each step's mean
    error within INT8_STEP_RATIO of the int8 effect and its median within
    LSUN_INT8_NUDGE_SHARE of the nudges' (chip_smoke, reasoned there)."""
    assert replay["calib"] <= chip_smoke.INT8_SCALE_REL
    worst, nudge = replay["int8"]
    assert worst <= chip_smoke.INT8_STEP_RATIO
    assert nudge <= chip_smoke.LSUN_INT8_NUDGE_SHARE


def test_int8_gate_sees_a_wrong_scale():
    """The int8 gates fail when one of JAX's calibrated scales is off by 2%
    (the calibration gate sees it)."""
    gold8 = dict(np.load(chip_smoke.LSUN_INT8_GOLDEN))
    key = next(k for k in gold8 if k.startswith("scale/")
               and "middle_block.0.in_layers.2" in k)
    stale = dict(gold8, **{key: gold8[key] * 1.02})
    real = np.load

    def load(path, *a, **kw):
        if path == chip_smoke.LSUN_INT8_GOLDEN:
            return stale
        return real(path, *a, **kw)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(chip_smoke.np, "load", load)
        with pytest.raises(AssertionError):
            chip_smoke.lsun_small_replay("cpu")


def test_full_width_tree_matches_jax():
    """configs/lsun/T4.yaml's UNetADM (526,304,771 parameters) on the meta
    device: the same parameter names and shapes as JAX's tree
    (jax.eval_shape), through the converter's name map."""
    dcfg = dict(chip_smoke.lsun_t4()["diffusion"])
    for k in ("sigma_min", "sigma_max", "weight_schedule", "distillation"):
        dcfg.pop(k)
    net = jax_create_unet_adm(**dcfg)
    shapes = jax.eval_shape(lambda: net.init(
        jax.random.key(0), jnp.zeros((1, 256, 256, 3)), jnp.zeros((1,))))
    want = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(
            shapes["params"])[0]:
        key, axes = adm_leaf([p.key for p in path], leaf.ndim)
        want[key] = tuple(np.array(leaf.shape)[list(axes)]) if axes else \
            tuple(leaf.shape)
    port = chip_smoke.lsun_net("fused")
    got = {k: tuple(v.shape) for k, v in port.state_dict().items()}
    assert got == want
    assert sum(np.prod(s) for s in got.values()) == 526_304_771


# LSUN's three attention maps at full width: (S, C, heads)
LSUN_MAPS = [(1024, 512, 8), (256, 1024, 16), (64, 1024, 16)]


@pytest.mark.parametrize("S,C,nh", LSUN_MAPS)
def test_attention_gates_match_jax(monkeypatch, S, C, nh):
    """The port's route gates at LSUN's maps are JAX's with its backend
    test forced on: the fused block only at 32x32, the int8 block at all
    three, flash (d = 64) only at S = 1024, fused_train at none."""
    monkeypatch.setenv("DXMI_FUSED_ATTN_FORCE", "1")
    monkeypatch.setattr(jax_attention, "_tpu_backend", lambda: True)
    monkeypatch.setattr(jax_attn_block, "_tpu_backend", lambda: True)
    for int8 in (False, True):
        assert fused_attn_available(S, C, nh, int8) == \
            jax_attn_block.fused_attn_available(S, C, nh, int8=int8)
    assert fused_attn_bwd_available(S, C, nh) == \
        jax_attn_block.fused_attn_bwd_available(S, C, nh) is False
    assert flash_available(S, C // nh) == \
        jax_attention.flash_available(S, C // nh)
    assert fused_attn_available(S, C, nh) == (S == 1024)
    assert fused_attn_available(S, C, nh, int8=True)


@pytest.mark.parametrize("path,want", [
    ("fused", {"gn_silu_bf16": 96, "attn_block_bf16": 5}),
    ("flash", {"gn_silu_bf16": 101, "flash_attn": 5}),
    ("int8", {"gn_silu_bf16": 85, "attn_block_i8": 16, "int8_conv": 99})])
def test_launch_tables(path, want):
    """The launches a forward that E8 checks, counted on the meta device
    from the full-width T4 net: 42 ResBlocks (84 K1 norms) and out.0; K2 at
    the 5 blocks of 32x32 and the einsum path (K1 at their norms) at the 5
    of 16x16 and 6 of 8x8 under fused; K4 at 32x32 under flash; K5 at all
    16 under --int8, K8 at the 84 ResBlock 3x3 convs with each of the 5
    phase up-blocks' first conv as 4 launches. The flash path's are E9's
    training forward's (K4 at 8 heads of 64, K1 at every norm)."""
    counts = chip_smoke.lsun_shape_counts(path)
    assert chip_smoke.lsun_launches(counts) == want
    if path == "flash":  # E9's training forward too
        assert {k for k in counts if k[0] == "k4"} == {("k4", 1024, 8, 64)}
    if path == "fused":
        assert {k for k in counts if k[0] == "k2"} == {("k2", 1024, 512, 8)}
    if path == "int8":
        assert {k[1:] for k in counts if k[0] == "k5"} == set(LSUN_MAPS)


def test_big_map_shapes():
    """The shapes phase K holds at 128x128 and larger (K1's split route on
    the card): the 256x256 maps at 256 and 512 channels (SiLU on and off)
    and the 128x128 ones up to the decoder's 768; K8's 3x3 convs at 256
    and 512 input channels at 256x256 and the phase convs at 128x128."""
    assert chip_smoke.lsun_gn_keys() == [
        (16384, 256, False), (16384, 256, True), (16384, 512, False),
        (16384, 512, True), (16384, 768, True), (65536, 256, False),
        (65536, 256, True), (65536, 512, True)]
    k8 = chip_smoke.lsun_k8_keys()
    assert (256, 256, 256, 256, 3, 3, ((1, 1), (1, 1))) in k8
    assert (256, 256, 512, 256, 3, 3, ((1, 1), (1, 1))) in k8
    assert sum(1 for k in k8 if k[4] == 2) == 4 and len(k8) == 10


def test_plain_chunks_equal_one_call():
    """The plain versions over batch chunks (phase K's and E8's at LSUN's
    maps) equal one call on the whole batch."""
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(5, 64, 64, generator=gen).bfloat16()
    a = (torch.rand(64, generator=gen) + 0.5, torch.randn(64, generator=gen),
         32, 1e-5, True, "bf16_onepass")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(chip_smoke, "PLAIN_CHUNK_ELEMS", 2 * 64 * 64)
        assert len(chip_smoke._chunks(5, 64 * 64)) == 3
        chunked = chip_smoke.gn_plain(x, *a)
    assert torch.equal(chunked, chip_smoke.group_norm_silu_reference(x, *a))
