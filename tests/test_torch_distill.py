"""The port's distillation losses (``dxmi_tpu_torch.trainers.distill``),
``karras_sample``, the EMA helpers and the ``weight_schedule`` repair,
against the JAX package: the schedules and weights exactly; the losses
and solvers through ``tests/torch_fixtures/distill_golden.npz`` (JAX's
draws stored beside its results); the losses' parameter gradients against
``jax.value_and_grad`` live, on the golden's inputs and keys; and the
dropout draw that the online and target forwards share."""
import copy
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from dxmi_tpu.trainers import distill as jd
from dxmi_tpu.utils import ema as jema
from dxmi_tpu_torch.samplers.edm import KarrasDenoiser
from dxmi_tpu_torch.trainers import distill
from dxmi_tpu_torch.utils import ema
from dxmi_tpu_torch.utils.convert import unet_adm_from_flax
from torch_fixtures import make_distill_golden

SCHEDULES = ("snr", "snr+1", "karras", "truncated-snr", "uniform")
# a conv bias that feeds a GroupNorm has a gradient of nearly cancelling
# terms (1e-9 of the largest in these cases), whose digits are fp32 noise
# in both frameworks: each tensor's limit adds 1e-6 of the largest
# gradient's norm, as tests/test_torch_edm_train.py does
GRAD_FLOOR = 1e-6


@pytest.fixture(scope="module")
def golden():
    return dict(np.load(chip_smoke.DISTILL_GOLDEN))


def test_weightings_snr_and_karras_t_match_jax():
    """get_weightings (all five schedules), get_snr and _karras_t: equal to
    JAX's on the same fp32 sigmas."""
    sig = np.exp(np.random.RandomState(0).randn(64) * 2).astype(np.float32)
    snr = distill.get_snr(torch.from_numpy(sig))
    np.testing.assert_array_equal(snr.numpy(),
                                  np.asarray(jd.get_snr(jnp.asarray(sig))))
    for name in SCHEDULES:
        np.testing.assert_array_equal(
            distill.get_weightings(name, snr, 0.5).numpy(),
            np.asarray(jd.get_weightings(name, jnp.asarray(snr.numpy()),
                                         0.5)))
    with pytest.raises(NotImplementedError):
        distill.get_weightings("lognormal", snr, 0.5)
    diff = KarrasDenoiser()
    frac = np.linspace(0, 1, 33).astype(np.float32)
    np.testing.assert_array_equal(
        distill.karras_t(diff, torch.from_numpy(frac)).numpy(),
        np.asarray(jd._karras_t(diff, jnp.asarray(frac))))


EMA_MODES = [("fixed", "fixed"), ("fixed", "progressive"),
             ("adaptive", "progressive"), ("fixed", "progdist")]


@pytest.mark.parametrize("mode", EMA_MODES)
def test_ema_and_scales_schedules_match_jax(mode):
    """Both schedules, step by step over whole runs (progdist's stages and
    sub-stages included), equal to JAX's, types too."""
    args = (mode[0], 0.95, mode[1], 16, 64, 4000)
    port = distill.create_ema_and_scales_fn(*args, distill_steps_per_iter=250)
    want = jd.create_ema_and_scales_fn(*args, distill_steps_per_iter=250)
    for step in range(0, 4001, 7):
        assert port(step) == want(step), step
    if mode[1] == "progdist":
        with pytest.raises(NotImplementedError):
            ema.ema_and_scales_fn(*args, 250)(0)
        return
    port, want = (f(*args, 250) for f in (ema.ema_and_scales_fn,
                                          jema.ema_and_scales_fn))
    for step in range(0, 4001, 7):
        got, ref = port(step), want(step)
        assert got == ref and [type(v) for v in got] == [type(v)
                                                         for v in ref]


def test_update_ema_matches_jax_exactly():
    """update_ema in place equals JAX's tree map bit for bit in fp32; a
    module whose parameters differ raises."""
    net = chip_smoke.distill_net(16, "online")
    target = chip_smoke.distill_net(16, "target")
    want = jema.update_ema(
        {k: v.detach().numpy().copy() for k, v in target.named_parameters()},
        {k: v.detach().numpy().copy() for k, v in net.named_parameters()},
        0.95)
    ema.update_ema(target, net, 0.95)
    for k, v in target.named_parameters():
        np.testing.assert_array_equal(v.detach().numpy(), np.asarray(want[k]))
    with pytest.raises(ValueError):
        ema.update_ema(target, chip_smoke.distill_net(64, "online")
                       .time_embed, 0.95)


def test_l2_32_resize_matches_jax_antialiased():
    """l2-32's resize is jax.image.resize's bilinear, antialiased when it
    shrinks 64 -> 32 (plain F.interpolate is 0.94 away): 1e-6; the loss
    too."""
    x = np.random.RandomState(1).randn(2, 64, 64, 3).astype(np.float32)
    y = np.random.RandomState(2).randn(2, 64, 64, 3).astype(np.float32)
    want = np.asarray(jd._resize_bilinear(jnp.asarray(x), 32))
    got = distill.resize_bilinear(torch.from_numpy(x).permute(0, 3, 1, 2), 32)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want,
                               atol=1e-6)
    w = np.float32([1.5, 0.5])
    np.testing.assert_allclose(
        distill.norm_loss("l2-32", torch.from_numpy(x).permute(0, 3, 1, 2),
                          torch.from_numpy(y).permute(0, 3, 1, 2),
                          torch.from_numpy(w)).numpy(),
        np.asarray(jd._norm_loss("l2-32", jnp.asarray(x), jnp.asarray(y),
                                 jnp.asarray(w))), rtol=1e-6)


def test_losses_and_solvers_match_the_golden(golden):
    """Every loss of DISTILL_CASES (l2, l1, l2-32 on the 64x64 net; CD, CT,
    progdist, DSM; train mode with JAX's dropout masks) within 1e-4 of
    JAX's, each of the seven karras_sample solvers and heun with churn
    within the fp32 limit itself (2e-5 + 2e-5 relative, without G10's
    allowance for JAX's nudged move), and the pretrain_ddpm
    update's loss (G10's gates, on the CPU); the update's gradient norms
    per tensor within 1e-4 of JAX's plus GRAD_FLOOR of the largest."""
    worst = chip_smoke.distill_golden_check(golden, "cpu")
    for name in chip_smoke.KARRAS_CASES:
        assert worst[f"karras/{name}"] <= 1.0, name
    assert worst["ddpm/loss"] <= 1e-5
    _, gnorm, _ = chip_smoke.ddpm_update_replay(golden, "cpu")
    top = max(float(golden[f"ddpm/gnorm/{k}"]) for k in gnorm)
    for k, v in gnorm.items():
        ref = float(golden[f"ddpm/gnorm/{k}"])
        assert abs(v - ref) <= 1e-4 * ref + GRAD_FLOOR * top, k


def test_ddpm_update_with_k3_within_its_bf16_limits(golden):
    """pretrain_ddpm's own net (fused attention, K3 where dropout does not
    split the pair) on the golden's update: K3 rounds its conv operands to
    bf16 where JAX does not, so it is held at G4's K3 limits (loss 2e-3,
    the gradient norms 0.2 relative)."""
    loss, gnorm, _ = chip_smoke.ddpm_update_replay(golden, "cpu", fuse=True)
    ref = float(golden["ddpm/loss"])
    assert abs(loss - ref) <= chip_smoke.G4_K3_METRIC_REL * ref
    a = np.array([gnorm[k] for k in sorted(gnorm)])
    b = np.array([float(golden[f"ddpm/gnorm/{k}"]) for k in sorted(gnorm)])
    assert np.linalg.norm(a - b) / np.linalg.norm(b) <= \
        chip_smoke.G4_K3_SAMPLER_REL


# the gradient checks' net: the golden's ADM cut to one 8x8 level without
# dropout (JAX compiles each loss's gradient on the CPU in a third of the
# golden net's time)
TINY = dict(channel_mult=(1,), attention_resolutions=(1,), dropout=0.0)


def _nchw(a):
    return np.ascontiguousarray(np.moveaxis(np.asarray(a), -1, -3))


@pytest.mark.parametrize("name", ["dsm", "cd_l2", "ct_l1", "pd_l2"])
def test_gradients_match_jax(name):
    """The mean loss and its gradient in every parameter of the online net
    against jax.value_and_grad, with JAX's noise and scale indices injected
    (the golden's draw code at TINY's size): loss 1e-5, each tensor's
    gradient within 1e-4 of JAX's in norm plus GRAD_FLOOR of the largest
    tensor's."""
    x, y, key, extra = make_distill_golden.distill_draws(name, 7, size=8)
    jloss, p = make_distill_golden.jax_distill_loss(name, key, x, y, extra,
                                                    image_size=8, **TINY)
    jl, jg = jax.jit(jax.value_and_grad(lambda q: jloss(q).mean()))(p)
    want = unet_adm_from_flax(jax.tree.map(np.asarray, jg))

    case = {f"{name}/key": 7, f"{name}/noise": _nchw(extra["noise"])}
    if "indices" in extra:
        case[f"{name}/indices"] = np.asarray(extra["indices"])
    nets = {r: chip_smoke.distill_net(8, r, **TINY)
            for r in chip_smoke.DISTILL_ROLES}
    loss, net = chip_smoke.distill_case(case, name, "cpu", nets, size=8)
    loss.mean().backward()
    np.testing.assert_allclose(float(loss.mean()), float(jl), rtol=1e-5)
    top = max(np.linalg.norm(v.numpy()) for v in want.values())
    for k, v in net.named_parameters():
        ref = want[k].numpy()
        err = np.linalg.norm(v.grad.numpy() - ref)
        assert err <= 1e-4 * np.linalg.norm(ref) + GRAD_FLOOR * top, (k, err)


def test_no_gradient_reaches_teacher_or_target(golden):
    nets = {r: chip_smoke.distill_net(16, r) for r in chip_smoke.DISTILL_ROLES}
    for name in ("cd_l2", "pd_l1"):
        loss, _ = chip_smoke.distill_case(golden, name, "cpu", nets)
        loss.sum().backward()
    assert all(p.grad is not None for p in nets["online"].parameters())
    for role in ("target", "teacher"):
        assert all(p.grad is None for p in nets[role].parameters()), role


def test_errors_as_jax():
    """No target raises; l2-32 in progdist raises; lpips and an unknown
    norm raise with JAX's messages."""
    diff = KarrasDenoiser(loss_norm="l2-32")
    net = chip_smoke.distill_net(16, "online")
    x = torch.zeros(2, 3, 16, 16)
    with pytest.raises(ValueError, match="Must have a target model"):
        distill.consistency_losses(diff, net, None, x, 8)
    with pytest.raises(ValueError, match="l2-32"):
        distill.progdist_losses(diff, net, x, 8, teacher_net=net)
    for norm in ("lpips", "l3"):
        with pytest.raises(ValueError) as got:
            distill.norm_loss(norm, x, x, torch.ones(2))
        with pytest.raises(ValueError) as want:
            jd._norm_loss(norm, jnp.zeros(2), jnp.zeros(2), jnp.ones(2))
        assert str(got.value) == str(want.value)


def _paired_outputs(net, target, masks=None, shift_rng=False):
    """(online, target) net outputs of a CT loss in training mode whose
    target forward is given the online forward's inputs: equal exactly
    when both forwards draw the same dropout masks. ``shift_rng`` draws
    once from the default generator before the target's forward."""
    seen = {}

    def online_in(mod, args):
        seen["args"] = args

    def target_in(mod, args):
        if shift_rng:
            torch.rand(1)
        return seen["args"]

    def keep(name):
        def hook(mod, args, out):
            seen[name] = out.detach().clone()
        return hook

    hooks = [net.register_forward_pre_hook(online_in),
             target.register_forward_pre_hook(target_in),
             net.register_forward_hook(keep("online")),
             target.register_forward_hook(keep("target"))]
    try:
        x = torch.from_numpy(np.tanh(np.random.RandomState(3).randn(
            4, 3, 16, 16)).astype(np.float32))
        distill.consistency_losses(
            KarrasDenoiser(), net, target, x, 8, y=torch.arange(4),
            train=True, generator=torch.Generator().manual_seed(0),
            dropout_masks=masks)
    finally:
        for h in hooks:
            h.remove()
    return seen["online"], seen["target"]


def test_online_and_target_share_the_dropout_draw():
    """With dropout 0.5 and the target's parameters equal to the online
    ones, the two forwards give equal outputs on equal inputs, whether the
    masks are drawn (the RNG state restored between them) or injected; a
    target that draws other masks gives another output. Both nets' modes
    are left as they were."""
    from dxmi_tpu_torch.models.unet_adm import UNetADM
    net = UNetADM(**dict(chip_smoke.DISTILL_SMALL, dropout=0.5))
    net.load_state_dict(chip_smoke.distill_net(16, "online").state_dict())
    net.eval()
    target = copy.deepcopy(net)
    torch.manual_seed(0)
    a, b = _paired_outputs(net, target)
    assert torch.equal(a, b)
    assert not net.training and not target.training
    a, b = _paired_outputs(net, target, shift_rng=True)
    assert float((a - b).abs().max()) > 0.1
    rec = net.record_dropout_masks(True)
    net.train()
    net(torch.zeros(4, 3, 16, 16), torch.ones(4), torch.arange(4))
    masks = net.record_dropout_masks(False)
    assert len(rec) == 10 and masks is rec
    net.eval()
    a, b = _paired_outputs(net, target, masks)
    assert torch.equal(a, b)


def test_build_sampler_passes_weight_schedule(tmp_path):
    """build_sampler gives KarrasDenoiser the config's weight_schedule, as
    JAX's does (it used to drop it), and uniform when the config has
    none."""
    from dxmi_tpu_torch.config import load_yaml
    from dxmi_tpu_torch.train_image_large import build_sampler
    cfg = load_yaml(os.path.join(chip_smoke.ADM_FIXTURE_DIR, "config.yaml"))
    cfg["training"]["pretrained_path"] = None
    for sched in SCHEDULES:
        cfg["diffusion"]["weight_schedule"] = sched
        s = build_sampler(cfg, torch.device("cpu"), 0, init="flax")
        assert s.diffusion.weight_schedule == sched
    del cfg["diffusion"]["weight_schedule"]
    assert build_sampler(cfg, torch.device("cpu"), 0).diffusion \
        .weight_schedule == "uniform"
