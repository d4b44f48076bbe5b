"""The port's UNetSmall in bf16 without int8 (``generate_cifar10 --dtype
bf16``, ``train_cifar10 --fast_levers``) against dxmi_tpu's on the same
weights, on the small net of test_torch_unet_small_int8.py (ch 32, ch_mult
(1, 2), 16x16, attention at 8x8), eagerly on the CPU.

The reference is JAX's bf16 net as its entries run it on the CPU: unfused
and einsum (JAX fuses neither in bf16 there). The port runs JAX's own
arithmetic unfused and einsum, or its fused defaults (K3's and K2's plain
versions: conv sums in fp32 rounded once, fp32 statistics).

A bf16 net amplifies a single flipped rounding: two bf16 arithmetics, or
the same one with another fp32 sum order, end about as far apart as bf16
is from fp32. So the limits read against JAX's own bf16 effect, the mean
relative distance of its bf16 output from its fp32 output on the same
inputs (``noise``, 1.2e-2 and 1.8e-2 here):
- block by block on JAX's input of each block (teacher forcing), the
  unfused port repeats JAX's roundings: within ``BLOCK_REL`` (1e-4) of the
  block's mean |output| (at most 3.9e-5 measured: a few flipped roundings);
- the whole net and a T = 10 trajectory with injected noise: within
  ``BF16_SHARE`` (2) times the effect of JAX's bf16 output and
  ``FP32_SHARE`` (1.5) times it of JAX's fp32 output, unfused and fused
  (0.21-1.0 and 0.77-1.0 measured); a layer left in fp32 or a wrong
  statistic lands further.
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dxmi_tpu.models.unet_small import UNetSmall as JaxUNetSmall
from dxmi_tpu.samplers.var import VARSampler as JaxVARSampler
from dxmi_tpu_torch.models import unet_small as port
from dxmi_tpu_torch.ops import _lib
from dxmi_tpu_torch.samplers.var import VARSampler
from dxmi_tpu_torch.utils.convert import unet_small_from_flax
from test_torch_unet_small_int8 import SMALL, _env, _inputs, _params, _rel

# setting -> (JAX and port module options, GroupNorm statistics, port
# fuses): the CLI's --dtype bf16 and the training levers
SETTINGS = {
    "generate": (dict(), "fp32"),
    "levers": (dict(softmax_f32=False, softmax_nomax=True, up_impl="phase"),
               "bf16_onepass"),
}
BLOCK_REL = 1e-4
BF16_SHARE, FP32_SHARE = 2.0, 1.5


def _jax_out(kw, stats, jdt, x, t):
    net = JaxUNetSmall(**SMALL, dtype=jdt, **kw)
    with _env({"DXMI_GN_STATS": stats}):
        return np.asarray(net.apply({"params": _params()}, jnp.asarray(x),
                                    jnp.asarray(t)), np.float32)


def _port_net(kw, stats, fused):
    net = port.UNetSmall(**SMALL, **kw, dtype=torch.bfloat16,
                         gn_stats=stats, fuse_gn_conv=fused,
                         attn_impl="fused" if fused else "einsum")
    net.load_state_dict(unet_small_from_flax(_params()))
    return net.eval()


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
@pytest.mark.parametrize("setting", list(SETTINGS))
def test_forward_matches_jax(setting, fused):
    kw, stats = SETTINGS[setting]
    x, t = _inputs()
    ref = _jax_out(kw, stats, jnp.bfloat16, x, t)
    ref32 = _jax_out(kw, "fp32", jnp.float32, x, t)
    noise = _rel(ref, ref32)
    assert 1e-3 < noise < 6e-2, noise
    net = _port_net(kw, stats, fused)
    _lib.reset_launches()
    with torch.no_grad():
        out = net(torch.from_numpy(x).permute(0, 3, 1, 2),
                  torch.from_numpy(t))
    assert out.dtype == torch.float32 and not _lib.LAUNCHES
    out = out.permute(0, 2, 3, 1).numpy()
    assert _rel(out, ref) < BF16_SHARE * noise
    assert _rel(out, ref32) < FP32_SHARE * noise


@pytest.mark.parametrize("setting", list(SETTINGS))
def test_blocks_match_jax_teacher_forced(setting):
    """Each top-level block of the unfused port (ResnetBlock, AttnBlock,
    Downsample, Upsample) on JAX's bf16 input of that block: forward hooks
    keep the port's output and hand JAX's on."""
    kw, stats = SETTINGS[setting]
    x, t = _inputs()
    net = JaxUNetSmall(**SMALL, dtype=jnp.bfloat16, **kw)
    with _env({"DXMI_GN_STATS": stats}):
        _, st = net.apply({"params": _params()}, jnp.asarray(x),
                          jnp.asarray(t), capture_intermediates=True,
                          mutable=["intermediates"])
    inter = st["intermediates"]
    pnet = _port_net(kw, stats, False)
    seen, hooks = [], []
    for name, mod in pnet.named_modules():
        if isinstance(mod, (port.ResnetBlock, port.AttnBlock,
                            port.Downsample, port.Upsample)):
            ref = torch.from_numpy(np.asarray(
                inter[name.replace(".", "_")]["__call__"][0], np.float32))
            ref = ref.permute(0, 3, 1, 2).contiguous(
                memory_format=torch.channels_last).bfloat16()

            def hook(mod, inp, out, _name=name, _ref=ref):
                seen.append((_name, out.float().numpy(),
                             _ref.float().numpy()))
                return _ref
            hooks.append(mod.register_forward_hook(hook))
    with torch.no_grad():
        pnet(torch.from_numpy(x).permute(0, 3, 1, 2), torch.from_numpy(t))
    for h in hooks:
        h.remove()
    assert len(seen) == 14
    for name, ours, ref in seen:
        assert _rel(ours, ref) < BLOCK_REL, (name, _rel(ours, ref))


def _draws(seed=11, n=4, T=10):
    rs = np.random.RandomState(seed)
    return (rs.randn(n, 16, 16, 3).astype(np.float32),
            rs.randn(T, n, 16, 16, 3).astype(np.float32))


@functools.lru_cache(maxsize=None)
def _jax_trajectory(jdt, stats):
    """JAX's VARSampler step (``var.py:111-149``) with ``_draws``' noise:
    x_{t+1} = x_t x_mult + eps_mult net(x_t, tau) + sigma_t eps_t."""
    x0, eps = _draws()
    jnet = JaxUNetSmall(**SMALL, dtype=jdt)
    jsamp = JaxVARSampler(jnet, 10, (3, 16, 16), trainable_beta="fix_last")
    sch = jsamp.schedule
    sig = np.asarray(jsamp.sigmas_all({"log_betas": jnp.log(jnp.asarray(
        sch.init_sigma))}))
    xs, x = [], jnp.asarray(x0)
    with _env({"DXMI_GN_STATS": stats}):
        for i in range(10):
            tau = jnp.full((x.shape[0],), sch.tau[i])
            e = jnet.apply({"params": _params()}, x, tau)
            x = x * sch.x_mult[i] + sch.eps_mult[i] * e + sig[i] * eps[i]
            xs.append(np.asarray(x))
    return np.stack(xs)


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
def test_trajectory_matches_jax(fused):
    """``generate_cifar10 --dtype bf16``'s trajectory (T = 10, injected x0
    and noise) step by step, at the forward's limits against JAX's bf16
    and fp32 trajectories of the same draws."""
    x0, eps = _draws()
    ref = _jax_trajectory(jnp.bfloat16, "fp32")
    ref32 = _jax_trajectory(jnp.float32, "fp32")
    sampler = VARSampler(_port_net({}, "fp32", fused), 10, (3, 16, 16),
                         trainable_beta="fix_last")
    with torch.no_grad():
        out = sampler.sample(4, x0=torch.from_numpy(x0).permute(0, 3, 1, 2),
                             eps=torch.from_numpy(eps).permute(0, 1, 4, 2,
                                                               3))
    got = out["l_sample"][1:].permute(0, 1, 3, 4, 2).numpy()
    for i in range(10):
        noise = _rel(ref[i], ref32[i])
        assert _rel(got[i], ref[i]) < BF16_SHARE * noise, i
        assert _rel(got[i], ref32[i]) < FP32_SHARE * noise, i
