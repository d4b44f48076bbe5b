"""UNetADM's training surface on the CPU: gradients against ``jax.grad`` of
dxmi_tpu's UNetADM through converted weights (fp32 master parameters, fp32
and bf16 compute, einsum and fused_train, whose JAX backward is the Pallas
kernel ``_kernel_bwd`` in interpret mode); casting at use equal to casting
once; gradient checkpointing; dropout under ``train()``; and the kernel
launches of a training step of the full-width ImageNet64 net, counted on
the meta device, that chip_smoke.py asserts in phase E3."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from dxmi_tpu.models.unet_adm import UNetADM as JaxUNetADM
from dxmi_tpu_torch.models import unet_adm
from dxmi_tpu_torch.models.unet_adm import UNetADM, create_unet_adm
from dxmi_tpu_torch.utils.convert import unet_adm_from_flax
from test_torch_unet_adm import NETS, _inputs, _seeded_flax_params


def _grads_jax(cfg, params, x, t, y, w, **kw):
    net = JaxUNetADM(**cfg, **kw)

    def loss(p):
        out = net.apply({"params": p}, jnp.asarray(x.transpose(0, 2, 3, 1)),
                        jnp.asarray(t), jnp.asarray(y))
        return jnp.sum(out * jnp.asarray(w.transpose(0, 2, 3, 1)))

    return unet_adm_from_flax(jax.tree.map(np.asarray, jax.grad(loss)(params)))


def _grads_port(cfg, params, x, t, y, w, **kw):
    net = UNetADM(**cfg, **kw)
    net.load_state_dict(unet_adm_from_flax(params))
    out = net(torch.from_numpy(x), torch.from_numpy(t),
              torch.from_numpy(y).long())
    loss = (out * torch.from_numpy(w)).sum()
    names = [n for n, _ in net.named_parameters()]
    assert all(p.dtype == torch.float32 for p in net.parameters())
    return dict(zip(names, torch.autograd.grad(loss, list(net.parameters()))))


@pytest.fixture(scope="module")
def case():
    params = _seeded_flax_params(NETS[16], seed=21)
    x, t, y = _inputs(16, seed=22)
    w = np.random.RandomState(23).randn(*x.shape).astype(np.float32)
    return params, x, t, y, w


def test_fp32_grads_match_jax(case):
    """fp32, einsum: every parameter's gradient within 1e-4 relative plus
    1e-6 of the largest gradient (fp32 through the net)."""
    params, x, t, y, w = case
    want = _grads_jax(NETS[16], params, x, t, y, w)
    got = _grads_port(NETS[16], params, x, t, y, w)
    G = max(float(v.abs().max()) for v in want.values())
    assert set(got) == set(want)
    for k, g in got.items():
        torch.testing.assert_close(g, want[k], rtol=1e-4, atol=1e-6 * G,
                                   msg=k)


@pytest.mark.parametrize("attn_impl", ["einsum", "fused_train"])
def test_bf16_grads_match_jax(case, monkeypatch, attn_impl):
    """bf16 compute on fp32 master parameters (flax's dtype=bf16), einsum
    with a bf16 softmax or fused_train (the port's K2 and K6 plain versions;
    JAX's Pallas kernels in interpret mode). Both frameworks round each
    operation to bf16, in places that differ, so each bf16 gradient carries
    its own bf16 noise against the fp32 gradient (JAX's: 0.029 of its norm
    over the net). The port's gradient is in that class: at most 1.5 times
    JAX's distance from the fp32 gradient (0.92 measured), and at most twice
    that distance from JAX's bf16 gradient (1.13: two independent noises)."""
    monkeypatch.setenv("DXMI_FUSED_ATTN_FORCE", "1")
    params, x, t, y, w = case
    kw = dict(dtype=jnp.bfloat16, softmax_f32=False, attn_impl=attn_impl)
    ref32 = _grads_jax(NETS[16], params, x, t, y, w)
    want = _grads_jax(NETS[16], params, x, t, y, w, **kw)
    got = _grads_port(NETS[16], params, x, t, y, w,
                      **dict(kw, dtype=torch.bfloat16))

    def dist(a, b):
        return np.sqrt(sum(float(((a[k] - b[k]) ** 2).sum()) for k in b)
                       / sum(float((ref32[k] ** 2).sum()) for k in ref32))

    noise = dist(want, ref32)
    assert 0 < noise < 0.1
    assert dist(got, ref32) <= 1.5 * noise
    assert dist(got, want) <= 2 * noise


def test_cast_at_use_equals_cast_once(case):
    """A bf16 net with fp32 parameters computes what cast_weights' bf16
    parameters compute (flax casts at every call; the port's sampling casts
    once)."""
    params, x, t, y, _ = case
    outs = []
    for cast in (False, True):
        net = UNetADM(**NETS[16], dtype=torch.bfloat16)
        net.load_state_dict(unet_adm_from_flax(params))
        if cast:
            net.cast_weights()
        with torch.no_grad():
            outs.append(net(torch.from_numpy(x), torch.from_numpy(t),
                            torch.from_numpy(y).long()))
    torch.testing.assert_close(outs[0], outs[1], rtol=0, atol=0)


def test_checkpointing_gives_the_same_gradients(case):
    params, x, t, y, w = case
    grads = [_grads_port(NETS[16], params, x, t, y, w, use_checkpoint=c)
             for c in (False, True)]
    for k in grads[0]:
        torch.testing.assert_close(grads[0][k], grads[1][k], rtol=0, atol=0,
                                   msg=k)


def test_dropout_follows_train_mode(case):
    params, x, t, y, _ = case
    net = UNetADM(**dict(NETS[16], dropout=0.5))
    net.load_state_dict(unet_adm_from_flax(params))
    args = (torch.from_numpy(x), torch.from_numpy(t),
            torch.from_numpy(y).long())
    with torch.no_grad():
        net.eval()
        a, b = net(*args), net(*args)
        torch.manual_seed(0)
        net.train()
        c, d = net(*args), net(*args)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert not torch.equal(c, d) and not torch.equal(a, c)


def _count(monkeypatch, net, backward):
    """Kernel wrappers counted on the meta device for one forward (and, with
    ``backward``, the attention backward kernels a backward would launch:
    one per flash map and per fused_train block)."""
    counts = {}

    def counter(name, out):
        def fn(*args, **kwargs):
            counts[name] = counts.get(name, 0) + 1
            if backward and name == "flash_attn":
                for k in ("flash_attn_bwd_dkv", "flash_attn_bwd_dq"):
                    counts[k] = counts.get(k, 0) + 1
            if backward and name == "attn_block_bf16":
                counts["attn_block_bwd_bf16"] = counts.get(
                    "attn_block_bwd_bf16", 0) + 1
            return out(args[0])
        return fn

    monkeypatch.setattr(unet_adm, "group_norm",
                        counter("gn_silu_bf16", torch.empty_like))
    monkeypatch.setattr(unet_adm, "flash_mha",
                        counter("flash_attn", torch.empty_like))
    monkeypatch.setattr(unet_adm, "fused_attn_block_train",
                        counter("attn_block_bf16", torch.empty_like))
    x = torch.empty(1, 3, 64, 64, device="meta")
    net(x, torch.empty(1, device="meta"),
        torch.zeros(1, dtype=torch.long, device="meta"))
    return counts


@pytest.mark.parametrize("attn_impl", ["flash", "fused_train"])
def test_imagenet64_training_launch_table(monkeypatch, attn_impl):
    """chip_smoke.TRAIN_LAUNCHES_PER_STEP from the full-width ImageNet64 net:
    TRAIN_FORWARDS forwards (T sampling steps and one per sampler minibatch)
    and TRAIN_BACKWARDS backwards (one per minibatch, G = T)."""
    cfg = dict(chip_smoke.imagenet64_t10()["diffusion"])
    for k in ("sigma_min", "sigma_max", "weight_schedule", "distillation"):
        cfg.pop(k)
    with torch.device("meta"):
        net = create_unet_adm(**cfg, attn_impl=attn_impl)
    fwd = _count(monkeypatch, net, backward=False)
    both = _count(monkeypatch, net, backward=True)
    bwd = {k: both[k] - fwd.get(k, 0) for k in both if both[k] > fwd.get(k, 0)}
    T = chip_smoke.T
    assert chip_smoke.TRAIN_FORWARDS == 2 * T
    assert chip_smoke.TRAIN_BACKWARDS == T
    want = {k: v * chip_smoke.TRAIN_FORWARDS for k, v in fwd.items()}
    want.update({k: v * chip_smoke.TRAIN_BACKWARDS for k, v in bwd.items()})
    assert want == chip_smoke.TRAIN_LAUNCHES_PER_STEP[attn_impl]
