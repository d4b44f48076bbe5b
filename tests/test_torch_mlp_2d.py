"""The 2D experiment in the port against dxmi_tpu on the CPU: the MLPs'
forwards through ``module_from_flax`` (1e-6), their flax-style init, the 2D
samplers and density bit for bit, one eps-matching pretraining step and one
DxMI iteration of ``train_2d``'s trainer with JAX's draws replayed (1e-5),
the pretrain cache read and written by both packages, and the
``train_2d`` CLI."""
import json
import os
import subprocess
import sys

import flax.serialization as fser
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dxmi_tpu.data import synthetic as jsyn
from dxmi_tpu.models.mlp import EpsMLP as JEps
from dxmi_tpu.models.mlp import ValueMLP as JValue
from dxmi_tpu.samplers.var import VARSampler as JVAR
from dxmi_tpu.trainers import buffer as jbuf
from dxmi_tpu.trainers.dxmi import DxMITrainer as JTrainer
from dxmi_tpu_torch import train_2d
from dxmi_tpu_torch.data import synthetic as psyn
from dxmi_tpu_torch.models.mlp import EpsMLP, ValueMLP
from dxmi_tpu_torch.trainers.buffer import from_d_sample
from dxmi_tpu_torch.trainers.optim import Adam
from dxmi_tpu_torch.utils import msgpack
from dxmi_tpu_torch.utils.convert import module_from_flax
from dxmi_tpu_torch.utils.train_state import flax_tree

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
T, B = 4, 16
HPARAMS = dict(tau1=0.1, tau2=0.01, lr=1e-4, v_lr=1e-4, beta_lr=1e-4)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _jax_nets(seed=0):
    k1, k2 = jax.random.split(jax.random.key(seed))
    eps, val = JEps(), JValue(time_dependent=True)
    pe = eps.init(k1, jnp.zeros((1, 2)), jnp.zeros((1,)))["params"]
    pv = val.init(k2, jnp.zeros((1, 2)), jnp.zeros((1,), jnp.int32))["params"]
    return eps, val, pe, pv


@pytest.mark.parametrize("which", ["eps", "value"])
def test_mlp_forward_matches_flax(which):
    """EpsMLP and ValueMLP with flax's parameters, at 1e-6."""
    eps, val, pe, pv = _jax_nets()
    rs = np.random.RandomState(1)
    x = rs.randn(8, 2).astype(np.float32)
    t = rs.randint(0, 11, 8).astype(np.float32)
    if which == "eps":
        net, ref = EpsMLP(), eps.apply({"params": pe}, x, t)
        net.load_state_dict(module_from_flax(net, _np(pe)))
    else:
        net, ref = ValueMLP(), val.apply({"params": pv}, x, t)
        net.load_state_dict(module_from_flax(net, _np(pv)))
    with torch.no_grad():
        out = net(torch.from_numpy(x), torch.from_numpy(t)).numpy()
    np.testing.assert_allclose(out, np.asarray(ref), rtol=1e-6, atol=1e-6)
    # and back: the port's flax tree is the flax tree
    back = flax_tree(net)
    for path, a in jax.tree_util.tree_flatten_with_path(
            _np(pe if which == "eps" else pv))[0]:
        node = back
        for k in path:
            node = node[k.key]
        np.testing.assert_array_equal(node, a)


def test_value_mlp_scalar_t_and_time_independent():
    """A scalar t broadcasts over the batch; without time dependence the
    net reads x alone, as flax's."""
    v = ValueMLP()
    x = torch.randn(5, 2)
    with torch.no_grad():
        torch.testing.assert_close(v(x, torch.tensor(3)),
                                   v(x, torch.full((5,), 3)))
    j = JValue(time_dependent=False)
    pj = j.init(jax.random.key(0), jnp.zeros((1, 2)))["params"]
    p = ValueMLP(time_dependent=False)
    p.load_state_dict(module_from_flax(p, _np(pj)))
    with torch.no_grad():
        np.testing.assert_allclose(
            p(x).numpy(), np.asarray(j.apply({"params": pj}, x.numpy())),
            rtol=1e-6, atol=1e-6)


def test_init_is_flax_lecun_normal():
    """Weights drawn as flax's Dense draws them: truncated at two standard
    deviations, variance 1 / fan_in; zero biases."""
    net = EpsMLP(generator=torch.Generator().manual_seed(0))
    w = net.dense_1.weight
    std = 1 / np.sqrt(128)
    assert float(w.abs().max()) <= 2 * std / 0.87962566103423978 + 1e-7
    assert abs(float(w.std()) / std - 1) < 0.05
    assert all(float(m.bias.abs().max()) == 0 for m in
               (net.dense_0, net.dense_1, net.dense_2, net.out))
    again = EpsMLP(generator=torch.Generator().manual_seed(0))
    torch.testing.assert_close(again.out.weight, net.out.weight)


@pytest.mark.parametrize("data", ["8gaussians", "2spirals", "checkerboard"])
def test_sample2d_bit_equal(data):
    a = psyn.sample2d(data, 301, np.random.RandomState(3))
    b = jsyn.sample2d(data, 301, np.random.RandomState(3))
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(psyn.pdf_8gaussian(a, 1.5),
                                  jsyn.pdf_8gaussian(b, 1.5))


@pytest.mark.parametrize("u", ["U1", "U2", "U3", "U4"])
def test_energy2d_bit_equal(u):
    z = np.random.RandomState(4).randn(50, 2)
    np.testing.assert_array_equal(psyn.energy2d(u, z), jsyn.energy2d(u, z))


def test_pretrain_step_matches_jax():
    """One eps-matching step at the same x0, steps and noise (the JAX
    entry's ``pre_update`` with its draws replayed): loss and parameters
    after Adam(1e-3) at 1e-5."""
    eps, _, pe, _ = _jax_nets()
    js = JVAR(eps, n_timesteps=T, sample_shape=(2,),
              trainable_beta="fix_last")
    sch = js.schedule
    x0 = jsyn.sample2d("8gaussians", B, np.random.RandomState(0))
    k1, k2 = jax.random.split(jax.random.key(7))
    i = jax.random.randint(k1, (B,), 0, T)
    noise = jax.random.normal(k2, x0.shape)
    gbar = jnp.take(sch.gamma_bar, T - 1 - i)[:, None]
    x_t = jnp.sqrt(gbar) * x0 + jnp.sqrt(1 - gbar) * noise

    def loss_fn(p):
        return ((eps.apply({"params": p}, x_t, jnp.take(sch.tau, i))
                 - noise) ** 2).mean()

    opt = optax.adam(1e-3)
    loss, g = jax.value_and_grad(loss_fn)(pe)
    up, _ = opt.update(g, opt.init(pe), pe)
    new = optax.apply_updates(pe, up)

    args = train_2d.parser().parse_args(
        ["--n_timesteps", str(T), "--batchsize", str(B), "--device", "cpu"])
    sampler, _, _ = train_2d.build(args, torch.device("cpu"))
    sampler.net.load_state_dict(module_from_flax(sampler.net, _np(pe)))
    popt = Adam(list(sampler.net.parameters()), 1e-3)
    ploss = train_2d.pretrain_step(
        sampler, popt, torch.from_numpy(x0),
        torch.from_numpy(np.asarray(i)).long(),
        torch.from_numpy(np.asarray(noise)))
    np.testing.assert_allclose(float(ploss), float(loss), rtol=1e-5)
    want = module_from_flax(sampler.net, _np(new))
    for k, p in sampler.net.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[k].numpy(),
                                   rtol=0, atol=1e-5, err_msg=k)


def _jax_2d():
    eps, val, pe, pv = _jax_nets()
    sampler = JVAR(eps, n_timesteps=T, sample_shape=(2,),
                   trainable_beta="fix_last")
    tr = JTrainer(batchsize=B, tau1=HPARAMS["tau1"], tau2=HPARAMS["tau2"],
                  gamma=1.0, n_timesteps=T, use_sampler_beta=True,
                  adavelreg=0.99, time_cost=0.0, time_cost_sig=1.0)
    tr.set_models(sampler, val, lr=HPARAMS["lr"], v_lr=HPARAMS["v_lr"],
                  beta_lr=HPARAMS["beta_lr"])
    sp = sampler.init_params(jax.random.key(3), net_params=pe)
    return sampler, tr, tr.init_state(sp, pv)


def test_one_2d_iteration_matches_jax():
    """One iteration of train_2d's trainer on the same trajectory, data and
    draws (update_sampler's permutation and noise from its key): every
    metric at 1e-5, the value's and the policy's parameters after."""
    sampler, tr, state = _jax_2d()
    x = jnp.asarray(jsyn.sample2d("8gaussians", B, np.random.RandomState(0)))
    sk, uk, gk = jax.random.split(jax.random.key(11), 3)
    d = sampler.sample(state.sampler_params, sk, B)
    traj = jbuf.from_d_sample(d)
    state1, m1 = tr.update_f_v(state, x, traj, uk)
    state2, m2 = tr.update_sampler(state1, traj, gk, n_generator=1)

    args = train_2d.parser().parse_args(
        ["--n_timesteps", str(T), "--batchsize", str(B), "--device", "cpu",
         "--tau1", str(HPARAMS["tau1"]), "--tau2", str(HPARAMS["tau2"]),
         "--lr", str(HPARAMS["lr"]), "--v_lr", str(HPARAMS["v_lr"]),
         "--beta_lr", str(HPARAMS["beta_lr"])])
    ps, pv, ptr = train_2d.build(args, torch.device("cpu"))
    ps.net.load_state_dict(module_from_flax(
        ps.net, _np(state.sampler_params["net"])))
    pv.load_state_dict(module_from_flax(pv, _np(state.v_params)))
    with torch.no_grad():
        ps.log_betas.copy_(torch.from_numpy(np.asarray(
            state.sampler_params["log_betas"])))
    buf = from_d_sample({k: torch.from_numpy(np.asarray(d[k])) for k in
                         ("l_sample", "sigma", "logp", "entropy", "mean")})
    pm1 = ptr.update_f_v(torch.from_numpy(np.asarray(x)), buf)
    kk, pkey = jax.random.split(gk)
    k_step, _ = jax.random.split(jax.random.split(kk, 1)[0])
    pm2 = ptr.update_sampler(
        buf, n_generator=1,
        perm=torch.from_numpy(np.asarray(jax.random.permutation(
            pkey, T * B))).long(),
        noise=[torch.from_numpy(np.asarray(jax.random.normal(
            k_step, (B, 2))))])
    for k, v in {**m1, **m2}.items():
        np.testing.assert_allclose(np.asarray({**pm1, **pm2}[k]),
                                   np.asarray(v), rtol=1e-5, atol=1e-5,
                                   err_msg=k)
    for k, p in module_from_flax(pv, _np(state2.v_params)).items():
        np.testing.assert_allclose(dict(pv.named_parameters())[k].detach()
                                   .numpy(), p.numpy(), atol=1e-5,
                                   err_msg=k)
    for k, p in module_from_flax(ps.net, _np(
            state2.sampler_params["net"])).items():
        np.testing.assert_allclose(dict(ps.net.named_parameters())[k]
                                   .detach().numpy(), p.numpy(), atol=1e-5,
                                   err_msg=k)


def test_pretrain_cache_both_ways(tmp_path):
    """A cache of JAX's (``to_bytes``) loads into the port, and the port's
    loads into JAX (``from_bytes``) with the same values."""
    eps, _, pe, _ = _jax_nets()
    path = str(tmp_path / "pre.msgpack")
    with open(path, "wb") as f:
        f.write(fser.to_bytes(pe))
    args = train_2d.parser().parse_args(
        ["--pretrain_cache", path, "--device", "cpu"])
    sampler, _, _ = train_2d.build(args, torch.device("cpu"))
    train_2d.pretrain(args, sampler, np.random.RandomState(0),
                      torch.device("cpu"))
    x = np.random.RandomState(2).randn(4, 2).astype(np.float32)
    t = np.arange(4, dtype=np.float32)
    with torch.no_grad():
        np.testing.assert_allclose(
            sampler.net(torch.from_numpy(x), torch.from_numpy(t)).numpy(),
            np.asarray(eps.apply({"params": pe}, x, t)), rtol=1e-6,
            atol=1e-6)
    out = str(tmp_path / "port.msgpack")
    msgpack.write(out, flax_tree(sampler.net))
    restored = fser.from_bytes(pe, open(out, "rb").read())
    jax.tree.map(np.testing.assert_array_equal, _np(restored), _np(pe))


def test_train_2d_cli(tmp_path):
    """The entry end to end on the CPU: pretraining written to the cache,
    a few iterations with the curve in JAX's layout, the samples file; a
    second run loads the cache."""
    cache = str(tmp_path / "c" / "pre.msgpack")
    curve = str(tmp_path / "curve.json")
    cmd = [sys.executable, "-m", "dxmi_tpu_torch.train_2d", "--device",
           "cpu", "--pretrain_iters", "5", "--n_iter", "4", "--batchsize",
           "32", "--eval_every", "2", "--eval_n", "64", "--curve_out",
           curve, "--pretrain_cache", cache, "--out", str(tmp_path / "o")]
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    r = subprocess.run(cmd, cwd=tmp_path, env=env, capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    assert "pretrained policy saved to" in r.stdout
    assert "mean log-likelihood under true pdf" in r.stdout
    data = json.load(open(curve))
    assert [p["iter"] for p in data["curve"]] == [0, 2, 4]
    assert data["config"]["n_iter"] == 4
    assert np.load(tmp_path / "o" / "8gaussians_samples.npy").shape == (
        2000, 2)
    r = subprocess.run(cmd, cwd=tmp_path, env=env, capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 0 and "pretrained policy loaded from" in r.stdout
