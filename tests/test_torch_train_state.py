"""Train-state resume in the JAX package's ``train_state.msgpack`` layout
(``dxmi_tpu_torch/utils/train_state.py``, ``utils/checkpoint.py``
``save_train_state``/``load_train_state``), held against ``dxmi_tpu``:

- the layout, for every trainer configuration that the repo's configs and
  the entries' overrides build, equals ``jax.tree_util.tree_flatten_with_path``
  of the JAX ``DxMIState`` leaf by leaf: key path, shape and dtype;
- a file written by the JAX trainer after two iterations resumes in the
  port, whose third iteration (JAX's draws injected) matches JAX's third
  at rtol 1e-4 / atol 1e-4 in every leaf (parameters, ``mu``, ``nu``,
  ``count``, ``betas_for_q``), each group's change within 1e-3 of JAX's:
  the CIFAR trainer (Adam with the clip), the Cond trainer (RAdam,
  ``nan_guard``, forward betas) and the trainer with a separate ``f``;
- a file the port writes loads through JAX's ``load_train_state`` with
  JAX's template, bit for bit, with equal meta;
- a file with one leaf of another shape or dtype, or another leaf count,
  is refused and the leaf named.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from dxmi_tpu_torch.config import (load_yaml, merge, parse_nested_args,
                                   parse_unknown_args)
from dxmi_tpu_torch.trainers.optim import Adam, ApplyIfFinite, RAdam
from dxmi_tpu_torch.utils import msgpack as port_msgpack
from dxmi_tpu_torch.utils.checkpoint import (load_train_state,
                                             save_train_state)
from dxmi_tpu_torch.utils.train_state import trainer_slots
from torch_fixtures import trainer_cases as tc

REPO = chip_smoke.REPO
_CFG = os.path.join(REPO, "configs")

# (config, overrides, fast levers, separate energy): every trainer
# configuration the four configs families and the entries' overrides build
LAYOUTS = {
    "cifar10_T10": ("cifar10/T10.yaml", chip_smoke.SHRUNK_CIFAR_ARGS, False,
                    False),
    "cifar10_T10_levers": ("cifar10/T10.yaml", chip_smoke.SHRUNK_CIFAR_ARGS,
                           True, False),
    "cifar10_T10_f": ("cifar10/T10.yaml", chip_smoke.SHRUNK_CIFAR_ARGS,
                      False, True),
    "cifar10_T4_ddgan": ("cifar10/T4_ddgan.yaml",
                         chip_smoke.SHRUNK_DDGAN_ARGS, False, False),
    "imagenet64_T10": ("imagenet64/T10.yaml", [
        *chip_smoke.SHRUNK_TRAIN_ARGS, "--diffusion.use_fp16", "True"],
        False, False),
    "imagenet64_conv16": ("imagenet64/conv16.yaml", [], False, False),
    "lsun_T4": ("lsun/T4.yaml", chip_smoke.SHRUNK_LSUN_ARGS
                + chip_smoke.SHRUNK_LSUN_VALUE["IGEBMEncoder"], False, False),
    "lsun_T4_wide": ("lsun/T4_wide.yaml", chip_smoke.SHRUNK_LSUN_ARGS
                     + chip_smoke.SHRUNK_LSUN_VALUE["WideResNet"], False,
                     False),
    "lsun_T10": ("lsun/T10.yaml", chip_smoke.SHRUNK_LSUN_ARGS
                 + chip_smoke.SHRUNK_LSUN_VALUE["IGEBMEncoder"], False,
                 False),
    # a spectral-norm value and a spectral-norm f: v_stats and f_stats
    "cifar10_T10_sn": ("cifar10/T10.yaml", [
        *chip_smoke.SHRUNK_CIFAR_ARGS, "--value.net.use_spectral_norm",
        "true"], False, "sn"),
}


def _config(name):
    path, over, _, _ = LAYOUTS[name]
    return merge(load_yaml(os.path.join(_CFG, path)),
                 parse_nested_args(parse_unknown_args(list(over))))


def _jax_layout(name, concrete=False):
    """(keystr, shape, dtype) of every leaf of the JAX entries' state for
    ``name``, traced with ``jax.eval_shape`` (nothing compiled); with
    ``concrete``, the initial state itself."""
    from dxmi_tpu import config as cfglib
    from dxmi_tpu.models.igebm import IGEBMEncoder

    cfg, (_, _, levers, with_f) = _config(name), LAYOUTS[name]
    tr = cfg["training"]
    if "diffusion" in cfg:
        from dxmi_tpu.models.unet_adm import create_unet_adm
        from dxmi_tpu.samplers.edm import EDMSampler, KarrasDenoiser

        d = dict(cfg["diffusion"])
        smin, smax = d.pop("sigma_min", 0.002), d.pop("sigma_max", 80.0)
        d.pop("weight_schedule", None)
        dist = d.pop("distillation", False)
        sampler = EDMSampler(create_unet_adm(**d), KarrasDenoiser(
            sigma_min=smin, sigma_max=smax, distillation=dist),
            **cfg["sampler"])
        vcfg = cfg["value"]
    else:
        over = (dict(dtype=jnp.bfloat16, softmax_f32=False,
                     softmax_nomax=True, up_impl="phase") if levers else {})
        net = cfglib.instantiate(cfg["sampler_net"], **over)
        sampler = cfglib.instantiate(cfg["sampler"], net=net)
        vcfg = cfg["value"]
        if levers:
            vcfg = {**vcfg, "net": {**vcfg["net"], "dtype": jnp.bfloat16}}
    value = cfglib.instantiate(vcfg)
    trainer = cfglib.instantiate(cfg["trainer"], batchsize=tr["batchsize"],
                                 n_timesteps=cfg["sampler"]["n_timesteps"])
    energy = (IGEBMEncoder(nh=8, keepdim=False,
                           use_spectral_norm=with_f == "sn")
              if with_f else None)
    trainer.set_models(sampler, value, lr=1e-5, v_lr=1e-5, energy=energy)
    x = jnp.zeros((1, *sampler.sample_shape))
    y = jnp.zeros((1,), jnp.int32)

    def init(key):
        vv = value.init(key, x, y)
        fv = energy.init(key, x) if with_f else {}
        return trainer.init_state(
            sampler.init_params(key), vv["params"],
            f_params=fv.get("params"), v_stats=vv.get("sn_stats"),
            f_stats=fv.get("sn_stats"))

    if not concrete:
        state = jax.eval_shape(init, jax.random.key(0))
        return [(jax.tree_util.keystr(p), tuple(a.shape), str(a.dtype))
                for p, a in jax.tree_util.tree_flatten_with_path(state)[0]]
    return init(jax.random.key(0))


def _port_trainer(name):
    """The port entries' trainer for ``name`` on the CPU."""
    from dxmi_tpu_torch import train_cifar10, train_image_large
    from dxmi_tpu_torch.config import instantiate
    from dxmi_tpu_torch.models.igebm import IGEBMEncoder

    cfg, (_, _, levers, with_f) = _config(name), LAYOUTS[name]
    tr = cfg["training"]
    cpu = torch.device("cpu")
    if "diffusion" in cfg:
        cfg["training"]["pretrained_path"] = None
        sampler = train_image_large.build_sampler(cfg, cpu, 0)
        value = instantiate(cfg["value"])
        trainer = instantiate(cfg["trainer"], batchsize=tr["batchsize"],
                              n_timesteps=cfg["sampler"]["n_timesteps"])
    else:
        cfg["training"]["sampler_ckpt"] = None
        sampler, value, trainer = train_cifar10.build(cfg, cpu, 0,
                                                      levers=levers)
    energy = (IGEBMEncoder(nh=8, keepdim=False,
                           use_spectral_norm=with_f == "sn")
              if with_f else None)
    trainer.set_models(sampler, value, lr=1e-5, v_lr=1e-5, energy=energy)
    return trainer


@pytest.mark.parametrize("name", sorted(LAYOUTS))
def test_layout_matches_jax(name):
    want = _jax_layout(name)
    got = [(s.name, s.shape, s.dtype) for s in
           trainer_slots(_port_trainer(name))]
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g == w, (i, g, w)


def test_optimizer_state_round_trip():
    """``state``/``load_state`` carry optax's fields: a restored Adam,
    RAdam and guard take the next step as the originals do."""
    gen = torch.Generator().manual_seed(0)
    p0 = [torch.randn(3, 4, generator=gen), torch.randn(5, generator=gen)]
    grads = [[torch.randn(3, 4, generator=gen), torch.randn(
        5, generator=gen)] for _ in range(7)]
    for cls in (Adam, RAdam):
        a_params = [p.clone() for p in p0]
        b_params = [p.clone() for p in p0]
        a, b = cls(a_params, 1e-2), cls(b_params, 1e-2)
        ga, gb = ApplyIfFinite([a], 3), ApplyIfFinite([b], 3)
        for g in grads[:6]:
            ga.step([g])
        ga.step([[torch.full((3, 4), float("nan")), grads[0][1]]])
        st, gst = a.state(), ga.state()
        assert st["count"].dtype == np.int32 and int(st["count"]) == 6
        assert gst == {"notfinite_count": 1, "last_finite": False,
                       "total_notfinite": 1}
        assert gst["last_finite"].dtype == np.bool_
        with torch.no_grad():
            for dst, src in zip(b_params, a_params):
                dst.copy_(src)
        b.load_state(st["count"], st["mu"], st["nu"])
        gb.load_state(**gst)
        ga.step([grads[6]])
        gb.step([grads[6]])
        for x, y in zip(a_params, b_params):
            assert torch.equal(x, y)
        assert ga.state() == gb.state()


@pytest.fixture(scope="module", params=tc.CASES)
def resumed(request, tmp_path_factory):
    """JAX: two iterations, the state file, the third iteration. Port: the
    file loaded, the third iteration on JAX's trajectory and draws."""
    case = request.param
    jc = tc.JaxCase(case)
    state = jc.state
    for it in (0, 1):
        state, _, _ = jc.iteration(state, it)
    state2 = state
    state3, m3, d3 = jc.iteration(state2, 2)
    trainer = tc.port_trainer(case)
    before = tc.port_leaves(trainer)
    meta = tc.jax_to_port(jc, state2, trainer,
                          tmp_path_factory.mktemp(case))
    loaded = tc.port_leaves(trainer)
    m_port = tc.port_iteration(jc, trainer, d3, 2)
    return dict(jc=jc, state2=state2, state3=state3, m3=m3, meta=meta,
                trainer=trainer, before=before, loaded=loaded,
                m_port=m_port, tmp=tmp_path_factory.mktemp(case + "_out"))


def test_jax_file_loads_bit_for_bit(resumed):
    """Every leaf of the JAX file lands in the port as it was (the port's
    own initial weights all differ), and the meta comes back."""
    r = resumed
    want = tc.jax_leaves(r["state2"])
    assert len(r["loaded"]) == len(want)
    for got, w in zip(r["loaded"], want):
        assert got.dtype == w.dtype and got.shape == w.shape
        assert got.tobytes() == w.tobytes()
    assert r["meta"] == {"i_iter": 2, "epoch": 1, "best_fid": 0.5}
    changed = [not np.array_equal(a, b) for a, b in
               zip(r["before"], r["loaded"]) if a.size > 1]
    assert sum(changed) > 0.9 * len(changed)


def test_resume_continues_as_jax(resumed):
    """The port's third iteration from the JAX file against JAX's third:
    every leaf within rtol 1e-4 / atol 1e-4, the counts equal to the steps
    taken, and the change of every moment and parameter group within 1e-3
    of JAX's change (the sampler's parameters and moments 1e-2), so the
    iteration itself is held, not only its small steps; the metrics within
    1e-4."""
    r = resumed
    slots = trainer_slots(r["trainer"])
    got, want = tc.port_leaves(r["trainer"]), tc.jax_leaves(r["state3"])
    prev = tc.jax_leaves(r["state2"])
    assert len(got) == len(want)
    num, den = {}, {}
    for slot, g, w, p in zip(slots, got, want, prev):
        assert g.dtype == w.dtype and g.shape == w.shape, slot.name
        if g.dtype != np.float32:
            assert np.array_equal(g, w), slot.name
            continue
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4,
                                   err_msg=slot.name)
        fam = slot.name.split("[")[0] + (".mu" if ".mu" in slot.name else
                                         ".nu" if ".nu" in slot.name else "")
        num[fam] = num.get(fam, 0.0) + float(
            ((g.astype(np.float64) - w) ** 2).sum())
        den[fam] = den.get(fam, 0.0) + float(
            ((w.astype(np.float64) - p) ** 2).sum())
    for fam in num:
        assert den[fam] > 0, fam
        # the sampler's Adam/RAdam steps are +-lr where its gradient sits
        # at the noise floor, and the Cond trainer's next minibatch takes
        # its gradient there: 1e-2 of the change over the whole sampler and
        # its moments, as test_torch_train_slice.py holds the sampler (cond:
        # 4.0e-3 parameters, 6.6e-3 mu measured; cifar and f below 1e-3)
        lim = 1e-2 if "sampler" in fam else 1e-3
        assert np.sqrt(num[fam] / den[fam]) < lim, (fam, num[fam], den[fam])
    # the counts are the steps taken in three iterations
    G = tc.T if r["jc"].cond else 1
    f = r["jc"].case == "f"
    want_counts = {".opt_state_v": 3 * (tc.T + (0 if f else 1)),
                   ".opt_state_f": 3, ".opt_state_sampler": 3 * G}
    counts = {s.name: int(g) for s, g in zip(slots, got)
              if s.name.endswith(".count")}
    assert len(counts) == (4 if f else 3)
    for name, c in counts.items():
        assert c == want_counts[name.split("[")[0].split(".inner")[0]], name
    for k, v in r["m3"].items():
        np.testing.assert_allclose(
            r["m_port"][k].detach().numpy(), np.asarray(v), rtol=1e-4,
            atol=1e-4, err_msg=k)


def test_port_file_loads_in_jax(resumed):
    """A file the port writes (after its resumed iteration) loads through
    the JAX package's ``load_train_state`` with JAX's template: every leaf
    bit for bit, the tree of JAX's state, the meta equal; and its bytes are
    ``flax.serialization.msgpack_serialize``'s of the same payload."""
    from flax import serialization

    from dxmi_tpu.utils import checkpoint as jck

    r = resumed
    out = str(r["tmp"])
    save_train_state(out, r["trainer"], i_iter=3, epoch=1, best_fid=0.25)
    assert sorted(os.listdir(out)) == ["train_state.msgpack"]
    state, meta = jck.load_train_state(out, r["jc"].state)
    assert meta == {"i_iter": 3, "epoch": 1, "best_fid": 0.25}
    assert jax.tree.structure(state) == jax.tree.structure(r["jc"].state)
    got = tc.port_leaves(r["trainer"])
    for a, b in zip(jax.tree.leaves(state), got):
        a = np.asarray(a)
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()
    with open(os.path.join(out, "train_state.msgpack"), "rb") as f:
        blob = f.read()
    assert blob == serialization.msgpack_serialize({
        "leaves": {str(i): a for i, a in enumerate(got)},
        "meta": {"i_iter": 3, "epoch": 1, "best_fid": 0.25}})


def test_spectral_norm_state_both_ways(tmp_path):
    """A state with a spectral-norm value and f (``v_stats`` and
    ``f_stats`` beside the parameters) written by JAX loads into the port
    bit for bit, the stats into the nets' buffers; the port's file loads
    into JAX's template bit for bit."""
    from dxmi_tpu.utils import checkpoint as jck
    from dxmi_tpu_torch.utils.train_state import sn_buffers

    state = _jax_layout("cifar10_T10_sn", concrete=True)
    assert state.v_stats is not None and state.f_stats is not None
    jck.save_train_state(str(tmp_path), state, i_iter=4, epoch=0)
    trainer = _port_trainer("cifar10_T10_sn")
    meta = load_train_state(str(tmp_path), trainer)
    assert meta["i_iter"] == 4
    leaves = [np.asarray(a) for a in jax.tree.leaves(state)]
    got = tc.port_leaves(trainer)
    assert len(got) == len(leaves)
    for a, b in zip(leaves, got):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    u = np.asarray(state.f_stats["SpectralNorm_0"]["conv1/kernel/u"])
    np.testing.assert_array_equal(trainer.energy.conv1.u.numpy(), u)
    assert len(sn_buffers(trainer.value)) == len(sn_buffers(
        trainer.energy)) == 32
    out = tmp_path / "port"
    out.mkdir()
    save_train_state(str(out), trainer, i_iter=5, epoch=1)
    back, meta = jck.load_train_state(str(out), state)
    assert meta["i_iter"] == 5
    for a, b in zip(jax.tree.leaves(back), leaves):
        assert np.asarray(a).tobytes() == b.tobytes()


@pytest.mark.parametrize("fault", ["shape", "dtype", "count"])
def test_refuses_a_mismatched_file(fault, tmp_path):
    """A file whose leaf count, or one leaf's shape or dtype, differs from
    the trainer's configuration is refused before anything is restored,
    the first differing leaf named."""
    trainer = tc.port_trainer("cifar")
    save_train_state(str(tmp_path), trainer, i_iter=1, epoch=0)
    path = str(tmp_path / "train_state.msgpack")
    payload = port_msgpack.read(path)
    names = [s.name for s in trainer_slots(trainer)]
    i = next(j for j, n in enumerate(names)
             if n.startswith(".v_params") and n.endswith("['kernel']"))
    leaf = payload["leaves"][str(i)]
    if fault == "shape":
        payload["leaves"][str(i)] = leaf[..., :-1]
        match = rf"leaf {i} \({__import__('re').escape(names[i])}\)"
    elif fault == "dtype":
        payload["leaves"][str(i)] = leaf.astype(np.float64)
        match = rf"leaf {i} .*float64"
    else:
        del payload["leaves"][str(len(names) - 1)]
        match = "does not match"
    port_msgpack.write(path, payload)
    before = tc.port_leaves(trainer)
    with pytest.raises(ValueError, match=match):
        load_train_state(str(tmp_path), trainer)
    for a, b in zip(before, tc.port_leaves(trainer)):
        assert np.array_equal(a, b)
