"""The pretraining entries of the port (``pretrain_ddpm``,
``pretrain_ddgan``, ``pretrain_edm``) and flax's initialisers
(``models/flax_init.py``), against the JAX package: the initialisers'
per-tensor statistics against JAX's ``init_params``, pretrain_ddgan's
update against the golden (``tests/torch_fixtures/distill_golden.npz``;
pretrain_ddpm's and the EDM loss are held in ``test_torch_distill.py``),
and each entry's CLI for 2 steps: its file byte-equal to JAX's
``save_checkpoint`` of the same parameters, read by JAX's
``load_sampler_params`` (what its entries load) and by the port's training
entries, bit for bit."""
import os
import sys

import jax
import numpy as np
import pytest
import torch
from flax import serialization

import chip_smoke
from dxmi_tpu.utils import checkpoint as jax_ckpt
from dxmi_tpu.utils.convert import convert_unet_adm, convert_unet_small
from dxmi_tpu_torch import (pretrain_ddgan, pretrain_ddpm, pretrain_edm,
                            train_cifar10)
from dxmi_tpu_torch.config import load_yaml, merge, parse_nested_args, to_yaml
from dxmi_tpu_torch.train_image_large import build_sampler
from dxmi_tpu_torch.utils.checkpoint import save_checkpoint
from dxmi_tpu_torch.utils.train_state import flax_tree

REPO = chip_smoke.REPO
# gradient norms of conv biases that feed a GroupNorm are fp32 noise (see
# test_torch_distill.py): 1e-6 of the largest norm is added to each limit
GRAD_FLOOR = 1e-6


@pytest.fixture(scope="module")
def golden():
    return dict(np.load(chip_smoke.DISTILL_GOLDEN))


def test_flax_initialisers_match_jax_init_params(golden):
    """UNetSmall, UNetADM and NCSN++ at small widths drawn by flax_init_:
    per parameter the flax path and shape of JAX's init_params, its exact
    zeros (the zero-initialised convs, biases) and ones (GroupNorm
    scales), its std within 5% of JAX's (4 standard errors for tensors
    under 6400 elements), lecun_normal's truncation; log_betas as the
    sampler's own formula."""
    assert chip_smoke.flax_init_check(golden, "cpu") <= 1


def test_adm_zero_layers_and_embedding():
    """The layers flax zeroes on purpose are zero after flax_init_ (and
    seeded_normal_ keeps none zero); the class embedding is an untruncated
    normal of variance 1/features."""
    from dxmi_tpu_torch.models.flax_init import flax_init_
    from dxmi_tpu_torch.models.unet_adm import UNetADM, seeded_normal_
    net = UNetADM(**dict(chip_smoke.DISTILL_SMALL, num_classes=1000))
    flax_init_(net, torch.Generator().manual_seed(0))
    zero = [k for k, v in net.named_parameters()
            if v.dim() == 4 and not v.any()]
    assert zero and all(k.endswith(("out_layers.3.weight",
                                    "proj_out.weight", "out.2.weight"))
                        for k in zero)
    emb = net.label_emb.weight
    assert abs(float(emb.std()) * emb.shape[1] ** 0.5 - 1) < 0.01
    assert float(emb.abs().max()) > 2.5 / emb.shape[1] ** 0.5
    seeded_normal_(net, 0)
    assert all(v.any() for v in net.parameters())


def test_ddgan_update_matches_the_golden(golden):
    """pretrain_ddgan's loss on the small NCSN++ with JAX's ti, eps and z
    (1e-5) and its gradient's norm per tensor (1e-4, plus GRAD_FLOOR of
    the largest)."""
    loss, gnorm = chip_smoke.ddgan_update_replay(golden, "cpu")
    ref = float(golden["ddgan/loss"])
    assert abs(loss - ref) <= 1e-5 * ref
    top = max(float(golden[f"ddgan/gnorm/{k}"]) for k in gnorm)
    for k, v in gnorm.items():
        want = float(golden[f"ddgan/gnorm/{k}"])
        assert abs(v - want) <= 1e-4 * want + GRAD_FLOOR * top, k


def _jax_tree(sampler, kind):
    """The sampler's parameters as the JAX package's own converters lay
    them out ({'log_betas', 'net'})."""
    state = {k: v.detach().numpy() for k, v in sampler.net.state_dict()
             .items()}
    conv = {"unet_small": convert_unet_small, "unet_adm": convert_unet_adm}
    return {"log_betas": sampler.log_betas.detach().numpy(),
            "net": conv[kind](state)["params"]}


@pytest.mark.parametrize("kind", ["unet_small", "unet_adm"])
def test_save_checkpoint_bytes_equal_jax(tmp_path, kind):
    """save_checkpoint writes the bytes of JAX's save_checkpoint for the
    same parameters, laid out by the JAX package's own torch-to-flax
    converters."""
    samplers = chip_smoke.init_samplers("cpu", torch.Generator())
    ours, theirs = tmp_path / "port.msgpack", tmp_path / "jax.msgpack"
    save_checkpoint(str(ours), samplers[kind], meta={"pretrain_steps": 3})
    jax_ckpt.save_checkpoint(str(theirs), _jax_tree(samplers[kind], kind),
                             meta={"pretrain_steps": 3})
    assert ours.read_bytes() == theirs.read_bytes()


def _small_adm_config(tmp_path):
    cfg = load_yaml(os.path.join(chip_smoke.ADM_FIXTURE_DIR, "config.yaml"))
    cfg["training"]["pretrained_path"] = None
    path = tmp_path / "adm_small.yaml"
    path.write_text(to_yaml(cfg))
    return str(path), cfg


def _run(monkeypatch, module, argv):
    monkeypatch.setattr(sys, "argv", [module.__name__, *argv])
    module.main()


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield "/".join(prefix + (k,)), np.asarray(v)


ENTRIES = {
    "ddpm": (pretrain_ddpm, ["--ch", "32", "--batch", "2", "--fake_data"],
             "eps-loss"),
    "ddgan": (pretrain_ddgan, ["--batch", "1", "--fake_data"], "x0-mse"),
    "edm": (pretrain_edm, ["--batch", "2", "--data_size", "8"], "edm-loss"),
}


@pytest.mark.parametrize("name", sorted(ENTRIES))
def test_entry_cli(tmp_path, monkeypatch, capsys, name, golden):
    """The entry for 2 steps on the CPU (pretrain_ddgan at NCSNppArgs' full
    width, the others small): JAX's log lines, a finite loss; the file is
    JAX's payload (meta pretrain_steps 2), byte-equal to JAX's
    save_checkpoint of the tree it holds (pretrain_ddpm's at the golden's
    width, with the paths of JAX's init_params; the small NCSN++'s and
    ADM's paths are held in test_flax_initialisers_match_jax_init_params),
    read by JAX's load_sampler_params and by the port's training entry
    (train_cifar10's build, train_image_large's build_sampler) bit for
    bit."""
    module, argv, tag = ENTRIES[name]
    out = tmp_path / "pre.msgpack"
    monkeypatch.chdir(tmp_path)
    extra = []
    if name == "edm":
        extra = ["--config", _small_adm_config(tmp_path)[0]]
    _run(monkeypatch, module, ["--out", str(out), "--steps", "2",
                               "--log_every", "1", "--device", "cpu",
                               *argv, *extra])
    lines = capsys.readouterr().out.splitlines()
    losses = [float(ln.split()[-1]) for ln in lines if tag in ln]
    assert len(losses) == 2 and np.isfinite(losses).all()

    blob = out.read_bytes()
    payload = serialization.msgpack_restore(blob)
    assert payload["meta"] == {"pretrain_steps": 2}
    again = tmp_path / "jax.msgpack"
    jax_ckpt.save_checkpoint(str(again), payload["params"],
                             meta={"pretrain_steps": 2})
    assert again.read_bytes() == blob
    stored = dict(_flat(payload["params"]))
    if name == "ddpm":  # at the golden's width: JAX's init_params' paths
        assert sorted(stored) == sorted(
            str(p) for p in golden["init/unet_small/paths"])
    loaded = dict(_flat(jax.tree.map(np.asarray,
                                     jax_ckpt.load_sampler_params(str(out)))))
    assert loaded.keys() == stored.keys()
    assert all(np.array_equal(loaded[k], stored[k]) for k in stored)

    if name == "edm":
        cfg = _small_adm_config(tmp_path)[1]
        cfg["training"]["pretrained_path"] = str(out)
        sampler = build_sampler(cfg, torch.device("cpu"), 0)
    else:
        cfg = merge(load_yaml(os.path.join(
            REPO, "configs", "cifar10",
            "T10.yaml" if name == "ddpm" else "T4_ddgan.yaml")),
            load_yaml(os.path.join(REPO, "configs", "cifar10",
                                   "cifar10.yaml")))
        over = {"training.sampler_ckpt": str(out), "value.net.nh": 16}
        if name == "ddpm":
            over["sampler_net.ch"] = 32
        cfg = merge(cfg, parse_nested_args(over))
        sampler = train_cifar10.build(cfg, torch.device("cpu"), 0)[0]
    got = dict(_flat(flax_tree(sampler)))
    assert got.keys() == stored.keys()
    assert all(np.array_equal(got[k], stored[k]) for k in stored)
