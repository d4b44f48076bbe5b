"""The training entries refuse a sampler checkpoint that does not match
their net: ``train_cifar10.build`` on the trained CIFAR fixture's
``sampler_best.pth`` and ``train_image_large.build_sampler`` on the ADM
fixture's ``sampler.pth``, each with one key renamed, raise ``KeyError``
(the JAX entries fail at their first forward on such a checkpoint). A
checkpoint missing only ``log_betas`` still loads.

The generation entries' run-dir lookup (``resolve_run_checkpoint``) walks
the JAX package's order on each run-dir layout and resolves the file JAX
resolves; a msgpack file it resolves loads to the weights JAX loads. So
does a msgpack ``sampler_ckpt`` in ``train_cifar10.build``."""
import os

import jax
import numpy as np
import pytest
import torch
from flax import serialization

import chip_smoke
from dxmi_tpu.utils import checkpoint as jax_checkpoint
from dxmi_tpu.utils import convert as jax_convert
from dxmi_tpu_torch import train_cifar10, train_image_large
from dxmi_tpu_torch.utils.checkpoint import (load_sampler_state,
                                             resolve_run_checkpoint)
from dxmi_tpu_torch.utils.convert import var_sampler_from_flax


def _cifar_cfg(path):
    cfg = chip_smoke.fixture_config()
    cfg["training"]["sampler_ckpt"] = str(path)
    return cfg


def _adm_cfg(path):
    cfg = chip_smoke.adm_fixture_config()
    cfg["training"]["pretrained_path"] = str(path)
    return cfg


def _renamed(src, old, new, dst):
    ckpt = torch.load(src, map_location="cpu", weights_only=False)
    sd = ckpt["state_dict"]
    sd[new] = sd.pop(old)
    torch.save(ckpt, dst)
    return dst


CASES = {
    "cifar": (os.path.join(chip_smoke.FIXTURE_DIR, "sampler_best.pth"),
              "conv_out.weight", _cifar_cfg,
              lambda cfg: train_cifar10.build(cfg, torch.device("cpu"), 0)),
    "adm": (os.path.join(chip_smoke.ADM_FIXTURE_DIR, "sampler.pth"),
            "out.2.weight", _adm_cfg,
            lambda cfg: train_image_large.build_sampler(
                cfg, torch.device("cpu"), 0)),
}


@pytest.mark.parametrize("entry", sorted(CASES))
def test_renamed_key_raises(tmp_path, entry):
    src, key, make_cfg, build = CASES[entry]
    assert f"net.{key}" in load_sampler_state(src)
    bad = _renamed(src, key, key + "_renamed", tmp_path / "bad.pth")
    with pytest.raises(KeyError, match=key):
        build(make_cfg(bad))


@pytest.mark.parametrize("entry", sorted(CASES))
def test_checkpoint_without_log_betas_loads(tmp_path, entry):
    src, key, make_cfg, build = CASES[entry]
    ckpt = torch.load(src, map_location="cpu", weights_only=False)
    ckpt["state_dict"].pop("log_betas", None)
    path = tmp_path / "ok.pth"
    torch.save(ckpt, path)
    out = build(make_cfg(path))
    sampler = out[0] if isinstance(out, tuple) else out
    want = ckpt["state_dict"][key]
    assert torch.equal(sampler.net.state_dict()[key].float(), want.float())


# run-dir layouts: the files present, and the (name, which) looked up
LAYOUTS = {
    "msgpack_best_beside_pth": (("sampler_best.msgpack", "sampler.pth"),
                                ("sampler", "best")),
    "msgpack_plain_beside_pth_best": (("sampler.msgpack",
                                       "sampler_best.pth"),
                                      ("sampler", "best")),
    "pt_only": (("value_best.pt",), ("value", "best")),
    "pt_plain_only": (("value.pt",), ("value", "last")),
    "pth_before_pt": (("sampler_last.pt", "sampler.pth"),
                      ("sampler", "last")),
    "pth_best_before_plain": (("sampler.pth", "sampler_best.pth"),
                              ("sampler", "best")),
    "other_which_only": (("sampler_last.pth",), ("sampler", "best")),
}


def _narrow_sampler_payload():
    """A narrow UNetSmall sampler as the JAX package writes it: the CIFAR
    fixture's ``sampler_best.pth`` converted by ``convert_unet_small`` into
    ``save_checkpoint``'s ``{'params': {'net', 'log_betas'}, 'meta'}``."""
    state = jax_checkpoint.load_torch_checkpoint(
        os.path.join(chip_smoke.FIXTURE_DIR, "sampler_best.pth"))
    state.pop("__meta__")
    out = jax_convert.convert_unet_small(state)
    return {"params": {"net": out["params"], "log_betas": out["log_betas"]},
            "meta": {"epoch": 3, "fid": 12.5}}


def _jax_loaded(path):
    """The sampler params JAX's ``load_sampler_params`` reads from ``path``,
    as the port's state dict."""
    return var_sampler_from_flax(jax.tree.map(
        np.array, jax_checkpoint.load_sampler_params(str(path))))


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_run_dir_lookup_follows_jax(tmp_path, layout):
    files, (name, which) = LAYOUTS[layout]
    blob = serialization.msgpack_serialize(_narrow_sampler_payload())
    for f in files:
        (tmp_path / f).write_bytes(blob if f.endswith(".msgpack") else b"")
    try:
        want, fmt = jax_checkpoint.resolve_run_checkpoint(str(tmp_path), name,
                                                          which)
    except FileNotFoundError:
        with pytest.raises(FileNotFoundError):
            resolve_run_checkpoint(str(tmp_path), name, which)
        return
    got = resolve_run_checkpoint(str(tmp_path), name, which)
    assert got == want
    if fmt == "msgpack":
        state = load_sampler_state(got, net="unet_small")
        ref = _jax_loaded(got)
        assert sorted(state) == sorted(ref)
        assert all(torch.equal(state[k], ref[k]) for k in ref)


def test_train_cifar10_loads_msgpack_sampler_ckpt(tmp_path):
    """``train_cifar10.build`` with a msgpack ``sampler_ckpt`` holds the
    weights JAX's entry loads from it (``load_sampler_params``), which are
    the fixture's own."""
    path = tmp_path / "sampler.msgpack"
    path.write_bytes(serialization.msgpack_serialize(
        _narrow_sampler_payload()))
    sampler = train_cifar10.build(_cifar_cfg(path), torch.device("cpu"), 0)[0]
    got = sampler.state_dict()
    ref = _jax_loaded(path)
    assert all(torch.equal(got[k], ref[k]) for k in ref)
    pth = load_sampler_state(os.path.join(chip_smoke.FIXTURE_DIR,
                                          "sampler_best.pth"))
    assert all(torch.equal(got[k], pth[k].float()) for k in pth)
