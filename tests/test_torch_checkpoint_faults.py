"""The training entries refuse a sampler checkpoint that does not match
their net: ``train_cifar10.build`` on the trained CIFAR fixture's
``sampler_best.pth`` and ``train_image_large.build_sampler`` on the ADM
fixture's ``sampler.pth``, each with one key renamed, raise ``KeyError``
(the JAX entries fail at their first forward on such a checkpoint). A
checkpoint missing only ``log_betas`` still loads.

The generation entries' run-dir lookup (``resolve_run_checkpoint``) walks
the JAX package's order on each run-dir layout: it resolves the file JAX
resolves, or raises where JAX would load a msgpack file the port cannot
read yet, naming that file."""
import os

import pytest
import torch

import chip_smoke
from dxmi_tpu.utils import checkpoint as jax_checkpoint
from dxmi_tpu_torch import train_cifar10, train_image_large
from dxmi_tpu_torch.utils.checkpoint import (load_sampler_state,
                                             resolve_run_checkpoint)


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


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_run_dir_lookup_follows_jax(tmp_path, layout):
    files, (name, which) = LAYOUTS[layout]
    for f in files:
        (tmp_path / f).write_bytes(b"")
    try:
        want, fmt = jax_checkpoint.resolve_run_checkpoint(str(tmp_path), name,
                                                          which)
    except FileNotFoundError:
        with pytest.raises(FileNotFoundError):
            resolve_run_checkpoint(str(tmp_path), name, which)
        return
    if fmt == "msgpack":
        with pytest.raises(NotImplementedError,
                           match=os.path.basename(want)):
            resolve_run_checkpoint(str(tmp_path), name, which)
    else:
        assert resolve_run_checkpoint(str(tmp_path), name, which) == want
