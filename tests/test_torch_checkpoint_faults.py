"""The training entries refuse a sampler checkpoint that does not match
their net: ``train_cifar10.build`` on the trained CIFAR fixture's
``sampler_best.pth`` and ``train_image_large.build_sampler`` on the ADM
fixture's ``sampler.pth``, each with one key renamed, raise ``KeyError``
(the JAX entries fail at their first forward on such a checkpoint). A
checkpoint missing only ``log_betas`` still loads."""
import os

import pytest
import torch

import chip_smoke
from dxmi_tpu_torch import train_cifar10, train_image_large
from dxmi_tpu_torch.utils.checkpoint import load_sampler_state


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
