"""The port needs only torch, numpy (scipy for the Frechet distance) and the
stdlib: every module of dxmi_tpu_torch, and chip_smoke.py, import with jax,
flax, yaml, msgpack, PIL, dxmi_tpu, the JAX evaluator and the tests' helpers
made unimportable. chip_smoke.py refuses to run without a
card, and outside the repository."""
import os
import shutil
import subprocess
import sys

import yaml

import chip_smoke

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the JAX package, its evaluator and the test helpers (the synthetic
# Inception weights' oracle) are the reference, never a dependency
BLOCKED = ("jax", "jaxlib", "flax", "yaml", "msgpack", "PIL", "dxmi_tpu",
           "evaluations", "tests", "_inception_oracle", "torch_fixtures")

IMPORT_ALL = r"""
import importlib, pkgutil, sys
BLOCKED = set(%r)

class Blocker:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError("blocked import of " + name)
        return None

sys.meta_path.insert(0, Blocker())
import dxmi_tpu_torch
names = [m.name for m in pkgutil.walk_packages(dxmi_tpu_torch.__path__,
                                               "dxmi_tpu_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
leaked = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
assert not leaked, leaked
print(" ".join(names))
print(len(names))
"""


def _run(args, cwd, timeout=120):
    env = dict(os.environ, PYTHONPATH=cwd)
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=timeout)


def test_port_imports_no_jax_yaml_or_reference():
    proc = _run(["-c", IMPORT_ALL % (BLOCKED,)], REPO)
    assert proc.returncode == 0, proc.stderr
    # 13 modules of the CIFAR-10 slice, 5 of the ImageNet64 slice
    # (ops.attention, ops.phase_up, models.unet_adm, samplers.edm,
    # generate_large), 2 of the int8 slice (ops.quant, utils.npz_stream),
    # 10 of the training slice (models.igebm, models.value, data,
    # data.synthetic, trainers, trainers.buffer, trainers.optim,
    # trainers.dxmi, trainers.dxmi_cond, train_image_large), 2 of the
    # CIFAR-10 training slice (data.cifar10, train_cifar10), 10 of the FID
    # slice (fid, fid.stats, fid.inception, fid.proxy, fid.runner,
    # fid.image_dir, fid.cli, evaluator, make_npz, utils.png), 2 of the
    # resume slice (utils.train_state, utils.logging); 7 of the anomaly and
    # 2D slice (models.mlp, data.tensor_file, data.image_folder,
    # trainers.dxmi_ev, utils.metrics, train_anomaly, train_2d); 60 in all
    assert int(proc.stdout.split()[-1]) >= 60
    names = proc.stdout.split()[:-1]
    for mod in ("models.mlp", "data.tensor_file", "data.image_folder",
                "trainers.dxmi_ev", "utils.metrics", "train_anomaly",
                "train_2d"):
        assert f"dxmi_tpu_torch.{mod}" in names, mod


def test_chip_smoke_fixture_config_matches_yaml():
    """chip_smoke.py reads its configs with the port's YAML reader (the card
    has no PyYAML); each equals what PyYAML reads."""
    with open(os.path.join(REPO, "tests", "fixtures", "torch_rundir_t10",
                           "config.yaml")) as f:
        assert chip_smoke.fixture_config() == yaml.safe_load(f)
    with open(os.path.join(REPO, "configs", "cifar10", "T10.yaml")) as f:
        cfg = yaml.safe_load(f)
    assert chip_smoke.cifar10_t10() == {k: cfg[k]
                                        for k in ("sampler_net", "sampler")}


def test_chip_smoke_adm_fixture_config_matches_yaml():
    with open(os.path.join(REPO, "tests", "fixtures", "torch_rundir_adm_t10",
                           "config.yaml")) as f:
        assert chip_smoke.adm_fixture_config() == yaml.safe_load(f)


def test_chip_smoke_imagenet64_config_matches_yaml():
    """chip_smoke.py's ImageNet64 config is the generation half (the
    diffusion and sampler sections) of configs/imagenet64/T10.yaml."""
    with open(os.path.join(REPO, "configs", "imagenet64", "T10.yaml")) as f:
        cfg = yaml.safe_load(f)
    assert chip_smoke.imagenet64_t10() == {k: cfg[k]
                                           for k in ("diffusion", "sampler")}


def test_chip_smoke_fails_without_a_card():
    proc = _run(["chip_smoke.py"], REPO)
    assert proc.returncode != 0
    assert proc.stdout == ""


def test_chip_smoke_fails_outside_the_repo(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    proc = _run(["chip_smoke.py"], str(tmp_path))
    assert proc.returncode != 0
    assert proc.stdout == ""
