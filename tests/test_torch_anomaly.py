"""The anomaly entry of the port against the JAX package on the CPU: the
tensor-file loader (layouts, ranges, order of batches), AUROC and average
precision with ties, the score's bilinear resize against
``jax.image.resize`` (1e-5), ``train_anomaly`` training and ``--score``
end to end on tiny data (tensor file, PNG folder, --fake_data, with and
without spectral norm), the JAX entry's value and energy files loaded
into the port, and the port scoring a JAX run directory's
``energy_last.msgpack`` to JAX's AUROC."""
import importlib.util
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from dxmi_tpu.data import tensor_file as jax_tf
from dxmi_tpu.utils import metrics as jax_metrics
from dxmi_tpu_torch import train_anomaly
from dxmi_tpu_torch.data import tensor_file as port_tf
from dxmi_tpu_torch.utils import metrics as port_metrics

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _save_tensor_file(path, layout, kind):
    rs = np.random.RandomState(0)
    x = rs.rand(10, 3, 8, 8)
    if kind == "u8":
        x = torch.from_numpy((x * 255).astype(np.uint8))
    elif kind == "unit":
        x = torch.from_numpy(x.astype(np.float32))
    else:
        x = torch.from_numpy((x * 2 - 1).astype(np.float32)).permute(
            0, 2, 3, 1)
    y = torch.from_numpy(rs.randint(0, 3, 10))
    obj = {"tensor": x, "tuple": (x, y), "list": [x, y],
           "dict": {"images": x, "y": y}, "other": {"foo": x}}[layout]
    torch.save(obj, path)


@pytest.mark.parametrize("layout,kind", [
    ("tensor", "u8"), ("tuple", "unit"), ("list", "pm1"), ("dict", "u8"),
    ("other", "unit")])
def test_tensor_batches_equal(tmp_path, layout, kind):
    path = str(tmp_path / "train_data.pth")
    _save_tensor_file(path, layout, kind)
    ours = port_tf.tensor_batches(path, 4, seed=3, image_size=8)
    ref = jax_tf.tensor_batches(path, 4, seed=3, image_size=8)
    for _ in range(6):  # three epochs of two whole batches
        (x, e), (xr, er) = next(ours), next(ref)
        np.testing.assert_array_equal(x, xr)
        assert sorted(e) == sorted(er)
        if "y" in er:
            np.testing.assert_array_equal(e["y"], er["y"])
    with pytest.raises(ValueError, match="--image_size 8"):
        next(port_tf.tensor_batches(path, 4, image_size=16))


@pytest.mark.parametrize("case", ["distinct", "ties", "all_tied"])
def test_roc_auc_and_average_precision_equal(case):
    rs = np.random.RandomState(1)
    scores = {"distinct": rs.randn(50), "ties": rs.randint(0, 4, 50) * 0.5,
              "all_tied": np.ones(50)}[case]
    labels = rs.randint(0, 2, 50)
    assert port_metrics.roc_auc(scores, labels) == jax_metrics.roc_auc(
        scores, labels)
    assert port_metrics.average_precision(scores, labels) == \
        jax_metrics.average_precision(scores, labels)
    a, b = scores[:20], scores[20:]
    assert port_metrics.anomaly_scores_from_energy(a, b) == \
        jax_metrics.anomaly_scores_from_energy(a, b)
    with pytest.raises(ValueError):
        port_metrics.roc_auc(scores, np.zeros(50))


@pytest.mark.parametrize("shape", [(128, 128), (100, 80), (32, 32),
                                   (64, 200), (17, 64)])
def test_resize_bilinear_matches_jax(shape):
    """Down and up, on one axis or both: ``jax.image.resize(...,
    'bilinear')`` (antialias on) within 1e-5."""
    x = np.random.RandomState(2).rand(2, *shape, 3).astype(np.float32)
    ref = np.asarray(jax.image.resize(jnp.asarray(x), (2, 64, 64, 3),
                                      "bilinear"))
    out = train_anomaly.resize_bilinear(torch.from_numpy(x), 64).numpy()
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-5)


def _pngs(d, n, size, seed, noise=False):
    os.makedirs(d, exist_ok=True)
    rs = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:size, 0:size]
    for i in range(n):
        a = (rs.rand(size, size, 3) * 255 if noise else
             np.stack([128 + 100 * np.sin(xx / 3.0 + c + i / 4)
                       for c in range(3)], -1))
        Image.fromarray(a.clip(0, 255).astype(np.uint8)).save(
            os.path.join(d, f"{i:02d}.png"))
    return d


SMALL = ["--image_size", "16", "--n_iter", "2", "--batchsize", "4",
         "--n_timesteps", "2", "--log_every", "1", "--device", "cpu"]


@pytest.mark.parametrize("data,sn", [("folder", True), ("tensor", False),
                                     ("fake", False)])
def test_train_and_score_end_to_end(tmp_path, monkeypatch, capsys, data, sn):
    """The entry trains 2 iterations from each data path (a PNG folder of
    16x16 and 64x64 images, whose loader halves the large ones), writes
    its run directory, and --score reads it (the spectral-norm buffers
    included) and prints JAX's line."""
    monkeypatch.chdir(tmp_path)
    if data == "folder":
        _pngs(str(tmp_path / "train"), 4, 16, 0)
        _pngs(str(tmp_path / "train"), 4, 64, 1)
        src = ["--data_dir", str(tmp_path / "train")]
    elif data == "tensor":
        torch.save(torch.rand(8, 3, 16, 16), tmp_path / "t.pth")
        src = ["--data_dir", str(tmp_path / "t.pth")]
    else:
        src = ["--fake_data"]
    run = f"{data}_{int(sn)}"
    train_anomaly.main([*SMALL, *src, "--run", run,
                        *(["--spectral_norm"] if sn else [])])
    out = capsys.readouterr().out
    assert "iter 0 d_loss=" in out and "iter 1 d_loss=" in out
    run_dir = tmp_path / "results" / "anomaly" / run
    assert sorted(os.listdir(run_dir)) == [
        "config.yaml", "energy_last.pth", "sampler_last.pth",
        "value_last.pth"]
    sd = torch.load(run_dir / "energy_last.pth")["state_dict"]
    assert sum(k.endswith((".u", ".sigma")) for k in sd) == (32 if sn else 0)
    d = train_anomaly.main([
        "--score", "--log_dir", str(run_dir), "--device", "cpu",
        "--in_dir", _pngs(str(tmp_path / "in"), 5, 16, 2),
        "--out_dir", _pngs(str(tmp_path / "out"), 5, 32, 3, noise=True)])
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line == f"AUROC: {d['auroc']:.4f}  AUPR: {d['aupr']:.4f}"


def _jax_entry(monkeypatch):
    monkeypatch.setenv("DXMI_PLATFORM", "cpu")
    spec = importlib.util.spec_from_file_location(
        "jax_train_anomaly", os.path.join(REPO, "train_anomaly.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_port_scores_a_jax_run_dir(tmp_path, monkeypatch, capsys):
    """A JAX run directory (config.yaml, energy_last.msgpack with its
    sn_stats beside the params, written by the JAX package's own
    checkpoint code) scored by both entries: the same AUROC and AUPR
    line."""
    from dxmi_tpu import config as cfglib
    from dxmi_tpu.utils import checkpoint as ckptlib

    jax_entry = _jax_entry(monkeypatch)
    _, _, _, energy = jax_entry.build(16, 2, spectral_norm=True)
    x = jnp.asarray(np.random.RandomState(4).randn(2, 16, 16, 3),
                    jnp.float32)
    v = energy.init(jax.random.key(1), x)
    _, mut = energy.apply(v, x, update_sn_stats=True, mutable=["sn_stats"])
    run_dir = str(tmp_path / "jax_run")
    ckptlib.save_run_checkpoint(run_dir, "last", f_params=v["params"],
                                f_stats=mut["sn_stats"])
    cfglib.save_yaml({"image_size": 16, "n_timesteps": 2,
                      "spectral_norm": True},
                     os.path.join(run_dir, "config.yaml"))
    dirs = ["--in_dir", _pngs(str(tmp_path / "in"), 6, 16, 5),
            "--out_dir", _pngs(str(tmp_path / "out"), 6, 24, 6, noise=True)]
    args = jax_entry.argparse.Namespace(log_dir=run_dir, in_dir=dirs[1],
                                        out_dir=dirs[3])
    jax_entry.score(args)
    ref = capsys.readouterr().out.strip().splitlines()[-1]
    train_anomaly.main(["--score", "--log_dir", run_dir, "--device", "cpu",
                        *dirs])
    assert capsys.readouterr().out.strip().splitlines()[-1] == ref
    assert ref.startswith("AUROC: ")


def test_jax_run_files_load_into_the_port(tmp_path, monkeypatch):
    """``load_module_state`` reads the JAX entry's ``value_last.msgpack``
    (the UNetSmallEncoder value) and ``energy_last.msgpack`` (the
    spectral-norm IGEBM, ``sn_stats`` beside ``params``): both nets then
    give JAX's outputs (1e-5), the energy's stats in its buffers."""
    from dxmi_tpu.utils import checkpoint as ckptlib
    from dxmi_tpu_torch.utils.checkpoint import load_module_state
    from dxmi_tpu_torch.utils.train_state import sn_buffers

    jax_entry = _jax_entry(monkeypatch)
    _, _, value, energy = jax_entry.build(16, 2, spectral_norm=True)
    x = np.random.RandomState(7).randn(2, 16, 16, 3).astype(np.float32)
    t = np.array([0.0, 1.0], np.float32)
    vv = value.init(jax.random.key(2), jnp.asarray(x), jnp.asarray(t))
    fv = energy.init(jax.random.key(3), jnp.asarray(x))
    run_dir = str(tmp_path / "run")
    ckptlib.save_run_checkpoint(run_dir, "last", v_params=vv["params"],
                                f_params=fv["params"],
                                f_stats=fv["sn_stats"])
    # the unfused switches: JAX's fp32 composition (K3 rounds to bf16)
    _, _, pv, pf = train_anomaly.build(16, 2, spectral_norm=True,
                                       fuse_gn_conv=False)
    pv.load_state_dict(load_module_state(
        os.path.join(run_dir, "value_last.msgpack"), pv))
    pf.load_state_dict(load_module_state(
        os.path.join(run_dir, "energy_last.msgpack"), pf))
    assert len(sn_buffers(pf)) == 32
    xt = torch.from_numpy(x.transpose(0, 3, 1, 2))
    with torch.no_grad():
        for ours, ref in ((pv(xt, torch.from_numpy(t)),
                           value.apply(vv, jnp.asarray(x), jnp.asarray(t))),
                          (pf(xt), energy.apply(fv, jnp.asarray(x)))):
            np.testing.assert_allclose(ours.numpy(), np.asarray(ref),
                                       rtol=1e-5, atol=1e-5)


def test_cli_runs_as_a_module(tmp_path):
    """``python -m dxmi_tpu_torch.train_anomaly`` takes every flag of the
    JAX entry (and --device)."""
    r = subprocess.run([sys.executable, "-m", "dxmi_tpu_torch.train_anomaly",
                        "--help"], cwd=tmp_path, capture_output=True,
                       text=True, timeout=120,
                       env=dict(os.environ, PYTHONPATH=REPO))
    assert r.returncode == 0
    for flag in ("--data_dir", "--image_size", "--n_timesteps", "--n_iter",
                 "--batchsize", "--lr", "--v_lr", "--f_lr", "--tau1",
                 "--tau2", "--seed", "--run", "--fake_data",
                 "--spectral_norm", "--log_every", "--score", "--log_dir",
                 "--in_dir", "--out_dir", "--device"):
        assert flag in r.stdout, flag
