"""Resume, n_critic and guidance through the port's entry points on the CPU
at a small width (chip_smoke's shrunken configs):

- ``train_cifar10`` for 2 steps, then ``--resume`` to 4: the second run
  starts at the saved iteration and epoch (JAX's "resumed full train
  state" line), keeps the file's best FID, and its final state file
  records 4 iterations; the state's parameter leaves equal the run's
  ``sampler_last.pth`` and ``value_last.pth`` bit for bit and its counts
  equal the steps taken;
- ``training.n_critic`` = 2: one sampler update every two iterations;
- ``train_image_large`` with ``--save_state_every 1`` for 2 steps, then
  ``--resume`` to 3, with JAX's meta (a periodic save records the
  iteration just run; the final one ``n_iter``);
- ``generate_cifar10 --guidance_scale`` on the resumed run directory.
"""
import os
import subprocess

import numpy as np
import torch

import chip_smoke
from dxmi_tpu_torch.utils import msgpack as port_msgpack

REPO = chip_smoke.REPO
ENV = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2")


def _run(cmd, cwd):
    proc = subprocess.run(cmd, cwd=cwd, capture_output=True, text=True,
                          timeout=600, env=ENV)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return proc.stdout.splitlines()


def _steps(cmd, n):
    i = cmd.index("--max_steps")
    return [*cmd[:i + 1], str(n), *cmd[i + 2:]]


def _iters(lines):
    return [int(l.split()[1]) for l in lines if l.startswith("iter ")]


def _state(run):
    return port_msgpack.read(os.path.join(run, "train_state.msgpack"))


def _params_match_last(run, state, sampler_net, value):
    """The state's sampler and value parameter leaves are the run's
    ``*_last.pth`` tensors (flax layout), bit for bit."""
    from dxmi_tpu_torch.utils.train_state import flax_path

    leaves = state["leaves"]
    sd = torch.load(os.path.join(run, "sampler_last.pth"),
                    weights_only=True)["state_dict"]
    vd = torch.load(os.path.join(run, "value_last.pth"),
                    weights_only=True)["state_dict"]
    want = [sd["log_betas"]]
    keys = sorted((flax_path(sampler_net, k, sd[k].dim()), k) for k in sd
                  if k != "log_betas")
    for (_, axes), k in keys:
        want.append(sd[k].permute(axes) if axes else sd[k])
    vkeys = sorted((flax_path(value, k, vd[k].dim()), k) for k in vd)
    for (_, axes), k in vkeys:
        want.append(vd[k].permute(axes) if axes else vd[k])
    for i, w in enumerate(want):
        assert np.asarray(leaves[str(i)]).tobytes() == \
            w.contiguous().numpy().tobytes(), i
    return len(want)


def test_train_cifar10_resume_then_guide(tmp_path):
    train, gen, log_dir = chip_smoke.cifar_train_cli_commands("res", "cpu")
    train = [*train, "--fake_data_size", "32"]  # 4 steps an epoch
    lines = _run(train, tmp_path)
    assert _iters(lines) == [0, 1] and lines[-1] == "done: 2 iters"
    run = str(tmp_path / log_dir)
    st = _state(run)
    assert st["meta"] == {"i_iter": 2, "epoch": 0, "best_fid": float("inf")}
    # a best FID in the file survives the resume (no FID files here)
    st["meta"]["best_fid"] = 0.125
    port_msgpack.write(os.path.join(run, "train_state.msgpack"), st)

    lines = _run(_steps(train, 4) + ["--resume"], tmp_path)
    assert "resumed full train state at epoch 0, iter 2" in lines
    assert _iters(lines) == [2, 3] and lines[-1] == "done: 4 iters"
    st = _state(run)
    assert st["meta"] == {"i_iter": 4, "epoch": 0, "best_fid": 0.125}

    from dxmi_tpu_torch.config import instantiate, load_yaml
    cfg = load_yaml(os.path.join(run, "config.yaml"))
    net = instantiate(cfg["sampler_net"])
    n = _params_match_last(run, st, net, instantiate(cfg["value"]))
    # the sampler's two Adam counts follow, then the value's: 4 steps of
    # the sampler, 4 x (1 + T) of the value
    counts = [int(st["leaves"][str(i)]) for i in range(len(st["leaves"]))
              if np.asarray(st["leaves"][str(i)]).dtype == np.int32]
    assert counts == [4, 4, 4 * (1 + 10)]
    assert n < len(st["leaves"])

    lines = _run([*gen, "--guidance_scale", "0.1"], tmp_path)
    assert "value-guided sampling, scale=0.1" in lines
    x = np.load(tmp_path / log_dir / "samples.npz")["arr_0"]
    assert x.shape == (8, 32, 32, 3)


def test_train_cifar10_n_critic(tmp_path):
    """n_critic = 2: the entry logs at each sampler update (iterations 1
    and 3) and the sampler's optimizer takes one step per two
    iterations."""
    train, _, log_dir = chip_smoke.cifar_train_cli_commands("nc", "cpu")
    lines = _run(_steps(train, 4) + ["--training.n_critic", "2"], tmp_path)
    assert _iters(lines) == [1, 3] and lines[-1] == "done: 4 iters"
    st = _state(str(tmp_path / log_dir))
    counts = [int(st["leaves"][str(i)]) for i in range(len(st["leaves"]))
              if np.asarray(st["leaves"][str(i)]).dtype == np.int32]
    assert counts == [2, 2, 4 * (1 + 10)]


def test_train_image_large_resume(tmp_path):
    train, gen, log_dir = chip_smoke.train_cli_commands("res", device="cpu")
    lines = _run([*train, "--save_state_every", "1"], tmp_path)
    assert _iters(lines) == [0, 1] and lines[-1] == "done"
    run = str(tmp_path / log_dir)
    assert _state(run)["meta"] == {"i_iter": 2, "epoch": 0,
                                   "best_fid": float("inf")}
    lines = _run(_steps(train, 3) + ["--resume", "--save_state_every", "1"],
                 tmp_path)
    assert "resumed full train state at iter 2" in lines
    assert _iters(lines) == [2] and lines[-1] == "done"
    st = _state(run)
    assert st["meta"]["i_iter"] == 3
    counts = [int(st["leaves"][str(i)]) for i in range(len(st["leaves"]))
              if np.asarray(st["leaves"][str(i)]).dtype == np.int32]
    # the guard's two counters, the RAdam counts (a full sweep of 10
    # minibatches an iteration), the value's Adam
    assert counts == [0, 0, 30, 30, 3 * 11]

    lines = _run([*gen, "--guidance_scale", "0.1"], tmp_path)
    assert "value-guided sampling, scale=0.1" in lines
    got = np.load(tmp_path / log_dir / "samples.npz")
    assert got["arr_0"].shape == (8, 16, 16, 3) and got["arr_1"].max() < 4


def test_periodic_save_records_the_iteration_just_run(tmp_path,
                                                       monkeypatch):
    """JAX's state saves (``train_image_large.py:286-288``, ``:304-305``):
    after iteration i (i > 0, i % save_state_every == 0) the file records
    i_iter = i, so a run resumed from it runs iteration i again; the final
    save records n_iter."""
    import sys

    from dxmi_tpu_torch import train_image_large

    saved = []
    monkeypatch.setattr(train_image_large, "save_train_state",
                        lambda log_dir, trainer, **meta: saved.append(meta))
    train, _, _ = chip_smoke.train_cli_commands("ps", device="cpu")
    argv = _steps(train, 5)[2:] + ["--save_state_every", "2"]
    monkeypatch.setattr(sys, "argv", argv)
    monkeypatch.chdir(tmp_path)
    train_image_large.main()
    assert [m["i_iter"] for m in saved] == [2, 4, 5]
    assert all(m["epoch"] == 0 for m in saved)


def test_closing_gate_seconds_a_step():
    """The gate's s/step reads the entry's cumulative it/s between the
    second and the last logged iteration, leaving out the first (FID and
    start-up), also in a resumed piece."""
    from dxmi_tpu_torch.closing_gate import seconds_a_step

    # a resumed piece from 250: FID and start take 40 s, then 1.5 s a step
    t = {250: 41.5, 270: 71.5, 490: 401.5}
    lines = [f"iter {i} d_loss=0.1 sampler_loss=0.2 ({(i + 1 - 250) / s:.6f}"
             " it/s)" for i, s in t.items()]
    assert abs(seconds_a_step(["resumed full train state at iter 250"]
                              + lines) - 1.5) < 1e-4
    assert seconds_a_step(lines[:2]) != seconds_a_step(lines[:2])  # nan
