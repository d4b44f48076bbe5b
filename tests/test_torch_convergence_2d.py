"""The port's first whole-training gate: ``python -m dxmi_tpu_torch.train_2d``
on the recipe of ``tests/test_convergence_2d.py`` (8gaussians, a weak
pretrain of 300 steps, 2000 DxMI iterations, lr 3e-5, v_lr 3e-4, beta_lr
1e-5, tau1 0, tau2 0.01, the true-pdf log-likelihood of 2000 samples
every 250). Its curve must rise as JAX's does (CONVERGENCE.md §1: -5.04
to a best near -3.9): the best point more than 0.5 nats above the first,
the last more than 0.3 above it. The port draws its own weights (flax's
lecun_normal, ``models/mlp.py``) and noise, so the curve is another draw
of the same process, not JAX's curve. Marked heavy like its JAX twin; the
driver's ``-m 'not slow'`` runs both in tier-1 (~60-90 s on this CPU)."""
import json
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.heavy
def test_port_2d_likelihood_rises(tmp_path):
    curve_out = str(tmp_path / "curve.json")
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2")
    cmd = [sys.executable, "-m", "dxmi_tpu_torch.train_2d", "--device",
           "cpu", "--data", "8gaussians", "--pretrain_iters", "300",
           "--n_iter", "2000", "--lr", "3e-5", "--v_lr", "3e-4",
           "--beta_lr", "1e-5", "--tau1", "0.0", "--tau2", "0.01",
           "--eval_every", "250", "--eval_n", "2000",
           "--curve_out", curve_out, "--out", str(tmp_path / "2d"),
           "--seed", "0"]
    r = subprocess.run(cmd, cwd=tmp_path, env=env, capture_output=True,
                       text=True, timeout=600)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-2000:]
    with open(curve_out) as fh:
        curve = json.load(fh)["curve"]
    assert [p["iter"] for p in curve] == list(range(0, 2001, 250))
    initial = curve[0]["loglik"]
    best = max(p["loglik"] for p in curve[1:])
    final = curve[-1]["loglik"]
    assert best > initial + 0.5, (initial, best, curve)
    assert final > initial + 0.3, (initial, final, curve)
