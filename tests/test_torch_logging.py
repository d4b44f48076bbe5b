"""The port's ``utils/logging.py`` against ``dxmi_tpu.utils.logging``: the
same scalar families from the same metrics (torch tensors on the port's
side), the same sample grid, the same weight norm, the same writer calls
and JAX's line when wandb is not installed."""
import numpy as np
import torch

from dxmi_tpu.utils import logging as jax_logging
from dxmi_tpu_torch.utils import logging as port_logging

_RS = np.random.RandomState(3)
METRICS = {"ebm/d_loss_": np.float32(0.25), "ebm/v_loss_": np.float32(1.5),
           "per_step/t": np.array([2, 0, 3, 1]),
           "per_step/running_cost": _RS.rand(4).astype(np.float32),
           "per_step/value": _RS.rand(4).astype(np.float32),
           "per_step/sigma": _RS.rand(4).astype(np.float32),
           "per_step/betas_for_q": _RS.rand(4).astype(np.float32),
           "per_step/v_loss": _RS.rand(4).astype(np.float32)}


def test_expand_metrics_equals_jax():
    ours = port_logging.expand_metrics(
        {k: torch.from_numpy(np.asarray(v)) for k, v in METRICS.items()})
    assert ours == jax_logging.expand_metrics(METRICS)
    no_t = {k: v for k, v in METRICS.items() if k != "per_step/t"}
    assert port_logging.expand_metrics(no_t) == \
        jax_logging.expand_metrics(no_t)


def test_grid_and_weight_norm_equal_jax():
    imgs = _RS.rand(11, 4, 5, 3).astype(np.float32)
    assert np.array_equal(port_logging.make_grid(imgs),
                          jax_logging.make_grid(imgs))
    params = [_RS.randn(3, 4).astype(np.float32),
              _RS.randn(7).astype(np.float32)]
    want = jax_logging.weight_norm_of({"a": params[0], "b": params[1]})
    got = port_logging.weight_norm_of([torch.from_numpy(p) for p in params])
    assert abs(got - want) < 1e-6 * want


class _Writer:
    def __init__(self):
        self.calls = []

    def add_scalar(self, *a):
        self.calls.append(("scalar", a))

    def add_image(self, key, img, i, dataformats):
        self.calls.append(("image", (key, img.shape, i, dataformats)))


def test_logger_writes_as_jax():
    d = {"a_": 1.5, "grid@": np.zeros((6, 7, 3)), "ignored": 3.0}
    ours, ref = _Writer(), _Writer()
    port_logging.BaseLogger(ours).log(
        {**d, "a_": torch.tensor(1.5)}, 4)
    jax_logging.BaseLogger(ref).log(d, 4)
    assert ours.calls == ref.calls


def test_wandb_missing_says_so(capsys, monkeypatch):
    import builtins

    real = builtins.__import__

    def no_wandb(name, *a, **k):
        if name == "wandb":
            raise ImportError(name)
        return real(name, *a, **k)

    monkeypatch.setattr(builtins, "__import__", no_wandb)
    assert port_logging.init_wandb("p", "n", "/tmp") is None
    assert capsys.readouterr().out.strip() == \
        "wandb not installed — --wandb ignored"
    assert port_logging.BaseLogger(None, use_wandb=True).wandb is None
