"""Build ``cifar_levers_golden.npz``: one ``DxMITrainer`` iteration of the JAX
package on the trained CIFAR fixture under ``train_cifar10 --fast_levers``
(``train_cifar10.py:164-174``): the sampler net in bf16 with the bf16
softmax without its max pass and the phase upsample, ``DXMI_GN_STATS=
bf16_onepass``, the value net's torso in bf16. The reference that
``tests/test_torch_cifar_levers.py`` holds the port's ``--fast_levers``
iteration to.

    python tests/torch_fixtures/make_cifar_levers_golden.py   # from the repo root

The case, the stored arrays and the replayed draws are
``make_cifar_train_golden``'s (its ``build`` with the levers' overrides).
"""
from __future__ import annotations

import contextlib
import os

import jax
import jax.numpy as jnp
import numpy as np

try:
    from torch_fixtures import make_cifar_train_golden
except ImportError:  # run as a script
    import make_cifar_train_golden

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "cifar_levers_golden.npz")
# the JAX entry's overrides (its DXMI_GN_STATS is an environment variable)
NET_OVERRIDES = dict(dtype=jnp.bfloat16, softmax_f32=False,
                     softmax_nomax=True, up_impl="phase")
VALUE_NET_OVERRIDES = dict(dtype=jnp.bfloat16)
GN_STATS = "bf16_onepass"


@contextlib.contextmanager
def gn_stats_env(mode):
    old = os.environ.get("DXMI_GN_STATS")
    os.environ["DXMI_GN_STATS"] = mode
    try:
        yield
    finally:
        if old is None:
            del os.environ["DXMI_GN_STATS"]
        else:
            os.environ["DXMI_GN_STATS"] = old


def build():
    """``make_cifar_train_golden.build`` under the levers."""
    with gn_stats_env(GN_STATS):
        return make_cifar_train_golden.build(NET_OVERRIDES,
                                             VALUE_NET_OVERRIDES)


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    arrays, _ = build()
    np.savez(GOLDEN, **arrays)
    print(f"wrote {GOLDEN}: {len(arrays)} arrays, "
          f"{os.path.getsize(GOLDEN)} bytes")
