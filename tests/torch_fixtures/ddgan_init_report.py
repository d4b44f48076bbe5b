"""The DDGAN pretraining recipe's loss at step 0 under JAX's initialiser and
under the port's, on the same batch and draws, for four seeds each: it
tells whether the port's curve starting above JAX's 0.356 (CONVERGENCE.md
§7) is the initialiser's draw or a fault in ``models/flax_init.py``.

    python tests/torch_fixtures/ddgan_init_report.py   # from the repo root

NCSN++ at ``NCSNppArgs()`` on the CPU, batch 32 of ``fake_cifar(1024, 7)``
at ``RandomState(7)``'s indices (the recipe's data, seed and first batch's
indices), one numpy draw of the time indices, noise and latents; prints
E[x0^2] and, per seed, the loss mean((G(x_t, ti, z) - x0)^2) and E[G^2]
(~1 min).
"""
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
B, SEEDS = 32, 4


def main():
    if REPO not in sys.path:
        sys.path.insert(0, REPO)
    from dxmi_tpu.models.ncsnpp import NCSNpp, NCSNppArgs
    from dxmi_tpu_torch import pretrain_ddgan
    from dxmi_tpu_torch.data.cifar10 import fake_cifar

    imgs = fake_cifar(1024, 7).images.astype(np.float32) / 127.5 - 1.0
    x0 = imgs[np.random.RandomState(7).randint(0, 1024, B)]
    rs = np.random.RandomState(1)
    ti = rs.randint(0, 4, B)
    eps = rs.randn(*x0.shape).astype(np.float32)
    z = rs.randn(B, 100).astype(np.float32)
    ab = pretrain_ddgan.alpha_bar(4)[ti][:, None, None, None]
    xt = np.sqrt(ab) * x0 + np.sqrt(1 - ab) * eps
    print(f"E[x0^2] {float((x0 ** 2).mean()):.4f}")

    net = NCSNpp(config=NCSNppArgs())
    init = jax.jit(lambda k: net.init(k, jnp.asarray(xt[:1]), jnp.zeros((1,)),
                                      jnp.asarray(z[:1]))["params"])
    apply = jax.jit(lambda p: net.apply(
        {"params": p}, jnp.asarray(xt), jnp.asarray(ti, jnp.float32),
        jnp.asarray(z)))

    def report(tag, seed, out):
        print(f"{tag} seed {seed}: loss {float(((out - x0) ** 2).mean()):.4f}"
              f", E[G^2] {float((out ** 2).mean()):.4f}")

    for seed in range(SEEDS):
        report("JAX init_params", seed,
               np.asarray(apply(init(jax.random.key(seed)))))
    for seed in range(SEEDS):
        sampler = pretrain_ddgan.build(4, torch.device("cpu"),
                                       torch.Generator().manual_seed(seed))
        sampler.net.eval()
        with torch.no_grad():
            out = sampler.net(torch.from_numpy(xt.transpose(0, 3, 1, 2)
                                               .copy()),
                              torch.from_numpy(ti).float(),
                              torch.from_numpy(z))
        report("port flax_init_", seed, out.numpy().transpose(0, 2, 3, 1))


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    main()
