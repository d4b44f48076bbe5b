"""Print the CPU measurements behind the int8 tests' limits: how far the
port's int8 path sits from the JAX package's on the CPU, and how strongly an
int8 trajectory amplifies fp32 noise.

    python tests/torch_fixtures/int8_cpu_report.py   # from the repo root

1. the ADM fixture (adm_int8_golden.npz): calibrated scales against JAX's,
   and per step the mean error over the int8 effect and the max abs error
   (chip_smoke.replay_int8, as tests/test_torch_adm_int8_golden.py
   gates it);
2. the same replay with the port's own input perturbed by 1e-7 (relative):
   the step means' max and mean change, and for six perturbations the
   median error over the int8 effect averaged over the steps (the gate
   chip_smoke.INT8_MEDIAN_RATIO reads);
3. JAX's calibrate_quant seeds its running maxima with the scales that
   net.init records on a zero input: for the CLI's key 123 and for key 0,
   the channels where those exceed the calibrated scales;
4. the 16x16 int8 net of tests/test_torch_unet_adm.py against JAX: fp32
   max abs output difference per route, and in bf16 (seeds 6 and 7) the
   distance between JAX's own bf16 and fp32 int8 outputs;
5. the planted wiring faults of tests/test_torch_adm_int8_golden.py: both
   G2-int8 readings of each;
6. the CIFAR fixture (cifar_int8_golden.npz): G-int8's readings of the
   port (chip_smoke.replay_int8, as tests/test_torch_cifar_int8_golden.py
   gates it) and of that test's planted wiring faults;
7. JAX's VARSampler.calibrate_quant starts from the scales of net.init on
   a zero input with the CLI's key (seed 0 + 123): the channels where
   those exceed the calibrated scales, on the CIFAR fixture (against the
   golden's) and on tests/test_torch_unet_small_int8.py's calibration
   cases.
"""
from __future__ import annotations

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(os.path.dirname(HERE))
for p in (REPO, os.path.dirname(HERE)):
    if p not in sys.path:
        sys.path.insert(0, p)


def fixture_report():
    import chip_smoke
    from dxmi_tpu_torch import generate_large
    from dxmi_tpu_torch.utils.checkpoint import load_sampler_state

    golden = dict(np.load(chip_smoke.INT8_GOLDEN))
    gold = np.load(os.path.join(chip_smoke.ADM_FIXTURE_DIR, "golden.npz"))
    cfg = chip_smoke.adm_fixture_config()
    state = load_sampler_state(os.path.join(chip_smoke.ADM_FIXTURE_DIR,
                                            "sampler.pth"))
    sampler = generate_large.load_sampler(cfg, state, "cpu", int8=True)
    fp = generate_large.load_sampler(cfg, state, "cpu")
    x0, eps, ys = chip_smoke.adm_int8_calib_draws(int(golden["calib_seed"]))
    sampler.calibrate_quant(n_sample=8, n_rounds=2, x0=torch.from_numpy(x0),
                            eps=torch.from_numpy(eps), y=torch.from_numpy(ys))
    ours = {k: v.clone() for k, v in sampler.net.state_dict().items()}
    want = chip_smoke.load_int8_golden_scales(sampler.net, golden)
    worst = max(float((ours[k] - v).abs().max() / v.abs().max())
                for k, v in want.items())
    print(f"1. {len(want)} calibrated scales within {worst:.2e} of JAX's")
    steps, final = chip_smoke.replay_int8(sampler, fp, golden, gold, "cpu")
    print("   per-step mean err / int8 effect "
          + " ".join(f"{r:.3f}" for r, _, _ in steps)
          + "; median err / int8 effect "
          + " ".join(f"{m:.3f}" for _, m, _ in steps)
          + f" (average {np.mean([m for _, m, _ in steps]):.4f})"
          + "; max abs err "
          + " ".join(f"{e:.2e}" for _, _, e in steps) + f"; final {final:.2e}")
    gen = torch.Generator().manual_seed(0)
    y = torch.from_numpy(gold["y"]).long()
    x = torch.from_numpy(gold["x_init"])
    worst_max = worst_mean = 0.0
    with torch.no_grad():
        for t in range(sampler.n_timesteps):
            e = torch.from_numpy(gold["eps"][t])
            a = sampler.sample_step(x, t, e, y)["mean"]
            b = sampler.sample_step(
                x * (1 + 1e-7 * torch.randn(x.shape, generator=gen)), t, e,
                y)["mean"]
            worst_max = max(worst_max, float((a - b).abs().max()))
            worst_mean = max(worst_mean, float((a - b).abs().mean()))
            x = torch.from_numpy(golden["means"][t] + gold["sigmas"][t]
                                 * gold["eps"][t])
    print(f"2. a 1e-7 relative perturbation of the input moves the int8 "
          f"step means by up to {worst_max:.3f} (max), {worst_mean:.1e} "
          "(mean over elements), worst step")
    medians = []
    for seed in range(1, 7):
        gen = torch.Generator().manual_seed(seed)
        x = torch.from_numpy(gold["x_init"])
        per_step = []
        with torch.no_grad():
            for t in range(sampler.n_timesteps):
                e = torch.from_numpy(gold["eps"][t])
                a = sampler.sample_step(
                    x * (1 + 1e-7 * torch.randn(x.shape, generator=gen)), t,
                    e, y)["mean"].numpy()
                f = fp.sample_step(x, t, e, y)["mean"].numpy()
                ref = golden["means"][t]
                per_step.append(np.median(np.abs(a - ref))
                                / np.median(np.abs(f - ref)))
                x = torch.from_numpy(ref + gold["sigmas"][t]
                                     * gold["eps"][t])
        medians.append(float(np.mean(per_step)))
    print("   median err / int8 effect averaged over the steps, perturbed "
          "seeds 1-6: " + " ".join(f"{m:.4f}" for m in medians))
    return fp, golden, gold


def wiring_fault_report(fp, golden, gold):
    import chip_smoke
    import test_torch_adm_int8_golden as G
    from dxmi_tpu_torch import generate_large
    from dxmi_tpu_torch.utils.checkpoint import load_sampler_state

    cfg = chip_smoke.adm_fixture_config()
    state = load_sampler_state(os.path.join(chip_smoke.ADM_FIXTURE_DIR,
                                            "sampler.pth"))
    for name, plant in G.WIRING_FAULTS.items():
        sampler = generate_large.load_sampler(cfg, state, "cpu", int8=True)
        chip_smoke.load_int8_golden_scales(sampler.net, golden)
        with torch.no_grad():
            plant(sampler.net)
        steps, _ = chip_smoke.replay_int8(sampler, fp, golden, gold, "cpu")
        print(f"5. {name}: worst mean ratio "
              f"{max(r for r, _, _ in steps):.3f}, median ratio averaged "
              f"{np.mean([m for _, m, _ in steps]):.4f}")


def init_seed_report():
    from torch_fixtures import make_adm_int8_golden as M
    from dxmi_tpu import config as cfglib
    from dxmi_tpu.models.unet_adm import create_unet_adm
    from dxmi_tpu_torch.utils.convert import adm_quant_scales_from_flax

    golden = np.load(M.GOLDEN)
    with M._env(M.ENV):
        cfg = cfglib.load_yaml(os.path.join(M.FIXTURE, "config.yaml"))
        d = {k: v for k, v in cfg["diffusion"].items() if k not in (
            "sigma_min", "sigma_max", "weight_schedule", "distillation")}
        net = create_unet_adm(**d, quant_int8="static", attn_impl="fused",
                              up_impl="phase")
        for key in (123, 0):
            v = jax.jit(net.init)(
                jax.random.fold_in(jax.random.key(key), 999),
                jnp.zeros((1, 16, 16, 3)), jnp.zeros((1,)),
                jnp.zeros((1,), jnp.int32))
            init = adm_quant_scales_from_flax(
                jax.tree.map(np.asarray, v["quant_scales"]))
            over = [(t.numpy() / golden["scale/" + k]).max()
                    for k, t in init.items()]
            n = sum(int((t.numpy() > golden["scale/" + k]).sum())
                    for k, t in init.items())
            total = sum(t.numel() for t in init.values())
            print(f"3. key {key}: init scales exceed the calibrated ones in "
                  f"{n} of {total} channels (largest ratio {max(over):.2f})")


def net_report():
    import test_torch_unet_adm as T

    os.environ["DXMI_FUSED_ATTN_FORCE"] = "1"
    for kw in T.INT8_ROUTES:
        params = T._seeded_flax_params(T.NETS[16], seed=5)
        x, t, y = T._inputs(16, seed=1)
        scales, ref = T._jax_int8(T.NETS[16], params, x, t, y, jnp.float32,
                                  **kw)
        _, out = T._port_int8(T.NETS[16], T.unet_adm_from_flax(params), x, t,
                              y, torch.float32, scales, **kw)
        print(f"4. fp32 int8 net {kw}: max abs diff to JAX "
              f"{np.abs(out - ref).max():.2e}")
    os.environ["DXMI_GN_STATS"] = "bf16_onepass"
    kw = T.INT8_ROUTES[1]
    for seed in (6, 7):
        params = T._seeded_flax_params(T.NETS[16], seed=seed)
        x, t, y = T._inputs(16, seed=2)
        _, ref = T._jax_int8(T.NETS[16], params, x, t, y, jnp.bfloat16, **kw)
        _, ref32 = T._jax_int8(T.NETS[16], params, x, t, y, jnp.float32,
                               **kw)
        print(f"   bf16 seed {seed}: JAX's bf16 vs fp32 int8 nets "
              f"{T._rel(ref, ref32):.4f} (mean rel)")


def cifar_report():
    import chip_smoke
    import test_torch_cifar_int8_golden as G
    import test_torch_unet_small_int8 as U
    from dxmi_tpu import config as cfglib
    from dxmi_tpu.config import instantiate
    from dxmi_tpu_torch.utils.convert import unet_small_quant_scales_from_flax

    golden = dict(np.load(chip_smoke.CIFAR_INT8_GOLDEN))
    gold = dict(np.load(os.path.join(G.FIXTURE, "golden.npz")))
    fp = G._sampler(int8=False)
    for name in ["port", *G.WIRING_FAULTS, "all_full_precision"]:
        if name == "all_full_precision":
            sampler = fp
        else:
            sampler = G._sampler()
            chip_smoke.load_int8_golden_scales(sampler.net, golden)
            if name != "port":
                with torch.no_grad():
                    G.WIRING_FAULTS[name](sampler.net)
        steps, _ = chip_smoke.replay_int8(sampler, fp, golden, gold, "cpu")
        print(f"6. {name}: worst mean ratio "
              f"{max(r for r, _, _ in steps):.3f}, median ratio averaged "
              f"{np.mean([m for _, m, _ in steps]):.4f}")

    def wins(init, want):
        n = sum(int((init[k] > v).sum()) for k, v in want.items())
        return n, sum(v.numel() for v in want.values())

    cfg = cfglib.load_yaml(os.path.join(G.FIXTURE, "config.yaml"))
    net = instantiate(cfg["sampler_net"], quant_int8="static")
    init = unet_small_quant_scales_from_flax(jax.tree.map(
        np.asarray, net.init(jax.random.fold_in(jax.random.key(123), 999),
                             jnp.zeros((1, 16, 16, 3)),
                             jnp.zeros((1,)))["quant_scales"]))
    want = {k[len("scale/"):]: torch.from_numpy(v)
            for k, v in golden.items() if k.startswith("scale/")}
    print("7. CIFAR fixture: init scales exceed the calibrated ones in "
          "%d of %d channels" % wins(init, want))
    x0, eps = U._calib_draws(7)
    for case, kw in U.CALIB_CASES.items():
        want, init = U.jax_calibration(kw, x0, eps)
        print(f"   test net, {case}: %d of %d channels" % wins(init, want))


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    wiring_fault_report(*fixture_report())
    init_seed_report()
    net_report()
    cifar_report()
