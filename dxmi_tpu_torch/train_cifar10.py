"""DxMI training for CIFAR-10 with the port (``train_cifar10.py:130-379``):
UNetSmall + VARSampler (T=10) or the DDGAN generator NCSN++ +
DDGANSampler (T=4, ``configs/cifar10/T4_ddgan.yaml``, ``value_resample``),
and ``DxMITrainer``, one iteration being

    sample -> update_f_v -> update_sampler

(with ``training.n_critic`` > 1: sample -> update_f_v each iteration, and
every n_critic iterations ``update_sampler`` on the trajectories of those
iterations, concatenated: ``train_cifar10.py:305-338``)

    python -m dxmi_tpu_torch.train_cifar10 --config configs/cifar10/T10.yaml \
        --dataset configs/cifar10/cifar10.yaml --run myrun [--fake_data] \
        [--max_steps N] [--resume] [--wandb] [--attn_impl fused|einsum] \
        [--fuse_gn_conv true|false] [--fast_levers] [--device cuda|cpu] \
        [--any.dot.key value ...]

The sampler net runs fp32. UNetSmall takes the generation defaults: fused
attention (K2, or K7 under ``DXMI_FUSED_ATTN_BB`` > 1) and K3 for each
GN+SiLU+conv whose dropout is inactive (``--attn_impl`` and
``--fuse_gn_conv`` are its options); NCSN++ runs its GroupNorms through K1
and has none of these options, nor the levers (``--fast_levers`` raises
there, as the JAX entry fails on NCSN++). ``--fast_levers`` (or ``DXMI_TRAIN_LEVERS=1``)
applies the JAX entry's overrides (``train_cifar10.py:164-174``,
``LEVER_NET``, ``LEVER_VALUE_NET``): the sampler net in bf16 with the bf16
softmax without its max pass, the phase upsample and ``bf16_onepass``
GroupNorm statistics, the value torso in bf16; parameters and the saved
config stay fp32. The fused layers keep running there, in bf16 (K3, and
K2 or K7 at d = 256); ``--fuse_gn_conv false --attn_impl einsum`` is the
JAX entry's own arithmetic. Without ``training.sampler_ckpt`` on disk the
weights are PyTorch's initialisation drawn from ``training.seed`` (DxMI
fine-tunes a pretrained sampler: the run warns). The trajectory is sampled
in chunks of 32 (64 under the levers) when the config does not set
``trainer.sample_chunks`` (the JAX entry's rule). Each epoch prints ``sample_norm_`` of 64 samples.
FID runs every ``training.fid_epoch`` epochs or ``fid_every`` iterations
(``fid/runner.py`` ``maybe_compute_fid``: ``n_fid_samples`` samples in
batches of ``sampling_batchsize`` against the CIFAR-10 statistics under
``datasets/``), and each time it improves, the run directory gets
``sampler_best.pth`` and ``value_best.pth`` with ``fid``, ``epoch`` and
``iter`` beside the weights; it is skipped, as in the JAX entry, while the
Inception weights or the statistics are not on disk. The run directory
``results/<data.name>/<config name>/<run>`` gets ``config.yaml`` and, at the
end, ``sampler_last.pth`` and ``value_last.pth`` in the reference's format,
which ``generate_cifar10 --sampler last`` reads. The full train state
(``train_state.msgpack``, the JAX package's layout: ``utils/train_state.py``)
is saved at each epoch boundary with the next epoch and at the end with the
current one (so a ``--max_steps`` stop resumes at the start of its epoch);
``--resume`` restores it with its epoch, iteration and best FID, and, as the
JAX entry, draws again from the seed (``train_cifar10.py:191-202``,
``:372-393``). ``--wandb`` logs to wandb when it is installed (else JAX's
warning); a ``tensorboardX`` writer is used when that package is.
``training.sampler_ckpt`` and ``value_ckpt`` may be flax
``.msgpack`` files of the JAX package or reference ``.pth`` files; an
NCSN++ ``sampler_ckpt`` must be ``.msgpack`` (``runs_conv/
pre_ddgan800.msgpack``): there is no reference layout to convert from, and
a ``.pth`` one raises, as in the JAX entry (``train_cifar10.py:86-96``).
"""
from __future__ import annotations

import argparse
import os
import time
from typing import Any, Dict, Tuple

import numpy as np
import torch

from dxmi_tpu_torch.config import (instantiate, load_yaml, merge,
                                   parse_nested_args, parse_unknown_args,
                                   save_yaml, to_yaml)
from dxmi_tpu_torch.data.cifar10 import EpochLoader, fake_cifar, get_dataset
from dxmi_tpu_torch.fid import runner as fid_runner
from dxmi_tpu_torch.runtime import select_device
from dxmi_tpu_torch.samplers import sample_chunked
from dxmi_tpu_torch.trainers.buffer import concat, from_d_sample
from dxmi_tpu_torch.trainers.dxmi import DxMITrainer, train_step
from dxmi_tpu_torch.utils.checkpoint import (TRAIN_STATE, load_sampler_into,
                                             load_sampler_state,
                                             load_train_state,
                                             load_value_state, net_kind,
                                             save_run_checkpoint,
                                             save_train_state)
from dxmi_tpu_torch.utils.logging import (BaseLogger, expand_metrics,
                                          init_wandb, make_grid,
                                          tensorboard_writer, weight_norm_of)

# the per-chunk batch of the trajectory sampling at fp32, and under the
# levers' bf16 torso (train_cifar10.py:61-72)
SAMPLE_CHUNK = 32
LEVER_SAMPLE_CHUNK = 64
# --fast_levers: the sampler net's and the value net's overrides
# (train_cifar10.py:164-174; JAX sets the statistics by DXMI_GN_STATS)
LEVER_NET = dict(dtype=torch.bfloat16, softmax_f32=False, softmax_nomax=True,
                 up_impl="phase", gn_stats="bf16_onepass")
LEVER_VALUE_NET = dict(dtype=torch.bfloat16)


def levers_on(flag: bool) -> bool:
    """Whether the levers apply: ``--fast_levers`` or DXMI_TRAIN_LEVERS=1,
    as the JAX entry reads them."""
    return flag or os.environ.get("DXMI_TRAIN_LEVERS") == "1"


def build(cfg: Dict[str, Any], device: torch.device, seed: int,
          attn_impl: str = "fused", fuse_gn_conv: bool = True,
          levers: bool = False
          ) -> Tuple[torch.nn.Module, torch.nn.Module, DxMITrainer]:
    """The config's sampler, value and trainer on ``device`` (the JAX entry's
    ``build`` and ``init_state``): the checkpoints when they exist, else
    weights drawn from ``seed``; the optimizers; the auto-chunk rule.
    ``levers``: the nets get ``LEVER_NET`` and ``LEVER_VALUE_NET``."""
    tr = cfg["training"]
    kind = net_kind(cfg["sampler_net"].get("_target_"))
    if kind == "ncsnpp":
        if levers:
            raise ValueError("--fast_levers: the levers are UNetSmall's "
                             "options (softmax_f32, softmax_nomax, up_impl); "
                             "NCSNpp has none of them")
        net_kw = {}
    else:
        net_kw = dict(attn_impl=attn_impl, fuse_gn_conv=fuse_gn_conv,
                      **(LEVER_NET if levers else {}))
    torch.manual_seed(seed)
    net = instantiate(cfg["sampler_net"], **net_kw)
    sampler = instantiate(cfg["sampler"], net=net)
    path = tr.get("sampler_ckpt")
    if path and os.path.exists(path):
        if kind == "ncsnpp" and not path.endswith(".msgpack"):
            raise SystemExit(
                f"sampler_ckpt {path}: no converter for the DDGAN NCSN++ "
                "from a PyTorch checkpoint (the reference ships no module "
                "for it, so the JAX package's NCSNpp has its own layout); "
                "train from scratch, or load a JAX package .msgpack file")
        load_sampler_into(sampler, load_sampler_state(path, net=kind))
        print(f"Sampler checkpoint loaded from {path}", flush=True)
    elif path:
        print(f"WARNING: sampler ckpt {path} not found; training from "
              f"weights drawn from seed {seed} (DxMI fine-tunes a pretrained "
              "sampler)", flush=True)
    vcfg = cfg["value"]
    if levers:
        vcfg = {**vcfg, "net": {**vcfg["net"], **LEVER_VALUE_NET}}
    value = instantiate(vcfg)
    v_path = tr.get("value_ckpt")
    if v_path and os.path.exists(v_path):
        value.load_state_dict(load_value_state(v_path))
        print(f"value checkpoint loaded from {v_path}", flush=True)
    sampler.to(device)
    value.to(device)
    trainer = instantiate(cfg["trainer"], batchsize=int(tr["batchsize"]),
                          n_timesteps=cfg["sampler"]["n_timesteps"])
    trainer.set_models(sampler, value, lr=float(tr["lr"]),
                       v_lr=float(tr["v_lr"]),
                       beta_lr=float(tr.get("beta_lr") or tr["lr"]))
    if trainer.sample_chunks == 1 and "sample_chunks" not in cfg["trainer"]:
        b = trainer.batchsize
        chunk = LEVER_SAMPLE_CHUNK if levers else SAMPLE_CHUNK
        if b > chunk and b % chunk == 0:
            trainer.sample_chunks = b // chunk
    return sampler, value, trainer


def to_device_batch(images: np.ndarray, device: torch.device) -> torch.Tensor:
    """NHWC [0, 1] numpy -> NCHW [-1, 1] fp32 on ``device``."""
    x = torch.from_numpy(np.ascontiguousarray(images.transpose(0, 3, 1, 2)))
    return x.to(device) * 2.0 - 1.0


def main() -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--config", required=True)
    p.add_argument("--dataset", required=True)
    p.add_argument("--run", default="run")
    p.add_argument("--max_steps", type=int, default=None)
    p.add_argument("--fake_data", action="store_true")
    p.add_argument("--fake_data_size", type=int, default=None)
    p.add_argument("--resume", action="store_true")
    p.add_argument("--wandb", action="store_true")
    p.add_argument("--fast_levers", action="store_true")
    p.add_argument("--attn_impl", default="fused", choices=["fused", "einsum"])
    p.add_argument("--fuse_gn_conv", default="true", choices=["true", "false"])
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args, unknown = p.parse_known_args()
    levers = levers_on(args.fast_levers)
    if levers:
        print("fast_levers: bf16 sampler and value torso, nomax softmax, "
              "phase upsample, bf16_onepass GN statistics, 64-sample "
              "chunks", flush=True)

    cfg = merge(load_yaml(args.config), load_yaml(args.dataset),
                parse_nested_args(parse_unknown_args(unknown)))
    print(to_yaml(cfg), flush=True)
    tr = cfg["training"]
    seed = int(tr["seed"])
    n_critic, n_generator = int(tr["n_critic"]), int(tr["n_generator"])
    fid_epoch, fid_every = tr.get("fid_epoch"), tr.get("fid_every")
    if fid_epoch is not None and fid_every is not None:
        raise ValueError("cannot set both fid_epoch and fid_every")
    dev = select_device(args.device)
    batchsize = int(tr["batchsize"])
    sampler, value, trainer = build(cfg, dev, seed, args.attn_impl,
                                    args.fuse_gn_conv == "true", levers)
    print(f"trajectory sampling in {trainer.sample_chunks} chunk(s)",
          flush=True)

    if args.fake_data:
        n_fake = args.fake_data_size or max(batchsize * 4, 256)
        train_set = fake_cifar(n_fake, seed)
        print(f"using fake data stand-in ({n_fake} images)", flush=True)
    else:
        train_set = get_dataset(cfg["data"]["name"],
                                cfg["data"].get("data_dir", "datasets"))
    loader = EpochLoader(train_set, batch_size=batchsize, seed=seed)

    model_cfg_name = os.path.basename(args.config).split(".")[0]
    logdir = os.path.join(f"results/{cfg['data']['name']}/{model_cfg_name}",
                          args.run)
    os.makedirs(logdir, exist_ok=True)
    save_yaml(cfg, os.path.join(logdir, "config.yaml"))
    use_wandb = False
    if args.wandb:
        proj = ("dxmi_cifar10_ddgan" if "ddgan" in model_cfg_name
                else f"dxmi_cifar10_T{cfg['sampler']['n_timesteps']}")
        use_wandb = init_wandb(proj, f"{model_cfg_name}_{args.run}", logdir,
                               dict(cfg)) is not None
    logger = BaseLogger(tensorboard_writer(logdir), use_wandb=use_wandb)
    print(f"run dir: {logdir}", flush=True)

    gen = torch.Generator(device=dev).manual_seed(seed)
    # FID draws from its own generator: training's draws do not depend on
    # whether the FID files are on disk
    run_fid = fid_runner.BestFID(cfg, sampler, value, logdir,
                                 torch.Generator(device=dev).manual_seed(seed),
                                 dev)
    start_epoch, i_iter = 0, 0
    if args.resume and os.path.exists(os.path.join(logdir, TRAIN_STATE)):
        meta = load_train_state(logdir, trainer)
        start_epoch, i_iter = int(meta["epoch"]), int(meta["i_iter"])
        run_fid.best = float(meta.get("best_fid", float("inf")))
        print(f"resumed full train state at epoch {start_epoch}, "
              f"iter {i_iter}", flush=True)

    def fid_at(epoch: int) -> None:
        fid = run_fid(epoch=epoch, iter=i_iter)
        if fid is not None:
            logger.log({"FID_": fid, "Best_FID_": run_fid.best}, i_iter)

    log_every = int(tr["log_every"])
    t0, start_iter = time.time(), i_iter
    done = False
    pending = []
    epoch = start_epoch
    for epoch in range(start_epoch, int(tr["n_epochs"])):
        with torch.no_grad():
            xi = sampler.sample(64, generator=gen)["sample"]
        norm = float(xi.reshape(xi.shape[0], -1).norm(dim=1).mean())
        print(f"epoch {epoch} sample_norm_={norm:.4f}", flush=True)
        grid = make_grid(((xi + 1) / 2).clamp(0, 1).permute(0, 2, 3, 1)
                         .cpu().numpy())
        logger.log({"sample_init@" if epoch == 0 else "sample@": grid,
                    "sample_norm_": norm}, 0 if epoch == 0 else i_iter)
        if fid_epoch is not None and epoch % int(fid_epoch) == 0:
            fid_at(epoch)
        for step, (images, _) in enumerate(loader.epoch(epoch)):
            if fid_every is not None and i_iter % int(fid_every) == 0:
                fid_at(epoch)
            x = to_device_batch(images, dev)
            if n_critic == 1:
                m, do_log = train_step(trainer, x, None, gen,
                                       n_generator=n_generator), True
            else:
                m, do_log = critic_step(trainer, x, gen, pending), False
                if (step + 1) % n_critic == 0:
                    m.update(trainer.update_sampler(
                        concat(*pending), n_generator=n_generator,
                        generator=gen))
                    pending, do_log = [], True
            if do_log and ((step + 1) % log_every == 0 or i_iter == 0):
                logger.log({**expand_metrics(
                    {k: v for k, v in m.items()
                     if not k.startswith("time/")}),
                    "weight_norm/sampler_": weight_norm_of(
                        sampler.parameters()),
                    "weight_norm/value_": weight_norm_of(value.parameters())},
                    i_iter)
                its = (i_iter + 1 - start_iter) / (time.time() - t0)
                print(f"iter {i_iter} d_loss={float(m['ebm/d_loss_']):.4f} "
                      f"sampler_loss={float(m['sampler/sampler_loss_']):.4f} "
                      f"({its:.3f} it/s) " + " ".join(
                          f"{k[5:]}={v:.3f}s" for k, v in m.items()
                          if k.startswith("time/")), flush=True)
            i_iter += 1
            done = args.max_steps is not None and i_iter >= args.max_steps
            if done:
                break
        if done:
            break
        save_train_state(logdir, trainer, i_iter=i_iter, epoch=epoch + 1,
                         best_fid=run_fid.best)
    save_run_checkpoint(logdir, "last", sampler, value,
                        meta={"epoch": epoch, "iter": i_iter})
    save_train_state(logdir, trainer, i_iter=i_iter, epoch=epoch,
                     best_fid=run_fid.best)
    print(f"done: {i_iter} iters", flush=True)


def critic_step(trainer: DxMITrainer, x: torch.Tensor,
                generator: torch.Generator, pending: list) -> Dict[str, Any]:
    """One iteration of the n_critic > 1 loop before its sampler update: a
    trajectory (kept in ``pending``) and ``update_f_v`` on it, with each
    phase's seconds under ``time/``."""
    sync = (torch.cuda.synchronize if x.device.type == "cuda"
            else (lambda: None))
    t0 = time.perf_counter()
    with torch.no_grad():
        traj = from_d_sample(sample_chunked(
            trainer.sampler, trainer.batchsize, trainer.sample_chunks,
            generator))
    pending.append(traj)
    sync()
    t1 = time.perf_counter()
    m = trainer.update_f_v(x, traj, generator=generator)
    sync()
    return {**m, "time/sample": t1 - t0,
            "time/update_f_v": time.perf_counter() - t1}


if __name__ == "__main__":
    main()
