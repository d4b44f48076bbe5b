"""DxMI training of the EDM sampler for ImageNet64 (class-conditional) and
LSUN-Bedroom 256 (unconditional; configs/lsun, with the IGEBM or the
Wide-ResNet value) with the port (``train_image_large.py:100-306``):
UNetADM + EDMSampler + ``DxMITrainerCond``, one iteration being

    sample -> update_f_v -> update_sampler (full-buffer sweep)

    python -m dxmi_tpu_torch.train_image_large --config configs/imagenet64/T10.yaml \
        --dataset configs/imagenet64/imagenet64.yaml --run myrun --fake_data \
        [--max_steps N] [--resume] [--save_state_every K] [--wandb] \
        [--attn_impl flash|fused_train|einsum] \
        [--up_impl phase|resize] [--gn_stats fp32|bf16_onepass] \
        [--device cuda|cpu] [--any.dot.key value ...]

The net keeps fp32 master parameters and computes in its config's dtype
(bf16 under ``use_fp16``). ``training.pretrained_path`` is a flax
``.msgpack`` file of the JAX package (``load_sampler_params``'s layouts) or
a reference ``.pth``; without it on disk the net's weights are drawn from
``training.seed`` (``seeded_normal_``) after the JAX entry's WARNING. The run
directory ``results/<data.name>/<config name>/<run>`` gets ``config.yaml``
and, at the end, ``sampler_last.pth`` and ``value_last.pth`` in the
reference's format, which ``generate_large --sampler last`` reads. Each
``log_every`` iterations it prints the JAX entry's line (d_loss,
sampler_loss, it/s). Every ``training.fid_every`` iterations, when the
Inception weights and the statistics ``datasets/VIRTUAL_<data.name>[_labeled]
.npz`` (``maybe_fid_state``; ``fid/proxy.py --virtual_name`` writes them for
the structured fake pool) are on disk, FID runs on ``n_fid_samples`` samples
and each improvement writes ``sampler_best.pth`` and ``value_best.pth`` with
``fid`` and ``i_iter``; without those files FID is skipped, as in the JAX
entry. The full train state (``train_state.msgpack``, the JAX package's
layout: ``utils/train_state.py``) is saved every ``--save_state_every``
iterations (default 500) and at the end; ``--resume`` restores it from the
run directory, with its iteration and best FID. As in the JAX entry
(``train_image_large.py:246-250``, ``:286-288``, ``:304-305``), a periodic
save records the iteration it has just run as ``i_iter``, so a run resumed
from it runs that iteration again; the final save records ``n_iter``; the
data stream and the generator start again from the seed. ``--wandb`` logs to
wandb when it is installed (else JAX's warning), and a ``tensorboardX``
writer is used when that package is. Without ``--fake_data`` the batches
come from the image folder ``data.data_dir`` (``data/image_folder.py``: PNG
files, classes from filename prefixes under ``sampler.class_cond``,
``data.cachefile``, ``data.deterministic``), decoded on ``--data_workers``
threads (default 4, as the JAX entry; 0 decodes in the loop), the call of
``train_image_large.py:199-209``.
"""
from __future__ import annotations

import argparse
import os
import time
from typing import Any, Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from dxmi_tpu_torch.config import (instantiate, load_yaml, merge,
                                   parse_nested_args, parse_unknown_args,
                                   save_yaml, to_yaml)
from dxmi_tpu_torch.data.image_folder import load_data
from dxmi_tpu_torch.data.synthetic import structured_class_images
from dxmi_tpu_torch.fid import runner as fid_runner
from dxmi_tpu_torch.models.unet_adm import create_unet_adm, seeded_normal_
from dxmi_tpu_torch.runtime import select_device
from dxmi_tpu_torch.samplers.edm import EDMSampler, KarrasDenoiser
from dxmi_tpu_torch.trainers.dxmi import train_step
from dxmi_tpu_torch.utils.checkpoint import (TRAIN_STATE, load_sampler_into,
                                             load_sampler_state,
                                             load_train_state,
                                             save_run_checkpoint,
                                             save_train_state)
from dxmi_tpu_torch.utils.logging import (BaseLogger, expand_metrics,
                                          init_wandb, tensorboard_writer)


def build_sampler(cfg: Dict[str, Any], device: torch.device, seed: int,
                  attn_impl: Optional[str] = None,
                  up_impl: Optional[str] = None,
                  gn_stats: str = "fp32") -> EDMSampler:
    """The config's EDMSampler on ``device`` with fp32 parameters: the
    pretrained checkpoint when ``training.pretrained_path`` exists, else
    weights drawn from ``seed``."""
    dcfg = dict(cfg["diffusion"])
    sigma_min = dcfg.pop("sigma_min", 0.002)
    sigma_max = dcfg.pop("sigma_max", 80.0)
    dcfg.pop("weight_schedule", None)
    distillation = dcfg.pop("distillation", False)
    with device:
        net = create_unet_adm(**dcfg, attn_impl=attn_impl, up_impl=up_impl,
                              gn_stats=gn_stats)
        sampler = EDMSampler(net, KarrasDenoiser(sigma_min=sigma_min,
                                                 sigma_max=sigma_max,
                                                 distillation=distillation),
                             **cfg["sampler"])
    sampler.to(device)
    path = cfg["training"].get("pretrained_path")
    if path and os.path.exists(path):
        load_sampler_into(sampler, load_sampler_state(path, net="unet_adm"))
        print(f"pretrained EDM loaded from {path}", flush=True)
    else:
        if path:
            print(f"WARNING: pretrained ckpt {path} missing; random init "
                  f"from seed {seed}", flush=True)
        seeded_normal_(net, seed)
    return sampler


def maybe_fid_state(cfg: Dict[str, Any], device: torch.device
                    ) -> Optional[fid_runner.FIDState]:
    """The FID network and reference statistics (``VIRTUAL_*.npz``, in the
    JAX entry's order), or None when either file is not on disk."""
    name = cfg["data"]["name"]
    stats_candidates = (
        f"datasets/VIRTUAL_{name}_labeled.npz",
        f"datasets/VIRTUAL_{name}.npz",
        "datasets/VIRTUAL_imagenet64_labeled.npz" if "imagenet" in name else
        "datasets/VIRTUAL_lsun_bedroom256.npz")
    w = fid_runner._find(fid_runner.DEFAULT_WEIGHTS)
    s = fid_runner._find(stats_candidates)
    if w is None or s is None:
        return None
    return fid_runner.build_fid_state(w, s, device)


def fake_data(cfg: Dict[str, Any], sampler: EDMSampler, size: int,
              batchsize: int, seed: int, device: torch.device
              ) -> Iterator[Tuple[torch.Tensor, Optional[torch.Tensor]]]:
    """Batches (x NCHW, y or None) drawn with replacement from the structured
    class pool, as the JAX entry's ``--fake_data``."""
    res = sampler.sample_shape[1]
    pool_x, pool_y = structured_class_images(
        max(size, batchsize), res, max(sampler.num_classes, 1), seed=seed)
    pool_x = torch.from_numpy(np.ascontiguousarray(
        pool_x.transpose(0, 3, 1, 2))).to(device)
    pool_y = torch.from_numpy(pool_y.astype(np.int64)).to(device)
    class_cond = bool(cfg["sampler"].get("class_cond"))
    print(f"using structured fake data ({len(pool_x)} images)", flush=True)
    rng = np.random.RandomState(seed)
    while True:
        idx = torch.from_numpy(rng.randint(0, len(pool_x), batchsize)).to(
            device)
        yield pool_x[idx], (pool_y[idx] if class_cond else None)


def folder_data(cfg: Dict[str, Any], batchsize: int, seed: int,
                num_workers: int, device: torch.device
                ) -> Iterator[Tuple[torch.Tensor, Optional[torch.Tensor]]]:
    """Batches (x NCHW, y or None) of the image folder ``data.data_dir``,
    as the JAX entry calls ``load_data`` (one process)."""
    class_cond = bool(cfg["sampler"].get("class_cond"))
    for x, extra in load_data(
            data_dir=cfg["data"]["data_dir"], batch_size=batchsize,
            image_size=int(cfg["data"]["image_size"]),
            class_cond=class_cond, cachefile=cfg["data"].get("cachefile"),
            deterministic=bool(cfg["data"].get("deterministic", False)),
            seed=seed, num_workers=num_workers):
        y = (torch.from_numpy(extra["y"].astype(np.int64)).to(device)
             if class_cond else None)
        yield torch.from_numpy(np.ascontiguousarray(
            x.transpose(0, 3, 1, 2))).to(device), y


def main() -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--config", required=True)
    p.add_argument("--dataset", required=True)
    p.add_argument("--run", default="run")
    p.add_argument("--max_steps", type=int, default=None)
    p.add_argument("--fake_data", action="store_true")
    p.add_argument("--fake_data_size", type=int, default=1024)
    p.add_argument("--up_impl", default=None, choices=["phase", "resize"])
    p.add_argument("--gn_stats", default="fp32",
                   choices=["fp32", "bf16_onepass"])
    p.add_argument("--attn_impl", default=None,
                   choices=["einsum", "flash", "fused_train"])
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--wandb", action="store_true")
    p.add_argument("--resume", action="store_true")
    p.add_argument("--data_workers", type=int, default=4)
    p.add_argument("--save_state_every", type=int, default=500)
    args, unknown = p.parse_known_args()

    cfg = merge(load_yaml(args.config), load_yaml(args.dataset),
                parse_nested_args(parse_unknown_args(unknown)))
    print(to_yaml(cfg), flush=True)
    tr = cfg["training"]
    seed = int(tr["seed"])
    dev = select_device(args.device)
    batchsize = int(tr["batchsize"])

    sampler = build_sampler(cfg, dev, seed, args.attn_impl, args.up_impl,
                            args.gn_stats)
    with dev:
        value = instantiate(cfg["value"])
    value.to(dev)
    trainer = instantiate(cfg["trainer"], batchsize=batchsize,
                          n_timesteps=cfg["sampler"]["n_timesteps"])
    trainer.set_models(sampler, value, lr=float(tr["lr"]),
                       v_lr=float(tr["v_lr"]),
                       beta_lr=float(tr.get("beta_lr") or tr["lr"]))

    if args.fake_data:
        data = fake_data(cfg, sampler, args.fake_data_size, batchsize, seed,
                         dev)
    else:
        data = folder_data(cfg, batchsize, seed, args.data_workers, dev)

    model_cfg_name = os.path.basename(args.config).split(".")[0]
    logdir = os.path.join(f"results/{cfg['data']['name']}/{model_cfg_name}",
                          args.run)
    os.makedirs(logdir, exist_ok=True)
    save_yaml(cfg, os.path.join(logdir, "config.yaml"))
    use_wandb = False
    if args.wandb:
        proj = f"dxmi_{cfg['data']['name']}_T{cfg['sampler']['n_timesteps']}"
        use_wandb = init_wandb(proj, f"{model_cfg_name}_{args.run}", logdir,
                               dict(cfg)) is not None
    logger = BaseLogger(tensorboard_writer(logdir), use_wandb=use_wandb)

    gen = torch.Generator(device=dev).manual_seed(seed)
    fid_state = maybe_fid_state(cfg, dev)
    # FID draws from its own generator, as in train_cifar10
    run_fid = fid_runner.BestFID(cfg, sampler, value, logdir,
                                 torch.Generator(device=dev).manual_seed(seed),
                                 dev, state=fid_state)
    start_iter = 0
    if args.resume and os.path.exists(os.path.join(logdir, TRAIN_STATE)):
        meta = load_train_state(logdir, trainer)
        start_iter = int(meta["i_iter"])
        run_fid.best = float(meta.get("best_fid", float("inf")))
        print(f"resumed full train state at iter {start_iter}", flush=True)
    fid_every = tr.get("fid_every")
    log_every = int(tr["log_every"])
    n_iter = int(tr["n_iter"]) if args.max_steps is None else args.max_steps
    t0 = time.time()
    for i_iter in range(start_iter, n_iter):
        if (fid_every and fid_state is not None
                and i_iter % int(fid_every) == 0):
            fid = run_fid(i_iter=i_iter)
            if fid is not None:
                logger.log({"FID_": fid, "Best_FID_": run_fid.best}, i_iter)
        x, y = next(data)
        m = train_step(trainer, x, y, gen)
        if i_iter and i_iter % int(args.save_state_every) == 0:
            save_train_state(logdir, trainer, i_iter=i_iter, epoch=0,
                             best_fid=run_fid.best)
        if i_iter % log_every == 0:
            logger.log(expand_metrics(
                {k: v for k, v in m.items() if not k.startswith("time/")}),
                i_iter)
            ips = (i_iter + 1 - start_iter) / (time.time() - t0)
            print(f"iter {i_iter} d_loss={float(m['ebm/d_loss_']):.4f} "
                  f"sampler_loss={float(m['sampler/sampler_loss_']):.4f} "
                  f"({ips:.3f} it/s)", flush=True)
    save_run_checkpoint(logdir, "last", sampler, value,
                        meta={"i_iter": n_iter})
    save_train_state(logdir, trainer, i_iter=n_iter, epoch=0,
                     best_fid=run_fid.best)
    print(f"nan-guard skips: {trainer.nan_guard_skips}", flush=True)
    print("done", flush=True)


if __name__ == "__main__":
    main()
