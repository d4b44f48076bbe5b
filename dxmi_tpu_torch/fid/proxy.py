"""A proxy FID setup for a repository without the published Inception
weights: the port's counterpart of ``scripts/make_fid_proxy.py``, which
runs where JAX is not installed.

    python -m dxmi_tpu_torch.fid.proxy --out datasets [--n 4096] \
        [--seed 112233] [--extract_batch 64] [--virtual_name NAME \
        --image_size 16 --n_class 4 --data_seed 42] [--device cuda|cpu]

It writes into ``--out``:
- ``pt_inception-2015-12-05.npz``: synthetic weights in the published
  layout (``make_synthetic_state_dict(0)``, bit-equal to
  ``tests/_inception_oracle.make_synthetic_state_dict(0, numpy=True)``),
  unless the file exists;
- ``cifar10_train_fid_stats.npz``: the statistics (``mu``/``sigma``, also as
  ``m2``/``s2``) of the pool3 activations of ``fake_cifar`` (the
  ``--fake_data`` stand-in of ``train_cifar10``, the same seed);
- with ``--virtual_name``, ``VIRTUAL_<name>.npz``: the statistics of
  ``structured_class_images`` (the ``--fake_data`` pool of
  ``train_image_large``), the name its FID gate looks for.

The FID numbers are relative only (fixed random features), but every part
of the path runs: the BatchNorm fold, the statistics files, the best-FID
gate. Run from the directory whose ``datasets/`` the entries should find.
"""
from __future__ import annotations

import argparse
import os
from typing import Dict, List, Tuple

import numpy as np

from dxmi_tpu_torch.data.cifar10 import fake_cifar
from dxmi_tpu_torch.data.synthetic import structured_class_images
from dxmi_tpu_torch.fid import stats as stats_lib
from dxmi_tpu_torch.fid.inception import (InceptionV3FID, build_inception,
                                          load_fid_inception_params,
                                          pool3_host)
from dxmi_tpu_torch.runtime import select_device

WEIGHTS_NAME = "pt_inception-2015-12-05.npz"
CIFAR_STATS_NAME = "cifar10_train_fid_stats.npz"


def conv_specs() -> List[Tuple[str, int, int, Tuple[int, int]]]:
    """(key prefix, in channels, out channels, (kh, kw)) of every ConvBN of
    the network in forward order: the published file's key order, which
    the random draws follow."""
    specs = []

    def cbn(prefix, i, o, k):
        specs.append((prefix, i, o, k))

    cbn("Conv2d_1a_3x3", 3, 32, (3, 3))
    cbn("Conv2d_2a_3x3", 32, 32, (3, 3))
    cbn("Conv2d_2b_3x3", 32, 64, (3, 3))
    cbn("Conv2d_3b_1x1", 64, 80, (1, 1))
    cbn("Conv2d_4a_3x3", 80, 192, (3, 3))

    def inception_a(name, i, pf):
        cbn(f"{name}.branch1x1", i, 64, (1, 1))
        cbn(f"{name}.branch5x5_1", i, 48, (1, 1))
        cbn(f"{name}.branch5x5_2", 48, 64, (5, 5))
        cbn(f"{name}.branch3x3dbl_1", i, 64, (1, 1))
        cbn(f"{name}.branch3x3dbl_2", 64, 96, (3, 3))
        cbn(f"{name}.branch3x3dbl_3", 96, 96, (3, 3))
        cbn(f"{name}.branch_pool", i, pf, (1, 1))

    inception_a("Mixed_5b", 192, 32)
    inception_a("Mixed_5c", 256, 64)
    inception_a("Mixed_5d", 288, 64)

    cbn("Mixed_6a.branch3x3", 288, 384, (3, 3))
    cbn("Mixed_6a.branch3x3dbl_1", 288, 64, (1, 1))
    cbn("Mixed_6a.branch3x3dbl_2", 64, 96, (3, 3))
    cbn("Mixed_6a.branch3x3dbl_3", 96, 96, (3, 3))

    def inception_c(name, c7):
        cbn(f"{name}.branch1x1", 768, 192, (1, 1))
        cbn(f"{name}.branch7x7_1", 768, c7, (1, 1))
        cbn(f"{name}.branch7x7_2", c7, c7, (1, 7))
        cbn(f"{name}.branch7x7_3", c7, 192, (7, 1))
        cbn(f"{name}.branch7x7dbl_1", 768, c7, (1, 1))
        cbn(f"{name}.branch7x7dbl_2", c7, c7, (7, 1))
        cbn(f"{name}.branch7x7dbl_3", c7, c7, (1, 7))
        cbn(f"{name}.branch7x7dbl_4", c7, c7, (7, 1))
        cbn(f"{name}.branch7x7dbl_5", c7, 192, (1, 7))
        cbn(f"{name}.branch_pool", 768, 192, (1, 1))

    inception_c("Mixed_6b", 128)
    inception_c("Mixed_6c", 160)
    inception_c("Mixed_6d", 160)
    inception_c("Mixed_6e", 192)

    cbn("Mixed_7a.branch3x3_1", 768, 192, (1, 1))
    cbn("Mixed_7a.branch3x3_2", 192, 320, (3, 3))
    cbn("Mixed_7a.branch7x7x3_1", 768, 192, (1, 1))
    cbn("Mixed_7a.branch7x7x3_2", 192, 192, (1, 7))
    cbn("Mixed_7a.branch7x7x3_3", 192, 192, (7, 1))
    cbn("Mixed_7a.branch7x7x3_4", 192, 192, (3, 3))

    def inception_e(name, i):
        cbn(f"{name}.branch1x1", i, 320, (1, 1))
        cbn(f"{name}.branch3x3_1", i, 384, (1, 1))
        cbn(f"{name}.branch3x3_2a", 384, 384, (1, 3))
        cbn(f"{name}.branch3x3_2b", 384, 384, (3, 1))
        cbn(f"{name}.branch3x3dbl_1", i, 448, (1, 1))
        cbn(f"{name}.branch3x3dbl_2", 448, 384, (3, 3))
        cbn(f"{name}.branch3x3dbl_3a", 384, 384, (1, 3))
        cbn(f"{name}.branch3x3dbl_3b", 384, 384, (3, 1))
        cbn(f"{name}.branch_pool", i, 192, (1, 1))

    inception_e("Mixed_7b", 1280)
    inception_e("Mixed_7c", 2048)
    return specs


def make_synthetic_state_dict(seed: int = 0) -> Dict[str, np.ndarray]:
    """Random weights in the exact ``pt_inception-2015-12-05`` layout
    (numpy): He-scaled conv kernels, gamma ~ 1, running_var ~ 1, so a
    94-conv forward keeps O(1) activations; and the ``fc`` head."""
    rng = np.random.RandomState(seed)
    state = {}
    for prefix, i, o, (kh, kw) in conv_specs():
        fan_in = i * kh * kw
        state[f"{prefix}.conv.weight"] = rng.randn(
            o, i, kh, kw).astype(np.float32) * np.sqrt(2.0 / fan_in)
        state[f"{prefix}.bn.weight"] = (
            1.0 + 0.1 * rng.randn(o)).astype(np.float32)
        state[f"{prefix}.bn.bias"] = (0.05 * rng.randn(o)).astype(np.float32)
        state[f"{prefix}.bn.running_mean"] = (
            0.1 * rng.randn(o)).astype(np.float32)
        state[f"{prefix}.bn.running_var"] = (
            1.0 + 0.2 * rng.rand(o)).astype(np.float32)
        state[f"{prefix}.bn.num_batches_tracked"] = np.asarray(1000, np.int64)
    state["fc.weight"] = rng.randn(1008, 2048).astype(np.float32) * 0.02
    state["fc.bias"] = (0.01 * rng.randn(1008)).astype(np.float32)
    return state


def pool3_of(model: InceptionV3FID, images: np.ndarray,
             batch: int) -> np.ndarray:
    """pool3 activations (N, 2048) float32 of NHWC images, ``batch`` at a
    time: uint8 ones are divided by 255, float ones taken in [0, 1]."""
    acts = []
    for i in range(0, len(images), batch):
        x = images[i:i + batch]
        if x.dtype == np.uint8:
            x = x.astype(np.float32) / 255.0
        acts.append(pool3_host(model, x))
    return np.concatenate(acts)


def save_stats(path: str, acts: np.ndarray) -> None:
    mu, sigma = stats_lib.activation_statistics(acts)
    np.savez(path, mu=mu, sigma=sigma, m2=mu, s2=sigma)


def write_weights(out: str) -> str:
    """``<out>/pt_inception-2015-12-05.npz`` (the seed-0 synthetic weights)
    unless it exists; its path."""
    os.makedirs(out, exist_ok=True)
    path = os.path.join(out, WEIGHTS_NAME)
    if not os.path.exists(path):
        np.savez(path, **make_synthetic_state_dict(0))
        print(f"synthetic Inception weights -> {path}", flush=True)
    return path


def write_cifar_stats(out: str, model: InceptionV3FID, n: int, seed: int,
                      batch: int) -> str:
    """``<out>/cifar10_train_fid_stats.npz`` over ``fake_cifar(n, seed)``."""
    images = fake_cifar(n, seed).images
    path = os.path.join(out, CIFAR_STATS_NAME)
    save_stats(path, pool3_of(model, images, batch))
    print(f"fake-data FID stats ({len(images)} images) -> {path}", flush=True)
    return path


def write_virtual_stats(out: str, name: str, model: InceptionV3FID, n: int,
                        image_size: int, n_class: int, data_seed: int,
                        batch: int) -> str:
    """``<out>/VIRTUAL_<name>.npz`` over ``structured_class_images``."""
    imgs, _ = structured_class_images(n, image_size, n_class, seed=data_seed)
    path = os.path.join(out, f"VIRTUAL_{name}.npz")
    save_stats(path, pool3_of(model, (imgs + 1.0) / 2.0, batch))
    print(f"structured class-data stats ({len(imgs)}) -> {path}", flush=True)
    return path


def main() -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--out", default="datasets",
                   help="directory for the weights and statistics")
    p.add_argument("--batch", type=int, default=128,
                   help="training batchsize (sets the minimum fake-data "
                        "size, as train_cifar10 --fake_data)")
    p.add_argument("--n", type=int, default=4096)
    p.add_argument("--seed", type=int, default=112233)
    p.add_argument("--extract_batch", type=int, default=64)
    p.add_argument("--virtual_name", default=None)
    p.add_argument("--image_size", type=int, default=16)
    p.add_argument("--n_class", type=int, default=4)
    p.add_argument("--data_seed", type=int, default=42)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = p.parse_args()

    dev = select_device(args.device)
    wpath = write_weights(args.out)
    model = build_inception(load_fid_inception_params(wpath), dev)
    write_cifar_stats(args.out, model, max(args.n, args.batch * 4, 256),
                      args.seed, args.extract_batch)
    if args.virtual_name:
        write_virtual_stats(args.out, args.virtual_name, model, args.n,
                            args.image_size, args.n_class, args.data_seed,
                            args.extract_batch)


if __name__ == "__main__":
    main()
