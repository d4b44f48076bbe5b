"""The proxy FID files for the entries' CPU tests, at a small size: the
seed-0 synthetic Inception weights and statistics over a few images, written
by the port's ``fid/proxy.py`` into ``<root>/datasets``."""
from __future__ import annotations

import os

import torch

from dxmi_tpu_torch.fid import proxy
from dxmi_tpu_torch.fid.inception import (build_inception,
                                          load_fid_inception_params)

N_IMAGES = 16


def write_datasets(root: str, virtual: str = None, image_size: int = 16,
                   n_class: int = 4) -> str:
    """``<root>/datasets`` with the weights, ``cifar10_train_fid_stats.npz``
    over ``fake_cifar`` and, with ``virtual``, ``VIRTUAL_<virtual>.npz``
    over the structured class images; its path."""
    out = os.path.join(root, "datasets")
    model = build_inception(load_fid_inception_params(
        proxy.write_weights(out)), torch.device("cpu"))
    proxy.write_cifar_stats(out, model, N_IMAGES, 112233, 8)
    if virtual:
        proxy.write_virtual_stats(out, virtual, model, N_IMAGES, image_size,
                                  n_class, 42, 8)
    return out
