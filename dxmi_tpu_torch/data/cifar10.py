"""CIFAR-10 for the port's training entry: the port's own copy of
``dxmi_tpu.data.cifar10`` (numpy and the standard library only).

``CIFAR10`` reads the python-version batches (stdlib pickle) into host memory
as NHWC uint8; ``EpochLoader`` serves epoch-shuffled, horizontally flipped,
drop-last batches in [0, 1], deterministic given (seed, epoch) and the same
as the JAX package's; ``fake_cifar`` is the synthetic stand-in, bit-equal to
the JAX package's for the same seed.
"""
from __future__ import annotations

import os
import pickle
import tarfile
from typing import Iterator, Tuple

import numpy as np

CIFAR_DIRNAME = "cifar-10-batches-py"
CIFAR_TGZ = "cifar-10-python.tar.gz"


class CIFAR10:
    """In-memory CIFAR-10 train or test split, NHWC uint8
    (``cifar10.py:26-61``)."""

    def __init__(self, data_dir: str, train: bool = True):
        base = os.path.join(data_dir, CIFAR_DIRNAME)
        if not os.path.isdir(base):
            tgz = os.path.join(data_dir, CIFAR_TGZ)
            if not os.path.isfile(tgz):
                raise FileNotFoundError(
                    f"CIFAR-10 not found under {data_dir} (expected "
                    f"{CIFAR_DIRNAME}/ or {CIFAR_TGZ}); provide the dataset "
                    "on disk, or pass --fake_data")
            with tarfile.open(tgz) as tf:
                tf.extractall(data_dir)
        files = ([f"data_batch_{i}" for i in range(1, 6)] if train
                 else ["test_batch"])
        xs, ys = [], []
        for fn in files:
            with open(os.path.join(base, fn), "rb") as f:
                d = pickle.load(f, encoding="bytes")
            xs.append(np.asarray(d[b"data"], dtype=np.uint8))
            ys.append(np.asarray(d[b"labels"], dtype=np.int32))
        self.images = np.concatenate(xs).reshape(-1, 3, 32, 32).transpose(
            0, 2, 3, 1)
        self.labels = np.concatenate(ys)

    def __len__(self) -> int:
        return len(self.images)


def get_dataset(name: str, data_dir: str = "datasets", split: str = "train"):
    if name == "cifar10":
        return CIFAR10(data_dir, train=(split == "train"))
    raise ValueError(f"unknown dataset: {name}")


class EpochLoader:
    """Epoch-shuffled, drop-last batches with random horizontal flips
    (``cifar10.py:63-94``): the permutation and the flips come from
    ``np.random.RandomState(seed + epoch)``; a process takes a rank-strided
    slice of the permutation."""

    def __init__(self, dataset, batch_size: int, seed: int = 0,
                 process_index: int = 0, process_count: int = 1,
                 flip: bool = True):
        self.ds = dataset
        self.batch_size = batch_size
        self.seed = seed
        self.process_index = process_index
        self.process_count = process_count
        self.flip = flip

    def steps_per_epoch(self) -> int:
        return len(self.ds) // (self.batch_size * self.process_count)

    def epoch(self, epoch: int) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        """(images NHWC float32 in [0, 1], labels int32) per batch."""
        rng = np.random.RandomState(self.seed + epoch)
        perm = rng.permutation(len(self.ds))
        shard = perm[self.process_index::self.process_count]
        n = self.steps_per_epoch() * self.batch_size
        shard = shard[:n]
        for i in range(0, n, self.batch_size):
            idx = shard[i:i + self.batch_size]
            x = self.ds.images[idx].astype(np.float32) / 255.0
            if self.flip:
                flip_mask = rng.rand(len(idx)) < 0.5
                x[flip_mask] = x[flip_mask, :, ::-1, :]
            yield x, self.ds.labels[idx]


def fake_cifar(n: int = 256, seed: int = 0, structured: bool = True):
    """A synthetic CIFAR-10 stand-in (``cifar10.py:97-125``): smooth colour
    gradients with a bright blob (``structured``) or uniform noise, uint8
    NHWC, and uniform labels."""
    ds = CIFAR10.__new__(CIFAR10)
    rng = np.random.RandomState(seed)
    if not structured:
        ds.images = (rng.rand(n, 32, 32, 3) * 255).astype(np.uint8)
    else:
        yy, xx = np.mgrid[0:32, 0:32].astype(np.float32) / 31.0
        a, b, c = [rng.uniform(-1, 1, (n, 1, 1)) for _ in range(3)]
        base = 0.5 + 0.4 * (a * xx + b * yy + c * xx * yy)
        cx = rng.uniform(0.2, 0.8, (n, 1, 1))
        cy = rng.uniform(0.2, 0.8, (n, 1, 1))
        blob = np.exp(-(((xx - cx) ** 2 + (yy - cy) ** 2) / 0.02))
        w = rng.uniform(0.2, 1.0, (n, 1, 1, 3))
        bw = rng.uniform(0.0, 1.0, (n, 1, 1, 3))
        img = (base[..., None] * w + 0.6 * blob[..., None] * bw
               + rng.normal(0, 0.02, (n, 32, 32, 3)))
        ds.images = (np.clip(img, 0, 1) * 255).astype(np.uint8)
    ds.labels = rng.randint(0, 10, n).astype(np.int32)
    return ds
