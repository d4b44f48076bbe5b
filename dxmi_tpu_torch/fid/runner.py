"""FID in the entries (``dxmi_tpu/fid/runner.py``): samples from the
sampler, their pool3 activations on the device, the Frechet distance to
cached dataset statistics (``.npz`` with ``mu``/``sigma`` or ``m2``/``s2``,
or the reference's ``.pt``).

The weights and statistics are looked up relative to the working directory,
as in the JAX package. Where they are not on disk, ``maybe_compute_fid``
skips FID and the caller goes on, as the JAX package's does; that is the
reference's behaviour, not a move off the device.
"""
from __future__ import annotations

import os
import time
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from dxmi_tpu_torch.fid import stats as stats_lib
from dxmi_tpu_torch.data.cifar10 import CIFAR10
from dxmi_tpu_torch.fid.inception import (InceptionV3FID, build_inception,
                                          load_fid_inception_params,
                                          pool3_host)
from dxmi_tpu_torch.fid.proxy import pool3_of
from dxmi_tpu_torch.samplers import sample_many
from dxmi_tpu_torch.utils.checkpoint import save_run_checkpoint

DEFAULT_WEIGHTS = ("datasets/pt_inception-2015-12-05.npz",
                   "pretrained/pt_inception-2015-12-05.npz",
                   "datasets/pt_inception-2015-12-05.pth",
                   "pretrained/pt_inception-2015-12-05.pth")
DEFAULT_STATS = ("datasets/cifar10_train_fid_stats.pt",
                 "datasets/cifar10_train_fid_stats.npz",
                 "datasets/fid_stats_cifar10_train.npz")


def _find(paths: Sequence[str]) -> Optional[str]:
    for p in paths:
        if os.path.exists(p):
            return p
    return None


def _numpy_globals() -> list:
    """What ``torch.load(weights_only=True)`` must allow to read numpy
    float arrays pickled by numpy 1 or 2, and nothing more."""
    core = getattr(np, "_core", None) or np.core
    rec = core.multiarray._reconstruct
    return [np.ndarray, np.dtype, type(np.dtype(np.float64)),
            type(np.dtype(np.float32)),
            (rec, "numpy.core.multiarray._reconstruct"),
            (rec, "numpy._core.multiarray._reconstruct")]


def load_dataset_stats(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """(mu, sigma) of a statistics file: ``.npz`` (``mu``/``sigma`` or
    ``m2``/``s2``) or the reference's ``.pt`` (``{'m2', 's2'}`` numpy
    arrays or tensors)."""
    if path.endswith(".npz"):
        with np.load(path) as d:
            if "mu" in d:
                return d["mu"], d["sigma"]
            return d["m2"], d["s2"]
    if path.endswith(".pt"):
        with torch.serialization.safe_globals(_numpy_globals()):
            d = torch.load(path, map_location="cpu", weights_only=True)
        return np.asarray(d["m2"]), np.asarray(d["s2"])
    raise ValueError(f"unknown stats format: {path}")


class FIDState:
    """The Inception network on its device and the dataset statistics.
    ``extract_raw`` maps NCHW [0, 1] images on the device to (B, 2048)
    activations there; ``extract_fn`` maps NHWC [0, 1] host images to host
    activations (float32)."""

    def __init__(self, model: InceptionV3FID, m2: np.ndarray, s2: np.ndarray):
        self.model = model
        self.device = next(model.parameters()).device
        self.m2 = m2
        self.s2 = s2

    @torch.no_grad()
    def extract_raw(self, x01: torch.Tensor) -> torch.Tensor:
        return self.model(x01)

    def extract_fn(self, x01_nhwc: np.ndarray) -> np.ndarray:
        return pool3_host(self.model, x01_nhwc)


def build_fid_state(weights_path: str, stats_path: str,
                    device: torch.device) -> FIDState:
    model = build_inception(load_fid_inception_params(weights_path), device)
    m2, s2 = load_dataset_stats(stats_path)
    return FIDState(model, m2, s2)


@torch.no_grad()
def compute_fid_from_sampler(sampler, generator: torch.Generator,
                             fid_state: FIDState, n_samples: int, batch: int,
                             dispatch_chunk: int = 8,
                             timing: Optional[Dict[str, Any]] = None
                             ) -> float:
    """FID of ``n_samples`` samples drawn from ``sampler`` with
    ``generator``: ``dispatch_chunk`` whole trajectories of ``batch`` at a
    time (``samplers.sample_many``), so ``ceil(n_samples / batch)`` rounded
    up to whole chunks are drawn and the first ``n_samples`` kept, as the
    JAX package counts them; ``clip((x + 1) / 2, 0, 1)``; Inception one
    sampler batch at a time. ``timing``, when given, receives the seconds
    of ``sample``, ``inception`` and ``frechet`` (each phase synchronised)
    and the Frechet ``route``."""
    acts = []
    n_batches = int(np.ceil(n_samples / batch))
    t_sample = t_incep = 0.0
    sync = (torch.cuda.synchronize if fid_state.device.type == "cuda"
            else (lambda: None))
    done = 0
    while done < n_batches:
        t0 = time.perf_counter()
        xs = sample_many(sampler, dispatch_chunk, batch, generator)
        x01 = ((xs + 1.0) / 2.0).clamp(0.0, 1.0)
        sync()
        t1 = time.perf_counter()
        for x in x01:
            acts.append(fid_state.extract_raw(x).cpu().numpy())
        t_sample += t1 - t0
        t_incep += time.perf_counter() - t1
        done += dispatch_chunk
    m1, s1 = stats_lib.activation_statistics(np.concatenate(acts)[:n_samples])
    info: Dict[str, Any] = {}
    fid = stats_lib.frechet_distance(m1, s1, fid_state.m2, fid_state.s2,
                                     info=info)
    if timing is not None:
        timing.update(sample=t_sample, inception=t_incep,
                      frechet=info["seconds"], route=info["route"])
    return fid


def build_cifar_train_stats(weights_path: str, device: torch.device,
                            data_dir: str = "datasets",
                            out_path: str =
                            "datasets/cifar10_train_fid_stats.npz",
                            batch: int = 100) -> Optional[str]:
    """Compute and cache the CIFAR-10 train-set statistics when the raw
    batches are on disk (the reference computes them at the first FID
    call); the cache path, or None without the batches."""
    try:
        ds = CIFAR10(data_dir, train=True)
    except (FileNotFoundError, OSError):
        return None
    model = build_inception(load_fid_inception_params(weights_path), device)
    acts = pool3_of(model, ds.images, batch)
    mu, sigma = stats_lib.activation_statistics(acts)
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    np.savez(out_path, mu=mu, sigma=sigma, m2=mu, s2=sigma)
    return out_path


def maybe_compute_fid(cfg: Dict[str, Any], sampler,
                      generator: torch.Generator,
                      fid_state: Optional[FIDState], device: torch.device,
                      timing: Optional[Dict[str, Any]] = None
                      ) -> Tuple[Optional[float], Optional[FIDState]]:
    """The entries' hook: FID when the weights and statistics exist (for
    CIFAR-10 the statistics are built from the raw batches when missing),
    else (None, None). Pass the returned state back in to reuse the
    network and statistics."""
    if fid_state is None:
        w = _find(DEFAULT_WEIGHTS)
        s = _find(DEFAULT_STATS)
        if w is not None and s is None \
                and cfg.get("data", {}).get("name") == "cifar10":
            s = build_cifar_train_stats(
                w, device, data_dir=cfg["data"].get("data_dir", "datasets"))
        if w is None or s is None:
            return None, None
        fid_state = build_fid_state(w, s, device)
    tr = cfg["training"]
    fid = compute_fid_from_sampler(
        sampler, generator, fid_state, n_samples=int(tr["n_fid_samples"]),
        batch=int(tr["sampling_batchsize"]), timing=timing)
    return fid, fid_state


class BestFID:
    """The training entries' FID gate (``train_cifar10.py``'s ``run_fid``):
    FID through ``maybe_compute_fid`` (with ``state``, or the state it
    builds, kept across calls), printed with its time split, and
    ``sampler_best``/``value_best`` written with ``fid`` and the call's
    ``meta`` whenever it improves."""

    def __init__(self, cfg: Dict[str, Any], sampler, value, logdir: str,
                 generator: torch.Generator, device: torch.device,
                 state: Optional[FIDState] = None):
        self.cfg, self.sampler, self.value = cfg, sampler, value
        self.logdir, self.generator, self.device = logdir, generator, device
        self.best = float("inf")
        self.state = state

    def __call__(self, **meta: Any) -> Optional[float]:
        timing: Dict[str, Any] = {}
        fid, self.state = maybe_compute_fid(
            self.cfg, self.sampler, self.generator, self.state, self.device,
            timing)
        if fid is None:
            what = ("Inception weights" if _find(
                DEFAULT_WEIGHTS) is None else "dataset statistics")
            print(f"FID skipped: no {what} on disk", flush=True)
            return None
        print(f"FID: {fid}", flush=True)
        print(f"FID time: sample {timing['sample']:.3f} s, inception "
              f"{timing['inception']:.3f} s, frechet {timing['frechet']:.3f} "
              f"s ({timing['route']})", flush=True)
        if fid < self.best:
            self.best = fid
            save_run_checkpoint(self.logdir, "best", self.sampler,
                                self.value, meta={"fid": fid, **meta})
        return fid
