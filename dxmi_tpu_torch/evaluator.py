"""The offline sample evaluator (``evaluations/evaluator.py``): FID, sFID,
Inception Score, precision and recall of an npz of samples against a
reference npz, on the port's FID Inception.

    python -m dxmi_tpu_torch.evaluator ref_batch.npz sample_batch.npz \
        [--weights pt_inception-2015-12-05.pth] [--batch 100] \
        [--device cuda|cpu]

- FID: pool3 (2048-d) Frechet distance;
- sFID: the first 7 channels of the Mixed_6d output flattened in NHWC
  order (2023-d), TF's ``mixed_6/conv`` tap;
- IS: exp(E KL(p(y|x) || p(y))) of the 1008-way ``fc`` head, softmaxed in
  numpy on the host, as the JAX evaluator (only when the weights have it);
- precision and recall: k-NN radius manifolds (k = 3), the pairwise
  distances on the device in fp32 as |a|^2 + |b|^2 - 2ab clamped at 0, in
  row blocks against the whole other set held once on the device
  (``ManifoldEstimator(device=None)`` runs JAX's numpy host path).

An npz holds ``arr_0`` uint8 (N, H, W, 3), read in batches without loading
the whole array; a reference npz may carry ``mu``/``sigma`` (and
``mu_s``/``sigma_s``) instead. Without weights on disk it prints the JAX
evaluator's WARNING and uses the synthetic weights of
``dxmi_tpu_torch.fid.proxy`` (JAX draws random threefry weights, which torch
cannot reproduce); the numbers then compare runs of this evaluator only.
"""
from __future__ import annotations

import argparse
import os
import zipfile
from typing import Callable, Dict, Iterator, Optional

import numpy as np
import torch

from dxmi_tpu_torch.fid import runner as fid_runner
from dxmi_tpu_torch.fid import stats as S
from dxmi_tpu_torch.fid.inception import (build_inception, fold_state,
                                          nchw_on, read_state)
from dxmi_tpu_torch.fid.proxy import make_synthetic_state_dict
from dxmi_tpu_torch.runtime import select_device


def build_extractors(weights_path: Optional[str] = None,
                     device: str = "cuda"
                     ) -> Callable[[np.ndarray], Dict[str, np.ndarray]]:
    """``extract(x01 NHWC numpy) -> {'pool3', 'spatial'[, 'probs']}`` on
    host numpy, the network on ``device``."""
    dev = select_device(device)
    if weights_path and os.path.exists(weights_path):
        raw = read_state(weights_path)
    else:
        print("WARNING: FID Inception weights not found — using random "
              "weights; metrics are NOT comparable to published numbers")
        raw = make_synthetic_state_dict(0)
    model = build_inception(fold_state(raw), dev)
    fc = None
    if "fc.weight" in raw:
        fc = (np.asarray(raw["fc.weight"], np.float32).T,
              np.asarray(raw["fc.bias"], np.float32))

    @torch.no_grad()
    def extract(x01: np.ndarray) -> Dict[str, np.ndarray]:
        out = {k: v.cpu().numpy()
               for k, v in model.taps(nchw_on(x01, dev)).items()}
        if fc is not None:
            logits = out["pool3"] @ fc[0] + fc[1]
            e = np.exp(logits - logits.max(axis=1, keepdims=True))
            out["probs"] = e / e.sum(axis=1, keepdims=True)
        return out

    return extract


def read_npz_images(path: str) -> np.ndarray:
    with np.load(path) as d:
        key = "arr_0" if "arr_0" in d else list(d.keys())[0]
        return d[key]


def iter_npz_batches(path: str, batch: int) -> Iterator[np.ndarray]:
    """The image array of an npz in ``batch``-row chunks, streamed through
    the zip member without materialising it (50k x 256^2 uint8 is ~9.8 GB);
    an exotic layout is read whole instead."""
    from numpy.lib import format as npfmt

    yielded = False
    try:
        with zipfile.ZipFile(path) as z:
            names = z.namelist()
            name = "arr_0.npy" if "arr_0.npy" in names else names[0]
            with z.open(name) as f:
                version = npfmt.read_magic(f)
                if version == (1, 0):
                    shape, fortran, dtype = npfmt.read_array_header_1_0(f)
                elif version == (2, 0):
                    shape, fortran, dtype = npfmt.read_array_header_2_0(f)
                else:
                    raise ValueError(f"npy format version {version}")
                if fortran or dtype.hasobject or len(shape) < 1:
                    raise ValueError("unsupported layout for streaming")
                row = int(np.prod(shape[1:], dtype=np.int64)) * dtype.itemsize
                for i in range(0, shape[0], batch):
                    k = min(batch, shape[0] - i)
                    buf = f.read(k * row)
                    if len(buf) != k * row:
                        raise EOFError("truncated npy member")
                    yield np.frombuffer(buf, dtype=dtype).reshape(
                        (k,) + tuple(shape[1:]))
                    yielded = True
        return
    except (ValueError, EOFError, zipfile.BadZipFile) as e:
        if yielded:
            # rows already went out: a restart would count them twice
            raise
        print(f"  (npz streaming unavailable: {e}; reading whole array)")
    imgs = read_npz_images(path)
    for i in range(0, len(imgs), batch):
        yield imgs[i:i + batch]


def npz_has_stats(path: str) -> bool:
    with np.load(path) as d:
        return "mu" in d


def extract_all(path: str, extract, batch: int = 100
                ) -> Dict[str, np.ndarray]:
    feats = {"pool3": [], "spatial": [], "probs": []}
    for chunk in iter_npz_batches(path, batch):
        out = extract(chunk.astype(np.float32) / 255.0)
        for k in feats:
            if k in out:
                feats[k].append(out[k])
    return {k: np.concatenate(v) for k, v in feats.items() if v}


def inception_score(probs: np.ndarray, split_size: int = 5000) -> float:
    scores = []
    for i in range(0, len(probs), split_size):
        part = probs[i:i + split_size]
        kl = part * (np.log(part + 1e-12)
                     - np.log(part.mean(0, keepdims=True) + 1e-12))
        scores.append(float(np.exp(kl.sum(1).mean())))
    return float(np.mean(scores))


class ManifoldEstimator:
    """k-NN radius manifolds for improved precision and recall (k = 3).

    ``device`` ('cuda' or 'cpu') runs the pairwise-distance passes in torch
    fp32 on that device, ``row_batch`` rows at a time against the whole
    other set, which is moved there once (the TF evaluator's own GPU
    arithmetic, |a|^2 + |b|^2 - 2ab); None runs the JAX evaluator's numpy
    host path in float64 blocks of ``row_batch`` x ``col_batch``."""

    def __init__(self, nhood_size: int = 3, row_batch: int = 10000,
                 col_batch: int = 10000, device: Optional[str] = "cuda"):
        self.k = nhood_size
        self.row_batch = row_batch
        self.col_batch = col_batch
        self.device = device

    def _pairwise_d2(self, a, b):
        return (np.sum(a**2, 1)[:, None] + np.sum(b**2, 1)[None]
                - 2 * a @ b.T).clip(0)

    @staticmethod
    def _d2(rows: torch.Tensor, f: torch.Tensor,
            sq: torch.Tensor) -> torch.Tensor:
        rsq = (rows * rows).sum(1)
        return (rsq[:, None] + sq[None, :] - 2.0 * rows @ f.T).clamp_min(0.0)

    def _on_device(self, feats) -> torch.Tensor:
        return torch.as_tensor(np.asarray(feats, np.float32),
                               device=self.device)

    def manifold_radii(self, feats: np.ndarray) -> np.ndarray:
        if self.device is not None:
            f = self._on_device(feats)
            sq = (f * f).sum(1)
            out = []
            for i in range(0, len(f), self.row_batch):
                d2 = self._d2(f[i:i + self.row_batch], f, sq)
                # the k+1 smallest, ascending; [k] skips the self-distance 0
                out.append(torch.topk(d2, self.k + 1, dim=1,
                                      largest=False).values[:, self.k])
            return torch.cat(out).cpu().numpy().astype(np.float64)

        n = len(feats)
        radii = np.zeros(n, dtype=np.float64)
        for i in range(0, n, self.row_batch):
            rows = feats[i:i + self.row_batch]
            d_row = np.full((len(rows), n), np.inf)
            for j in range(0, n, self.col_batch):
                cols = feats[j:j + self.col_batch]
                d_row[:, j:j + len(cols)] = self._pairwise_d2(rows, cols)
            part = np.partition(d_row, self.k, axis=1)
            radii[i:i + len(rows)] = part[:, self.k]
        return radii

    def evaluate(self, feats_a, radii_a, feats_b) -> float:
        """The fraction of ``feats_b`` inside the manifold of ``feats_a``."""
        if self.device is not None:
            f = self._on_device(feats_a)
            r = torch.as_tensor(np.asarray(radii_a, np.float32),
                                device=self.device)
            sq = (f * f).sum(1)
            b = self._on_device(feats_b)
            inside = torch.cat([
                (self._d2(b[j:j + self.row_batch], f, sq)
                 <= r[None, :]).any(dim=1)
                for j in range(0, len(b), self.row_batch)])
            return float(inside.float().mean())

        inside = np.zeros(len(feats_b), dtype=bool)
        for j in range(0, len(feats_b), self.row_batch):
            rows = feats_b[j:j + self.row_batch]
            for i in range(0, len(feats_a), self.col_batch):
                cols = feats_a[i:i + self.col_batch]
                d2 = self._pairwise_d2(rows, cols)
                inside[j:j + len(rows)] |= (
                    d2 <= radii_a[i:i + len(cols)][None, :]).any(axis=1)
        return float(inside.mean())


def compute_prec_recall(ref_feats, sample_feats, k: int = 3,
                        device: Optional[str] = "cuda"):
    est = ManifoldEstimator(k, device=device)
    radii_ref = est.manifold_radii(ref_feats)
    radii_sample = est.manifold_radii(sample_feats)
    precision = est.evaluate(ref_feats, radii_ref, sample_feats)
    recall = est.evaluate(sample_feats, radii_sample, ref_feats)
    return precision, recall


def evaluate(ref_batch: str, sample_batch: str, extract, batch: int = 100,
             device: str = "cuda") -> Dict[str, object]:
    """The evaluator's metrics as ``main`` prints them, by name: ``IS`` (with
    an fc head), ``FID``, ``sFID`` (with spatial reference statistics),
    ``precision`` and ``recall`` (with a reference of images); and each
    Frechet distance's route and seconds under ``FID_route``,
    ``FID_seconds`` (``sFID_*`` alike)."""
    print("computing sample batch activations...")
    sample = extract_all(sample_batch, extract, batch)
    print("computing/loading reference batch statistics...")
    ref_feats = None
    if npz_has_stats(ref_batch):
        with np.load(ref_batch) as d:
            ref_stats = (d["mu"], d["sigma"])
            ref_spatial = (d["mu_s"], d["sigma_s"]) if "mu_s" in d else None
    else:
        ref_feats = extract_all(ref_batch, extract, batch)
        ref_stats = S.activation_statistics(ref_feats["pool3"])
        ref_spatial = S.activation_statistics(ref_feats["spatial"])
    out: Dict[str, object] = {}
    if "probs" in sample:
        out["IS"] = inception_score(sample["probs"])
        print("Inception Score:", out["IS"])
    info: Dict[str, object] = {}
    out["FID"] = S.frechet_distance(
        *S.activation_statistics(sample["pool3"]), *ref_stats, info=info)
    out["FID_route"], out["FID_seconds"] = info["route"], info["seconds"]
    print("FID:", out["FID"])
    if ref_spatial is not None:
        out["sFID"] = S.frechet_distance(
            *S.activation_statistics(sample["spatial"]), *ref_spatial,
            info=info)
        out["sFID_route"] = info["route"]
        out["sFID_seconds"] = info["seconds"]
        print("sFID:", out["sFID"])
    if ref_feats is not None:
        out["precision"], out["recall"] = compute_prec_recall(
            ref_feats["pool3"], sample["pool3"], device=device)
        print("Precision:", out["precision"])
        print("Recall:", out["recall"])
    return out


def main() -> None:
    p = argparse.ArgumentParser()
    p.add_argument("ref_batch")
    p.add_argument("sample_batch")
    p.add_argument("--weights", default=None,
                   help="pt_inception-2015-12-05 weights (.pth or .npz)")
    p.add_argument("--batch", type=int, default=100)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = p.parse_args()

    weights = args.weights or fid_runner._find(fid_runner.DEFAULT_WEIGHTS)
    extract = build_extractors(weights, args.device)
    evaluate(args.ref_batch, args.sample_batch, extract, args.batch,
             args.device)


if __name__ == "__main__":
    main()
