"""Build ``fid_golden.npz``: the JAX evaluator's FID Inception outputs
(``evaluations/evaluator.py`` ``build_extractors``: pool3, the sFID spatial
tap and the fc head's softmax) on a few seeded images, under the seed-0
synthetic weights in the published layout
(``tests/_inception_oracle.make_synthetic_state_dict``). The port's
Inception is held to it on the CPU (``tests/test_torch_fid_inception.py``)
and on the card (``chip_smoke.py`` phase F), where there is no JAX.

    python tests/torch_fixtures/make_fid_golden.py   # from the repo root

Stored: ``x32`` (3, 32, 32, 3) and ``x64`` (2, 64, 64, 3) float32 NHWC
images in [0, 1] drawn by ``np.random.RandomState(SEED)``; for each,
``<size>_pool3`` (B, 2048), ``<size>_spatial`` (B, 2023) and
``<size>_probs`` (B, 1008).
"""
from __future__ import annotations

import os
import sys
import tempfile

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "fid_golden.npz")
SEED = 21
SIZES = {"x32": (3, 32), "x64": (2, 64)}


def images() -> dict:
    rng = np.random.RandomState(SEED)
    return {k: rng.rand(b, s, s, 3).astype(np.float32)
            for k, (b, s) in SIZES.items()}


def build() -> dict:
    """The golden arrays, computed with JAX on the CPU."""
    for p in (REPO, os.path.join(REPO, "tests")):
        if p not in sys.path:
            sys.path.insert(0, p)
    from _inception_oracle import make_synthetic_state_dict
    from evaluations.evaluator import build_extractors

    out = images()
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "pt_inception-2015-12-05.npz")
        np.savez(path, **make_synthetic_state_dict(seed=0, numpy=True))
        extract = build_extractors(weights_path=path)
        for key in SIZES:
            for name, val in extract(out[key]).items():
                out[f"{key}_{name}"] = np.asarray(val, np.float32)
    return out


if __name__ == "__main__":
    np.savez(GOLDEN, **build())
    print(f"wrote {GOLDEN}")
