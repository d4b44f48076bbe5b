"""The port's offline evaluator (dxmi_tpu_torch/evaluator.py) against the
JAX evaluator (evaluations/evaluator.py): the Inception Score, the k-NN
manifolds of precision and recall (the torch path on the CPU and the numpy
host path against JAX's host path), the streamed npz read, and the command
end to end on the CPU."""
import os
import subprocess
import sys

import numpy as np
import pytest

from dxmi_tpu_torch import evaluator
from dxmi_tpu_torch.utils.npz_stream import NpzStreamWriter
from evaluations import evaluator as jax_evaluator

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _probs(seed, n, k=1008):
    logits = np.random.RandomState(seed).randn(n, k) * 3
    e = np.exp(logits - logits.max(1, keepdims=True))
    return (e / e.sum(1, keepdims=True)).astype(np.float32)


@pytest.mark.parametrize("n,split", [(50, 5000), (120, 40)])
def test_inception_score_matches_jax(n, split):
    p = _probs(n, n)
    assert evaluator.inception_score(p, split) == \
        jax_evaluator.inception_score(p, split)


def _clusters(seed, n, d=32, shift=0.0):
    rng = np.random.RandomState(seed)
    centers = rng.randn(5, d) * 4
    return (centers[rng.randint(0, 5, n)] + rng.randn(n, d)
            + shift).astype(np.float32)


def test_host_manifolds_match_jax():
    """device=None is JAX's numpy host path: radii and the inside fractions
    equal, in blocks smaller than the sets."""
    a, b = _clusters(0, 130), _clusters(1, 110, shift=0.8)
    ours = evaluator.ManifoldEstimator(3, 50, 40, device=None)
    theirs = jax_evaluator.ManifoldEstimator(3, 50, 40, device=False)
    ra, rb = ours.manifold_radii(a), theirs.manifold_radii(a)
    assert np.array_equal(ra, rb)
    assert ours.evaluate(a, ra, b) == theirs.evaluate(a, rb, b)


def test_torch_manifolds_match_jax_host_path():
    """The torch path (fp32, |a|^2 + |b|^2 - 2ab, topk of the k+1
    smallest) on the CPU against JAX's host path: radii within fp32
    rounding, precision and recall within one sample of JAX's; the host
    path equal to JAX's."""
    a, b = _clusters(2, 300), _clusters(3, 250, shift=0.5)
    ours = evaluator.ManifoldEstimator(3, 64, device="cpu")
    theirs = jax_evaluator.ManifoldEstimator(3, 64, device=False)
    np.testing.assert_allclose(ours.manifold_radii(a),
                               theirs.manifold_radii(a), rtol=1e-4)
    got = evaluator.compute_prec_recall(a, b, device="cpu")
    want = jax_evaluator.compute_prec_recall(a, b, device=False)
    assert got == pytest.approx(want, abs=1.0 / 250)
    assert evaluator.compute_prec_recall(a, b, device=None) == want


def test_npz_batches_match_jax(tmp_path):
    """The streamed read of an npz written by np.savez, by the port's
    NpzStreamWriter, and a compressed one (read whole), as JAX's."""
    imgs = np.random.RandomState(0).randint(0, 256, (23, 4, 5, 3), np.uint8)
    paths = [str(tmp_path / n) for n in ("a.npz", "b.npz", "c.npz")]
    np.savez(paths[0], arr_0=imgs)
    with NpzStreamWriter(paths[1], 23, (4, 5, 3)) as w:
        w.write(imgs[:10])
        w.write(imgs[10:])
    np.savez_compressed(paths[2], arr_0=imgs)
    for path in paths:
        got = list(evaluator.iter_npz_batches(path, 10))
        want = list(jax_evaluator.iter_npz_batches(path, 10))
        assert [len(g) for g in got] == [10, 10, 3]
        for g, w_ in zip(got, want):
            assert np.array_equal(g, w_)


def test_evaluator_cli(tmp_path):
    """python -m dxmi_tpu_torch.evaluator ref.npz sample.npz --device cpu:
    without weights it warns as JAX's and uses the proxy's synthetic
    weights; it prints IS, FID, sFID, precision and recall, finite."""
    rng = np.random.RandomState(1)
    np.savez(tmp_path / "ref.npz",
             arr_0=rng.randint(0, 256, (8, 32, 32, 3), np.uint8))
    np.savez(tmp_path / "sample.npz",
             arr_0=rng.randint(0, 256, (6, 32, 32, 3), np.uint8))
    proc = subprocess.run(
        [sys.executable, "-m", "dxmi_tpu_torch.evaluator", "ref.npz",
         "sample.npz", "--batch", "4", "--device", "cpu"], cwd=tmp_path,
        capture_output=True, text=True, timeout=600,
        env=dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2"))
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = proc.stdout.splitlines()
    assert lines[0].startswith("WARNING: FID Inception weights not found")
    values = {}
    for line in lines:
        name, _, val = line.partition(": ")
        if name in ("Inception Score", "FID", "sFID", "Precision", "Recall"):
            values[name] = float(val)
    assert len(values) == 5 and all(np.isfinite(v) for v in values.values())
