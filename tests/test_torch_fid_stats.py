"""The port's FID statistics and Frechet distance
(dxmi_tpu_torch/fid/stats.py), the statistics files and the sampler loop of
fid/runner.py, against the JAX package's on the same inputs."""
import numpy as np
import pytest
import torch
from torch import nn

from dxmi_tpu.fid import runner as jax_runner
from dxmi_tpu.fid import stats as jax_stats
from dxmi_tpu_torch.fid import runner, stats
from dxmi_tpu_torch.fid.runner import FIDState


def _features(seed, n, d, scale=1.0, shift=0.0):
    return np.random.RandomState(seed).randn(n, d) * scale + shift


def test_statistics_match_jax():
    acts = _features(0, 200, 16).astype(np.float32)
    for got, want in zip(stats.activation_statistics(acts),
                         jax_stats.activation_statistics(acts)):
        assert got.dtype == np.float64 and np.array_equal(got, want)
    x = _features(1, 300, 8)
    s1, s2 = x.sum(0), x.T @ x
    for got, want in zip(stats.stats_from_moments(300, s1, s2),
                         jax_stats.stats_from_moments(300, s1, s2)):
        assert np.array_equal(got, want)


@pytest.mark.parametrize("method", ["auto", "cholesky", "scipy"])
@pytest.mark.parametrize("case", ["definite", "singular"])
def test_frechet_matches_jax(method, case):
    """Every route on a positive definite and a singular (n < d) sigma1,
    against JAX's on the same statistics; cholesky raises on the singular
    one in both; ``info`` names the route that gave the value."""
    n1, d = (600, 48) if case == "definite" else (10, 24)
    m1, s1 = stats.activation_statistics(_features(7, n1, d))
    m2, s2 = stats.activation_statistics(_features(8, 400, d, 1.3, 0.2))
    if case == "singular" and method == "cholesky":
        for fn in (stats.frechet_distance, jax_stats.frechet_distance):
            with pytest.raises(np.linalg.LinAlgError):
                fn(m1, s1, m2, s2, method=method)
        return
    info = {}
    got = stats.frechet_distance(m1, s1, m2, s2, method=method, info=info)
    want = jax_stats.frechet_distance(m1, s1, m2, s2, method=method)
    assert got == pytest.approx(want, rel=1e-12)
    route = "cholesky" if (method != "scipy" and case == "definite") \
        else "scipy"
    assert info["route"] == route and info["seconds"] > 0


def test_fid_of_pool3_sized_features_matches_jax():
    """FID from identical (n, 2048) features through the port and JAX,
    statistics included: within 1e-6 relative (cholesky, n > 2048)."""
    a = np.maximum(_features(3, 2100, 2048), 0).astype(np.float32)
    b = np.maximum(_features(4, 2100, 2048, 1.1, 0.05), 0).astype(np.float32)
    got = stats.frechet_distance(*stats.activation_statistics(a),
                                 *stats.activation_statistics(b))
    want = jax_stats.frechet_distance(*jax_stats.activation_statistics(a),
                                      *jax_stats.activation_statistics(b))
    assert got == pytest.approx(want, rel=1e-6)
    assert stats.frechet_distance(*stats.activation_statistics(a),
                                  *stats.activation_statistics(a)) == \
        pytest.approx(0.0, abs=1e-6)


def test_unknown_method_raises():
    m, s = stats.activation_statistics(_features(5, 50, 4))
    with pytest.raises(ValueError, match="unknown method"):
        stats.frechet_distance(m, s, m, s, method="newton")


def test_newton_schulz_matches_jax_and_scipy():
    from scipy import linalg

    a = np.random.RandomState(2).randn(16, 16)
    spd = a @ a.T + 16 * np.eye(16)
    want = np.asarray(jax_stats.sqrtm_newton_schulz(spd.astype(np.float32),
                                                    iters=30))
    got = stats.sqrtm_newton_schulz(torch.from_numpy(spd).float(), iters=30)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    got64 = stats.sqrtm_newton_schulz(torch.from_numpy(spd), iters=30)
    np.testing.assert_allclose(got64.numpy(), linalg.sqrtm(spd).real,
                               rtol=1e-10)


def test_load_dataset_stats(tmp_path):
    """.npz with mu/sigma or m2/s2, and the reference's .pt (numpy arrays
    or tensors) read as JAX's reader reads them; .pt through
    ``weights_only``."""
    mu, sigma = np.arange(3.0), np.eye(3) * 2
    paths = {"a.npz": dict(mu=mu, sigma=sigma), "b.npz": dict(m2=mu, s2=sigma)}
    for name, arrays in paths.items():
        np.savez(tmp_path / name, **arrays)
    torch.save({"m2": mu, "s2": sigma}, tmp_path / "c.pt")
    torch.save({"m2": torch.from_numpy(mu), "s2": torch.from_numpy(sigma)},
               tmp_path / "d.pt")
    for name in ("a.npz", "b.npz", "c.pt", "d.pt"):
        got = runner.load_dataset_stats(str(tmp_path / name))
        want = jax_runner.load_dataset_stats(str(tmp_path / name))
        for g, w in zip(got, want):
            assert np.array_equal(g, w), name
    with pytest.raises(ValueError, match="unknown stats format"):
        runner.load_dataset_stats(str(tmp_path / "e.msgpack"))


class _Sampler(nn.Module):
    """Samples of a fixed per-call pattern drawn from the generator, and a
    count of the trajectories asked for."""

    sample_shape = (3, 4, 4)

    def __init__(self):
        super().__init__()
        self.calls = []

    def sample(self, n, generator=None):
        self.calls.append(n)
        return {"sample": torch.randn((n, *self.sample_shape),
                                      generator=generator) * 1.5}


class _Features(nn.Module):
    """A stand-in extractor: 8 linear features of the image."""

    def __init__(self):
        super().__init__()
        self.lin = nn.Linear(48, 8)

    def forward(self, x):
        return self.lin(x.flatten(1))


@pytest.mark.parametrize("n_samples,trajectories", [(250, 8), (900, 16)])
def test_compute_fid_from_sampler_counts(n_samples, trajectories):
    """Whole chunks of 8 trajectories of ``batch`` until ceil(n / batch)
    batches are drawn (JAX's count), the first n samples kept, clip((x + 1)
    / 2), one sampler batch per extractor call; the FID is that of those
    samples."""
    torch.manual_seed(0)
    feats = _Features()
    m2, s2 = stats.activation_statistics(_features(9, 500, 8))
    state = FIDState(feats, m2, s2)
    sampler = _Sampler()
    timing = {}
    got = runner.compute_fid_from_sampler(
        sampler, torch.Generator().manual_seed(3), state, n_samples, 100,
        timing=timing)
    assert sampler.calls == [100] * trajectories
    gen = torch.Generator().manual_seed(3)
    xs = torch.cat([torch.randn((100, 3, 4, 4), generator=gen) * 1.5
                    for _ in range(trajectories)])
    with torch.no_grad():
        acts = feats(((xs + 1) / 2).clamp(0, 1)).numpy()[:n_samples]
    want = stats.frechet_distance(*stats.activation_statistics(acts), m2, s2)
    assert got == pytest.approx(want, rel=1e-6)
    assert set(timing) == {"sample", "inception", "frechet", "route"}


def test_maybe_compute_fid_skips_without_files(tmp_path, monkeypatch):
    """Without weights or statistics under the working directory FID is
    skipped (None, None), as JAX's hook does; with CIFAR-10 weights but no
    statistics and no raw batches, too."""
    monkeypatch.chdir(tmp_path)
    cfg = {"data": {"name": "cifar10", "data_dir": str(tmp_path)},
           "training": {"n_fid_samples": 8, "sampling_batchsize": 4}}
    assert runner.maybe_compute_fid(cfg, None, None, None,
                                    torch.device("cpu")) == (None, None)
    (tmp_path / "datasets").mkdir()
    (tmp_path / "datasets" / "pt_inception-2015-12-05.npz").write_bytes(b"")
    assert runner.maybe_compute_fid(cfg, None, None, None,
                                    torch.device("cpu")) == (None, None)


def test_build_cifar_train_stats(tmp_path):
    """The CIFAR-10 statistics built from the raw python batches (the
    reference builds them at the first FID call): the statistics of the
    batches' pool3 activations, readable as dataset statistics; without the
    batches, None."""
    import pickle

    from dxmi_tpu_torch.data.cifar10 import CIFAR10
    from dxmi_tpu_torch.fid.inception import (build_inception,
                                              load_fid_inception_params)
    from dxmi_tpu_torch.fid.proxy import pool3_of, write_weights

    base = tmp_path / "cifar-10-batches-py"
    base.mkdir()
    rng = np.random.RandomState(0)
    for i in range(1, 6):
        with open(base / f"data_batch_{i}", "wb") as f:
            pickle.dump({b"data": rng.randint(0, 256, (2, 3072), np.uint8),
                         b"labels": list(rng.randint(0, 10, 2))}, f)
    wpath = write_weights(str(tmp_path))
    out = runner.build_cifar_train_stats(
        wpath, torch.device("cpu"), data_dir=str(tmp_path),
        out_path=str(tmp_path / "stats.npz"), batch=4)
    model = build_inception(load_fid_inception_params(wpath),
                            torch.device("cpu"))
    want = stats.activation_statistics(
        pool3_of(model, CIFAR10(str(tmp_path)).images, 4))
    for got, w in zip(runner.load_dataset_stats(out), want):
        assert np.array_equal(got, w)
    assert runner.build_cifar_train_stats(
        wpath, torch.device("cpu"), data_dir=str(tmp_path / "none")) is None
