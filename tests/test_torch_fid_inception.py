"""The port's FID Inception-v3 (dxmi_tpu_torch/fid/inception.py) against the
JAX package's: the BatchNorm fold bit for bit (.pth and .npz), the proxy's
synthetic weights bit for bit against the test oracle's, the flax tree
converter, the resize against jax.image.resize, and the network's pool3,
sFID tap and IS probabilities against the JAX evaluator's golden
(tests/torch_fixtures/fid_golden.npz) at JAX's own cross-framework limit,
1e-3 of the feature scale + 1e-4 (tests/test_inception_load.py)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from _inception_oracle import make_synthetic_state_dict
from dxmi_tpu.fid import inception as jax_inception
from dxmi_tpu_torch.evaluator import build_extractors
from dxmi_tpu_torch.fid import proxy
from dxmi_tpu_torch.fid.inception import (InceptionV3FID,
                                          load_fid_inception_params)
from dxmi_tpu_torch.utils.convert import inception_from_flax
from torch_fixtures import make_fid_golden

GOLDEN = make_fid_golden.GOLDEN
REL, ABS = 1e-3, 1e-4


@pytest.fixture(scope="module")
def weight_files(tmp_path_factory):
    """Synthetic pt-layout weights (seed 7) as a torch .pth state dict and
    an .npz re-pack."""
    d = tmp_path_factory.mktemp("fidw")
    pth = str(d / "pt_inception-2015-12-05.pth")
    torch.save(make_synthetic_state_dict(seed=7), pth)
    npz = str(d / "pt_inception-2015-12-05.npz")
    np.savez(npz, **make_synthetic_state_dict(seed=7, numpy=True))
    return {"pth": pth, "npz": npz}


def _jax_as_port(tree):
    """JAX's folded tree in the port's keys and layouts, without a cast."""
    out = {}
    for path, leaf in jax.tree_util.tree_leaves_with_path(tree):
        keys = [p.key for p in path]
        assert keys[-2] == "Conv_0"
        leaf = np.asarray(leaf)
        if keys[-1] == "kernel":
            out[".".join(keys[:-2]) + ".conv.weight"] = leaf.transpose(
                3, 2, 0, 1)
        else:
            out[".".join(keys[:-2]) + ".conv.bias"] = leaf
    return out


@pytest.mark.parametrize("fmt", ["pth", "npz"])
def test_folded_weights_bit_equal_to_jax(weight_files, fmt):
    """load_fid_inception_params folds each BatchNorm in numpy float32 with
    JAX's formula: every folded weight and bias equals JAX's bit for bit;
    the fc head is kept as the file has it."""
    path = weight_files[fmt]
    want = _jax_as_port(jax_inception.load_fid_inception_params(path))
    got = load_fid_inception_params(path)
    assert sorted(got) == sorted([*want, "fc.weight", "fc.bias"])
    for key, val in want.items():
        assert got[key].dtype == torch.float32
        assert np.array_equal(got[key].numpy(), val), key
    raw = make_synthetic_state_dict(seed=7, numpy=True)
    assert np.array_equal(got["fc.weight"].numpy(),
                          raw["fc.weight"].astype(np.float32))
    model = InceptionV3FID()
    model.load_state_dict(got, strict=True)


def test_inception_from_flax(weight_files):
    """inception_from_flax carries JAX's folded tree into the port's state
    dict: the port's own fold, bit for bit, loadable without the fc head."""
    tree = jax_inception.load_fid_inception_params(weight_files["npz"])
    got = inception_from_flax({"params": tree})
    want = load_fid_inception_params(weight_files["npz"])
    assert sorted(got) == sorted(k for k in want if not k.startswith("fc."))
    for key, val in got.items():
        assert torch.equal(val, want[key]), key
    InceptionV3FID(fc=False).load_state_dict(got, strict=True)
    with pytest.raises(ValueError):
        inception_from_flax({"Mixed_5b": {"branch1x1": {"Dense_0": {
            "kernel": np.zeros((2, 2))}}}})


def test_proxy_weights_bit_equal_to_oracle():
    """fid/proxy.py's own copy of the synthetic draw is the test oracle's,
    key for key, dtype and bits (seed 0, as make_fid_proxy.py writes)."""
    want = make_synthetic_state_dict(seed=0, numpy=True)
    got = proxy.make_synthetic_state_dict(0)
    assert list(got) == list(want)
    for key in want:
        assert got[key].dtype == want[key].dtype, key
        assert np.array_equal(got[key], want[key]), key


@pytest.mark.parametrize("size", [32, 64, 256])
def test_resize_matches_jax(size):
    """The half-pixel bilinear resize to 299 equals jax.image.resize at
    every input size the repo feeds it (all of them upsample)."""
    x = np.random.RandomState(size).rand(2, size, size, 3).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(x), (2, 299, 299, 3),
                                       method="bilinear"))
    got = F.interpolate(torch.from_numpy(x.transpose(0, 3, 1, 2)),
                        size=(299, 299), mode="bilinear",
                        align_corners=False).numpy().transpose(0, 2, 3, 1)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_golden_inputs_are_the_makers():
    gold = np.load(GOLDEN)
    for key, val in make_fid_golden.images().items():
        assert np.array_equal(gold[key], val), key


@pytest.fixture(scope="module")
def extract():
    """The evaluator's extractor without a weights file: the proxy's seed-0
    synthetic weights, those of the golden."""
    return build_extractors(None, device="cpu")


@pytest.mark.parametrize("key", ["x32", "x64"])
def test_inception_matches_jax_golden(key, extract):
    """pool3, the sFID tap (Mixed_6d's first 7 channels, NHWC order) and
    the fc head's softmax of the seed-0 synthetic weights against the JAX
    evaluator's on the same images."""
    gold = np.load(GOLDEN)
    out = extract(gold[key])
    for name, width in (("pool3", 2048), ("spatial", 7 * 17 * 17),
                        ("probs", 1008)):
        ref = gold[f"{key}_{name}"]
        assert out[name].shape == ref.shape == (len(gold[key]), width)
        err = np.abs(out[name] - ref).max()
        assert err < REL * np.abs(ref).mean() + ABS, (name, err)


def test_input_larger_than_299_raises():
    """jax.image.resize antialiases when it downsamples; the port refuses
    rather than compute another network."""
    model = InceptionV3FID(fc=False)
    with pytest.raises(ValueError, match="larger than 299"):
        model(torch.zeros(1, 3, 300, 32))
