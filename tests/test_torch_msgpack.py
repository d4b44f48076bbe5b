"""The port's msgpack reader (``dxmi_tpu_torch/utils/msgpack.py``) against
flax's and msgpack's own:

- on ``runs_conv/pre_edm16.msgpack`` and on synthetic trees written by
  ``flax.serialization.msgpack_serialize`` it returns the tree that
  ``flax.serialization.msgpack_restore`` returns, leaf by leaf and bit for
  bit (bf16 arrays as ``torch.bfloat16`` tensors of the same bits);
- on documents that ``msgpack.packb`` writes with every type byte (float32,
  the fixext and ext widths, the 16- and 32-bit str, bin, array and map
  lengths) it returns what ``msgpack.unpackb`` returns;
- it raises on truncated input and on bytes after the document;
- the sampler layouts of the JAX package's ``load_sampler_params`` load to
  the same state dict;
- the port's EDMSampler with ``pre_edm16.msgpack`` loaded by the reader
  follows the JAX sampler's trajectory from the same file
  (``tests/torch_fixtures/edm16_golden.npz``, which rebuilds from JAX).
"""
import os

import jax.numpy as jnp
import msgpack
import numpy as np
import pytest
import torch
from flax import serialization

import chip_smoke
from dxmi_tpu_torch import generate_large
from dxmi_tpu_torch.utils import checkpoint, convert
from dxmi_tpu_torch.utils import msgpack as port_msgpack
from torch_fixtures import make_edm16_golden, rebuild_checks


def _same(ours, ref, path="."):
    """Leaf by leaf, bit for bit: dict keys in order, list lengths, scalar
    types and values, array dtypes, shapes and bytes."""
    if isinstance(ref, dict):
        assert isinstance(ours, dict) and list(ours) == list(ref), path
        for k in ref:
            _same(ours[k], ref[k], f"{path}/{k}")
    elif isinstance(ref, list):
        assert isinstance(ours, list) and len(ours) == len(ref), path
        for i, (a, b) in enumerate(zip(ours, ref)):
            _same(a, b, f"{path}/{i}")
    elif isinstance(ref, (np.ndarray, np.generic)) and ref.dtype == jnp.bfloat16:
        assert isinstance(ours, torch.Tensor), path
        assert ours.dtype == torch.bfloat16 and ours.shape == ref.shape, path
        assert (ours.view(torch.int16).numpy().view(np.uint16).tobytes()
                == np.asarray(ref).view(np.uint16).tobytes()), path
    elif isinstance(ref, np.ndarray):
        assert isinstance(ours, np.ndarray), path
        assert ours.dtype == ref.dtype and ours.shape == ref.shape, path
        assert ours.tobytes() == ref.tobytes(), path
    elif isinstance(ref, np.generic):
        assert type(ours) is type(ref), path
        assert np.asarray(ours).tobytes() == np.asarray(ref).tobytes(), path
    else:
        assert type(ours) is type(ref) and ours == ref, (path, ours, ref)


def test_reader_equals_flax_on_pre_edm16():
    with open(chip_smoke.CONV16_CKPT, "rb") as f:
        blob = f.read()
    _same(port_msgpack.msgpack_restore(blob),
          serialization.msgpack_restore(blob))


_RS = np.random.RandomState(0)
TREES = {
    "fp32": {"w": _RS.randn(3, 4).astype(np.float32)},
    "fp64": {"w": _RS.randn(5).astype(np.float64)},
    "bf16": {"w": jnp.asarray(_RS.randn(2, 3), jnp.bfloat16),
             "s": np.asarray(jnp.asarray(1.5, jnp.bfloat16))},
    "int8": {"w": _RS.randint(-128, 128, (4, 4)).astype(np.int8)},
    "uint8": {"w": _RS.randint(0, 256, (7,)).astype(np.uint8)},
    "int32": {"w": _RS.randint(-2**31, 2**31 - 1, (3,)).astype(np.int32)},
    "int64": {"w": np.array([-2**62, 2**62, 7], np.int64)},
    "bool": {"w": np.array([[True, False], [False, True]])},
    "zero_d_and_scalars": {"a": np.array(3.25, np.float32),
                           "b": np.float32(-1.5), "c": np.int64(-9),
                           "d": np.bool_(True), "e": np.float64(2.0),
                           "f": np.uint8(200)},
    "ints": {"pos": [0, 127, 128, 255, 256, 65535, 65536, 2**32 - 1,
                     2**32, 2**64 - 1],
             "neg": [-1, -32, -33, -128, -129, -32768, -32769, -2**31,
                     -2**31 - 1, -2**63]},
    "float_meta": {"meta": {"fid": 3.14159, "lr": 1e-6, "neg": -0.0,
                            "inf": float("inf")}},
    "str": {"short": "abc", "str8": "x" * 40, "str16": "y" * 300,
            "str32": "z" * 70000, "utf8": "σ_max ünïcode"},
    "none_and_bytes": {"none": None, "bin": b"\x00\x01" * 200,
                       "complex": 1.5 - 2j},
    "empty_dicts": {"a": {}, "b": {"c": {}}},
    "nested_lists": {"l": [[1, [2.5, "s", None]], [], [[[]]],
                           list(range(20))],
                     "arrs": [np.zeros(2, np.float32), [np.ones((1, 1))]]},
    "many_keys": {f"k{i}": i for i in range(20)},
}


@pytest.mark.parametrize("case", sorted(TREES))
def test_reader_equals_flax_on_synthetic_trees(case):
    blob = serialization.msgpack_serialize(TREES[case])
    _same(port_msgpack.msgpack_restore(blob),
          serialization.msgpack_restore(blob))


def test_reader_reassembles_chunked_leaves():
    """A flax chunked leaf (arrays above 2^30 bytes are written so; here a
    small one chunked by flax's own helper) comes back whole, as flax
    returns it, at the top and inside a dict."""
    arr = np.arange(12, dtype=np.float32).reshape(3, 4)
    tree = {"a": serialization._chunk(arr), "b": {"c": serialization._chunk(
        arr[0])}}
    blob = serialization.msgpack_serialize(tree)
    ours = port_msgpack.msgpack_restore(blob)
    _same(ours, serialization.msgpack_restore(blob))
    assert np.array_equal(ours["a"], arr)
    top = serialization.msgpack_serialize(serialization._chunk(arr))
    assert np.array_equal(port_msgpack.msgpack_restore(top), arr)


PLAIN = {
    "float32": msgpack.packb([1.5, -2.25, 3e38], use_single_float=True),
    "fixext_and_ext": msgpack.packb(
        [msgpack.ExtType(5, b"a" * n) for n in (1, 2, 4, 8, 16, 3, 300,
                                                70000)]),
    "array16_map16": msgpack.packb({str(i): list(range(i)) for i in
                                    range(18)}),
    "array32_map32": msgpack.packb({"a": list(range(70000)),
                                    "m": {str(i): i for i in range(70000)}}),
    "bin_widths": msgpack.packb([b"x" * n for n in (3, 300, 70000)],
                                use_bin_type=True),
    "bool_nil": msgpack.packb([True, False, None]),
}


@pytest.mark.parametrize("case", sorted(PLAIN))
def test_reader_equals_msgpack_on_every_type(case):
    blob = PLAIN[case]
    ref = msgpack.unpackb(blob, raw=False, strict_map_key=False)
    ours = port_msgpack.unpackb(blob)
    if case == "fixext_and_ext":
        ref = [port_msgpack.ExtType(e.code, e.data) for e in ref]
    assert ours == ref


def test_reader_raises_on_truncated_input():
    blob = serialization.msgpack_serialize(
        {"w": np.arange(6, dtype=np.float32), "meta": {"s": "abc", "i": 300}})
    for cut in (1, 2, 5, len(blob) // 2, len(blob) - 1):
        with pytest.raises(ValueError, match="truncated"):
            port_msgpack.msgpack_restore(blob[:cut])
    with pytest.raises(ValueError, match="after the document"):
        port_msgpack.msgpack_restore(blob + b"\xc0")


def test_sampler_layouts_load_alike(tmp_path):
    """The three layouts of ``load_sampler_params``: a run-dir payload, a
    bare sampler tree and a bare net tree (no log_betas) give one state."""
    payload = checkpoint.load_flax_checkpoint(chip_smoke.CONV16_CKPT)
    params = payload["params"]
    want = convert.edm_sampler_from_flax(params)
    for name, tree in (("payload", payload), ("sampler", params),
                       ("net", params["net"])):
        path = tmp_path / f"{name}.msgpack"
        path.write_bytes(serialization.msgpack_serialize(tree))
        got = checkpoint.load_sampler_state(str(path), net="unet_adm")
        expect = {k: v for k, v in want.items()
                  if name != "net" or k != "log_betas"}
        assert sorted(got) == sorted(expect), name
        for k, v in expect.items():
            assert torch.equal(got[k], v), (name, k)


@pytest.mark.parametrize("net", [None, "unet_conv"])
def test_msgpack_sampler_load_needs_its_net(net):
    """A flax file names no net: without a known ``net`` the load fails
    at the call, before any converter runs."""
    with pytest.raises(ValueError, match="needs net="):
        checkpoint.load_sampler_state(chip_smoke.CONV16_CKPT, net=net)


@pytest.fixture(scope="module")
def edm16_golden():
    return chip_smoke.edm16_golden()


def test_edm16_golden_rebuilds_from_jax(edm16_golden):
    committed = dict(np.load(chip_smoke.EDM16_GOLDEN))
    shares = rebuild_checks.fp32_rebuild_shares(make_edm16_golden.build(),
                                                committed)
    assert max(shares.values()) <= 1, shares


@pytest.mark.parametrize("attn_impl", ["einsum", "fused"])
def test_port_sampler_from_msgpack_follows_jax(edm16_golden, attn_impl):
    """The port's EDMSampler, pre_edm16.msgpack loaded by its reader, on the
    JAX sampler's injected trajectory from the same file: each step within
    G5's limits (the fp32 ADM goldens'), and on the CPU its step means
    within 1e-4 (1.1e-5 at worst measured; states reach |x| ~ 200)."""
    state = checkpoint.load_sampler_state(chip_smoke.CONV16_CKPT,
                                          net="unet_adm")
    sampler = generate_large.load_sampler(
        chip_smoke.conv16_config(), state, "cpu", attn_impl=attn_impl,
        up_impl="resize", gn_stats="fp32")
    worst, _ = chip_smoke.adm_golden_replay(sampler, edm16_golden, "cpu",
                                            attn_impl)
    assert worst < 1e-4, worst


def test_replay_refuses_another_checkpoint(edm16_golden):
    """G5 sees a wrong load: the ADM fixture's weights (the same net) in
    place of pre_edm16's fail the replay."""
    state = checkpoint.load_sampler_state(os.path.join(
        chip_smoke.ADM_FIXTURE_DIR, "sampler.pth"))
    sampler = generate_large.load_sampler(
        chip_smoke.conv16_config(), state, "cpu", attn_impl="einsum",
        up_impl="resize", gn_stats="fp32")
    with pytest.raises(AssertionError, match="mean err"):
        chip_smoke.adm_golden_replay(sampler, edm16_golden, "cpu", "wrong")
