"""The port's msgpack writer (``dxmi_tpu_torch/utils/msgpack.py``
``msgpack_serialize``, ``write``) against ``flax.serialization``: the same
bytes for the same tree, bf16 and flax's chunked arrays included (flax's
chunk size lowered on both sides: an array above the real 1 GiB is too
large for the suite), and the port's reader reads back what it wrote."""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from dxmi_tpu_torch.utils import msgpack as port_msgpack

_RS = np.random.RandomState(1)


def _bf16(a):
    return np.asarray(jnp.asarray(a, jnp.bfloat16))


TREES = {
    "train_state": {
        "leaves": {str(i): _RS.randn(3, 2).astype(np.float32)
                   for i in range(12)},
        "meta": {"i_iter": 250, "epoch": 0, "best_fid": float("inf")}},
    "counters": {"count": np.asarray(3, np.int32),
                 "last_finite": np.asarray(True),
                 "total": np.asarray(0, np.int32)},
    "bf16": {"w": _bf16(_RS.randn(4, 5)), "s": _bf16(1.5)},
    "ints": {"a": 0, "b": 127, "c": 128, "d": 255, "e": 256, "f": 65535,
             "g": 65536, "h": 2 ** 32, "i": -1, "j": -32, "k": -33,
             "l": -128, "m": -129, "n": -32768, "o": -32769,
             "p": -2 ** 31 - 1, "q": 2 ** 64 - 1},
    "scalars": {"f": 0.1, "inf": float("-inf"), "none": None, "t": True,
                "f0": False, "np64": np.float64(2.5), "np32": np.float32(1),
                "i64": np.int64(-7), "c": 1 + 2j},
    "lengths": {"s31": "x" * 31, "s32": "y" * 32, "s300": "z" * 300,
                "s70k": "w" * 70000, "b": b"\x00" * 300,
                "b70k": b"\x01" * 70000, "l15": list(range(15)),
                "l16": list(range(16)), "l70k": [1] * 70000,
                "m16": {f"k{i:02d}": i for i in range(16)}},
    "nested": {"z": {"b": [1, {"y": 2, "x": [3.5]}], "a": np.zeros((0, 3))},
               "a": np.arange(6, dtype=np.int16).reshape(2, 3)},
    "ext_widths": {f"n{n}": np.zeros(n, np.uint8) for n in
                   (0, 1, 2, 3, 5, 9, 200, 300, 70000)},
}


@pytest.mark.parametrize("name", sorted(TREES))
def test_bytes_equal_flax(name):
    tree = TREES[name]
    assert port_msgpack.msgpack_serialize(tree) == \
        serialization.msgpack_serialize(tree)


def test_torch_tensors_write_as_numpy():
    """A torch tensor writes as the numpy array of its values; a bf16
    tensor under the name ``bfloat16``, as JAX's bf16 arrays."""
    w = _RS.randn(3, 4)
    ours = {"f": torch.from_numpy(w.astype(np.float32)),
            "b": torch.from_numpy(w).to(torch.bfloat16),
            "i": torch.tensor(5, dtype=torch.int32)}
    ref = {"f": w.astype(np.float32), "b": _bf16(w),
           "i": np.asarray(5, np.int32)}
    assert port_msgpack.msgpack_serialize(ours) == \
        serialization.msgpack_serialize(ref)


CHUNKED = {
    "nested": lambda: {"a": {"w": _RS.randn(37).astype(np.float32)},
                       "small": np.ones(2, np.float32)},
    "top": lambda: _RS.randn(5, 9).astype(np.float64),
    "bf16": lambda: {"w": _bf16(_RS.randn(21))},
    "in_list": lambda: {"l": [_RS.randn(40).astype(np.float32)]},
}


@pytest.mark.parametrize("name", sorted(CHUNKED))
def test_chunked_bytes_equal_flax(name, monkeypatch):
    """Arrays above the chunk size (here 32 bytes on both sides) are split
    as flax splits them: a dict's values and the top level, not a list's
    items; the reader joins them again."""
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 32)
    monkeypatch.setattr(port_msgpack, "MAX_CHUNK_SIZE", 32)
    tree = CHUNKED[name]()
    blob = serialization.msgpack_serialize(tree)
    assert port_msgpack.msgpack_serialize(tree) == blob
    if name != "in_list":
        assert b"__msgpack_chunked_array__" in blob
    ref = serialization.msgpack_restore(blob)
    got = port_msgpack.msgpack_restore(blob)
    for a, b in zip(jax_leaves(got), jax_leaves(ref)):
        a = a.view(torch.int16).numpy() if isinstance(a, torch.Tensor) \
            else a
        assert np.asarray(a).tobytes() == np.asarray(b).tobytes()


def jax_leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in jax_leaves(tree[k])]
    if isinstance(tree, list):
        return [x for v in tree for x in jax_leaves(v)]
    return [tree]


def test_write_then_read(tmp_path):
    """``write`` goes through ``<path>.tmp`` and leaves the file alone; the
    port's reader and flax's read it back."""
    path = str(tmp_path / "s.msgpack")
    with open(path, "wb") as f:
        f.write(b"old")
    tree = TREES["train_state"]
    port_msgpack.write(path, tree)
    assert sorted(os.listdir(tmp_path)) == ["s.msgpack"]
    back = port_msgpack.read(path)
    assert back["meta"] == tree["meta"]
    for k, v in tree["leaves"].items():
        assert back["leaves"][k].tobytes() == v.tobytes()
    with open(path, "rb") as f:
        assert serialization.msgpack_restore(f.read())["meta"] == \
            tree["meta"]


def test_tuple_raises_as_in_flax():
    with pytest.raises(TypeError):
        serialization.msgpack_serialize({"a": (1, 2)})
    with pytest.raises(TypeError, match="tuple"):
        port_msgpack.msgpack_serialize({"a": (1, 2)})
