"""The port's streaming npz writer (dxmi_tpu_torch.utils.npz_stream) loads
equal to np.savez, writes the same bytes as dxmi_tpu's NpzStreamWriter for
the same batches, adds the label member, and refuses a wrong row count."""
import time
import zipfile

import numpy as np
import pytest

from dxmi_tpu.utils.npz_stream import NpzStreamWriter as JaxWriter
from dxmi_tpu_torch.utils.npz_stream import NpzStreamWriter


def _batches(n=3, b=4, shape=(8, 8, 3)):
    rs = np.random.RandomState(0)
    return [rs.randint(0, 256, size=(b, *shape)).astype(np.uint8)
            for _ in range(n)]


def test_loads_equal_to_savez(tmp_path):
    batches = _batches()
    labels = np.arange(12, dtype=np.int64) % 5
    with NpzStreamWriter(str(tmp_path / "s.npz"), 12, (8, 8, 3)) as w:
        for b in batches:
            w.write(b)
        w.add("arr_1", labels)
    np.savez(tmp_path / "ref.npz", np.concatenate(batches), labels)
    got, ref = np.load(tmp_path / "s.npz"), np.load(tmp_path / "ref.npz")
    assert sorted(got.files) == sorted(ref.files) == ["arr_0", "arr_1"]
    for k in ref.files:
        assert got[k].dtype == ref[k].dtype
        np.testing.assert_array_equal(got[k], ref[k])


def test_bytes_match_the_jax_writer(tmp_path, monkeypatch):
    """Same batches, same clock (zipfile stamps each member with the
    time): the two writers' files are byte for byte equal."""
    monkeypatch.setattr(time, "time", lambda: 1_700_000_000.0)
    paths = []
    for cls in (JaxWriter, NpzStreamWriter):
        path = str(tmp_path / f"{cls.__module__}.npz")
        w = cls(path, n_total=12, shape_tail=(8, 8, 3))
        for b in _batches():
            w.write(b)
        w.close()
        paths.append(path)
    with open(paths[0], "rb") as a, open(paths[1], "rb") as b:
        assert a.read() == b.read()


@pytest.mark.parametrize("n_batches", [2, 4])
def test_wrong_row_count_raises(tmp_path, n_batches):
    w = NpzStreamWriter(str(tmp_path / "s.npz"), 12, (8, 8, 3))
    with pytest.raises(ValueError, match="12"):
        for b in _batches(n_batches):
            w.write(b)
        w.close()


def test_wrong_row_shape_raises(tmp_path):
    with NpzStreamWriter(str(tmp_path / "s.npz"), 4, (8, 8, 3)) as w:
        with pytest.raises(ValueError, match="rows of"):
            w.write(np.zeros((4, 8, 8, 4), np.uint8))
        w.write(np.zeros((4, 8, 8, 3), np.uint8))


def test_error_inside_the_block_is_the_one_raised(tmp_path):
    path = tmp_path / "s.npz"
    with pytest.raises(RuntimeError, match="sampling failed"):
        with NpzStreamWriter(str(path), 12, (8, 8, 3)) as w:
            w.write(_batches(1)[0])
            raise RuntimeError("sampling failed")
    assert zipfile.is_zipfile(path)
