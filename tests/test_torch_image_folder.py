"""The port's PNG image-folder loader against ``dxmi_tpu.data.image_folder``
(PIL) on files the test writes: batches bit-equal for RGB, grayscale and
RGBA PNGs at sizes that need 0 to 3 BOX halvings, center and random crops,
flips, ``num_workers`` 0 and 2, class labels, process sharding and JAX's
``cachefile``; Pillow's resize itself on random images; the refusal of
other formats; ``train_image_large`` trained from a folder."""
import os
import pickle
import subprocess

import numpy as np
import pytest
from PIL import Image

import chip_smoke
from dxmi_tpu.data import image_folder as jax_loader
from dxmi_tpu_torch.data import image_folder as port

# (name, mode, width, height): 0, 1, 2 and 3 halvings at image_size 16
FILES = [("a_0.png", "RGB", 20, 16), ("b_1.png", "L", 40, 33),
         ("a_2.png", "RGBA", 70, 80), ("sub/b_3.png", "RGB", 150, 140),
         ("sub/c_4.png", "RGBA", 33, 47), ("c_5.png", "L", 64, 64),
         ("sub/deeper/a_6.png", "RGB", 17, 90), ("b_7.png", "RGB", 129, 64)]


@pytest.fixture(scope="module")
def folder(tmp_path_factory):
    root = tmp_path_factory.mktemp("imgs")
    rs = np.random.RandomState(0)
    for name, mode, w, h in FILES:
        path = root / name
        path.parent.mkdir(parents=True, exist_ok=True)
        c = {"L": 1, "RGB": 3, "RGBA": 4}[mode]
        yy, xx = np.mgrid[0:h, 0:w]
        a = (rs.randint(0, 256, (h, w, c)) // 2 + 64 * np.sin(
            xx[..., None] / 5.0 + yy[..., None] / 7.0) + 64)
        a = np.clip(a, 0, 255).astype(np.uint8)
        if mode == "RGBA":
            a[..., 3] = rs.choice([0, 1, 100, 255], (h, w))
        Image.fromarray(a[..., 0] if c == 1 else a, mode).save(path)
    (root / "notes.txt").write_text("not an image")
    return str(root)


def _batches(mod, folder, n, **kw):
    it = mod.load_data(folder, batch_size=3, image_size=16, **kw)
    out = [next(it) for _ in range(n)]
    it.close()
    return out


@pytest.mark.parametrize("kw", [
    {}, {"random_crop": True}, {"class_cond": True, "random_flip": False},
    {"num_workers": 2, "random_crop": True, "class_cond": True},
    {"deterministic": True, "num_workers": 2},
    {"process_index": 1, "process_count": 2, "seed": 4},
    {"process_index": 1, "process_count": 2, "num_workers": 2,
     "random_crop": True}])
def test_batches_bit_equal(folder, kw):
    """Five batches of three (across epoch boundaries) equal to JAX's, bit
    for bit, with their labels."""
    ours = _batches(port, folder, 5, **kw)
    ref = _batches(jax_loader, folder, 5, **kw)
    for (x, e), (xr, er) in zip(ours, ref):
        assert x.dtype == xr.dtype == np.float32 and x.shape == (3, 16, 16,
                                                                3)
        np.testing.assert_array_equal(x, xr)
        assert sorted(e) == sorted(er)
        if "y" in er:
            np.testing.assert_array_equal(e["y"], er["y"])


def test_cachefile_both_ways(folder, tmp_path):
    """A cachefile written by JAX's loader feeds the port's (and the other
    way); its ``{'files', 'classes'}`` layout and the batches equal."""
    jc, pc = str(tmp_path / "jax.pkl"), str(tmp_path / "port.pkl")
    ref = _batches(jax_loader, folder, 2, class_cond=True, cachefile=jc)
    ours = _batches(port, folder, 2, class_cond=True, cachefile=jc)
    _batches(port, folder, 1, class_cond=True, cachefile=pc)
    a, b = (pickle.load(open(p, "rb")) for p in (jc, pc))
    assert a["files"] == b["files"] and len(a["files"]) == len(FILES)
    np.testing.assert_array_equal(a["classes"], b["classes"])
    again = _batches(jax_loader, folder, 2, class_cond=True, cachefile=pc)
    for (x, e), (xr, er), (x2, _) in zip(ours, ref, again):
        np.testing.assert_array_equal(x, xr)
        np.testing.assert_array_equal(x2, xr)
        np.testing.assert_array_equal(e["y"], er["y"])


@pytest.mark.parametrize("mode", ["L", "RGB", "RGBA"])
def test_pil_resize_bit_equal(mode):
    """``pil_resize`` against Pillow's ``Image.resize`` (BOX and BICUBIC,
    up and down, one axis or both) on random images."""
    rs = np.random.RandomState({"L": 1, "RGB": 2, "RGBA": 3}[mode])
    c = {"L": 1, "RGB": 3, "RGBA": 4}[mode]
    for _ in range(40):
        h, w = rs.randint(2, 70, 2)
        a = rs.randint(0, 256, (h, w, c)).astype(np.uint8)
        im = Image.fromarray(a[..., 0] if c == 1 else a, mode)
        size = (int(rs.choice([w, rs.randint(1, 90)])),
                int(rs.randint(1, 90)))
        for kind, res in (("box", Image.BOX), ("bicubic", Image.BICUBIC)):
            ref = np.array(im.resize(size, resample=res))
            ref = ref[..., None] if ref.ndim == 2 else ref
            np.testing.assert_array_equal(port.pil_resize(a, size, kind),
                                          ref, err_msg=f"{a.shape} {size}")


def test_other_formats_raise(tmp_path):
    """A JPEG (which JAX's loader decodes through PIL) or a palette PNG
    raises, naming the file."""
    rs = np.random.RandomState(5)
    a = rs.randint(0, 256, (20, 20, 3)).astype(np.uint8)
    Image.fromarray(a).save(tmp_path / "a_0.jpg")
    it = port.load_data(str(tmp_path), batch_size=1, image_size=16)
    with pytest.raises(ValueError, match="a_0.jpg"):
        next(it)
    os.remove(tmp_path / "a_0.jpg")
    Image.fromarray(a).convert("P").save(tmp_path / "p_0.png")
    it = port.load_data(str(tmp_path), batch_size=1, image_size=16,
                        num_workers=2)
    with pytest.raises(ValueError, match="p_0.png"):
        next(it)


@pytest.mark.parametrize("workers", ["0", "2"])
def test_train_image_large_from_a_folder(tmp_path, workers):
    """``train_image_large`` without --fake_data trains from a PNG folder of
    class-prefixed images (the config's data_dir, image_size, cachefile
    overridden), decoding in the loop or on two threads."""
    folder = tmp_path / "png"
    folder.mkdir()
    rs = np.random.RandomState(6)
    for i in range(16):
        Image.fromarray(rs.randint(0, 256, (32, 40, 3)).astype(np.uint8)
                        ).save(folder / f"n0{i % 4}_{i:02d}.png")
    train, _, log_dir = chip_smoke.train_cli_commands("folder", device="cpu")
    train = [a for a in train if a != "--fake_data"]
    train += ["--data.data_dir", str(folder), "--data.image_size", "16",
              "--data.cachefile", str(tmp_path / "cache.pkl"),
              "--data_workers", workers]
    proc = subprocess.run(train, cwd=tmp_path, capture_output=True,
                          text=True, timeout=600,
                          env=dict(os.environ, PYTHONPATH=chip_smoke.REPO,
                                   OMP_NUM_THREADS="2"))
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "iter 1 d_loss=" in proc.stdout
    assert (tmp_path / log_dir / "sampler_last.pth").exists()
    files = pickle.load(open(tmp_path / "cache.pkl", "rb"))
    assert len(files["files"]) == 16 and sorted(set(files["classes"])) == [
        0, 1, 2, 3]
