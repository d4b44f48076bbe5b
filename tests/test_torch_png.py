"""The port's PNG reader and writer (dxmi_tpu_torch/utils/png.py), its image
directories (fid/image_dir.py) and make_npz: exact round trips, PIL's own
decoding of the port's files, PIL's files read back, every row filter, the
refusals, and the JAX package's directory listing and npz packing."""
import os
import struct
import sys
import zlib

import numpy as np
import pytest
from PIL import Image

from dxmi_tpu.fid import image_dir as jax_image_dir
from dxmi_tpu_torch import make_npz
from dxmi_tpu_torch.fid import image_dir
from dxmi_tpu_torch.utils import png


def _img(seed, h, w, c=3):
    return np.random.RandomState(seed).randint(0, 256, (h, w, c), np.uint8)


@pytest.mark.parametrize("h,w", [(1, 1), (32, 32), (17, 5), (64, 48)])
def test_round_trip_exact(tmp_path, h, w):
    """write_png then read_png gives the uint8 array back; PIL decodes the
    same pixels."""
    img = _img(h * w, h, w)
    path = str(tmp_path / "a.png")
    png.write_png(path, img)
    assert np.array_equal(png.read_png(path), img)
    assert np.array_equal(np.asarray(Image.open(path).convert("RGB")), img)


@pytest.mark.parametrize("mode", ["L", "RGB", "RGBA"])
def test_reads_pil_files(tmp_path, mode):
    """8-bit grayscale, RGB and RGBA files written by PIL read as PIL's
    convert('RGB')."""
    c = {"L": 1, "RGB": 3, "RGBA": 4}[mode]
    arr = _img(c, 23, 31, c)
    path = str(tmp_path / f"{mode}.png")
    Image.fromarray(arr[..., 0] if c == 1 else arr, mode).save(path)
    want = np.asarray(Image.open(path).convert("RGB"))
    assert np.array_equal(png.read_png(path), want)


def _filtered_png(path, img, kind):
    """An 8-bit PNG of ``img`` (H, W, C) whose every row uses filter
    ``kind``, encoded by the specification's formulas."""
    h, w, c = img.shape
    rows = img.reshape(h, w * c).astype(np.int64)
    out = []
    for y in range(h):
        prior = rows[y - 1] if y else np.zeros(w * c, np.int64)
        line = rows[y]
        left = np.concatenate([np.zeros(c, np.int64), line[:-c]])
        upleft = np.concatenate([np.zeros(c, np.int64), prior[:-c]])
        if kind == 0:
            pred = np.zeros_like(line)
        elif kind == 1:
            pred = left
        elif kind == 2:
            pred = prior
        elif kind == 3:
            pred = (left + prior) // 2
        else:
            p = left + prior - upleft
            pa, pb, pc = abs(p - left), abs(p - prior), abs(p - upleft)
            pred = np.where((pa <= pb) & (pa <= pc), left,
                            np.where(pb <= pc, prior, upleft))
        out.append(bytes([kind]) + ((line - pred) % 256).astype(
            np.uint8).tobytes())
    ctype = {1: 0, 3: 2, 4: 6}[c]
    with open(path, "wb") as f:
        f.write(png.SIGNATURE + png._chunk(b"IHDR", struct.pack(
            ">IIBBBBB", w, h, 8, ctype, 0, 0, 0))
            + png._chunk(b"IDAT", zlib.compress(b"".join(out)))
            + png._chunk(b"IEND", b""))


@pytest.mark.parametrize("kind", [0, 1, 2, 3, 4])
@pytest.mark.parametrize("c", [1, 3, 4])
def test_every_row_filter(tmp_path, kind, c):
    """None, Sub, Up, Average and Paeth rows decode exactly, at 1, 3 and 4
    bytes a pixel; PIL agrees."""
    img = _img(10 * kind + c, 9, 13, c)
    path = str(tmp_path / "f.png")
    _filtered_png(path, img, kind)
    want = np.repeat(img, 3, axis=2) if c == 1 else img[..., :3]
    assert np.array_equal(png.read_png(path), want)
    assert np.array_equal(np.asarray(Image.open(path).convert("RGB")), want)


def test_refusals_name_the_file(tmp_path):
    """Palette, 16-bit and interlaced files, a file that is not a PNG and
    a corrupt chunk raise and name the file."""
    pal = str(tmp_path / "pal.png")
    Image.fromarray(_img(1, 4, 4)).convert("P").save(pal)
    deep = str(tmp_path / "deep.png")
    Image.fromarray(np.arange(16, dtype=np.uint16).reshape(4, 4)
                    * 4000).save(deep)
    inter = str(tmp_path / "inter.png")
    with open(inter, "wb") as f:
        f.write(png.SIGNATURE + png._chunk(b"IHDR", struct.pack(
            ">IIBBBBB", 1, 1, 8, 2, 0, 0, 1))
            + png._chunk(b"IDAT", zlib.compress(b"\0\0\0\0"))
            + png._chunk(b"IEND", b""))
    text = str(tmp_path / "text.png")
    with open(text, "wb") as f:
        f.write(b"not an image")
    bad = str(tmp_path / "bad.png")
    png.write_png(bad, _img(2, 4, 4))
    data = bytearray(open(bad, "rb").read())
    data[40] ^= 0xFF  # inside the IDAT chunk
    with open(bad, "wb") as f:
        f.write(bytes(data))
    for path in (pal, deep, inter, text, bad):
        with pytest.raises(ValueError, match=os.path.basename(path)):
            png.read_png(path)
    with pytest.raises(ValueError, match="uint8"):
        png.write_png(str(tmp_path / "x.png"), np.zeros((2, 2, 3), np.float32))


def test_writer_names_and_errors(tmp_path):
    """PNGWriter writes <prefix>_<index>.png on its threads; a failed write
    raises at close."""
    batch = np.stack([_img(i, 8, 8) for i in range(5)])
    w = png.PNGWriter(str(tmp_path), prefix="0")
    w.put_batch(10, batch)
    assert w.close() == 5
    for j in range(5):
        assert np.array_equal(png.read_png(str(tmp_path / f"0_{10 + j}.png")),
                              batch[j])
    w = png.PNGWriter(str(tmp_path / "missing"))
    w.put_batch(0, batch[:1])
    with pytest.raises(FileNotFoundError):
        w.close()


@pytest.fixture
def png_dir(tmp_path):
    d = tmp_path / "imgs"
    (d / "sub").mkdir(parents=True)
    imgs = {f"0_{i}.png": _img(i, 6, 7) for i in (0, 1, 2, 10, 11)}
    imgs["sub/0_3.png"] = _img(3, 6, 7)
    for name, arr in imgs.items():
        png.write_png(str(d / name), arr)
    (d / "notes.txt").write_text("skip me")
    return d, imgs


def test_image_dir_matches_jax(png_dir):
    """list_images, load_batch and dir_activations as the JAX package's
    (which decodes through PIL): the same files in the same order, the
    same pixels, the same batches."""
    d, _ = png_dir
    files = image_dir.list_images(str(d))
    assert files == jax_image_dir.list_images(str(d))
    assert np.array_equal(image_dir.load_batch(files),
                          jax_image_dir.load_batch(files))

    def extract(x):
        return x.reshape(len(x), -1)[:, :5] * len(x)

    assert np.array_equal(image_dir.dir_activations(str(d), extract, 4),
                          jax_image_dir.dir_activations(str(d), extract, 4))
    with pytest.raises(FileNotFoundError):
        image_dir.dir_activations(str(d / "sub" / "none"), extract)


def test_load_batch_refuses_other_formats(tmp_path):
    path = str(tmp_path / "a.jpg")
    Image.fromarray(_img(0, 4, 4)).save(path)
    with pytest.raises(ValueError, match="only PNG"):
        image_dir.load_batch([path])


def test_make_npz_matches_jax(png_dir, tmp_path, monkeypatch):
    """python -m dxmi_tpu_torch.make_npz packs the directory as the JAX
    make_npz.py does (arr_0, sorted order), streaming."""
    d, _ = png_dir
    ours, theirs = str(tmp_path / "ours.npz"), str(tmp_path / "theirs.npz")
    monkeypatch.setattr(sys, "argv", ["make_npz", "--image_dir", str(d),
                                      "--out", ours, "--device", "cpu"])
    make_npz.main()
    import make_npz as jax_make_npz

    monkeypatch.setattr(sys, "argv", ["make_npz.py", "--image_dir", str(d),
                                      "--out", theirs])
    jax_make_npz.main()
    got, want = np.load(ours)["arr_0"], np.load(theirs)["arr_0"]
    assert got.shape == (6, 6, 7, 3) and np.array_equal(got, want)
    with pytest.raises(SystemExit):
        make_npz.pack(str(tmp_path / "empty"), str(tmp_path / "e.npz"))
