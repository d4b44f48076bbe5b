"""Image-folder dataset for ImageNet64 and LSUN
(``dxmi_tpu.data.image_folder``, ``image_folder.py:19-208``), reading PNG
files without PIL.

As the JAX loader: the recursive sorted listing, classes from filename
prefixes (``<class>_<name>.png``), the pickled ``cachefile`` of
``{'files', 'classes'}`` (either package's file loads), center or random
crop, horizontal flip, /127.5 - 1, process sharding, and both random
streams: ``num_workers=0`` draws from one ``RandomState(seed +
process_index)``, and with workers each image draws from
``SeedSequence([seed + process_index, epoch, index])`` on a thread pool
that assembles batches ``prefetch`` ahead. The batches are bit-equal to the
JAX loader's on the same files.

The crops resize as the JAX loader's PIL calls do (Pillow 12.1's
``Image.resize``, ``libImaging/Resample.c``), written out in numpy: BOX
halvings while the image is at least twice the target, then BICUBIC to the
scale. Each pass computes its coefficients in float64, turns them into
fixed point with 22 fractional bits, and rounds its uint8 output (the
horizontal pass first; a pass whose size is unchanged does nothing, and an
unchanged size returns the image as it is). RGBA resizes premultiplied
(PIL converts it to ``RGBa`` and back around ``resize``); grayscale is
resized in its one channel and becomes RGB after. Files the port's PNG
reader does not take (other formats, palette, 16-bit, grayscale with alpha)
raise and name the file.
"""
from __future__ import annotations

import os
import pickle
from typing import Callable, Iterator, List, Optional, Tuple

import numpy as np

from dxmi_tpu_torch.utils.png import read_png_raw

IMG_EXTS = {"jpg", "jpeg", "png", "gif", "webp", "bmp"}
PRECISION_BITS = 22


def list_image_files_recursively(data_dir: str) -> List[str]:
    results = []
    for entry in sorted(os.listdir(data_dir)):
        full = os.path.join(data_dir, entry)
        ext = entry.split(".")[-1].lower()
        if "." in entry and ext in IMG_EXTS:
            results.append(full)
        elif os.path.isdir(full):
            results.extend(list_image_files_recursively(full))
    return results


# ---- Pillow's resampling -------------------------------------------------

def _box(x: np.ndarray) -> np.ndarray:
    return ((x > -0.5) & (x <= 0.5)).astype(np.float64)


def _bicubic(x: np.ndarray) -> np.ndarray:
    a = -0.5
    x = np.abs(x)
    near = ((a + 2.0) * x - (a + 3.0)) * x * x + 1
    far = (((x - 5) * x + 8) * x - 4) * a
    return np.where(x < 1.0, near, np.where(x < 2.0, far, 0.0))


FILTERS = {"box": (_box, 0.5), "bicubic": (_bicubic, 2.0)}


def _coeffs(in_size: int, out_size: int, kind: str
            ) -> Tuple[np.ndarray, np.ndarray]:
    """``precompute_coeffs`` + ``normalize_coeffs_8bpc``: for each output
    pixel the input indices (out, ksize) and the fixed-point weights."""
    filt, fsupport = FILTERS[kind]
    scale = float(in_size) / out_size
    filterscale = max(scale, 1.0)
    support = fsupport * filterscale
    ksize = int(np.ceil(support)) * 2 + 1
    center = (np.arange(out_size) + 0.5) * scale
    xmin = np.maximum(np.trunc(center - support + 0.5), 0).astype(np.int64)
    xmax = np.minimum(np.trunc(center + support + 0.5),
                      in_size).astype(np.int64) - xmin
    x = np.arange(ksize)[None, :]
    live = x < xmax[:, None]
    w = filt(((x + xmin[:, None]) - center[:, None] + 0.5)
             * (1.0 / filterscale))
    w = np.where(live, w, 0.0)
    ww = np.zeros((out_size, 1))
    for j in range(ksize):  # in order, as the C loop sums (not pairwise)
        ww += w[:, j:j + 1]
    w = np.where(ww != 0.0, w / np.where(ww != 0.0, ww, 1.0), w)
    kk = np.trunc(np.where(w < 0, -0.5, 0.5) + w * (1 << PRECISION_BITS))
    idx = np.where(live, x + xmin[:, None], xmin[:, None])
    return idx, kk.astype(np.int64)


def _pass(img: np.ndarray, out_size: int, kind: str, axis: int
          ) -> np.ndarray:
    """One 8bpc pass along ``axis`` (1 horizontal, 0 vertical) of a (H, W,
    C) uint8 image: the fixed-point sums from 2^21, shifted by 22 bits and
    clipped to uint8."""
    idx, kk = _coeffs(img.shape[axis], out_size, kind)
    src = img.astype(np.int64)
    acc = np.full(img.shape[:axis] + (out_size,) + img.shape[axis + 1:],
                  1 << (PRECISION_BITS - 1), np.int64)
    for j in range(idx.shape[1]):
        taps = np.take(src, idx[:, j], axis=axis)
        w = kk[:, j].reshape((-1, 1, 1) if axis == 0 else (1, -1, 1))
        acc += taps * w
    return np.clip(acc >> PRECISION_BITS, 0, 255).astype(np.uint8)


def _premultiply(img: np.ndarray) -> np.ndarray:
    """RGBA -> RGBa (``rgbA2rgba``: MULDIV255 of each colour by alpha)."""
    a = img[..., 3:].astype(np.uint32)
    tmp = img[..., :3].astype(np.uint32) * a + 128
    rgb = ((tmp >> 8) + tmp) >> 8
    return np.concatenate([rgb.astype(np.uint8), img[..., 3:]], axis=-1)


def _unpremultiply(img: np.ndarray) -> np.ndarray:
    """RGBa -> RGBA (``rgba2rgbA``: 255 c / alpha, clipped, where alpha is
    neither 0 nor 255)."""
    a = img[..., 3:].astype(np.int64)
    rgb = img[..., :3].astype(np.int64)
    div = np.minimum(255 * rgb // np.maximum(a, 1), 255)
    keep = (a == 255) | (a == 0)
    out = np.where(keep, rgb, div).astype(np.uint8)
    return np.concatenate([out, img[..., 3:]], axis=-1)


def pil_resize(img: np.ndarray, size: Tuple[int, int], kind: str
               ) -> np.ndarray:
    """``Image.resize((w, h), BOX or BICUBIC)`` of a (H, W, C) uint8 image
    in PIL's mode L (C 1), RGB (3) or RGBA (4)."""
    w, h = size
    if (img.shape[1], img.shape[0]) == (w, h):
        return img
    rgba = img.shape[2] == 4
    out = _premultiply(img) if rgba else img
    if w != out.shape[1]:
        out = _pass(out, w, kind, 1)
    if h != out.shape[0]:
        out = _pass(out, h, kind, 0)
    return _unpremultiply(out) if rgba else out


def _size(img: np.ndarray) -> Tuple[int, int]:
    return img.shape[1], img.shape[0]  # PIL's (width, height)


def _rgb(img: np.ndarray) -> np.ndarray:
    """``convert('RGB')``: gray replicated, alpha dropped."""
    if img.shape[2] == 1:
        return np.repeat(img, 3, axis=2)
    return img[..., :3]


def _scale_to(img: np.ndarray, smaller: int) -> np.ndarray:
    while min(*_size(img)) >= 2 * smaller:
        img = pil_resize(img, tuple(x // 2 for x in _size(img)), "box")
    scale = smaller / min(*_size(img))
    return _rgb(pil_resize(img, tuple(round(x * scale) for x in _size(img)),
                           "bicubic"))


def center_crop_arr(img: np.ndarray, image_size: int) -> np.ndarray:
    """Halve by BOX, BICUBIC to the scale, then the center crop
    (``image_folder.py:31-45``)."""
    arr = _scale_to(img, image_size)
    crop_y = (arr.shape[0] - image_size) // 2
    crop_x = (arr.shape[1] - image_size) // 2
    return arr[crop_y:crop_y + image_size, crop_x:crop_x + image_size]


def random_crop_arr(img: np.ndarray, image_size: int,
                    rng: np.random.RandomState, min_frac: float = 0.8,
                    max_frac: float = 1.0) -> np.ndarray:
    """A random smaller side in [image_size / max_frac, image_size /
    min_frac], then a random crop (``image_folder.py:48-62``)."""
    min_s = round(image_size / max_frac)
    max_s = round(image_size / min_frac)
    arr = _scale_to(img, rng.randint(min_s, max_s + 1))
    crop_y = rng.randint(arr.shape[0] - image_size + 1)
    crop_x = rng.randint(arr.shape[1] - image_size + 1)
    return arr[crop_y:crop_y + image_size, crop_x:crop_x + image_size]


def read_image(path: str) -> np.ndarray:
    """A file of the listing as (H, W, C) uint8 in PIL's mode; anything
    but an 8-bit grayscale, RGB or RGBA PNG raises, naming the file."""
    if not path.lower().endswith(".png"):
        raise ValueError(f"{path}: only PNG images are read by the port "
                         "(the other formats need PIL; ROADMAP.md)")
    return read_png_raw(path)


class ImageFolderDataset:
    """Lazily decoded images; classes from filename prefixes."""

    def __init__(self, data_dir: str, image_size: int,
                 class_cond: bool = False, cachefile: Optional[str] = None,
                 random_crop: bool = False, random_flip: bool = True):
        self.image_size = image_size
        self.random_crop = random_crop
        self.random_flip = random_flip
        if cachefile and os.path.exists(cachefile):
            with open(cachefile, "rb") as f:
                d = pickle.load(f)
            self.files, self.classes = d["files"], d["classes"]
        else:
            self.files = list_image_files_recursively(data_dir)
            self.classes = None
            if class_cond:
                names = [os.path.basename(p).split("_")[0]
                         for p in self.files]
                ids = {c: i for i, c in enumerate(sorted(set(names)))}
                self.classes = np.asarray([ids[n] for n in names],
                                          dtype=np.int32)
            if cachefile:
                with open(cachefile, "wb") as f:
                    pickle.dump({"files": self.files,
                                 "classes": self.classes}, f)

    def __len__(self) -> int:
        return len(self.files)

    def load(self, idx: int, rng: np.random.RandomState
             ) -> Tuple[np.ndarray, Optional[int]]:
        img = read_image(self.files[idx])
        if self.random_crop:
            arr = random_crop_arr(img, self.image_size, rng)
        else:
            arr = center_crop_arr(img, self.image_size)
        if self.random_flip and rng.rand() < 0.5:
            arr = arr[:, ::-1]
        x = arr.astype(np.float32) / 127.5 - 1.0
        y = int(self.classes[idx]) if self.classes is not None else None
        return x, y


def load_data(data_dir: str, batch_size: int, image_size: int,
              class_cond: bool = False, cachefile: Optional[str] = None,
              deterministic: bool = False, random_crop: bool = False,
              random_flip: bool = True, seed: int = 0,
              process_index: int = 0, process_count: int = 1,
              num_workers: int = 0, prefetch: int = 2
              ) -> Iterator[Tuple[np.ndarray, dict]]:
    """Infinite, process-sharded batches ``(x (B, H, W, C) in [-1, 1],
    {'y': labels} or {})``, in the JAX loader's order and draws."""
    ds = ImageFolderDataset(data_dir, image_size, class_cond, cachefile,
                            random_crop, random_flip)
    rng = np.random.RandomState(seed + process_index)
    n = len(ds)

    def index_batches():
        epoch = 0
        while True:
            order = np.arange(n) if deterministic else rng.permutation(n)
            shard = order[process_index::process_count]
            for i in range(0, len(shard) - batch_size + 1, batch_size):
                yield epoch, shard[i:i + batch_size]
            epoch += 1

    def pack(rows):
        extra = {}
        if class_cond:
            extra["y"] = np.asarray([y for _, y in rows], dtype=np.int32)
        return np.stack([x for x, _ in rows]), extra

    if num_workers <= 0:
        for _, idx in index_batches():
            yield pack([ds.load(int(j), rng) for j in idx])
        return

    def load_one(epoch: int, j: int):
        r = np.random.RandomState(np.random.SeedSequence(
            [seed + process_index, epoch, int(j)]).generate_state(1)[0])
        return ds.load(int(j), r)

    yield from _prefetched(index_batches(), load_one, pack, num_workers,
                           prefetch)


def _prefetched(batches: Iterator, load_one: Callable, pack: Callable,
                num_workers: int, prefetch: int) -> Iterator:
    """Batches decoded on a pool of ``num_workers`` threads by a producer
    thread, ``prefetch`` ahead; a decode error reaches the consumer, and
    closing the generator stops the producer and the pool."""
    import queue as queuelib
    import threading
    from concurrent.futures import ThreadPoolExecutor

    q: "queuelib.Queue" = queuelib.Queue(maxsize=max(1, prefetch))
    pool = ThreadPoolExecutor(max_workers=num_workers)
    stop = threading.Event()

    def producer():
        try:
            for epoch, idx in batches:
                batch = pack(list(pool.map(
                    lambda j, e=epoch: load_one(e, j), idx)))
                while not stop.is_set():
                    try:
                        q.put(batch, timeout=0.5)
                        break
                    except queuelib.Full:
                        continue
                if stop.is_set():
                    return
        except BaseException as e:  # decode errors reach the consumer
            q.put(e)

    thread = threading.Thread(target=producer, daemon=True)
    thread.start()
    try:
        while True:
            item = q.get()
            if isinstance(item, BaseException):
                raise item
            yield item
    finally:
        stop.set()
        try:
            while True:
                q.get_nowait()
        except queuelib.Empty:
            pass
        thread.join(timeout=5.0)
        pool.shutdown(wait=False, cancel_futures=True)
