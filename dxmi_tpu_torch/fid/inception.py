"""The FID Inception-v3 (``dxmi_tpu/fid/inception.py``): pytorch_fid's
patched network with its BatchNorms folded into the convolutions.

Input: float images in [0, 1], NCHW (the JAX module takes NHWC), resized
bilinearly to 299 x 299 with half-pixel centres (``F.interpolate``,
``align_corners=False``, which equals ``jax.image.resize`` when it
upsamples; a larger input raises, since ``jax.image.resize`` antialiases
when it downsamples), then mapped to [-1, 1]. Output: the (B, 2048) pool3
activations. InceptionA, C and the first E average-pool without counting
the padding; the last E max-pools in its pool branch; the stem's max pools
are VALID. ``taps`` also returns the evaluator's sFID tap: the first 7
channels of the Mixed_6d output (whose first 192 channels are its branch1x1
unit, TF's ``mixed_6/conv``), flattened in NHWC row-major order (2023
values).

``load_fid_inception_params`` reads the published
``pt_inception-2015-12-05.pth`` (a plain state dict) or an ``.npz`` re-pack
with the same keys and folds each BatchNorm in numpy float32 with the JAX
package's formula, so the folded weights equal JAX's bit for bit; the
``fc`` head (1008 logits, for the Inception Score) is kept when the file
has it.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

BN_EPS = 1e-3  # torchvision's InceptionV3 BatchNorm eps
SIZE = 299
SPATIAL_CHANNELS = 7  # the sFID tap's channels of Mixed_6d


class ConvBN(nn.Module):
    """A convolution with the BatchNorm folded into its bias, then ReLU."""

    def __init__(self, cin: int, cout: int, kernel, stride: int = 1,
                 padding=0):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, kernel, stride=stride,
                              padding=padding, bias=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(self.conv(x))


def _avg_pool_nopad_count(x: torch.Tensor) -> torch.Tensor:
    """3x3 stride-1 average pool with ``count_include_pad=False`` (the FID
    patch)."""
    return F.avg_pool2d(x, 3, stride=1, padding=1, count_include_pad=False)


class InceptionA(nn.Module):
    def __init__(self, cin: int, pool_features: int):
        super().__init__()
        self.branch1x1 = ConvBN(cin, 64, 1)
        self.branch5x5_1 = ConvBN(cin, 48, 1)
        self.branch5x5_2 = ConvBN(48, 64, 5, padding=2)
        self.branch3x3dbl_1 = ConvBN(cin, 64, 1)
        self.branch3x3dbl_2 = ConvBN(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = ConvBN(96, 96, 3, padding=1)
        self.branch_pool = ConvBN(cin, pool_features, 1)

    def forward(self, x):
        b5 = self.branch5x5_2(self.branch5x5_1(x))
        b3 = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        bp = self.branch_pool(_avg_pool_nopad_count(x))
        return torch.cat([self.branch1x1(x), b5, b3, bp], 1)


class InceptionB(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.branch3x3 = ConvBN(cin, 384, 3, stride=2)
        self.branch3x3dbl_1 = ConvBN(cin, 64, 1)
        self.branch3x3dbl_2 = ConvBN(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = ConvBN(96, 96, 3, stride=2)

    def forward(self, x):
        bd = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([self.branch3x3(x), bd,
                          F.max_pool2d(x, 3, stride=2)], 1)


class InceptionC(nn.Module):
    def __init__(self, cin: int, c7: int):
        super().__init__()
        self.branch1x1 = ConvBN(cin, 192, 1)
        self.branch7x7_1 = ConvBN(cin, c7, 1)
        self.branch7x7_2 = ConvBN(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7_3 = ConvBN(c7, 192, (7, 1), padding=(3, 0))
        self.branch7x7dbl_1 = ConvBN(cin, c7, 1)
        self.branch7x7dbl_2 = ConvBN(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_3 = ConvBN(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7dbl_4 = ConvBN(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_5 = ConvBN(c7, 192, (1, 7), padding=(0, 3))
        self.branch_pool = ConvBN(cin, 192, 1)

    def forward(self, x):
        b7 = self.branch7x7_3(self.branch7x7_2(self.branch7x7_1(x)))
        bd = self.branch7x7dbl_1(x)
        for m in (self.branch7x7dbl_2, self.branch7x7dbl_3,
                  self.branch7x7dbl_4, self.branch7x7dbl_5):
            bd = m(bd)
        bp = self.branch_pool(_avg_pool_nopad_count(x))
        return torch.cat([self.branch1x1(x), b7, bd, bp], 1)


class InceptionD(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.branch3x3_1 = ConvBN(cin, 192, 1)
        self.branch3x3_2 = ConvBN(192, 320, 3, stride=2)
        self.branch7x7x3_1 = ConvBN(cin, 192, 1)
        self.branch7x7x3_2 = ConvBN(192, 192, (1, 7), padding=(0, 3))
        self.branch7x7x3_3 = ConvBN(192, 192, (7, 1), padding=(3, 0))
        self.branch7x7x3_4 = ConvBN(192, 192, 3, stride=2)

    def forward(self, x):
        b3 = self.branch3x3_2(self.branch3x3_1(x))
        b7 = self.branch7x7x3_1(x)
        for m in (self.branch7x7x3_2, self.branch7x7x3_3,
                  self.branch7x7x3_4):
            b7 = m(b7)
        return torch.cat([b3, b7, F.max_pool2d(x, 3, stride=2)], 1)


class InceptionE(nn.Module):
    """``pool_mode`` 'avg' (Mixed_7b) or 'max' (Mixed_7c, the FID patch)."""

    def __init__(self, cin: int, pool_mode: str):
        super().__init__()
        self.pool_mode = pool_mode
        self.branch1x1 = ConvBN(cin, 320, 1)
        self.branch3x3_1 = ConvBN(cin, 384, 1)
        self.branch3x3_2a = ConvBN(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3_2b = ConvBN(384, 384, (3, 1), padding=(1, 0))
        self.branch3x3dbl_1 = ConvBN(cin, 448, 1)
        self.branch3x3dbl_2 = ConvBN(448, 384, 3, padding=1)
        self.branch3x3dbl_3a = ConvBN(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3dbl_3b = ConvBN(384, 384, (3, 1), padding=(1, 0))
        self.branch_pool = ConvBN(cin, 192, 1)

    def forward(self, x):
        b3 = self.branch3x3_1(x)
        b3 = torch.cat([self.branch3x3_2a(b3), self.branch3x3_2b(b3)], 1)
        bd = self.branch3x3dbl_2(self.branch3x3dbl_1(x))
        bd = torch.cat([self.branch3x3dbl_3a(bd), self.branch3x3dbl_3b(bd)],
                       1)
        if self.pool_mode == "avg":
            bp = _avg_pool_nopad_count(x)
        else:
            bp = F.max_pool2d(x, 3, stride=1, padding=1)
        return torch.cat([self.branch1x1(x), b3, bd, self.branch_pool(bp)],
                         1)


class InceptionV3FID(nn.Module):
    """``forward(x01)`` -> (B, 2048) pool3 activations of NCHW images in
    [0, 1] of any size up to 299; ``taps(x01)`` -> ``{'pool3', 'spatial'}``.
    ``fc``: keep the 1008-way logits head (``fc``) of the published file."""

    def __init__(self, fc: bool = True):
        super().__init__()
        self.Conv2d_1a_3x3 = ConvBN(3, 32, 3, stride=2)
        self.Conv2d_2a_3x3 = ConvBN(32, 32, 3)
        self.Conv2d_2b_3x3 = ConvBN(32, 64, 3, padding=1)
        self.Conv2d_3b_1x1 = ConvBN(64, 80, 1)
        self.Conv2d_4a_3x3 = ConvBN(80, 192, 3)
        self.Mixed_5b = InceptionA(192, 32)
        self.Mixed_5c = InceptionA(256, 64)
        self.Mixed_5d = InceptionA(288, 64)
        self.Mixed_6a = InceptionB(288)
        self.Mixed_6b = InceptionC(768, 128)
        self.Mixed_6c = InceptionC(768, 160)
        self.Mixed_6d = InceptionC(768, 160)
        self.Mixed_6e = InceptionC(768, 192)
        self.Mixed_7a = InceptionD(768)
        self.Mixed_7b = InceptionE(1280, "avg")
        self.Mixed_7c = InceptionE(2048, "max")
        self.fc = nn.Linear(2048, 1008) if fc else None

    def _trunk(self, x01: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """(pool3, Mixed_6d output NCHW)."""
        if x01.shape[-2] > SIZE or x01.shape[-1] > SIZE:
            raise ValueError(
                f"input {tuple(x01.shape[-2:])} is larger than {SIZE}: the "
                "JAX package's resize antialiases when it downsamples, "
                "which this port does not reproduce")
        x = F.interpolate(x01, size=(SIZE, SIZE), mode="bilinear",
                          align_corners=False)
        x = 2.0 * x - 1.0
        x = self.Conv2d_2b_3x3(self.Conv2d_2a_3x3(self.Conv2d_1a_3x3(x)))
        x = F.max_pool2d(x, 3, stride=2)
        x = self.Conv2d_4a_3x3(self.Conv2d_3b_1x1(x))
        x = F.max_pool2d(x, 3, stride=2)
        for m in (self.Mixed_5b, self.Mixed_5c, self.Mixed_5d, self.Mixed_6a,
                  self.Mixed_6b, self.Mixed_6c, self.Mixed_6d):
            x = m(x)
        spatial = x
        for m in (self.Mixed_6e, self.Mixed_7a, self.Mixed_7b, self.Mixed_7c):
            x = m(x)
        return x.mean(dim=(2, 3)), spatial

    def forward(self, x01: torch.Tensor) -> torch.Tensor:
        return self._trunk(x01)[0]

    def taps(self, x01: torch.Tensor) -> Dict[str, torch.Tensor]:
        """pool3 (B, 2048) and the sFID tap (B, 7 * 17 * 17)."""
        pool3, spatial = self._trunk(x01)
        sp = spatial[:, :SPATIAL_CHANNELS].permute(0, 2, 3, 1)
        return {"pool3": pool3, "spatial": sp.reshape(sp.shape[0], -1)}


def fold_bn(conv_w: np.ndarray, gamma, beta, mean, var,
            eps: float = BN_EPS) -> Tuple[np.ndarray, np.ndarray]:
    """Fold an inference BatchNorm into the conv before it:
    W' = W * g / s, b' = beta - mean * g / s with s = sqrt(var + eps)."""
    scale = gamma / np.sqrt(var + eps)
    w = conv_w * scale[:, None, None, None]  # (O, I, kh, kw)
    b = beta - mean * scale
    return w, b


def read_state(path: str) -> Dict[str, np.ndarray]:
    """The raw arrays of a ``pt_inception`` file: ``.npz``, or a ``.pth``
    state dict read with ``weights_only``."""
    if path.endswith(".npz"):
        with np.load(path) as d:
            return {k: d[k] for k in d.files}
    raw = torch.load(path, map_location="cpu", weights_only=True)
    return {k: v.numpy() for k, v in raw.items()}


def fold_state(state: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """The port's state dict from a raw pt-layout one: each
    ``<prefix>.conv.weight`` with its ``<prefix>.bn.*`` folded into
    ``<prefix>.conv.{weight,bias}``, and ``fc.*`` when present."""
    out: Dict[str, torch.Tensor] = {}
    prefixes = sorted({k.rsplit(".conv.weight", 1)[0]
                       for k in state if k.endswith(".conv.weight")})
    for prefix in prefixes:
        w, b = fold_bn(*(np.asarray(state[f"{prefix}.{name}"], np.float32)
                         for name in ("conv.weight", "bn.weight", "bn.bias",
                                      "bn.running_mean", "bn.running_var")))
        out[f"{prefix}.conv.weight"] = torch.from_numpy(w)
        out[f"{prefix}.conv.bias"] = torch.from_numpy(b)
    for name in ("fc.weight", "fc.bias"):
        if name in state:
            out[name] = torch.from_numpy(np.asarray(state[name], np.float32))
    return out


def load_fid_inception_params(path: str) -> Dict[str, torch.Tensor]:
    """The folded state dict of ``InceptionV3FID`` from the published FID
    weights (``pt_inception-2015-12-05.pth``) or an npz re-pack with the
    same keys."""
    return fold_state(read_state(path))


def nchw_on(x01_nhwc: np.ndarray, device: torch.device) -> torch.Tensor:
    """Host NHWC images as an NCHW float32 tensor on ``device``."""
    return torch.from_numpy(np.ascontiguousarray(
        np.asarray(x01_nhwc, np.float32).transpose(0, 3, 1, 2))).to(device)


@torch.no_grad()
def pool3_host(model: InceptionV3FID, x01_nhwc: np.ndarray) -> np.ndarray:
    """pool3 activations (B, 2048) float32 on the host of host NHWC images
    in [0, 1], computed on the model's device."""
    dev = next(model.parameters()).device
    return model(nchw_on(x01_nhwc, dev)).cpu().numpy()


def build_inception(state: Dict[str, torch.Tensor],
                    device: torch.device) -> InceptionV3FID:
    """``InceptionV3FID`` in eval mode on ``device`` with ``state`` loaded
    strictly (with the ``fc`` head when ``state`` has it)."""
    model = InceptionV3FID(fc="fc.weight" in state)
    model.load_state_dict(state, strict=True)
    return model.to(device).eval()
