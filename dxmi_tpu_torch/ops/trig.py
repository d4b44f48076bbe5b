"""Accurate float32 sin/cos arguments for large angles.

A 3-term Cody-Waite reduction mod 2*pi (as ``dxmi_tpu/ops/trig.py``): the
sinusoidal timestep embedding takes arguments up to ~1000 rad, where a
plain float32 range reduction drifts by ~1e-3. Reducing first keeps the
embedding within ~1e-7 of the reference.
"""
from __future__ import annotations

import math

import numpy as np
import torch

_TWO_PI = 2.0 * math.pi
_TP_HI = float(np.float32(np.trunc(_TWO_PI * 2**13) / 2**13))
_TP_MID = float(np.float32(_TWO_PI - _TP_HI))
_TP_LO = float(np.float32(_TWO_PI - _TP_HI - _TP_MID))


def reduce_mod_2pi(x: torch.Tensor) -> torch.Tensor:
    k = torch.floor(x / _TWO_PI)
    return ((x - k * _TP_HI) - k * _TP_MID) - k * _TP_LO
