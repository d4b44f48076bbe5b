"""Device choice for the port's entry points."""
from __future__ import annotations

import torch


def select_device(device: str = "cuda") -> torch.device:
    """Return the device to run on: ``cuda`` (the default) or an explicit
    ``cpu``. A request for ``cuda`` without a card raises; nothing falls
    back to the CPU.

    Also pins float32 semantics for the parity paths: cuDNN convolutions
    and cuBLAS matmuls default to (or may use) TF32, which keeps about
    three decimal digits; the JAX reference runs these products in fp32,
    so TF32 is switched off for both.
    """
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' requested but no CUDA device is "
                           "available (pass device='cpu' to run on the CPU)")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return dev
