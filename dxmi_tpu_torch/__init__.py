"""dxmi_tpu_torch: the PyTorch/CUDA port of dxmi_tpu for NVIDIA Hopper.

The package mirrors ``dxmi_tpu``'s module paths. It imports torch, numpy
and the stdlib only; the JAX package is its reference and is imported by
the tests alone. Hand-written CUDA kernels live in ``csrc/`` and are
built on first use into ``build/dxmi_tpu_torch/`` (see ``ops/_lib.py``).
"""
