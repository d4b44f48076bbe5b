"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here carries the ``cuda`` marker and skips without a CUDA device.
The file imports no JAX, so on a machine with the card (and no JAX) it runs
without the repository's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py

Tolerances are chip_smoke.TOL (stated and reasoned there).
"""
import numpy as np
import pytest
import torch

from chip_smoke import TOL
from dxmi_tpu_torch.ops import _lib
from dxmi_tpu_torch.ops.attn_block import attn_block, attn_block_reference
from dxmi_tpu_torch.ops.conv_fused import gn_silu_conv, gn_silu_conv_reference
from dxmi_tpu_torch.ops.groupnorm import group_norm, group_norm_silu_reference

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    _lib.reset_launches()
    return torch.device("cuda")


def _tensors(rs, device, *shapes_scales):
    """Normal tensors (shape, scale, shift) from a numpy RandomState."""
    return [torch.from_numpy((rs.randn(*shape) * scale + shift)
                             .astype(np.float32)).to(device)
            for shape, scale, shift in shapes_scales]


def _check(out, ref, name):
    atol, rtol = TOL[name]
    torch.testing.assert_close(out, ref, rtol=rtol, atol=atol)
    assert _lib.LAUNCHES[name] == 1


@pytest.mark.parametrize("silu", [False, True])
@pytest.mark.parametrize("shape", [(100, 1024, 128), (100, 16, 256),
                                   (8, 256, 32), (8, 64, 96), (4, 64, 384),
                                   (3, 7, 64)])
def test_group_norm(card, shape, silu):
    C = shape[-1]
    x, s, b = _tensors(np.random.RandomState(0), card, (shape, 2.0, 0.5),
                       ((C,), 0.1, 1.0), ((C,), 0.1, 0.0))
    _check(group_norm(x, s, b, 32, 1e-6, silu),
           group_norm_silu_reference(x, s, b, 32, 1e-6, silu), "gn_silu")


@pytest.mark.parametrize("B,R,Cin,Cout", [(100, 32, 128, 128),
                                          (100, 16, 512, 256),
                                          (100, 4, 256, 256), (8, 16, 32, 32),
                                          (8, 8, 96, 64), (8, 8, 192, 64),
                                          (3, 5, 64, 40)])
def test_gn_silu_conv(card, B, R, Cin, Cout):
    args = _tensors(np.random.RandomState(1), card, ((B, R, R, Cin), 2.0, 0.5),
                    ((Cin,), 0.1, 1.0), ((Cin,), 0.1, 0.0),
                    ((3, 3, Cin, Cout), (9 * Cin) ** -0.5, 0.0),
                    ((Cout,), 0.1, 0.0))
    _check(gn_silu_conv(*args), gn_silu_conv_reference(*args),
           "gn_silu_conv3x3")


@pytest.mark.parametrize("B,S,C,nh", [(100, 256, 256, 1), (8, 64, 64, 1),
                                      (2, 128, 128, 2), (2, 192, 96, 1)])
def test_attn_block(card, B, S, C, nh):
    args = _tensors(np.random.RandomState(2), card, ((B, S, C), 2.0, 0.5),
                    ((C,), 0.1, 1.0), ((C,), 0.1, 0.0),
                    ((C, 3 * C), C ** -0.5, 0.0), ((3 * C,), 0.1, 0.0),
                    ((C, C), C ** -0.5, 0.0), ((C,), 0.1, 0.0))
    _check(attn_block(*args, num_heads=nh, eps=1e-6),
           attn_block_reference(*args, num_heads=nh, eps=1e-6), "attn_block")


def test_wrappers_reject_what_the_kernels_do_not_take(card):
    x = torch.zeros(2, 8, 8, 48, device=card)
    with pytest.raises(ValueError):
        gn_silu_conv(x, x.new_ones(48), x.new_zeros(48),
                     x.new_zeros(3, 3, 48, 64), x.new_zeros(64))
    y = torch.zeros(2, 16, 64, device=card)
    with pytest.raises(ValueError):
        attn_block(y, y.new_ones(64), y.new_zeros(64), y.new_zeros(64, 192),
                   y.new_zeros(192), y.new_zeros(64, 64), y.new_zeros(64),
                   num_heads=1)
    with pytest.raises(ValueError):
        group_norm(torch.zeros(2, 8, 64, device=card).transpose(1, 2),
                   torch.ones(8, device=card), torch.zeros(8, device=card), 8)
    assert not _lib.LAUNCHES
