"""K8's stride-2 form (the UNetSmall Downsample's int8 conv) against
dxmi_tpu.ops.quant on the CPU, with numpy-seeded inputs: the static
(per-channel and per-tensor scales) and dynamic W8A8 convs at stride 2 give
identical values to JAX's, in fp32 and bf16, with Downsample's padding (the
map padded (0, 1) on H and W, then a VALID 3x3 conv) and with the pads
handed to the conv itself. Both sides keep the same operation order and the
int8 sums are exact, so the tolerance is zero; the plain version's int32
sums equal a float64 strided convolution of the same int8 values."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from dxmi_tpu.ops import quant as jq
from dxmi_tpu_torch.ops import quant as tq

DTYPES = [(jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)]
VALID = ((0, 0), (0, 0))
# (map, padding handed to the conv): Downsample's explicit (0, 1) pad then
# VALID, the same pad inside the conv, and SAME at an odd size
FORMS = [(16, "downsample"), (16, ((0, 1), (0, 1))), (9, ((1, 1), (1, 1)))]


def _inputs(seed, R, C=64, O=32):
    rs = np.random.RandomState(seed)
    x = (rs.randn(2, R, R, C) * 2 + 0.3).astype(np.float32)
    kern = (rs.randn(3, 3, C, O) / np.sqrt(9 * C)).astype(np.float32)
    b = (0.1 * rs.randn(O)).astype(np.float32)
    a = (0.01 + 0.05 * np.abs(rs.randn(C))).astype(np.float32)
    return x, kern, b, a


def _form(x, pad):
    """The conv's input and padding: Downsample pads x itself (jnp.pad,
    unet_small.py:455) and runs a VALID conv."""
    if pad == "downsample":
        return np.pad(x, ((0, 0), (0, 1), (0, 1), (0, 0))), VALID
    return x, pad


def _np(t):
    return np.asarray(t, np.float32)


@pytest.mark.parametrize("R,pad", FORMS)
@pytest.mark.parametrize("jdt,tdt", DTYPES)
@pytest.mark.parametrize("scale", ["channel", "tensor"])
def test_int8_conv_static_stride2_equal(jdt, tdt, R, pad, scale):
    x, kern, b, a = _inputs(1, R)
    x, pad = _form(x, pad)
    a = a if scale == "channel" else np.float32(0.05)
    ref = jq.int8_conv_static(jnp.asarray(x).astype(jdt), jnp.asarray(kern),
                              jnp.asarray(b), jnp.asarray(a), (2, 2), pad,
                              out_dtype=jdt)
    out = tq.int8_conv_static(torch.from_numpy(x).to(tdt),
                              torch.from_numpy(kern), torch.from_numpy(b),
                              torch.as_tensor(a), (2, 2), pad, out_dtype=tdt)
    assert out.dtype == tdt and tuple(out.shape) == ref.shape
    np.testing.assert_array_equal(out.float().numpy(), _np(ref))


@pytest.mark.parametrize("R,pad", FORMS)
@pytest.mark.parametrize("jdt,tdt", DTYPES)
def test_int8_conv_dynamic_stride2_equal(jdt, tdt, R, pad):
    x, kern, b, _ = _inputs(2, R)
    x, pad = _form(x, pad)
    ref = jq.int8_conv(jnp.asarray(x).astype(jdt), jnp.asarray(kern),
                       jnp.asarray(b), (2, 2), pad, out_dtype=jdt)
    out = tq.int8_conv(torch.from_numpy(x).to(tdt), torch.from_numpy(kern),
                       torch.from_numpy(b), (2, 2), pad, out_dtype=tdt)
    assert tuple(out.shape) == ref.shape
    np.testing.assert_array_equal(out.float().numpy(), _np(ref))


@pytest.mark.parametrize("R,pad", FORMS)
def test_plain_k8_stride2_is_exact(R, pad):
    """The int32 sums of the stride-2 plain version equal a float64 strided
    convolution of the same int8 values."""
    x, kern, _, a = _inputs(3, R, C=32, O=16)
    x, pad = _form(x, pad)
    q = tq.prepare_conv_static(torch.from_numpy(kern), torch.from_numpy(a))
    out = tq.int8_conv_reference(torch.from_numpy(x), q, None, pad,
                                 torch.float32, stride=2)
    xi = torch.clamp(torch.round(torch.from_numpy(x) * q.xscale), -127, 127)
    (pt, pb), (pl, pr) = pad
    acc = F.conv2d(F.pad(xi.double().permute(0, 3, 1, 2), (pl, pr, pt, pb)),
                   q.w_i8.double().permute(0, 3, 1, 2), stride=2)
    want = acc.to(torch.int32).float() * q.dq[:, None, None]
    torch.testing.assert_close(out, want.permute(0, 2, 3, 1), rtol=0, atol=0)


@pytest.mark.parametrize("static", [True, False])
def test_qconv_stride2_matches_jax_qconv(static):
    """A stride-2 VALID QConv (the Downsample's, on the padded map): its
    calibrating pass records the JAX QConv's act_scale over the padded map
    and returns the full-precision conv; its int8 forward equals JAX's."""
    rs = np.random.RandomState(4)
    x = np.pad((rs.randn(2, 16, 16, 32) * 1.5).astype(np.float32),
               ((0, 0), (0, 1), (0, 1), (0, 0)))
    m = jq.QConv(32, (3, 3), strides=(2, 2), padding=VALID,
                 static_act=static, dtype=jnp.float32)
    v = m.init(jax.random.key(0), jnp.asarray(x))
    p = jax.tree.map(lambda t: t + 0.05 * jax.random.normal(
        jax.random.key(1), t.shape), v["params"])
    q = tq.QConv(32, 32, static_act=static, out_dtype=torch.float32,
                 kernel_size=3, stride=2, padding=0)
    with torch.no_grad():
        q.weight.copy_(torch.from_numpy(
            np.array(p["kernel"]).transpose(3, 2, 0, 1)))
        q.bias.copy_(torch.from_numpy(np.array(p["bias"])))
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).contiguous(
        memory_format=torch.channels_last)
    variables = {"params": p}
    if static:
        zeros = jax.tree.map(jnp.zeros_like, v["quant_scales"])
        y_cal, upd = m.apply({"params": p, "quant_scales": zeros},
                             jnp.asarray(x), mutable=["quant_scales"])
        q.calibrating = True
        with torch.no_grad():
            yt = q(xt)
        q.calibrating = False
        np.testing.assert_allclose(
            q.act_scale.numpy(),
            np.asarray(upd["quant_scales"]["act_scale"]), rtol=1e-6)
        np.testing.assert_allclose(yt.permute(0, 2, 3, 1).numpy(),
                                   np.asarray(y_cal), rtol=1e-5, atol=1e-5)
        q.act_scale.copy_(torch.from_numpy(
            np.asarray(upd["quant_scales"]["act_scale"])))
        variables["quant_scales"] = upd["quant_scales"]
    ref = np.asarray(m.apply(variables, jnp.asarray(x)))
    with torch.no_grad():
        out = q(xt)
    assert tuple(out.shape) == (2, 32, 8, 8)
    np.testing.assert_array_equal(out.permute(0, 2, 3, 1).numpy(), ref)


@pytest.mark.parametrize("args,msg", [
    (dict(W=130), "W <= 128"), (dict(pad=((0, 2), (0, 1))), "pads of at "
                                "most 1"), (dict(C=48), "Cin % 32")])
def test_stride2_forms_k8_does_not_take_raise(args, msg):
    """On a card tensor (the meta device stands in) the stride-2 wrapper
    raises for what the kernel does not take."""
    C, W = args.get("C", 64), args.get("W", 16)
    x = torch.empty(2, 16, W, C, device="meta")
    kern = torch.empty(3, 3, C, 32, device="meta")
    with pytest.raises(ValueError, match=msg):
        tq.int8_conv_static(x, kern, None, torch.empty(C, device="meta"),
                            strides=(2, 2), padding=args.get("pad", VALID))
