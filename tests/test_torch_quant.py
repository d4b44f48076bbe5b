"""The port's int8 math (dxmi_tpu_torch.ops.quant) against dxmi_tpu.ops.quant
on the CPU, with numpy-seeded inputs. The quantisers, the static, dynamic and
matmul W8A8 convs (3x3 SAME and the 2x2 phase pads, fp32 and bf16 outputs)
give identical values: both sides keep the same operation order and the int8
sums are exact, so the tolerance is zero. The calibration quantile agrees to
rtol 1e-6 (one fp32 rounding of the interpolation). K8's plain version is
exact against a float64 convolution, and a QConv's calibrating pass records
the JAX QConv's scale."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from dxmi_tpu.ops import quant as jq
from dxmi_tpu.ops.phase_up import conv3x3_nearest_up2 as jax_phase_up
from dxmi_tpu_torch.ops import _lib
from dxmi_tpu_torch.ops import quant as tq
from dxmi_tpu_torch.ops.phase_up import (conv3x3_nearest_up2,
                                         prepare_phase_int8)

DTYPES = [(jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)]
PADS = [((1, 1), (1, 1)), ((1, 0), (1, 0)), ((1, 0), (0, 1)),
        ((0, 1), (1, 0)), ((0, 1), (0, 1))]


def _conv_inputs(seed, C=64, O=32, k=3):
    rs = np.random.RandomState(seed)
    x = (rs.randn(2, 8, 8, C) * 2 + 0.3).astype(np.float32)
    kern = (rs.randn(k, k, C, O) / np.sqrt(k * k * C)).astype(np.float32)
    b = (0.1 * rs.randn(O)).astype(np.float32)
    a = (0.01 + 0.05 * np.abs(rs.randn(C))).astype(np.float32)
    return x, kern, b, a


def _np(t):
    return np.asarray(t, np.float32)


def test_quantize_per_channel_equal():
    rs = np.random.RandomState(0)
    w = (rs.randn(3, 3, 64, 32) * 0.1).astype(np.float32)
    w[..., 5] = 0.0  # a dead channel: the 1e-8 floor
    wi, ws = jq.quantize_per_channel(jnp.asarray(w))
    ti, ts = tq.quantize_per_channel(torch.from_numpy(w))
    np.testing.assert_array_equal(np.asarray(wi), ti.numpy())
    np.testing.assert_array_equal(np.asarray(ws), ts.numpy())
    oi, os_ = tq.quantize_per_channel(torch.from_numpy(w).permute(3, 2, 0, 1),
                                      axis=0)
    np.testing.assert_array_equal(np.asarray(wi),
                                  oi.permute(2, 3, 1, 0).numpy())


def test_quantize_per_tensor_equal():
    x = (np.random.RandomState(1).randn(2, 8, 8, 16) * 3).astype(np.float32)
    xi, xs = jq.quantize_per_tensor(jnp.asarray(x))
    ti, ts = tq.quantize_per_tensor(torch.from_numpy(x))
    np.testing.assert_array_equal(np.asarray(xi), ti.numpy())
    assert float(xs) == float(ts)


@pytest.mark.parametrize("pad", PADS)
@pytest.mark.parametrize("jdt,tdt", DTYPES)
def test_int8_conv_static_equal(jdt, tdt, pad):
    x, kern, b, a = _conv_inputs(2)
    if pad[0] != (1, 1):
        kern = kern[:2, :2]
    ref = jq.int8_conv_static(jnp.asarray(x), jnp.asarray(kern),
                              jnp.asarray(b), jnp.asarray(a), padding=pad,
                              out_dtype=jdt)
    out = tq.int8_conv_static(torch.from_numpy(x), torch.from_numpy(kern),
                              torch.from_numpy(b), torch.from_numpy(a),
                              padding=pad, out_dtype=tdt)
    assert out.dtype == tdt
    np.testing.assert_array_equal(out.float().numpy(), _np(ref))


@pytest.mark.parametrize("jdt,tdt", DTYPES)
def test_int8_conv_static_scalar_scale_equal(jdt, tdt):
    x, kern, b, _ = _conv_inputs(3)
    ref = jq.int8_conv_static(jnp.asarray(x), jnp.asarray(kern),
                              jnp.asarray(b), jnp.float32(0.05),
                              out_dtype=jdt)
    out = tq.int8_conv_static(torch.from_numpy(x), torch.from_numpy(kern),
                              torch.from_numpy(b), torch.tensor(0.05),
                              out_dtype=tdt)
    np.testing.assert_array_equal(out.float().numpy(), _np(ref))


@pytest.mark.parametrize("jdt,tdt", DTYPES)
def test_int8_conv_dynamic_equal(jdt, tdt):
    x, kern, b, _ = _conv_inputs(4)
    ref = jq.int8_conv(jnp.asarray(x), jnp.asarray(kern), jnp.asarray(b),
                       out_dtype=jdt)
    out = tq.int8_conv(torch.from_numpy(x), torch.from_numpy(kern),
                       torch.from_numpy(b), out_dtype=tdt)
    np.testing.assert_array_equal(out.float().numpy(), _np(ref))


@pytest.mark.parametrize("jdt,tdt", DTYPES)
def test_int8_matmul_static_equal(jdt, tdt):
    rs = np.random.RandomState(5)
    x = rs.randn(2, 64, 64).astype(np.float32)
    w = (rs.randn(64, 96) / 8).astype(np.float32)
    b = (0.1 * rs.randn(96)).astype(np.float32)
    a = (0.01 + 0.05 * np.abs(rs.randn(64))).astype(np.float32)
    ref = jq.int8_matmul_static(jnp.asarray(x).astype(jdt), jnp.asarray(w),
                                jnp.asarray(b), jnp.asarray(a), out_dtype=jdt)
    out = tq.int8_matmul_static(torch.from_numpy(x).to(tdt),
                                torch.from_numpy(w), torch.from_numpy(b),
                                torch.from_numpy(a), out_dtype=tdt)
    assert out.shape == (2, 64, 96)
    np.testing.assert_array_equal(out.float().numpy(), _np(ref))


@pytest.mark.parametrize("jdt,tdt", DTYPES)
def test_phase_up_int8_equal(jdt, tdt):
    """The int8 mode of conv3x3_nearest_up2: phase kernels summed in fp32
    from the fp32 weight, four static int8 convs, bias added in the compute
    dtype after the interleave."""
    x, kern, b, a = _conv_inputs(6)
    ref = jax_phase_up(jnp.asarray(x).astype(jdt), jnp.asarray(kern),
                       jnp.asarray(b), jdt, jnp.asarray(a))
    xt = torch.from_numpy(x).to(tdt).permute(0, 3, 1, 2)
    w = torch.from_numpy(kern).permute(3, 2, 0, 1)
    bt = torch.from_numpy(b)
    out = conv3x3_nearest_up2(xt, w, bt, tdt, torch.from_numpy(a))
    assert out.dtype == tdt and out.shape == (2, 32, 16, 16)
    np.testing.assert_array_equal(out.permute(0, 2, 3, 1).float().numpy(),
                                  _np(ref))
    cached = conv3x3_nearest_up2(xt, w, bt, tdt,
                                 prepared=prepare_phase_int8(
                                     w, torch.from_numpy(a)))
    torch.testing.assert_close(cached, out, rtol=0, atol=0)


def test_calib_channel_scale():
    rs = np.random.RandomState(7)
    x = (rs.randn(1000, 48) * np.linspace(0.1, 3, 48)).astype(np.float32)
    ref = np.asarray(jq.calib_channel_scale(jnp.asarray(x)))
    out = tq.calib_channel_scale(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-6, atol=0)
    z = tq.calib_channel_scale(torch.zeros(10, 4))
    assert (z == 1e-8).all()


@pytest.mark.parametrize("pad", PADS + [((0, 0), (0, 0))])
def test_plain_k8_is_exact(pad):
    """K8's plain version sums the int8 products of each tap in float64;
    a float64 convolution of the same int8 values gives the same int32."""
    x, kern, b, a = _conv_inputs(8, C=32, O=16)
    k = 3 if pad[0] == (1, 1) else (1 if pad[0] == (0, 0) else 2)
    q = tq.prepare_conv_static(torch.from_numpy(kern[:k, :k]),
                               torch.from_numpy(a))
    out = tq.int8_conv_reference(torch.from_numpy(x), q, None, pad,
                                 torch.float32)
    xi = torch.clamp(torch.round(torch.from_numpy(x) * q.xscale), -127, 127)
    (pt, pb), (pl, pr) = pad
    acc = F.conv2d(F.pad(xi.double().permute(0, 3, 1, 2), (pl, pr, pt, pb)),
                   q.w_i8.double().permute(0, 3, 1, 2))
    want = acc.to(torch.int32).float() * q.dq[:, None, None]
    torch.testing.assert_close(out, want.permute(0, 2, 3, 1), rtol=0, atol=0)


def test_cpu_takes_the_plain_version_and_counts_nothing():
    _lib.reset_launches()
    x, kern, b, a = _conv_inputs(9)
    q = tq.prepare_conv_static(torch.from_numpy(kern), torch.from_numpy(a))
    out = tq.int8_conv_apply(torch.from_numpy(x), q, torch.from_numpy(b))
    ref = tq.int8_conv_reference(torch.from_numpy(x), q, torch.from_numpy(b),
                                 tq.SAME_3X3, torch.bfloat16)
    torch.testing.assert_close(out, ref, rtol=0, atol=0)
    assert not _lib.LAUNCHES


@pytest.mark.parametrize("args,exc,msg", [
    (dict(C=48), ValueError, "Cin % 32"),
    (dict(pad=((2, 0), (1, 1))), ValueError, "pads of at most 1"),
    (dict(pad=((1, 1), (0, 1))), ValueError, "keeps the input's size"),
    (dict(strides=(3, 3)), NotImplementedError, "stride")])
def test_forms_k8_does_not_take_raise(args, exc, msg):
    """On a card tensor (the meta device stands in: no arithmetic runs)
    the wrapper raises for what K8 does not take; strides other than 1 and
    2 raise anywhere."""
    C = args.get("C", 64)
    x = torch.empty(2, 8, 8, C, device="meta")
    kern = torch.empty(3, 3, C, 32, device="meta")
    with pytest.raises(exc, match=msg):
        tq.int8_conv_static(x, kern, None, torch.empty(C, device="meta"),
                            strides=args.get("strides", (1, 1)),
                            padding=args.get("pad", tq.SAME_3X3))


@pytest.mark.parametrize("static", [True, False])
def test_qconv_matches_jax_qconv(static):
    """A QConv's calibrating pass records the JAX QConv's act_scale and
    returns its full-precision conv; then the int8 forward (cached and
    per-call preparation alike) equals JAX's int8 apply."""
    rs = np.random.RandomState(10)
    x = (rs.randn(2, 8, 8, 32) * 1.5).astype(np.float32)
    m = jq.QConv(16, static_act=static, dtype=jnp.float32)
    v = m.init(jax.random.key(0), jnp.asarray(x))
    p = jax.tree.map(lambda a: a + 0.05 * jax.random.normal(
        jax.random.key(1), a.shape), v["params"])
    q = tq.QConv(32, 16, static_act=static, out_dtype=torch.float32)
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
        # identical scales for the int8 comparison
        q.act_scale.copy_(torch.from_numpy(
            np.asarray(upd["quant_scales"]["act_scale"])))
        variables["quant_scales"] = upd["quant_scales"]
    ref = np.asarray(m.apply(variables, jnp.asarray(x)))
    with torch.no_grad():
        per_call = q(xt)
        q.prepare_int8()
        cached = q(xt)
    np.testing.assert_array_equal(per_call.permute(0, 2, 3, 1).numpy(), ref)
    torch.testing.assert_close(cached, per_call, rtol=0, atol=0)


def test_qconv_int8_cache_follows_state_dict():
    """A QConv quantises its weights once, on its first int8 forward, and
    reuses them; loading a state dict (new scales or weights) drops that
    cache, so the next forward quantises from what was loaded and never
    from the stale operands."""
    x, kern, b, a = _conv_inputs(12, C=32, O=16)
    q = tq.QConv(32, 16, out_dtype=torch.float32)
    state = {"weight": torch.from_numpy(kern.transpose(3, 2, 0, 1).copy()),
             "bias": torch.from_numpy(b), "act_scale": torch.from_numpy(a)}
    q.load_state_dict(state)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).contiguous(
        memory_format=torch.channels_last)

    def fresh(sd):
        ref = tq.QConv(32, 16, out_dtype=torch.float32)
        ref.load_state_dict(sd)
        return tq.int8_conv_reference(
            xt.permute(0, 2, 3, 1), ref.quantise_int8(), ref.bias.float(),
            tq.SAME_3X3, torch.float32).permute(0, 3, 1, 2)

    with torch.no_grad():
        y0 = q(xt)
        cache = q._int8_cache
        assert cache is not None
        q(xt)
        assert q._int8_cache is cache
        torch.testing.assert_close(y0, fresh(state), rtol=0, atol=0)
        state2 = dict(state, act_scale=state["act_scale"] * 2.0)
        q.load_state_dict(state2)
        assert q._int8_cache is None
        y1 = q(xt)
        torch.testing.assert_close(y1, fresh(state2), rtol=0, atol=0)
        assert not torch.equal(y1, y0)
