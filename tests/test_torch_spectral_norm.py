"""The spectral-norm IGEBM of the port against flax's ``nn.SpectralNorm``
(``dxmi_tpu.models.igebm`` with ``use_spectral_norm=True``) on the CPU: the
forward, the parameters' gradient, ``u`` and ``sigma`` after a forward
under ``update_sn_stats`` and unchanged without it (1e-6 of the scale),
the ``sn_stats`` tree both ways, and the bf16 torso."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dxmi_tpu.models.igebm import IGEBMEncoder as JIGEBM
from dxmi_tpu_torch.models.igebm import IGEBMEncoder, update_sn_stats
from dxmi_tpu_torch.utils.convert import module_from_flax
from dxmi_tpu_torch.utils.train_state import flax_tree, sn_buffers

CASES = {"sum_pool": dict(nh=8, keepdim=False, learn_out_scale=True),
         "class_film": dict(nh=8, n_class=3)}


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _pair(case, seed=0):
    kw = CASES[case]
    jm = JIGEBM(use_spectral_norm=True, **kw)
    x = np.random.RandomState(seed).randn(3, 16, 16, 3).astype(np.float32)
    y = np.array([0, 2, 1]) if "n_class" in kw else None
    args = (jnp.asarray(x),) if y is None else (jnp.asarray(x), y)
    v = jm.init(jax.random.key(seed), *args)
    tm = IGEBMEncoder(use_spectral_norm=True, **kw)
    tm.load_state_dict(module_from_flax(tm, _np(v["params"]),
                                        _np(v["sn_stats"])))
    targs = (torch.from_numpy(x.transpose(0, 3, 1, 2)),) + (
        () if y is None else (torch.from_numpy(y),))
    return jm, v, args, tm, targs


def _close(a, b, what, rel=1e-6):
    a, b = np.asarray(a), np.asarray(b)
    np.testing.assert_allclose(a, b, rtol=0,
                               atol=rel * max(np.abs(b).max(), 1.0),
                               err_msg=what)


def _stats_equal(tm, stats, rel=1e-6):
    want = module_from_flax(tm, _np(stats["params"]), _np(stats["sn_stats"]))
    for key, t in sn_buffers(tm):
        _close(t.numpy(), want[key].numpy(), key, rel)


@pytest.mark.parametrize("case", list(CASES))
def test_forward_and_stats_match_flax(case):
    jm, v, args, tm, targs = _pair(case)
    with torch.no_grad():
        out = tm(*targs).numpy()
    _close(out, jm.apply(v, *args), "forward")
    _stats_equal(tm, v)  # a forward outside update_sn_stats stores nothing
    ref, mut = jm.apply(v, *args, update_sn_stats=True,
                        mutable=["sn_stats"])
    with torch.no_grad(), update_sn_stats(tm):
        out = tm(*targs).numpy()
    _close(out, ref, "forward with update")
    _stats_equal(tm, {"params": v["params"], "sn_stats": mut["sn_stats"]})
    # a second update iterates again from the stored u, as flax's
    ref2, mut2 = jm.apply({"params": v["params"], **mut}, *args,
                          update_sn_stats=True, mutable=["sn_stats"])
    with torch.no_grad(), update_sn_stats(tm):
        _close(tm(*targs).numpy(), ref2, "second update")
    _stats_equal(tm, {"params": v["params"], "sn_stats": mut2["sn_stats"]})
    assert not tm.update_sn


@pytest.mark.parametrize("case", list(CASES))
def test_gradient_matches_flax(case):
    """The gradient flows through sigma (u and v stopped): every
    parameter's gradient of the summed output within 1e-6 of its scale."""
    jm, v, args, tm, targs = _pair(case, seed=1)
    g = jax.grad(lambda p: jm.apply({"params": p, "sn_stats": v["sn_stats"]},
                                    *args).sum())(v["params"])
    tm(*targs).sum().backward()
    want = module_from_flax(tm, _np(g))
    for k, p in tm.named_parameters():
        _close(p.grad.numpy(), want[k].numpy(), k)


def test_sn_stats_tree_both_ways():
    """The buffers carry flax's ``sn_stats`` names: the port's tree is
    JAX's, leaf for leaf, and the converter refuses a tree without them."""
    jm, v, args, tm, _ = _pair("sum_pool")
    back = flax_tree(tm, stats=True)
    flat = jax.tree_util.tree_flatten_with_path(_np(v["sn_stats"]))[0]
    assert len(flat) == len(sn_buffers(tm)) == 2 * (1 + 3 + 2 + 3 + 2 + 3
                                                    + 2)
    for path, a in flat:
        node = back
        for k in path:
            node = node[k.key]
        np.testing.assert_array_equal(node, a)
    with pytest.raises(KeyError):
        module_from_flax(tm, _np(v["params"]), {})
    assert not sn_buffers(IGEBMEncoder(nh=8))


def test_bf16_torso_normalises_in_fp32():
    """In bf16 the normalised kernels are computed in fp32 and cast where
    used (flax's SpectralNorm returns the parameters' dtype): against the
    JAX bf16 encoder within its own bf16 effect."""
    kw = CASES["sum_pool"]
    jm = JIGEBM(use_spectral_norm=True, dtype=jnp.bfloat16, **kw)
    x = np.random.RandomState(2).randn(3, 16, 16, 3).astype(np.float32)
    v = jm.init(jax.random.key(2), jnp.asarray(x))
    ref = np.asarray(jm.apply(v, jnp.asarray(x)), np.float32)
    ref32 = np.asarray(JIGEBM(use_spectral_norm=True, **kw).apply(
        v, jnp.asarray(x)))
    tm = IGEBMEncoder(use_spectral_norm=True, dtype=torch.bfloat16, **kw)
    tm.load_state_dict(module_from_flax(tm, _np(v["params"]),
                                        _np(v["sn_stats"])))
    with torch.no_grad():
        out = tm(torch.from_numpy(x.transpose(0, 3, 1, 2))).float().numpy()
    effect = np.abs(ref - ref32).max()
    assert np.abs(out - ref).max() <= 2 * effect + 1e-6, (out, ref, effect)
