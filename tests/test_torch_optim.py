"""The port's optimizer rules against optax (the JAX trainers' own): Adam,
RAdam (through its un-adapted first steps and past rho_t = 5), the
global-norm clip and apply_if_finite; and why torch.optim.RAdam is not used:
on gradients near eps it steps differently."""
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dxmi_tpu_torch.trainers.optim import (Adam, ApplyIfFinite, RAdam,
                                           clip_by_global_norm, global_norm)


def _grads(n_steps, shape, scale, seed):
    rs = np.random.RandomState(seed)
    return [(rs.randn(*shape) * scale).astype(np.float32)
            for _ in range(n_steps)]


def _optax_run(tx, p0, grads):
    p = jnp.asarray(p0)
    state = tx.init(p)
    out = []
    for g in grads:
        u, state = tx.update(jnp.asarray(g), state, p)
        p = optax.apply_updates(p, u)
        out.append(np.asarray(p))
    return out


def _port_run(cls, lr, p0, grads):
    p = torch.from_numpy(p0.copy())
    opt = cls([p], lr)
    out = []
    for g in grads:
        opt.step([torch.from_numpy(g)])
        out.append(p.numpy().copy())
    return out


@pytest.mark.parametrize("scale", [1.0, 1e-3, 1e-8])
@pytest.mark.parametrize("cls,tx", [(Adam, optax.adam), (RAdam, optax.radam)])
def test_rule_matches_optax(cls, tx, scale):
    """12 steps (RAdam: the bias-corrected momentum until rho_t reaches 5 at
    step 6, the rectified step after), gradients of three magnitudes, the
    last near eps: every iterate within 1e-5 relative plus four fp32 ulps of
    the largest parameter (an iterate near zero carries the rounding of the
    larger terms that made it; 1.5e-7 at |p0| up to 2.2 measured: XLA and
    torch round a few operations of the update apart). The step's scalars
    follow optax's fp32 rounding: in float64, RAdam's rectification would
    move the first rectified step by ~1%."""
    lr = 1e-2
    p0 = np.random.RandomState(0).randn(7, 5).astype(np.float32)
    grads = _grads(12, (7, 5), scale, 1)
    for a, b in zip(_port_run(cls, lr, p0, grads),
                    _optax_run(tx(lr), p0, grads)):
        np.testing.assert_allclose(a, b, rtol=1e-5,
                                   atol=2.0 ** -21 * np.abs(p0).max())


def test_torch_radam_differs_on_small_gradients():
    """torch.optim.RAdam adds eps to sqrt(v) before the bias correction;
    optax adds it to sqrt(v_hat). With gradients near eps the two rules
    part at the first rectified step (step 6), while the port's rule stays
    on optax's."""
    lr = 1e-2
    p0 = np.zeros((4, 4), np.float32)
    grads = _grads(8, (4, 4), 1e-8, 2)
    want = _optax_run(optax.radam(lr), p0, grads)
    ours = _port_run(RAdam, lr, p0, grads)
    p = torch.zeros(4, 4, requires_grad=True)
    opt = torch.optim.RAdam([p], lr=lr)
    theirs = []
    for g in grads:
        p.grad = torch.from_numpy(g)
        opt.step()
        theirs.append(p.detach().numpy().copy())
    np.testing.assert_allclose(ours[-1], want[-1], rtol=1e-5, atol=1e-12)
    gap = np.abs(theirs[-1] - want[-1]).max()
    assert gap > 0.1 * np.abs(want[-1] - want[4]).max(), gap


def test_clip_by_global_norm_matches_optax():
    grads = [torch.randn(3, 4) * 3, torch.randn(5)]
    jg = [jnp.asarray(g.numpy()) for g in grads]
    for max_norm in (0.1, 1e3):
        want, _ = optax.clip_by_global_norm(max_norm).update(jg, None)
        for a, b in zip(clip_by_global_norm(grads, max_norm), want):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6)
    np.testing.assert_allclose(float(global_norm(grads)),
                               float(optax.global_norm(jg)), rtol=1e-6)


def test_apply_if_finite_matches_optax():
    """Non-finite gradients are skipped (parameters and state unchanged) and
    counted; after more than max_consecutive_errors skips in a row the
    update goes through, as optax.apply_if_finite does."""
    lr, limit = 1e-2, 2
    p0 = np.ones(3, np.float32)
    finite = np.array([0.5, -1.0, 2.0], np.float32)
    bad = np.array([np.nan, 1.0, 1.0], np.float32)
    seq = [finite, bad, bad, bad, finite, bad, finite]
    want = _optax_run(optax.apply_if_finite(optax.adam(lr), limit), p0, seq)
    p = torch.from_numpy(p0.copy())
    guard = ApplyIfFinite([Adam([p], lr)], limit)
    applied = []
    for g, w in zip(seq, want):
        applied.append(guard.step([[torch.from_numpy(g)]]))
        np.testing.assert_allclose(p.numpy(), w, rtol=1e-6, equal_nan=True)
    assert applied == [True, False, False, True, True, False, True]
    assert guard.total_notfinite == 4
