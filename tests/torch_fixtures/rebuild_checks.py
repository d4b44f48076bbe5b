"""Limits for rebuilding the committed goldens from the JAX package on the
CPU of whatever host runs the tests, and for holding the port's int8 net
against JAX's.

XLA's CPU code orders fp32 sums by the host's vector width, so a golden
rebuilt on another host differs from the committed one at fp32 rounding.
That difference scales with the magnitude of the summands, not of the
result: a metric that is a difference of large terms (a squared residual of
the value net's outputs, an energy gap) moves by far more than its own
rounding. Each array is therefore held against the largest magnitude of its
family, the quantities computed together from the same terms:

- the value phase's per-step metrics (``metric/per_step/{v_loss, value,
  running_cost}``), its batch metrics (``metric/ebm/*``), the sampler
  phase's (``metric/sampler/*``), the value net's update (``vnorm/*`` and
  ``vproj/*``, sums over a tensor's elements of an update whose size is set
  by the net's largest), and every other array on its own (states, draws,
  schedules);
- within FP32_REL = 2^-16 (256 units of fp32 rounding) of that largest.
  On one host against the committed goldens: 60 units in the ADM iteration
  (``metric/per_step/v_loss`` at step 7, a squared residual of 11 against
  values of 27), 37 in its value update, 4 in the CIFAR one; 0 on the host
  that wrote them. 2^-16 stays 65x below G3's metric limit of 1e-3;
- the sampler's update (``snorm/*``, ``sproj/*``) within SAMPLER_REL =
  2^-7 of the net's largest tensor update: RAdam's rectified steps are about
  lr per element whatever the gradient, so an element whose gradient sits
  at the fp32 noise floor steps with a host-dependent sign, and a small
  tensor's own update is not reproducible (a bias's projection moved by
  3.7x of itself). Measured 1.5e-3 (ADM) and 9.7e-4 (CIFAR) of the largest;
  G3 allows 1e-2 of it plus 5% of each.

The int8 goldens compound nothing: ``make_adm_int8_golden.build(teacher=
golden)`` runs each step with the golden's scales from the golden's own
state, so a value at an int8 rounding boundary that flips under fp32 noise
moves that step only (one step in ten moved a quarter of its elements, by
up to 3% of the step's largest, on one host). A flip moves a minority of the
elements, so each step's median error is held within FP32_REL of the
step's largest; the calibrated scales (quantiles of activations) within
FP32_REL of each buffer's largest (3.2e-6 measured).
"""
from __future__ import annotations

import numpy as np

FP32_REL = 2.0 ** -16
SAMPLER_REL = 2.0 ** -7


def family(key: str) -> str:
    """The family an fp32 golden array is held against."""
    if key.startswith("metric/per_step/") and key.rsplit("/", 1)[1] in (
            "v_loss", "value", "running_cost"):
        return "metric/per_step"
    for prefix in ("metric/ebm/", "metric/sampler/"):
        if key.startswith(prefix):
            return prefix[:-1]
    if key.startswith(("vnorm/", "vproj/")):
        return "value update"
    if key.startswith(("snorm/", "sproj/")):
        return "sampler update"
    return key


def fp32_rebuild_shares(built: dict, golden: dict) -> dict:
    """Each array's largest error over its limit (a share above 1 fails)."""
    if set(built) != set(golden):
        raise AssertionError(f"keys differ: {set(built) ^ set(golden)}")
    scale: dict = {}
    for k, v in golden.items():
        f = family(k)
        scale[f] = max(scale.get(f, 0.0), float(np.abs(v).max()))
    shares = {}
    for k, v in golden.items():
        f = family(k)
        rel = SAMPLER_REL if f == "sampler update" else FP32_REL
        err = np.abs(np.asarray(built[k], np.float64)
                     - np.asarray(v, np.float64)).max()
        shares[k] = float(err) / (rel * max(scale[f], 1e-30))
    return shares


def check_fp32_rebuild(built: dict, golden: dict) -> float:
    """Raise if an array is over its limit; returns the worst share."""
    shares = fp32_rebuild_shares(built, golden)
    bad = {k: s for k, s in shares.items() if not s <= 1}
    if bad:
        raise AssertionError(f"over the rebuild limit: {bad}")
    return max(shares.values())


def median_share(a, ref) -> float:
    """The median error over FP32_REL of ref's largest."""
    err = np.abs(np.asarray(a, np.float64) - np.asarray(ref, np.float64))
    return float(np.median(err)) / (FP32_REL * float(np.abs(ref).max()))


def check_int8_rebuild(built: dict, golden: dict) -> None:
    """The teacher-forced int8 rebuild against the golden (see above)."""
    if set(built) != set(golden):
        raise AssertionError(f"keys differ: {set(built) ^ set(golden)}")
    if int(built["calib_seed"]) != int(golden["calib_seed"]):
        raise AssertionError("calibration seed differs")
    for k, v in golden.items():
        if k.startswith("scale/"):
            err = np.abs(built[k] - v).max()
            if not err <= FP32_REL * np.abs(v).max():
                raise AssertionError(f"{k}: {err:.3e} from the golden")
    steps = list(zip(built["means"], golden["means"]))
    steps.append((built["final"], golden["final"]))
    for i, (a, ref) in enumerate(steps):
        s = median_share(a, ref)
        if not s <= 1:
            raise AssertionError(f"int8 step {i}: median error at {s:.2f} "
                                 "of its limit")
