"""NaN/Inf handling policy as a functional transform.

Reference semantics: src/core/nan_policy.c:33-190 — a thread-local global policy
{PROPAGATE (default), IGNORE -> replace NaN/Inf with 0, ERROR -> return
VV_DSP_ERROR_NAN_INF, CLAMP -> NaN->0, +Inf->+FLT_MAX, -Inf->-FLT_MAX} applied
by DCT (src/spectral/dct.c:86-136) and Savitzky-Golay (src/filter/savgol.c:237-286)
to inputs and outputs.

Re-design: a global mutable policy is hostile to jit/functional
semantics, so the policy is an explicit argument on the ops that honor it
(``dct``, ``savgol``), defaulting to PROPAGATE. ERROR cannot raise from inside
a traced computation; under jit it degrades to debug-checkable semantics: the
output is poisoned with NaN wherever the input was non-finite (so the error is
observable) and callers running eagerly can use :func:`has_nan_or_inf` /
``jax.experimental.checkify`` for a hard failure.
"""

from __future__ import annotations

import enum

import jax.numpy as jnp


class NanPolicy(enum.Enum):
    PROPAGATE = "propagate"
    IGNORE = "ignore"
    ERROR = "error"
    CLAMP = "clamp"


def has_nan_or_inf(x) -> jnp.ndarray:
    """Scalar bool: any non-finite element (reference vv_dsp_has_nan_inf)."""
    return jnp.any(~jnp.isfinite(x))


def apply_nan_policy(x, policy: NanPolicy = NanPolicy.PROPAGATE):
    """Apply the NaN/Inf policy elementwise.

    PROPAGATE: identity. IGNORE: non-finite -> 0. CLAMP: NaN -> 0,
    +/-Inf -> +/-max_finite. ERROR: identity (caller checks has_nan_or_inf;
    non-finite values propagate and poison downstream results).
    """
    if policy in (NanPolicy.PROPAGATE, NanPolicy.ERROR):
        return x
    if policy == NanPolicy.IGNORE:
        return jnp.where(jnp.isfinite(x), x, jnp.zeros_like(x))
    if policy == NanPolicy.CLAMP:
        big = jnp.finfo(x.dtype).max
        out = jnp.where(jnp.isnan(x), jnp.zeros_like(x), x)
        out = jnp.where(jnp.isposinf(x), jnp.full_like(x, big), out)
        out = jnp.where(jnp.isneginf(x), jnp.full_like(x, -big), out)
        return out
    raise ValueError(f"unknown NaN policy: {policy!r}")
