"""Savitzky-Golay smoothing / differentiation (reference: src/filter/savgol.c).

Semantics preserved:
- kernel: least-squares polynomial fit on centered indices, evaluated at the
  window center; derivative kernels scaled by deriv!/delta^deriv
  (sg_smoothing_kernel / sg_derivative_kernel, src/filter/savgol.c:28-162);
  polyorder <= 15, window_length odd and <= 257 like the reference limits.
- application: pad by window//2 per boundary mode, then *correlation* (no
  kernel flip — convolve_valid, src/filter/savgol.c:205-217).
- boundary modes (pad_signal, src/filter/savgol.c:164-203):
    REFLECT  : mirror about the edge SAMPLE excluded — left x[1], x[2], ...
               (scipy's 'mirror')
    CONSTANT : edge value replicate (NB: the reference implements CONSTANT
               identically to NEAREST — both replicate the edge sample)
    NEAREST  : edge value replicate
    WRAP     : circular
- NaN policy applied to input and output (src/filter/savgol.c:237-286).

Design: the kernel is solved host-side in float64 with a numerically
superior lstsq (vs the reference's Gaussian elimination on normal equations);
the apply is one batched conv on device.
"""

from __future__ import annotations

import functools
import math as _math

import numpy as np
import jax.numpy as jnp
from jax import lax

from vv_dsp_tpu import config
from vv_dsp_tpu.utils.nan_policy import NanPolicy, apply_nan_policy

MODES = ("reflect", "constant", "nearest", "wrap")


@functools.lru_cache(maxsize=128)
def savgol_coeffs_np(window_length: int, polyorder: int, deriv: int = 0,
                     delta: float = 1.0) -> np.ndarray:
    """Correlation weights w so that y[n] = sum_k w[k] x[n - half + k]."""
    if window_length <= 0 or window_length % 2 == 0:
        raise ValueError("window_length must be odd and positive")
    if polyorder >= window_length or polyorder > 15:
        raise ValueError("polyorder must be < window_length and <= 15")
    if deriv > polyorder:
        return np.zeros(window_length, dtype=np.float64)
    half = window_length // 2
    t = np.arange(-half, half + 1, dtype=np.float64)
    A = np.vander(t, polyorder + 1, increasing=True)  # A[r, j] = t_r^j
    # weights = the minimum-norm solution of A^T w = deriv! * e_deriv (the
    # LS projector row). Solved via SVD lstsq on A^T DIRECTLY — forming the
    # normal equations (A^T A) squares the condition number and loses ~6
    # digits already at window 79 / polyorder 5 (1e-1 coefficient error).
    e = np.zeros(polyorder + 1)
    e[deriv] = float(_math.factorial(deriv))
    w, *_ = np.linalg.lstsq(A.T, e, rcond=None)
    if deriv == 0:
        s = w.sum()
        if s != 0.0:
            w = w / s  # reference's numerical safeguard (savgol.c:158)
    else:
        w = w / (delta ** deriv)
    return w


def _pad(x, pad: int, mode: str):
    if pad == 0:
        return x
    n = x.shape[-1]
    if mode == "reflect":  # scipy 'mirror': exclude the edge sample
        left = x[..., 1 : pad + 1][..., ::-1]
        right = x[..., n - 1 - pad : n - 1][..., ::-1]
    elif mode in ("constant", "nearest"):
        left = jnp.repeat(x[..., :1], pad, axis=-1)
        right = jnp.repeat(x[..., -1:], pad, axis=-1)
    elif mode == "wrap":
        left = x[..., -pad:]
        right = x[..., :pad]
    else:
        raise ValueError(f"mode must be one of {MODES}")
    return jnp.concatenate([left, x, right], axis=-1)


def savgol_filter(x, window_length: int, polyorder: int, deriv: int = 0,
                  delta: float = 1.0, mode: str = "reflect",
                  nan_policy: NanPolicy = NanPolicy.PROPAGATE):
    """Savitzky-Golay filter over the last axis (vv_dsp_savgol,
    src/filter/savgol.c:220-287)."""
    x = config.as_compute(x)
    if window_length > 257:
        raise ValueError("window_length must be <= 257 (reference limit)")
    if window_length // 2 > x.shape[-1] - 1:
        raise ValueError(
            f"window_length // 2 = {window_length // 2} exceeds len(x)-1 = "
            f"{x.shape[-1] - 1}; padding cannot be constructed (scipy raises "
            "the same)")
    x = apply_nan_policy(x, nan_policy)
    w = jnp.asarray(savgol_coeffs_np(window_length, polyorder, deriv, delta),
                    dtype=x.dtype)
    xp = _pad(x, window_length // 2, mode)
    batch_shape = xp.shape[:-1]
    xb = xp.reshape((-1, 1, xp.shape[-1]))
    # Correlation (no flip), 'valid'.
    kern = w.reshape((1, 1, window_length))
    y = lax.conv_general_dilated(
        xb, kern, window_strides=(1,), padding=[(0, 0)],
        dimension_numbers=("NCH", "OIH", "NCH"),
        precision=config.MATMUL_PRECISION,
    )
    y = y.reshape(batch_shape + (y.shape[-1],))
    return apply_nan_policy(y, nan_policy)
