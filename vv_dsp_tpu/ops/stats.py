"""Statistics & elementwise core math (reference: src/core/core.c, stats.c).

The reference's scalar loops with double accumulators (e.g. Kahan sum in
src/core/core.c:44-53, Welford variance, one-pass skew/kurtosis in
src/core/stats.c:61-104) become vectorized jnp reductions. Accuracy idiom:
reductions accumulate in float32; the parity tolerances (1e-4 for
stats, python/test_stats.py:13) hold for the test signal scales. All
functions reduce over the last axis and batch over leading axes.
"""

from __future__ import annotations

import jax.numpy as jnp

from vv_dsp_tpu.ops.fft import rfft, irfft


# ---- basic reductions (src/core/core.c:10-137) ----

def sum_(x, axis=-1):
    return jnp.sum(x, axis=axis)


def mean(x, axis=-1):
    return jnp.mean(x, axis=axis)


def var(x, axis=-1):
    """Population variance (Welford in the reference -> same value)."""
    return jnp.var(x, axis=axis)


def minimum(x, axis=-1):
    return jnp.min(x, axis=axis)


def maximum(x, axis=-1):
    return jnp.max(x, axis=axis)


def argmin(x, axis=-1):
    return jnp.argmin(x, axis=axis)


def argmax(x, axis=-1):
    return jnp.argmax(x, axis=axis)


def cumsum(x, axis=-1):
    return jnp.cumsum(x, axis=axis)


def diff(x, axis=-1):
    return jnp.diff(x, axis=axis)


def clamp(x, lo, hi):
    return jnp.clip(x, lo, hi)


# ---- advanced stats (src/core/stats.c) ----

def rms(x, axis=-1):
    """sqrt(mean(x^2)) (src/core/stats.c:10-19)."""
    return jnp.sqrt(jnp.mean(jnp.square(x), axis=axis))


def peak(x, axis=-1):
    """(min, max) tuple (vv_dsp_peak, src/core/stats.c:21-32)."""
    return jnp.min(x, axis=axis), jnp.max(x, axis=axis)


def crest_factor(x, axis=-1):
    """max(|x|) / rms (src/core/stats.c:34-46); rms==0 -> inf."""
    mn, mx = peak(x, axis=axis)
    pk = jnp.maximum(mx, -mn)
    r = rms(x, axis=axis)
    return jnp.where(r == 0, jnp.inf, pk / jnp.where(r == 0, 1.0, r))


def zero_crossing_count(x, axis=-1):
    """Strict sign-change count: a>0,b<0 or a<0,b>0 (src/core/stats.c:48-59).

    A zero sample breaks both conditions, exactly like the reference.
    """
    a = jnp.moveaxis(x, axis, -1)[..., :-1]
    b = jnp.moveaxis(x, axis, -1)[..., 1:]
    c = ((a > 0) & (b < 0)) | ((a < 0) & (b > 0))
    return jnp.sum(c.astype(jnp.int32), axis=-1)


def _central_moments(x, axis=-1):
    mu = jnp.mean(x, axis=axis, keepdims=True)
    d = x - mu
    m2 = jnp.mean(jnp.square(d), axis=axis)
    m3 = jnp.mean(d ** 3, axis=axis)
    m4 = jnp.mean(d ** 4, axis=axis)
    return m2, m3, m4


def skewness(x, axis=-1):
    """m3 / var^1.5, zero if var <= 0 (src/core/stats.c:61-80)."""
    m2, m3, _ = _central_moments(x, axis=axis)
    safe = jnp.where(m2 > 0, m2, 1.0)
    return jnp.where(m2 > 0, m3 / safe ** 1.5, 0.0)


def kurtosis(x, axis=-1):
    """Excess kurtosis m4 / var^2 - 3 (src/core/stats.c:82-104)."""
    m2, _, m4 = _central_moments(x, axis=axis)
    safe = jnp.where(m2 > 0, m2, 1.0)
    return jnp.where(m2 > 0, m4 / (safe * safe) - 3.0, 0.0)


def _next_pow2(v: int) -> int:
    n = 1
    while n < v:
        n <<= 1
    return n


def autocorrelation(x, max_lag: int, biased: bool = False):
    """r[k] = sum_i x[i] x[i+k] for k in [0, max_lag], via rFFT.

    biased: divide by n; unbiased: divide by the overlap count n-k
    (vv_dsp_autocorrelation, src/core/stats.c:106-122). Returns
    (..., max_lag+1).
    """
    n = x.shape[-1]
    nfft = _next_pow2(2 * n)
    spec = rfft(x, nfft)
    r = irfft(spec * jnp.conj(spec), nfft)[..., : max_lag + 1]
    lags = jnp.arange(max_lag + 1, dtype=x.dtype)
    if biased:
        return r / n
    count = jnp.maximum(n - lags, 1.0)
    return jnp.where(lags < n, r / count, 0.0)


def cross_correlation(x, y, max_lag: int):
    """r[k] = mean over overlap of x[i] * y[i+k], k in [0, max_lag]
    (vv_dsp_cross_correlation, src/core/stats.c:124-139: normalized by the
    overlap count)."""
    nx, ny = x.shape[-1], y.shape[-1]
    nfft = _next_pow2(nx + ny)
    spec = jnp.conj(rfft(x, nfft)) * rfft(y, nfft)
    r = irfft(spec, nfft)[..., : max_lag + 1]
    lags = jnp.arange(max_lag + 1)
    count = jnp.minimum(nx, ny - lags)
    safe = jnp.maximum(count, 1).astype(x.dtype)
    return jnp.where(count > 0, r / safe, 0.0)


def kahan_sum(x, axis=-1):
    """Compensated (Kahan) summation (vv_dsp_sum uses Kahan compensation,
    src/core/core.c:44-53). XLA's default reduction is pairwise — already
    O(sqrt(n)) better error than naive — but Kahan gives O(1) error growth
    for very long streaming accumulations; implemented as a lax.scan over
    128-lane chunks so the running compensation stays vectorized."""
    from jax import lax

    x = jnp.moveaxis(x, axis, -1)
    n = x.shape[-1]
    lanes = 128
    pad = (-n) % lanes
    if pad:
        x = jnp.concatenate([x, jnp.zeros(x.shape[:-1] + (pad,), x.dtype)],
                            axis=-1)
    chunks = x.reshape(x.shape[:-1] + (-1, lanes))
    chunks = jnp.moveaxis(chunks, -2, 0)  # (n_chunks, ..., lanes)

    def step(carry, c):
        s, comp = carry
        y = c - comp
        t = s + y
        comp = (t - s) - y
        return (t, comp), None

    zero = jnp.zeros(chunks.shape[1:], x.dtype)
    (s, comp), _ = lax.scan(step, (zero, zero), chunks)
    return jnp.sum(s - comp, axis=-1)
