"""Envelope extraction: real cepstrum, minimum phase, LPC
(reference: src/envelope/{cepstrum,minphase,lpc}.c).

Semantics preserved:
- real cepstrum: IFFT(log(|FFT(x)| + 1e-12)).real (cepstrum.c:7-39),
- inverse cepstrum / min-phase: causal cepstrum window {c0, 2*c[1..n/2-1],
  0 at Nyquist, zeros} -> FFT -> exp(real part) -> (IFFT for time signal)
  (cepstrum.c:41-78, minphase.c:7-31; NB the reference exponentiates only the
  real part, producing a zero-phase magnitude envelope — preserved bug-for-bug
  with a `full_complex=False` default and the mathematically-complete variant
  behind the flag),
- LPC: autocorrelation (lpc.c:7-16) + Levinson-Durbin (lpc.c:18-41) with the
  reference's sign convention (A(z) = 1 + sum a_m z^-m, k = -acc/e), and the
  LP spectrum magnitude gain/|1 - sum a_m e^{jm theta}| (lpc.c:55-72).

Design: cepstrum/min-phase are FFT->pointwise->FFT chains (fused by
XLA); Levinson is an order-static unrolled recursion of vectorized updates —
order is small (<=32) so the O(p^2) work is negligible and stays on device,
batched over leading axes.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from vv_dsp_tpu import config
from vv_dsp_tpu.ops import fft as _fft


def cepstrum_real(x):
    """Real cepstrum of (..., n) (vv_dsp_cepstrum_real).

    Universal FFT dispatch (ops.fft), matching the reference's single
    plan vtable (src/envelope/cepstrum.c:20-35 -> src/spectral/fft.c).
    Real input factors through the half-cost r2c/c2r tiers: log|FFT| of a
    real signal is real and Hermitian-symmetric, so
    ifft(log|fft(x)|).real == irfft(log|rfft(x)|) exactly."""
    import jax as _jax

    if jnp.iscomplexobj(x):
        spec = _fft.fft(x)
        logmag = jnp.log(jnp.abs(spec) + 1e-12)
        return _fft.ifft(logmag.astype(spec.dtype)).real
    n = x.shape[-1]
    dt = _fft._real_compute_dtype(x)
    xs = _fft.rfft(x.astype(dt))
    logmag = jnp.log(jnp.abs(xs) + 1e-12)
    return _fft.irfft(_jax.lax.complex(logmag, jnp.zeros_like(logmag)), n)


def _causal_cepstrum_window(c):
    """{c0, 2c1..c_{n/2-1}, 0 @ Nyquist (even n), 0...} (cepstrum.c:55-60)."""
    n = c.shape[-1]
    w = np.zeros(n, dtype=np.float64)
    w[0] = 1.0
    nh = n // 2
    w[1:nh] = 2.0
    # Nyquist (even n) and the upper half stay zero.
    return c * jnp.asarray(w, dtype=c.dtype)


def minphase_spectrum_from_cepstrum(c, full_complex: bool = False):
    """Min-phase spectrum exp(FFT(causal-windowed cepstrum))
    (vv_dsp_minphase_from_cepstrum, minphase.c:7-31).

    full_complex=False reproduces the reference exactly: it exponentiates only
    Re(H) and zeroes the phase, yielding the magnitude envelope. True gives the
    mathematically complete min-phase spectrum exp(H).
    """
    cw = _causal_cepstrum_window(c)
    H = _fft.fft(cw.astype(config.complex_for_real(c.dtype)))
    if full_complex:
        return jnp.exp(H)
    return jnp.exp(H.real).astype(H.dtype)


def icepstrum_minphase(c, full_complex: bool = False):
    """Min-phase time signal from a real cepstrum
    (vv_dsp_icepstrum_minphase, cepstrum.c:41-78)."""
    spec = minphase_spectrum_from_cepstrum(c, full_complex)
    return _fft.ifft(spec).real


def autocorr(x, order: int):
    """r[k] = sum_i x[i] x[i+k], k in [0, order] (vv_dsp_autocorr, lpc.c:7-16)."""
    from vv_dsp_tpu.ops.stats import autocorrelation

    n = x.shape[-1]
    # unnormalized: autocorrelation() divides, so undo; direct small-k einsum
    # is cheaper for small order but FFT path is uniform.
    r = autocorrelation(x, order, biased=True) * n
    return r


def levinson(r, order: int):
    """Levinson-Durbin (vv_dsp_levinson, lpc.c:18-41).

    r: (..., order+1) autocorrelation. Returns (a, err): a is (..., order+1)
    with a[0] = 1 and A(z) = 1 + sum_{m>=1} a_m z^-m; err is the final
    prediction error. Order-static unrolled recursion, batched.
    """
    dt = r.dtype
    e = r[..., 0]
    # r[0] == 0 (silent input): the reference rejects this with an error
    # status (lpc.c:25, e <= 0). Functionally we zero the reflection
    # coefficients instead of emitting NaNs; a, err come out all-zero.
    degenerate = e <= 0
    a = [jnp.ones_like(e)] + [jnp.zeros_like(e) for _ in range(order)]
    for m in range(1, order + 1):
        acc = r[..., m]
        for i in range(1, m):
            acc = acc + a[i] * r[..., m - i]
        k = jnp.where(degenerate, 0.0, -acc / jnp.where(degenerate, 1.0, e))
        new_a = list(a)
        new_a[m] = k
        for i in range(1, m):
            new_a[i] = a[i] + k * a[m - i]
        a = new_a
        e = e * (1.0 - k * k)
    return jnp.stack(a, axis=-1).astype(dt), e.astype(dt)


def lpc(x, order: int):
    """Autocorrelation-method LPC (vv_dsp_lpc, lpc.c:43-53)."""
    r = autocorr(x, order)
    return levinson(r, order)


def lpspec(a, gain, nfft: int):
    """LP magnitude envelope |gain / (1 - sum_m a_m e^{j m theta_k})| at nfft
    points (vv_dsp_lpspec, lpc.c:55-72; a includes a[0]=1 which is skipped)."""
    order = a.shape[-1] - 1
    k = np.arange(nfft, dtype=np.float64)
    m = np.arange(1, order + 1, dtype=np.float64)
    theta = 2.0 * np.pi * k / nfft
    cos_t = jnp.asarray(np.cos(m[None, :] * theta[:, None]), dtype=a.dtype)
    sin_t = jnp.asarray(np.sin(m[None, :] * theta[:, None]), dtype=a.dtype)
    am = a[..., 1:]
    re = 1.0 - jnp.einsum("...m,km->...k", am, cos_t,
                          precision=config.MATMUL_PRECISION)
    im = -jnp.einsum("...m,km->...k", am, sin_t,
                     precision=config.MATMUL_PRECISION)
    den = jnp.sqrt(re * re + im * im)
    gain = jnp.asarray(gain, dtype=den.dtype)
    return jnp.where(den > 0, gain[..., None] / jnp.where(den > 0, den, 1.0), 0.0)
