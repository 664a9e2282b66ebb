"""Analytic signal, instantaneous phase & frequency
(reference: src/spectral/hilbert.c).

Design: the analytic signal is ifft(fft(x) * mask) with the
one-sided doubling mask baked as a constant; instantaneous phase replaces the
reference's sequential accumulation loop (src/spectral/hilbert.c:82-92) with a
vectorized conj-product angle + cumulative sum — identical numerics (the
per-step wrap-free increments are computed independently, then cumsum'd).

Mask semantics (src/spectral/hilbert.c:47-59):
  even N: keep DC and Nyquist, double bins 1..N/2-1, zero negatives;
  odd  N: keep DC, double bins 1..(N-1)/2, zero negatives.
"""

from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp

from vv_dsp_tpu.ops import fft as _fft


def _analytic_mask(n: int) -> np.ndarray:
    h = np.zeros(n, dtype=np.float64)
    h[0] = 1.0
    if n % 2 == 0:
        h[1 : n // 2] = 2.0
        h[n // 2] = 1.0
    else:
        h[1 : (n + 1) // 2] = 2.0
    return h


@functools.lru_cache(maxsize=32)
def _hilbert_mult(n: int):
    """One-sided multiplier s with H[x] = irfft(-i * s * rfft(x)): s = 1 on
    strictly-positive non-Nyquist bins, 0 at DC (and Nyquist for even n) —
    the rfft/irfft factorization of the reference's two-sided mask
    (src/spectral/hilbert.c:47-59): ifft(fft(x) * mask) == x + i*H[x]
    exactly, but runs as TWO half-cost REAL transforms instead of full c2c
    forward + Hermitian expand + full c2c inverse."""
    s = np.zeros(n // 2 + 1, dtype=np.float64)
    s[1: (n + 1) // 2] = 1.0
    return s


def _hilbert_pair(x):
    """(x_f32, H[x]) for real input through the r2c/c2r fast tiers."""
    n = x.shape[-1]
    dt = _fft._real_compute_dtype(x)
    x = x.astype(dt)
    xs = _fft.rfft(x)
    s = jnp.asarray(_hilbert_mult(n), dtype=dt)
    # -i * (re + i*im) * s = (im * s) + i * (-re * s)
    y = jax.lax.complex(jnp.imag(xs) * s, -jnp.real(xs) * s)
    return x, _fft.irfft(y, n)


def hilbert_analytic(x):
    """Analytic signal z = x + j*H[x] of (..., n) real -> complex.

    All transforms go through the universal dispatch (ops.fft) like every
    transform consumer in the reference goes through the one plan vtable
    (src/spectral/fft.c:95-124): honors set_fft_backend + fast tiers."""
    n = x.shape[-1]
    if jnp.iscomplexobj(x):
        mask = jnp.asarray(_analytic_mask(n), dtype=jnp.real(x).dtype)
        return _fft.ifft(_fft.fft(x) * mask)
    xr, h = _hilbert_pair(x)
    return jax.lax.complex(xr, h)


def instantaneous_phase(z):
    """Continuous phase via conj-product increments
    (vv_dsp_instantaneous_phase, src/spectral/hilbert.c:77-93)."""
    phi0 = jnp.angle(z[..., :1])
    dphi = jnp.angle(z[..., 1:] * jnp.conj(z[..., :-1]))
    return jnp.concatenate([phi0, phi0 + jnp.cumsum(dphi, axis=-1)], axis=-1)


def instantaneous_frequency(phase, fs: float):
    """Hz from unwrapped phase; out[0] = 0
    (vv_dsp_instantaneous_frequency, src/spectral/hilbert.c:95-113)."""
    scale = fs / (2.0 * np.pi)
    d = jnp.diff(phase, axis=-1) * scale
    zero = jnp.zeros_like(d[..., :1])
    return jnp.concatenate([zero, d], axis=-1)


def envelope(x):
    """|analytic| amplitude envelope; real input never materializes the
    complex analytic signal (|z| = sqrt(x^2 + H[x]^2))."""
    if jnp.iscomplexobj(x):
        return jnp.abs(hilbert_analytic(x))
    xr, h = _hilbert_pair(x)
    return jnp.sqrt(xr * xr + h * h)
