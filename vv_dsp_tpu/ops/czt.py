"""Chirp-Z transform via Bluestein's algorithm (reference: src/spectral/czt.c).

SciPy convention (src/spectral/czt.h:11-13): X[k] = sum_n x[n] A^{-n} W^{nk},
k in [0, M). General spiral contours (|W| != 1, |A| != 1) supported through
magnitude/angle decomposition like the reference (src/spectral/czt.c:84-111).

Design: W and A are *static plan parameters* (Python complex), so
every chirp table g[n] = A^{-n} W^{n^2/2}, the convolution kernel
b[i] = W^{-(i-(N-1))^2/2}, its FFT, and the output chirp W^{k^2/2} are computed
host-side in float64 numpy and baked into the jitted computation as constants.
On device only remain: one pointwise multiply, one C2C FFT of length
P = next_pow2(N+M-1), one pointwise multiply with the precomputed kernel FFT,
one inverse FFT, and one final pointwise multiply — the exact 3-FFT structure
of the reference (src/spectral/czt.c:140-166) with one of the FFTs folded into
the plan.
"""

from __future__ import annotations

import functools

import numpy as np
import jax.numpy as jnp

from vv_dsp_tpu import config
from vv_dsp_tpu.ops import fft as _fft
from vv_dsp_tpu.ops.fft import next_pow2


def czt_params_for_freq_range(f_start: float, f_end: float, m: int, fs: float):
    """(W, A) for an M-point sweep of [f_start, f_end) Hz
    (vv_dsp_czt_params_for_freq_range, src/spectral/czt.c:20-38).

    Note the reference spaces bins by (f_end-f_start)/M (endpoint excluded).
    """
    delta = (f_end - f_start) / float(m)
    w = np.exp(-2j * np.pi * delta / fs)
    a = np.exp(-2j * np.pi * f_start / fs)
    return complex(w), complex(a)


@functools.lru_cache(maxsize=64)
def next_fast_len(target: int) -> int:
    """Smallest 5-smooth (2^a 3^b 5^c) length >= target — the chirp
    convolution length.  5-smooth sizes stay on the fast tiers (four-step
    factors them near-square; CPU pocketfft likes them too) and pad far
    less than next_pow2: e.g. target 8197 -> 8640 instead of 16384, which
    flipped Bluestein-at-4099 from 0.7x to >1x vs the XLA HLO."""
    best = next_pow2(target)
    f5 = 1
    while f5 < best:
        f35 = f5
        while f35 < best:
            # smallest power of two lifting f35 over target
            q = f35
            while q < target:
                q *= 2
            best = min(best, q)
            f35 *= 3
        f5 *= 5
    return best


def _czt_tables(n: int, m: int, w: complex, a: complex):
    """Host-side f64 chirp constants for a (N, M, W, A) plan."""
    arg_w = np.angle(complex(w))
    mag_w = abs(complex(w))

    def w_pow(e):  # W^e via mag/angle decomposition (czt.c:84-111)
        return (mag_w ** e) * np.exp(1j * arg_w * e)

    nn = np.arange(n, dtype=np.float64)
    g = (complex(a) ** (-nn)) * w_pow(0.5 * nn * nn)  # g[n] = A^-n W^{n^2/2}

    p = next_fast_len(n + m - 1)
    i = np.arange(n + m - 1, dtype=np.float64)
    b = np.zeros(p, dtype=np.complex128)
    mm = i - (n - 1)
    b[: n + m - 1] = w_pow(-0.5 * mm * mm)  # b[i] = W^{-(i-(N-1))^2/2}
    b_fft = np.fft.fft(b)

    kk = np.arange(m, dtype=np.float64)
    out_chirp = w_pow(0.5 * kk * kk)  # W^{k^2/2}
    return g, b_fft, out_chirp, p


def czt(x, m: int, w: complex, a: complex = 1.0 + 0.0j):
    """Chirp-Z transform of (..., N) -> (..., M) complex.

    Equivalent of vv_dsp_czt_exec_cpx / _real (src/spectral/czt.c:40-178);
    real input is promoted to complex automatically.
    """
    n = x.shape[-1]
    m = int(m)
    g_np, b_fft_np, chirp_np, p = _czt_tables(n, m, complex(w), complex(a))
    cdt = config.complex_for_real(
        x.real.dtype if jnp.iscomplexobj(x) else x.dtype
    )
    g = jnp.asarray(g_np, dtype=cdt)
    b_fft = jnp.asarray(b_fft_np, dtype=cdt)
    chirp = jnp.asarray(chirp_np, dtype=cdt)

    ax = x.astype(cdt) * g
    # universal FFT dispatch: the reference's CZT executes its FFTs through
    # the one plan vtable (src/spectral/czt.c:140-154); ops.fft gives the
    # matmul/four-step tiers + set_fft_backend.  (An r2c route would not
    # help even for real x: the chirp premultiply makes `ax` complex, and
    # splitting FFT(x*g_re) + j*FFT(x*g_im) costs two r2c = one c2c.)
    a_fft = _fft.fft(ax, n=p)
    c = _fft.ifft(a_fft * b_fft)
    return c[..., n - 1 : n - 1 + m] * chirp


def czt_range(x, f_start: float, f_end: float, m: int, fs: float):
    """Frequency-zoom convenience wrapper."""
    w, a = czt_params_for_freq_range(f_start, f_end, m, fs)
    return czt(x, m, w, a)
