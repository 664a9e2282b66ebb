"""DCT-II / DCT-III / DCT-IV (reference: src/spectral/dct.c).

Conventions preserved exactly (src/spectral/dct.c:18-68):
- DCT-II  forward : X[k] = sum_n x[n] cos(pi (n+0.5) k / N)           (:21-30)
- DCT-II  backward: x[n] = (2/N)(0.5 X[0] + sum_{k>=1} X[k]
                      cos(pi k (n+0.5)/N))                            (:32-42)
- DCT-III forward : Y[k] = x[0] + 2 sum_{n>=1} x[n]
                      cos(pi k (n+0.5)/N)                             (:46-55)
- DCT-III backward: the DCT-II forward scaled by 2/N (inverse pair)
- DCT-IV  : self-inverse; backward scaled by 2/N                      (:57-68)

Design: the transforms are dense cosine-matrix matmuls, batched over leading
axes, with the cosine tables generated
host-side in float64. This is both exact for every N (the reference's naive
O(N^2) loops have the same complexity but run at scalar-CPU speed) and faster
than an FFT decomposition for the small/odd N the test sweep uses
(n in {7, 8, 63, 64, 257}, python/test_dct.py:44). An rFFT-based O(N log N)
path kicks in automatically for large power-of-two N.

NaN policy is applied to input and output like vv_dsp_dct_execute
(src/spectral/dct.c:86-136).
"""

from __future__ import annotations

import functools

import numpy as np
import jax.numpy as jnp

from vv_dsp_tpu import config
from vv_dsp_tpu.ops import fft as _fft
from vv_dsp_tpu.utils.nan_policy import NanPolicy, apply_nan_policy

# Above this size (power of two only) DCT-II/III go through rFFT instead of a
# dense matmul: matmul is O(N^2); the threshold is untuned on the GPU.
_FFT_THRESHOLD = 4096


@functools.lru_cache(maxsize=64)
def _dct2_matrix(n: int) -> np.ndarray:
    """M[k, m] = cos(pi (m+0.5) k / n), float64."""
    k = np.arange(n, dtype=np.float64)[:, None]
    m = np.arange(n, dtype=np.float64)[None, :]
    return np.cos(np.pi * (m + 0.5) * k / n)


@functools.lru_cache(maxsize=64)
def _dct4_matrix(n: int) -> np.ndarray:
    k = np.arange(n, dtype=np.float64)[:, None]
    m = np.arange(n, dtype=np.float64)[None, :]
    return np.cos(np.pi * (m + 0.5) * (k + 0.5) / n)


def _matmul(x, mat_np):
    mat = jnp.asarray(mat_np, dtype=x.dtype)
    return jnp.einsum("...n,kn->...k", x, mat,
                      precision=config.MATMUL_PRECISION)


def _is_pow2(n: int) -> bool:
    return n > 0 and (n & (n - 1)) == 0


def _dct2_fft(x):
    """DCT-II via the even-reordering rFFT identity (Makhoul 1980)."""
    n = x.shape[-1]
    v = jnp.concatenate([x[..., ::2], x[..., 1::2][..., ::-1]], axis=-1)
    spec = _fft.rfft(v)
    k = np.arange(n // 2 + 1, dtype=np.float64)
    tw = jnp.asarray(np.exp(-1j * np.pi * k / (2.0 * n)), dtype=spec.dtype)
    half = spec * tw
    # Full-length DCT output: X[k] = Re(half[k]); X[n-k] = -Im(half[k]).
    head = jnp.real(half)
    tail = -jnp.imag(half[..., 1 : (n + 1) // 2][..., ::-1])
    return jnp.concatenate([head[..., : n // 2 + 1], tail], axis=-1)


def dct2_forward(x):
    n = x.shape[-1]
    if _is_pow2(n) and n >= _FFT_THRESHOLD:
        return _dct2_fft(x)
    return _matmul(x, _dct2_matrix(n))


def _idct2_fft(X):
    """Inverse of _dct2_fft (exact inverse of the unscaled DCT-II, i.e. the
    reference's 2/N-weighted backward): reverse the Makhoul identity —
    rebuild the half spectrum from the packed real outputs, undo the
    quarter-sample twiddle, irfft, and undo the even/odd reordering."""
    n = X.shape[-1]
    h = n // 2
    head = X[..., : h + 1]
    K = (n + 1) // 2 - 1  # slots k = 1..K carry Im(half[k]) = -X[n-k]
    im_part = -X[..., h + 1 :][..., ::-1]  # positions n-1..h+1 -> k=1..
    im = jnp.concatenate(
        [jnp.zeros_like(X[..., :1]), im_part] +
        ([jnp.zeros_like(X[..., :1])] if n % 2 == 0 else []), axis=-1)
    cd = jnp.result_type(X.dtype, jnp.complex64)
    half = head.astype(cd) + 1j * im.astype(cd)
    k = np.arange(h + 1, dtype=np.float64)
    ctw = jnp.asarray(np.exp(1j * np.pi * k / (2.0 * n)), dtype=cd)
    spec = half * ctw
    if n % 2 == 0:
        # Nyquist: only Re survived packing; spec must be real = X[h]*sqrt(2)
        spec = spec.at[..., h].set(head[..., h].astype(cd) * np.sqrt(2.0))
    v = _fft.irfft(spec, n)
    ne = (n + 1) // 2
    out = jnp.zeros_like(v)
    out = out.at[..., ::2].set(v[..., :ne])
    out = out.at[..., 1::2].set(v[..., ne:][..., ::-1])
    return out


def dct2_backward(x):
    n = x.shape[-1]
    if _is_pow2(n) and n >= _FFT_THRESHOLD:
        return _idct2_fft(x)
    # x[m] = (2/N)(0.5 X[0] + sum_{k>=1} X[k] cos(pi k (m+0.5)/N))
    # (src/spectral/dct.c:32-42); weight w_k = 2/N except w_0 = 1/N.
    w = np.full(n, 2.0 / n)
    w[0] = 1.0 / n
    mat = np.ascontiguousarray((_dct2_matrix(n) * w[:, None]).T)
    return _matmul(x, mat)


def dct3_forward(x):
    # Y[k] = x[0] + 2 sum_{n>=1} x[n] cos(pi k (n+0.5) / N)
    # (exact reference formula incl. the unit coefficient on x[0],
    # src/spectral/dct.c:46-55). NB: this kernel is the TRANSPOSE of the
    # DCT-II backward kernel (the half-sample shift rides the input index),
    # so the _idct2_fft fast path does NOT apply here; forward DCT-III stays
    # a matmul (its inverse routes through the fast dct2_backward).
    n = x.shape[-1]
    mat = 2.0 * _dct2_matrix(n)
    mat[:, 0] = 1.0
    return _matmul(x, mat)


def dct3_backward(x):
    # Reference routes DCT-III backward through the same dct3_inverse_from_ii
    # kernel as DCT-II backward (src/spectral/dct.c:112-119).
    return dct2_backward(x)


def dct4(x, inverse: bool = False):
    n = x.shape[-1]
    y = _matmul(x, _dct4_matrix(n))
    if inverse:
        y = y * (2.0 / n)
    return y


def dct(x, type: int = 2, inverse: bool = False,
        nan_policy: NanPolicy = NanPolicy.PROPAGATE):
    """Plan-free DCT execute (vv_dsp_dct_execute, src/spectral/dct.c:86-136).

    x: (..., n) real. NaN policy applied to input and output.
    """
    x = apply_nan_policy(x, nan_policy)
    if type == 2:
        y = dct2_backward(x) if inverse else dct2_forward(x)
    elif type == 3:
        y = dct3_backward(x) if inverse else dct3_forward(x)
    elif type == 4:
        y = dct4(x, inverse=inverse)
    else:
        raise ValueError("DCT type must be 2, 3, or 4")
    return apply_nan_policy(y, nan_policy)
