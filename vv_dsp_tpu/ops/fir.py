"""FIR design & application (reference: src/filter/fir.c, src/filter/common.c).

Semantics preserved:
- design: windowed-sinc lowpass h[n] = 2 fc sinc(2 fc (n - (N-1)/2)) * w[n]
  with the filter module's private windows rect/hamming/hann/blackman
  (src/filter/fir.c:17-73) — generated host-side in f64.
- apply: causal convolution y[i] = sum_k h[k] x[i-k] with zero initial history,
  i.e. scipy.signal.lfilter(h, [1], x). The reference's streaming ring buffer
  (vv_dsp_fir_state, src/filter/fir.c:160-196) exists to carry the L-1 sample
  history across blocks; on the device the same contract is met by
  (a) whole-signal batched convolution here, and
  (b) ppermute halo exchange between time-shards (vv_dsp_tpu.parallel).

Design: interchangeable paths with identical numerics —
  fir_apply          : direct conv via lax.conv_general_dilated (small taps;
                       XLA lowers it to an implicit GEMM),
  fir_apply_fft      : single-block rFFT linear convolution
                       (vv_dsp_fir_apply_fft, src/filter/fir.c:75-135),
  fir_apply_os       : blocked overlap-save rFFT convolution — the streaming
                       FFT path the reference is missing (its FFT path is
                       whole-signal only and reported broken,
                       docs/simd_optimization_analysis.md:69-73),
  fir_apply_mxu      : block-Toeplitz matmuls (traced taps, sharded halos);
  fir_apply_best picks between them by tap count.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp
from jax import lax

from vv_dsp_tpu import config
from vv_dsp_tpu.ops import fft as _fftmod
from vv_dsp_tpu.ops.fft import next_pow2
from vv_dsp_tpu.ops.window import get_window_np


def design_lowpass_np(num_taps: int, cutoff: float,
                      window: str = "hamming") -> np.ndarray:
    """Host-side (float64 numpy) windowed-sinc design — safe to call and
    cache from anywhere, including inside a jit trace (jnp.asarray would
    yield a Tracer there)."""
    if num_taps <= 0:
        raise ValueError("num_taps must be positive")
    if not (0.0 < cutoff < 1.0):
        raise ValueError("cutoff must be in (0, 1)")
    n = np.arange(num_taps, dtype=np.float64)
    alpha = (num_taps - 1) / 2.0
    m = n - alpha
    h = 2.0 * cutoff * np.sinc(2.0 * cutoff * m)  # np.sinc is sin(pi x)/(pi x)
    return h * get_window_np(window, num_taps)


def design_lowpass(num_taps: int, cutoff: float, window: str = "hamming",
                   dtype=None) -> jnp.ndarray:
    """Windowed-sinc lowpass (vv_dsp_fir_design_lowpass, src/filter/fir.c:47-73).

    cutoff in (0, 1), same normalization as the reference (h sums to ~1 at DC).
    """
    return jnp.asarray(design_lowpass_np(num_taps, cutoff, window),
                       dtype=config.real_dtype(dtype))


def _causal_conv(x, h):
    """y[i] = sum_k h[k] x[i-k], x[<0] = 0; batches over leading axes.

    Implemented as lax.conv_general_dilated with left zero padding of L-1 —
    XLA lowers this to an implicit GEMM.
    """
    taps = h.shape[-1]
    batch_shape = x.shape[:-1]
    n = x.shape[-1]
    xb = x.reshape((-1, 1, n))
    # Correlation with reversed taps == convolution.
    kern = h[::-1].astype(x.dtype).reshape((1, 1, taps))
    y = lax.conv_general_dilated(
        xb, kern,
        window_strides=(1,),
        padding=[(taps - 1, 0)],
        dimension_numbers=("NCH", "OIH", "NCH"),
        precision=config.MATMUL_PRECISION,
    )
    return y.reshape(batch_shape + (n,))


def fir_apply(h, x):
    """Causal FIR filtering, lfilter(h, [1], x) semantics
    (vv_dsp_fir_apply, src/filter/fir.c:160-196 with zeroed initial state)."""
    x = config.as_compute(x)
    return _causal_conv(x, jnp.asarray(h, dtype=x.dtype))


def fir_apply_fft(h, x):
    """Whole-signal linear convolution via rFFT, truncated to len(x)
    (vv_dsp_fir_apply_fft, src/filter/fir.c:75-135)."""
    x = config.as_compute(x)
    h = jnp.asarray(h, dtype=x.dtype)
    n = x.shape[-1]
    taps = h.shape[-1]
    nfft = next_pow2(n + taps - 1)
    y = _fftmod.irfft(_fftmod.rfft(x, nfft) * _fftmod.rfft(h, nfft), nfft)
    return y[..., :n]


def fir_apply_os(h, x, block_size: int | None = None):
    """Overlap-save blocked rFFT convolution, identical output to fir_apply.

    Each block of `block_size` output samples is computed from a segment of
    block_size + taps - 1 inputs (taps-1 of history), transformed at
    nfft = next_pow2(block+taps-1). This is the streaming-FFT structure whose
    per-shard version (history via ppermute) lives in vv_dsp_tpu.parallel.
    """
    x = config.as_compute(x)
    h = jnp.asarray(h, dtype=x.dtype)
    taps = h.shape[-1]
    n = x.shape[-1]
    if block_size is None:
        # nfft 4096 (or the next power of two above 2*taps) with the
        # maximal valid block for that transform size; untuned on the GPU
        nfft_target = max(4096, next_pow2(2 * taps))
        block_size = nfft_target - taps + 1
    nfft = next_pow2(block_size + taps - 1)
    n_blocks = -(-n // block_size)
    right_pad = n_blocks * block_size - n
    xp = jnp.pad(x, [(0, 0)] * (x.ndim - 1) + [(taps - 1, right_pad)])
    # Overlapping segments. The segment matrix is (block + taps - 1) wide;
    # build it from two aligned reshapes + slice (dense passes instead of
    # an (n_blocks x seg) gather, cf. framing.py).
    seg_len = block_size + taps - 1
    total = n_blocks * block_size
    a = xp[..., :total].reshape(xp.shape[:-1] + (n_blocks, block_size))
    b = xp[..., block_size:]
    b = jnp.pad(b, [(0, 0)] * (x.ndim - 1)
                + [(0, total + taps - 1 - b.shape[-1])])
    b = b[..., :total].reshape(xp.shape[:-1] + (n_blocks, block_size))
    segs = jnp.concatenate([a, b[..., : seg_len - block_size]], axis=-1)
    hf = _fftmod.rfft(h, nfft)
    y = _fftmod.irfft(_fftmod.rfft(segs, nfft) * hf, nfft)
    y = y[..., taps - 1 : taps - 1 + block_size]  # valid part of each block
    y = y.reshape(y.shape[:-2] + (n_blocks * block_size,))
    return y[..., :n]


def fir_apply_mxu(h, x, chunk: int = 128):
    """Causal FIR as block-Toeplitz matmuls — identical to fir_apply.

    Derivation: split h into J chunks of C taps and time into blocks of C.
    With windows W_k = x[kC-(C-1) : kC+C] (length 2C-1, zero left pad) and
    Toeplitz matrices T_j[s, r] = h[jC + r + C-1 - s] (zero outside the
    chunk),
        y_block[m] = sum_j  W_{m-j} @ T_j
    i.e. J matmuls of (blocks, 2C-1) @ (2C-1, C) with j-row-shifted windows.
    FLOPs ~= 2 * (2 - 1/C) * taps * n, within 2x of the direct form but
    running as dense matmuls. Works with traced taps (learned coefficients
    under jit), which the sharded FIR and the streaming FIR rely on.
    """
    x = config.as_compute(x)
    import jax as _jax

    traced = isinstance(h, _jax.core.Tracer)
    if not traced:
        h = np.asarray(h, dtype=np.float64)
    taps = h.shape[-1]
    C = chunk
    J = -(-taps // C)
    if traced:
        hp_j = jnp.concatenate(
            [h.astype(x.dtype), jnp.zeros((J * C - taps,), x.dtype)])
    else:
        hp = np.zeros(J * C)
        hp[:taps] = h
    batch = x.shape[:-1]
    n = x.shape[-1]
    nb = -(-n // C)

    # windows via the two-aligned-reshape trick (no gather)
    xp = jnp.pad(x, [(0, 0)] * (x.ndim - 1) + [(C - 1, nb * C - n)])
    total = nb * C
    a = xp[..., : total].reshape(batch + (nb, C))
    b = jnp.pad(xp[..., C:], [(0, 0)] * (x.ndim - 1)
                + [(0, 2 * C - 1)])[..., :total].reshape(batch + (nb, C))
    W = jnp.concatenate([a, b[..., : C - 1]], axis=-1)  # (..., nb, 2C-1)

    # Toeplitz blocks (host-side f64 for concrete taps; on-device gather for
    # traced taps, e.g. under shard_map/jit with learned coefficients)
    s = np.arange(2 * C - 1)[:, None]
    r = np.arange(C)[None, :]
    idx = r + C - 1 - s  # tap index within chunk
    valid = (idx >= 0) & (idx < C)
    y = None
    for j in range(min(J, nb)):  # chunks beyond nb only hit zero history
        if traced:
            tj = jnp.where(jnp.asarray(valid),
                           hp_j[j * C + np.clip(idx, 0, C - 1)], 0.0)
        else:
            tj = jnp.asarray(
                np.where(valid, hp[j * C + np.clip(idx, 0, C - 1)], 0.0
                         ).astype(np.dtype(x.dtype)))
        if j == 0:
            wj = W
        else:
            wj = jnp.concatenate(
                [jnp.zeros(batch + (j, 2 * C - 1), W.dtype),
                 W[..., : nb - j, :]], axis=-2)
        term = jnp.einsum("...ns,sc->...nc", wj, tj,
                          precision=config.MATMUL_PRECISION)
        y = term if y is None else y + term
    return y.reshape(batch + (nb * C,))[..., :n]


def fir_apply_best(h, x):
    """Causal FIR through the path chosen by tap count: the direct conv
    up to 64 taps, overlap-save rFFT above (FLOPs grow with log(taps)
    instead of taps). The crossover is untuned on the GPU."""
    if jnp.shape(h)[-1] <= 64:
        return fir_apply(h, x)
    return fir_apply_os(h, x)


def filtfilt_fir(h, x):
    """Zero-phase FIR (vv_dsp_filtfilt_fir, src/filter/common.c:23-80):
    symmetric-pad by taps-1, forward conv, reverse, conv, reverse, center."""
    x = config.as_compute(x)
    h = jnp.asarray(h, dtype=x.dtype)
    taps = h.shape[-1]
    pad = taps - 1 if taps > 1 else 0
    if pad and x.shape[-1] < pad:
        raise ValueError(
            f"filtfilt_fir needs len(x) >= num_taps - 1 = {pad} "
            f"(got {x.shape[-1]}); scipy.filtfilt has the same padlen rule")
    if pad:
        # reference reflect_pad: left = [x[pad-1]..x[0]], right = [x[n-1]..]
        # == numpy 'symmetric'
        left = x[..., :pad][..., ::-1]
        right = x[..., -pad:][..., ::-1]
        ext = jnp.concatenate([left, x, right], axis=-1)
    else:
        ext = x
    y = _causal_conv(ext, h)
    y = _causal_conv(y[..., ::-1], h)[..., ::-1]
    if pad:
        y = y[..., pad:-pad]
    return y
