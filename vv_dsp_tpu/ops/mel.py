"""Mel scale, filterbank, log-mel spectrogram and MFCC
(reference: src/features/mel.c).

Semantics preserved:
- HTK mel scale 2595*log10(1 + f/700), negatives clamp to 0 (mel.c:14-28);
  a Slaney variant is additionally provided (the reference enum exists but
  returns OUT_OF_RANGE, mel.c:88-91),
- triangular filterbank over n_fft/2+1 bins built in the Hz domain, each
  filter normalized to SUM 1 (area normalization, mel.c:146-180). Note the
  reference builds triangle edges with searchsorted on bin frequencies, which
  is equivalent to evaluating the triangle at each bin frequency and clipping
  to [left_idx, right_idx) — reproduced exactly,
- log-mel: log(filterbank @ power + eps) (mel.c:204-245),
- MFCC: unnormalized DCT-II of the log-mel vector, keep first K coefficients,
  optional sinusoidal liftering 1 + (L/2) sin(pi i / L) skipping c0
  (mel.c:249-309).

Design: the reference's triple per-frame/per-mel/per-bin loop
(mel.c:225-241) and its per-frame DCT *plan create/destroy* (mel.c:287!) become
two batched matmuls: (frames x bins) @ (bins x mels) and
(frames x mels) @ (mels x K). The filterbank and DCT matrices are the "plan",
generated host-side in float64.
"""

from __future__ import annotations

import functools

import numpy as np
import jax.numpy as jnp

from vv_dsp_tpu import config
from vv_dsp_tpu.ops.dct import _dct2_matrix


def hz_to_mel(hz, variant: str = "htk"):
    hz = np.maximum(np.asarray(hz, dtype=np.float64), 0.0)
    if variant == "htk":
        return 2595.0 * np.log10(1.0 + hz / 700.0)
    if variant == "slaney":
        f_sp = 200.0 / 3.0
        min_log_hz = 1000.0
        min_log_mel = min_log_hz / f_sp
        logstep = np.log(6.4) / 27.0
        lin = hz / f_sp
        log = min_log_mel + np.log(np.maximum(hz, 1e-10) / min_log_hz) / logstep
        return np.where(hz >= min_log_hz, log, lin)
    raise ValueError("variant must be 'htk' or 'slaney'")


def mel_to_hz(mel, variant: str = "htk"):
    mel = np.maximum(np.asarray(mel, dtype=np.float64), 0.0)
    if variant == "htk":
        return 700.0 * (10.0 ** (mel / 2595.0) - 1.0)
    if variant == "slaney":
        f_sp = 200.0 / 3.0
        min_log_hz = 1000.0
        min_log_mel = min_log_hz / f_sp
        logstep = np.log(6.4) / 27.0
        lin = mel * f_sp
        log = min_log_hz * np.exp(logstep * (mel - min_log_mel))
        return np.where(mel >= min_log_mel, log, lin)
    raise ValueError("variant must be 'htk' or 'slaney'")


@functools.lru_cache(maxsize=32)
def mel_filterbank_np(n_fft: int, n_mels: int, sample_rate: float,
                      fmin: float, fmax: float,
                      variant: str = "htk") -> np.ndarray:
    """(n_mels, n_fft//2+1) float64 area-normalized triangular filterbank
    (vv_dsp_mel_filterbank_create, mel.c:66-193)."""
    if fmax <= fmin or fmax > sample_rate / 2.0:
        raise ValueError("need fmin < fmax <= sample_rate/2")
    n_bins = n_fft // 2 + 1
    if n_mels >= n_bins:
        raise ValueError("n_mels must be < n_fft//2+1")
    mel_pts = np.linspace(hz_to_mel(fmin, variant), hz_to_mel(fmax, variant),
                          n_mels + 2)
    hz_pts = mel_to_hz(mel_pts, variant)
    freqs = np.arange(n_bins, dtype=np.float64) * sample_rate / n_fft

    fb = np.zeros((n_mels, n_bins), dtype=np.float64)
    for m in range(n_mels):
        left, center, right = hz_pts[m], hz_pts[m + 1], hz_pts[m + 2]
        li = np.searchsorted(freqs, left)
        ci = np.searchsorted(freqs, center)
        ri = np.searchsorted(freqs, right)
        ks = np.arange(li, min(ci, n_bins))
        fb[m, ks] = (freqs[ks] - left) / (center - left)
        ks = np.arange(ci, min(ri, n_bins))
        fb[m, ks] = (right - freqs[ks]) / (right - center)
        s = fb[m].sum()
        if s > 0:
            fb[m] /= s
    return fb


def log_mel_spectrogram(power_spec, n_fft: int, n_mels: int, sample_rate: float,
                        fmin: float = 0.0, fmax: float | None = None,
                        log_epsilon: float = 1e-10, variant: str = "htk"):
    """(..., frames, n_fft//2+1) power -> (..., frames, n_mels) log-mel
    (vv_dsp_compute_log_mel_spectrogram, mel.c:204-245)."""
    if fmax is None:
        fmax = sample_rate / 2.0
    fb = jnp.asarray(
        mel_filterbank_np(n_fft, n_mels, float(sample_rate), float(fmin),
                          float(fmax), variant),
        dtype=power_spec.dtype,
    )
    mel_e = jnp.einsum("...fb,mb->...fm", power_spec, fb,
                       precision=config.MATMUL_PRECISION)
    return jnp.log(mel_e + log_epsilon)


def mel_energies_from_power_parts(re, im, n_fft: int, n_mels: int,
                                  sample_rate: float, fmin: float = 0.0,
                                  fmax: float | None = None,
                                  variant: str = "htk"):
    """Mel energies straight from the (re, im) rfft parts
    (STFT.power_parts): the mel projection is linear in the power, so
    mel_e = (re*re) @ fb.T + (im*im) @ fb.T — the (frames, bins) power
    array never materializes in HBM (it is ~13x larger than the mel
    energies), and the squares fuse into the matmul operand reads."""
    if fmax is None:
        fmax = sample_rate / 2.0
    fb = jnp.asarray(
        mel_filterbank_np(n_fft, n_mels, float(sample_rate), float(fmin),
                          float(fmax), variant),
        dtype=re.dtype,
    )
    return (jnp.einsum("...fb,mb->...fm", re * re, fb,
                       precision=config.MATMUL_PRECISION)
            + jnp.einsum("...fb,mb->...fm", im * im, fb,
                         precision=config.MATMUL_PRECISION))


def mfcc_from_power_parts(re, im, n_fft: int, n_mels: int, n_coeffs: int,
                          sample_rate: float, fmin: float = 0.0,
                          fmax: float | None = None,
                          log_epsilon: float = 1e-10, lifter: float = 0.0,
                          variant: str = "htk"):
    """MFCC from the (re, im) rfft parts — matches
    mfcc(re*re + im*im, ...) exactly (see mel_energies_from_power_parts
    for why the power array never exists)."""
    mel_e = mel_energies_from_power_parts(re, im, n_fft, n_mels,
                                          sample_rate, fmin, fmax, variant)
    return mfcc_from_log_mel(jnp.log(mel_e + log_epsilon), n_coeffs, lifter)


def _lifter_np(n_coeffs: int, lifter: float) -> np.ndarray:
    w = np.ones(n_coeffs, dtype=np.float64)
    if lifter > 0:
        i = np.arange(1, n_coeffs, dtype=np.float64)
        w[1:] = 1.0 + (lifter / 2.0) * np.sin(np.pi * i / lifter)
    return w


def mfcc_from_log_mel(log_mel, n_coeffs: int, lifter: float = 0.0):
    """(..., frames, n_mels) -> (..., frames, n_coeffs): unnormalized DCT-II,
    keep first K, sinusoidal liftering (vv_dsp_mfcc, mel.c:249-309)."""
    n_mels = log_mel.shape[-1]
    if n_coeffs > n_mels:
        raise ValueError("n_coeffs must be <= n_mels")
    dct_mat = jnp.asarray(_dct2_matrix(n_mels)[:n_coeffs], dtype=log_mel.dtype)
    coeffs = jnp.einsum("...fm,km->...fk", log_mel, dct_mat,
                        precision=config.MATMUL_PRECISION)
    lw = _lifter_np(n_coeffs, float(lifter))
    return coeffs * jnp.asarray(lw, dtype=coeffs.dtype)


def mfcc(power_spec, n_fft: int, n_mels: int, n_coeffs: int, sample_rate: float,
         fmin: float = 0.0, fmax: float | None = None,
         log_epsilon: float = 1e-10, lifter: float = 0.0,
         variant: str = "htk"):
    """Full MFCC plan execute (vv_dsp_mfcc_init/process, mel.c:314-463):
    power spectrogram -> log-mel -> DCT-II -> lifter."""
    lm = log_mel_spectrogram(power_spec, n_fft, n_mels, sample_rate, fmin,
                             fmax, log_epsilon, variant)
    return mfcc_from_log_mel(lm, n_coeffs, lifter)


def mel_energies_stft(x, nfft: int, hop: int, n_mels: int,
                      sample_rate: float, window: str = "hann",
                      window_param=None, fmin: float = 0.0,
                      fmax: float | None = None, variant: str = "htk"):
    """Signal -> STFT mel energies: the framing-free power-parts matmul
    path when the dense DFT tier applies (STFT.supports_direct), else the
    power spectrogram (strided frames + rfft) and the filterbank matmul."""
    from vv_dsp_tpu.ops.stft import STFT

    if x.ndim != 2 and not jnp.iscomplexobj(x):
        from vv_dsp_tpu.utils.shapes import collapse_leading
        x2, restore = collapse_leading(x)
        return restore(mel_energies_stft(x2, nfft, hop, n_mels, sample_rate,
                                         window, window_param, fmin, fmax,
                                         variant), 2)
    plan = STFT(nfft, hop, window, window_param)
    if plan.supports_direct() and not jnp.iscomplexobj(x):
        re, im = plan.power_parts(x)
        return mel_energies_from_power_parts(re, im, nfft, n_mels,
                                             sample_rate, fmin, fmax, variant)
    power = plan.power(x)
    if fmax is None:
        fmax = sample_rate / 2.0
    fb = jnp.asarray(
        mel_filterbank_np(nfft, n_mels, float(sample_rate), float(fmin),
                          float(fmax), variant), dtype=power.dtype)
    return jnp.einsum("...fb,mb->...fm", power, fb,
                      precision=config.MATMUL_PRECISION)


def mfcc_stft(x, nfft: int, hop: int, n_mels: int, n_coeffs: int,
              sample_rate: float, window: str = "hann", window_param=None,
              fmin: float = 0.0, fmax: float | None = None,
              log_epsilon: float = 1e-10, lifter: float = 0.0,
              variant: str = "htk"):
    """Signal -> MFCC: mel_energies_stft, then log, DCT-II and lifter."""
    mel_e = mel_energies_stft(x, nfft, hop, n_mels, sample_rate, window,
                              window_param, fmin, fmax, variant)
    return mfcc_from_log_mel(jnp.log(mel_e + log_epsilon), n_coeffs, lifter)
