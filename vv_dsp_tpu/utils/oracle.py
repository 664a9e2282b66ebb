"""Float64 NumPy/SciPy references for the pipelines and the STFT family.

Each function recomputes what the library computes, independently of the
code under test, in float64 on the host: the CPU parity tests and
chip_smoke.py compare against the same definitions. Inputs are
(channels, n) float arrays; outputs are float64 (complex128 for spectra).
"""

from __future__ import annotations

import numpy as np


def _window(name: str, n: int) -> np.ndarray:
    from vv_dsp_tpu.ops.window import get_window_np
    return np.asarray(get_window_np(name, n, None), np.float64)


def frames(x, nfft: int, hop: int) -> np.ndarray:
    """(..., n) -> (..., frames, nfft): frames at f*hop, tail frames
    zero-padded, frame count 1 + (n - nfft + hop)//hop (1 if n < nfft)."""
    x = np.asarray(x, np.float64)
    n = x.shape[-1]
    nf = 1 if n < nfft else 1 + (n - nfft + hop) // hop
    need = (nf - 1) * hop + nfft
    xp = np.pad(x, [(0, 0)] * (x.ndim - 1) + [(0, max(0, need - n))])
    idx = np.arange(nf)[:, None] * hop + np.arange(nfft)[None, :]
    return xp[..., idx]


def stft(x, nfft: int, hop: int, window: str = "hann",
         rfft: bool = False) -> np.ndarray:
    """STFT.process: windowed frames -> unscaled FFT (all bins, or the
    one-sided half with rfft=True)."""
    fr = frames(x, nfft, hop) * _window(window, nfft)
    return np.fft.rfft(fr, axis=-1) if rfft else np.fft.fft(fr, axis=-1)


def stft_power(x, nfft: int, hop: int, window: str = "hann") -> np.ndarray:
    """STFT.power: |rfft(windowed frames)|^2."""
    return np.abs(stft(x, nfft, hop, window, rfft=True)) ** 2


def istft(spec, nfft: int, hop: int, output_len: int, window: str = "hann",
          rfft: bool = False) -> np.ndarray:
    """STFT.reconstruct: inverse FFT -> window -> overlap-add, divided by
    the overlap-added w^2 where it exceeds 1e-12."""
    spec = np.asarray(spec)
    t = (np.fft.irfft(spec, nfft, axis=-1) if rfft
         else np.fft.ifft(spec, axis=-1).real)
    w = _window(window, nfft)
    nf = t.shape[-2]
    span = max(output_len, (nf - 1) * hop + nfft)
    out = np.zeros(t.shape[:-2] + (span,))
    norm = np.zeros(span)
    for f in range(nf):
        out[..., f * hop:f * hop + nfft] += t[..., f, :] * w
        norm[f * hop:f * hop + nfft] += w * w
    out, norm = out[..., :output_len], norm[:output_len]
    return np.where(norm > 1e-12, out / np.where(norm > 1e-12, norm, 1.0),
                    out)


def mel_energies(x, nfft: int, hop: int, n_mels: int, sample_rate: float,
                 window: str = "hann", fmin: float = 0.0,
                 fmax: float | None = None) -> np.ndarray:
    """mel_energies_stft: power spectrogram @ HTK filterbank^T."""
    from vv_dsp_tpu.ops.mel import mel_filterbank_np
    fmax = sample_rate / 2.0 if fmax is None else fmax
    fb = mel_filterbank_np(nfft, n_mels, float(sample_rate), float(fmin),
                           float(fmax), "htk")
    return stft_power(x, nfft, hop, window) @ np.asarray(fb, np.float64).T


def mfcc(x, nfft: int, hop: int, n_mels: int, n_mfcc: int,
         sample_rate: float, window: str = "hann", lifter: float = 0.0,
         log_epsilon: float = 1e-10) -> np.ndarray:
    """mfcc_stft: log(mel energies + eps) -> unnormalized DCT-II -> first
    n_mfcc -> sinusoidal lifter (skipping c0)."""
    from vv_dsp_tpu.ops.dct import _dct2_matrix
    lm = np.log(mel_energies(x, nfft, hop, n_mels, sample_rate, window)
                + log_epsilon)
    d = np.asarray(_dct2_matrix(n_mels), np.float64)[:n_mfcc]
    c = lm @ d.T
    if lifter > 0:
        i = np.arange(1, n_mfcc, dtype=np.float64)
        c[..., 1:] *= 1.0 + (lifter / 2.0) * np.sin(np.pi * i / lifter)
    return c


def northstar_chain(x, chain) -> np.ndarray:
    """NorthStarChain: lfilter FIR -> scipy resample_poly -> STFT power ->
    log-mel -> DCT-II, at the chain's own geometry."""
    from scipy import signal as ss
    x = np.asarray(x, np.float64)
    h = np.asarray(chain.fir_coeffs, np.float64)
    y = ss.lfilter(h, [1.0], x, axis=-1)
    yr = ss.resample_poly(y, chain.up, chain.down, axis=-1)
    yr = yr[..., :-(-x.shape[-1] * chain.up // chain.down)]
    sr = chain.sample_rate * chain.up / chain.down
    return mfcc(yr, chain.nfft, chain.hop, chain.n_mels, chain.n_mfcc, sr,
                chain.window)


def spectral_gate(x, gate) -> np.ndarray:
    """SpectralGate: pad both ends by nfft-hop, one-sided STFT, zero every
    bin whose magnitude is below threshold x the frame's peak, inverse with
    w^2-normalized OLA, trim the padding."""
    x = np.asarray(x, np.float64)
    n = x.shape[-1]
    pad = gate.nfft - gate.hop
    xp = np.pad(x, [(0, 0)] * (x.ndim - 1) + [(pad, pad)])
    spec = stft(xp, gate.nfft, gate.hop, gate.window, rfft=True)
    mag = np.abs(spec)
    keep = mag >= gate.threshold * mag.max(axis=-1, keepdims=True)
    out = istft(np.where(keep, spec, 0.0), gate.nfft, gate.hop, xp.shape[-1],
                gate.window, rfft=True)
    return out[..., pad:pad + n]


def rel_err(got, want) -> float:
    """max |got - want| / max |want| — the parity metric of every
    comparison here."""
    got = np.asarray(got)
    want = np.asarray(want)
    if got.shape != want.shape:
        raise ValueError(f"shape {got.shape} != reference {want.shape}")
    return float(np.abs(got - want).max() / np.abs(want).max())
