"""STFT / ISTFT / spectrogram (reference: src/spectral/stft.c).

Design: the reference processes one frame per call in a host loop
(vv_dsp_stft_process, src/spectral/stft.c:74-92); here the whole signal is
framed in one batched gather and transformed with ONE batched FFT over the
frame axis (one batched cuFFT call on the GPU). Reconstruction
(vv_dsp_stft_reconstruct, src/spectral/stft.c:95-110) becomes a scatter-add
overlap-add plus the w^2 normalization accumulator, divided out with the same
1e-12 guard as the reference driver (tools/dump_stft_roundtrip.c:50-54).

Semantics preserved:
- forward: frame -> window multiply -> unscaled C2C FFT (complex spectrum of
  all nfft bins; use `rfft=True` for the Hermitian-packed half spectrum),
- frames start at f*hop (non-centered), frame count for spectrogram
  = 1 if n < nfft else 1 + (n - nfft + hop)//hop (src/spectral/stft.c:118),
- inverse: 1/n-scaled IFFT -> multiply by window -> OLA; norm accumulates w^2.
- constraint hop <= nfft (src/spectral/stft.c:33).
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import jax.numpy as jnp

from vv_dsp_tpu import config
from vv_dsp_tpu.ops import framing
from vv_dsp_tpu.ops import fft as _fft
from vv_dsp_tpu.ops.window import get_window, get_window_np


@functools.lru_cache(maxsize=16)
def _windowed_rfft_basis(nfft: int, window: str, param, dtype_name: str):
    """(re, im) of diag(w) @ B_r2c, host-side f64 then cast: windowing a
    frame and multiplying by the DFT basis equals multiplying by the
    row-scaled basis, so the window costs ZERO extra HBM traffic."""
    w = get_window_np(window, nfft, param)
    b = _fft._dft_basis(nfft, "r2c") * w[:, None]
    dt = np.dtype(dtype_name)
    return (np.ascontiguousarray(b.real).astype(dt),
            np.ascontiguousarray(b.imag).astype(dt))


@dataclasses.dataclass(frozen=True)
class STFT:
    """Shape-specialized STFT "plan": precomputed window + static geometry.

    Equivalent of the vv_dsp_stft handle (src/spectral/stft.c:8-19); the
    reference supports boxcar/hann/hamming windows, we accept all 13.
    """

    nfft: int
    hop: int
    window: str = "hann"
    window_param: float | None = None
    dtype: object = None

    def __post_init__(self):
        if self.nfft <= 0 or self.hop <= 0 or self.hop > self.nfft:
            raise ValueError("need 0 < hop <= nfft (src/spectral/stft.c:33)")

    @property
    def win(self) -> jnp.ndarray:
        return get_window(self.window, self.nfft, self.window_param, self.dtype)

    def num_frames(self, n: int) -> int:
        """Frame count used by spectrogram (src/spectral/stft.c:118)."""
        if n < self.nfft:
            return 1
        return 1 + (n - self.nfft + self.hop) // self.hop

    def process(self, x, rfft: bool = False):
        """Forward STFT of (..., n) -> (..., frames, nfft) complex
        (or (..., frames, nfft//2+1) with rfft=True).

        Frames start at f*hop; the tail frame is zero-padded like
        vv_dsp_stft_spectrogram's tail handling (src/spectral/stft.c:124-137).
        """
        x = config.as_compute(x)
        if x.ndim != 2 and not jnp.iscomplexobj(x):
            # rank-oblivious fast path: fold leading axes into channels
            from vv_dsp_tpu.utils.shapes import collapse_leading
            x2, restore = collapse_leading(x)
            return restore(self.process(x2, rfft), 2)
        frames = self._windowed_frames(x)
        if rfft:
            return _fft.rfft(frames)
        return _fft.fft(frames)

    def _windowed_frames(self, x):
        """(..., n) -> (..., frames, nfft) windowed frames, tail frames
        zero-padded."""
        n = x.shape[-1]
        nf = self.num_frames(n)
        if self.nfft % self.hop == 0:
            # strided-reshape framing: dense slices instead of a gather
            frames = framing.frames_strided(x, self.nfft, self.hop, nf)
        else:
            idx, mask = framing.frame_indices(n, self.nfft, self.hop,
                                              center=False, n_frames=nf)
            frames = jnp.take(x, idx, axis=-1)
            frames = jnp.where(mask, frames, jnp.zeros_like(frames))
        return frames * self.win.astype(frames.dtype)

    def power(self, x):
        """One-sided power spectrogram |rfft(frames)|^2, fused so the complex
        spectrum never hits HBM (ops.fft.rfft_power): (..., n) ->
        (..., frames, nfft//2+1). The fast input to mel/MFCC."""
        x = config.as_compute(x)
        if x.ndim != 2 and not jnp.iscomplexobj(x):
            from vv_dsp_tpu.utils.shapes import collapse_leading
            x2, restore = collapse_leading(x)
            return restore(self.power(x2), 2)
        if self.supports_direct() and not jnp.iscomplexobj(x):
            # framing-free dense matmul tier: |X|^2 = re^2 + im^2
            re, im = self.power_parts(x)
            return re * re + im * im
        return _fft.rfft_power(self._windowed_frames(x))

    def supports_direct(self) -> bool:
        """True when the framing-free windowed-basis matmul path applies."""
        return (self.nfft % self.hop == 0
                and _fft._fft_tier(self.nfft, "r2c") == "dense")

    def power_parts(self, x, nf: int | None = None):
        """(re, im) of the windowed rfft, framing-free, for hop | nfft on
        the dense matmul tier: frame k spans x[k*hop : k*hop+nfft], so
        splitting the windowed basis into q = nfft/hop row blocks gives
        X[k] = sum_r x_view_r[k] @ Bw[r*hop:(r+1)*hop] where x_view_r is a
        plain strided reshape of x shifted by r*hop — the nfft/hop-times
        expanded windowed frames array NEVER materializes in HBM (it was
        the dominant cost of the chain's STFT stage).

        Returning the parts (instead of |.|^2) lets downstream LINEAR
        reductions of the power — the mel projection — fuse as
        (re*re) @ M + (im*im) @ M with no power array in HBM either
        (ops.mel.mel_energies_from_power_parts). Real input only (the
        windowed r2c basis assumes it)."""
        if jnp.iscomplexobj(x):
            raise TypeError("power_parts requires real input (windowed r2c)")
        x = config.as_compute(x)
        if nf is None:
            nf = self.num_frames(x.shape[-1])
        dt = _fft._real_compute_dtype(x)
        bre, bim = _windowed_rfft_basis(self.nfft, self.window,
                                        self.window_param, jnp.dtype(dt).name)
        q = self.nfft // self.hop
        hop = self.hop
        lead = x.shape[:-1]
        need = (nf - 1) * hop + self.nfft
        xp = x.astype(dt)
        if need > x.shape[-1]:
            xp = jnp.pad(xp, [(0, 0)] * len(lead)
                         + [(0, need - x.shape[-1])])
        re = im = 0.0
        for r in range(q):
            seg = xp[..., r * hop: r * hop + nf * hop].reshape(
                lead + (nf, hop))
            br = jnp.asarray(bre[r * hop: (r + 1) * hop])
            bi = jnp.asarray(bim[r * hop: (r + 1) * hop])
            re = re + jnp.einsum("...nh,hk->...nk", seg, br,
                                 precision=config.MATMUL_PRECISION)
            im = im + jnp.einsum("...nh,hk->...nk", seg, bi,
                                 precision=config.MATMUL_PRECISION)
        return re, im

    def reconstruct(self, spec, output_len: int, rfft: bool = False):
        """Inverse STFT with w^2-normalized overlap-add.

        spec: (..., frames, bins) -> (..., output_len). Matches
        dump_stft_roundtrip's per-sample y = recon/norm with norm > 1e-12
        guard (tools/dump_stft_roundtrip.c:50-54).
        """
        if rfft:
            time = _fft.irfft(spec, self.nfft)
        else:
            time = _fft.ifft(spec).real
        return self._ola_norm(time, output_len)

    def reconstruct_parts(self, re, im, output_len: int):
        """Inverse STFT from Hermitian-packed (re, im) rfft parts — the
        complex spectrum never exists: irfft(X) = re @ M_re - im @ M_im
        with M the weighted c2r basis (1/n scaling + Hermitian double
        weights folded in, ops.fft._dft_basis), then the same windowed
        w^2-normalized OLA as reconstruct. Pairs with power_parts for
        spectral-modification roundtrips (e.g. SpectralGate) that only
        rescale bins."""
        dtn = jnp.dtype(re.dtype).name
        mre = jnp.asarray(_fft._basis_cast(self.nfft, "c2r", "re", dtn))
        mim = jnp.asarray(_fft._basis_cast(self.nfft, "c2r", "im", dtn))
        time = (jnp.einsum("...nk,kt->...nt", re, mre,
                           precision=config.MATMUL_PRECISION)
                - jnp.einsum("...nk,kt->...nt", im, mim,
                             precision=config.MATMUL_PRECISION))
        return self._ola_norm(time, output_len)

    def _ola_norm(self, time, output_len: int):
        w = self.win.astype(time.dtype)
        ola = (framing.overlap_add_strided if self.nfft % self.hop == 0
               else framing.overlap_add)
        recon = ola(time * w, self.hop, output_len)
        nf = time.shape[-2]
        wsq = jnp.broadcast_to(w * w, (nf, self.nfft))
        norm = ola(wsq, self.hop, output_len)
        return jnp.where(norm > 1e-12, recon / jnp.where(norm > 1e-12, norm, 1.0),
                         recon)

    def spectrogram(self, x):
        """Magnitude spectrogram (vv_dsp_stft_spectrogram,
        src/spectral/stft.c:112-144): (..., n) -> (..., frames, nfft).

        Full two-sided bins like the reference; on the direct tier the
        one-sided half comes from the framing-free parts (no complex
        array) and the mirror is a concat (|X[n-k]| = |X[k]| — valid for
        REAL input only, hence the iscomplexobj guard)."""
        if self.supports_direct() and not jnp.iscomplexobj(x):
            re, im = self.power_parts(x)
            half = jnp.sqrt(re * re + im * im)
            lo = self.nfft - half.shape[-1] + 1
            return jnp.concatenate([half, half[..., 1:lo][..., ::-1]], -1)
        return jnp.abs(self.process(x))


def stft_spectrogram(x, nfft: int, hop: int, window: str = "hann"):
    return STFT(nfft, hop, window).spectrogram(x)


def power_spectrogram_onesided(x, nfft: int, hop: int, window: str = "hann"):
    """|rfft|^2 over frames — the input shape expected by the MFCC pipeline
    (reference builds it from vv_dsp_stft_spectrogram bins, tools/dump_mfcc.c)."""
    return STFT(nfft, hop, window).power(x)
