"""Flagship DSP pipelines (jittable, shardable).

Design: each pipeline is a frozen dataclass holding only static config and
host-precomputed float64->f32 constants; ``__call__(x)`` is a pure function of
the signal, so ``jax.jit(pipeline)``, ``vmap`` and ``shard_map`` all apply
directly. The sharded execution path (``apply_sharded``) runs the FIR and
resample stages as halo-exchange sharded ops and the frame-parallel stages
with the frame axis sharded over the block mesh axis.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp

from vv_dsp_tpu.ops import fir as _fir
from vv_dsp_tpu.ops import mel as _mel
from vv_dsp_tpu.ops.stft import STFT
from vv_dsp_tpu import parallel as _par




def _promote_audio(x):
    """Model entry promotion = the library-wide policy (config.as_compute):
    integer PCM and sub-f32 floats compute in f32; the matmul precision
    knob is the sanctioned accuracy/speed trade."""
    from vv_dsp_tpu import config
    return config.as_compute(x)

@dataclasses.dataclass(frozen=True)
class NorthStarChain:
    """1024-tap FIR -> up/down polyphase resample -> STFT -> log-mel -> MFCC.

    The BASELINE.json north-star configuration: the per-chip roofline chain
    whose Msamples/s (at the input rate) is the headline benchmark.
    """

    fir_taps: int = 1024
    fir_cutoff: float = 0.45
    up: int = 4
    down: int = 3
    nfft: int = 2048
    hop: int = 512
    n_mels: int = 80
    n_mfcc: int = 20
    sample_rate: float = 48000.0
    window: str = "hann"
    #: fuse FIR+resample into ONE banded-matrix matmul (sample-exact vs
    #: the staged pair; erases the intermediate HBM round trip)
    fused_head: bool = True

    @functools.cached_property
    def fir_coeffs(self):
        # host-side numpy at the configured real dtype: a first touch inside
        # a jit trace must not cache a Tracer (jnp.asarray yields one
        # there), and every FIR path accepts numpy taps
        import numpy as np
        from vv_dsp_tpu import config
        return _fir.design_lowpass_np(self.fir_taps, self.fir_cutoff
                                      ).astype(np.dtype(config.real_dtype()))

    @functools.cached_property
    def stft_plan(self) -> STFT:
        return STFT(self.nfft, self.hop, self.window)

    def __call__(self, x):
        """x: (channels, n) -> (channels, frames, n_mfcc)."""
        from vv_dsp_tpu.ops import resample as _rs
        x = _promote_audio(x)
        if self.fused_head:
            y = _rs.fir_resample_fused(self.fir_coeffs, x, self.up, self.down)
        else:
            y = _fir.fir_apply_best(self.fir_coeffs, x)
            y = _rs.resample_poly_best(y, self.up, self.down)
        return _mel.mfcc_stft(y, self.nfft, self.hop, self.n_mels,
                              self.n_mfcc, self.sample_rate * self.up
                              / self.down, window=self.window)

    def apply_sharded(self, x, mesh, fuse_halos: bool = True):
        """Multi-chip execution: FIR and resample run as halo-exchange
        sharded ops over the (channel, block) mesh; the STFT runs
        frame-sharded; the mel/MFCC matmuls partition over the sharded frame
        axis automatically (they contract only the bin axis).

        The head stays STAGED here (unlike __call__'s fused default): the
        composite filter's halo is ~up*fir_taps input samples, which for the
        flagship geometry exceeds typical per-shard blocks and would force
        multi-round halos on every step, while the fusion's benefit — one
        less HBM round trip — is a per-chip property the staged sharded ops
        already amortize across the halo exchange.

        fuse_halos=True (default) collapses the chain's FOUR per-stage halo
        exchanges (FIR left, polyphase left+right, STFT right) into ONE
        combined left+right raw-signal exchange per step: every shard pulls
        a deep input halo sized for the composed dependency cone and
        recomputes the ~1% of boundary work redundantly — 2 ppermute rounds
        instead of 4, numerically identical to the staged path (parity
        test: tests/test_parallel.py).  Falls back to the staged path when
        the geometry doesn't divide evenly."""
        if fuse_halos:
            try:
                return self._apply_sharded_fused(x, mesh)
            except ValueError:
                pass
        y = _par.fir_apply_sharded(self.fir_coeffs, x, mesh)
        y = _par.resample_poly_sharded(y, self.up, self.down, mesh)
        spec = _par.stft_process_sharded(y, self.nfft, self.hop, mesh,
                                         self.window)
        power = jnp.square(jnp.abs(spec))
        return _mel.mfcc(power, self.nfft, self.n_mels, self.n_mfcc,
                         self.sample_rate * self.up / self.down)

    def _apply_sharded_fused(self, x, mesh, channel_axis: str = "channel",
                             block_axis: str = "block"):
        """One combined halo exchange for the whole chain head (see
        apply_sharded).  Dependency-cone arithmetic: a local STFT frame
        needs `nfft-hop` resampled lookahead samples; resampled output j
        reads FIR output positions (half_len + j*down)//up - i for the
        taps_pp polyphase taps; FIR is causal with taps-1 history.  The
        anchor arithmetic is shard-independent because t_local*up is a
        multiple of down*up (same invariant as resample_poly_sharded)."""
        import math as _math
        import numpy as np
        from jax import lax
        from jax.sharding import PartitionSpec as P
        from vv_dsp_tpu.ops import resample as _rs
        from vv_dsp_tpu.ops import framing as _framing
        from vv_dsp_tpu.ops import fft as _offt
        from vv_dsp_tpu.ops.window import get_window
        from vv_dsp_tpu.parallel import halo as _halo
        from vv_dsp_tpu import config as _config

        g = _math.gcd(self.up, self.down)
        up, down = self.up // g, self.down // g
        nb = mesh.shape[block_axis]
        n = x.shape[-1]
        if n % (nb * down):
            raise ValueError("length must divide n_blocks * down")
        t = n // nb
        out_local = t * up // down
        if out_local % self.hop:
            raise ValueError("per-shard resampled length must divide hop")
        n2 = n * up // down

        taps = self.fir_taps
        h_np = np.asarray(self.fir_coeffs, dtype=np.float64)
        h_rs = _rs._resample_poly_filter(up, down)
        half_len = (len(h_rs) - 1) // 2
        h_pad = np.zeros((-(-len(h_rs) // up)) * up)
        h_pad[:len(h_rs)] = h_rs
        taps_pp = len(h_pad) // up
        hpp = h_pad.reshape(taps_pp, up).T
        overlap = self.nfft - self.hop

        # deep-halo sizes from the dependency cone (+1 margin each side)
        HL = taps - 1 + max(0, taps_pp - 1 - half_len // up) + 1
        ext_out = out_local + overlap
        HR = max(0, (half_len + (ext_out - 1) * down) // up - (t - 1)) + 1

        # local polyphase gather geometry over the FIR-extended block
        jj = np.arange(ext_out)
        tt = half_len + jj * down
        idx_np = HL + tt // up
        idx_np = idx_np[:, None] - np.arange(taps_pp)[None, :]
        w_np = hpp[tt % up]
        idx_j = jnp.asarray(idx_np, dtype=jnp.int32)
        w_j = jnp.asarray(w_np, dtype=jnp.float32)
        win = get_window(self.window, self.nfft)
        nf_local = out_local // self.hop

        @functools.partial(
            jax.shard_map, mesh=mesh,
            in_specs=(P(channel_axis, block_axis), P(), P(), P()),
            out_specs=P(channel_axis, block_axis, None),
            check_vma=False)
        def run(xb, idx_, w_, wn):
            left = _halo.halo_from_left(xb, HL, block_axis)
            right = _halo.halo_from_right(xb, HR, block_axis)
            ext = jnp.concatenate([left, xb, right], axis=-1)
            yf = _fir.fir_apply_mxu(h_np, ext)
            # FIR ring-out past the global signal end is NOT part of the
            # staged semantics (the resampler zero-pads beyond n): mask it
            idx_blk = lax.axis_index(block_axis)
            gposf = (idx_blk * t - HL
                     + jnp.arange(ext.shape[-1], dtype=jnp.int32))
            yf = jnp.where(gposf < n, yf, jnp.zeros_like(yf))
            gathered = jnp.take(yf, idx_, axis=-1)
            y2 = jnp.einsum("...ot,ot->...o", gathered, w_,
                            precision=_config.MATMUL_PRECISION)
            # resampled lookahead beyond n2 is zero in the staged path
            # (STFT right-halo zeros / zero-padded tail frames)
            gpos2 = (idx_blk * out_local
                     + jnp.arange(ext_out, dtype=jnp.int32))
            y2 = jnp.where(gpos2 < n2, y2, jnp.zeros_like(y2))
            # local STFT over the extended resampled block
            frames = _framing.frames_strided(y2, self.nfft, self.hop,
                                             nf_local) * wn
            return _offt.rfft(frames)

        spec = run(x, idx_j, w_j, win)
        power = jnp.square(jnp.abs(spec))
        return _mel.mfcc(power, self.nfft, self.n_mels, self.n_mfcc,
                         self.sample_rate * self.up / self.down)


@dataclasses.dataclass(frozen=True)
class SpectralGate:
    """The reference's end-to-end benchmark pipeline: frame -> window -> FFT
    -> spectral magnitude gate -> IFFT -> OLA (bench/bench_pipeline.c:77-120).

    Gate: zero every bin whose magnitude is below `threshold` x the frame's
    peak magnitude."""

    nfft: int = 1024
    hop: int = 256
    threshold: float = 0.1
    window: str = "hann"

    @functools.cached_property
    def stft_plan(self) -> STFT:
        return STFT(self.nfft, self.hop, self.window)

    def _gate(self, spec):
        mag = jnp.abs(spec)
        peak = jnp.max(mag, axis=-1, keepdims=True)
        return jnp.where(mag >= self.threshold * peak, spec,
                         jnp.zeros_like(spec))

    @property
    def _edge_pad(self) -> int:
        # COLA coverage padding: the first/last nfft-hop samples of a raw
        # OLA roundtrip have partial window coverage (norm ~ w(t)^2 -> 0),
        # and once gating perturbs a frame, dividing by that tiny norm
        # amplifies the edge error unboundedly (measured 420x on a sine).
        # Zero-padding both ends by nfft-hop gives every REAL sample full
        # coverage; the pure roundtrip stays sample-exact. (The reference's
        # pipeline bench sidesteps this by never normalizing at all —
        # bench/bench_pipeline.c:140-144 passes NULL for norm.)
        return self.nfft - self.hop

    def __call__(self, x):
        """x: (channels, n) -> (channels, n) denoised."""
        x = _promote_audio(x)
        if x.ndim != 2 and not jnp.iscomplexobj(x):
            # rank-oblivious: fold leading axes into channels
            from vv_dsp_tpu.utils.shapes import collapse_leading
            x2, restore = collapse_leading(x)
            return restore(self(x2), 1)
        n = x.shape[-1]
        pad = self._edge_pad
        xp = jnp.pad(x, [(0, 0)] * (x.ndim - 1) + [(pad, pad)])
        n_pad = xp.shape[-1]
        if self.stft_plan.supports_direct():
            # parts-form roundtrip: framing-free forward, gate on squared
            # magnitudes (mag >= t*peak  <=>  mag^2 >= t^2*peak^2), matmul
            # c2r inverse — no complex array anywhere
            re, im = self.stft_plan.power_parts(xp)
            p2 = re * re + im * im
            peak2 = jnp.max(p2, axis=-1, keepdims=True)
            keep = p2 >= (self.threshold * self.threshold) * peak2
            zero = jnp.zeros_like(re)
            out = self.stft_plan.reconstruct_parts(
                jnp.where(keep, re, zero), jnp.where(keep, im, zero), n_pad)
        else:
            spec = self.stft_plan.process(xp, rfft=True)
            out = self.stft_plan.reconstruct(self._gate(spec), n_pad,
                                             rfft=True)
        return out[..., pad:pad + n]

    def apply_sharded(self, x, mesh):
        n = x.shape[-1]
        pad = self._edge_pad
        xp = jnp.pad(x, [(0, 0)] * (x.ndim - 1) + [(pad, pad)])
        spec = _par.stft_process_sharded(xp, self.nfft, self.hop, mesh,
                                         self.window, pad=True)
        gated = self._gate(spec)
        out = _par.stft_reconstruct_sharded(gated, self.nfft, self.hop, mesh,
                                            self.window)
        return out[..., pad:pad + n]


@dataclasses.dataclass(frozen=True)
class MFCCFrontend:
    """Signal -> MFCC features, the tools/dump_mfcc.c chain as one model:
    STFT power spectrogram -> mel filterbank -> log -> DCT-II -> lifter."""

    nfft: int = 1024
    hop: int = 256
    n_mels: int = 26
    n_mfcc: int = 13
    sample_rate: float = 16000.0
    lifter: float = 0.0
    window: str = "hann"
    fmin: float = 0.0
    fmax: float | None = None

    @functools.cached_property
    def stft_plan(self) -> STFT:
        return STFT(self.nfft, self.hop, self.window)

    def __call__(self, x):
        """x: (channels, n) -> (channels, frames, n_mfcc)."""
        x = _promote_audio(x)
        return _mel.mfcc_stft(x, self.nfft, self.hop, self.n_mels,
                              self.n_mfcc, self.sample_rate,
                              window=self.window, fmin=self.fmin,
                              fmax=self.fmax, lifter=self.lifter)
