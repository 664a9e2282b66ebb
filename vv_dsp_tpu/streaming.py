"""Streaming (block-at-a-time) processing with carried state.

The reference's streaming surface is stateful C structs advanced one block at
a time: the FIR history ring buffer (vv_dsp_fir_state, src/filter/fir.c:
160-196), the per-biquad z1/z2 registers (src/filter/iir.h:14-17), the STFT
handle's frame-by-frame process/reconstruct (src/spectral/stft.c:74-110) and
the resampler handle (src/resample/resampler.c). Re-design:

- state is an explicit immutable pytree; every `*_process` is a pure function
  (state, block) -> (output, new_state), so it jits, vmaps, and composes with
  lax.scan for offline replay of a streaming pipeline;
- block outputs are bit-identical (to float tolerance) to the offline ops on
  the concatenated signal — asserted by tests/test_streaming.py;
- the streaming resampler emits with a fixed latency instead of looking
  ahead, so equal input blocks yield equal-size output blocks (static shapes
  under jit); `flush` drains the tail.

These states are also exactly the per-stream quantities a checkpointing
pipeline must save/restore (SURVEY.md section 5.4).
"""

from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np
import jax
import jax.numpy as jnp

from vv_dsp_tpu.ops import fft as _offt

from vv_dsp_tpu import config

from vv_dsp_tpu.ops import fir as _fir
from vv_dsp_tpu.ops import iir as _iir
from vv_dsp_tpu.ops import resample as _resample
from vv_dsp_tpu.ops.window import get_window


# ---------------------------------------------------------------------------
# chunked streaming: many blocks per device dispatch
# ---------------------------------------------------------------------------

def scan_stream(step, state, signal, block_len, out_axis=-1):
    """Run a streaming `step` over K consecutive blocks in ONE dispatch.

    `step` is any (state, (..., block_len)) -> (out, new_state) pure stream
    step from this module (or a composition like StreamingNorthStar.process).
    `signal` is (..., K*block_len); the K blocks run under `lax.scan`, so the
    whole sweep compiles to a single device program — the serving-side answer
    to per-call dispatch latency (the reference advances its stateful structs
    one host call per block, src/filter/fir.c:160-196; here one host call
    covers K blocks). Semantics are EXACTLY K sequential `step` calls.

    `out_axis` is the axis of each per-block output along which consecutive
    blocks concatenate: -1 for sample streams (FIR/IIR/resample/ISTFT),
    -2 for frame streams ((..., frames, bins/coeffs) from STFT analysis or
    the MFCC chain). Returns (merged_outputs, final_state).
    """
    total = signal.shape[-1]
    if block_len <= 0 or total % block_len:
        raise ValueError(
            f"signal length {total} must be a positive multiple of "
            f"block_len {block_len}")
    k = total // block_len
    blocks = jnp.moveaxis(
        signal.reshape(signal.shape[:-1] + (k, block_len)), -2, 0)

    def body(s, blk):
        out, s2 = step(s, blk)
        return s2, out

    state, outs = jax.lax.scan(body, state, blocks)
    if not isinstance(outs, jax.Array):
        # a composed step returning a pytree (e.g. a tuple of streams) would
        # otherwise crash below on .ndim with an opaque AttributeError
        raise TypeError(
            "scan_stream expects step to return a single array per block; "
            f"got {jax.tree_util.tree_structure(outs)} — merge multi-output "
            "steps yourself (jax.tree_util.tree_map over lax.scan) or wrap "
            "the step to return one array")
    # outs: (k, ...out_shape...) — fold the block axis into out_axis.
    a = out_axis if out_axis < 0 else out_axis - (outs.ndim - 1)
    if not (-(outs.ndim - 1) <= a <= -1):
        raise ValueError(f"out_axis {out_axis} out of range for per-block "
                         f"output of rank {outs.ndim - 1}")
    outs = jnp.moveaxis(outs, 0, a - 1)
    pos = outs.ndim + (a - 1)
    shape = outs.shape
    merged = shape[:pos] + (shape[pos] * shape[pos + 1],) + shape[pos + 2:]
    return outs.reshape(merged), state


# ---------------------------------------------------------------------------
# FIR
# ---------------------------------------------------------------------------

def fir_stream_init(h, batch_shape=(), dtype=jnp.float32):
    """Zeroed taps-1 history (the reference zeroes its ring buffer on init,
    src/filter/fir.c:147-153)."""
    taps = np.asarray(h).shape[-1]
    return jnp.zeros(tuple(batch_shape) + (taps - 1,), dtype=dtype)


def fir_stream_process(h, state, block):
    """One block of causal FIR: y = conv(history ++ block) restricted to the
    block; returns (y, new_state). Matches vv_dsp_fir_apply's cross-call
    contract (src/filter/fir.c:160-196)."""
    h = jnp.asarray(h, dtype=block.dtype)
    taps = h.shape[-1]
    if taps == 1:
        return h[0] * block, state
    ext = jnp.concatenate([state, block], axis=-1)
    if taps > 32:  # block-Toeplitz matmul form, same dispatch as the sharded op
        y = _fir.fir_apply_mxu(h, ext)[..., taps - 1:]
    else:
        y = _fir.fir_apply(h, ext)[..., taps - 1:]
    return y, ext[..., -(taps - 1):]


# ---------------------------------------------------------------------------
# IIR
# ---------------------------------------------------------------------------

def iir_stream_init(sos, batch_shape=(), dtype=jnp.float32):
    """(..., n_stages, 2) zero z1/z2 registers."""
    rows = _iir.normalize_sos(sos)
    return jnp.zeros(tuple(batch_shape) + (len(rows), 2), dtype=dtype)


def iir_stream_process(sos, state, block):
    """One block through the biquad cascade with carried per-stage state;
    identical to sosfilt with zi (the reference carries z1/z2 across calls
    implicitly in its struct, src/filter/iir.c:21-27)."""
    rows = _iir.normalize_sos(sos)
    y = block
    new_states = []
    for i, (b0, b1, b2, a1, a2) in enumerate(rows):
        A_cum, b_cum = _iir._biquad_cumulative(y, b0, b1, b2, a1, a2)
        y, s = _iir._biquad_output(y, b0, state[..., i, :], A_cum, b_cum)
        new_states.append(s)
    return y, jnp.stack(new_states, axis=-2)


# ---------------------------------------------------------------------------
# STFT analysis / OLA synthesis
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class StftStream:
    """Streaming STFT geometry (blocks must be multiples of hop)."""

    nfft: int
    hop: int
    window: str = "hann"

    def analysis_init(self, batch_shape=(), dtype=jnp.float32):
        """Carried input tail of nfft-hop samples."""
        return jnp.zeros(tuple(batch_shape) + (self.nfft - self.hop,), dtype)

    def frames(self, state, block):
        """Shared windowed-framing step: (state, (..., k*hop)) ->
        ((..., k, nfft) frames, new_state). Used by analysis and by streaming
        pipelines that want a fused power spectrum instead of complex bins."""
        b = block.shape[-1]
        if b % self.hop:
            raise ValueError("block length must be a multiple of hop")
        ext = jnp.concatenate([state, block], axis=-1)
        k = b // self.hop
        win = get_window(self.window, self.nfft, dtype=block.dtype)
        if self.nfft % self.hop == 0:
            from vv_dsp_tpu.ops.framing import frames_strided
            frames = frames_strided(ext, self.nfft, self.hop, k) * win
        else:
            idx = (jnp.arange(k, dtype=jnp.int32)[:, None] * self.hop
                   + jnp.arange(self.nfft, dtype=jnp.int32)[None, :])
            frames = jnp.take(ext, idx, axis=-1) * win
        # positive-offset slice: with nfft == hop the carried tail is EMPTY
        # (a -0 slice would wrongly return the whole buffer)
        tail_start = ext.shape[-1] - (self.nfft - self.hop)
        return frames, ext[..., tail_start:]

    def analysis(self, state, block, rfft: bool = True):
        """(state, (..., k*hop)) -> ((..., k, bins), new_state). Frame f of
        call t covers global samples [t*B + f*hop - (nfft-hop), ... + nfft),
        i.e. analysis runs with nfft-hop latency relative to block arrival —
        the same frames the offline STFT emits, in order, no frame skipped."""
        frames, new_state = self.frames(state, block)
        spec = _offt.rfft(frames) if rfft else _offt.fft(frames)
        return spec, new_state

    def synthesis_init(self, batch_shape=(), dtype=jnp.float32):
        """Carried OLA accumulators (data, w^2 norm) of nfft-hop samples."""
        z = jnp.zeros(tuple(batch_shape) + (self.nfft - self.hop,), dtype)
        return z, z

    def synthesis(self, state, spec, rfft: bool = True):
        """(state, (..., k, bins)) -> ((..., k*hop), new_state): inverse FFT,
        window, overlap-add with carried tail, w^2-normalized with the
        reference's 1e-12 guard (tools/dump_stft_roundtrip.c:50-54)."""
        acc, norm_acc = state
        if rfft:
            time = _offt.irfft(spec, self.nfft)
        else:
            time = _offt.ifft(spec).real
        win = get_window(self.window, self.nfft, dtype=time.dtype)
        k = spec.shape[-2]
        out_len = k * self.hop
        overlap = self.nfft - self.hop
        buf_len = out_len + overlap
        from vv_dsp_tpu.ops.framing import overlap_add, overlap_add_strided
        ola = (overlap_add_strided if self.nfft % self.hop == 0
               else overlap_add)
        recon = ola(time * win, self.hop, buf_len)
        wsq = jnp.broadcast_to(win * win, (k, self.nfft))
        norm = jnp.broadcast_to(ola(wsq, self.hop, buf_len), recon.shape)
        recon = recon.at[..., :overlap].add(acc)
        norm = norm.at[..., :overlap].add(norm_acc)
        y, ny = recon[..., :out_len], norm[..., :out_len]
        good = ny > 1e-12
        y = jnp.where(good, y / jnp.where(good, ny, 1.0), y)
        return y, (recon[..., out_len:], norm[..., out_len:])


# ---------------------------------------------------------------------------
# polyphase resampler stream
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=32)
def _poly_stream_tables(up: int, down: int, b: int, dtype_name: str):
    """HOST-side (numpy) gather indices and phase weights for one block
    geometry of ResamplePolyStream.process — cached as numpy and converted
    at the use site: caching jnp arrays here leaks a trace-constant when
    the first call happens under jit (UnexpectedTracerError on the second
    trace; the library-wide rule from models/pipeline.fir_coeffs)."""
    h = _resample._resample_poly_filter(up, down)
    half_len = (len(h) - 1) // 2
    h_pad = np.zeros((-(-len(h) // up)) * up)
    h_pad[: len(h)] = h
    taps_pp = len(h_pad) // up
    hpp = h_pad.reshape(taps_pp, up).T
    n_out = b * up // down
    j = np.arange(n_out)
    t_loc = half_len + j * down
    anchor = t_loc // up
    phase = t_loc % up
    idx = anchor[:, None] - np.arange(taps_pp)[None, :] + taps_pp - 1
    return (np.ascontiguousarray(idx.astype(np.int32)),
            np.ascontiguousarray(hpp[phase].astype(np.dtype(dtype_name))))


@dataclasses.dataclass(frozen=True)
class ResamplePolyStream:
    """Streaming scipy-parity polyphase resampler with fixed latency.

    Feeding blocks of B input samples (B % down == 0, B >= delay) emits
    exactly B*up/down outputs per call. The emitted stream equals
    resample_poly(x) of the concatenated input preceded by `latency_out`
    lead-in samples (the resample of the implicit pre-signal zeros): drop the
    first `latency_out` emitted samples for exact offline parity, and call
    `flush()` once at end-of-stream to drain the final `latency_out` outputs.

    The reference's streaming resampler re-evaluates windowed sinc per output
    with a persistent position (src/resample/resampler.c; profiled at
    0.80-0.82 Msamples/s) — here it is the same dense polyphase gather+matvec
    as the offline path.
    """

    up: int
    down: int

    def __post_init__(self):
        g = math.gcd(self.up, self.down)
        object.__setattr__(self, "up", self.up // g)
        object.__setattr__(self, "down", self.down // g)

    @functools.cached_property
    def _geometry(self):
        h = _resample._resample_poly_filter(self.up, self.down)
        half_len = (len(h) - 1) // 2
        h_pad = np.zeros((-(-len(h) // self.up)) * self.up)
        h_pad[:len(h)] = h
        taps_pp = len(h_pad) // self.up
        hpp = h_pad.reshape(taps_pp, self.up).T
        # Lookahead in input samples (future span of the centered filter),
        # rounded up to a multiple of `down` so per-block geometry repeats.
        look = -(-half_len // self.up) + 1
        delay_in = -(-look // self.down) * self.down
        hist = taps_pp - 1 + delay_in
        return hpp, taps_pp, half_len, delay_in, hist

    @property
    def latency_out(self) -> int:
        """Output-sample latency of the stream."""
        _, _, _, delay_in, _ = self._geometry
        return delay_in * self.up // self.down

    def init(self, batch_shape=(), dtype=jnp.float32):
        """Zero input history of taps_pp-1+delay samples (pre-signal zeros)."""
        *_, hist = self._geometry
        return jnp.zeros(tuple(batch_shape) + (hist,), dtype)

    def process(self, state, block):
        """(state, (..., B)) -> ((..., B*up/down), new_state)."""
        hpp, taps_pp, half_len, delay_in, hist = self._geometry
        b = block.shape[-1]
        if b % self.down:
            raise ValueError("block length must be a multiple of `down`")
        ext = jnp.concatenate([state, block], axis=-1)
        n_out = b * self.up // self.down
        # Call t's ext buffer covers global inputs [tB - hist, (t+1)B).
        # This call emits global outputs K in [t*n_out - latency, ...+n_out);
        # output K gathers inputs ext-indexed at
        #   (taps_pp - 1) + (half_len + j*down)//up - i,  i in [0, taps_pp)
        # with weight hpp[(half_len + j*down) % up, i] — the same polyphase
        # anchor/phase decomposition as ops.resample._upfirdn_gather, shifted
        # so the filter's future span (delay_in) is already in the buffer.
        # Tables depend only on (up, down, b): cached so the eager block loop
        # doesn't rebuild/re-upload them every call.
        idx_np, w_np = _poly_stream_tables(self.up, self.down, b,
                                           str(block.dtype))
        idx, w = jnp.asarray(idx_np), jnp.asarray(w_np)
        gathered = jnp.take(ext, idx, axis=-1)
        y = jnp.einsum("...ot,ot->...o", gathered, w,
                       precision=config.MATMUL_PRECISION)
        return y, ext[..., -hist:]

    def flush(self, state):
        """Drain the final latency_out outputs by pushing delay_in zeros
        (end-of-signal zero padding, same as the offline edge masking)."""
        _, _, _, delay_in, _ = self._geometry
        zeros = jnp.zeros(state.shape[:-1] + (delay_in,), state.dtype)
        y, _ = self.process(state, zeros)
        return y
