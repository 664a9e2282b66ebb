"""Sharded DSP operators: FIR, IIR, STFT, polyphase resample over a
(channel, block) mesh.

Each operator is numerically identical to its single-device counterpart in
``vv_dsp_tpu.ops`` (the parity tests assert this on an 8-device CPU mesh);
the seams between time-block shards are stitched with the halo exchanges in
``vv_dsp_tpu.parallel.halo``:

  op              halo                     reference state being replaced
  ----------      ----------------------   ---------------------------------
  FIR             taps-1 from left         history ring buffer
                                           (src/filter/fir.c:170-193)
  STFT analysis   nfft-hop from right      frame overlap into next block
                                           (src/spectral/stft.c:74-92)
  STFT synthesis  nfft-hop spill to right  OLA + w^2 norm accumulation
                                           (src/spectral/stft.c:103-109)
  IIR             per-shard affine compose DF2T recurrence
                  (all_gather, exclusive   (src/filter/iir.c:21-27)
                  prefix over blocks)
  resample_poly   polyphase taps each way  (reference is single-block only)

Sharding contract: global arrays are (channels, time) [or (channels, frames,
bins) for spectra]; the channel axis shards over mesh axis "channel"
(embarrassingly parallel), the time/frame axis over "block". Time length must
divide evenly by the block-shard count (use mesh.pad_to_blocks).
"""

from __future__ import annotations

import functools
import math

import numpy as np
import jax
import jax.numpy as jnp

from vv_dsp_tpu.ops import fft as _offt
from jax import lax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from vv_dsp_tpu import config
from vv_dsp_tpu.ops import fir as _fir
from vv_dsp_tpu.ops import iir as _iir
from vv_dsp_tpu.ops import framing as _framing
from vv_dsp_tpu.ops import resample as _resample
from vv_dsp_tpu.ops.window import get_window
from vv_dsp_tpu.parallel import halo as _halo


def shard_channels(x, mesh: Mesh, channel_axis: str = "channel"):
    """Place a (channels, ...) array with the channel axis sharded — the
    embarrassingly-parallel data layout every pointwise/spectral op in
    vv_dsp_tpu.ops accepts unchanged (XLA partitions them automatically)."""
    spec = P(channel_axis, *([None] * (x.ndim - 1)))
    return jax.device_put(x, NamedSharding(mesh, spec))


# ---------------------------------------------------------------------------
# FIR — overlap-save with left halo (the ring-buffer replacement)
# ---------------------------------------------------------------------------

def fir_apply_sharded(h, x, mesh: Mesh, channel_axis: str = "channel",
                      block_axis: str = "block", use_fft: bool | None = None):
    """Causal FIR over a sharded time axis; identical to ops.fir.fir_apply.

    x: (channels, n) with n % n_block_shards == 0. Each shard pulls the
    taps-1 sample halo from its left neighbor (zeros on shard 0 = zero
    initial history) and runs a local conv — direct (implicit GEMM) for
    small taps, block-Toeplitz matmuls above 32 taps, overlap-save rFFT
    with use_fft=True.
    """
    if isinstance(h, jax.core.Tracer):
        h_np = h  # fir_apply_mxu handles traced taps with on-device tables
        hj = h.astype(x.dtype)
    else:
        h_np = np.asarray(h, dtype=np.float64)  # concrete Toeplitz/FFT tables
        hj = jnp.asarray(h_np.astype(np.dtype(x.dtype)))
    taps = h_np.shape[-1]

    @functools.partial(
        jax.shard_map, mesh=mesh,
        in_specs=P(channel_axis, block_axis),
        out_specs=P(channel_axis, block_axis))
    def run(xb):
        left = _halo.halo_from_left(xb, taps - 1, block_axis)
        ext = jnp.concatenate([left, xb], axis=-1)
        if use_fft:
            y = _fir.fir_apply_os(hj, ext)
        elif use_fft is None and taps > 32:
            # block-Toeplitz matmul form (coefficients close over the
            # mapped body as constants; traced taps are supported)
            y = _fir.fir_apply_mxu(h_np, ext)
        else:
            y = _fir.fir_apply(hj, ext)
        return y[..., taps - 1:]

    return run(x)


# ---------------------------------------------------------------------------
# IIR — block-local associative scan + cross-shard affine composition
# ---------------------------------------------------------------------------

def iir_apply_sharded(sos, x, mesh: Mesh, channel_axis: str = "channel",
                      block_axis: str = "block"):
    """Biquad cascade over a sharded time axis; identical to ops.iir.iir_apply.

    Per stage: each shard computes its cumulative affine maps
    (A_cum, b_cum) via associative scan, all_gathers the per-shard TOTAL maps
    over the block axis, folds the exclusive prefix (a static loop over the
    shard count — n_blocks tiny 2x2 matmuls), and corrects its local output
    with the resulting entry state. Stage loop is static (cascades are short).
    """
    rows = _iir.normalize_sos(sos)
    nb = mesh.shape[block_axis]

    @functools.partial(
        jax.shard_map, mesh=mesh,
        in_specs=P(channel_axis, block_axis),
        out_specs=P(channel_axis, block_axis))
    def run(xb):
        my = lax.axis_index(block_axis)
        y = xb
        for b0, b1, b2, a1, a2 in rows:
            A_cum, b_cum = _iir._biquad_cumulative(y, b0, b1, b2, a1, a2)
            # Per-shard total map. A_tot is data-independent (A^t_local,
            # identical on every equal-length shard); only b_tot is gathered.
            A_tot = A_cum[..., -1, :, :]
            b_tot = b_cum[..., -1, :]  # (ch_local, 2)
            if nb == 1:
                s0 = None
            else:
                b_all = lax.all_gather(b_tot, block_axis)  # (nb, ch, 2)
                A_loc = A_tot[0] if A_tot.ndim == 3 else A_tot
                s = jnp.zeros_like(b_all[0])
                entries = [s]
                for k in range(1, nb):
                    s = jnp.einsum("ij,...j->...i", A_loc, s) + b_all[k - 1]
                    entries.append(s)
                s0 = jnp.take(jnp.stack(entries), my, axis=0)
            y, _ = _iir._biquad_output(y, b0, s0, A_cum, b_cum)
        return y

    return run(x)


# ---------------------------------------------------------------------------
# STFT — analysis right-halo, synthesis right-spill OLA
# ---------------------------------------------------------------------------

def stft_process_sharded(x, nfft: int, hop: int, mesh: Mesh,
                         window: str = "hann", rfft: bool = True,
                         channel_axis: str = "channel",
                         block_axis: str = "block", pad: bool = False):
    """Forward STFT over a time-sharded signal, any hop <= nfft
    (src/spectral/stft.c:33 generality).

    x: (channels, n); n % (n_block_shards * hop) == 0 required so frame
    ownership is uniform (pass pad=True to zero-pad any n up to the next
    multiple — the reference's zero-padded tail frames,
    src/spectral/stft.c:124-137). Shard k owns the frames starting inside
    its block, pulling nfft-hop samples of right halo. nfft need NOT divide
    by hop: non-divisible geometries frame with an in-shard gather instead
    of the strided reshape.

    Returns (channels, n//hop, bins) with the FRAME axis sharded over
    `block_axis` — feed it straight to sharded spectral ops or
    stft_reconstruct_sharded without any resharding. The global frame count
    covers all tail frames; slice [..., :nf, :] for the reference's
    spectrogram count 1 + (n - nfft + hop)//hop.
    """
    nb = mesh.shape[block_axis]
    if pad:
        rem = (-x.shape[-1]) % (nb * hop)
        if rem:
            x = jnp.pad(x, [(0, 0)] * (x.ndim - 1) + [(0, rem)])
    n = x.shape[-1]
    if n % (nb * hop):
        raise ValueError("signal length must divide n_block_shards * hop "
                         "(or pass pad=True)")
    win = get_window(window, nfft, dtype=x.dtype)
    overlap = nfft - hop

    @functools.partial(
        jax.shard_map, mesh=mesh,
        in_specs=(P(channel_axis, block_axis), P()),
        out_specs=P(channel_axis, block_axis, None))
    def run(xb, w):
        right = _halo.halo_from_right(xb, overlap, block_axis)
        ext = jnp.concatenate([xb, right], axis=-1)
        t_local = xb.shape[-1]
        nf_local = t_local // hop
        if nfft % hop == 0:
            frames = _framing.frames_strided(ext, nfft, hop, nf_local)
        else:
            idx = (jnp.arange(nf_local, dtype=jnp.int32)[:, None] * hop
                   + jnp.arange(nfft, dtype=jnp.int32)[None, :])
            frames = jnp.take(ext, idx, axis=-1)
        frames = frames * w
        if rfft:
            return _offt.rfft(frames)
        return _offt.fft(frames)

    return run(x, win)


def stft_reconstruct_sharded(spec, nfft: int, hop: int, mesh: Mesh,
                             window: str = "hann", rfft: bool = True,
                             channel_axis: str = "channel",
                             block_axis: str = "block"):
    """Inverse STFT with w^2-normalized OLA over frame-sharded spectra.

    spec: (channels, frames, bins) with the frame axis sharded as produced by
    stft_process_sharded (any hop <= nfft; non-divisible geometries use the
    scatter overlap-add). Each shard OLA's its frames into a local buffer of
    t_local + (nfft-hop) samples, sends the tail spill (data AND w^2 norm) to
    its right neighbor via ppermute, and divides with the reference's 1e-12
    guard (tools/dump_stft_roundtrip.c:50-54). Returns (channels, frames*hop).
    """
    win = get_window(window, nfft)
    overlap = nfft - hop
    ola = (_framing.overlap_add_strided if nfft % hop == 0
           else _framing.overlap_add)

    @functools.partial(
        jax.shard_map, mesh=mesh,
        in_specs=(P(channel_axis, block_axis, None), P()),
        out_specs=P(channel_axis, block_axis))
    def run(sb, w):
        if rfft:
            time = _offt.irfft(sb, nfft)
        else:
            time = _offt.ifft(sb).real
        w = w.astype(time.dtype)
        nf_local = sb.shape[-2]
        t_local = nf_local * hop
        buf_len = t_local + overlap
        recon = ola(time * w, hop, buf_len)
        wsq = jnp.broadcast_to(w * w, (nf_local, nfft))
        norm = jnp.broadcast_to(ola(wsq, hop, buf_len), recon.shape)
        # Stitch the seam: the tail spill of both accumulators (data and w^2
        # norm, stacked so they ride one exchange) is added onto the right
        # neighbors — across several blocks when nfft-hop > t_local. Zeros
        # arrive at shard 0; the last shard's overflow is dropped (OLA bounds
        # clipping, src/core/framing.c:137-146).
        spill = jnp.stack([recon[..., t_local:], norm[..., t_local:]])
        both = jnp.stack([recon[..., :t_local], norm[..., :t_local]])
        both = _halo.spill_add_right(both, spill, block_axis)
        recon, norm = both[0], both[1]
        good = norm > 1e-12
        return jnp.where(good, recon / jnp.where(good, norm, 1.0), recon)

    return run(spec, win)


# ---------------------------------------------------------------------------
# Polyphase resampling — two-sided halo
# ---------------------------------------------------------------------------

def resample_poly_sharded(x, up: int, down: int, mesh: Mesh,
                          channel_axis: str = "channel",
                          block_axis: str = "block"):
    """scipy-parity polyphase resample over a sharded time axis.

    x: (channels, n) with n % (n_block_shards * down) == 0, so every shard
    emits exactly t_local*up/down samples. The centered anti-alias filter
    needs ceil(half_len/up) samples of right halo and taps_pp-1 of left halo
    per shard; anchor arithmetic is shard-independent because t_local*up is a
    multiple of up (see ops.resample._upfirdn_gather for the dense polyphase
    core this mirrors).
    """
    g = math.gcd(up, down)
    up //= g
    down //= g
    if up == 1 and down == 1:
        return x
    nb = mesh.shape[block_axis]
    n = x.shape[-1]
    if n % (nb * down):
        raise ValueError("signal length must divide n_block_shards * down")
    h = _resample._resample_poly_filter(up, down)
    half_len = (len(h) - 1) // 2
    h_pad = np.zeros((-(-len(h) // up)) * up)
    h_pad[:len(h)] = h
    taps_pp = len(h_pad) // up
    hpp = h_pad.reshape(taps_pp, up).T  # hpp[p, i] = h[p + i*up]
    halo_l = taps_pp - 1
    halo_r = -(-half_len // up) + 1
    t_local = n // nb
    out_local = t_local * up // down

    # Local gather geometry (identical on every shard): output j reads input
    # ext[anchor_j + halo_l - i] for tap i, anchor_j = (half_len + j*down)//up.
    j = np.arange(out_local)
    t = half_len + j * down
    anchor = t // up
    phase = t % up
    idx = anchor[:, None] - np.arange(taps_pp)[None, :] + halo_l
    w_np = hpp[phase]  # (out_local, taps_pp)

    idx_j = jnp.asarray(idx, dtype=jnp.int32)
    w_j = jnp.asarray(w_np, dtype=x.dtype)

    @functools.partial(
        jax.shard_map, mesh=mesh,
        in_specs=(P(channel_axis, block_axis), P(), P()),
        out_specs=P(channel_axis, block_axis))
    def run(xb, idx_, w_):
        left = _halo.halo_from_left(xb, halo_l, block_axis)
        right = _halo.halo_from_right(xb, halo_r, block_axis)
        ext = jnp.concatenate([left, xb, right], axis=-1)
        gathered = jnp.take(ext, idx_, axis=-1)  # (ch, out_local, taps_pp)
        return jnp.einsum("...ot,ot->...o", gathered, w_,
                          precision=config.MATMUL_PRECISION)

    return run(x, idx_j, w_j)


# ---------------------------------------------------------------------------
# Savitzky-Golay and zero-phase FIR — two-sided halos
# ---------------------------------------------------------------------------

def _edge_fixed_ext(xb, halo: int, n_total: int, nb: int, block_axis: str,
                    reflect_mode: str):
    """Two-sided halo'd window with global-edge padding applied.

    Returns ext = virtually-padded-global-signal[start-halo, start+t+halo)
    for this shard, where out-of-signal positions follow `reflect_mode`:
    'reflect'   pad[-i] = x[i]     (savgol REFLECT, np.pad 'reflect'),
    'symmetric' pad[-i] = x[i-1]   (filtfilt edge padding, np.pad
                                    'symmetric').

    halo may exceed the per-shard block: the halo exchange runs multi-block
    ppermute rounds, and — key property — every reflected position g' of an
    out-of-signal g in this shard's window satisfies |g'| <= halo, which is
    always inside the shard's own (t + 2*halo) window, so the fix-up is a
    local gather (no extra communication).
    """
    left = _halo.halo_from_left(xb, halo, block_axis)
    right = _halo.halo_from_right(xb, halo, block_axis)
    ext = jnp.concatenate([left, xb, right], axis=-1)
    t = xb.shape[-1]
    idx = lax.axis_index(block_axis)
    # NB: 'reflect' needs strict halo < t — reflecting position -halo reads
    # x[halo], which at halo == t lives in the NEIGHBOR shard (the slice
    # below would come up one element short); the gather path handles it.
    if halo < t or (halo == t and reflect_mode != "reflect"):
        # fast static path: only the first/last shard has out-of-signal
        # positions, covered by its own block (+ right/left halo)
        if reflect_mode == "reflect":
            refl_l = xb[..., 1: halo + 1][..., ::-1]
            refl_r = xb[..., t - 1 - halo: t - 1][..., ::-1]
        else:
            refl_l = xb[..., :halo][..., ::-1]
            refl_r = xb[..., t - halo:][..., ::-1]
        ext = ext.at[..., :halo].set(
            jnp.where(idx == 0, refl_l, ext[..., :halo]))
        ext = ext.at[..., -halo:].set(
            jnp.where(idx == nb - 1, refl_r, ext[..., -halo:]))
        return ext
    # halo spans multiple blocks: gather fix-up against the global edges
    start = idx * t
    e = jnp.arange(t + 2 * halo, dtype=jnp.int32)
    g = start - halo + e
    if reflect_mode == "reflect":
        g = jnp.where(g < 0, -g, g)
        g = jnp.where(g >= n_total, 2 * n_total - 2 - g, g)
    else:
        g = jnp.where(g < 0, -g - 1, g)
        g = jnp.where(g >= n_total, 2 * n_total - 1 - g, g)
    return jnp.take(ext, g - (start - halo), axis=-1)


def savgol_filter_sharded(x, window_length: int, polyorder: int, mesh: Mesh,
                          deriv: int = 0, delta: float = 1.0,
                          channel_axis: str = "channel",
                          block_axis: str = "block"):
    """Sharded Savitzky-Golay, identical to ops.savgol.savgol_filter with
    mode='reflect'. The centered window needs window_length//2 samples of
    halo on BOTH sides; halos wider than the per-shard block are supported
    (multi-block ppermute rounds + local reflected-edge gather).
    """
    from vv_dsp_tpu.ops import savgol as _savgol

    half = window_length // 2
    w_np = _savgol.savgol_coeffs_np(window_length, polyorder, deriv, delta)
    nb = mesh.shape[block_axis]
    n_total = x.shape[-1]
    if half >= n_total:
        raise ValueError("window_length//2 must be < signal length")

    @functools.partial(
        jax.shard_map, mesh=mesh,
        in_specs=P(channel_axis, block_axis),
        out_specs=P(channel_axis, block_axis))
    def run(xb):
        ext = _edge_fixed_ext(xb, half, n_total, nb, block_axis, "reflect")
        # valid correlation over ext (causal conv with reversed kernel,
        # dropping the warm-up) -> exactly t outputs
        return _fir.fir_apply_mxu(w_np[::-1].copy(), ext)[..., 2 * half:]

    return run(x)


def filtfilt_fir_sharded(h, x, mesh: Mesh, channel_axis: str = "channel",
                         block_axis: str = "block"):
    """Sharded zero-phase FIR (ops.fir.filtfilt_fir semantics): symmetric
    global edge padding, forward causal pass then time-reversed pass —
    realized as one centered non-causal filter with g = h (*) h-reversed
    (the autocorrelation of h), using two-sided halos of taps-1 samples
    (multi-block halos supported)."""
    h_np = np.asarray(h, dtype=np.float64)
    taps = h_np.shape[-1]
    pad = taps - 1
    # h fwd then reversed-h == correlation with g = conv(h, h[::-1]),
    # centered at lag 0: y[i] = sum_k g[k] xext[i + k - (taps-1)]
    g = np.convolve(h_np, h_np[::-1])
    nb = mesh.shape[block_axis]
    n_total = x.shape[-1]
    if pad >= n_total:
        raise ValueError("taps-1 must be < signal length")

    @functools.partial(
        jax.shard_map, mesh=mesh,
        in_specs=P(channel_axis, block_axis),
        out_specs=P(channel_axis, block_axis))
    def run(xb):
        if pad == 0:
            return xb * jnp.asarray(g[0], dtype=xb.dtype)
        ext = _edge_fixed_ext(xb, pad, n_total, nb, block_axis, "symmetric")
        # causal conv with g over ext, then shift so the center tap aligns:
        # y[i] = (g * xext)[i + 2*pad] with causal indexing
        y = _fir.fir_apply_mxu(g, ext)
        return y[..., 2 * pad :]

    return run(x)
