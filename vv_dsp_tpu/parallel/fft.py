"""Distributed FFT over the block-sharded time axis, and sharded Hilbert.

The reference computes global transforms on a single core; the sharded ops
in parallel/ops.py cover *local* per-frame transforms (STFT). Whole-signal
spectral ops on a time-sharded signal (Hilbert analytic signal, cepstrum,
CZT) need a GLOBAL FFT across shards. This module implements the four-step
Cooley-Tukey factorization N = N1 * N2 with N1 = n_block_shards:

  shard n1 holds x[n1*N2 : (n1+1)*N2]  (natural block layout)
  step A: cross-shard DFT over the block index          (one psum_scatter)
            A[k1, n2] = sum_n1 x[n1, n2] W_N1^{n1 k1}
  step B: local twiddle  B = A * W_N^{n2 k1}
  step C: local length-N2 FFT over n2

giving X[k1 + N1*k2] on shard k1 — a CYCLIC frequency layout (shard k1 owns
frequencies congruent to k1 mod N1). Pointwise spectral filters (the Hilbert
one-sided mask, cepstral windows, band gates) evaluate their response at the
locally-known global bin indices, so they stay embarrassingly parallel in
this layout; ifft_sharded inverts back to the natural block layout.

The cross-shard DFT is N1 (= mesh size, tiny) weighted partial sums fused
into ONE reduce-scatter — the communication-optimal form of the
distributed transpose for small N1.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, PartitionSpec as P

from vv_dsp_tpu.ops import fft as _fft


def _block_dft(xb, nb: int, axis_name: str, sign: float):
    """Cross-shard DFT over the block index via one psum_scatter.

    Each shard s forms its weighted copies W^{sign*s*k1} * xb for every
    target k1, and the reduce-scatter sums them so shard k1 receives
    sum_s W^{sign*s*k1} x_s — the length-nb DFT across shards."""
    if nb == 1:
        # single-member axis: the cross-shard DFT is the identity, and a
        # degenerate 1-group c64 reduce-scatter is pure overhead — skip
        # the collective entirely
        return xb
    s = lax.axis_index(axis_name)
    ang = (sign * 2.0 * jnp.pi / nb) * s.astype(jnp.float32)
    outs = []
    for k1 in range(nb):
        w = jax.lax.complex(jnp.cos(ang * k1), jnp.sin(ang * k1))
        outs.append(xb * w.astype(xb.dtype))
    stacked = jnp.stack(outs, axis=0)  # (nb, ..., t_local)
    return lax.psum_scatter(stacked, axis_name, scatter_dimension=0,
                            tiled=False)


def _twiddle(t_local: int, n: int, k1, sign: float, dtype):
    # Reduce the phase index (n2*k1) mod n in INTEGER arithmetic before the
    # f32 angle multiply — the raw product reaches n*nb where f32 ULP would
    # exceed 2*pi (garbage twiddles for signals beyond ~1M samples).
    n2 = jnp.arange(t_local, dtype=jnp.int32)
    m = jnp.mod(n2 * k1.astype(jnp.int32), n)
    ang = (sign * 2.0 * jnp.pi / n) * m.astype(jnp.float32)
    return jax.lax.complex(jnp.cos(ang), jnp.sin(ang)).astype(dtype)


def fft_sharded(x, mesh: Mesh, channel_axis: str = "channel",
                block_axis: str = "block"):
    """Global forward FFT of a block-sharded (channels, n) signal.

    Returns the complex spectrum in CYCLIC layout: the array element at
    shard k1, local position k2 is X[k1 + n_blocks*k2]. Use
    `cyclic_freq_indices` for the global bin index of each local element,
    and ifft_sharded to return to the natural layout.
    """
    nb = mesh.shape[block_axis]
    n = x.shape[-1]

    @functools.partial(
        jax.shard_map, mesh=mesh,
        in_specs=P(channel_axis, block_axis),
        out_specs=P(channel_axis, block_axis))
    def run(xb):
        xb = xb.astype(jnp.complex64)
        a = _block_dft(xb, nb, block_axis, sign=-1.0)
        k1 = lax.axis_index(block_axis)
        b = a * _twiddle(a.shape[-1], n, k1, -1.0, a.dtype)
        return _fft.fft(b)

    return run(x)


def ifft_sharded(spec, mesh: Mesh, channel_axis: str = "channel",
                 block_axis: str = "block"):
    """Inverse of fft_sharded: cyclic-layout spectrum -> natural block-layout
    complex signal (scaled 1/n like jnp.fft.ifft)."""
    nb = mesh.shape[block_axis]
    n = spec.shape[-1]

    @functools.partial(
        jax.shard_map, mesh=mesh,
        in_specs=P(channel_axis, block_axis),
        out_specs=P(channel_axis, block_axis))
    def run(sb):
        # invert step C (local iFFT gives 1/N2 scaling) ...
        b = _fft.ifft(sb)
        # ... step B ...
        k1 = lax.axis_index(block_axis)
        a = b * _twiddle(b.shape[-1], n, k1, +1.0, b.dtype)
        # ... and step A (inverse block DFT; contributes the remaining 1/N1)
        return _block_dft(a, nb, block_axis, sign=+1.0) / nb

    return run(spec)


def cyclic_freq_indices(t_local: int, nb: int, k1):
    """Global frequency bin of each local element in the cyclic layout."""
    return k1 + nb * jnp.arange(t_local, dtype=jnp.int32)


def hilbert_analytic_sharded(x, mesh: Mesh, channel_axis: str = "channel",
                             block_axis: str = "block"):
    """Analytic signal of a block-sharded real signal — the sharded version
    of ops.hilbert.hilbert_analytic (reference src/spectral/hilbert.c:14-75):
    global FFT, one-sided doubling mask (evaluated at the cyclic layout's
    global bin indices, so it needs NO extra communication), global iFFT.
    """
    nb = mesh.shape[block_axis]
    n = x.shape[-1]
    spec = fft_sharded(x, mesh, channel_axis, block_axis)

    @functools.partial(
        jax.shard_map, mesh=mesh,
        in_specs=P(channel_axis, block_axis),
        out_specs=P(channel_axis, block_axis))
    def mask(sb):
        k1 = lax.axis_index(block_axis)
        g = cyclic_freq_indices(sb.shape[-1], nb, k1)
        half = n // 2
        if n % 2 == 0:
            factor = jnp.where((g == 0) | (g == half), 1.0,
                               jnp.where(g < half, 2.0, 0.0))
        else:
            factor = jnp.where(g == 0, 1.0,
                               jnp.where(g <= half, 2.0, 0.0))
        return sb * factor.astype(sb.dtype)

    return ifft_sharded(mask(spec), mesh, channel_axis, block_axis)


def cepstrum_real_sharded(x, mesh: Mesh, channel_axis: str = "channel",
                          block_axis: str = "block"):
    """Real cepstrum of a block-sharded signal (sharded version of
    ops.envelope.cepstrum_real; reference src/envelope/cepstrum.c:7-39):
    global FFT -> log(|X| + 1e-12) (pointwise, layout-oblivious) -> global
    iFFT real part."""
    spec = fft_sharded(x, mesh, channel_axis, block_axis)

    @functools.partial(
        jax.shard_map, mesh=mesh,
        in_specs=P(channel_axis, block_axis),
        out_specs=P(channel_axis, block_axis))
    def logmag(sb):
        return jnp.log(jnp.abs(sb) + 1e-12).astype(sb.dtype)

    return jnp.real(ifft_sharded(logmag(spec), mesh, channel_axis,
                                 block_axis))
