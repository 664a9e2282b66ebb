"""Signal framing and overlap-add (reference: src/core/framing.c).

Design: instead of a per-frame fetch loop
(vv_dsp_fetch_frame, src/core/framing.c:71-121), all frames are materialized in
one batched gather — a (num_frames, frame_len) index matrix into the (padded)
signal, which XLA lowers to an efficient gather/dynamic-slice pattern. The
overlap-add loop (vv_dsp_overlap_add, src/core/framing.c:123-148) becomes a
single scatter-add.

Boundary semantics preserved exactly:
- centered framing: frame f is centered at f*hop with symmetric-style
  reflection (reflect_index, src/core/framing.c:21-56: idx=-1 -> x[0],
  idx=n -> x[n-1] — numpy's 'symmetric' pad mode),
- non-centered framing: frame f starts at f*hop with zero padding,
- num_frames: centered = ceil(n / hop), non-centered = 1 + (n - frame) // hop
  (src/core/framing.c:58-69).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def num_frames(signal_len: int, frame_len: int, hop_len: int, center: bool) -> int:
    """Frame count (vv_dsp_get_num_frames, src/core/framing.c:58-69)."""
    if hop_len <= 0:
        return 0
    if center:
        return -(-signal_len // hop_len)  # ceil division
    if signal_len < frame_len:
        return 0
    return 1 + (signal_len - frame_len) // hop_len


def symmetric_index(idx, n: int):
    """Vectorized equivalent of reflect_index (src/core/framing.c:21-56).

    Maps any integer index into [0, n) with symmetric reflection
    (..., x1, x0 | x0, x1, ..., x_{n-1} | x_{n-1}, ...).
    """
    if n == 1:
        return jnp.zeros_like(idx)
    period = 2 * n
    m = jnp.mod(idx, period)  # lax mod on ints is floor-mod for positive period
    return jnp.where(m < n, m, period - 1 - m)


def frame_indices(signal_len: int, frame_len: int, hop_len: int, center: bool,
                  n_frames: int | None = None):
    """(num_frames, frame_len) int32 gather indices plus a validity mask.

    For centered mode indices are already reflected into range; mask is all
    True. For non-centered, out-of-range taps are clamped to 0 and masked.
    """
    if n_frames is None:
        n_frames = num_frames(signal_len, frame_len, hop_len, center)
    starts = jnp.arange(n_frames, dtype=jnp.int32) * hop_len
    if center:
        starts = starts - frame_len // 2
    offs = jnp.arange(frame_len, dtype=jnp.int32)
    idx = starts[:, None] + offs[None, :]
    if center:
        return symmetric_index(idx, signal_len), None
    mask = (idx >= 0) & (idx < signal_len)
    return jnp.clip(idx, 0, signal_len - 1), mask


def frames_strided(signal, frame_len: int, hop_len: int, n_frames: int):
    """Zero-pad-tail framing via k = frame_len//hop strided reshapes instead
    of a gather (requires frame_len % hop == 0).

    Dense reshape+concat passes read memory contiguously where a
    (frames x frame_len) jnp.take gather does not. Matches fetch_frames(center=False) with out-of-range taps zeroed.
    """
    if frame_len % hop_len:
        raise ValueError("frames_strided requires frame_len % hop == 0")
    k = frame_len // hop_len
    n = signal.shape[-1]
    need = (n_frames - 1) * hop_len + frame_len
    if need > n:
        pads = [(0, 0)] * (signal.ndim - 1) + [(0, need - n)]
        signal = jnp.pad(signal, pads)
    parts = []
    for j in range(k):
        seg = jax.lax.slice_in_dim(signal, j * hop_len,
                                   j * hop_len + n_frames * hop_len, axis=-1)
        parts.append(seg.reshape(seg.shape[:-1] + (n_frames, hop_len)))
    return jnp.concatenate(parts, axis=-1)


def overlap_add_strided(frames, hop_len: int, output_len: int):
    """Overlap-add via k shifted dense adds instead of a scatter (requires
    frame_len % hop == 0); same result as overlap_add with bounds clipping."""
    n_frames, frame_len = frames.shape[-2], frames.shape[-1]
    if frame_len % hop_len:
        raise ValueError("overlap_add_strided requires frame_len % hop == 0")
    k = frame_len // hop_len
    total = (n_frames - 1) * hop_len + frame_len
    batch = frames.shape[:-2]
    out = jnp.zeros(batch + (total,), dtype=frames.dtype)
    for j in range(k):
        part = frames[..., j * hop_len : (j + 1) * hop_len]
        flat = part.reshape(batch + (n_frames * hop_len,))
        out = out.at[..., j * hop_len : j * hop_len + n_frames * hop_len].add(
            flat)
    if total >= output_len:
        return out[..., :output_len]
    pads = [(0, 0)] * len(batch) + [(0, output_len - total)]
    return jnp.pad(out, pads)


def fetch_frames(signal, frame_len: int, hop_len: int, center: bool = True,
                 window=None):
    """Batched frame extraction.

    signal: (..., n) -> (..., num_frames, frame_len). Optional window
    multiplies each frame (vv_dsp_fetch_frame's window argument).
    """
    n = signal.shape[-1]
    idx, mask = frame_indices(n, frame_len, hop_len, center)
    frames = jnp.take(signal, idx, axis=-1)
    if mask is not None:
        frames = jnp.where(mask, frames, jnp.zeros_like(frames))
    if window is not None:
        frames = frames * jnp.asarray(window, dtype=frames.dtype)
    return frames


def overlap_add(frames, hop_len: int, output_len: int):
    """Scatter-add frames back onto a time axis.

    frames: (..., num_frames, frame_len) -> (..., output_len). Samples falling
    past output_len are dropped (bounds clipping,
    src/core/framing.c:137-146).
    """
    n_frames, frame_len = frames.shape[-2], frames.shape[-1]
    starts = jnp.arange(n_frames, dtype=jnp.int32) * hop_len
    idx = starts[:, None] + jnp.arange(frame_len, dtype=jnp.int32)[None, :]
    # Route out-of-range samples to a trash slot appended at the end.
    oob = idx >= output_len
    idx = jnp.where(oob, output_len, idx)
    batch_shape = frames.shape[:-2]
    out = jnp.zeros(batch_shape + (output_len + 1,), dtype=frames.dtype)
    out = out.at[..., idx].add(frames)
    return out[..., :output_len]
