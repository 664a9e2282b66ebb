"""Neighbor halo exchange over the block (time) axis.

The sharded replacement for the reference's cross-block state carriers:
- FIR history ring buffer of num_taps-1 samples (src/filter/fir.c:170-193)
  -> `halo_from_left` of taps-1 samples,
- STFT frame overlap of nfft-hop samples (src/spectral/stft.c:95-110)
  -> `halo_from_right` for analysis, `spill_to_right` for OLA synthesis.

All functions must be called INSIDE shard_map with `axis_name` bound.
`lax.ppermute` leaves unaddressed targets zero-filled, which is exactly the
boundary condition the reference uses (zero initial filter history; zero
pad past the signal end).

Halos wider than one block are supported: the exchange runs
ceil(halo / t_local) ppermute rounds, each pulling one block further away
(neighbor-only hops: one ppermute per round).
"""

from __future__ import annotations

import jax.numpy as jnp
from jax import lax


def _axis_size(axis_name: str) -> int:
    return lax.axis_size(axis_name)


def _shift_left_one(x, axis_name: str, nb: int):
    """Each shard receives its RIGHT neighbor's array (zeros on the last)."""
    perm = [(i + 1, i) for i in range(nb - 1)]
    return lax.ppermute(x, axis_name, perm)


def _shift_right_one(x, axis_name: str, nb: int):
    """Each shard receives its LEFT neighbor's array (zeros on the first)."""
    perm = [(i, i + 1) for i in range(nb - 1)]
    return lax.ppermute(x, axis_name, perm)


def halo_from_left(x, halo: int, axis_name: str = "block"):
    """Receive the `halo` samples preceding this shard's block.

    x: (..., t_local). Returns (..., halo); shard 0's out-of-signal prefix is
    zeros (= the reference's zeroed initial FIR history,
    src/filter/fir.c:147-153). halo may exceed t_local.
    """
    if halo == 0:
        return x[..., :0]
    nb = _axis_size(axis_name)
    t = x.shape[-1]
    if nb == 1:
        return jnp.zeros(x.shape[:-1] + (halo,), x.dtype)
    rounds = -(-halo // t)
    parts = []
    buf = x
    for _ in range(rounds):
        buf = _shift_right_one(buf, axis_name, nb)
        parts.insert(0, buf)  # farther-left blocks go in front
    return jnp.concatenate(parts, axis=-1)[..., -halo:]


def halo_from_right(x, halo: int, axis_name: str = "block"):
    """Receive the `halo` samples following this shard's block.

    The out-of-signal suffix on the last shards is zeros (= zero padding past
    the signal end, the reference's spectrogram tail handling,
    src/spectral/stft.c:124-137). halo may exceed t_local.
    """
    if halo == 0:
        return x[..., :0]
    nb = _axis_size(axis_name)
    t = x.shape[-1]
    if nb == 1:
        return jnp.zeros(x.shape[:-1] + (halo,), x.dtype)
    rounds = -(-halo // t)
    parts = []
    buf = x
    for _ in range(rounds):
        buf = _shift_left_one(buf, axis_name, nb)
        parts.append(buf)
    return jnp.concatenate(parts, axis=-1)[..., :halo]


def spill_add_right(buf, spill, axis_name: str = "block"):
    """Overlap-add seam stitch: each shard's `spill` (the accumulation that
    ran past its block, (..., L)) is added onto the blocks to its right,
    however many it spans; the last shard's overflow is dropped (the
    reference clips OLA writes past the output buffer,
    src/core/framing.c:137-146).

    buf: (..., t_local) local accumulator. Returns buf with all incoming
    spill added at the correct offsets.
    """
    nb = _axis_size(axis_name)
    t = buf.shape[-1]
    carry = spill
    while carry.shape[-1] > 0:
        if nb == 1:
            break
        recv = _shift_right_one(carry, axis_name, nb)
        add_len = min(t, recv.shape[-1])
        buf = buf.at[..., :add_len].add(recv[..., :add_len])
        carry = recv[..., add_len:]
    return buf
