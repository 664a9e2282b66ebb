"""Device mesh construction and multi-host runtime init.

New design (the reference has no distributed layer):
`jax.distributed.initialize` brings up the multi-process runtime, and a
2-D ``("channel", "block")`` mesh maps channels x time-blocks onto devices.
XLA's collectives over this mesh (ppermute/psum/all_gather emitted by
shard_map) are the communication backend — the NCCL-equivalent is built in.
"""

from __future__ import annotations

import jax
from jax.sharding import Mesh, PartitionSpec as P


def initialize_distributed(coordinator_address: str | None = None,
                           num_processes: int | None = None,
                           process_id: int | None = None) -> None:
    """Bring up the multi-process runtime; a no-op without a coordinator
    (one process driving all of its local devices needs no runtime).

    Nothing in the environment describes the cluster, so every process
    passes the coordinator (``host:port``), the process count and its own
    id. Call it before anything queries jax.devices().
    """
    if coordinator_address is None and num_processes is None:
        return
    jax.distributed.initialize(coordinator_address, num_processes, process_id)


def make_mesh(n_channel_shards: int | None = None,
              n_block_shards: int | None = None,
              devices=None,
              axis_names: tuple[str, str] = ("channel", "block")) -> Mesh:
    """Build a 2-D (channel, block) mesh over the available devices.

    Defaults: all devices on the block (time) axis — the axis that carries
    the halo exchanges — with channel=1. The cards of one host are joined
    all to all, so the mesh layout follows the algorithm only.
    """
    if devices is None:
        devices = jax.devices()
    n_dev = len(devices)
    if n_channel_shards is None and n_block_shards is None:
        n_channel_shards, n_block_shards = 1, n_dev
    elif n_channel_shards is None:
        n_channel_shards = n_dev // n_block_shards
    elif n_block_shards is None:
        n_block_shards = n_dev // n_channel_shards
    if n_channel_shards * n_block_shards != n_dev:
        raise ValueError(
            f"mesh {n_channel_shards}x{n_block_shards} != {n_dev} devices")
    # Auto axis types: sharding propagates through jnp ops inside shard_map
    # bodies (jax>=0.9 defaults to Explicit, which rejects that).
    auto = (jax.sharding.AxisType.Auto,) * 2
    return jax.make_mesh((n_channel_shards, n_block_shards), axis_names,
                         axis_types=auto, devices=devices)


def block_size(mesh: Mesh, n: int, block_axis: str = "block") -> int:
    """Per-shard length of a time axis of global length n (must divide)."""
    nb = mesh.shape[block_axis]
    if n % nb:
        raise ValueError(f"time length {n} not divisible by {nb} block shards; "
                         "pad with pad_to_blocks() first")
    return n // nb


def pad_to_blocks(x, mesh: Mesh, block_axis: str = "block", axis: int = -1):
    """Right-pad the time axis with zeros to a multiple of the block-shard
    count. Returns (padded, original_len)."""
    nb = mesh.shape[block_axis]
    n = x.shape[axis]
    rem = (-n) % nb
    if rem == 0:
        return x, n
    pads = [(0, 0)] * x.ndim
    pads[axis % x.ndim] = (0, rem)
    import jax.numpy as jnp
    return jnp.pad(x, pads), n
