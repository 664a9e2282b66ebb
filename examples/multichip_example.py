"""Multi-chip sharded execution on a (channel, block) mesh.

Simulates an 8-device CPU mesh; drop the jax.config lines below to shard
over the machine's own devices (e.g. four GPUs).
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))  # repo root

# Simulate 8 CPU devices.
import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_num_cpu_devices", 8)

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from vv_dsp_tpu import parallel
from vv_dsp_tpu.parallel import mesh as pmesh
from vv_dsp_tpu.ops import fir, iir
from vv_dsp_tpu.models import NorthStarChain


def main():
    n_dev = len(jax.devices())
    mesh = pmesh.make_mesh(1, n_dev)
    print(f"mesh: {dict(mesh.shape)} over {jax.devices()[0].platform}")

    rng = np.random.default_rng(0)
    n = n_dev * 6144
    x = jnp.asarray(rng.standard_normal((4, n)), dtype=jnp.float32)
    x = jax.device_put(x, NamedSharding(mesh, P("channel", "block")))

    # FIR with cross-shard halo exchange == dense result
    h = fir.design_lowpass(255, 0.25)
    y = parallel.fir_apply_sharded(h, x, mesh)
    dense = fir.fir_apply(h, x)
    print("sharded FIR max |err|:", float(jnp.max(jnp.abs(y - dense))))

    # IIR with cross-shard affine state composition
    sos = iir.butter_sos(4, 0.2)
    yi = parallel.iir_apply_sharded(sos, x, mesh)
    di = iir.iir_apply(sos, x)
    print("sharded IIR max |err|:", float(jnp.max(jnp.abs(yi - di))))

    # Full pipeline, sharded end to end
    chain = NorthStarChain(fir_taps=128, nfft=512, hop=128, n_mels=40,
                           n_mfcc=13)
    feats = jax.jit(lambda v: chain.apply_sharded(v, mesh))(x)
    print("sharded MFCC features:", feats.shape)


if __name__ == "__main__":
    main()
