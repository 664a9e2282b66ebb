"""Sharded-vs-unsharded STFT throughput on a 1-device mesh.

The sharded STFT's per-shard work goes through the same ops.fft dispatch as
the single-device path, and on one device the halo ppermutes are
self-sends, so a 1-device mesh should show sharded ~ unsharded throughput.

Writes benchmarks/sharded_stft_profile.json.
"""

import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax


def chain_time(fn, x, iters=100):
    @jax.jit
    def run(v):
        def step(i, acc):
            out = fn(v + acc * 1e-30)
            s = jnp.sum(jnp.real(out)) + jnp.sum(jnp.imag(out))
            return s.astype(jnp.float32) * 1e-30
        return lax.fori_loop(0, iters, step, jnp.float32(0.0))
    float(run(x))
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        float(run(x))
        best = min(best, time.perf_counter() - t0)
    return best / iters


def main():
    from vv_dsp_tpu.ops.stft import STFT
    from vv_dsp_tpu.parallel import stft_process_sharded
    from vv_dsp_tpu.parallel import mesh as pmesh

    nfft, hop = 2048, 512
    ch, n = 16, 638976
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.standard_normal((ch, n)), dtype=jnp.float32)
    mesh = pmesh.make_mesh(1, 1, devices=jax.devices()[:1])
    plan = STFT(nfft, hop)

    d_sh = chain_time(lambda v: stft_process_sharded(v, nfft, hop, mesh),
                      x)
    d_un = chain_time(lambda v: plan.process(v, rfft=True), x)
    rows = {
        "device": str(jax.devices()[0]),
        "nfft": nfft, "hop": hop, "channels": ch, "samples": n,
        "sharded_1dev_ms": round(d_sh * 1e3, 3),
        "unsharded_ms": round(d_un * 1e3, 3),
        "sharded_msps": round(ch * n / d_sh / 1e6, 1),
        "unsharded_msps": round(ch * n / d_un / 1e6, 1),
        "ratio": round(d_un / d_sh, 3),
        "notes": "sharded runs the shard_map body (ops.fft fast tiers + "
                 "self-send halo) on a 1-device mesh; unsharded is "
                 "STFT.process(rfft=True). Before the universal dispatch "
                 "the sharded body paid the XLA FFT HLO per shard.",
    }
    print(json.dumps(rows, indent=1))
    with open(os.path.join(REPO, "benchmarks",
                           "sharded_stft_profile.json"), "w") as f:
        json.dump(rows, f, indent=1)


if __name__ == "__main__":
    main()
