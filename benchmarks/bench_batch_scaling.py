"""Batch (channel-count) scaling of the flagship chain on one chip — the
serving-deployment question: how does throughput grow as independent audio
streams are batched onto the same card?

Per-call launch overhead and tall matmuls both favor batching; this sweep
quantifies it. Chained fori_loop timing, full-output-sum consumption.

Run: python benchmarks/bench_batch_scaling.py
Writes benchmarks/batch_scaling.json.
"""

import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import numpy as np
import jax
import jax.numpy as jnp


def main():
    from vv_dsp_tpu.models import NorthStarChain
    from vv_dsp_tpu.utils.profiling import chain_benchmark

    chain = NorthStarChain()
    n = 479232  # ~10 s @ 48 kHz per channel
    rng = np.random.default_rng(0)
    rows = []
    for ch in (4, 16, 64, 128):
        x = jnp.asarray(rng.standard_normal((ch, n)), dtype=jnp.float32)

        def step(v, acc):
            out = chain(v + acc * 1e-30)
            return jnp.sum(out).astype(jnp.float32) * 1e-30

        r = chain_benchmark(f"chain_{ch}ch", step, x, n_samples=ch * n)
        msps = r.samples_per_sec / 1e6
        rows.append({
            "channels": ch,
            "elapsed_ms": round(r.elapsed_ms, 3),
            "msamples_per_sec": round(msps, 1),
            "realtime_48k_streams": int(msps * 1e6 / 48000),
        })
        print(f"{ch:4d} ch: {r.elapsed_ms:8.2f} ms  {msps:8.1f} Msps  "
              f"(~{rows[-1]['realtime_48k_streams']} realtime 48k streams)",
              flush=True)

    out = {
        "device": str(jax.devices()[0]),
        "signal_samples_per_channel": n,
        "pipeline": "NorthStarChain (fused head + framing-free STFT + "
                    "mel-fused MFCC)",
        "rows": rows,
    }
    path = os.path.join(REPO, "benchmarks", "batch_scaling.json")
    with open(path, "w") as f:
        json.dump(out, f, indent=1)
    print(f"wrote {path}")


if __name__ == "__main__":
    main()
