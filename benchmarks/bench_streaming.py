"""Streaming throughput bench — the analog of the reference's streaming
resample rows (docs/profiles/resample_profile.json:59-83: 64-1024-sample
blocks at 0.80-0.82 Msamples/s on the 7950X).

Measures StreamingNorthStar.process over a long block sequence with the
carried state as the on-device dependency chain (state_k feeds block k+1, so
no artificial data dependency is needed); ONE host pull at the end. Per-call
dispatch latency is part of the measurement — that IS the deployment shape
for block streaming — so the per-block wall time is reported alongside
throughput.

Run: python benchmarks/bench_streaming.py [--blocks 64]
Writes benchmarks/streaming_profile.json.
"""

import argparse
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import numpy as np
import jax
import jax.numpy as jnp


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--blocks", type=int, default=64)
    ap.add_argument("--out", default=os.path.join(REPO, "benchmarks",
                                                  "streaming_profile.json"))
    args = ap.parse_args()

    from vv_dsp_tpu.models.streaming_chain import StreamingNorthStar

    chain = StreamingNorthStar()
    channels = 16
    rng = np.random.default_rng(0)
    rows = []
    for block_in in (1536, 6144, 24576):  # %3 == 0, resampled %512 == 0
        chain.validate_block(block_in)
        x = jnp.asarray(rng.standard_normal((channels, block_in)),
                        dtype=jnp.float32)
        step = jax.jit(lambda s, b: chain.process(s, b))
        state = chain.init((channels,))
        feats, state = step(state, x)          # compile + warmup
        # scalar pull as the sync point
        float(jnp.sum(feats))

        t0 = time.perf_counter()
        for _ in range(args.blocks):
            feats, state = step(state, x)
        # one dependency pull: the last block's features depend on the
        # carried state of every previous block
        float(jnp.sum(feats))
        dt = (time.perf_counter() - t0) / args.blocks
        msps = channels * block_in / dt / 1e6
        rows.append({
            "name": f"streaming_north_star_block{block_in}",
            "block_in": block_in,
            "per_block_ms": round(dt * 1e3, 3),
            "msamples_per_sec": round(msps, 1),
            "realtime_streams_48k": int(msps * 1e6 / 48000 / channels),
        })
        print(f"block={block_in:6d}: {dt*1e3:7.2f} ms/block  "
              f"{msps:8.1f} Msps  (~{rows[-1]['realtime_streams_48k']}x "
              f"48k realtime per channel)", flush=True)

    # Chunked streaming: K blocks per dispatch (process_blocks = lax.scan
    # over the same step). Identical block semantics/state boundaries; the
    # per-call dispatch floor is paid once per CHUNK, not once per block.
    chunk_rows = []
    for block_in, k in ((1536, 16), (1536, 64), (6144, 16), (6144, 64)):
        x = jnp.asarray(rng.standard_normal((channels, k * block_in)),
                        dtype=jnp.float32)
        fn = jax.jit(lambda s, sig: chain.process_blocks(s, sig, block_in))
        state = chain.init((channels,))
        feats, state = fn(state, x)
        float(jnp.sum(feats))
        iters = max(1, args.blocks // k)
        t0 = time.perf_counter()
        for _ in range(iters):
            feats, state = fn(state, x)
        float(jnp.sum(feats))
        dt = (time.perf_counter() - t0) / iters
        msps = channels * k * block_in / dt / 1e6
        chunk_rows.append({
            "name": f"streaming_north_star_chunked_b{block_in}_k{k}",
            "block_in": block_in,
            "blocks_per_dispatch": k,
            "per_block_ms": round(dt * 1e3 / k, 3),
            "msamples_per_sec": round(msps, 1),
            "realtime_streams_48k": int(msps * 1e6 / 48000 / channels),
        })
        print(f"chunked block={block_in:6d} k={k:3d}: "
              f"{dt*1e3/k:7.3f} ms/block  {msps:8.1f} Msps", flush=True)

    out = {
        "device": str(jax.devices()[0]),
        "channels": channels,
        "note": "per-call dispatch latency included — the "
                "deployment shape for block streaming; chunked rows amortize it over K blocks per dispatch "
                "(process_blocks); reference scalar baseline: 0.80-0.82 "
                "Msps (resample_profile.json:59-83)",
        "rows": rows,
        "chunked_rows": chunk_rows,
    }
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
