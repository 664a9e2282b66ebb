"""Headline benchmarks: STFT throughput (1024/256, the reference's
stft_profile row) and the north-star chain (1024-tap FIR -> 4/3 polyphase
-> 2048-pt STFT -> mel -> MFCC, BASELINE.md:47-49).

Timing methodology: all iterations run inside ONE jitted lax.fori_loop
with iteration k+1 data-dependent on iteration k, and the FULL output
reduced to a single scalar pulled at the end: the per-call dispatch is
amortized over ITERS iterations, and the full-sum consumption keeps XLA's
simplifier from skipping work back through the dots (consuming only a
slice lets it).

Needs a GPU: without one it exits non-zero before measuring anything.
Prints the device as JSON first, then one JSON line per metric; the
headline row (stft_1024_256_throughput, directly comparable to the
reference's 6.38 Msamples/s on a Ryzen 7950X scalar build) is printed LAST.
"""

import json
import os
import sys
import time

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

BASELINE_STFT_MSPS = 6.38   # reference STFT 1024-pt throughput (BASELINE.md)
BASELINE_CHAIN_MSPS = 0.9   # reference chain, scalar C build on a CPU
ITERS = 400


def chain_time(step, x, iters: int = ITERS) -> float:
    """Best-of-3 seconds per iteration; step(v, acc) -> scalar, chained."""

    @jax.jit
    def run(v):
        return lax.fori_loop(0, iters, lambda i, acc: step(v, acc),
                             jnp.float32(0.0))

    float(run(x))  # compile + warmup
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        float(run(x))
        best = min(best, time.perf_counter() - t0)
    return best / iters


def consume(out):
    s = jnp.sum(jnp.real(out))
    if jnp.iscomplexobj(out):
        s = s + jnp.sum(jnp.imag(out))
    return s.astype(jnp.float32) * 1e-30


def main():
    from vv_dsp_tpu.models import NorthStarChain
    from vv_dsp_tpu.ops.stft import STFT
    from vv_dsp_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    dev = jax.devices()[0]
    print(json.dumps({"device": {"platform": dev.platform,
                                 "kind": dev.device_kind,
                                 "count": len(jax.devices())}}), flush=True)
    if dev.platform != "gpu":
        print("bench.py: no GPU; nothing measured", file=sys.stderr)
        return 1

    rng = np.random.default_rng(0)
    channels = 16
    rows = []

    # north-star chain, input-rate Msamples/s
    chain = NorthStarChain()
    n_chain = 479232
    xc = jnp.asarray(rng.standard_normal((channels, n_chain)),
                     dtype=jnp.float32)
    dt = chain_time(lambda v, acc: consume(chain(v + acc * 1e-30)), xc)
    rows.append({
        "metric": "northstar_chain_throughput",
        "value": round(channels * n_chain / dt / 1e6, 2),
        "unit": "Msamples/s",
        "vs_baseline": round(channels * n_chain / dt / 1e6
                             / BASELINE_CHAIN_MSPS, 2),
    })

    # reference-comparable STFT row (full C2C complex spectrum, all bins)
    nfft, hop = 1024, 256
    n = 48000 * 10
    x = jnp.asarray(rng.standard_normal((channels, n)), dtype=jnp.float32)
    plan = STFT(nfft, hop)
    dt = chain_time(
        lambda v, acc: consume(plan.process(v + acc * 1e-30, rfft=False)), x)
    rows.append({
        "metric": "stft_1024_256_throughput",
        "value": round(channels * n / dt / 1e6, 2),
        "unit": "Msamples/s",
        "vs_baseline": round(channels * n / dt / 1e6 / BASELINE_STFT_MSPS, 2),
    })

    for row in rows:
        print(json.dumps(row))
    return 0


if __name__ == "__main__":
    sys.exit(main())
