"""FFT tier crossover bench: rfft + c2c fft at several sizes, three tiers."""
import sys, time
import sys, os; sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import numpy as np, jax, jax.numpy as jnp
from vv_dsp_tpu.ops import fft as F
from vv_dsp_tpu.utils.profiling import chain_benchmark

TOTAL = 1 << 23  # ~8.4M samples per call, constant across sizes
rng = np.random.default_rng(0)

def bench(kind, n, tier):
    batch = TOTAL // n
    x = jnp.asarray(rng.standard_normal((batch, n)), dtype=jnp.float32)
    if tier == "dense":
        fn = {"r2c": lambda v: F._matmul_rfft(v, n),
              "c2c": lambda v: F._matmul_fft(v.astype(jnp.complex64), n, False)}[kind]
    elif tier == "four":
        if F._four_step_factors(n) is None: return None
        fn = {"r2c": lambda v: jax.lax.complex(*F._four_step_rfft_parts(v, n)),
              "c2c": lambda v: F._four_step_fft(v.astype(jnp.complex64), n, False)}[kind]
    else:
        fn = {"r2c": lambda v: jnp.fft.rfft(v), "c2c": lambda v: jnp.fft.fft(v)}[kind]
    def step(v, acc):
        # full-output consumption: sliced consumption lets XLA slice back
        # through the dense/four-step dots and skip work
        s = fn(v + acc * 1e-30)
        return (jnp.sum(jnp.real(s)) + jnp.sum(jnp.imag(s))
                ).astype(jnp.float32) * 1e-30
    try:
        r = chain_benchmark(f"{kind}_{n}_{tier}", step, x, n_samples=TOTAL, iters=8)
    except Exception as e:
        print(f"{kind} n={n} {tier}: FAILED {type(e).__name__}: {str(e)[:120]}", flush=True)
        return None
    msps = r.samples_per_sec / 1e6
    print(f"{kind} n={n:>7} {tier:>5}: {r.elapsed_ms:8.2f} ms  {msps:10.0f} Msps", flush=True)
    return msps

kinds = sys.argv[1].split(",") if len(sys.argv) > 1 else ["r2c"]
sizes = [int(s) for s in sys.argv[2].split(",")] if len(sys.argv) > 2 else [2048, 4096, 8192, 16384]
tiers = sys.argv[3].split(",") if len(sys.argv) > 3 else ["dense", "four"]
for kind in kinds:
    for n in sizes:
        for tier in tiers:
            if tier == "dense" and n > 8192: continue
            bench(kind, n, tier)
