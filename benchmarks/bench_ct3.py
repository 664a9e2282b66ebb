"""CT3 (six-step three-factor) tier vs the two-level four-step and the XLA
FFT HLO at large N — the round-5 'long-signal cliff' measurement, plus the
routed consumers (Hilbert envelope, real cepstrum) at the flagship length.

Run: python benchmarks/bench_ct3.py
"""

import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np
import jax
import jax.numpy as jnp


def main():
    from vv_dsp_tpu.ops import fft as F
    from vv_dsp_tpu.ops import hilbert as hb
    from vv_dsp_tpu.ops import envelope as env
    from vv_dsp_tpu.utils.profiling import chain_benchmark

    rng = np.random.default_rng(0)
    c = 16

    def _use_c(out):
        return (jnp.sum(jnp.real(out)) + jnp.sum(jnp.imag(out))
                ).astype(jnp.float32) * 1e-30

    def _use(out):
        return jnp.sum(out).astype(jnp.float32) * 1e-30

    for n in [262144, 479232, 524288, 1048576]:
        x = jnp.asarray(rng.standard_normal((c, n)), dtype=jnp.float32)
        # complex input built on the device
        z = jax.jit(lambda a: jax.lax.complex(a, jnp.zeros_like(a)))(x)

        plans = {"ct3": F._ct3_split(n), "four_step": F._four_step_factors(n)}
        rows = {}
        for name, factors in plans.items():
            if factors is None or (name == "ct3" and len(factors) != 3):
                continue
            r = chain_benchmark(
                f"c2c_{name}_{n}",
                lambda v, acc, f=factors: _use_c(F._four_step_fft(
                    v + acc * 1e-30, n, inverse=False, factors=f)),
                z, n_samples=c * n, iters=100)
            rows[name] = r.elapsed_ms
        r = chain_benchmark(
            f"c2c_xla_{n}",
            lambda v, acc: _use_c(jnp.fft.fft(v + acc * 1e-30)),
            z, n_samples=c * n, iters=100)
        rows["xla_hlo"] = r.elapsed_ms
        print(json.dumps({"n": n, "c2c_ms": {k: round(v, 3)
                                             for k, v in rows.items()}}),
              flush=True)

    # routed consumers at the flagship length
    n = 479232
    x = jnp.asarray(rng.standard_normal((c, n)), dtype=jnp.float32)
    r = chain_benchmark(
        "hilbert_envelope", lambda v, acc: _use(hb.envelope(v + acc * 1e-30)),
        x, n_samples=c * n, iters=100)
    print(json.dumps({"hilbert_envelope_ms": round(r.elapsed_ms, 3),
                      "Msps": round(c * n / r.elapsed_ms / 1e3, 1)}),
          flush=True)
    r = chain_benchmark(
        "cepstrum_real", lambda v, acc: _use(
            env.cepstrum_real(v + acc * 1e-30)),
        x, n_samples=c * n, iters=100)
    print(json.dumps({"cepstrum_real_ms": round(r.elapsed_ms, 3),
                      "Msps": round(c * n / r.elapsed_ms / 1e3, 1)}),
          flush=True)


if __name__ == "__main__":
    main()
