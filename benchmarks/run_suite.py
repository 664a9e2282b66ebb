"""Benchmark suite — the counterpart of the reference's bench/ programs
(bench_stft.c size sweep, bench_resample_fixed.c quality/ratio sweep,
bench_filter, bench_pipeline.c end-to-end chain), emitting the same record
shape {name, elapsed_ms, samples_per_sec, rtf, iterations} as
bench/bench_framework.h:31-48, one JSON object per line plus a profile file.

Run: python benchmarks/run_suite.py [--out profiles.json] [--quick] [--cpu]

Needs a GPU unless --cpu is given (a CPU smoke run, not a measurement).
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np
import jax
import jax.numpy as jnp


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None, help="write records to this file")
    ap.add_argument("--quick", action="store_true", help="fewer configs")
    ap.add_argument("--cpu", action="store_true",
                    help="CPU smoke run (no measurement)")
    args = ap.parse_args()
    if args.cpu:
        jax.config.update("jax_platforms", "cpu")

    from vv_dsp_tpu.ops import fir, resample
    from vv_dsp_tpu.ops.stft import STFT
    from vv_dsp_tpu.models import NorthStarChain, SpectralGate
    from vv_dsp_tpu.utils.compile_cache import enable_compile_cache
    from vv_dsp_tpu.utils.profiling import chain_benchmark

    enable_compile_cache()
    dev = jax.devices()[0]
    device = {"platform": dev.platform, "kind": dev.device_kind,
              "count": len(jax.devices())}
    print(json.dumps({"device": device}), flush=True)
    if dev.platform != "gpu" and not args.cpu:
        print("run_suite.py: no GPU; nothing measured (--cpu for a smoke "
              "run)", file=sys.stderr)
        return 1

    def _use(out):
        # consume the FULL output: slicing one element lets XLA's simplifier
        # slice backward through dots and skip most of the work (measured:
        # a "60 TFLOPS" dense pair that really runs at 21)
        return jnp.sum(out).astype(jnp.float32) * 1e-30

    def _use_c(out):
        return (jnp.sum(jnp.real(out)) + jnp.sum(jnp.imag(out))
                ).astype(jnp.float32) * 1e-30

    rng = np.random.default_rng(0)
    channels, fs = 16, 48000.0
    n = 479232  # 10 s @ 48 kHz rounded to a 3*512 multiple for the chain
    x = jnp.asarray(rng.standard_normal((channels, n)), dtype=jnp.float32)
    total = channels * n
    results = []

    def record(r):
        results.append(r)
        print(r.to_json(), flush=True)

    # --- STFT size sweep (bench_stft.c) ---
    sizes = [1024] if args.quick else [256, 512, 1024, 2048, 4096]
    for nfft in sizes:
        plan = STFT(nfft, nfft // 4)
        record(chain_benchmark(
            f"stft_{nfft}_c2c",
            lambda v, acc, plan=plan: _use_c(
                plan.process(v + acc * 1e-30)),
            x, n_samples=total, sample_rate=fs))

    # --- STFT roundtrip (dump_stft_roundtrip path) ---
    plan = STFT(1024, 256)

    def rt(v, acc):
        spec = plan.process(v + acc * 1e-30, rfft=True)
        return _use(plan.reconstruct(spec, n, rfft=True))

    record(chain_benchmark("stft_1024_roundtrip", rt, x, n_samples=total,
                           sample_rate=fs))

    # --- FIR tap sweep (bench_filter) ---
    taps_list = [64] if args.quick else [16, 64, 256, 1024]
    for taps in taps_list:
        h = fir.design_lowpass(taps, 0.3)
        record(chain_benchmark(
            f"fir_{taps}_best",
            lambda v, acc, h=h: _use(fir.fir_apply_best(h, v + acc * 1e-30)),
            x, n_samples=total, sample_rate=fs))

    # --- resampling (bench_resample_fixed.c ratios) ---
    ratios = [(4, 3)] if args.quick else [(2, 1), (1, 2), (4, 3), (160, 147)]
    for up, down in ratios:
        n2 = n // down * down
        xv = x[..., :n2]
        record(chain_benchmark(
            f"resample_poly_{up}_{down}",
            lambda v, acc, up=up, down=down: _use(resample.resample_poly_best(
                v + acc * 1e-30, up, down)),
            xv, n_samples=channels * n2, sample_rate=fs))

    # --- IIR cascade / Savitzky-Golay / Hilbert (filter-module surfaces) ---
    if not args.quick:
        from vv_dsp_tpu.ops import iir as _iir
        from vv_dsp_tpu.ops import savgol as _sg
        from vv_dsp_tpu.ops import hilbert as _hb
        sos4 = _iir.butter_sos(4, 0.2)
        record(chain_benchmark(
            "iir_butter4",
            lambda v, acc: _use(_iir.iir_apply(sos4, v + acc * 1e-30)),
            x, n_samples=total, sample_rate=fs))
        record(chain_benchmark(
            "savgol_31_3",
            lambda v, acc: _use(_sg.savgol_filter(v + acc * 1e-30, 31, 3)),
            x, n_samples=total, sample_rate=fs))
        record(chain_benchmark(
            "hilbert_envelope",
            lambda v, acc: _use(_hb.envelope(v + acc * 1e-30)),
            x, n_samples=total, sample_rate=fs))

    # --- CZT / cepstrum (spectral consumers through the universal FFT
    # dispatch; reference: bench_czt tool, src/envelope/cepstrum.c) ---
    if not args.quick:
        import math as _math
        from vv_dsp_tpu.ops import czt as _czt
        from vv_dsp_tpu.ops import envelope as _env
        n_czt = 4096
        xz = x[:, :n_czt]
        w_dft = complex(_math.cos(2 * _math.pi / n_czt),
                        -_math.sin(2 * _math.pi / n_czt))
        record(chain_benchmark(
            "czt_4096_dft_equiv",
            lambda v, acc: _use_c(_czt.czt(v + acc * 1e-30, n_czt, w_dft,
                                           1.0 + 0j)),
            xz, n_samples=channels * n_czt, sample_rate=fs))
        record(chain_benchmark(
            "cepstrum_4096",
            lambda v, acc: _use(_env.cepstrum_real(v + acc * 1e-30)),
            xz, n_samples=channels * n_czt, sample_rate=fs))
        # batched zoom-FFT serving shape: the whole 10 s signal chopped
        # into 4096-point segments, ONE czt call — the amortized
        # throughput of the same transform as the 16-row czt_4096 row
        n_seg = n // n_czt
        xzb = x[:, : n_seg * n_czt].reshape(channels * n_seg, n_czt)
        record(chain_benchmark(
            "czt_4096_batched",
            lambda v, acc: _use_c(_czt.czt(v + acc * 1e-30, n_czt, w_dft,
                                           1.0 + 0j)),
            xzb, n_samples=channels * n_seg * n_czt, sample_rate=fs))

    # --- end-to-end pipelines (bench_pipeline.c analog + north star) ---
    gate = SpectralGate()
    record(chain_benchmark(
        "pipeline_spectral_gate",
        lambda v, acc: _use(gate(v + acc * 1e-30)), x, n_samples=total,
        sample_rate=fs))
    chain = NorthStarChain()
    record(chain_benchmark(
        "pipeline_north_star",
        lambda v, acc: _use(chain(v + acc * 1e-30)), x, n_samples=total,
        sample_rate=fs))

    profile = {
        "device": device,
        "channels": channels,
        "signal_samples": n,
        "results": [json.loads(r.to_json()) for r in results],
    }
    if args.out:
        with open(args.out, "w") as f:
            json.dump(profile, f, indent=1)
        print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
