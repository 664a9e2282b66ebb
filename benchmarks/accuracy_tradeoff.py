"""Accuracy/throughput curve for the matmul-precision knob — the analog
of the reference's approx-math tradeoff bench
(bench/bench_accuracy_performance_trade_offs.c:37-50: exact vs fast-approx
sin/exp accuracy and speed).

For each precision tier of `config.set_matmul_precision`
(highest = fp32, high and default = TF32 tensor cores on the GPU) this
measures, on the card:
  - max |err| / max |ref| vs a float64 HOST oracle (numpy/scipy), and
  - chained-fori-loop throughput (the only trustworthy timing here),
for the three matmul-dominated surfaces: STFT-1024 power, the 1024-tap
FIR, and the MFCC frontend.

Writes benchmarks/accuracy_tradeoff.json.
"""

import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import numpy as np
import jax
import jax.numpy as jnp


def host_oracles(x64, h64, nfft, hop, n_mels, n_mfcc, sr):
    """float64 numpy references for the three surfaces — the same math as
    the device path (windows/filterbank/DCT from the package's own f64 host
    builders) evaluated entirely in float64."""
    from vv_dsp_tpu.ops.mel import mel_filterbank_np, _dct2_matrix
    from vv_dsp_tpu.ops.window import get_window_np

    n = x64.shape[-1]
    nf = 1 + (n - nfft + hop) // hop
    idx = np.arange(nf)[:, None] * hop + np.arange(nfft)[None, :]
    xp = np.pad(x64, [(0, 0), (0, max(0, idx.max() + 1 - n))])
    frames = xp[:, idx] * get_window_np("hann", nfft)[None, None, :]
    power = np.abs(np.fft.rfft(frames, axis=-1)) ** 2

    fir = np.stack([np.convolve(row, h64)[:n] for row in x64])

    fb = mel_filterbank_np(nfft, n_mels, sr, 0.0, sr / 2.0)
    logmel = np.log(power @ fb.T + 1e-10)
    mfcc = logmel @ np.asarray(_dct2_matrix(n_mels))[:n_mfcc].T
    return power, fir, mfcc


def main():
    from vv_dsp_tpu import config
    from vv_dsp_tpu.ops.stft import STFT
    from vv_dsp_tpu.ops import fir as _fir
    from vv_dsp_tpu.ops import mel as _mel
    from vv_dsp_tpu.utils.profiling import chain_benchmark

    nfft, hop = 1024, 256
    n_mels, n_mfcc, sr = 26, 13, 16000.0
    ch, n = 16, 479232
    rng = np.random.default_rng(0)
    x64 = rng.standard_normal((ch, n))
    h64 = _fir.design_lowpass_np(1024, 0.45)
    err_x = jnp.asarray(x64[:, : 4 * 48000].astype(np.float32))
    want_power_s, want_fir_s, want_mfcc_s = host_oracles(
        x64[:, : 4 * 48000], h64, nfft, hop, n_mels, n_mfcc, sr)
    x = jnp.asarray(x64.astype(np.float32))
    h = h64.astype(np.float32)

    def surfaces():
        plan = STFT(nfft, hop)
        return {
            "stft_1024_power": lambda v: plan.power(v),
            "fir_1024_mxu": lambda v: _fir.fir_apply_best(h, v),
            "mfcc_frontend": lambda v: _mel.mfcc(
                plan.power(v), nfft, n_mels, n_mfcc, sr),
        }

    def rel_err(got, want):
        return float(np.abs(np.asarray(got, np.float64) - want).max()
                     / np.abs(want).max())

    rows = []
    for prec in ("highest", "high", "default"):
        config.set_matmul_precision(prec)
        fns = surfaces()
        oracles = {"stft_1024_power": want_power_s, "fir_1024_mxu": want_fir_s,
                   "mfcc_frontend": want_mfcc_s}
        for name, fn in fns.items():
            err = rel_err(jax.jit(fn)(err_x), oracles[name])

            def step(v, acc, fn=fn):
                return jnp.sum(fn(v + acc * 1e-30)
                               ).astype(jnp.float32) * 1e-30

            # best of 3 against run-to-run drift
            r = min((chain_benchmark(f"{name}@{prec}", step, x,
                                     n_samples=ch * n) for _ in range(3)),
                    key=lambda b: b.elapsed_ms)
            rows.append({
                "surface": name,
                "precision": prec,
                "max_rel_err_vs_f64": err,
                "elapsed_ms": round(r.elapsed_ms, 3),
                "msamples_per_sec": round(r.samples_per_sec / 1e6, 1),
            })
            print(f"{name:18s} {prec:8s} err={err:.2e} "
                  f"{r.samples_per_sec/1e6:8.1f} Msps", flush=True)
    config.set_matmul_precision("highest")

    artifact = {
        "device": str(jax.devices()[0]),
        "channels": ch,
        "signal_samples": n,
        "note": "error vs float64 host oracle on 4 s of the same signal; "
                "throughput via chained fori_loop on the full 10 s signal, "
                "full-output-sum consumption",
        "rows": rows,
    }
    out = os.path.join(REPO, "benchmarks", "accuracy_tradeoff.json")
    with open(out, "w") as f:
        json.dump(artifact, f, indent=1)
    print(f"wrote {out}")


if __name__ == "__main__":
    main()
