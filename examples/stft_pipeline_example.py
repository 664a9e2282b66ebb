"""STFT spectral-gate denoising pipeline (counterpart of the reference's
bench/bench_pipeline.c chain): noisy sine -> STFT -> magnitude gate -> ISTFT."""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))  # repo root

import numpy as np
import jax
import jax.numpy as jnp

from vv_dsp_tpu.models import SpectralGate


def main():
    fs, n = 48000, 48000
    t = np.arange(n) / fs
    clean = 0.8 * np.sin(2 * np.pi * 440.0 * t)
    noisy = clean + 0.05 * np.random.default_rng(0).standard_normal(n)
    x = jnp.asarray(noisy[None, :], dtype=jnp.float32)

    gate = SpectralGate(nfft=1024, hop=256, threshold=0.1)
    y = jax.jit(gate)(x)

    seg = slice(1024, n - 1024)
    snr_in = 10 * np.log10(np.mean(clean[seg] ** 2)
                           / np.mean((noisy[seg] - clean[seg]) ** 2))
    out = np.asarray(y[0])
    snr_out = 10 * np.log10(np.mean(clean[seg] ** 2)
                            / np.mean((out[seg] - clean[seg]) ** 2))
    print(f"SNR in: {snr_in:.1f} dB -> out: {snr_out:.1f} dB")


if __name__ == "__main__":
    main()
