"""Accuracy/throughput knob — the counterpart of the reference's
examples/fastapprox_example.c (its VV_DSP_FAST_EXP / has_fastapprox
demo): here the fast-approx-math role is played by the matmul precision
tiers, switched at runtime with config.set_matmul_precision.

Shows the error each tier introduces on an MFCC front-end vs the
fp32-parity tier (benchmarks/accuracy_tradeoff.py measures the full
curve)."""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))  # repo root

import numpy as np
import jax
import jax.numpy as jnp

from vv_dsp_tpu import config
from vv_dsp_tpu.models import MFCCFrontend
from vv_dsp_tpu.ops import fft

print("vv-dsp-tpu precision-knob example")
print("=================================\n")
print("Available accuracy tiers (config.set_matmul_precision):")
print("- highest: 6-pass bf16x3, f32-parity (the default contract)")
print("- high:    3-pass bf16x3 (~1e-5 rel err)")
print("- default: single-pass bf16 (~1e-3 rel err, fastest)\n")

rng = np.random.default_rng(0)
x = jnp.asarray(rng.standard_normal((1, 48000)), dtype=jnp.float32)
frontend = MFCCFrontend()

# force the matmul transform tier so the knob has something to act on
fft.set_fft_backend("matmul")
config.set_matmul_precision("highest")
ref = np.asarray(jax.jit(frontend)(x))

if jax.default_backend() == "cpu":
    print("(running on CPU: all tiers are true f32 there — on the GPU the "
          "lower tiers run as TF32 on the tensor cores)")
for tier in ("highest", "high", "default"):
    config.set_matmul_precision(tier)
    out = np.asarray(jax.jit(frontend)(x))
    err = np.abs(out - ref).max() / np.abs(ref).max()
    print(f"MFCC @ {tier:8s}: max rel err vs highest = {err:.2e}")

config.set_matmul_precision("highest")
fft.set_fft_backend("auto")
print("\nThroughput per tier: python benchmarks/accuracy_tradeoff.py")
