"""Serving-ingest pattern: batch WAV decode overlapped with device compute.

Demonstrates the production loop the batch-scaling bench models
(benchmarks/bench_batch_scaling.py): many audio streams per step, host
decode running ahead of the device via `prefetch_batches`, features out.

Run: python examples/serving_example.py  (any backend; ~30 s on first
compile, then the loop itself is decode-overlapped)
"""

import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))  # repo root

import numpy as np
import jax
import jax.numpy as jnp

from vv_dsp_tpu.io import write_wav, prefetch_batches
from vv_dsp_tpu.models import MFCCFrontend


def make_corpus(root: str, n_files: int, seconds: float, sr: int) -> list:
    rng = np.random.default_rng(0)
    n = int(seconds * sr)
    t = np.arange(n) / sr
    paths = []
    for i in range(n_files):
        f0 = 200.0 + 50.0 * i
        x = (0.4 * np.sin(2 * np.pi * f0 * t)
             + 0.02 * rng.standard_normal(n)).astype(np.float32)
        p = os.path.join(root, f"stream{i:03d}.wav")
        write_wav(p, x, sr, format=16)
        paths.append(p)
    return paths


def main() -> None:
    sr = 48000
    batch_size = 16
    root = tempfile.mkdtemp(prefix="vvdsp_serving_")
    paths = make_corpus(root, 64, seconds=2.0, sr=sr)

    model = jax.jit(MFCCFrontend(nfft=1024, hop=256, n_mels=40, n_mfcc=13,
                                 sample_rate=float(sr)))
    chunks = [paths[i:i + batch_size]
              for i in range(0, len(paths), batch_size)]

    # warm the jit cache so the loop below measures steady-state serving
    cap = 2 * sr
    model(jnp.zeros((batch_size, cap), jnp.float32)).block_until_ready()

    total_samples = 0
    t0 = time.perf_counter()
    for batch in prefetch_batches(chunks, capacity_frames=cap, channels=1):
        if not batch.ok:
            bad = [p for p, f in zip(batch.paths, batch.frames) if f < 0]
            raise SystemExit(f"undecodable inputs: {bad}")
        feats = model(jnp.asarray(batch.data[:, 0, :]))
        feats.block_until_ready()
        total_samples += int(batch.frames.sum())
        print(f"batch of {len(batch.paths)}: features {feats.shape}")
    dt = time.perf_counter() - t0
    print(f"served {total_samples} samples in {dt:.2f}s "
          f"({total_samples / dt / 1e6:.0f} Msamples/s end-to-end, "
          f"decode overlapped) on {jax.devices()[0].platform}")


if __name__ == "__main__":
    main()
