"""Profiling, benchmarking, and roofline accounting.

The reference ships a custom bench framework emitting JSON result records
{name, elapsed, samples/s, RTF, iterations} (bench/bench_framework.h:31-48)
plus committed profile artifacts (docs/profiles/*.json). Equivalents here:

- :func:`benchmark` — same record shape (name / elapsed_ms / samples_per_sec
  / rtf / iterations) for any jitted fn, with compile excluded and device
  sync via block_until_ready,
- :func:`trace` — context manager around jax.profiler for on-device
  timelines (view in TensorBoard / Perfetto),
- :class:`Roofline` — per-device speed-of-light model: given FLOPs and HBM
  bytes of an op, the attainable time bound max(flops/peak, bytes/bw) and
  the achieved fraction, against the published peaks in DEVICE_PEAKS.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import time

import jax


# Published peaks keyed by jax's device_kind: dense FLOP/s per precision
# (no sparsity) and HBM bytes/s. Source: NVIDIA H100 Tensor Core GPU data
# sheet, SXM5 part, at its 700 W power limit. "fp32" is the CUDA-core rate
# that lax.Precision.HIGHEST runs at; "tf32" is what HIGH/DEFAULT f32 dots
# run at on the tensor cores.
DEVICE_PEAKS = {
    "NVIDIA H100 80GB HBM3": {"fp32": 67e12, "tf32": 495e12, "bf16": 989e12,
                              "hbm": 3.35e12},
}


def device_peaks(device_kind: str | None = None) -> dict:
    """DEVICE_PEAKS row for `device_kind` (default: the first jax device).
    A device without a row is an error, never a default."""
    if device_kind is None:
        device_kind = jax.devices()[0].device_kind
    try:
        return DEVICE_PEAKS[device_kind]
    except KeyError:
        raise ValueError(f"no published peaks for device kind "
                         f"{device_kind!r}; add a DEVICE_PEAKS row") from None


@dataclasses.dataclass
class BenchResult:
    """Mirror of vv_dsp_bench_result (bench/bench_framework.h:31-38)."""

    name: str
    elapsed_ms: float
    samples_per_sec: float
    rtf: float  # real-time factor: elapsed / signal duration
    iterations: int

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self))


def benchmark(name: str, fn, *args, n_samples: int | None = None,
              sample_rate: float = 48000.0, iters: int = 20,
              warmup: int = 2) -> BenchResult:
    """Time a device function (compile excluded, device-synced).

    n_samples: samples processed per call (for throughput/RTF); inferred
    from args[0]'s size when omitted.
    """
    if n_samples is None:
        n_samples = int(args[0].size)
    for _ in range(warmup):
        jax.block_until_ready(fn(*args))
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(*args)
    jax.block_until_ready(out)
    dt = time.perf_counter() - t0
    per_call = dt / iters
    return BenchResult(
        name=name,
        elapsed_ms=per_call * 1e3,
        samples_per_sec=n_samples / per_call,
        rtf=per_call / (n_samples / sample_rate),
        iterations=iters,
    )


def chain_benchmark(name: str, step, x, n_samples: int | None = None,
                    sample_rate: float = 48000.0,
                    iters: int = 200, repeats: int = 3) -> BenchResult:
    """Chained timing: all iterations inside ONE jitted lax.fori_loop
    with iteration k+1 data-dependent on k, one scalar transfer at the end,
    so per-call dispatch is amortized over `iters` and the reduction to a
    scalar keeps every iteration live.

    step(x, acc_scalar) -> scalar must fold `acc` into its input (e.g.
    ``x + acc * 1e-30``) AND reduce the FULL output (e.g. sum) — consuming
    only a slice lets XLA's simplifier prune work back through the dots
    (measured 2x inflation on a dense-basis STFT).

    Returns the best of `repeats` runs.
    """
    import jax.numpy as jnp
    from jax import lax

    if n_samples is None:
        n_samples = int(x.size)

    @jax.jit
    def run(v):
        return lax.fori_loop(0, iters, lambda i, acc: step(v, acc),
                             jnp.float32(0.0))

    float(run(x))  # compile + warmup
    best = float("inf")
    for _ in range(max(1, repeats)):
        t0 = time.perf_counter()
        float(run(x))
        best = min(best, time.perf_counter() - t0)
    per_call = best / iters
    return BenchResult(
        name=name,
        elapsed_ms=per_call * 1e3,
        samples_per_sec=n_samples / per_call,
        rtf=per_call / (n_samples / sample_rate),
        iterations=iters,
    )


@contextlib.contextmanager
def trace(log_dir: str = "/tmp/jax-trace"):
    """On-device profiler timeline (open with TensorBoard or Perfetto);
    replaces the reference's host-side monotonic timers with real per-op
    device tracing."""
    jax.profiler.start_trace(log_dir)
    try:
        yield log_dir
    finally:
        jax.profiler.stop_trace()


@dataclasses.dataclass(frozen=True)
class Roofline:
    """Speed-of-light bound for one op on one device."""

    flops: float
    hbm_bytes: float
    device_kind: str = ""  # "" = the first jax device

    def _specs(self):
        # fp32: the rate lax.Precision.HIGHEST (the default) runs at
        peaks = device_peaks(self.device_kind or None)
        return peaks["fp32"], peaks["hbm"]

    @property
    def compute_bound(self) -> bool:
        peak_f, peak_b = self._specs()
        return self.flops / peak_f > self.hbm_bytes / peak_b

    @property
    def attainable_seconds(self) -> float:
        peak_f, peak_b = self._specs()
        return max(self.flops / peak_f, self.hbm_bytes / peak_b)

    def achieved_fraction(self, measured_seconds: float) -> float:
        """1.0 = at the roofline; <1 = headroom remains."""
        return self.attainable_seconds / max(measured_seconds, 1e-12)


def fir_roofline(channels: int, n: int, taps: int,
                 device_kind: str = "") -> Roofline:
    """Direct-form FIR: 2*taps FLOPs/sample, one read + one write."""
    return Roofline(flops=2.0 * channels * n * taps,
                    hbm_bytes=4.0 * channels * (2 * n + taps),
                    device_kind=device_kind)


def stft_roofline(channels: int, frames: int, nfft: int,
                  device_kind: str = "") -> Roofline:
    """Per-frame C2C FFT: 5*N*log2(N) FLOPs, frame in + spectrum out."""
    import math
    return Roofline(
        flops=5.0 * channels * frames * nfft * math.log2(max(nfft, 2)),
        hbm_bytes=4.0 * channels * frames * (nfft + 2 * nfft),
        device_kind=device_kind)


def resample_roofline(channels: int, n_out: int, taps_pp: int,
                      n_in: int, device_kind: str = "") -> Roofline:
    """Polyphase: 2*taps_pp FLOPs per output, input read + output write."""
    return Roofline(flops=2.0 * channels * n_out * taps_pp,
                    hbm_bytes=4.0 * channels * (n_in + n_out),
                    device_kind=device_kind)
