"""Device time per stage of NorthStarChain and SpectralGate from ONE
jax.profiler trace on the GPU, with each stage's share of the roofline.

Each stage also runs as its own jitted function, so the HLO module name in
the trace (``jit_<stage>``) names the stage without relying on XLA's kernel
names; the whole pipelines run in the same window for their fused totals.
Inside a module, kernels are split into cuFFT (kernel name contains "fft"),
cuBLAS (gemm/gemv) and XLA's own fusions. Three calibration modules (a
float32 and a bf16 8192^3 matmul, a 1 GiB elementwise pass) show what this
card reaches on plain XLA next to the published peaks
(utils/profiling.DEVICE_PEAKS).

FLOPs and bytes per stage are computed from shapes in stages():
bytes are each stage's own inputs plus outputs once (4 bytes per f32,
8 per complex64), FLOPs are the operations as executed (the head's banded
einsum counts its zero fill; a length-N real FFT counts 2.5 N log2 N).

    python benchmarks/trace_pipelines.py [--trace-dir DIR] [--calls 5]
"""

from __future__ import annotations

import argparse
import collections
import glob
import json
import math
import os
import subprocess
import sys
import tempfile
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np

CHANNELS, N = 16, 479232


def _kernel_class(name: str) -> str:
    low = name.lower()
    if "fft" in low:
        return "cufft"
    if "gemm" in low or "gemv" in low or "xmma" in low or "cutlass" in low:
        return "cublas"
    return "xla_fusion"


def stages(x):
    """{name: (fn, args, flops, bytes)} for the staged chain and gate, the
    whole pipelines and the calibration modules; each fn is named after its
    key, so its trace module is jit_<key>. flops None: not a roofline row."""
    import jax.numpy as jnp
    from vv_dsp_tpu.models import NorthStarChain, SpectralGate
    from vv_dsp_tpu.ops import fft as F
    from vv_dsp_tpu.ops import mel, resample
    from vv_dsp_tpu.ops.stft import STFT

    ch = NorthStarChain()
    c, n = x.shape
    sr = ch.sample_rate * ch.up / ch.down
    plan = STFT(ch.nfft, ch.hop, ch.window)

    def chain_head(v):
        return resample.fir_resample_fused(ch.fir_coeffs, v, ch.up, ch.down)

    def chain_framing(y):
        return plan._windowed_frames(y)

    def chain_fft_power(fr):
        return F.rfft_power(fr)

    def chain_mel(p):
        return mel.log_mel_spectrogram(p, ch.nfft, ch.n_mels, sr)

    def chain_dct(lm):
        return mel.mfcc_from_log_mel(lm, ch.n_mfcc)

    def northstar_chain(v):
        return ch(v)

    y = resample.fir_resample_fused(ch.fir_coeffs, x, ch.up, ch.down)
    fr = chain_framing(y)
    pw = chain_fft_power(fr)
    lm = chain_mel(pw)
    nf, bins = pw.shape[-2], pw.shape[-1]
    f32, c64 = 4, 8

    # executed FLOPs of the banded head einsum (resample._upfirdn_tall)
    g = math.gcd(ch.up, ch.down)
    up, down = ch.up // g, ch.down // g
    gf, off = resample._fused_fir_resample_filter(
        tuple(np.asarray(ch.fir_coeffs, np.float64)), up, down)
    taps_pp = -(-len(gf) // up)
    group = max(1, int(round(taps_pp / down)))
    m, _ = resample._upfirdn_tall_plan(tuple(gf), up, down, off, group)
    wd, u = m.shape
    width = -(-wd // (group * down)) * group * down
    k_frames = -(-y.shape[-1] // u)
    head_flops = 2.0 * c * k_frames * width * u

    gate = SpectralGate()
    pad = gate.nfft - gate.hop
    gplan = gate.stft_plan
    n_pad = n + 2 * pad

    def gate_framing(v):
        return gplan._windowed_frames(jnp.pad(v, [(0, 0), (pad, pad)]))

    def gate_rfft(fr_):
        return F.rfft(fr_)

    def gate_mask(s):
        return gate._gate(s)

    def gate_irfft(s):
        return F.irfft(s, gate.nfft)

    def gate_ola(t):
        return gplan._ola_norm(t, n_pad)[..., pad:pad + n]

    def spectral_gate(v):
        return gate(v)

    gfr = gate_framing(x)
    gspec = gate_rfft(gfr)
    gt = gate_irfft(gspec)
    gnf, gbins = gspec.shape[-2], gspec.shape[-1]
    fft_fl = lambda rows, nn: 2.5 * rows * nn * math.log2(nn)

    a = jnp.ones((8192, 8192), jnp.float32)
    big = jnp.ones((1 << 28,), jnp.float32)
    from jax import lax

    def calib_f32_gemm(p):
        return jnp.matmul(p, p, precision=lax.Precision.HIGHEST)

    def calib_bf16_gemm(p):
        q = p.astype(jnp.bfloat16)
        return jnp.matmul(q, q, preferred_element_type=jnp.float32)

    def calib_copy(p):
        return p * 2.0

    return {
        "chain_head": (chain_head, (x,), head_flops,
                       f32 * (x.size + y.size + m.size)),
        "chain_framing": (chain_framing, (y,), 0.0,
                          f32 * (y.size + fr.size)),
        "chain_fft_power": (chain_fft_power, (fr,),
                            fft_fl(c * nf, ch.nfft) + 3.0 * pw.size,
                            f32 * (fr.size + pw.size)),
        "chain_mel": (chain_mel, (pw,), 2.0 * pw.size * ch.n_mels,
                      f32 * (pw.size + lm.size + bins * ch.n_mels)),
        "chain_dct": (chain_dct, (lm,), 2.0 * lm.size * ch.n_mfcc,
                      f32 * (lm.size + c * nf * ch.n_mfcc)),
        "northstar_chain": (northstar_chain, (x,), None, None),
        "gate_framing": (gate_framing, (x,), 0.0,
                         f32 * (x.size + gfr.size)),
        "gate_rfft": (gate_rfft, (gfr,), fft_fl(c * gnf, gate.nfft),
                      f32 * gfr.size + c64 * gspec.size),
        "gate_mask": (gate_mask, (gspec,), 0.0, 2 * c64 * gspec.size),
        "gate_irfft": (gate_irfft, (gspec,), fft_fl(c * gnf, gate.nfft),
                       c64 * gspec.size + f32 * gt.size),
        "gate_ola": (gate_ola, (gt,), 0.0, f32 * (gt.size + x.size)),
        "spectral_gate": (spectral_gate, (x,), None, None),
        "calib_f32_gemm": (calib_f32_gemm, (a,), 2.0 * 8192 ** 3,
                           3 * f32 * a.size),
        "calib_bf16_gemm": (calib_bf16_gemm, (a,), 2.0 * 8192 ** 3,
                            3 * f32 * a.size),
        "calib_copy": (calib_copy, (big,), 0.0, 2 * f32 * big.size),
    }


def reduce_trace(path: str, modules: set[str]) -> dict:
    """Per jit module: kernel time by class, kernel count, and the busy
    union of its kernels (the device plane's stream lines)."""
    import jax
    pd = jax.profiler.ProfileData.from_file(path)
    per = collections.defaultdict(lambda: {
        "kernel_ns": collections.Counter(), "intervals": []})
    for plane in pd.planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            if not line.name.startswith("Stream"):
                continue
            for ev in line.events:
                stats = dict(ev.stats)
                mod = stats.get("hlo_module", "")
                if mod not in modules:
                    continue
                rec = per[mod]
                rec["kernel_ns"][_kernel_class(ev.name)] += ev.duration_ns
                rec["intervals"].append((ev.start_ns, ev.end_ns))
    out = {}
    for mod, rec in per.items():
        iv = sorted(rec["intervals"])
        busy, cur_s, cur_e = 0.0, None, None
        for s, e in iv:
            if cur_e is None or s > cur_e:
                if cur_e is not None:
                    busy += cur_e - cur_s
                cur_s, cur_e = s, e
            else:
                cur_e = max(cur_e, e)
        if cur_e is not None:
            busy += cur_e - cur_s
        out[mod] = {"kernel_ns": dict(rec["kernel_ns"]), "busy_ns": busy,
                    "kernels": len(iv)}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--trace-dir", default=None,
                    help="keep the trace here (default: a temporary dir)")
    ap.add_argument("--calls", type=int, default=5,
                    help="traced calls per module")
    args = ap.parse_args(argv)

    import jax
    from vv_dsp_tpu.utils.compile_cache import enable_compile_cache
    from vv_dsp_tpu.utils.profiling import device_peaks

    enable_compile_cache()
    if jax.default_backend() != "gpu":
        print("trace_pipelines: needs a GPU", file=sys.stderr)
        return 1
    dev = jax.devices()[0]
    peaks = device_peaks(dev.device_kind)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60, check=True).stdout.strip()
    x = jax.device_put(np.random.default_rng(0).standard_normal(
        (CHANNELS, N)).astype(np.float32))
    table = stages(x)
    jitted, wall = {}, {}
    for name, (fn, fargs, _, _) in table.items():
        jitted[name] = jax.jit(fn).lower(*fargs).compile()
        jax.block_until_ready(jitted[name](*fargs))
        times = []
        for _ in range(args.calls):
            t0 = time.perf_counter()
            jax.block_until_ready(jitted[name](*fargs))
            times.append(time.perf_counter() - t0)
        wall[name] = float(np.median(times))

    trace_dir = args.trace_dir or tempfile.mkdtemp(prefix="vvdsp_trace_")
    jax.profiler.start_trace(trace_dir)
    for name, (_, fargs, _, _) in table.items():
        for _ in range(args.calls):
            jax.block_until_ready(jitted[name](*fargs))
    jax.profiler.stop_trace()
    path = sorted(glob.glob(os.path.join(trace_dir, "**", "*.xplane.pb"),
                            recursive=True))[-1]

    mod_of = {f"jit_{k}": k for k in table}
    red = reduce_trace(path, set(mod_of))
    print(f"card: {card}; device_kind: {dev.device_kind}; "
          f"{args.calls} calls per module; trace {path}")
    for mod, stage in mod_of.items():
        r = red.get(mod)
        if r is None:
            print(f"{stage}: no kernels in the trace", file=sys.stderr)
            return 1
        _, _, flops, nbytes = table[stage]
        k_ns = sum(r["kernel_ns"].values()) / args.calls
        busy = r["busy_ns"] / args.calls * 1e-9
        row = {"stage": stage, "module": mod,
               "wall_us": wall[stage] * 1e6,
               "kernel_us": k_ns / 1e3,
               "idle_share": 1.0 - busy / wall[stage],
               "kernels_per_call": r["kernels"] / args.calls,
               "by_class_us": {k: v / args.calls / 1e3
                               for k, v in r["kernel_ns"].items()}}
        if flops is not None:
            prec = "bf16" if "bf16" in stage else "fp32"
            t_f = flops / peaks[prec]
            t_b = nbytes / peaks["hbm"]
            row.update(flops=flops, bytes=nbytes,
                       achieved_tflops=flops / (k_ns * 1e-9) / 1e12,
                       achieved_gbps=nbytes / (k_ns * 1e-9) / 1e9,
                       roofline_share=max(t_f, t_b) / (k_ns * 1e-9),
                       bound="flops" if t_f > t_b else "bytes")
        print(json.dumps(row))
    return 0


if __name__ == "__main__":
    sys.exit(main())
