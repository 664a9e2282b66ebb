#!/usr/bin/env python3
"""Proof that the DSP library runs on an NVIDIA GPU through its entry points.

    python chip_smoke.py              # one card: every single-card phase
    python chip_smoke.py --devices 4  # four cards: the sharded phase only

Every phase runs jitted on the card at the benchmark geometry (16 channels x
479,232 f32 samples, 10 s at 48 kHz) and is compared with a float64
NumPy/SciPy reference (vv_dsp_tpu.utils.oracle, scipy.signal); each line
prints the measured error, max |got - want| / max |want|, beside its
tolerance. One process drives the card(s). Any failed comparison or
exception exits non-zero and prints no result. Without a GPU the script
exits non-zero after the device check.

The last line of stdout is the result:
    {"ok": true, "device": {"platform": "gpu", "kind": "...", "count": N}}

tests/test_chip_smoke.py runs every phase on the CPU at the TINY size.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np

SEED = 0
CHANNELS = 16
N = 479232          # 10 s at 48 kHz, a multiple of 4 * 3 * 512
N_16K = 160000      # 10 s at 16 kHz for the MFCC front end
TINY = dict(channels=2, n=24576, n_16k=16000)  # CPU tests of the phases

# Tolerances, relative to max |reference|, taken from the CPU tests of the
# same op (tests/*.py) or BASELINE.md's parity contract.
TOL = {
    "chain": 5e-5,      # BASELINE.md north-star chain parity
    "stft": 5e-5,       # FFT-class parity (python/test_fft.py)
    "mel": 5e-5,
    "gate": 5e-5,
    "fir": 3e-3,        # tests/test_fir.py RTOL (python/test_filters.py)
    "resample": 5e-5,   # tests/test_resample.py polyphase parity
    "iir": 5e-3,        # tests/test_iir.py long-signal stability
    "savgol": 1e-4,     # tests/test_savgol.py
    "hilbert": 1e-4,    # tests/test_hilbert.py
    "czt": 1e-3,        # tests/test_czt.py
    "cepstrum": 1e-3,   # tests/test_envelope.py
    "stream": 2e-3,     # tests/test_models.py streaming parity
    "wav": 1e-6,        # float32 WAV round trip is exact up to rounding
    "sharded": 2e-3,    # tests/test_models.py sharded chain parity
    "istft": 5e-4,      # tests/test_parallel.py sharded round trip
}


class Checker:
    """Collects comparisons; a failed one fails the run at the end."""

    def __init__(self):
        self.failures = []

    def check(self, name, got, want, tol):
        from vv_dsp_tpu.utils import oracle
        got = np.asarray(got)
        err = oracle.rel_err(got, want)
        ok = bool(np.isfinite(got).all()) and err < tol
        print(f"  {name}: err {err:.3e} tol {tol:.0e} "
              f"{'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            self.failures.append(name)
        return err


def timed(fn, *args, repeats: int = 5):
    """(output, compile seconds, median steady seconds) of jit(fn)(*args),
    each steady call ending in block_until_ready."""
    import jax
    t0 = time.perf_counter()
    compiled = jax.jit(fn).lower(*args).compile()
    compile_s = time.perf_counter() - t0
    out = jax.block_until_ready(compiled(*args))
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        jax.block_until_ready(compiled(*args))
        times.append(time.perf_counter() - t0)
    return out, compile_s, float(np.median(times))


def run(fn, *args):
    import jax
    return jax.block_until_ready(jax.jit(fn)(*args))


def phase_chain(chk, x, x64):
    """NorthStarChain at its defaults vs the float64 oracle on 2 channels,
    plus a finite gradient through the whole chain."""
    import jax
    import jax.numpy as jnp
    from vv_dsp_tpu.models import NorthStarChain
    from vv_dsp_tpu.utils import oracle
    chain = NorthStarChain()
    out, c_s, s_s = timed(chain, x)
    print(f"  NorthStarChain {tuple(x.shape)} -> {tuple(out.shape)}: "
          f"compile {c_s:.2f} s, steady {s_s * 1e3:.3f} ms "
          f"(median of 5)", flush=True)
    chk.check("chain vs float64 oracle (2 ch)", out[:2],
              oracle.northstar_chain(x64[:2], chain), TOL["chain"])
    g = run(jax.grad(lambda v: jnp.mean(chain(v) ** 2)), x)
    ok = bool(jnp.isfinite(g).all()) and g.shape == x.shape
    print(f"  grad of mean(chain(x)^2) wrt x: shape {tuple(g.shape)}, "
          f"finite {ok}", flush=True)
    if not ok:
        chk.failures.append("chain grad")


def phase_pipelines(chk, x, x64, x16, x16_64):
    """SpectralGate on the 48 kHz batch, MFCCFrontend at 16 kHz."""
    from vv_dsp_tpu.models import MFCCFrontend, SpectralGate
    from vv_dsp_tpu.utils import oracle
    gate = SpectralGate()
    out, c_s, s_s = timed(gate, x)
    print(f"  SpectralGate {tuple(x.shape)}: compile {c_s:.2f} s, steady "
          f"{s_s * 1e3:.3f} ms", flush=True)
    chk.check("gate vs float64 gate", out, oracle.spectral_gate(x64, gate),
              TOL["gate"])
    m = MFCCFrontend()
    out = run(m, x16)
    chk.check("MFCCFrontend 16 kHz vs float64", out,
              oracle.mfcc(x16_64, m.nfft, m.hop, m.n_mels, m.n_mfcc,
                          m.sample_rate, m.window, m.lifter), TOL["mel"])


def phase_suite(chk, x, x64):
    """One call of each benchmarks/run_suite.py row's operation at its row
    size, compared on 2 channels."""
    import math
    from scipy import signal as ss
    from vv_dsp_tpu.ops import czt, envelope, fir, hilbert, iir, resample
    from vv_dsp_tpu.ops import savgol
    from vv_dsp_tpu.ops.stft import STFT
    from vv_dsp_tpu.utils import oracle
    r = x64[:2]
    for nfft in (256, 512, 1024, 2048, 4096):
        plan = STFT(nfft, nfft // 4)
        out = run(lambda v: plan.process(v)[:2], x)
        chk.check(f"stft_{nfft}_c2c", out,
                  oracle.stft(r, nfft, nfft // 4), TOL["stft"])
    for taps in (16, 64, 256, 1024):
        h = fir.design_lowpass_np(taps, 0.3)
        out = run(lambda v: fir.fir_apply_best(h.astype(np.float32), v)[:2],
                  x)
        chk.check(f"fir_{taps}_best", out, ss.lfilter(h, [1.0], r, axis=-1),
                  TOL["fir"])
    for up, down in ((2, 1), (1, 2), (4, 3), (160, 147)):
        n2 = x.shape[-1] // down * down
        out = run(lambda v: resample.resample_poly_best(v[:, :n2], up,
                                                        down)[:2], x)
        chk.check(f"resample_poly_{up}_{down}", out,
                  ss.resample_poly(r[:, :n2], up, down, axis=-1),
                  TOL["resample"])
    sos = iir.butter_sos(4, 0.2)
    out = run(lambda v: iir.iir_apply(sos, v)[:2], x)
    chk.check("iir_butter4", out, ss.sosfilt(sos, r, axis=-1), TOL["iir"])
    out = run(lambda v: savgol.savgol_filter(v, 31, 3)[:2], x)
    chk.check("savgol_31_3", out,
              ss.savgol_filter(r, 31, 3, mode="mirror", axis=-1),
              TOL["savgol"])
    out = run(lambda v: hilbert.envelope(v)[:2], x)
    chk.check(f"hilbert_envelope_{x.shape[-1]}", out,
              np.abs(ss.hilbert(r, axis=-1)), TOL["hilbert"])
    n_czt = 4096
    w = complex(math.cos(2 * math.pi / n_czt), -math.sin(2 * math.pi / n_czt))
    out = run(lambda v: czt.czt(v[:, :n_czt], n_czt, w, 1.0 + 0j)[:2], x)
    chk.check("czt_4096_dft_equiv", out,
              ss.czt(r[:, :n_czt], n_czt, w, 1.0, axis=-1), TOL["czt"])
    out = run(lambda v: envelope.cepstrum_real(v[:, :n_czt])[:2], x)
    spec = np.abs(np.fft.rfft(r[:, :n_czt], axis=-1))
    chk.check("cepstrum_4096", out,
              np.fft.irfft(np.log(spec + 1e-12), n_czt, axis=-1),
              TOL["cepstrum"])


def phase_streaming(chk, x):
    """StreamingNorthStar fed 10 ms blocks (480 samples) vs the offline
    ops on the same stream. hop 128 so that a 10 ms block (640 resampled
    samples) holds whole frames."""
    import jax
    import jax.numpy as jnp
    from vv_dsp_tpu.models import StreamingNorthStar
    from vv_dsp_tpu.ops import fir, mel, resample
    from vv_dsp_tpu.ops.stft import STFT
    chain = StreamingNorthStar(hop=128)
    block, n_blocks = 480, 8
    sig = x[:, :block * n_blocks]
    step = jax.jit(chain.process)
    state = chain.init(sig.shape[:-1])
    feats = []
    for i in range(n_blocks):
        f, state = step(state, sig[:, i * block:(i + 1) * block])
        feats.append(f)
    feats.append(jax.jit(chain.flush)(state))
    streamed = jnp.concatenate(feats, axis=-2)
    delay = chain._resampler._geometry[3]
    y = fir.fir_apply(chain.fir_coeffs, sig)
    y = jnp.concatenate([jnp.zeros(y.shape[:-1] + (delay,), y.dtype), y], -1)
    y2 = resample.resample_poly(y, chain.up, chain.down)
    offline = mel.mfcc(STFT(chain.nfft, chain.hop).power(y2), chain.nfft,
                       chain.n_mels, chain.n_mfcc,
                       chain.sample_rate * chain.up / chain.down)
    warm = chain.nfft // chain.hop - 1
    print(f"  StreamingNorthStar: {n_blocks} blocks of {block} + flush -> "
          f"{streamed.shape[-2]} frames", flush=True)
    chk.check("streaming vs offline chain", streamed[..., warm:, :], offline,
              TOL["stream"])


def phase_wav(chk, x):
    """WAV -> SpectralGate -> WAV through vv_dsp_tpu.io (float32 WAV)."""
    import os
    import tempfile
    from vv_dsp_tpu.io import read_wav, write_wav
    from vv_dsp_tpu.io import wav as _wav
    from vv_dsp_tpu.models import SpectralGate
    audio = np.asarray(x[:2]) * 0.1
    gate = SpectralGate()
    with tempfile.TemporaryDirectory() as d:
        src, dst = os.path.join(d, "in.wav"), os.path.join(d, "out.wav")
        write_wav(src, audio, 48000, format=0)
        a, sr = read_wav(src)
        out = np.asarray(run(gate, a))
        write_wav(dst, out, sr, format=0)
        back, sr2 = read_wav(dst)
    codec = "native csrc/wavio.cpp" if _wav._get_lib() else "numpy fallback"
    print(f"  WAV round trip ({codec}): {a.shape} at {sr} Hz", flush=True)
    if sr2 != 48000:
        chk.failures.append("wav sample rate")
    chk.check("wav -> gate -> wav", back, np.asarray(run(gate, audio)),
              TOL["wav"])


def phase_sharded(chk, x, x64, n_dev):
    """NorthStarChain.apply_sharded (both halo modes), the sharded Hilbert,
    the sharded STFT round trip and the sharded IIR on a (1, n_dev) mesh,
    each input's shards on n_dev distinct devices."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P
    from scipy import signal as ss
    from vv_dsp_tpu import parallel
    from vv_dsp_tpu.models import NorthStarChain
    from vv_dsp_tpu.ops import iir
    mesh = parallel.make_mesh(1, n_dev, devices=jax.devices()[:n_dev])
    xs = jax.device_put(x, NamedSharding(mesh, P("channel", "block")))
    devs = {s.device for s in xs.addressable_shards}
    print(f"  input shards on {len(devs)} devices: "
          f"{sorted(d.id for d in devs)}", flush=True)
    if len(devs) != n_dev:
        chk.failures.append("input sharding")
    chain = NorthStarChain()
    dense = np.asarray(run(chain, jax.device_put(x, jax.devices()[0])))
    for fuse in (True, False):
        out, c_s, s_s = timed(
            lambda v, f=fuse: chain.apply_sharded(v, mesh, fuse_halos=f), xs)
        nf = min(out.shape[-2], dense.shape[-2])
        print(f"  apply_sharded fuse_halos={fuse}: compile {c_s:.2f} s, "
              f"steady {s_s * 1e3:.3f} ms", flush=True)
        chk.check(f"apply_sharded(fuse_halos={fuse}) vs one-card chain",
                  np.asarray(out)[..., :nf, :], dense[..., :nf, :],
                  TOL["sharded"])
    z = run(lambda v: parallel.hilbert_analytic_sharded(v, mesh), xs)
    chk.check("hilbert_analytic_sharded vs scipy (2 ch)", np.asarray(z)[:2],
              ss.hilbert(x64[:2], axis=-1), TOL["hilbert"])
    nfft, hop = 2048, 512
    y = run(lambda v: parallel.stft_reconstruct_sharded(
        parallel.stft_process_sharded(v, nfft, hop, mesh), nfft, hop, mesh),
        xs)
    n = x.shape[-1]
    chk.check("stft_process_sharded -> stft_reconstruct_sharded",
              np.asarray(y)[:, nfft:n - nfft], x64[:, nfft:n - nfft],
              TOL["istft"])
    sos = iir.butter_sos(4, 0.2)
    out = run(lambda v: parallel.iir_apply_sharded(sos, v, mesh), xs)
    chk.check("iir_apply_sharded vs sosfilt (2 ch)", np.asarray(out)[:2],
              ss.sosfilt(sos, x64[:2], axis=-1), TOL["iir"])


def card_lines() -> list[str]:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return [ln.strip() for ln in out.stdout.splitlines() if ln.strip()]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--devices", type=int, default=1, choices=(1, 4),
                    help="4: run only the sharded phase on four cards")
    args = ap.parse_args(argv)

    import jax
    from vv_dsp_tpu.utils.compile_cache import enable_compile_cache

    cache = enable_compile_cache()
    devices = jax.devices()
    backend = jax.default_backend()
    print(f"jax {jax.__version__}, backend {backend}, devices {devices}")
    print(f"device_kind: {devices[0].device_kind}")
    print(f"compile cache: {cache}", flush=True)
    if backend != "gpu":
        print(f"chip_smoke: no GPU (backend {backend!r}); nothing run",
              file=sys.stderr)
        return 1
    if len(devices) < args.devices:
        print(f"chip_smoke: --devices {args.devices} needs that many "
              f"devices, found {len(devices)}", file=sys.stderr)
        return 1
    cards = card_lines()
    for line in cards:
        print(f"card: {line}")

    rng = np.random.default_rng(SEED)
    x64 = rng.standard_normal((CHANNELS, N))
    x = jax.device_put(x64.astype(np.float32), devices[0])
    chk = Checker()
    t_start = time.perf_counter()
    if args.devices > 1:
        phases = [("sharded", lambda: phase_sharded(chk, x, x64,
                                                    args.devices))]
    else:
        x16_64 = rng.standard_normal((CHANNELS, N_16K))
        x16 = jax.device_put(x16_64.astype(np.float32), devices[0])
        phases = [
            ("NorthStarChain", lambda: phase_chain(chk, x, x64)),
            ("pipelines", lambda: phase_pipelines(chk, x, x64, x16, x16_64)),
            ("suite rows", lambda: phase_suite(chk, x, x64)),
            ("streaming", lambda: phase_streaming(chk, x)),
            ("wav", lambda: phase_wav(chk, x)),
        ]
    for name, fn in phases:
        t0 = time.perf_counter()
        print(f"phase {name}", flush=True)
        fn()
        print(f"  phase {name}: {time.perf_counter() - t0:.1f} s", flush=True)
    print(f"all phases: {time.perf_counter() - t_start:.1f} s")
    if chk.failures:
        print(f"chip_smoke: FAILED: {chk.failures}", file=sys.stderr)
        return 1
    for line in cards:
        print(f"card: {line}")
    print(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform, "kind": devices[0].device_kind,
        "count": args.devices if args.devices > 1 else len(devices)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
