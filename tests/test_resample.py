import numpy as np
import jax.numpy as jnp
import pytest
import scipy.signal as sig

from vv_dsp_tpu.ops import resample as vrs


def _ref_linear(x, l, m):
    # numpy mirror of src/resample/resampler.c:77-86
    n = len(x)
    out_n = (n - 1) * l // m + 1
    out = np.zeros(out_n)
    for k in range(out_n):
        pos = k * m / l
        pos = min(max(pos, 0.0), n - 1)
        i0 = int(np.floor(pos))
        i1 = min(i0 + 1, n - 1)
        frac = pos - i0
        out[k] = x[i0] * (1 - frac) + x[i1] * frac
    return out


def _ref_sinc(x, l, m, taps):
    # numpy mirror of src/resample/resampler.c:88-119
    n = len(x)
    ratio = l / m
    out_n = int(np.floor((n - 1) * ratio)) + 1
    if taps % 2:
        taps += 1
    half = taps // 2
    cutoff = min(1.0, ratio)
    out = np.zeros(out_n)
    for k in range(out_n):
        pos = k / ratio
        center = int(np.floor(pos))
        acc = wsum = 0.0
        for mm in range(-half, taps - half):
            idx = center + mm
            t = idx - pos
            s = np.sinc(t * cutoff)
            mi = mm + half
            w = 0.5 - 0.5 * np.cos(2 * np.pi * mi / (taps - 1)) if taps > 1 else 1.0
            weight = s * w
            idx = min(max(idx, 0), n - 1)
            acc += x[idx] * weight
            wsum += weight
        out[k] = acc / wsum if wsum != 0 else acc
    return out


@pytest.mark.parametrize("l,m", [(2, 1), (1, 2), (4, 3), (3, 2), (160, 147)])
def test_linear_reference_parity(rng, l, m):
    x = rng.standard_normal(200).astype(np.float32)
    got = np.asarray(vrs.resample_linear(jnp.asarray(x), l, m))
    ref = _ref_linear(x.astype(np.float64), l, m)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("l,m,taps", [(2, 1, 16), (4, 3, 32), (1, 2, 16)])
def test_sinc_reference_parity(rng, l, m, taps):
    x = rng.standard_normal(120).astype(np.float32)
    got = np.asarray(vrs.resample_sinc(jnp.asarray(x), l, m, taps))
    ref = _ref_sinc(x.astype(np.float64), l, m, taps)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=1e-3, atol=1e-3)


def test_tone_roundtrip():
    # tests/resample_tests.c:26-80: up2x -> down2x on a 1 kHz tone, 32-tap sinc
    fs = 8000.0
    n = 800
    t = np.arange(n) / fs
    x = np.sin(2 * np.pi * 1000.0 * t).astype(np.float32)
    up = vrs.resample_sinc(jnp.asarray(x), 2, 1, 32)
    down = np.asarray(vrs.resample_sinc(up, 1, 2, 32))
    m = min(len(down), n)
    err = np.abs(down[32 : m - 32] - x[32 : m - 32]).mean()
    assert err < 0.1, err


@pytest.mark.parametrize("up,down", [(2, 1), (1, 2), (4, 3), (3, 4), (160, 147)])
def test_resample_poly_scipy_parity(rng, up, down):
    x = rng.standard_normal(500).astype(np.float32)
    got = np.asarray(vrs.resample_poly(jnp.asarray(x), up, down))
    ref = sig.resample_poly(x.astype(np.float64), up, down)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=5e-3, atol=5e-4)


def test_upfirdn_scipy_parity(rng):
    x = rng.standard_normal(100).astype(np.float32)
    h = sig.firwin(21, 0.4)
    for up, down in [(1, 1), (3, 2), (2, 3)]:
        got = np.asarray(vrs.upfirdn(h, jnp.asarray(x), up, down))
        ref = sig.upfirdn(h, x.astype(np.float64), up, down)
        assert got.shape == ref.shape, (up, down)
        np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)


def test_interpolate_primitives(rng):
    x = rng.standard_normal(50).astype(np.float32)
    pos = jnp.asarray([0.0, 3.25, 48.9, 60.0])  # incl. clamped
    lin = np.asarray(vrs.interpolate_linear(jnp.asarray(x), pos))
    assert lin[0] == pytest.approx(x[0], abs=1e-6)
    assert lin[3] == pytest.approx(x[-1], abs=1e-6)
    assert lin[1] == pytest.approx(0.75 * x[3] + 0.25 * x[4], abs=1e-5)
    cr = np.asarray(vrs.interpolate_catmull_rom(jnp.asarray(x), pos))
    assert cr.shape == (4,)
    assert cr[0] == pytest.approx(x[0], abs=1e-6)


def test_batched(rng):
    x = rng.standard_normal((3, 100)).astype(np.float32)
    y = np.asarray(vrs.resample_poly(jnp.asarray(x), 4, 3))
    for i in range(3):
        ref = sig.resample_poly(x[i].astype(np.float64), 4, 3)
        np.testing.assert_allclose(y[i], ref, rtol=5e-3, atol=5e-4)


def test_multistage_factorization():
    from vv_dsp_tpu.ops.resample import _factor_stages
    for up, down in ((160, 147), (441, 480), (320, 441), (2, 1), (7, 5)):
        stages = _factor_stages(up, down)
        u = d = 1
        for su, sd in stages:
            assert su <= 9 and sd <= 9
            u *= su
            d *= sd
        assert (u, d) == (up, down)


def test_multistage_vs_single_stage(rng):
    import math
    from vv_dsp_tpu.ops import resample
    t = np.arange(44100) / 44100.0
    x = jnp.asarray(np.sin(2 * np.pi * 997.0 * t)[None, :], dtype=jnp.float32)
    y = resample.resample_multistage(x, 160, 147)
    assert y.shape[-1] == -(-x.shape[-1] * 160 // 147)
    want = np.sin(2 * np.pi * 997.0 * np.arange(y.shape[-1]) / 48000.0)
    np.testing.assert_allclose(np.asarray(y[0, 1000:-1000]),
                               want[1000:-1000], atol=5e-3)


def test_multistage_large_prime(rng):
    """Ratios with primes > 9 (e.g. 11) route that factor through a plain
    polyphase stage instead of raising."""
    from vv_dsp_tpu.ops.resample import _factor_stages, resample_multistage
    stages = _factor_stages(10, 11)
    u = d = 1
    for su, sd in stages:
        u *= su; d *= sd
    assert (u, d) == (10, 11)
    x = jnp.asarray(rng.standard_normal((2, 2200)), dtype=jnp.float32)
    y = resample_multistage(x, 10, 11)
    assert y.shape[-1] == -(-2200 * 10 // 11)


# ---------------------------------------------------------------------------
# MXU strided-conv upfirdn (resample_poly_mxu)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("up,down", [(4, 3), (2, 1), (1, 2), (160, 147),
                                     (147, 160), (3, 7), (7, 3)])
def test_resample_poly_mxu_scipy_parity(rng, up, down):
    """The strided-conv form must be sample-exact vs scipy.resample_poly —
    including CD<->48k (160/147) in a SINGLE stage (round-1 needed a
    quality-equivalent multistage cascade there)."""
    x = rng.standard_normal((2, 9999)).astype(np.float32)
    want = sig.resample_poly(x.astype(np.float64), up, down, axis=-1)
    got = np.asarray(vrs.resample_poly_mxu(jnp.asarray(x), up, down))
    assert got.shape == want.shape
    assert np.abs(got - want).max() / max(1.0, np.abs(want).max()) < 5e-5


def test_resample_poly_mxu_matches_gather(rng):
    x = rng.standard_normal((3, 4096)).astype(np.float32)
    for up, down in [(4, 3), (5, 2), (160, 147)]:
        a = np.asarray(vrs.resample_poly_mxu(jnp.asarray(x), up, down))
        b = np.asarray(vrs.resample_poly(jnp.asarray(x), up, down))
        np.testing.assert_allclose(a, b, atol=2e-5)


def test_upfirdn_mxu_scipy_parity(rng):
    h = sig.firwin(31, 0.4)
    for up, down in [(3, 2), (5, 4), (1, 3), (4, 1)]:
        x = rng.standard_normal(1000).astype(np.float32)
        want = sig.upfirdn(h, x.astype(np.float64), up, down)
        got = np.asarray(vrs.upfirdn_mxu(h, jnp.asarray(x), up, down))
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, atol=1e-4)


def test_resample_poly_mxu_batched_3d(rng):
    """The conv path accepts any leading batch shape."""
    x = rng.standard_normal((2, 3, 999)).astype(np.float32)
    got = np.asarray(vrs.resample_poly_mxu(jnp.asarray(x), 4, 3))
    want = sig.resample_poly(x.astype(np.float64), 4, 3, axis=-1)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=5e-5)


@pytest.mark.parametrize("up,down,taps,n", [(4, 3, 1024, 48000),
                                            (2, 1, 64, 1000),
                                            (1, 2, 127, 4097),
                                            (160, 147, 64, 14700),
                                            (3, 4, 33, 999)])
def test_fir_resample_fused_matches_staged(rng, up, down, taps, n):
    """The one-matmul fused head must be sample-identical to
    resample_poly(fir_apply(h, x)) — including the staged FIR's
    end-of-signal truncation semantics."""
    from vv_dsp_tpu.ops import fir as vfir
    x = rng.standard_normal((3, n)).astype(np.float32)
    h = vfir.design_lowpass_np(taps, 0.4).astype(np.float32)
    staged = np.asarray(
        vrs.resample_poly(vfir.fir_apply(h, jnp.asarray(x)), up, down))
    fused = np.asarray(vrs.fir_resample_fused(h, jnp.asarray(x), up, down))
    assert staged.shape == fused.shape
    scale = max(1.0, np.abs(staged).max())
    assert np.abs(staged - fused).max() / scale < 5e-5


def test_fir_resample_fused_identity_rate(rng):
    """up == down reduces to plain FIR filtering."""
    from vv_dsp_tpu.ops import fir as vfir
    x = rng.standard_normal((2, 2048)).astype(np.float32)
    h = vfir.design_lowpass_np(65, 0.3).astype(np.float32)
    fused = np.asarray(vrs.fir_resample_fused(h, jnp.asarray(x), 3, 3))
    want = np.asarray(vfir.fir_apply(h, jnp.asarray(x)))
    np.testing.assert_allclose(fused, want, atol=2e-5)


@pytest.mark.parametrize("up,down,n", [(4, 3, 8), (1, 2, 30), (2, 1, 5),
                                       (3, 4, 40)])
def test_fir_resample_fused_short_signal(rng, up, down, n):
    """Signals shorter than the resample filter's half-length: every output
    window crosses the FIR tail, so m0 clamps to 0 and the whole result is
    the staged computation (regression: m0 < 0 sliced y from the END,
    returning wrong-length garbage)."""
    from vv_dsp_tpu.ops import fir as vfir
    x = rng.standard_normal((2, n)).astype(np.float32)
    h = vfir.design_lowpass_np(9, 0.4).astype(np.float32)
    staged = np.asarray(
        vrs.resample_poly(vfir.fir_apply(h, jnp.asarray(x)), up, down))
    fused = np.asarray(vrs.fir_resample_fused(h, jnp.asarray(x), up, down))
    assert staged.shape == fused.shape
    np.testing.assert_allclose(fused, staged, atol=1e-5)
