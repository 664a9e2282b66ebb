import numpy as np
import jax.numpy as jnp
import scipy.signal as sig

from vv_dsp_tpu.ops import hilbert as vh


def test_analytic_real_part_is_input(rng):
    # tests/hilbert_tests.c:16-52
    for n in (128, 129):
        x = rng.standard_normal(n).astype(np.float32)
        z = np.asarray(vh.hilbert_analytic(jnp.asarray(x)))
        np.testing.assert_allclose(z.real, x, atol=1e-3)


def test_analytic_scipy_parity(rng):
    for n in (64, 65):
        x = rng.standard_normal(n).astype(np.float32)
        z = np.asarray(vh.hilbert_analytic(jnp.asarray(x)))
        ref = sig.hilbert(x.astype(np.float64))
        np.testing.assert_allclose(z, ref, atol=1e-4)


def test_instantaneous_frequency_sine():
    # bin-centered sine: mean inst freq within 0.5 Hz (hilbert_tests.c:16-52)
    fs = 1000.0
    n = 1000
    f0 = 50.0
    t = np.arange(n) / fs
    x = np.sin(2 * np.pi * f0 * t).astype(np.float32)
    z = vh.hilbert_analytic(jnp.asarray(x))
    phase = vh.instantaneous_phase(z)
    freq = np.asarray(vh.instantaneous_frequency(phase, fs))
    mid = freq[100:-100]
    assert abs(mid.mean() - f0) < 0.5


def test_envelope_of_am_signal():
    fs = 1000.0
    n = 2048
    t = np.arange(n) / fs
    env_true = 1.0 + 0.5 * np.sin(2 * np.pi * 3.0 * t)
    x = (env_true * np.sin(2 * np.pi * 100.0 * t)).astype(np.float32)
    env = np.asarray(vh.envelope(jnp.asarray(x)))
    # ignore edges
    np.testing.assert_allclose(env[200:-200], env_true[200:-200], atol=0.05)


def test_batched(rng):
    x = rng.standard_normal((4, 64)).astype(np.float32)
    z = np.asarray(vh.hilbert_analytic(jnp.asarray(x)))
    for i in range(4):
        np.testing.assert_allclose(z[i], sig.hilbert(x[i].astype(np.float64)),
                                   atol=1e-4)
