import numpy as np
import jax.numpy as jnp
import pytest

from vv_dsp_tpu.ops import fft as vfft

RTOL = 5e-5  # python/test_fft.py:37-38 parity contract
ATOL = 5e-5


def test_fft_parity(rng):
    for n in (8, 64, 100, 1024):  # incl. non-pow2
        x = (rng.standard_normal(n) + 1j * rng.standard_normal(n)).astype(np.complex64)
        np.testing.assert_allclose(
            vfft.fft(jnp.asarray(x)), np.fft.fft(x), rtol=RTOL, atol=ATOL * np.abs(
                np.fft.fft(x)).max()
        )


def test_ifft_scaling(rng):
    x = (rng.standard_normal(128) + 1j * rng.standard_normal(128)).astype(np.complex64)
    y = vfft.ifft(vfft.fft(jnp.asarray(x)))
    np.testing.assert_allclose(y, x, rtol=RTOL, atol=ATOL)


def test_rfft_irfft_roundtrip(rng):
    for n in (16, 64, 63, 1024):
        x = rng.standard_normal(n).astype(np.float32)
        spec = vfft.rfft(jnp.asarray(x))
        assert spec.shape[-1] == n // 2 + 1
        y = vfft.irfft(spec, n)
        np.testing.assert_allclose(y, x, rtol=RTOL, atol=ATOL)


def test_impulse_flat_spectrum():
    # tests/spectral_tests.c:22-31
    x = np.zeros(64, dtype=np.float32)
    x[0] = 1.0
    spec = np.asarray(vfft.fft(jnp.asarray(x).astype(jnp.complex64)))
    np.testing.assert_allclose(spec, np.ones(64, dtype=np.complex64), atol=1e-5)


def test_hermitian_expand(rng):
    for n in (16, 17):
        x = rng.standard_normal(n).astype(np.float32)
        full = np.asarray(vfft.hermitian_expand(vfft.rfft(jnp.asarray(x)), n))
        np.testing.assert_allclose(full, np.fft.fft(x), rtol=1e-4, atol=1e-4)


def test_fftshift_roundtrip(rng):
    for n in (8, 9):
        x = rng.standard_normal(n).astype(np.float32)
        y = vfft.ifftshift(vfft.fftshift(jnp.asarray(x)))
        np.testing.assert_allclose(y, x)
        np.testing.assert_allclose(vfft.fftshift(jnp.asarray(x)), np.fft.fftshift(x))


def test_phase_wrap():
    x = jnp.asarray([0.0, np.pi, -np.pi, 3 * np.pi, -2.5 * np.pi, 7.0])
    w = np.asarray(vfft.phase_wrap(x))
    assert np.all(w <= np.pi + 1e-6) and np.all(w > -np.pi - 1e-6)
    np.testing.assert_allclose(w[0], 0.0, atol=1e-6)
    np.testing.assert_allclose(w[1], np.pi, atol=1e-6)
    np.testing.assert_allclose(w[3], np.pi, atol=1e-5)
    np.testing.assert_allclose(w[5], 7.0 - 2 * np.pi, atol=1e-5)


def test_phase_unwrap(rng):
    phase = np.cumsum(rng.uniform(0.0, 0.8, 200)).astype(np.float32)
    wrapped = np.angle(np.exp(1j * phase)).astype(np.float32)
    un = np.asarray(vfft.phase_unwrap(jnp.asarray(wrapped)))
    np.testing.assert_allclose(un, phase, atol=1e-3)


# ---------------------------------------------------------------------------
# four-step factorized tier (the large-N matmul path)
# ---------------------------------------------------------------------------

@pytest.fixture
def matmul_backend():
    """Force the matmul tiers (set_fft_backend("matmul"))."""
    vfft.set_fft_backend("matmul")
    yield
    vfft.set_fft_backend("auto")


def test_four_step_factors():
    assert vfft._four_step_factors(8192) == (64, 128)
    assert vfft._four_step_factors(1 << 20) == (1024, 1024)
    assert vfft._four_step_factors(10000) == (100, 100)
    assert vfft._four_step_factors(65537) is None  # prime
    # tier dispatch: above the dense cap, factorable sizes go four-step
    vfft.set_fft_backend("matmul")
    try:
        assert vfft._fft_tier(8192, "r2c") == "four_step"
        assert vfft._fft_tier(2048, "r2c") == "dense"
        assert vfft._fft_tier(4096, "r2c") == "four_step"
        assert vfft._fft_tier(4096, "c2c") == "four_step"
        # prime 65537 <= the Bluestein cap: chirp-Z on the pow2 tiers
        assert vfft._fft_tier(65537, "c2c") == "bluestein"
        assert vfft._fft_tier((1 << 20) + 7, "c2c") == "xla"
        # prime r2c in (2048, 4096]: no factorization, dense form
        assert vfft._fft_tier(4093, "r2c") == "dense"
        assert vfft._fft_tier(1 << 25, "c2c") == "xla"
    finally:
        vfft.set_fft_backend("auto")


@pytest.mark.parametrize("n", [8192, 12288, 10000, 65536, 1 << 20])
def test_four_step_c2c_parity(rng, matmul_backend, n):
    """fft_kiss.c:27-74 capability (any composite size) at matmul accuracy:
    parity vs np.fft within the py-fft 5e-5 contract."""
    x = (rng.standard_normal(n) + 1j * rng.standard_normal(n)).astype(
        np.complex64)
    want = np.fft.fft(x)
    got = np.asarray(vfft.fft(jnp.asarray(x)))
    np.testing.assert_allclose(got, want, atol=ATOL * np.abs(want).max())
    back = np.asarray(vfft.ifft(jnp.asarray(got.astype(np.complex64))))
    np.testing.assert_allclose(back, x, atol=5e-4)


@pytest.mark.parametrize("n", [8192, 12288, 10000, 65536, 1 << 20])
def test_four_step_r2c_c2r_parity(rng, matmul_backend, n):
    x = rng.standard_normal(n).astype(np.float32)
    want = np.fft.rfft(x)
    got = np.asarray(vfft.rfft(jnp.asarray(x)))
    assert got.shape[-1] == n // 2 + 1
    np.testing.assert_allclose(got, want, atol=ATOL * np.abs(want).max())
    back = np.asarray(vfft.irfft(jnp.asarray(got.astype(np.complex64)), n))
    np.testing.assert_allclose(back, x, atol=5e-4)


def test_four_step_power_matches_rfft(rng, matmul_backend):
    n = 8192
    x = rng.standard_normal((3, n)).astype(np.float32)
    want = np.abs(np.fft.rfft(x)) ** 2
    got = np.asarray(vfft.rfft_power(jnp.asarray(x)))
    np.testing.assert_allclose(got, want, atol=1e-4 * want.max())


def test_four_step_batched_matches_single(rng, matmul_backend):
    n = 8192
    x = (rng.standard_normal((4, n)) + 1j * rng.standard_normal((4, n))
         ).astype(np.complex64)
    batched = np.asarray(vfft.fft(jnp.asarray(x)))
    for i in range(4):
        single = np.asarray(vfft.fft(jnp.asarray(x[i])))
        np.testing.assert_array_equal(batched[i], single)


@pytest.mark.parametrize("n", [4099, 5003, 8191, 9973])
def test_bluestein_prime_sizes(rng, matmul_backend, n):
    """Prime/unfactorable n > the dense cap runs the chirp-Z (Bluestein)
    tier — every-N coverage at fast-tier speed (the reference falls back to
    a naive O(N^2) DFT, src/spectral/fft_kiss.c:76-92). Parity within the
    py-fft 5e-5 contract for c2c/ifft/r2c/c2r."""
    # exercise the bluestein path DIRECTLY (the matmul test backend keeps
    # n <= 8192 dense, so dispatch-level coverage lives at n=9973 +
    # test_four_step_factors' tier assertions)
    x = (rng.standard_normal((2, n)) + 1j * rng.standard_normal((2, n))
         ).astype(np.complex64)
    want = np.fft.fft(x.astype(np.complex128))
    got = np.asarray(vfft._bluestein_fft(jnp.asarray(x), n, inverse=False))
    assert np.abs(got - want).max() / np.abs(want).max() < 5e-5
    wi = np.fft.ifft(x.astype(np.complex128))
    gi = np.asarray(vfft._bluestein_fft(jnp.asarray(x), n, inverse=True))
    assert np.abs(gi - wi).max() / max(1e-9, np.abs(wi).max()) < 5e-5
    if vfft._fft_tier(n, "c2c") == "bluestein":  # dispatch-level r2c/c2r
        xr = rng.standard_normal((2, n)).astype(np.float32)
        wr = np.fft.rfft(xr.astype(np.float64))
        gr = np.asarray(vfft.rfft(jnp.asarray(xr)))
        assert np.abs(gr - wr).max() / np.abs(wr).max() < 5e-5
        gir = np.asarray(vfft.irfft(jnp.asarray(wr.astype(np.complex64)),
                                    n))
        assert np.abs(gir - xr).max() < 5e-5 * max(1.0, np.abs(xr).max())
