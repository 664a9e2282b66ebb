"""The plain XLA paths that replaced the removed kernels, against SciPy:
fir_apply_best across tap counts, resample_poly_best across the suite's
ratios, Savitzky-Golay across window x order x mode; plus the profiling
peak table, the compile-cache placement and a gradient through the chain."""

import os

import numpy as np
import pytest
import jax
import jax.numpy as jnp
from scipy import signal as ss

from vv_dsp_tpu.ops import fir, resample, savgol
from vv_dsp_tpu.utils import compile_cache, oracle, profiling

H100 = "NVIDIA H100 80GB HBM3"


@pytest.mark.parametrize("taps", [4, 16, 33, 64, 65, 128, 255, 512, 1024])
def test_fir_apply_best_vs_lfilter(taps):
    """Both sides of the 64-tap switch (direct conv / overlap-save)."""
    x = np.random.default_rng(taps).standard_normal((2, 6000))
    h = fir.design_lowpass_np(taps, 0.3)
    got = np.asarray(jax.jit(lambda v: fir.fir_apply_best(
        h.astype(np.float32), v))(jnp.asarray(x, jnp.float32)))
    assert oracle.rel_err(got, ss.lfilter(h, [1.0], x, axis=-1)) < 1e-5


@pytest.mark.parametrize("up,down", [(2, 1), (1, 2), (4, 3), (3, 4),
                                     (160, 147), (147, 160), (6, 4)])
def test_resample_poly_best_vs_scipy(up, down):
    x = np.random.default_rng(up * 1000 + down).standard_normal((2, 5880))
    got = np.asarray(jax.jit(lambda v: resample.resample_poly_best(
        v, up, down))(jnp.asarray(x, jnp.float32)))
    assert oracle.rel_err(got, ss.resample_poly(x, up, down, axis=-1)) < 5e-5


def test_resample_poly_best_identity_ratio():
    x = jnp.arange(12.0).reshape(2, 6)
    assert resample.resample_poly_best(x, 3, 3) is x


SCIPY_MODE = {"reflect": "mirror", "nearest": "nearest", "wrap": "wrap",
              "constant": "nearest"}  # reference CONSTANT == NEAREST


@pytest.mark.parametrize("mode", sorted(SCIPY_MODE))
@pytest.mark.parametrize("polyorder", [2, 3])
@pytest.mark.parametrize("window", [5, 31])
def test_savgol_vs_scipy(window, polyorder, mode):
    x = np.random.default_rng(window + polyorder).standard_normal((2, 3000))
    got = np.asarray(jax.jit(lambda v: savgol.savgol_filter(
        v, window, polyorder, mode=mode))(jnp.asarray(x, jnp.float32)))
    want = ss.savgol_filter(x, window, polyorder, mode=SCIPY_MODE[mode],
                            axis=-1)
    assert oracle.rel_err(got, want) < 1e-5


def test_device_peaks_h100_row():
    peaks = profiling.device_peaks(H100)
    assert peaks["fp32"] == 67e12 and peaks["tf32"] == 495e12
    assert peaks["bf16"] == 989e12 and peaks["hbm"] == 3.35e12


def test_device_peaks_unknown_kind_raises():
    with pytest.raises(ValueError, match="no published peaks"):
        profiling.device_peaks("an unlisted card")
    # the test host's CPU device has no row either: no silent default
    with pytest.raises(ValueError):
        profiling.Roofline(1e9, 1e6).attainable_seconds


def test_roofline_h100_fp32_bound():
    r = profiling.Roofline(67e12, 1.0, device_kind=H100)
    assert r.compute_bound
    assert abs(r.attainable_seconds - 1.0) < 1e-12
    assert abs(r.achieved_fraction(2.0) - 0.5) < 1e-12


@pytest.fixture
def cache_config():
    """Restore the jax cache settings the helper may change."""
    names = ("jax_compilation_cache_dir",
             "jax_persistent_cache_min_compile_time_secs")
    saved = {n: getattr(jax.config, n) for n in names}
    yield
    for n, v in saved.items():
        jax.config.update(n, v)


def test_compile_cache_env_set_changes_nothing(monkeypatch, cache_config,
                                               tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    before = jax.config.jax_compilation_cache_dir
    assert compile_cache.enable_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before


def test_compile_cache_default_is_fixed_repo_dir(monkeypatch, cache_config):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    want = os.path.join(repo, ".jax_cache")
    assert compile_cache.enable_compile_cache() == want
    assert jax.config.jax_compilation_cache_dir == want
    assert compile_cache.enable_compile_cache() == want  # same every call


def test_grad_through_plain_chain():
    """d/dx of a scalar loss through the whole chain matches a central
    finite difference along a random direction."""
    from vv_dsp_tpu.models import NorthStarChain
    chain = NorthStarChain(fir_taps=64, nfft=256, hop=64, n_mels=20,
                           n_mfcc=8)
    rng = np.random.default_rng(7)
    x = jnp.asarray(rng.standard_normal((1, 1536)), jnp.float32)
    d = jnp.asarray(rng.standard_normal((1, 1536)), jnp.float32)
    loss = jax.jit(lambda v: jnp.mean(chain(v) ** 2))
    g = jax.jit(jax.grad(lambda v: jnp.mean(chain(v) ** 2)))(x)
    assert g.shape == x.shape and bool(jnp.isfinite(g).all())
    eps = 1e-2
    fd = (float(loss(x + eps * d)) - float(loss(x - eps * d))) / (2 * eps)
    ad = float(jnp.sum(g * d))
    assert abs(fd - ad) <= 2e-2 * abs(ad)


def test_grad_through_chain_wrt_fir_taps():
    """Learned front end: gradient w.r.t. traced FIR taps on the staged
    head is finite and non-zero."""
    from vv_dsp_tpu.ops import mel
    x = jnp.asarray(np.random.default_rng(8).standard_normal((1, 4096)),
                    jnp.float32)
    h0 = jnp.asarray(fir.design_lowpass_np(32, 0.4), jnp.float32)

    def loss(h):
        y = resample.resample_poly_best(fir.fir_apply(h, x), 4, 3)
        return jnp.mean(mel.mfcc_stft(y, 256, 64, 20, 8, 64000.0) ** 2)

    g = jax.jit(jax.grad(loss))(h0)
    assert bool(jnp.isfinite(g).all()) and float(jnp.abs(g).max()) > 0
