"""The STFT family on the plain XLA path across the benchmark geometries,
against the float64 NumPy references in vv_dsp_tpu.utils.oracle:
nfft in {256..4096} x hop in {nfft/4, nfft/2} for process (c2c and r2c),
power, reconstruct, mel energies and MFCC, and SpectralGate across
nfft x threshold."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from vv_dsp_tpu.models import SpectralGate
from vv_dsp_tpu.ops import mel
from vv_dsp_tpu.ops.stft import STFT
from vv_dsp_tpu.utils import oracle

GRID = [(nfft, nfft // q) for nfft in (256, 512, 1024, 2048, 4096)
        for q in (4, 2)]
IDS = [f"{n}-{h}" for n, h in GRID]
TOL = 5e-5  # FFT-class parity (python/test_fft.py)


def _signal(nfft, seed=0):
    # 6 frames' worth plus a ragged tail, so the zero-padded tail frame runs
    return np.random.default_rng(seed).standard_normal((2, 6 * nfft + 37))


@pytest.mark.parametrize("rfft", [False, True], ids=["c2c", "r2c"])
@pytest.mark.parametrize("nfft,hop", GRID, ids=IDS)
def test_process(nfft, hop, rfft):
    x = _signal(nfft)
    plan = STFT(nfft, hop)
    got = np.asarray(jax.jit(lambda v: plan.process(v, rfft=rfft))(
        jnp.asarray(x, jnp.float32)))
    assert oracle.rel_err(got, oracle.stft(x, nfft, hop, rfft=rfft)) < TOL


@pytest.mark.parametrize("nfft,hop", GRID, ids=IDS)
def test_power(nfft, hop):
    x = _signal(nfft, 1)
    got = np.asarray(jax.jit(STFT(nfft, hop).power)(jnp.asarray(
        x, jnp.float32)))
    assert oracle.rel_err(got, oracle.stft_power(x, nfft, hop)) < TOL


@pytest.mark.parametrize("nfft,hop", GRID, ids=IDS)
def test_reconstruct(nfft, hop):
    """Inverse of a float64 spectrum: w^2-normalized OLA vs the NumPy
    overlap-add. The first and last nfft samples divide by a window norm
    near zero (ill-conditioned in any precision), so they are compared
    only for shape; the interior to FFT-class parity."""
    x = _signal(nfft, 2)
    n = x.shape[-1]
    spec = oracle.stft(x, nfft, hop, rfft=True)
    got = np.asarray(jax.jit(
        lambda s: STFT(nfft, hop).reconstruct(s, n, rfft=True))(
            jnp.asarray(spec, jnp.complex64)))
    want = oracle.istft(spec, nfft, hop, n, rfft=True)
    assert got.shape == want.shape
    assert oracle.rel_err(got[:, nfft:n - nfft],
                          want[:, nfft:n - nfft]) < TOL
    # the interior is the input signal itself (COLA roundtrip)
    assert oracle.rel_err(want[:, nfft:n - nfft], x[:, nfft:n - nfft]) < 1e-12


@pytest.mark.parametrize("nfft,hop", GRID, ids=IDS)
def test_mel_energies_stft(nfft, hop):
    x = _signal(nfft, 3)
    got = np.asarray(jax.jit(lambda v: mel.mel_energies_stft(
        v, nfft, hop, 40, 16000.0))(jnp.asarray(x, jnp.float32)))
    assert oracle.rel_err(got, oracle.mel_energies(x, nfft, hop, 40,
                                                   16000.0)) < TOL


@pytest.mark.parametrize("nfft,hop", GRID, ids=IDS)
def test_mfcc_stft(nfft, hop):
    x = _signal(nfft, 4)
    got = np.asarray(jax.jit(lambda v: mel.mfcc_stft(
        v, nfft, hop, 40, 13, 16000.0, lifter=22.0))(
            jnp.asarray(x, jnp.float32)))
    want = oracle.mfcc(x, nfft, hop, 40, 13, 16000.0, lifter=22.0)
    assert oracle.rel_err(got, want) < TOL


@pytest.mark.parametrize("threshold", [0.05, 0.1, 0.3])
@pytest.mark.parametrize("nfft", [256, 512, 1024, 2048])
def test_spectral_gate_vs_numpy_gate(nfft, threshold):
    x = np.random.default_rng(5).standard_normal((2, 8 * nfft + 11))
    gate = SpectralGate(nfft=nfft, hop=nfft // 4, threshold=threshold)
    got = np.asarray(jax.jit(gate)(jnp.asarray(x, jnp.float32)))
    assert oracle.rel_err(got, oracle.spectral_gate(x, gate)) < TOL
