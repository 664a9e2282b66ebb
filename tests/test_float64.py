"""Double-precision verification path — the VV_DSP_USE_DOUBLE analog
(vv_dsp_types.h): every op takes its compute dtype from the input, so f64
arrays under jax x64 run the whole stack in float64 (on the host CPU;
this is the verification build, like the reference's double cmake
option).

x64 must be enabled before jax initializes arrays, so these tests run in a
subprocess rather than flipping global state under the shared CPU fixture.
"""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_SCRIPT = """
import jax
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
import numpy as np, jax.numpy as jnp
from vv_dsp_tpu.models import NorthStarChain, SpectralGate
from vv_dsp_tpu.ops import fft, fir, iir, resample

rng = np.random.default_rng(0)
x = jnp.asarray(rng.standard_normal((2, 20000)))
assert x.dtype == jnp.float64

out = NorthStarChain()(x)
assert out.dtype == jnp.float64, out.dtype
assert fft.rfft(x, 1024).dtype == jnp.complex128
assert SpectralGate()(x).dtype == jnp.float64
assert iir.iir_apply(iir.butter_sos(4, 0.3), x).dtype == jnp.float64
assert resample.resample_poly(x, 4, 3).dtype == jnp.float64

# f64 accuracy: direct FIR vs numpy convolve at double rounding level
h = fir.design_lowpass_np(101, 0.4)
got = np.asarray(fir.fir_apply(h, x))
want = np.stack([np.convolve(np.asarray(x)[i], h)[:20000] for i in range(2)])
assert np.abs(got - want).max() < 1e-12
print("F64_OK")
"""


def test_float64_end_to_end():
    r = subprocess.run([sys.executable, "-c", _SCRIPT], capture_output=True,
                       text=True, timeout=600, cwd=REPO)
    assert r.returncode == 0, r.stderr[-2000:]
    assert "F64_OK" in r.stdout
