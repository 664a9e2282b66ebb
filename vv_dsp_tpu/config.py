"""Global dtype/precision policy.

The reference library (vv-dsp) is float32 by default with float64 internals for
constant generation (e.g. src/core/core.c:44-53, src/spectral/czt.c:84-111 use
double accumulators / double chirp math). We mirror that idiom:

- compute dtype: float32; bfloat16 inputs are promoted at op entry,
- all *constants* (windows, twiddle/chirp tables, filterbanks, filter taps,
  SOS coefficients) are generated host-side in numpy float64 and cast once,
- every dot and conv passes ``precision=MATMUL_PRECISION`` (``HIGHEST`` by
  default, full fp32) so the SciPy-parity contract holds (<= 5e-5 for
  FFT-class ops); nothing sets jax_default_matmul_precision globally.
"""

from __future__ import annotations

import jax.numpy as jnp
from jax import lax

# Default real/complex compute dtypes (reference: vv_dsp_real = float,
# vv_dsp_cpx = {float re, im}; include/vv_dsp/vv_dsp_types.h:70-128).
DEFAULT_REAL_DTYPE = jnp.float32
DEFAULT_COMPLEX_DTYPE = jnp.complex64

# Matmul precision of every dot and conv (FIR, polyphase, DCT, mel
# filterbank, matmul-DFT). Switchable at runtime — the analog of the
# reference's float/double precision build option (VV_DSP_USE_DOUBLE,
# vv_dsp_types.h). On the GPU, per JAX: "highest" runs float32 dots on the
# CUDA cores (the parity contract); "high" and "default" let float32 dots
# run as TF32 on the tensor cores (10-bit mantissa inputs, float32
# accumulation) — faster on compute-bound matmuls, error not measured here.
MATMUL_PRECISION = lax.Precision.HIGHEST

_PRECISIONS = {
    "highest": lax.Precision.HIGHEST,  # fp32 (parity contract)
    "high": lax.Precision.HIGH,        # TF32 tensor cores
    "default": lax.Precision.DEFAULT,  # TF32 tensor cores
}


def set_matmul_precision(name: str) -> None:
    """Runtime accuracy/throughput knob for every matmul-form transform.

    NB: jit caches compiled programs — set this before tracing a function
    (or call fn.clear_cache()) for it to take effect on that function."""
    global MATMUL_PRECISION
    if name not in _PRECISIONS:
        raise ValueError(f"precision must be one of {sorted(_PRECISIONS)}")
    MATMUL_PRECISION = _PRECISIONS[name]


def get_matmul_precision():
    return MATMUL_PRECISION


def clear_all_caches(include_jit: bool = False) -> int:
    """Drop every host-side constant cache in the package — the single
    serving-process memory story (the reference bounds its one plan cache
    to a 64-bucket LRU, src/spectral/fft_fftw.c:52-56; here EVERY cache is
    a bounded functools.lru_cache, but a long-running server mixing many
    geometries can still hold up to the sum of the caps — worst case a few
    hundred MB with many distinct large-n FFT bases).

    Walks every loaded vv_dsp_tpu module and clears each lru_cache (twiddle
    tables, DFT bases, windows, filterbanks, chirps, band matrices, SOS
    constants, OLA norms, ...).  Returns the number of caches cleared.
    include_jit=True additionally drops jax's compiled-executable cache
    (jax.clear_caches()) — compiled programs are the other long-lived
    per-geometry allocation, owned by jax, and re-compile on next use.
    """
    import sys

    cleared = 0
    for name, mod in list(sys.modules.items()):
        if mod is None or not name.startswith("vv_dsp_tpu"):
            continue
        for attr in list(vars(mod).values()):
            if callable(getattr(attr, "cache_clear", None)) and hasattr(
                    attr, "cache_info"):
                attr.cache_clear()
                cleared += 1
    if include_jit:
        import jax
        jax.clear_caches()
    return cleared


import contextlib as _contextlib


@_contextlib.contextmanager
def matmul_precision(name: str):
    """Scoped version of set_matmul_precision: the knob applies to
    everything TRACED inside the block (models use this to pin their
    documented precision independent of the ambient global)."""
    global MATMUL_PRECISION
    prev = MATMUL_PRECISION
    set_matmul_precision(name)
    try:
        yield
    finally:
        MATMUL_PRECISION = prev


def real_dtype(dtype=None):
    """Resolve a real dtype argument (None -> default)."""
    return DEFAULT_REAL_DTYPE if dtype is None else jnp.dtype(dtype)


def as_compute(x):
    """Promote a signal array to its compute dtype at op entry: integers
    (PCM buffers) and sub-single floats (bf16/f16 serving buffers) become
    float32; float32/float64 pass through untouched.

    Every filtering/transform op calls this first — the reference's C API
    is float-only so this is new surface, but the failure mode it prevents
    (filter weights silently cast to int -> all-zero taps) is silent
    garbage, not an error."""
    d = jnp.asarray(x).dtype
    if jnp.issubdtype(d, jnp.floating):
        return x if jnp.finfo(d).bits >= 32 else x.astype(jnp.float32)
    if jnp.issubdtype(d, jnp.complexfloating):
        return x
    return jnp.asarray(x).astype(jnp.float32)


def complex_dtype(dtype=None):
    """Resolve a complex dtype argument (None -> default)."""
    return DEFAULT_COMPLEX_DTYPE if dtype is None else jnp.dtype(dtype)


def complex_for_real(dtype) -> jnp.dtype:
    """Matching complex dtype for a real dtype."""
    d = jnp.dtype(dtype)
    if d == jnp.float64:
        return jnp.dtype(jnp.complex128)
    return jnp.dtype(jnp.complex64)


# ---------------------------------------------------------------------------
# FP environment (reference: vv_dsp_set_flush_denormals, src/core/fp_env.c)
# ---------------------------------------------------------------------------

_flush_denormals = True


def set_flush_denormals(enabled: bool) -> bool:
    """Denormal-flushing intent, the counterpart of the reference's
    per-thread FTZ/DAZ MXCSR/FPCR toggles (src/core/fp_env.c:9-109).

    XLA exposes no runtime bit for this, so the setting is recorded for
    code to query and changes no kernel; returns the recorded state. What
    the GPU does with subnormals on these paths is not measured yet.
    """
    global _flush_denormals
    _flush_denormals = bool(enabled)
    return _flush_denormals


def get_flush_denormals() -> bool:
    return _flush_denormals


def set_debug_nans(enabled: bool) -> None:
    """Trap NaN production device-wide (jax_debug_nans) — the runtime analog
    of the reference's ASan/UBSan debug builds plus its ERROR NaN policy
    (CMakeLists.txt:78-79, src/core/nan_policy.c): any op producing NaN
    raises immediately with the offending jaxpr."""
    import jax

    jax.config.update("jax_debug_nans", bool(enabled))
