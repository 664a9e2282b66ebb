"""Complex helpers: reference-parity math (src/core/core.c:10-44 — vv_dsp_cpx
make/add/sub/mul/conj/abs/phase/from_polar) plus host<->device transfer
helpers for complex data.

jnp complex64 arrays replace the reference's {re, im} struct, with the
hypot/atan2 edge-case semantics the reference guarantees.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp


def cpx(re, im):
    """vv_dsp_cpx_make (src/core/core.c:10-13)."""
    re = jnp.asarray(re)
    im = jnp.asarray(im)
    if not jnp.issubdtype(re.dtype, jnp.floating):
        re = re.astype(jnp.float32)
        im = im.astype(jnp.float32)
    return jax.lax.complex(re, im.astype(re.dtype))


def cpx_add(a, b):
    return a + b


def cpx_sub(a, b):
    return a - b


def cpx_mul(a, b):
    """vv_dsp_cpx_mul (src/core/core.c:19-23)."""
    return a * b


def cpx_conj(a):
    return jnp.conj(a)


def cpx_abs(a):
    """|a| via hypot (overflow-safe like the reference's hypotf,
    src/core/core.c:28-30)."""
    return jnp.hypot(jnp.real(a), jnp.imag(a))


def cpx_phase(a):
    """atan2(im, re) (src/core/core.c:32-34)."""
    return jnp.arctan2(jnp.imag(a), jnp.real(a))


def cpx_from_polar(mag, phase):
    """vv_dsp_cpx_from_polar (src/core/core.c:36-40)."""
    mag = jnp.asarray(mag)
    return cpx(mag * jnp.cos(phase), mag * jnp.sin(phase))


# ---------------------------------------------------------------------------
# host <-> device transfer (no reference counterpart: single-process C has
# no device boundary)
# ---------------------------------------------------------------------------

def cpx_to_device(x, device=None):
    """Move a host array (complex or real) to the device."""
    return jax.device_put(np.asarray(x), device)


def cpx_from_device(x) -> np.ndarray:
    """Pull a device array (complex or real) to host numpy."""
    return np.asarray(x)
