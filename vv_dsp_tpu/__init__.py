"""vv-dsp-tpu: a DSP framework built on JAX/XLA.

A from-scratch re-design of the capability surface of the C99 library
``crlotwhite/vv-dsp`` for accelerators (it runs on an NVIDIA H100):

- arrays-in/arrays-out functional API on ``(..., time)`` / ``(..., frames, bins)``
  jnp arrays (all ops batch over leading axes),
- "plans" are precomputed-constant pytrees (windows, twiddles, chirps, filterbanks
  generated host-side in float64 numpy, cast to the compute dtype) plus
  ``jax.jit`` shape specialization,
- hot loops are plain XLA: batched FFTs and matmul-form DCT/mel/polyphase,
- multi-chip scaling via ``jax.sharding.Mesh`` + ``shard_map`` with ``ppermute``
  halo exchange for overlap-save/OLA boundaries (see ``vv_dsp_tpu.parallel``).

Capability parity map (reference file → this package):
  src/window/window.c            → ops/window.py
  src/core/{core,stats}.c        → ops/stats.py
  src/core/framing.c             → ops/framing.py
  src/core/nan_policy.c          → utils/nan_policy.py
  src/spectral/fft*.c, utils.c   → ops/fft.py
  src/spectral/stft.c            → ops/stft.py
  src/spectral/dct.c             → ops/dct.py
  src/spectral/czt.c             → ops/czt.py
  src/spectral/hilbert.c         → ops/hilbert.py
  src/filter/{fir,common}.c      → ops/fir.py
  src/filter/iir.c               → ops/iir.py (+ associative-scan parallelism)
  src/filter/savgol.c            → ops/savgol.py
  src/resample/*.c               → ops/resample.py
  src/envelope/*.c               → ops/envelope.py
  src/features/mel.c             → ops/mel.py
  src/audio/wav.c                → io/wav.py (+ native C decoder in csrc/)
  (no reference counterpart)     → parallel/ (mesh, halo exchange, sharded ops)
"""

from vv_dsp_tpu import config
from vv_dsp_tpu.utils.nan_policy import NanPolicy, apply_nan_policy
from vv_dsp_tpu.ops.window import get_window, WINDOW_NAMES
from vv_dsp_tpu.ops import (
    window,
    complex_ops,
    stats,
    framing,
    fft,
    stft,
    dct,
    czt,
    hilbert,
    fir,
    iir,
    savgol,
    resample,
    envelope,
    mel,
)
from vv_dsp_tpu.ops.fft import (
    fft as fft_c2c,
    ifft,
    rfft,
    irfft,
    fftshift,
    ifftshift,
    phase_wrap,
    phase_unwrap,
)
from vv_dsp_tpu.ops.stft import STFT, stft_spectrogram
from vv_dsp_tpu.ops.framing import num_frames, fetch_frames, overlap_add

# Heavier subsystems import lazily to keep `import vv_dsp_tpu` light:
#   vv_dsp_tpu.parallel   — mesh / halo exchange / sharded ops
#   vv_dsp_tpu.models     — end-to-end pipelines
#   vv_dsp_tpu.streaming  — block streaming with carried state
#   vv_dsp_tpu.io         — WAV codec (native C++ backend)
#   vv_dsp_tpu.utils.{profiling,checkpoint}

__version__ = "0.5.0"


def __getattr__(name):
    if name in ("parallel", "models", "streaming", "io"):
        import importlib

        return importlib.import_module(f"vv_dsp_tpu.{name}")
    raise AttributeError(f"module 'vv_dsp_tpu' has no attribute {name!r}")
