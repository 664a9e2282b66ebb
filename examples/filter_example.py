"""FIR design + filtering (counterpart of the reference's
examples/filter_example.c): design a 33-tap Hamming windowed-sinc lowpass and
filter a square wave, streaming and whole-signal."""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))  # repo root

import numpy as np
import jax
import jax.numpy as jnp

from vv_dsp_tpu.ops import fir
from vv_dsp_tpu import streaming


def main():
    taps, n = 33, 128
    h = fir.design_lowpass(taps, 0.2, "hamming")
    x = jnp.asarray(np.where(np.arange(n) % 10 < 5, 1.0, -1.0),
                    dtype=jnp.float32)

    y = fir.fir_apply(h, x)
    print("y[0..4]:", np.asarray(y[:5]))

    # Same result block-by-block with carried history (the reference's
    # vv_dsp_fir_state contract).
    state = streaming.fir_stream_init(h)
    outs = []
    for i in range(0, n, 32):
        blk, state = streaming.fir_stream_process(h, state, x[i : i + 32])
        outs.append(blk)
    y2 = jnp.concatenate(outs)
    print("streaming max |diff|:", float(jnp.max(jnp.abs(y - y2))))

    # Zero-phase variant and an IIR Butterworth for comparison.
    from vv_dsp_tpu.ops import iir

    yzp = fir.filtfilt_fir(h, x)
    sos = iir.butter_sos(4, 0.2)
    yb = iir.iir_apply(sos, x)
    print("filtfilt rms:", float(jnp.sqrt(jnp.mean(yzp**2))),
          "butter rms:", float(jnp.sqrt(jnp.mean(yb**2))))


if __name__ == "__main__":
    main()
