"""Multi-chip scaling layer — mesh setup, halo exchange, sharded DSP ops.

The reference (crlotwhite/vv-dsp) has ZERO parallelism: its only cross-block
state machinery is the FIR history ring buffer (src/filter/fir.c:170-193), the
IIR DF2T recurrence (src/filter/iir.c:21-27) and STFT overlap-add norm
accumulation (src/spectral/stft.c:103-109). This package is therefore new
design, not a port: those *halo semantics* become `jax.lax.ppermute`
exchanges between time-block shards on a `jax.sharding.Mesh`, and the IIR
recurrence becomes a blockwise associative scan whose per-shard affine maps
compose across the mesh.

Mesh convention: 2-D mesh ``("channel", "block")`` —
  - ``channel``: embarrassingly parallel data axis (channels/batch),
  - ``block``: the time axis split into contiguous blocks; neighbor
    exchanges ride ppermute between neighbouring shards.
"""

from vv_dsp_tpu.parallel.mesh import make_mesh, initialize_distributed
from vv_dsp_tpu.parallel.halo import halo_from_left, halo_from_right
from vv_dsp_tpu.parallel.ops import (
    fir_apply_sharded,
    iir_apply_sharded,
    stft_process_sharded,
    stft_reconstruct_sharded,
    resample_poly_sharded,
    savgol_filter_sharded,
    filtfilt_fir_sharded,
    shard_channels,
)
from vv_dsp_tpu.parallel.fft import (
    fft_sharded,
    ifft_sharded,
    hilbert_analytic_sharded,
    cepstrum_real_sharded,
)
