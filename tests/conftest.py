"""Test harness: run everything on CPU with 8 virtual devices so the sharded
paths (vv_dsp_tpu.parallel) are exercised without a multi-device host.
jax.config (not env vars) so the setting holds however jax was imported
before conftest (backends initialize lazily, so this still wins). The GPU
path is exercised by chip_smoke.py."""

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_num_cpu_devices", 8)

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def rng():
    return np.random.default_rng(1234)
