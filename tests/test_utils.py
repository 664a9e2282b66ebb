"""Profiling/bench framework, roofline model, checkpoint save/restore, NaN
policy semantics."""

import os

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from vv_dsp_tpu.utils import profiling, checkpoint
from vv_dsp_tpu.utils.nan_policy import NanPolicy, apply_nan_policy
from vv_dsp_tpu import streaming
from vv_dsp_tpu.ops import fir, iir


def test_benchmark_record_shape():
    fn = jax.jit(lambda v: v * 2.0)
    x = jnp.ones((4, 48000))
    r = profiling.benchmark("double", fn, x, iters=3, warmup=1)
    assert r.name == "double" and r.iterations == 3
    assert r.elapsed_ms > 0 and r.samples_per_sec > 0 and r.rtf > 0
    import json
    rec = json.loads(r.to_json())
    assert set(rec) == {"name", "elapsed_ms", "samples_per_sec", "rtf",
                        "iterations"}


def test_roofline_model():
    kind = "NVIDIA H100 80GB HBM3"
    r = profiling.fir_roofline(16, 480000, 64, device_kind=kind)
    assert r.attainable_seconds > 0
    # 64-tap FIR at the fp32 peak: ~1 GFLOP vs ~61 MB -> bandwidth-bound
    assert not r.compute_bound
    big = profiling.fir_roofline(16, 480000, 4096, device_kind=kind)
    assert big.compute_bound
    assert 0 < r.achieved_fraction(r.attainable_seconds * 2) <= 0.5 + 1e-9


def test_checkpoint_roundtrip_streaming_state(tmp_path, rng):
    h = fir.design_lowpass(33, 0.3)
    sos = iir.butter_sos(4, 0.2)
    state = {
        "fir": streaming.fir_stream_init(h, (2,)),
        "iir": streaming.iir_stream_init(sos, (2,)),
        "counter": jnp.asarray(1234),
    }
    # advance the states so they are nonzero
    x = jnp.asarray(rng.standard_normal((2, 256)), dtype=jnp.float32)
    _, state["fir"] = streaming.fir_stream_process(h, state["fir"], x)
    _, state["iir"] = streaming.iir_stream_process(sos, state["iir"], x)

    p = str(tmp_path / "state.ckpt")
    checkpoint.save(p, state)
    like = {
        "fir": streaming.fir_stream_init(h, (2,)),
        "iir": streaming.iir_stream_init(sos, (2,)),
        "counter": jnp.asarray(0),
    }
    back = checkpoint.load(p, like)
    assert int(back["counter"]) == 1234
    np.testing.assert_array_equal(back["fir"], state["fir"])
    np.testing.assert_array_equal(back["iir"], state["iir"])
    # resuming from the checkpoint continues the stream identically
    y1, _ = streaming.fir_stream_process(h, state["fir"], x)
    y2, _ = streaming.fir_stream_process(h, back["fir"], x)
    np.testing.assert_array_equal(y1, y2)


def test_nan_policy_semantics():
    x = jnp.asarray([1.0, jnp.nan, jnp.inf, -jnp.inf, 2.0])
    np.testing.assert_array_equal(
        np.isnan(np.asarray(apply_nan_policy(x, NanPolicy.PROPAGATE))),
        [False, True, False, False, False])
    ig = np.asarray(apply_nan_policy(x, NanPolicy.IGNORE))
    np.testing.assert_array_equal(ig, [1.0, 0.0, 0.0, 0.0, 2.0])
    cl = np.asarray(apply_nan_policy(x, NanPolicy.CLAMP))
    assert cl[1] == 0.0 and cl[2] > 1e37 and cl[3] < -1e37


def test_matmul_precision_switch(rng):
    from vv_dsp_tpu import config
    from jax import lax
    assert config.get_matmul_precision() == lax.Precision.HIGHEST
    config.set_matmul_precision("default")
    try:
        assert config.get_matmul_precision() == lax.Precision.DEFAULT
        with pytest.raises(ValueError):
            config.set_matmul_precision("double")
    finally:
        config.set_matmul_precision("highest")


def test_checkpoint_rejects_dtype_mismatch(tmp_path):
    p = str(tmp_path / "s.ckpt")
    checkpoint.save(p, {"a": jnp.zeros(4, jnp.float32)})
    with pytest.raises(ValueError, match="dtype"):
        checkpoint.load(p, {"a": jnp.zeros(4, jnp.int32)})


def test_checkpoint_rejects_structure_mismatch(tmp_path):
    p = str(tmp_path / "s.ckpt")
    checkpoint.save(p, {"a": jnp.zeros(4), "b": jnp.ones(3)})
    with pytest.raises(ValueError, match="structure"):
        checkpoint.load(p, {"a": jnp.zeros(4), "c": jnp.ones(3)})


def test_cpx_device_transport_roundtrip(rng):
    from vv_dsp_tpu.ops import complex_ops as C
    x = (rng.standard_normal(64) + 1j * rng.standard_normal(64)).astype(
        np.complex64)
    dev = C.cpx_to_device(x)
    assert jnp.iscomplexobj(dev)
    back = C.cpx_from_device(dev)
    np.testing.assert_allclose(back, x, rtol=1e-6)
    # real arrays pass through both directions
    r = np.arange(8, dtype=np.float32)
    np.testing.assert_array_equal(C.cpx_from_device(C.cpx_to_device(r)), r)
