"""chip_smoke.py off the card: its refusal to run without a GPU (and
without the package), its comparison helper, and every phase at a tiny
size on the CPU mesh, which runs the same references as on the card."""

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import jax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = os.path.join(REPO, "chip_smoke.py")
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402


def _no_result(stdout: str) -> bool:
    last = stdout.strip().splitlines()[-1] if stdout.strip() else ""
    try:
        return "ok" not in json.loads(last)
    except ValueError:
        return True


def test_exits_nonzero_without_gpu():
    out = subprocess.run([sys.executable, SCRIPT], capture_output=True,
                         text=True, timeout=300, cwd=REPO,
                         env={**os.environ, "JAX_PLATFORMS": "cpu",
                              "JAX_COMPILATION_CACHE_DIR": ""})
    assert out.returncode != 0
    assert "no GPU" in out.stderr
    assert _no_result(out.stdout)


def test_exits_nonzero_alone_in_a_directory(tmp_path):
    shutil.copy(SCRIPT, tmp_path / "chip_smoke.py")
    out = subprocess.run([sys.executable, "chip_smoke.py"],
                         capture_output=True, text=True, timeout=300,
                         cwd=tmp_path, env={**os.environ,
                                            "JAX_PLATFORMS": "cpu",
                                            "PYTHONPATH": ""})
    assert out.returncode != 0
    assert _no_result(out.stdout)


def test_checker_passes_and_fails(capsys):
    chk = chip_smoke.Checker()
    want = np.linspace(-1.0, 1.0, 64)
    err = chk.check("close", want + 1e-7, want, 1e-5)
    assert err < 1e-5 and not chk.failures
    chk.check("far", want + 1e-3, want, 1e-5)
    chk.check("nan", np.where(want > 0, np.nan, want), want, 1e-5)
    assert chk.failures == ["far", "nan"]
    assert "tol 1e-05" in capsys.readouterr().out


def test_checker_rejects_shape_mismatch():
    with pytest.raises(ValueError, match="shape"):
        chip_smoke.Checker().check("s", np.zeros(3), np.ones(4), 1.0)


@pytest.fixture(scope="module")
def signals():
    size = chip_smoke.TINY
    rng = np.random.default_rng(chip_smoke.SEED)
    x64 = rng.standard_normal((size["channels"], size["n"]))
    x16_64 = rng.standard_normal((size["channels"], size["n_16k"]))
    dev = jax.devices()[0]
    return (jax.device_put(x64.astype(np.float32), dev), x64,
            jax.device_put(x16_64.astype(np.float32), dev), x16_64)


@pytest.mark.parametrize("phase", ["chain", "pipelines", "suite",
                                   "streaming", "wav", "sharded"])
def test_phase_at_tiny_size(phase, signals):
    x, x64, x16, x16_64 = signals
    chk = chip_smoke.Checker()
    run = {
        "chain": lambda: chip_smoke.phase_chain(chk, x, x64),
        "pipelines": lambda: chip_smoke.phase_pipelines(chk, x, x64, x16,
                                                        x16_64),
        "suite": lambda: chip_smoke.phase_suite(chk, x, x64),
        "streaming": lambda: chip_smoke.phase_streaming(chk, x),
        "wav": lambda: chip_smoke.phase_wav(chk, x),
        "sharded": lambda: chip_smoke.phase_sharded(chk, x, x64, 4),
    }[phase]
    run()
    assert not chk.failures
