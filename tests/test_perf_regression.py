"""Benchmark-as-test: the perf gate is part of the test surface, like the
reference registering its bench suites in CTest
(tests/benchmark/CMakeLists.txt:27-36).  The timing gate itself needs a GPU
(the suite pins jax to an 8-device CPU mesh), so here we verify the gate
MACHINERY — its refusal without a card or a baseline for the card, and
the comparison logic."""

import json
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GATE = os.path.join(REPO, "scripts", "check_perf_regression.py")
KIND = "NVIDIA H100 80GB HBM3"


@pytest.fixture
def gate():
    sys.path.insert(0, os.path.join(REPO, "scripts"))
    import check_perf_regression
    return check_perf_regression


def test_gate_fails_without_gpu():
    """Without a GPU the benchmark refuses to measure and the gate exits
    non-zero (it used to exit 0 and pass silently)."""
    out = subprocess.run([sys.executable, GATE], capture_output=True,
                         text=True, timeout=300,
                         env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert out.returncode != 0
    assert "no GPU" in out.stdout


def test_gate_report_mode_never_fails(gate, monkeypatch):
    monkeypatch.setattr(gate, "run_bench",
                        lambda: ({"platform": "cpu", "kind": "cpu"}, {}, 1))
    assert gate.main([]) == 1
    assert gate.main(["--report"]) == 0


@pytest.mark.parametrize("baseline_kind", [None, "another card"])
def test_gate_fails_without_baseline_for_this_card(gate, monkeypatch,
                                                   tmp_path, baseline_kind):
    path = tmp_path / "BENCH_BASELINE.json"
    if baseline_kind is not None:
        path.write_text(json.dumps({"device_kind": baseline_kind,
                                    "metrics": {"m": {"value": 1.0}}}))
    monkeypatch.setattr(gate, "BASELINE", str(path))
    monkeypatch.setattr(gate, "run_bench", lambda: (
        {"platform": "gpu", "kind": KIND}, {"m": {"value": 1.0}}, 0))
    assert gate.main([]) == 1
    assert gate.main(["--report"]) == 0


def test_gate_update_then_pass_and_catch_regression(gate, monkeypatch,
                                                    tmp_path):
    path = tmp_path / "BENCH_BASELINE.json"
    monkeypatch.setattr(gate, "BASELINE", str(path))
    rows = {"m": {"value": 100.0, "unit": "Msamples/s"}}
    monkeypatch.setattr(gate, "run_bench", lambda: (
        {"platform": "gpu", "kind": KIND}, rows, 0))
    assert gate.main(["--update"]) == 0
    assert json.loads(path.read_text())["device_kind"] == KIND
    assert gate.main([]) == 0
    rows["m"] = {"value": 80.0, "unit": "Msamples/s"}
    assert gate.main([]) == 1
    assert gate.main(["--report"]) == 0


def test_compare_catches_synthetic_ten_percent_injection(gate):
    """The gate's comparison logic at its 10% threshold: a synthetic -10.5%
    row must fail, a -5% row must pass."""
    base = {"rowA": {"value": 1000.0}, "rowB": {"value": 2000.0}}
    rows = {"rowA": {"value": 895.0}, "rowB": {"value": 1900.0}}
    lines, failed = gate.compare(rows, base, threshold=0.10)
    assert len(lines) == 2
    assert len(failed) == 1 and failed[0].startswith("rowA")

    rows_ok = {"rowA": {"value": 950.0}, "rowB": {"value": 2000.0}}
    _, failed_ok = gate.compare(rows_ok, base, threshold=0.10)
    assert not failed_ok

    _, failed_missing = gate.compare({"rowA": {"value": 1000.0}}, base, 0.10)
    assert any("MISSING" in f for f in failed_missing)
