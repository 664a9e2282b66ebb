"""Performance-regression gate — the counterpart of the reference's
benchmark-as-test registration (tests/benchmark/CMakeLists.txt:27-36: bench
suites wired into CTest so a perf change is visible in the test harness).

Two scopes:

  default  — the headline bench (bench.py, 2 metrics) vs
             benchmarks/BENCH_BASELINE.json at --threshold 10%.
  --suite  — EVERY benchmarks/run_suite.py row vs
             benchmarks/SUITE_BASELINE.json at the same threshold.

A baseline belongs to one device_kind. The gate FAILS (non-zero) when the
benchmark finds no GPU or when the baseline file is missing or was taken
on another kind of card; --update writes a baseline on the card at hand.

Usage:
    python scripts/check_perf_regression.py                  # headline gate
    python scripts/check_perf_regression.py --suite          # full-suite gate
    python scripts/check_perf_regression.py [--suite] --update  # new baseline
    python scripts/check_perf_regression.py --report         # never fail

This process never imports jax: the benchmark runs in ONE child process,
which owns the card.
"""

import argparse
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BASELINE = os.path.join(REPO, "benchmarks", "BENCH_BASELINE.json")
SUITE_BASELINE = os.path.join(REPO, "benchmarks", "SUITE_BASELINE.json")


def _run(cmd, timeout):
    """(device dict or None, JSON rows, returncode) of one benchmark run."""
    out = subprocess.run(cmd, capture_output=True, text=True,
                         timeout=timeout)
    device, rows = None, []
    for line in out.stdout.splitlines():
        line = line.strip()
        if line.startswith("{"):
            row = json.loads(line)
            if "device" in row and len(row) == 1:
                device = row["device"]
            else:
                rows.append(row)
    if out.returncode != 0:
        print(out.stdout)
        print(out.stderr, file=sys.stderr)
    return device, rows, out.returncode


def run_bench():
    device, rows, rc = _run([sys.executable, os.path.join(REPO, "bench.py")],
                            1800)
    return device, {r["metric"]: {"value": r["value"], "unit": r["unit"]}
                    for r in rows if "metric" in r}, rc


def run_suite():
    device, rows, rc = _run(
        [sys.executable, os.path.join(REPO, "benchmarks", "run_suite.py")],
        3600)
    return device, {r["name"]: {"value": r["samples_per_sec"],
                                "unit": "samples/s"}
                    for r in rows if "name" in r}, rc


def compare(rows: dict, base: dict, threshold: float):
    """Per-metric comparison; returns (lines, failures).  Pure function so
    the synthetic-injection test can drive it without hardware."""
    lines, failed = [], []
    for metric, ref in base.items():
        got = rows.get(metric)
        if got is None:
            failed.append(f"{metric}: MISSING from bench output")
            continue
        ratio = got["value"] / ref["value"]
        status = "OK" if ratio >= 1.0 - threshold else "REGRESSION"
        lines.append(f"{metric:34s} {got['value']:14.1f} vs baseline "
                     f"{ref['value']:14.1f} ({ratio:6.2%})  {status}")
        if status != "OK":
            failed.append(f"{metric}: {ratio:.2%} of baseline "
                          f"(threshold {1 - threshold:.0%})")
    return lines, failed


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--threshold", type=float, default=0.10,
                    help="max allowed fractional drop vs baseline")
    ap.add_argument("--suite", action="store_true",
                    help="gate every run_suite.py row (not just headline)")
    ap.add_argument("--report", action="store_true",
                    help="print comparison, always exit 0")
    ap.add_argument("--update", action="store_true",
                    help="rewrite the baseline from a fresh run")
    args = ap.parse_args(argv)
    fail = 0 if args.report else 1

    path = SUITE_BASELINE if args.suite else BASELINE
    device, rows, rc = run_suite() if args.suite else run_bench()
    if rc != 0 or device is None or device.get("platform") != "gpu":
        print(f"no GPU measurement (device={device}, rc={rc}); "
              f"the perf gate {'reports nothing' if args.report else 'FAILS'}")
        return fail
    if args.update:
        with open(path, "w") as f:
            json.dump({"device_kind": device["kind"], "metrics": rows}, f,
                      indent=1)
        print(f"baseline updated: {path}")
        return 0

    base = None
    if os.path.exists(path):
        with open(path) as f:
            base = json.load(f)
    if base is None or base.get("device_kind") != device["kind"]:
        print(f"no baseline for {device['kind']!r} in {path}; run --update "
              f"on this card. Measured: {json.dumps(rows)}")
        return fail
    lines, failed = compare(rows, base["metrics"], args.threshold)
    print("\n".join(lines))
    if failed and not args.report:
        print("\nPERF REGRESSION:\n  " + "\n  ".join(failed),
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
