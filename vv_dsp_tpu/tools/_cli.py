"""Shared helpers for the dump tools: text signal I/O in the reference's
fixture format (one value per line; complex as "re,im") and C-style %g
printing."""

from __future__ import annotations

import sys

import numpy as np


def force_cpu():
    """Dump tools are tiny host utilities — keep them on the CPU."""
    import jax
    try:
        jax.config.update("jax_platforms", "cpu")
    except Exception:
        pass  # backend already initialized; any device works


def _open(path: str):
    try:
        return open(path)
    except OSError as e:
        sys.stderr.write(f"fopen: {e}\n")  # reference tools perror + exit 1
        raise SystemExit(1)


def read_reals(path: str, n: int | None = None) -> np.ndarray:
    vals = []
    with _open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            vals.append(float(line.split(",")[0]))
            if n is not None and len(vals) >= n:
                break
    return np.asarray(vals, dtype=np.float32)


def read_complex(path: str, n: int | None = None) -> np.ndarray:
    vals = []
    with _open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            re, im = line.split(",")[:2]
            vals.append(complex(float(re), float(im)))
            if n is not None and len(vals) >= n:
                break
    return np.asarray(vals, dtype=np.complex64)


def print_reals(x, fmt: str = "%g"):
    out = sys.stdout
    for v in np.asarray(x).ravel():
        out.write(fmt % float(v) + "\n")


def print_complex(x, fmt: str = "%g,%g"):
    out = sys.stdout
    for v in np.asarray(x).ravel():
        out.write(fmt % (float(v.real), float(v.imag)) + "\n")


def rand_reals(n: int, seed: int, lo: float = -1.0, hi: float = 1.0):
    r = np.random.default_rng(seed)
    return (r.random(n, dtype=np.float32) * (hi - lo) + lo).astype(np.float32)


def rand_complex(n: int, seed: int):
    r = np.random.default_rng(seed)
    return (r.random(n) + 1j * r.random(n)).astype(np.complex64)


def parse_flags(argv, spec, usage: str):
    """Tiny C-style flag parser. spec: {flag: (key, type)}; returns dict or
    None (usage error)."""
    out = {}
    i = 0
    while i < len(argv):
        a = argv[i]
        if a in ("-h", "--help"):
            sys.stderr.write(usage + "\n")
            return None
        if a in spec:
            key, typ = spec[a]
            if typ is bool:
                out[key] = True
                i += 1
                continue
            if i + 1 >= len(argv):
                sys.stderr.write(usage + "\n")
                return None
            out[key] = typ(argv[i + 1])
            i += 2
        else:
            sys.stderr.write(usage + "\n")
            return None
    return out
