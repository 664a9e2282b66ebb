"""IIR biquad cascades as parallel associative scans, plus native
Butterworth / Chebyshev design.

Reference: src/filter/iir.c — a Direct-Form-II-Transposed biquad
    y  = b0 x + z1
    z1 = b1 x - a1 y + z2
    z2 = b2 x - a2 y
applied per-sample, per-stage (sequential recurrence, src/filter/iir.c:21-43).
The reference ships NO design functions (README overclaims; only caller-supplied
coefficients) — design here is new surface required by the north star
(BASELINE.json config 3).

Design: the recurrence is linear in the state s = (z1, z2):
    s' = A s + B x,   A = [[-a1, 1], [-a2, 0]],  B = [b1 - a1 b0, b2 - a2 b0]
    y  = b0 x + s_prev[0]
so a length-n filter run is an associative scan over affine maps
(A, B x_t) with composition (f then g) = (g.A @ f.A, g.A @ f.b + g.b) —
O(log n) depth on device instead of O(n) sequential steps. Stages of a cascade
run sequentially (static Python loop; stage count is small). The scan is also
the unit of cross-shard state carry in vv_dsp_tpu.parallel: each time-shard
reduces to one affine map, shards compose via collective prefix.

Numerics: scan elements are kept in float32 by default; coefficients are
designed in float64 numpy. Parity contract is scipy.signal.sosfilt/lfilter
within 3e-3 (python/test_filters.py:32-33).
"""

from __future__ import annotations

import functools

import numpy as np
import jax.numpy as jnp
from jax import lax

from vv_dsp_tpu import config


# ---------------------------------------------------------------------------
# apply
# ---------------------------------------------------------------------------

def _biquad_cumulative(x, b0, b1, b2, a1, a2):
    """Cumulative affine maps of one biquad over the last axis.

    x: (..., n). Returns (A_cum, b_cum) with A_cum: (..., n, 2, 2),
    b_cum: (..., n, 2) such that the state after sample t from entry state s0
    is s_t = A_cum[t] @ s0 + b_cum[t]. This decomposition is what lets the
    sharded version (vv_dsp_tpu.parallel) compose whole blocks: a shard's
    total map is (A_cum[-1], b_cum[-1]).
    """
    if not jnp.issubdtype(x.dtype, jnp.floating):
        x = x.astype(jnp.float32)  # int input would truncate coefficients
    dt = x.dtype
    A = jnp.asarray([[-a1, 1.0], [-a2, 0.0]], dtype=dt)
    B = jnp.asarray([b1 - a1 * b0, b2 - a2 * b0], dtype=dt)

    # Element t: affine map s -> A s + B x_t. Batched shapes:
    #   As: (..., n, 2, 2) broadcast constant; bs: (..., n, 2)
    bs = x[..., None] * B  # (..., n, 2)
    As = jnp.broadcast_to(A, x.shape + (2, 2))

    def combine(f, g):
        fa, fb = f
        ga, gb = g
        # the precision knob matters here: at a reduced precision the scan
        # path misses its documented scipy parity
        a = jnp.einsum("...ij,...jk->...ik", ga, fa,
                       precision=config.MATMUL_PRECISION)
        b = jnp.einsum("...ij,...j->...i", ga, fb,
                       precision=config.MATMUL_PRECISION) + gb
        return a, b

    return lax.associative_scan(combine, (As, bs), axis=-3)


def _biquad_output(x, b0, s_init, A_cum, b_cum):
    """DF2T output from cumulative maps: y_t = b0 x_t + z1_{t-1}.

    Returns (y, s_final)."""
    if s_init is None:
        s_after = b_cum  # (..., n, 2): state after sample t
        prev_z1 = jnp.concatenate(
            [jnp.zeros_like(s_after[..., :1, 0]), s_after[..., :-1, 0]], axis=-1
        )
    else:
        # s_init: (..., 2) per batch entry — add the time axis for broadcast.
        s_after = b_cum + jnp.einsum("...tij,...tj->...ti", A_cum,
                                     s_init[..., None, :],
                                     precision=config.MATMUL_PRECISION)
        first = jnp.broadcast_to(s_init[..., 0:1], s_after[..., :1, 0].shape)
        prev_z1 = jnp.concatenate([first, s_after[..., :-1, 0]], axis=-1)
    y = b0 * x + prev_z1
    return y, s_after[..., -1, :]


def _biquad_scan(x, b0, b1, b2, a1, a2, s_init=None):
    """One biquad over the last axis via associative scan.

    x: (..., n). Returns (y, s_final) where s_final = (z1, z2) state after the
    block — the quantity a streaming caller (or the sharded version) carries.
    """
    A_cum, b_cum = _biquad_cumulative(x, b0, b1, b2, a1, a2)
    return _biquad_output(x, b0, s_init, A_cum, b_cum)


def normalize_sos(sos) -> np.ndarray:
    """Validate/normalize SOS to (n_stages, 5) float64 rows [b0 b1 b2 a1 a2]
    with a0 divided out (accepts scipy's (n, 6) layout)."""
    sos = np.asarray(sos, dtype=np.float64)
    if sos.ndim == 1:
        sos = sos[None, :]
    out = []
    for row in sos:
        if row.shape[0] == 6:
            b0, b1, b2, a0, a1, a2 = row
            if abs(a0 - 1.0) > 1e-12:
                b0, b1, b2, a1, a2 = b0 / a0, b1 / a0, b2 / a0, a1 / a0, a2 / a0
        else:
            b0, b1, b2, a1, a2 = row
        out.append((b0, b1, b2, a1, a2))
    return np.asarray(out)


def biquad_apply(x, b0, b1, b2, a1, a2, s_init=None):
    """Single-biquad DF2T filter (vv_dsp_biquad_process semantics)."""
    y, _ = _biquad_scan(x, float(b0), float(b1), float(b2), float(a1), float(a2),
                        s_init)
    return y


_BLOCK_B = 512          # block length of the block state-space fast path
_BLOCK_MIN_N = 8192     # below this the per-section scan is fine


@functools.lru_cache(maxsize=32)
def _cascade_block_constants(sos_key, b_len: int):
    """Host-side float64 constants for the block state-space IIR.

    The SOS cascade is ONE LTI system s' = A s + Bv u, y = Cv s + D u with
    state dim S = 2*n_sections (series composition of the DF2T sections).
    Splitting the signal into blocks of b_len makes every block's work a
    dense matmul and the cross-block coupling a tiny affine scan:
      y_block = T @ x_block (zero-state response; T[i,j] = h[i-j], the
                 cascade impulse response — EXACT inside a block, no
                 truncation: only j <= i < b_len terms exist)
                + R @ s_entry            (R[i] = Cv A^i)
      c_block = F^T @ x_block            (F[j] = A^{b-1-j} Bv)
      s_next  = A^b s_entry + c_block.
    Returns (Wcat (b+S, b) = [T; F^T], R (b, S), Ab (S, S), radius) in
    float64; casting to f32 happens at the call site. `radius` is the pole
    magnitude bound — the powers of A only stay representable for stable
    (or marginally stable) filters, so callers fall back to the scan path
    when radius > 1."""
    sos = np.asarray(sos_key, dtype=np.float64).reshape(-1, 5)
    A = np.zeros((0, 0))
    Bv = np.zeros((0,))
    Cv = np.zeros((0,))
    D = 1.0
    for b0, b1, b2, a1, a2 in sos:
        Ai = np.array([[-a1, 1.0], [-a2, 0.0]])
        Bi = np.array([b1 - a1 * b0, b2 - a2 * b0])
        Ci = np.array([1.0, 0.0])
        Di = b0
        s_old = A.shape[0]
        A_new = np.zeros((s_old + 2, s_old + 2))
        A_new[:s_old, :s_old] = A
        A_new[s_old:, :s_old] = np.outer(Bi, Cv)
        A_new[s_old:, s_old:] = Ai
        B_new = np.concatenate([Bv, Bi * D])
        C_new = np.concatenate([Di * Cv, Ci])
        A, Bv, Cv, D = A_new, B_new, C_new, D * Di
    S = A.shape[0]
    radius = float(np.abs(np.linalg.eigvals(A)).max()) if S else 0.0

    h = np.zeros(b_len)
    F = np.zeros((b_len, S))
    R = np.zeros((b_len, S))
    h[0] = D
    Ak = np.eye(S)                      # A^i
    for i in range(b_len):
        R[i] = Cv @ Ak
        if i + 1 < b_len:
            h[i + 1] = Cv @ (Ak @ Bv)
        Ak = Ak @ A
    Ab = Ak                              # A^b_len
    # F[j] = A^{b-1-j} Bv: build backwards reusing the power chain
    acc = Bv.copy()
    for j in range(b_len - 1, -1, -1):
        F[j] = acc
        acc = A @ acc
    i_idx = np.arange(b_len)[:, None]
    j_idx = np.arange(b_len)[None, :]
    T = np.where(i_idx >= j_idx, h[np.clip(i_idx - j_idx, 0, b_len - 1)], 0.0)
    wcat = np.concatenate([T, F.T], axis=0)   # (b+S, b)
    return wcat, R, Ab, radius


def _iir_apply_block(sos_n, x, zi):
    """Block state-space cascade apply: one (b+S, b) matmul per block plus
    an affine scan over the ~n/b block states. Replaces the whole-signal
    associative scan on long signals (measured 182 -> ~4 ms for a butter-4
    on 16ch x 479k; the per-sample scan drags 19 combine sweeps of
    (n, 2, 2) matrices through HBM)."""
    
    b_len = _BLOCK_B
    wcat64, r64, ab64, _ = _cascade_block_constants(
        tuple(map(tuple, sos_n)), b_len)
    n_sec = sos_n.shape[0]
    S = 2 * n_sec
    dt = x.dtype if jnp.issubdtype(x.dtype, jnp.floating) else jnp.float32
    x = x.astype(dt)
    wcat = jnp.asarray(wcat64.astype(np.dtype(dt)))
    r_m = jnp.asarray(r64.astype(np.dtype(dt)))
    ab = jnp.asarray(ab64.astype(np.dtype(dt)))

    lead = x.shape[:-1]
    n = x.shape[-1]
    nb = -(-n // b_len)
    xp = jnp.pad(x, [(0, 0)] * len(lead) + [(0, nb * b_len - n)])
    xb = xp.reshape(lead + (nb, b_len))
    einsum_out = jnp.einsum("...nj,ij->...ni", xb, wcat,
                            precision=config.MATMUL_PRECISION)
    zsr, c = einsum_out[..., :b_len], einsum_out[..., b_len:]

    # entry state per block: s_{m+1} = Ab s_m + c_m (affine scan over nb)
    a_bc = jnp.broadcast_to(ab, lead + (nb, S, S))

    def combine(f, g):
        fa, fb = f
        ga, gb = g
        return (jnp.einsum("...ij,...jk->...ik", ga, fa,
                           precision=config.MATMUL_PRECISION),
                jnp.einsum("...ij,...j->...i", ga, fb,
                           precision=config.MATMUL_PRECISION) + gb)

    a_cum, b_cum = lax.associative_scan(combine, (a_bc, c), axis=len(lead))
    # s_after[m] = state after block m (entry state of block m+1)
    if zi is None:
        s_after = b_cum
        s_entry = jnp.concatenate(
            [jnp.zeros(lead + (1, S), dt), s_after[..., :-1, :]], axis=-2)
        s_last = s_after[..., -1, :]
    else:
        # accept scipy-style unbatched (n_sections, 2) zi like the scan
        # path: broadcast to the batch before flattening to cascade order
        zi_b = jnp.broadcast_to(jnp.asarray(zi, dtype=dt),
                                lead + (n_sec, 2))
        s0 = zi_b.reshape(lead + (S,))
        s_after = b_cum + jnp.einsum("...nij,...j->...ni", a_cum, s0,
                                      precision=config.MATMUL_PRECISION)
        s_entry = jnp.concatenate(
            [jnp.broadcast_to(s0[..., None, :], lead + (1, S)),
             s_after[..., :-1, :]], axis=-2)
        s_last = s_after[..., -1, :]
    y = zsr + jnp.einsum("...ns,is->...ni", s_entry, r_m,
                         precision=config.MATMUL_PRECISION)
    y = y.reshape(lead + (nb * b_len,))[..., :n]
    # exact end state for n not a block multiple: recompute the tail's
    # state transition over the real samples only
    if n % b_len:
        # exact end state when n is not a block multiple: redo the partial
        # block's transition over the real samples only (A^{tail-1-j} Bv and
        # A^tail from small host tables)
        m_last = n // b_len
        tail_len = n - m_last * b_len
        s_in_tail = s_entry[..., m_last, :]
        wt_t, _, ab_t, _ = _cascade_block_constants(
            tuple(map(tuple, sos_n)), tail_len)
        f_t = jnp.asarray(wt_t[tail_len:, :].astype(np.dtype(dt)))
        ab_tj = jnp.asarray(ab_t.astype(np.dtype(dt)))
        x_tail = x[..., m_last * b_len:]
        c_t = jnp.einsum("...j,sj->...s", x_tail, f_t,
                         precision=config.MATMUL_PRECISION)
        s_last = jnp.einsum("ij,...j->...i", ab_tj, s_in_tail,
                            precision=config.MATMUL_PRECISION) + c_t
    return y, s_last


def _block_path_ok(sos_n, n: int) -> bool:
    if n < _BLOCK_MIN_N or sos_n.shape[0] > 8:
        return False
    _, _, _, radius = _cascade_block_constants(
        tuple(map(tuple, sos_n)), _BLOCK_B)
    return radius <= 1.0 + 1e-9


def iir_apply(sos, x, return_state: bool = False, zi=None):
    """Biquad cascade (vv_dsp_iir_apply, src/filter/iir.c:29-43;
    scipy.signal.sosfilt role).

    sos: (n_stages, 6) scipy-style [b0 b1 b2 a0 a1 a2] (a0 must be 1), or
    (n_stages, 5) reference-style [b0 b1 b2 a1 a2]. Stage loop is static.
    zi: optional (..., n_stages, 2) per-stage DF2T entry state (z1, z2),
    scipy's sosfilt(zi=...) convention.

    Long signals run the block state-space path (_iir_apply_block): the
    cascade as one LTI system, blocks of 512 as dense matmuls, block
    states coupled by a ~n/512-element affine scan. Short signals and
    unstable designs (pole radius > 1, whose A-powers overflow) keep the
    per-section associative scan.
    """
    sos_n = normalize_sos(sos)
    n = x.shape[-1]
    if _block_path_ok(sos_n, n):
        y, s_cascade = _iir_apply_block(sos_n, x, zi)
        if return_state:
            return y, s_cascade.reshape(s_cascade.shape[:-1]
                                        + (sos_n.shape[0], 2))
        return y
    states = []
    y = x
    for k, (b0, b1, b2, a1, a2) in enumerate(sos_n):
        s0 = None if zi is None else jnp.asarray(zi)[..., k, :]
        y, s = _biquad_scan(y, b0, b1, b2, a1, a2, s_init=s0)
        states.append(s)
    if return_state:
        return y, jnp.stack(states, axis=-2)
    return y


def sosfilt_zi_np(sos) -> np.ndarray:
    """scipy.signal.sosfilt_zi: per-stage DF2T steady state for a unit-step
    input, cascading each stage's DC gain into the next stage's scale.
    Host-side float64. Returns (n_stages, 2)."""
    sos = normalize_sos(sos)
    zis = np.empty((len(sos), 2), dtype=np.float64)
    scale = 1.0
    for k, (b0, b1, b2, a1, a2) in enumerate(sos):
        A = np.array([[-a1, 1.0], [-a2, 0.0]])
        B = np.array([b1 - a1 * b0, b2 - a2 * b0])
        zis[k] = scale * np.linalg.solve(np.eye(2) - A, B)
        scale *= (b0 + b1 + b2) / (1.0 + a1 + a2)  # stage DC gain
    return zis


def filtfilt_sos(sos, x, padlen: int | None = None):
    """Zero-phase IIR: scipy.signal.sosfiltfilt parity (forward-backward
    cascade with odd-reflect padding and steady-state initial conditions).

    The IIR complement of filtfilt_fir (src/filter/common.c:23-80) — the
    reference has no IIR zero-phase path; with the butter/cheby designs this
    completes the scipy zero-phase workflow on the associative-scan kernels.
    Each directional pass is the same O(log n)-depth scan as iir_apply.
    """
    sos = normalize_sos(sos)
    n = x.shape[-1]
    if padlen is None:
        ntaps = 2 * len(sos) + 1
        ntaps -= int(min((sos[:, 2] == 0).sum(), (sos[:, 4] == 0).sum()))
        padlen = 3 * ntaps  # scipy's default edge size
    if padlen >= n:
        raise ValueError(
            f"signal length {n} must exceed padlen {padlen}")
    if not jnp.issubdtype(jnp.asarray(x).dtype, jnp.floating):
        x = jnp.asarray(x, jnp.float32)
    if padlen > 0:
        left = 2.0 * x[..., :1] - x[..., padlen:0:-1]
        right = 2.0 * x[..., -1:] - x[..., -2:-padlen - 2:-1]
        ext = jnp.concatenate([left, x, right], axis=-1)
    else:
        ext = x
    zi = jnp.asarray(sosfilt_zi_np(sos), dtype=ext.dtype)
    fwd = iir_apply(sos, ext, zi=zi * ext[..., :1, None])
    rev = fwd[..., ::-1]
    bwd = iir_apply(sos, rev, zi=zi * rev[..., :1, None])
    out = bwd[..., ::-1]
    return out[..., padlen:padlen + n] if padlen > 0 else out


def lfilter(b, a, x):
    """scipy.signal.lfilter semantics for ANY filter order.

    Order <= 2 runs as a single biquad affine scan (the reference/tool path,
    tools/dump_iir.c); higher orders factor through :func:`tf2sos` into a
    biquad cascade (root pairing + distributed gain), each stage an
    associative scan. Parity contract: scipy.signal.lfilter within 3e-3
    (python/test_filters.py:32-33)."""
    b = np.asarray(b, dtype=np.float64)
    a = np.asarray(a, dtype=np.float64)
    b = b / a[0]
    a = a / a[0]
    if len(a) <= 3 and len(b) <= 3:
        b = np.pad(b, (0, 3 - len(b)))
        a = np.pad(a, (0, 3 - len(a)))
        return biquad_apply(x, b[0], b[1], b[2], a[1], a[2])
    return iir_apply(tf2sos(b, a), x)


# ---------------------------------------------------------------------------
# design (host-side, float64 numpy) — new surface vs the reference
# ---------------------------------------------------------------------------

def _bilinear_zpk(z, p, k, fs=2.0):
    fs2 = 2.0 * fs
    z = np.asarray(z, dtype=np.complex128)
    p = np.asarray(p, dtype=np.complex128)
    degree = len(p) - len(z)
    zb = (fs2 + z) / (fs2 - z)
    pb = (fs2 + p) / (fs2 - p)
    zb = np.append(zb, -np.ones(degree))
    kb = k * np.real(np.prod(fs2 - z) / np.prod(fs2 - p))
    return zb, pb, kb


def _butter_prototype(order: int):
    k = np.arange(order)
    poles = np.exp(1j * np.pi * (2 * k + order + 1) / (2 * order))
    return np.array([]), poles, 1.0


def _cheby1_prototype(order: int, rp: float):
    eps = np.sqrt(10.0 ** (rp / 10.0) - 1.0)
    mu = np.arcsinh(1.0 / eps) / order
    k = np.arange(order)
    theta = np.pi * (2 * k + 1) / (2 * order)
    poles = -np.sinh(mu) * np.sin(theta) + 1j * np.cosh(mu) * np.cos(theta)
    gain = np.real(np.prod(-poles))
    if order % 2 == 0:
        gain /= np.sqrt(1.0 + eps * eps)
    return np.array([]), poles, gain


def _cheby2_prototype(order: int, rs: float):
    de = 1.0 / np.sqrt(10.0 ** (rs / 10.0) - 1.0)
    mu = np.arcsinh(1.0 / de) / order
    k = np.arange(order)
    theta = np.pi * (2 * k + 1) / (2 * order)
    # zeros on the imaginary axis at sec(theta); odd order drops the
    # middle (infinite) zero
    if order % 2:
        mask = np.arange(order) != order // 2
    else:
        mask = np.ones(order, bool)
    zeros = 1j / np.cos(theta[mask]) * -1.0
    zeros = np.conj(zeros)
    poles = 1.0 / (-np.sinh(mu) * np.sin(theta) + 1j * np.cosh(mu) * np.cos(theta))
    gain = np.real(np.prod(-poles) / np.prod(-zeros))
    return zeros, poles, gain


def _lp2lp_zpk(z, p, k, wo):
    degree = len(p) - len(z)
    return z * wo, p * wo, k * wo ** degree


def _lp2hp_zpk(z, p, k, wo):
    degree = len(p) - len(z)
    zh = wo / z if len(z) else np.array([], dtype=np.complex128)
    ph = wo / p
    zh = np.append(zh, np.zeros(degree))
    kh = k * np.real(np.prod(-z) / np.prod(-p)) if len(z) else k * np.real(
        1.0 / np.prod(-p)
    )
    return zh, ph, kh


def _lp2bp_zpk(z, p, k, wo, bw):
    """Lowpass prototype -> bandpass: s -> (s^2 + wo^2)/(bw*s). Each root r
    splits into the pair r*bw/2 +- sqrt((r*bw/2)^2 - wo^2); the `degree`
    missing zeros land at the origin; gain scales by bw^degree."""
    z = np.asarray(z, dtype=np.complex128)
    p = np.asarray(p, dtype=np.complex128)
    degree = len(p) - len(z)
    zs = z * (bw / 2.0)
    ps = p * (bw / 2.0)
    zb = np.concatenate([zs + np.sqrt(zs ** 2 - wo ** 2),
                         zs - np.sqrt(zs ** 2 - wo ** 2)])
    pb = np.concatenate([ps + np.sqrt(ps ** 2 - wo ** 2),
                         ps - np.sqrt(ps ** 2 - wo ** 2)])
    zb = np.append(zb, np.zeros(degree))
    kb = k * bw ** degree
    return zb, pb, kb


def _lp2bs_zpk(z, p, k, wo, bw):
    """Lowpass prototype -> bandstop: s -> bw*s/(s^2 + wo^2). Roots invert
    (bw/2)/r then split like bandpass; the `degree` missing zeros land at
    +-j*wo (the notch); gain picks up real(prod(-z)/prod(-p))."""
    z = np.asarray(z, dtype=np.complex128)
    p = np.asarray(p, dtype=np.complex128)
    degree = len(p) - len(z)
    zs = (bw / 2.0) / z if len(z) else np.array([], dtype=np.complex128)
    ps = (bw / 2.0) / p
    zb = np.concatenate([zs + np.sqrt(zs ** 2 - wo ** 2),
                         zs - np.sqrt(zs ** 2 - wo ** 2)]) if len(zs) else (
        np.array([], dtype=np.complex128))
    pb = np.concatenate([ps + np.sqrt(ps ** 2 - wo ** 2),
                         ps - np.sqrt(ps ** 2 - wo ** 2)])
    zb = np.concatenate([zb, np.full(degree, 1j * wo),
                         np.full(degree, -1j * wo)])
    num = np.real(np.prod(-z)) if len(z) else 1.0
    kb = k * num / np.real(np.prod(-p))
    return zb, pb, kb


def _pair_conjugates(vals):
    """Sort complex values into conjugate pairs (+ at most one real leftover
    per odd count), returning a list of 1- or 2-element arrays."""
    vals = np.asarray(vals, dtype=np.complex128)
    used = np.zeros(len(vals), dtype=bool)
    pairs = []
    order = np.argsort(-np.abs(vals))  # pair high-|.| (near unit circle) first
    for i in order:
        if used[i]:
            continue
        used[i] = True
        if abs(vals[i].imag) < 1e-10 * max(1.0, abs(vals[i].real)):
            # find another real
            j = next((jj for jj in order if not used[jj]
                      and abs(vals[jj].imag)
                      < 1e-10 * max(1.0, abs(vals[jj].real))), None)
            if j is None:
                pairs.append(np.array([vals[i]]))
            else:
                used[j] = True
                pairs.append(np.array([vals[i], vals[j]]))
        else:
            conj = np.conj(vals[i])
            j = min((jj for jj in order if not used[jj]),
                    key=lambda jj: abs(vals[jj] - conj), default=None)
            if j is None or abs(vals[j] - conj) > 1e-6 * max(1.0, abs(conj)):
                raise ValueError("unpaired complex root")
            used[j] = True
            pairs.append(np.array([vals[i], vals[j]]))
    return pairs


def zpk2sos(z, p, k, distribute_gain: bool = True):
    """Pair zeros/poles into second-order sections.

    scipy-grade robustness for arbitrary filters (scipy.signal.zpk2sos
    role): pole pairs are matched with their NEAREST zero pairs (processing
    poles closest to the unit circle first, where a bad match costs the most
    dynamic range), sections are ordered so the near-unit-circle poles come
    last, and the overall gain is spread geometrically across sections
    (|k|^(1/n)) instead of loaded onto the first one — the f32 overflow /
    underflow hazard of single-section gain is what motivates both choices.
    Leftover zero pairs (numerator order > denominator) become FIR sections.
    """
    z = np.asarray(z, dtype=np.complex128)
    p = np.asarray(p, dtype=np.complex128)
    ppairs = _pair_conjugates(p) if len(p) else []
    zpairs = _pair_conjugates(z) if len(z) else []

    def closeness(pair):  # distance to the unit circle
        return min(abs(1.0 - np.abs(v)) for v in pair)

    # Assign zeros: nearest-pair matching, worst-conditioned poles pick first.
    order = sorted(range(len(ppairs)), key=lambda i: closeness(ppairs[i]))
    remaining = list(zpairs)
    assigned: dict[int, np.ndarray] = {}
    for i in order:
        if remaining:
            cen = np.mean(ppairs[i])
            j = min(range(len(remaining)),
                    key=lambda t: abs(np.mean(remaining[t]) - cen))
            assigned[i] = remaining.pop(j)
        else:
            assigned[i] = np.array([])
    # Farthest-from-circle sections first; leftover FIR zero sections lead.
    section_pairs = [(np.array([]), zz) for zz in remaining]
    section_pairs += [(ppairs[i], assigned[i]) for i in reversed(order)]

    ns = max(len(section_pairs), 1)
    if distribute_gain and k != 0.0:
        g = float(abs(k)) ** (1.0 / ns)
        gains = [g] * ns
        gains[0] *= 1.0 if k > 0 else -1.0
    else:
        gains = [float(k)] + [1.0] * (ns - 1)

    sos = []
    for i, (pp, zz) in enumerate(section_pairs):
        bpoly = np.real(np.poly(zz)) if len(zz) else np.array([1.0])
        apoly = np.real(np.poly(pp)) if len(pp) else np.array([1.0])
        b = np.zeros(3)
        a = np.zeros(3)
        b[: len(bpoly)] = bpoly * gains[i]
        a[: len(apoly)] = apoly
        sos.append(np.concatenate([b, a]))
    if not sos:
        sos.append(np.array([float(k), 0, 0, 1, 0, 0]))
    return np.asarray(sos)


def tf2zpk(b, a):
    """Transfer-function -> zeros/poles/gain (+ pure-delay count).

    Returns (z, p, k, n_delay) where n_delay counts leading zeros of b — a
    z^-n_delay factor (zeros at infinity) that sections realize as delay
    numerators; tf2sos appends them explicitly."""
    b = np.atleast_1d(np.asarray(b, dtype=np.float64))
    a = np.atleast_1d(np.asarray(a, dtype=np.float64))
    if a[0] == 0.0:
        raise ValueError("a[0] must be nonzero")
    b = b / a[0]
    a = a / a[0]
    nz = np.nonzero(np.abs(b) > 0.0)[0]
    if len(nz) == 0:
        return np.array([]), np.array([]), 0.0, 0
    n_delay = int(nz[0])
    b = b[n_delay:]
    k = float(b[0])
    z = np.roots(b / b[0]) if len(b) > 1 else np.array([])
    p = np.roots(a) if len(a) > 1 else np.array([])
    return z, p, k, n_delay


def tf2sos(b, a):
    """Arbitrary-order (b, a) -> SOS cascade (scipy.signal.tf2sos role):
    root-find, conjugate-pair, proximity-match, distribute gain."""
    z, p, k, n_delay = tf2zpk(b, a)
    sos = zpk2sos(z, p, k)
    for _ in range(n_delay):
        sos = np.vstack([sos, [0.0, 1.0, 0.0, 1.0, 0.0, 0.0]])
    return sos


def _design(proto, btype: str, wn):
    z, p, k = proto
    fs = 2.0
    wn = np.atleast_1d(np.asarray(wn, dtype=np.float64))
    warped = 2.0 * fs * np.tan(np.pi * wn / fs)
    if btype in ("lowpass", "highpass"):
        if wn.size != 1:
            raise ValueError(f"{btype} needs a scalar wn")
        if btype == "lowpass":
            z, p, k = _lp2lp_zpk(z, p, k, warped[0])
        else:
            z, p, k = _lp2hp_zpk(z, p, k, warped[0])
    elif btype in ("bandpass", "bandstop"):
        if wn.size != 2 or not wn[0] < wn[1]:
            raise ValueError(f"{btype} needs wn = (low, high) with low < high")
        bw = warped[1] - warped[0]
        wo = float(np.sqrt(warped[0] * warped[1]))
        if btype == "bandpass":
            z, p, k = _lp2bp_zpk(z, p, k, wo, bw)
        else:
            z, p, k = _lp2bs_zpk(z, p, k, wo, bw)
    else:
        raise ValueError(
            "btype must be lowpass/highpass/bandpass/bandstop")
    z, p, k = _bilinear_zpk(z, p, k, fs)
    return zpk2sos(z, p, k)


def butter_sos(order: int, wn, btype: str = "lowpass") -> np.ndarray:
    """Butterworth digital design -> (sections, 6) SOS. wn normalized to
    Nyquist like scipy.signal.butter(order, wn, btype, output='sos');
    bandpass/bandstop take wn = (low, high)."""
    return _design(_butter_prototype(order), btype, wn)


def cheby1_sos(order: int, rp: float, wn, btype: str = "lowpass") -> np.ndarray:
    """Chebyshev-I digital design -> SOS (scipy.signal.cheby1 parity)."""
    return _design(_cheby1_prototype(order, rp), btype, wn)


def cheby2_sos(order: int, rs: float, wn, btype: str = "lowpass") -> np.ndarray:
    """Chebyshev-II digital design -> SOS (scipy.signal.cheby2 parity)."""
    return _design(_cheby2_prototype(order, rs), btype, wn)
