"""Resampling: reference-parity linear & windowed-sinc paths plus a TRUE
polyphase rational resampler (the reference's polyphase is a TODO comment only,
src/resample/resampler.c:13).

Reference semantics preserved (src/resample/resampler.c):
- output length = floor((n-1) * L/M) + 1 (endpoint mapping, :73),
- linear path: per-output fractional-index interpolation with edge clamping
  (:77-86, interpolate.c:4-21),
- sinc path: windowed-sinc (Hann over taps, N-1 denominator) around
  floor(in_pos), cutoff = min(1, L/M), edge clamp, normalize by kernel sum
  (:88-119); taps forced even, 4..128.

Design: the per-output-sample gather loops become dense phase
matrices. For a rational ratio L/M the fractional position k*M/L has exactly L
distinct fractional phases, so the sinc path is a (L, taps) weight matrix and
output phase r is a stride-M correlation of the input with row
(r*M mod L) — i.e. true polyphase structure executed as L batched
convolutions. `resample_poly` provides the scipy.signal.resample_poly-parity
upfirdn path used by the north-star chain.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import jax
import jax.numpy as jnp

from vv_dsp_tpu import config
from vv_dsp_tpu.ops.window import get_window_np


# ---------------------------------------------------------------------------
# interpolation primitives (src/resample/interpolate.c)
# ---------------------------------------------------------------------------

def interpolate_linear(x, pos):
    """Linear interp at fractional positions; pos<=0 -> x[0], pos>=n-1 -> x[-1]
    (src/resample/interpolate.c:4-21)."""
    x = config.as_compute(x)
    n = x.shape[-1]
    pos = jnp.clip(pos, 0.0, float(n - 1))
    i0 = jnp.floor(pos).astype(jnp.int32)
    i1 = jnp.minimum(i0 + 1, n - 1)
    frac = (pos - i0).astype(x.dtype)
    return jnp.take(x, i0, axis=-1) * (1 - frac) + jnp.take(x, i1, axis=-1) * frac


def interpolate_catmull_rom(x, pos):
    """Catmull-Rom cubic with clamped neighbors (src/resample/interpolate.c:23-64)."""
    x = config.as_compute(x)
    n = x.shape[-1]
    pos = jnp.clip(pos, 0.0, float(n - 1))
    i1 = jnp.floor(pos).astype(jnp.int32)
    t = (pos - i1).astype(x.dtype)
    i0 = jnp.clip(i1 - 1, 0, n - 1)
    i2 = jnp.clip(i1 + 1, 0, n - 1)
    i3 = jnp.clip(i1 + 2, 0, n - 1)
    p0 = jnp.take(x, i0, axis=-1)
    p1 = jnp.take(x, jnp.clip(i1, 0, n - 1), axis=-1)
    p2 = jnp.take(x, i2, axis=-1)
    p3 = jnp.take(x, i3, axis=-1)
    t2 = t * t
    t3 = t2 * t
    return 0.5 * (
        2 * p1
        + (-p0 + p2) * t
        + (2 * p0 - 5 * p1 + 4 * p2 - p3) * t2
        + (-p0 + 3 * p1 - 3 * p2 + p3) * t3
    )


# ---------------------------------------------------------------------------
# reference-parity resampler
# ---------------------------------------------------------------------------

def output_length(n: int, l: int, m: int) -> int:
    """floor((n-1) * L/M) + 1 (src/resample/resampler.c:73)."""
    return (n - 1) * l // m + 1


def resample_linear(x, l: int, m: int):
    """Linear-interpolation rational resampler (reference linear path)."""
    x = config.as_compute(x)
    n = x.shape[-1]
    out_n = output_length(n, l, m)
    k = np.arange(out_n, dtype=np.float64)
    pos = jnp.asarray(k * m / l, dtype=x.dtype)
    return interpolate_linear(x, pos)


@functools.lru_cache(maxsize=64)
def _sinc_phase_table(l: int, m: int, taps: int) -> np.ndarray:
    """(L, taps) windowed-sinc weights for the L distinct fractional phases.

    Phase r corresponds to outputs k with k*M mod L == r*M mod L... — we index
    by r = k mod L directly: frac(k*M/L) = (k*M mod L)/L depends only on
    k mod L. Weights follow src/resample/resampler.c:95-118: t = idx - in_pos,
    kernel = sinc(t*cutoff) * hann01(m+half over taps), normalized by its sum.
    """
    cutoff = min(1.0, l / m)
    half = taps // 2
    win = get_window_np("hann", taps)  # hann over (taps-1) denominator, matches
    rows = np.zeros((l, taps), dtype=np.float64)
    offs = np.arange(-half, taps - half, dtype=np.float64)
    for r in range(l):
        frac = (r * m % l) / l  # in_pos - floor(in_pos)
        t = offs - frac
        w = np.sinc(t * cutoff) * win
        s = w.sum()
        rows[r] = w / s if s != 0.0 else w
    return rows


def resample_sinc(x, l: int, m: int, taps: int = 32):
    """Windowed-sinc rational resampler, reference semantics
    (src/resample/resampler.c:88-119) executed as a polyphase gather+matvec.

    Edge handling: input index clamp to [0, n-1] like the reference.
    """
    x = config.as_compute(x)
    taps = int(np.clip(taps, 4, 128))
    if taps % 2:
        taps += 1
    n = x.shape[-1]
    out_n = output_length(n, l, m)
    half = taps // 2
    wtab = jnp.asarray(_sinc_phase_table(l, m, taps), dtype=x.dtype)

    k = np.arange(out_n)
    center = (k * m) // l  # floor(k*M/L)
    phase = k % l
    idx = center[:, None] + np.arange(-half, taps - half)[None, :]
    idx = np.clip(idx, 0, n - 1)
    gathered = jnp.take(x, jnp.asarray(idx), axis=-1)  # (..., out_n, taps)
    w = wtab[jnp.asarray(phase)]  # (out_n, taps)
    return jnp.einsum("...ot,ot->...o", gathered, w,
                      precision=config.MATMUL_PRECISION)


# ---------------------------------------------------------------------------
# scipy-parity polyphase (upfirdn) — the north-star resampler
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=64)
def _resample_poly_filter(up: int, down: int) -> np.ndarray:
    """scipy.signal.resample_poly default anti-alias FIR: firwin with a
    Kaiser(5.0) window, 2*10*max(up,down)+1 taps, cutoff 1/max(up,down),
    scaled by up."""
    max_rate = max(up, down)
    f_c = 1.0 / max_rate
    half_len = 10 * max_rate
    numtaps = 2 * half_len + 1
    n = np.arange(numtaps, dtype=np.float64) - half_len
    h = f_c * np.sinc(f_c * n)
    h *= get_window_np("kaiser", numtaps, 5.0)
    h /= h.sum()  # firwin scales so DC gain is 1
    return h * up


def _upfirdn_gather(h, x, up: int, down: int, offset: int, n_out: int):
    """Polyphase upfirdn core: y[k] = full[offset + k*down] where
    full[t] = sum_j x[j] h[t - j*up] (linear conv of the zero-stuffed signal).

    Executed without materializing the up-rate stream: for t = offset+k*down,
    contributing input indices are j = t//up - i with tap h[(t mod up) + i*up]
    — a dense gather + per-phase dot, the classic polyphase
    decomposition.
    """
    h = np.asarray(h, dtype=np.float64)
    n_in = x.shape[-1]
    len_h = len(h)
    h_pad = np.zeros((-(-len_h // up)) * up, dtype=np.float64)
    h_pad[:len_h] = h
    taps_pp = len(h_pad) // up
    hpp = h_pad.reshape(taps_pp, up).T  # hpp[p, i] = h[p + i*up]

    t = offset + np.arange(n_out) * down
    anchor = t // up
    phase = t % up
    idx = anchor[:, None] - np.arange(taps_pp)[None, :]
    valid = (idx >= 0) & (idx < n_in)
    idx_c = np.clip(idx, 0, n_in - 1)
    gathered = jnp.take(x, jnp.asarray(idx_c), axis=-1)  # (..., n_out, taps_pp)
    gathered = jnp.where(jnp.asarray(valid), gathered, 0)
    w = jnp.asarray(hpp, dtype=x.dtype)[jnp.asarray(phase)]  # (n_out, taps_pp)
    return jnp.einsum("...ot,ot->...o", gathered, w,
                      precision=config.MATMUL_PRECISION)


def upfirdn(h, x, up: int = 1, down: int = 1):
    """scipy.signal.upfirdn parity: zero-stuff by up, filter with h,
    downsample by down; output length ceil((n_in-1)*up + len(h)) / down)."""
    x = config.as_compute(x)
    n_in = x.shape[-1]
    n_out = -(-((n_in - 1) * up + len(np.asarray(h))) // down)
    return _upfirdn_gather(h, x, up, down, 0, n_out)


def resample_poly(x, up: int, down: int):
    """scipy.signal.resample_poly(x, up, down) parity: polyphase anti-aliased
    rational resampling with output length ceil(n*up/down) and centered
    (zero-delay) default kaiser filter."""
    x = config.as_compute(x)
    g = math.gcd(up, down)
    up //= g
    down //= g
    if up == 1 and down == 1:
        return x
    n_in = x.shape[-1]
    n_out = -(-n_in * up // down)
    h = _resample_poly_filter(up, down)
    half_len = (len(h) - 1) // 2
    return _upfirdn_gather(h, x, up, down, half_len, n_out)


# ---------------------------------------------------------------------------
# frame-matmul upfirdn — the matmul path for ANY ratio
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=64)
def _upfirdn_conv_plan(h_key, up: int, down: int, offset: int):
    """Static geometry for the strided-conv upfirdn form.

    Outputs grouped in frames of `up`: y[k*up + p] reads inputs
    x[k*down + a_p - i] with a_p = (offset + p*down)//up, weight
    h[r_p + i*up], r_p = (offset + p*down) % up. Over one frame the union of
    input windows spans Wd = a_{up-1} - (a_0 - taps_pp + 1) + 1 samples, so
    the whole resample is ONE cross-correlation with stride `down` and `up`
    output channels: W[p, c] = h[r_p + (a_p - c_lo - c)*up] — natural-order
    output falls out of the (frames, up) reshape with NO phase transposes.
    Returns (W (up, Wd) float64, c_lo).
    """
    h = np.asarray(h_key, dtype=np.float64)
    h_pad = np.zeros((-(-len(h) // up)) * up, dtype=np.float64)
    h_pad[: len(h)] = h
    taps_pp = len(h_pad) // up
    p = np.arange(up)
    t = offset + p * down
    anchor = t // up
    phase = t % up
    c_lo = int(anchor[0]) - (taps_pp - 1)
    c_hi = int(anchor[-1])
    wd = c_hi - c_lo + 1
    W = np.zeros((up, wd), dtype=np.float64)
    i = np.arange(taps_pp)
    for pp in range(up):
        cols = anchor[pp] - c_lo - i  # window column of tap i
        W[pp, cols] = h_pad[phase[pp] + i * up]
    return W, c_lo


def _upfirdn_conv(h, x, up: int, down: int, offset: int, n_out: int):
    """upfirdn as one strided conv (see _upfirdn_conv_plan). Identical
    output to _upfirdn_gather; the (n_out, taps_pp) gather matrix never
    exists in HBM and the output needs no reordering."""
    W, c_lo = _upfirdn_conv_plan(tuple(np.asarray(h, np.float64)), up, down,
                                 offset)
    wd = W.shape[1]
    n_in = x.shape[-1]
    k_frames = -(-n_out // up)
    pad_l = max(0, -c_lo)
    last_needed = (k_frames - 1) * down + c_lo + wd - 1
    pad_r = max(0, last_needed - (n_in - 1))

    lead = x.shape[:-1]
    xb = x.reshape((-1, 1) + (n_in,))
    xb = jnp.pad(xb, ((0, 0), (0, 0), (pad_l, pad_r)))
    Wj = jnp.asarray(W.astype(np.dtype(x.dtype)))[:, None, :]  # (up, 1, Wd)
    y = jax.lax.conv_general_dilated(
        xb, Wj, window_strides=(down,), padding="VALID",
        precision=config.MATMUL_PRECISION)  # (batch, up, K)
    y = jnp.swapaxes(y, -1, -2).reshape(lead + (k_frames * up,))
    return y[..., :n_out]


def _upfirdn_frames_matmul(h, x, up: int, down: int, offset: int,
                           n_out: int):
    """upfirdn as strided-reshape framing + ONE einsum.

    frames[k, c] = x[k*down + c_lo + c] built from contiguous reshape views
    (no gather — the 11x framing lesson), then (..., K, Win) @ (Win, up) ->
    natural-order output. The form for large `up` (the einsum's output dim
    is wide where the conv lowering has `up` tiny output channels), at q*x
    HBM reads.

    This is exactly the group=1 instance of the tall-frames plan below.
    """
    return _upfirdn_tall(h, x, up, down, offset, n_out, group=1)


def resample_poly_mxu(x, up: int, down: int):
    """scipy.signal.resample_poly parity on the matmul paths (same
    filter and output length as resample_poly; bit-identical geometry).

    Form dispatch (thresholds untuned on the GPU): large `up` rides the
    frames-matmul einsum (wide output dim; q = ceil(Wd/down) stays small so
    the framing inflation is bounded); otherwise the strided conv."""
    x = config.as_compute(x)
    g = math.gcd(up, down)
    up //= g
    down //= g
    if up == 1 and down == 1:
        return x
    n_in = x.shape[-1]
    n_out = -(-n_in * up // down)
    h = _resample_poly_filter(up, down)
    half_len = (len(h) - 1) // 2
    taps_pp = -(-len(h) // up)
    q = -(-(down + taps_pp) // down)
    if up >= 32 and q <= 4:
        return _upfirdn_frames_matmul(h, x, up, down, half_len, n_out)
    return _upfirdn_conv(h, x, up, down, half_len, n_out)


# The polyphase path the pipelines and the benchmark use: the
# (n_out, taps_pp) gather matrix of resample_poly never exists.
resample_poly_best = resample_poly_mxu


def upfirdn_mxu(h, x, up: int = 1, down: int = 1):
    """scipy.signal.upfirdn parity on the strided-conv path."""
    x = config.as_compute(x)
    n_in = x.shape[-1]
    n_out = -(-((n_in - 1) * up + len(np.asarray(h))) // down)
    return _upfirdn_conv(h, x, up, down, 0, n_out)


# ---------------------------------------------------------------------------
# tall-frames upfirdn & fused FIR+resample — ONE matmul for the chain head
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=32)
def _upfirdn_tall_plan(h_key, up: int, down: int, offset: int, group: int):
    """Block-banded weight matrix for frames of `group*up` outputs.

    Generalizes _upfirdn_conv_plan from one phase-group per step to `group`
    groups per frame: outputs j in [0, group*up) of frame k read inputs
    x[k*group*down + c] for c in [c_lo, c_hi], weight
    M[c - c_lo, j] = h[phase_j + i*up] at c = anchor_j - i. With
    group*down ~ taps_pp the matrix is mostly dense, so the whole upfirdn is
    ONE (frames, Win) @ (Win, group*up) matmul — the same trick as
    fir_apply_mxu's block-Toeplitz form, at any rational rate.
    Returns (M (Win, group*up) float64, c_lo).
    """
    h = np.asarray(h_key, dtype=np.float64)
    h_pad = np.zeros((-(-len(h) // up)) * up, dtype=np.float64)
    h_pad[: len(h)] = h
    taps_pp = len(h_pad) // up
    gpp = h_pad.reshape(taps_pp, up)  # gpp[i, r] = h[r + i*up]
    j = np.arange(group * up)
    t = offset + j * down
    anchor = t // up
    phase = t % up
    c_lo = int(anchor[0]) - (taps_pp - 1)
    wd = int(anchor[-1]) - c_lo + 1
    M = np.zeros((wd, group * up), dtype=np.float64)
    i = np.arange(taps_pp)
    for jj in range(group * up):
        M[anchor[jj] - c_lo - i, jj] = gpp[i, phase[jj]]
    return M, c_lo


def _upfirdn_tall(h, x, up: int, down: int, offset: int, n_out: int,
                  group: int):
    """upfirdn evaluated `group*up` outputs per frame via one einsum (see
    _upfirdn_tall_plan). Sample-identical to _upfirdn_gather."""
    M, c_lo = _upfirdn_tall_plan(tuple(np.asarray(h, np.float64)), up, down,
                                 offset, group)
    wd, U = M.shape
    stride = group * down
    n_in = x.shape[-1]
    k_frames = -(-n_out // U)
    q = -(-wd // stride)
    width = q * stride
    Mp = np.zeros((width, U))
    Mp[:wd] = M
    pad_l = max(0, -c_lo)
    base = c_lo + pad_l
    pad_r = max(0, base + (k_frames + q - 1) * stride - (n_in + pad_l))
    lead = x.shape[:-1]
    xp = jnp.pad(x, [(0, 0)] * len(lead) + [(pad_l, pad_r)])
    views = [
        xp[..., base + r * stride: base + (k_frames + r) * stride]
        .reshape(lead + (k_frames, stride))
        for r in range(q)
    ]
    frames = jnp.concatenate(views, axis=-1)
    Mj = jnp.asarray(Mp.astype(np.dtype(x.dtype)))
    y = jnp.einsum("...kw,wp->...kp", frames, Mj,
                   precision=config.MATMUL_PRECISION)
    return y.reshape(lead + (k_frames * U,))[..., :n_out]


@functools.lru_cache(maxsize=16)
def _fused_fir_resample_filter(fir_key, up: int, down: int):
    """Composite filter g = conv(zero-stuff_up(h_fir), h_resample): filtering
    at the input rate then polyphase-resampling equals ONE upfirdn with g
    (out[t] = sum_i x[i] g[t - up*i]). Returns (g float64, offset)."""
    h_f = np.asarray(fir_key, dtype=np.float64)
    h_r = _resample_poly_filter(up, down)
    up_f = np.zeros((len(h_f) - 1) * up + 1, dtype=np.float64)
    up_f[::up] = h_f
    return np.convolve(up_f, h_r), (len(h_r) - 1) // 2


def fir_resample_fused(h_fir, x, up: int, down: int,
                       group: int | None = None):
    """resample_poly(fir_apply(h_fir, x), up, down) in ONE matmul pass —
    sample-exact vs the staged pair, including the staged FIR's end-of-signal
    truncation (the composite filter "sees" the FIR tail past n that
    fir_apply truncates, so the last few outputs are recomputed staged).

    This erases the intermediate HBM round trip AND both stages' separate
    launch/layout overheads — the north-star chain's head becomes one
    matmul. FLOP overhead vs the algorithmic minimum is Win/taps_pp ~ 2x
    at the default group.
    """
    x = config.as_compute(x)
    if x.ndim != 2:
        from vv_dsp_tpu.utils.shapes import collapse_leading
        x2, restore = collapse_leading(x)
        return restore(fir_resample_fused(h_fir, x2, up, down, group), 1)
    g = math.gcd(up, down)
    up //= g
    down //= g
    h_np = np.asarray(h_fir, dtype=np.float64)
    if up == 1 and down == 1:
        from vv_dsp_tpu.ops.fir import fir_apply_mxu
        return fir_apply_mxu(h_np, x)
    n_in = x.shape[-1]
    n_out = -(-n_in * up // down)
    gf, offset = _fused_fir_resample_filter(tuple(h_np), up, down)
    taps_pp = -(-len(gf) // up)
    if group is None:
        # frame stride ~ taps_pp (group*down ~ taps_pp): wider frames
        # amortize the band's zero-fill over taller matmul tiles.
        # Untuned on the GPU.
        group = max(1, int(round(taps_pp / down)))
    y = _upfirdn_tall(gf, x, up, down, offset, n_out, group)

    # exact staged tail: first output whose window crosses the FIR tail
    # (clamped — for signals shorter than the resample filter's half-length
    # every output crosses it and the whole result is computed staged)
    m0 = max(0, -(-(up * n_in - offset) // down))
    n_tail = n_out - m0
    if 0 < n_tail <= 1024 and m0 > 0:
        # the staged definition for the few crossing outputs collapses to a
        # tiny dense matmul: y_st[m] = sum_j x[j] * W[m - m0, j - jw0] with
        # W[m,j] = sum_{k < n_in} h_r[off + m*down - k*up] * h_fir[k - j]
        # (a full fir_apply on the tail slice measured 5 ms — absurd for
        # ~13 outputs; this is the same numbers at matmul-epsilon cost)
        wt, jw0 = _staged_tail_matrix(tuple(h_np), up, down, offset,
                                      n_in, m0, n_tail)
        xw = x[..., max(0, jw0):]
        tail = jnp.einsum("...j,mj->...m", xw,
                          jnp.asarray(wt[:, :xw.shape[-1]], dtype=x.dtype),
                          precision=config.MATMUL_PRECISION)
        y = jnp.concatenate([y[..., :m0], tail], axis=-1)
    elif m0 < n_out:
        h_r = _resample_poly_filter(up, down)
        taps_r = -(-len(h_r) // up)
        jlo = (offset + m0 * down) // up - taps_r + 1
        taps_f = len(h_np)
        s0 = max(0, jlo - taps_f + 1)
        from vv_dsp_tpu.ops.fir import fir_apply
        y_t = fir_apply(h_np.astype(np.dtype(x.dtype)), x[..., s0:])
        off2 = offset + m0 * down - up * s0
        tail = _upfirdn_gather(h_r, y_t, up, down, off2, n_out - m0)
        y = jnp.concatenate([y[..., :m0], tail], axis=-1)
    return y


@functools.lru_cache(maxsize=16)
def _staged_tail_matrix(h_key, up: int, down: int, offset: int, n_in: int,
                        m0: int, n_tail: int):
    """(W (n_tail, width) float32, jw0): the staged fused-head tail as one
    dense matrix over the input window x[jw0:n_in] — staged means the FIR
    intermediate is truncated at n_in (k < n_in), which is the one place the
    pure composite filter differs from resample_poly(fir_apply(x))."""
    h_fir = np.asarray(h_key, dtype=np.float64)
    h_r = _resample_poly_filter(up, down)
    len_r = len(h_r)
    taps_f = len(h_fir)
    # offset == (len_r-1)//2 (the composite offset IS h_r's group delay —
    # _fused_fir_resample_filter):
    # y_st[m] = sum_k 1[0<=k<n_in] h_r[offset + m*down - k*up] * y_fir[k],
    # y_fir[k] = sum_u h_fir[u] x[k-u]
    ms = np.arange(m0, m0 + n_tail)
    k_hi = min(n_in - 1, (offset + int(ms[-1]) * down) // up)
    k_lo = max(0, -(-(offset + int(ms[0]) * down - len_r + 1) // up))
    jw0 = k_lo - taps_f + 1
    width = k_hi - jw0 + 1
    # A[m, k] = h_r coefficient; B[k, j] = h_fir[k - j]
    kk = np.arange(k_lo, k_hi + 1)
    gi = offset + ms[:, None] * down - kk[None, :] * up
    a = np.where((gi >= 0) & (gi < len_r), h_r[np.clip(gi, 0, len_r - 1)], 0.0)
    jj = np.arange(jw0, jw0 + width)
    fi = kk[:, None] - jj[None, :]
    b = np.where((fi >= 0) & (fi < taps_f),
                 h_fir[np.clip(fi, 0, taps_f - 1)], 0.0)
    w = a @ b  # (n_tail, width)
    if jw0 < 0:  # clip columns for x indices < 0 (zero samples)
        w = w[:, -jw0:]
        jw0 = 0
    return np.ascontiguousarray(w), jw0  # float64; cast at use


# ---------------------------------------------------------------------------
# multistage rational resampling — for large L/M ratios
# ---------------------------------------------------------------------------

def _factor_stages(up: int, down: int, max_side: int = 9):
    """Split L/M into a cascade of small rational stages (each side's factor
    <= max_side) so every stage stays in the fast polyphase regime. Greedy:
    pair the largest remaining up-factor with the largest remaining
    down-factor per stage."""
    def prime_factors(v):
        out = []
        d = 2
        while d * d <= v:
            while v % d == 0:
                out.append(d)
                v //= d
            d += 1
        if v > 1:
            out.append(v)
        return out

    def group(factors):
        # multiply small primes together while staying <= max_side; a prime
        # above max_side becomes its own (single-stage polyphase) stage
        factors = sorted(factors, reverse=True)
        groups = []
        for f in factors:
            if f > max_side:
                groups.append(f)
                continue
            placed = False
            for i, g in enumerate(groups):
                if g * f <= max_side:
                    groups[i] = g * f
                    placed = True
                    break
            if not placed:
                groups.append(f)
        return sorted(groups, reverse=True)

    ups = group(prime_factors(up)) if up > 1 else []
    downs = group(prime_factors(down)) if down > 1 else []
    stages = []
    while ups or downs:
        u = ups.pop(0) if ups else 1
        d = downs.pop(0) if downs else 1
        stages.append((u, d))
    return stages


def resample_multistage(x, up: int, down: int):
    """Rational resampling as a cascade of small polyphase stages.

    For large coprime ratios (e.g. 160/147 for 44.1k->48k) the single-stage
    polyphase filter has up*taps_pp ~ 20*max(L,M)*... weights — slow even as
    a dense einsum. Factoring into stages
    with single-digit ratios keeps every stage in the fast regime and needs
    FEWER total taps (each stage's transition band is wider). The composite
    response differs slightly from scipy.signal.resample_poly's single
    filter (it is a cascade of kaiser anti-aliasers — at least as much
    stopband rejection), so this is a quality-equivalent, not sample-exact,
    alternative; output length still ceil(n*L/M).
    """
    x = config.as_compute(x)
    g = math.gcd(up, down)
    up //= g
    down //= g
    if up == 1 and down == 1:
        return x
    n_in = x.shape[-1]
    n_out_target = -(-n_in * up // down)
    for u, d in _factor_stages(up, down):
        x = resample_poly(x, u, d)
    # cascade of ceils can overshoot by a sample or two
    return x[..., :n_out_target]
