"""Leading-axes collapse for 2-D code paths.

Some paths operate on (channels, time) — the reference's ops are
rank-oblivious per-signal loops, so our dispatch must be too: 1-D signals
and (batch, channels, time) tensors get their leading axes folded into one
channel axis, run the 2-D path, and unfold."""

from __future__ import annotations


def collapse_leading(x):
    """(..., t) -> ((-1, t) view, restore) where restore(out, out_trailing)
    maps a kernel output whose last `out_trailing` axes are new (e.g. 1 for
    sample streams, 2 for (frames, bins)) back to the original leading
    shape.  Works for 1-D (adds a singleton channel) through N-D."""
    lead = x.shape[:-1]
    x2 = x.reshape((-1, x.shape[-1]))

    def restore(out, out_trailing: int = 1):
        return out.reshape(lead + out.shape[-out_trailing:])

    return x2, restore
