"""Pre-emphasis and overlapped framing.

Batched replacement for the reference's sample-serial Preemph stage
(mfcc/core/preemph.py:20-27) and the ring-buffer Frame stage
(mfcc/core/frame.py:49-155).  The ring buffer + RotatingCounters exist only
because the FPGA sees one sample per clock; with the whole signal resident in
device memory, framing is a static gather and pre-emphasis a shifted subtract.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

EMPHASIS_COEFF = 0.96875  # 1 - 1/32


def preemphasis(x: jnp.ndarray, carry: jnp.ndarray | None = None) -> jnp.ndarray:
    """Float pre-emphasis y[t] = x[t] - 0.96875*x[t-1] over the last axis.

    ``carry`` is the previous sample from an earlier chunk (streaming); with
    carry=None the first output equals x[0] (the RTL's previous-sample
    register resets to 0: y[0] = x[0] + 0 - 0)."""
    if carry is None:
        prev = jnp.concatenate(
            [jnp.zeros(x.shape[:-1] + (1,), x.dtype), x[..., :-1]], axis=-1)
    else:
        prev = jnp.concatenate([carry[..., None], x[..., :-1]], axis=-1)
    return x - EMPHASIS_COEFF * prev


def preemphasis_int(x: jnp.ndarray, carry: jnp.ndarray | None = None,
                    width: int = 16) -> jnp.ndarray:
    """Fixed-point pre-emphasis: y = wrap_w(x + (prev >> 5) - prev)
    (mfcc/core/preemph.py:23).  x int32 holding width-bit-range samples."""
    if carry is None:
        prev = jnp.concatenate(
            [jnp.zeros(x.shape[:-1] + (1,), x.dtype), x[..., :-1]], axis=-1)
    else:
        prev = jnp.concatenate([carry[..., None], x[..., :-1]], axis=-1)
    y = x + (prev >> 5) - prev
    return wrap_signed(y, width)


def wrap_signed(v: jnp.ndarray, bits: int) -> jnp.ndarray:
    """Truncate to ``bits`` bits and sign-extend (nMigen signed assignment)."""
    mask = (1 << bits) - 1
    sign = 1 << (bits - 1)
    return ((v & mask) ^ sign) - sign


def frame_indices(n_samples: int, nfft: int, hop: int,
                  windowlen: int | None = None) -> np.ndarray:
    """(nframes, windowlen) static gather index matrix.  ``windowlen`` is the
    number of REAL samples per frame (a frame completes after windowlen
    samples, mfcc/core/frame.py:86-91); defaults to nfft."""
    wl = windowlen or nfft
    n = (n_samples - wl) // hop + 1
    if n <= 0:
        raise ValueError(
            f"signal of {n_samples} samples is shorter than one frame ({wl})")
    starts = np.arange(n, dtype=np.int32) * hop
    return starts[:, None] + np.arange(wl, dtype=np.int32)[None, :]


def extract_frames(x: jnp.ndarray, nfft: int, hop: int,
                   windowlen: int | None = None) -> jnp.ndarray:
    """Gather overlapped frames: (..., T) -> (..., F, nfft).

    Static shapes: F is derived from T at trace time, so XLA sees a constant
    gather (replaces mfcc/core/frame.py's ring buffer + read-pointer jumps).
    With windowlen < nfft, positions >= windowlen are zero-padded (the
    Frame stage's padding mode, frame.py:77,120)."""
    wl = windowlen or nfft
    idx = jnp.asarray(frame_indices(x.shape[-1], nfft, hop, wl))
    fr = x[..., idx]
    if wl < nfft:
        fr = jnp.pad(fr, [(0, 0)] * (fr.ndim - 1) + [(0, nfft - wl)])
    return fr
