"""Float MFCC pipeline as JAX matmuls.

Design (SURVEY.md section 7): the FLOPs live in three matmuls that XLA
compiles to GEMMs and fuses under one jit --

  1. frames @ [window-weighted DFT]     (512 x 514: re|im concatenated)
  2. power  @ mel                       (257 x 32)
  3. logmel @ dct                       (32 x 32)

The Hamming window multiply is precomposed into the DFT operator
(tables.windowed_rdft_matrix), so the radix-2 RTL core (mfcc/misc/fft.py),
the window LUT datapath (mfcc/core/window.py) and the serial filterbank
accumulator (mfcc/core/filterbank.py) all collapse into matmuls.  Everything
between matmuls is elementwise work that XLA fuses.

An rfft-based variant is kept both as a numerics cross-check and because at
much larger nfft the O(N log N) path wins.
"""

from __future__ import annotations

import functools
from typing import Literal

import numpy as np
import jax
import jax.numpy as jnp

from ..config import MFCCConfig
from .. import tables
from . import framing

Precision = Literal["highest", "high", "default", "split", "bf16", "f64ish"]


def _bf16_trunc(x: jnp.ndarray) -> jnp.ndarray:
    """Round an f32 array to bf16 precision via mantissa bit arithmetic
    (round-to-nearest-even, like a real bf16 cast).

    NOT written as x.astype(bf16).astype(f32): under
    --xla_allow_excess_precision=true (set by some runtimes) XLA may
    elide the round-trip cast, which silently zeroes the residual of a
    double-word split.  The bit arithmetic cannot be elided.
    """
    u = jax.lax.bitcast_convert_type(x, jnp.uint32)
    round_bias = jnp.uint32(0x7FFF) + ((u >> 16) & jnp.uint32(1))
    return jax.lax.bitcast_convert_type((u + round_bias)
                                        & jnp.uint32(0xFFFF0000),
                                        jnp.float32)


def split_matmul(x: jnp.ndarray, w: jnp.ndarray) -> jnp.ndarray:
    """Error-compensated bf16 matmul: ~16 mantissa bits in 4 bf16 passes
    (exact bf16 products, f32 accumulation).

    x = x_hi + x_lo and w = w_hi + w_lo with the *_hi parts bf16-exact
    (mantissa-masked; see _bf16_trunc) and the residuals holding the next
    mantissa bits.  Accumulation stays f32.
    """
    bf = jnp.bfloat16
    x_hi = _bf16_trunc(x)
    x_lo = (x - x_hi).astype(bf)
    w_hi = _bf16_trunc(w)
    w_lo = (w - w_hi).astype(bf)
    x_hi = x_hi.astype(bf)
    w_hi = w_hi.astype(bf)
    out = jnp.matmul(x_hi, w_hi, preferred_element_type=jnp.float32)
    out = out + jnp.matmul(x_hi, w_lo, preferred_element_type=jnp.float32)
    out = out + jnp.matmul(x_lo, w_hi, preferred_element_type=jnp.float32)
    out = out + jnp.matmul(x_lo, w_lo, preferred_element_type=jnp.float32)
    return out


def _matmul_precision(precision: Precision):
    if precision == "highest":
        return jax.lax.Precision.HIGHEST
    if precision == "high":
        return jax.lax.Precision.HIGH
    if precision == "default":
        return jax.lax.Precision.DEFAULT
    return jax.lax.Precision.DEFAULT  # bf16 handled by dtype


@functools.lru_cache(maxsize=None)
def _operators_np(cfg: MFCCConfig):
    """Constant operator matrices (numpy, cached per config)."""
    C, S = tables.windowed_rdft_matrix(cfg.nfft)
    CS = np.concatenate([C, S], axis=1)              # (nfft, 2*nbins)
    mel = tables.float_mel_matrix(cfg.samplerate, cfg.nfft, cfg.nfilters)
    dct = tables.dct2_ortho_matrix(cfg.nfilters)[:, : cfg.nceptrums]
    return CS, mel, dct


def _operators(cfg: MFCCConfig, dtype_name: str):
    dtype = jnp.dtype(dtype_name)
    CS, mel, dct = _operators_np(cfg)
    return (jnp.asarray(CS, dtype), jnp.asarray(mel, dtype),
            jnp.asarray(dct, dtype))


@functools.lru_cache(maxsize=None)
def _segment_operators_np(cfg: MFCCConfig):
    """The windowed-DFT operator split along the frame axis into hop-sized
    segments: frame i = [seg_i | seg_{i+1} | seg_{i+2} | first 2 of seg_{i+3}]
    for nfft=512 = 3*hop + 2.  Lets the DFT run as shifted matmuls over the
    (L, hop) reshape of the signal -- overlapped framing with NO gather and
    no frame materialization (the vectorized answer to the ring buffer's
    overlap re-reads, mfcc/core/frame.py:86-114)."""
    CS, _, _ = _operators_np(cfg)
    hop, nfft = cfg.hop, cfg.nfft
    nseg = nfft // hop
    rem = nfft - nseg * hop
    segs = [CS[q * hop: (q + 1) * hop] for q in range(nseg)]
    tail = CS[nseg * hop:] if rem else None
    return segs, tail, nseg, rem


def mfcc_segmented(audio_emph: jnp.ndarray, cfg: MFCCConfig = MFCCConfig(),
                   *, precision: Precision = "highest",
                   dtype=jnp.float32, mel_floor: float = 0.0) -> jnp.ndarray:
    """Float pipeline on EMPHASIZED audio via segment matmuls:
    (..., T) -> (..., F, nceptrums).  Numerically the same spec as
    mfcc_frames(method='dft'); it reads the signal once instead of
    materializing overlapping frames."""
    x = audio_emph.astype(dtype)
    T = x.shape[-1]
    hop, nfft = cfg.hop, cfg.nfft
    F = cfg.n_frames(T)
    segs_np, tail_np, nseg, rem = _segment_operators_np(cfg)
    L = F + nseg + (1 if rem else 0)   # segment rows needed
    need = L * hop
    if need > T:
        x = jnp.pad(x, [(0, 0)] * (x.ndim - 1) + [(0, need - T)])
    X = x[..., : need].reshape(x.shape[:-1] + (L, hop))

    use_split = (precision == "split")
    prec = _matmul_precision("highest" if use_split else precision)
    mm = (split_matmul if use_split
          else functools.partial(jnp.matmul, precision=prec))
    nbins = cfg.nbins_float
    reim = None
    for q in range(nseg):
        t = mm(X[..., q: q + F, :], jnp.asarray(segs_np[q], dtype))
        reim = t if reim is None else reim + t
    if rem:
        t = mm(X[..., nseg: nseg + F, :rem], jnp.asarray(tail_np, dtype))
        reim = reim + t

    re, im = reim[..., :nbins], reim[..., nbins:]
    power = re * re + im * im
    _, mel, dct = _operators(cfg, jnp.dtype(dtype).name)
    melspec = jnp.matmul(power, mel, precision=prec)
    if mel_floor:
        melspec = jnp.maximum(melspec, mel_floor)
    logmel = jnp.log2(melspec)
    return jnp.matmul(logmel, dct, precision=prec)


def mfcc_frames(frames: jnp.ndarray, cfg: MFCCConfig = MFCCConfig(), *,
                method: str = "dft", precision: Precision = "highest",
                dtype=jnp.float32, mel_floor: float = 0.0) -> jnp.ndarray:
    """MFCC of pre-emphasized frames: (..., F, nfft) -> (..., F, nceptrums).

    method='dft'  -- windowed-DFT matmul, one f32 GEMM (the default).
    method='rfft' -- jnp.fft.rfft reference path (identical numerics spec).
    """
    if precision == "f64ish":
        # compensated double-f32 accuracy mode: <=1e-5 vs the float64
        # oracle without f64 on the device; see ops/df32.py
        from . import df32
        return df32.mfcc_frames_f64ish(frames, cfg)
    frames = frames.astype(dtype)
    nbins = cfg.nbins_float
    use_split = (precision == "split")
    prec = _matmul_precision("highest" if use_split else precision)
    CS, mel, dct = _operators(cfg, jnp.dtype(dtype).name)

    if method == "dft":
        reim = (split_matmul(frames, CS) if use_split
                else jnp.matmul(frames, CS, precision=prec))
        re, im = reim[..., :nbins], reim[..., nbins:]
        power = re * re + im * im
    elif method == "rfft":
        win = jnp.asarray(tables.float_window(cfg.nfft), dtype)
        spec = jnp.fft.rfft(frames * win, axis=-1) / cfg.nfft
        power = jnp.abs(spec).astype(dtype) ** 2
    else:
        raise ValueError(f"unknown method {method!r}")

    melspec = jnp.matmul(power, mel, precision=prec)
    if mel_floor:
        melspec = jnp.maximum(melspec, mel_floor)
    logmel = jnp.log2(melspec)
    return jnp.matmul(logmel, dct, precision=prec)


def mfcc_batch(audio: jnp.ndarray, cfg: MFCCConfig = MFCCConfig(), *,
               method: str = "dft", precision: Precision = "highest",
               dtype=jnp.float32, mel_floor: float = 0.0) -> jnp.ndarray:
    """Full float pipeline on raw signals: (..., T) -> (..., F, nceptrums)."""
    x = audio.astype(dtype)
    emph = framing.preemphasis(x)
    if method == "segmented":
        if cfg.windowlen != cfg.nfft:
            # the segment layout assumes full-nfft frames; fall back
            method = "dft"
        else:
            return mfcc_segmented(emph, cfg, precision=precision,
                                  dtype=dtype, mel_floor=mel_floor)
    frames = framing.extract_frames(emph, cfg.nfft, cfg.hop,
                                    windowlen=cfg.windowlen)
    return mfcc_frames(frames, cfg, method=method, precision=precision,
                       dtype=dtype, mel_floor=mel_floor)


# -- Partial feature extractors (the model-family surface) -------------------

def power_spectrum_frames(frames: jnp.ndarray, cfg: MFCCConfig = MFCCConfig(),
                          *, precision: Precision = "highest",
                          dtype=jnp.float32) -> jnp.ndarray:
    """(..., F, nfft) -> (..., F, nbins_float) |fft(w*x)/nfft|^2."""
    frames = frames.astype(dtype)
    nbins = cfg.nbins_float
    CS, _, _ = _operators(cfg, jnp.dtype(dtype).name)
    reim = jnp.matmul(frames, CS, precision=_matmul_precision(precision))
    re, im = reim[..., :nbins], reim[..., nbins:]
    return re * re + im * im


def log_mel_frames(frames: jnp.ndarray, cfg: MFCCConfig = MFCCConfig(), *,
                   precision: Precision = "highest", dtype=jnp.float32,
                   mel_floor: float = 0.0) -> jnp.ndarray:
    """(..., F, nfft) -> (..., F, nfilters) log2 mel energies."""
    power = power_spectrum_frames(frames, cfg, precision=precision, dtype=dtype)
    _, mel, _ = _operators(cfg, jnp.dtype(dtype).name)
    melspec = jnp.matmul(power, mel, precision=_matmul_precision(precision))
    if mel_floor:
        melspec = jnp.maximum(melspec, mel_floor)
    return jnp.log2(melspec)
