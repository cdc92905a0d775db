"""Observability: per-stage intermediate dumps and profiler hooks.

The reference taps every stage's stream with passive collector processes
(gen_collector, mfcc/core/mfcc.py:128-141) and embeds a LiteScope logic
analyzer (mfcc/debug/scope.py).  The equivalents here: a debug mode that
returns all stage outputs as a pytree, and jax.profiler trace helpers.
"""

from __future__ import annotations

import contextlib

import jax
import jax.numpy as jnp

from ..config import MFCCConfig
from .. import tables
from ..ops import framing, float_ops, int_ops


def float_intermediates(audio: jnp.ndarray, cfg: MFCCConfig = MFCCConfig(), *,
                        dtype=jnp.float32) -> dict:
    """All float-path stage outputs: the 9-stage chain the reference's
    simulator collects (mfcc/core/mfcc.py:171-183)."""
    x = jnp.asarray(audio).astype(dtype)
    emph = framing.preemphasis(x)
    frames = framing.extract_frames(emph, cfg.nfft, cfg.hop,
                                    windowlen=cfg.windowlen)
    win = frames * jnp.asarray(tables.float_window(cfg.nfft), dtype)
    spec = jnp.fft.rfft(win, axis=-1) / cfg.nfft
    spec_re = spec.real.astype(dtype)   # complex arrays don't transfer on
    spec_im = spec.imag.astype(dtype)   # all backends: keep re/im separate
    power = spec_re ** 2 + spec_im ** 2
    mel = jnp.matmul(power, jnp.asarray(
        tables.float_mel_matrix(cfg.samplerate, cfg.nfft, cfg.nfilters), dtype),
        precision=jax.lax.Precision.HIGHEST)
    logmel = jnp.log2(mel)
    cep = jnp.matmul(logmel, jnp.asarray(
        tables.dct2_ortho_matrix(cfg.nfilters), dtype),
        precision=jax.lax.Precision.HIGHEST)
    return dict(emph=emph, frames=frames, window=win, fft_re=spec_re,
                fft_im=spec_im, power=power, filterbank=mel, log=logmel,
                dct=cep, cepstra=cep[..., : cfg.nceptrums])


def int_intermediates(audio, cfg: MFCCConfig = MFCCConfig()) -> dict:
    """All INT-path stage outputs (same taps, fixed-point)."""
    with jax.enable_x64():
        x = jnp.asarray(audio, dtype=jnp.int32)
        emph = framing.preemphasis_int(x, width=cfg.width)
        frames = framing.extract_frames(emph, cfg.nfft, cfg.hop,
                                    windowlen=cfg.windowlen)
        win = int_ops.window_int(frames, cfg.nfft, cfg.window_precision,
                                 cfg.width)
        re, im = int_ops.fft_stream_int(win, cfg.width)
        power = int_ops.power_int(re, im, cfg.width, cfg.power_width)
        mel = int_ops.filterbank_int(power, cfg.samplerate, cfg.nfft,
                                     cfg.nfilters, cfg.filter_wsize,
                                     cfg.filter_gain, 16, cfg.power_width)
        logmel = int_ops.log2fix_int(mel, 16, cfg.log_width_output)
        cep = int_ops.dct_int(logmel, cfg.width)
        return dict(emph=emph, frames=frames, window=win, fft_re=re, fft_im=im,
                    power=power, filterbank=mel, log=logmel, dct=cep,
                    cepstra=cep[..., : cfg.nceptrums])


@contextlib.contextmanager
def profile_trace(logdir: str = "/tmp/mfcc_jax_trace"):
    """jax.profiler trace context -- the LiteScope equivalent.  View with
    tensorboard/xprof."""
    jax.profiler.start_trace(logdir)
    try:
        yield logdir
    finally:
        jax.profiler.stop_trace()
