"""Public batch API: the flagship MFCC feature extractor.

Replaces the reference's top-level ``MFCC`` Elaboratable + host protocol
(mfcc/core/mfcc.py:19-117, software/main.c) with two jit-compiled batch
transforms over (streams, samples) arrays:

  * ``MFCC.float_path``  -- the float spec (notebook MFCC-INT.ipynb),
    matmul formulation, bf16/f32 selectable.
  * ``MFCC.int_path``    -- bit-exact RTL fixed-point parity (int32/int64).

Both paths vmap/shard trivially over streams and frames; see
mfcc_jax.parallel for multi-chip sharding and mfcc_jax.streaming for the
stateful chunked API.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from .config import MFCCConfig
from .ops import float_ops, int_ops, framing


class MFCC:
    """Batched MFCC front-end.

    >>> fe = MFCC()                       # defaults = wav2mfcc target config
    >>> cep = fe(audio_batch)             # float path, (S, T) -> (S, F, 32)
    >>> cep_int = fe.int(audio_batch)     # bit-exact INT path
    """

    def __init__(self, cfg: MFCCConfig = MFCCConfig(), *,
                 method: str = "dft", precision: str = "highest",
                 dtype=jnp.float32, mel_floor: float = 0.0):
        """``precision`` is the accuracy dial (plus the raw matmul-precision
        names float_ops accepts):

          * ``"highest"`` (default) -- the 5e-4 float contract: every f32
            matmul at ``Precision.HIGHEST`` (true f32, never TF32).
          * ``"fast"`` -- currently the same chain as ``"highest"``: it
            names a speed/accuracy trade that no path implements yet, and
            is never LESS accurate than asked.
          * ``"f64ish"`` -- compensated-f32 double-word arithmetic,
            <=1e-5-class accuracy (ops/df32.py).

        The dial mirrors the reference's injectable ``multiplier_cls``
        configurability (mfcc/core/mfcc.py:62-82)."""
        self.cfg = cfg
        self.method = method
        self.precision = precision
        self.dtype = dtype
        self.mel_floor = mel_floor
        if precision == "fast":
            precision = "highest"
        opts = dict(cfg=cfg, method=method, precision=precision, dtype=dtype,
                    mel_floor=mel_floor)
        self._float_jit = jax.jit(functools.partial(float_ops.mfcc_batch,
                                                    **opts))
        self._float_frames_jit = jax.jit(functools.partial(
            float_ops.mfcc_frames, **opts))
        # the INT path is x64-free for the reference config family; exotic
        # filterbank layouts fall back to the int64 (x64) filterbank
        self._int_needs_x64 = not int_ops._fb_int32_layout_ok(cfg)
        with self._x64_ctx():
            self._int_jit = jax.jit(functools.partial(int_ops.mfcc_int_batch,
                                                      cfg=cfg))
            self._int_frames_jit = jax.jit(functools.partial(
                int_ops.mfcc_int_frames, cfg=cfg))

    def _x64_ctx(self):
        import contextlib
        return (jax.enable_x64() if self._int_needs_x64
                else contextlib.nullcontext())

    # -- float path ----------------------------------------------------------

    def __call__(self, audio: jnp.ndarray) -> jnp.ndarray:
        """(..., T) raw samples -> (..., F, nceptrums) float cepstra."""
        return self._float_jit(jnp.asarray(audio))

    def frames(self, frames: jnp.ndarray) -> jnp.ndarray:
        """(..., F, nfft) pre-emphasized frames -> (..., F, nceptrums)."""
        return self._float_frames_jit(jnp.asarray(frames))

    # -- INT path (bit-exact RTL parity) --------------------------------------

    def int(self, audio) -> jnp.ndarray:
        """(..., T) int16-range samples -> (..., F, nceptrums) int32 cepstra,
        element-exact vs the RTL fixed-point pipeline."""
        with self._x64_ctx():
            return self._int_jit(jnp.asarray(audio, dtype=jnp.int32))

    def int_frames(self, frames) -> jnp.ndarray:
        with self._x64_ctx():
            return self._int_frames_jit(jnp.asarray(frames, dtype=jnp.int32))

    # -- debug / observability -------------------------------------------------

    def intermediates(self, audio) -> dict:
        """All 8 stage outputs of the float path (the ``gen_collector`` debug
        pattern, mfcc/core/mfcc.py:128-141, as a returned pytree)."""
        from .utils.debug import float_intermediates
        return float_intermediates(jnp.asarray(audio), self.cfg,
                                   dtype=self.dtype)


def n_frames(cfg: MFCCConfig, n_samples: int) -> int:
    return cfg.n_frames(n_samples)
