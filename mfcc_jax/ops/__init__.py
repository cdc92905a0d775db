"""Compute ops (plain JAX; XLA compiles them for the device).

``float_ops``    -- the float pipeline as matmuls + fused elementwise ops.
``int_ops``      -- the bit-exact fixed-point pipeline, vectorized int32/int64.
``framing``      -- pre-emphasis + overlapped frame extraction (shared).
``df32``         -- compensated double-f32 accuracy mode (lazy import).
"""

from . import framing, float_ops, int_ops  # noqa: F401
