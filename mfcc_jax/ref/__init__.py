"""Pure-numpy reference oracles.

``float_ref`` ports the executable float spec (notebook/MFCC-INT.ipynb);
``int_ref`` ports the RTL's exact fixed-point arithmetic (mfcc/core/*,
mfcc/misc/fft.py).  Everything in mfcc_jax.ops / mfcc_jax.pipeline is tested
against these.
"""

from . import float_ref, int_ref  # noqa: F401
