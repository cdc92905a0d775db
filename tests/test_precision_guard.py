"""No float32 matmul on the float paths runs at DEFAULT precision.

On an NVIDIA card an f32 matmul at DEFAULT precision may run in TF32, which
keeps ~10 mantissa bits: measured on an H100, the default-config float path
then misses the 5e-4 gate by three orders of magnitude.  Every f32
``dot_general`` the float paths trace must ask for ``Precision.HIGHEST``.
The walk is over the traced jaxpr, so it holds whatever backend runs it.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mfcc_jax import MFCC, MFCCConfig
from mfcc_jax import models
from mfcc_jax.ops import float_ops
from mfcc_jax.streaming import StreamingMFCC, init_state
from mfcc_jax.utils import debug

CFG = MFCCConfig()
T = CFG.nfft + 4 * CFG.hop


def _subjaxprs(params):
    for v in params.values():
        for item in (v if isinstance(v, (tuple, list)) else (v,)):
            if hasattr(item, "eqns"):
                yield item
            elif hasattr(item, "jaxpr") and hasattr(item.jaxpr, "eqns"):
                yield item.jaxpr


def f32_dots(jaxpr):
    """(lhs dtype, rhs dtype, precision) of every dot_general, recursively."""
    out = []
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "dot_general":
            lhs, rhs = (v.aval.dtype for v in eqn.invars)
            out.append((lhs, rhs, eqn.params.get("precision")))
        for sub in _subjaxprs(eqn.params):
            out.extend(f32_dots(sub))
    return out


def _is_highest(precision):
    if precision is None:
        return False
    ps = precision if isinstance(precision, tuple) else (precision,)
    return all(p == jax.lax.Precision.HIGHEST for p in ps)


def _audio(n=T):
    return jnp.asarray(np.random.default_rng(0).integers(-3000, 3000, (2, n)),
                       jnp.float32)


FLOAT_PATHS = {
    "MFCC": lambda: MFCC(CFG)._float_jit,
    "MFCC-rfft": lambda: MFCC(CFG, method="rfft")._float_jit,
    "MFCC-segmented": lambda: MFCC(CFG, method="segmented")._float_jit,
    "MFCC-fast": lambda: MFCC(CFG, precision="fast")._float_jit,
    "MFCC-split": lambda: MFCC(CFG, precision="split")._float_jit,
    "MFCC-mel_floor": lambda: MFCC(CFG, mel_floor=1.0)._float_jit,
    "MFCCFeatures": lambda: models.MFCCFeatures(CFG)._fn,
    "MelSpectrogram": lambda: models.MelSpectrogram(CFG)._fn,
    "LogMelSpectrogram": lambda: models.LogMelSpectrogram(CFG)._fn,
    "Spectrogram": lambda: models.Spectrogram(CFG)._fn,
    "LibrosaMFCC": lambda: models.LibrosaMFCC()._fn,
    "float_intermediates": lambda: functools.partial(
        debug.float_intermediates, cfg=CFG),
}


@pytest.mark.parametrize("name", list(FLOAT_PATHS))
def test_no_default_precision_f32_matmul(name):
    jaxpr = jax.make_jaxpr(FLOAT_PATHS[name]())(_audio()).jaxpr
    dots = f32_dots(jaxpr)
    f32 = [d for d in dots if jnp.float32 in d[:2]]
    assert f32, f"{name}: expected f32 matmuls in the trace"
    bad = [d for d in f32 if not _is_highest(d[2])]
    assert not bad, f"{name}: f32 dot_general below HIGHEST: {bad}"


def test_streaming_step_float_matmuls_are_highest():
    sm = StreamingMFCC(CFG)
    chunks = _audio(1024)
    state = init_state(2, CFG)
    jaxpr = jax.make_jaxpr(
        lambda c, s: sm._step(c, s, jnp.zeros((2,), bool), None))(
            chunks, state).jaxpr
    f32 = [d for d in f32_dots(jaxpr) if jnp.float32 in d[:2]]
    assert f32 and all(_is_highest(d[2]) for d in f32)


def test_guard_sees_a_default_precision_matmul():
    """The walk itself: a DEFAULT-precision f32 matmul is reported."""
    fn = functools.partial(float_ops.mfcc_batch, cfg=CFG, precision="default")
    f32 = [d for d in f32_dots(jax.make_jaxpr(fn)(_audio()).jaxpr)
           if jnp.float32 in d[:2]]
    assert f32 and not any(_is_highest(d[2]) for d in f32)
