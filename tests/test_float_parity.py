"""JAX float path vs the float64 numpy oracle (the notebooks' executable
spec), plus internal consistency between the DFT-matmul and rfft methods."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from mfcc_jax import MFCC, MFCCConfig
from mfcc_jax.ref import float_ref
from mfcc_jax.ops import float_ops

CFG = MFCCConfig()

# f32 accuracy vs float64 on real speech-scale signals: the absolute error
# is dominated by the spectral dynamic range hitting log2 at quiet mel bins.
F32_TOL = 5e-4


def test_float_pipeline_vs_oracle(audio_int16):
    want = float_ref.mfcc_float(audio_int16, CFG)
    got = np.asarray(MFCC(CFG)(jnp.asarray(audio_int16)))
    assert want.shape == got.shape == (5, 32)
    assert np.abs(want - got).max() < F32_TOL


def test_float_pipeline_vs_oracle_reference_wav(reference_wav):
    sig = reference_wav[: 512 + 4 * 170]
    want = float_ref.mfcc_float(sig, CFG)
    got = np.asarray(MFCC(CFG)(jnp.asarray(sig)))
    assert np.abs(want - got).max() < F32_TOL


def test_dft_and_rfft_methods_agree(audio_int16):
    a = np.asarray(MFCC(CFG, method="dft")(jnp.asarray(audio_int16)))
    b = np.asarray(MFCC(CFG, method="rfft")(jnp.asarray(audio_int16)))
    assert np.abs(a - b).max() < F32_TOL


def test_intermediates_shapes(audio_int16):
    inter = MFCC(CFG).intermediates(jnp.asarray(audio_int16))
    assert inter["frames"].shape == (5, 512)
    assert inter["power"].shape == (5, 257)
    assert inter["filterbank"].shape == (5, 32)
    assert inter["cepstra"].shape == (5, 32)


def test_partial_extractors(audio_int16):
    from mfcc_jax.ops import framing
    import jax
    x = jnp.asarray(audio_int16, jnp.float32)
    frames = framing.extract_frames(framing.preemphasis(x), CFG.nfft, CFG.hop)
    logmel = np.asarray(jax.jit(float_ops.log_mel_frames)(frames))
    _, inter = float_ref.mfcc_float(audio_int16, CFG, return_intermediates=True)
    assert np.abs(logmel - np.log2(inter["mel"])).max() < F32_TOL


def test_batch_of_streams(audio_int16):
    """Leading stream axis maps transparently."""
    batch = np.stack([audio_int16, audio_int16[::-1]])
    got = np.asarray(MFCC(CFG)(jnp.asarray(batch)))
    assert got.shape == (2, 5, 32)
    single = np.asarray(MFCC(CFG)(jnp.asarray(batch[1])))
    assert np.abs(got[1] - single).max() < 1e-5


def test_f64ish_meets_1e5_target(audio_int16):
    """Compensated double-f32 mode (ops/df32.py): <=1e-5 max-abs-err vs the
    float64 oracle WITHOUT f64 hardware support -- the BASELINE.md accuracy
    north star, met on the ambient backend (the CPU here; chip_smoke.py
    checks it on the GPU)."""
    import jax
    sig = audio_int16.astype(np.float32)
    want = float_ref.mfcc_float(sig.astype(np.float64), CFG)
    got = np.asarray(jax.jit(
        lambda a: float_ops.mfcc_batch(a, CFG, precision="f64ish"))(
            jnp.asarray(sig[None])))[0]
    assert np.abs(got - want).max() <= 1e-5


def test_f64ish_arbitrary_scale(audio_int16):
    """wire_grid=False generalizes f64ish beyond the 2^-5 wire grid
    (ROADMAP item 5): librosa-style [-1, 1] audio and a 2^20-scaled copy
    both meet the 1e-5 gate vs a float64 oracle of the SAME values --
    an exact power-of-two renormalization (c0 restored analytically) plus
    the dynamically-chosen limb grid + exact-residual DFT
    (df32._limb_matmul_auto) replace the static-grid assumption.  Gate:
    1e-5 OR two f32 ulps of the true value, elementwise -- a coefficient
    |v| > ~168 (c0 at extreme scales) cannot beat ulp(v)/2 in an f32
    output no matter the algorithm (measured: non-c0 error is a
    scale-invariant ~5e-6; c0 reaches ~1.3 ulp of itself at 2^20)."""
    import jax
    from mfcc_jax.ops import df32
    fn = jax.jit(lambda a: df32.mfcc_batch_f64ish(a, CFG, wire_grid=False))
    for scale in (1.0 / 32768.0, 2.0 ** 20):
        sig = (audio_int16 * scale).astype(np.float32)
        want = float_ref.mfcc_float(sig.astype(np.float64), CFG)
        got = np.asarray(fn(jnp.asarray(sig[None])))[0]
        tol = np.maximum(
            1e-5, 2 * np.spacing(np.abs(want).astype(np.float32)))
        assert (np.abs(got - want) <= tol).all(), scale


def test_f64ish_reference_wav(reference_wav):
    import jax
    real = reference_wav[: 512 + 90 * 170].astype(np.float32)
    want = float_ref.mfcc_float(real.astype(np.float64), CFG)
    got = np.asarray(jax.jit(
        lambda a: float_ops.mfcc_batch(a, CFG, precision="f64ish"))(
            jnp.asarray(real[None])))[0]
    assert np.abs(got - want).max() <= 1e-5


def test_split_matmul_accuracy():
    """The XLA-level double-word matmul survives excess-precision flags
    (mantissa masking, not casts)."""
    from mfcc_jax.ops.float_ops import split_matmul
    rng = np.random.default_rng(0)
    a = jnp.asarray(rng.standard_normal((64, 512)).astype(np.float32) * 1e4)
    b = jnp.asarray(rng.standard_normal((512, 128)).astype(np.float32))
    want = np.asarray(a, np.float64) @ np.asarray(b, np.float64)
    got = np.asarray(jax.jit(split_matmul)(a, b))
    rel = np.abs(got - want) / np.abs(want).max()
    # 2x-bf16 double-word keeps ~16 mantissa bits: ~1e-5 relative.
    # Raw bf16 would be ~3e-3; Precision.HIGHEST is ~1e-7.
    assert rel.max() < 2e-5


def test_segmented_matches_oracle(audio_int16):
    """The segmented (no-gather) formulation vs float64 oracle -- works on
    any backend."""
    from mfcc_jax.ops import float_ops
    import functools
    want = float_ref.mfcc_float(audio_int16, CFG)
    fn = jax.jit(functools.partial(float_ops.mfcc_batch, cfg=CFG,
                                   method="segmented"))
    got = np.asarray(fn(jnp.asarray(audio_int16, jnp.float32)))
    assert np.abs(want - got).max() < 5e-4
