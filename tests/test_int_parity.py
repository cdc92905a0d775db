"""JAX INT path vs the exact fixed-point oracle (element-exact), and the
oracle vs external references where those exist."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from mfcc_jax import MFCC, MFCCConfig
from mfcc_jax.ref import int_ref
from mfcc_jax.ops import int_ops, framing


CFG = MFCCConfig()


def _sig(audio_int16):
    return audio_int16.astype(np.int64)


def test_oracle_fft_vs_scipy_scaling(audio_int16):
    """The INT FFT approximates fft(x)/N with per-stage rounding; the
    reference's own bench cross-checks against scipy fft // 512
    (mfcc/misc/fft.py:492-496).  Error stays within a few LSB."""
    x = np.zeros(512, dtype=np.int64)
    x[: len(audio_int16)] = audio_int16[:512]
    wr, wi = int_ref.fft_int(x)
    ref = np.fft.fft(x.astype(np.float64)) / 512
    err = np.abs((wr + 1j * wi) - ref)
    assert err.max() < 3.0


def test_oracle_dct_matches_scipy_shape(audio_int16):
    """INT DCT-II via 4N FFT tracks scipy dct(x)/(2*4N)*4N... the reference
    bench compares against scipy dct // 64 for N=16 (dct_stream.py:127-141).
    For N=32 the 128-pt FFT scales by 1/128 and the DCT trick doubles
    amplitude: out ~ dct(x, norm=None)/256 * 2 = dct/128."""
    import scipy.fft
    x = (audio_int16[:32].astype(np.int64) >> 2)
    got = int_ref.dct_int(x)
    want = scipy.fft.dct(x.astype(np.float64), type=2) / 128.0
    assert np.abs(got - want).max() < 4.0


def test_jax_int_pipeline_exact(audio_int16):
    sig = _sig(audio_int16)
    want = int_ref.mfcc_int(sig, CFG)
    got = np.asarray(MFCC(CFG).int(sig))
    assert want.shape == got.shape == (5, 32)
    assert np.array_equal(want, got)


def test_jax_int_pipeline_exact_reference_wav(reference_wav):
    sig = reference_wav[: 512 + 4 * 170].astype(np.int64)
    want = int_ref.mfcc_int(sig, CFG)
    got = np.asarray(MFCC(CFG).int(sig))
    assert np.array_equal(want, got)


def test_jax_int_stages_exact(audio_int16):
    """Element-exact per-stage parity on adversarial random data (full
    int16 range, exercising wraparound)."""
    rng = np.random.default_rng(99)
    frames = rng.integers(-32768, 32768, size=(4, 512)).astype(np.int64)

    with jax.enable_x64():
        f32 = jnp.asarray(frames, jnp.int32)

        w_np = int_ref.window_int(frames)
        w_jx = np.asarray(jax.jit(int_ops.window_int)(f32))
        assert np.array_equal(w_np, w_jx)

        re_np, im_np = int_ref.fft_stream_int(w_np)
        re_jx, im_jx = jax.jit(int_ops.fft_stream_int)(jnp.asarray(w_np, jnp.int32))
        assert np.array_equal(re_np, np.asarray(re_jx))
        assert np.array_equal(im_np, np.asarray(im_jx))

        p_np = int_ref.power_int(re_np, im_np)
        p_jx = np.asarray(jax.jit(int_ops.power_int)(
            jnp.asarray(re_np, jnp.int32), jnp.asarray(im_np, jnp.int32)))
        assert np.array_equal(p_np, p_jx)

        m_np = np.stack([int_ref.filterbank_int(p_np[i]) for i in range(4)])
        m_jx = np.asarray(jax.jit(int_ops.filterbank_int)(
            jnp.asarray(p_np, jnp.int32)))
        assert np.array_equal(m_np, m_jx)

        l_np = int_ref.log2fix_int(m_np)
        l_jx = np.asarray(jax.jit(int_ops.log2fix_int)(
            jnp.asarray(m_np, jnp.int32)))
        assert np.array_equal(l_np, l_jx)

        d_np = int_ref.dct_int(l_np)
        d_jx = np.asarray(jax.jit(int_ops.dct_int)(
            jnp.asarray(l_np, jnp.int32)))
        assert np.array_equal(d_np, d_jx)


def test_log2fix_known_values():
    """log2(2^k) = k * 2^11 exactly; Q4.11 with zero LSB."""
    vals = np.array([1, 2, 4, 1024, 32768, 0, 3])
    out = int_ref.log2fix_int(vals)
    assert out[0] == 0
    assert out[1] == 1 << 11
    assert out[2] == 2 << 11
    assert out[3] == 10 << 11
    assert out[4] == 15 << 11
    assert out[5] == 0          # zero clamps to 1 (log.py:123-126)
    # log2(3) = 1.585 -> 3246.08; LSB is never emitted (loop stops at cnt==0)
    assert out[6] % 2 == 0
    assert abs(out[6] - 1.584962 * 2048) < 4


def test_preemphasis_int_wraps():
    x = np.array([32767, -32768, 32767, 0], dtype=np.int64)
    want = int_ref.preemphasis_int(x)
    got = np.asarray(framing.preemphasis_int(jnp.asarray(x, jnp.int32)))
    assert np.array_equal(want, got)


@pytest.mark.parametrize("nfft", [256, 512, 1024])
def test_filterbank_int32_equals_int64(nfft):
    """The x64-free limb filterbank equals the int64 accumulator on random
    power values across the full 30-bit range, extremes included."""
    cfg = MFCCConfig(nfft=nfft)
    args = (cfg.samplerate, cfg.nfft, cfg.nfilters, cfg.filter_wsize,
            cfg.filter_gain, 16, cfg.power_width)
    rng = np.random.default_rng(nfft)
    power = rng.integers(0, 1 << 30, size=(6, nfft // 2)).astype(np.int64)
    power[0] = 0
    power[1] = (1 << 30) - 1
    with jax.enable_x64():
        want = np.asarray(jax.jit(lambda p: int_ops.filterbank_int(p, *args))(
            jnp.asarray(power)))
    got = np.asarray(jax.jit(lambda p: int_ops.filterbank_int32(p, *args))(
        jnp.asarray(power, jnp.int32)))
    assert np.array_equal(want, got)


def test_filterbank_int32_is_one_matmul():
    """Every limb pair goes through a single dot_general: per-pair matmuls
    that share operands get merged by XLA's GPU backend into one GEMM with
    a concatenated prologue, which returned wrong rows in some runs on an
    H100."""
    power = jnp.zeros((3, 256), jnp.int32)
    jaxpr = jax.make_jaxpr(int_ops.filterbank_int32)(power).jaxpr
    dots = [e for e in jaxpr.eqns if e.primitive.name == "dot_general"]
    assert len(dots) == 1
    rhs, pairs, _ = int_ops._fb_limb_operator(16000, 512, 32, 30, 18, 16, 30)
    assert len(pairs) == 15 and rhs.shape == (4 * 256, 15 * 32)


@pytest.mark.gpu
def test_int_batch_repeatable_on_gpu(gpu_device):
    """Repeated runs of one compiled INT batch on the card all equal the
    CPU backend's result (the per-pair matmul form failed this on an H100
    in 7 of 40 runs)."""
    rng = np.random.default_rng(7)
    audio = rng.integers(-12000, 12000, size=(1024, 4096)).astype(np.int32)
    fe = MFCC(CFG)
    want = np.asarray(fe._int_jit(jax.device_put(audio, jax.devices("cpu")[0])))
    x = jax.device_put(audio, gpu_device)
    for _ in range(10):
        assert np.array_equal(np.asarray(fe.int(x)), want)
