"""Utility-layer coverage (numpy-only): VAD threshold, lifter formula,
config derived properties, oracle edge behaviors."""

import numpy as np
import pytest

from mfcc_jax import MFCCConfig, MIC_CONFIG, RESET_WORD, MAGIC_WORD
from mfcc_jax.utils.vad import voice_activity_power, has_voice, DEFAULT_THRESHOLD
from mfcc_jax.utils.liftering import lifter
from mfcc_jax.ref import int_ref, float_ref


def test_config_properties():
    cfg = MFCCConfig()
    assert cfg.hop == 170               # nfft//3 (mfcc.py:43)
    assert cfg.windowlen == 512
    assert cfg.nbins == 256 and cfg.nbins_float == 257
    assert cfg.log_precision == 11      # Log2Fix(16,15) -> Q4.11
    assert cfg.n_frames(512) == 1
    assert cfg.n_frames(511) == 0
    assert cfg.n_frames(512 + 170) == 2
    assert MIC_CONFIG.nceptrums == 16
    assert RESET_WORD == 0x80000000 and MAGIC_WORD == 0xA55A


def test_vad_matches_reference_semantics():
    """Sum of c0^2 over the central third (cepstrum.c:168-176)."""
    cep = np.zeros((9, 16), dtype=np.int64)
    cep[:, 0] = np.arange(9) * 1000
    # central third = frames 3,4,5 -> 3000^2 + 4000^2 + 5000^2
    assert int(voice_activity_power(cep)) == 9e6 + 16e6 + 25e6
    assert not has_voice(cep)
    cep[4, 0] = 20000                    # 4e8 > 1e8 threshold
    assert has_voice(cep)
    assert DEFAULT_THRESHOLD == int(1e8)


def test_lifter_formula():
    """1 + (L/2) sin(pi n / L), L=22 (lift.py:12-26)."""
    x = np.ones((2, 32))
    out = lifter(x, L=22)
    n = np.arange(32)
    np.testing.assert_allclose(out[0], 1 + 11 * np.sin(np.pi * n / 22))
    assert lifter(x, L=0) is x           # L<=0 no-op


def test_int_oracle_constant_input():
    """DC input: the filterbank/log/DCT chain stays finite and exact."""
    sig = np.full(512 + 170, 1000, dtype=np.int64)
    out = int_ref.mfcc_int(sig)
    assert out.shape == (2, 32)
    assert np.abs(out).max() < 32768     # int16-range guaranteed by design


def test_int_oracle_impulse():
    sig = np.zeros(512 + 170, dtype=np.int64)
    sig[100] = 32767
    out = int_ref.mfcc_int(sig)
    assert out.shape == (2, 32)
    # an impulse has flat spectrum: power reaches the filterbank, log2 > 0
    assert np.isfinite(out).all()


def test_float_oracle_parseval_sanity(audio_int16):
    """The float spec's spectrum scaling: |fft/N|^2 summed over bins tracks
    signal energy/N (Parseval with the 1/N convention)."""
    _, inter = float_ref.mfcc_float(audio_int16, return_intermediates=True)
    frame0 = inter["win"][0]
    spec0 = inter["spec"][0]
    lhs = (np.abs(spec0[1:-1]) ** 2).sum() * 2 + np.abs(spec0[0]) ** 2 \
        + np.abs(spec0[-1]) ** 2              # sum over all N bins of |fft/N|^2
    rhs = (frame0 ** 2).sum() / 512           # = sum|x|^2 / N (Parseval)
    assert abs(lhs - rhs) / rhs < 1e-9
