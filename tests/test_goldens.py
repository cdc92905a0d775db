"""Golden-recipe pinning (round-1 VERDICT item 6).

The reference's goldens come from real librosa (software/genlibrosa.py:14-28).
librosa is absent here, so the committed fixtures were generated from an
INDEPENDENT implementation -- transformers.audio_utils (HuggingFace's numpy
port of the same librosa conventions) + scipy's DCT -- by
tests/fixtures/make_goldens.py.  These tests pin mfcc_jax's recipe to those
arrays so drift is caught without librosa; the live cross-check against
transformers runs too (it is baked into this environment).
(numpy-only -- no device compiles)"""

import os

import numpy as np
import pytest

from mfcc_jax.compat import librosa_mfcc as lr

HERE = os.path.dirname(os.path.abspath(__file__))
FIX = os.path.join(HERE, "fixtures")


@pytest.fixture(scope="module")
def goldens():
    return np.load(os.path.join(FIX, "librosa_goldens.npz"))


def test_recipe_matches_committed_goldens(reference_wav, goldens):
    """compat.librosa_mfcc reproduces the independently-generated fixture
    to float precision, and the int16 file formats byte-for-byte."""
    assert len(reference_wav) == int(goldens["n_samples"])
    spec = lr.mfcc(reference_wav, sr=int(goldens["sr"]), hop=170, n_mfcc=32)
    assert spec.shape == goldens["spec"].shape
    assert np.abs(spec - goldens["spec"]).max() < 1e-5     # dB scale

    scale = lr.sklearn_scale(spec, axis=1)
    assert np.abs(scale - goldens["scale"]).max() < 1e-5

    # the .spec/.sklearn int16 artifacts (genlibrosa.py:27-28) must be
    # byte-identical to the committed files
    want_spec = np.fromfile(os.path.join(FIX, "f2bjrop1.0.spec"), np.int16)
    want_skl = np.fromfile(os.path.join(FIX, "f2bjrop1.0.sklearn"), np.int16)
    assert np.array_equal(spec.astype(np.int16).ravel(), want_spec)
    assert np.array_equal(scale.astype(np.int16).ravel(), want_skl)


def test_recipe_matches_transformers_live(reference_wav):
    """Live cross-check against the independent implementation (not this
    repo's code): transformers.audio_utils + scipy DCT."""
    pytest.importorskip("transformers")
    import sys
    sys.path.insert(0, FIX)
    try:
        from make_goldens import independent_mfcc
    finally:
        sys.path.pop(0)
    y = reference_wav[:16000].astype(np.float64) / 32768.0
    want = independent_mfcc(y, 16000)
    got = lr.mfcc(reference_wav[:16000], sr=16000, hop=170, n_mfcc=32)
    assert np.abs(want - got).max() < 1e-5


def test_goldens_cli_writes_fixture_format(reference_wav, tmp_path):
    """`cli goldens` writes .spec/.sklearn files identical to the fixtures
    when pointed at the reference wav."""
    import shutil
    from mfcc_jax.cli import main
    wav = tmp_path / "f2bjrop1.0.wav"
    shutil.copy("/root/reference/f2bjrop1.0.wav", wav)
    assert main(["goldens", str(tmp_path)]) == 0
    got = np.fromfile(tmp_path / "f2bjrop1.0.spec", np.int16)
    want = np.fromfile(os.path.join(FIX, "f2bjrop1.0.spec"), np.int16)
    assert np.array_equal(got, want)
    got2 = np.fromfile(tmp_path / "f2bjrop1.0.sklearn", np.int16)
    want2 = np.fromfile(os.path.join(FIX, "f2bjrop1.0.sklearn"), np.int16)
    assert np.array_equal(got2, want2)
