"""Host layer: native wav decode, transport protocols, goldens tooling.
(numpy-only -- no device compiles)"""

import os

import numpy as np
import pytest

from mfcc_jax.io import native, wav, transport
from mfcc_jax.compat import librosa_mfcc as lr


def test_native_builds():
    assert native.available(), "native lib should build in this environment"


def test_native_wav_rejects_malformed(tmp_path):
    """Round-1 ADVICE (medium): bits in 1..7 must be rejected before the
    bytes-per-sample division (SIGFPE), and a huge declared data-chunk size
    must be clamped to the actual file size, not allocated."""
    import struct

    def wav_bytes(bits, data_cksize, payload=b""):
        fmt = struct.pack("<HHIIHH", 1, 1, 16000, 16000 * max(bits // 8, 1),
                          max(bits // 8, 1), bits)
        body = (b"fmt " + struct.pack("<I", len(fmt)) + fmt +
                b"data" + struct.pack("<I", data_cksize) + payload)
        return b"RIFF" + struct.pack("<I", 4 + len(body)) + b"WAVE" + body

    p1 = tmp_path / "bits4.wav"
    p1.write_bytes(wav_bytes(4, 8, b"\x00" * 8))
    with pytest.raises(IOError):          # must error, not crash the process
        native.wav_read(str(p1))

    p2 = tmp_path / "hugechunk.wav"       # declares ~4 GiB, holds 8 bytes
    p2.write_bytes(wav_bytes(16, 0xFFFFFFF0, b"\x01\x00\x02\x00" * 2))
    s, r = native.wav_read(str(p2))       # clamped to the 4 real samples
    assert list(s) == [1, 2, 1, 2] and r == 16000


def test_native_wav_matches_scipy(reference_wav):
    s, r = native.wav_read("/root/reference/f2bjrop1.0.wav")
    assert r == 16000
    assert np.array_equal(s, reference_wav)


def test_batch_loader(reference_wav):
    paths = ["/root/reference/f2bjrop1.0.wav"] * 3
    mat, lengths, rates = wav.read_batch(paths, 5000)
    assert mat.shape == (3, 5000)
    assert (lengths == 5000).all() and (rates == 16000).all()
    assert np.array_equal(mat[2], reference_wav[:5000])


def test_wav_fallback_matches_native(reference_wav):
    a, ra = wav.read("/root/reference/f2bjrop1.0.wav", prefer_native=True)
    b, rb = wav.read("/root/reference/f2bjrop1.0.wav", prefer_native=False)
    assert ra == rb and np.array_equal(a, b)


def test_stream_words_roundtrip():
    samples = np.array([0, 1, -1, 32767, -32768, 123], np.int16)
    words = transport.encode_stream(samples, reset_first=True)
    assert words[0] == 0x80000000
    got, resets, trailing = transport.decode_stream(words)
    assert np.array_equal(got, samples)
    assert resets[0] and not resets[1:].any() and not trailing
    # mid-stream reset
    w2 = np.concatenate([words[1:3], [np.uint32(0x80000000)], words[3:]])
    got2, resets2, t2 = transport.decode_stream(w2)
    assert np.array_equal(got2, samples)
    assert resets2.tolist() == [False, False, True, False, False, False]
    assert not t2
    # a trailing / lone reset word must be reported, not dropped
    _, _, t3 = transport.decode_stream(np.array([0x80000000], np.uint32))
    assert t3
    s4, r4, t4 = transport.decode_stream(
        np.concatenate([words[1:3], [np.uint32(0x80000000)]]))
    assert len(s4) == 2 and not r4.any() and t4


def test_split_resets():
    s = np.arange(10, dtype=np.int16)
    r = np.zeros(10, bool)
    r[[0, 4]] = True
    segs = transport.split_resets(s, r, trailing_reset=True)
    assert [(seg.tolist(), rf) for seg, rf in segs] == [
        ([0, 1, 2, 3], True), ([4, 5, 6, 7, 8, 9], True), ([], True)]
    segs2 = transport.split_resets(s, np.zeros(10, bool))
    assert len(segs2) == 1 and not segs2[0][1] \
        and np.array_equal(segs2[0][0], s)


def test_framed_features_roundtrip_and_resync():
    rng = np.random.default_rng(5)
    cep = rng.integers(-32768, 32768, (7, 16)).astype(np.int16)
    for native_pref in (True, False):
        enc = transport.encode_frames(cep, prefer_native=native_pref)
        # inject garbage prefix + truncated tail: decoder must resync
        noisy = b"\x00\xa5\x00" + enc + b"\xa5\x5a\x01"
        dec, consumed = transport.decode_frames(noisy, 16,
                                                prefer_native=native_pref)
        assert np.array_equal(dec, cep)
        assert consumed <= len(noisy) - 3  # incomplete frame left unconsumed
    # native and python encodings are byte-identical
    assert transport.encode_frames(cep, True) == transport.encode_frames(cep, False)


def test_librosa_recipe_sanity(reference_wav):
    """Shape/stability checks of the golden recipe; exact parity is asserted
    against real librosa when importable."""
    sig = reference_wav[:16000]
    M = lr.mfcc(sig, sr=16000, hop=170, n_mfcc=32)
    assert M.shape == (32, 1 + 16000 // 170)
    assert np.isfinite(M).all()
    # c0 of a loud signal is strongly negative-to-positive dB scale value
    assert np.abs(M).max() < 2000

    sc = lr.sklearn_scale(M)
    assert np.allclose(sc.mean(axis=1), 0, atol=1e-9)
    assert np.allclose(sc.std(axis=1), 1, atol=1e-9)


def test_librosa_exact_if_available(reference_wav):
    librosa = pytest.importorskip("librosa")
    sig = reference_wav[:16000].astype(np.float32) / 32768.0
    want = librosa.feature.mfcc(y=sig, sr=16000, hop_length=170, n_mfcc=32)
    got = lr.mfcc(sig, sr=16000, hop=170, n_mfcc=32)
    assert np.abs(want - got).max() < 1e-6


def test_mel_filterbank_properties():
    fb = lr.mel_filterbank(16000, 2048, 128)
    assert fb.shape == (128, 1025)
    assert (fb >= 0).all()
    # every filter has support; slaney norm keeps areas equalized
    assert (fb.sum(axis=1) > 0).all()


def test_walk_wavs(tmp_path):
    (tmp_path / "a").mkdir()
    for name in ["a/x.wav", "a/y.WAV", "z.wav", "skip.txt"]:
        (tmp_path / name).write_bytes(b"")
    found = wav.walk_wavs(str(tmp_path))
    assert [os.path.basename(p) for p in found] == ["x.wav", "y.WAV", "z.wav"]
