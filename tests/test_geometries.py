"""Frame geometries through the public entry points, against the oracles.

The reference core is parameterized over a power-of-two FFT family and any
frame step (mfcc/core/mfcc.py:20-21,43; misc/fft.py:349-380).  Each geometry
below runs through ``MFCC`` (float, 5e-4 vs the float64 oracle), ``MFCC.int``
(element-exact vs the RTL oracle), the pre-framed entries ``MFCC.frames`` /
``MFCC.int_frames``, and ``StreamingMFCC`` (chunked == batch).
"""

import numpy as np
import jax.numpy as jnp
import pytest

from mfcc_jax import MFCC, MFCCConfig
from mfcc_jax.ops import framing
from mfcc_jax.ref import float_ref, int_ref
from mfcc_jax.streaming import StreamingMFCC

GATE = 5e-4

GEOMETRIES = {
    "nfft256-hop84": MFCCConfig(nfft=256, step=84),
    "nfft256-hop85": MFCCConfig(nfft=256),
    "nfft512-hop171": MFCCConfig(step=171),
    "nfft1024-hop340": MFCCConfig(nfft=1024, step=340),
    "nfft1024-hop341": MFCCConfig(nfft=1024),
}
IDS = list(GEOMETRIES)


def _signal(cfg, n_frames=6, seed=0):
    """int16 chirp + tone + noise covering ``n_frames`` frames plus a
    partial one."""
    rng = np.random.default_rng(seed)
    T = cfg.nfft + (n_frames - 1) * cfg.hop + cfg.hop // 2
    t = np.arange(T) / 16000.0
    sig = (9000 * np.sin(2 * np.pi * (200 + 3000 * t) * t)
           + 4000 * np.sin(2 * np.pi * 1200 * t)
           + rng.integers(-1500, 1500, T))
    return np.clip(sig, -32768, 32767).astype(np.int16)


@pytest.fixture(params=IDS)
def geometry(request):
    cfg = GEOMETRIES[request.param]
    return cfg, _signal(cfg)


def test_float_batch_vs_oracle(geometry):
    cfg, sig = geometry
    want = float_ref.mfcc_float(sig.astype(np.float64), cfg)
    got = np.asarray(MFCC(cfg)(sig.astype(np.float32)))
    assert got.shape == want.shape == (cfg.n_frames(len(sig)),
                                       cfg.nceptrums)
    assert np.abs(want - got).max() < GATE


def test_int_batch_exact(geometry):
    cfg, sig = geometry
    want = int_ref.mfcc_int(sig.astype(np.int64), cfg)
    got = np.asarray(MFCC(cfg).int(sig))
    assert got.shape == want.shape and np.array_equal(want, got)


def test_frames_entries_match_batch(geometry):
    """The pre-framed entries (what a caller with its own framing uses)
    equal the batch path on the same frames."""
    cfg, sig = geometry
    fe = MFCC(cfg)
    x = jnp.asarray(sig, jnp.float32)
    frames = framing.extract_frames(framing.preemphasis(x), cfg.nfft,
                                    cfg.hop)
    want_f = float_ref.mfcc_float(sig.astype(np.float64), cfg)
    assert np.abs(np.asarray(fe.frames(frames)) - want_f).max() < GATE
    xi = jnp.asarray(sig, jnp.int32)
    iframes = framing.extract_frames(
        framing.preemphasis_int(xi, width=cfg.width), cfg.nfft, cfg.hop)
    assert np.array_equal(np.asarray(fe.int_frames(iframes)),
                          int_ref.mfcc_int(sig.astype(np.int64), cfg))


@pytest.mark.parametrize("int_path", [False, True], ids=["float", "int"])
def test_streaming_chunked_equals_batch(geometry, int_path):
    """An odd chunk width that never divides the hop: chunked output equals
    the oracle (INT exact, float within the gate)."""
    cfg, sig = geometry
    sm = StreamingMFCC(cfg, int_path=int_path)
    C = cfg.hop + 37
    outs, _ = sm.process(sig[None], chunk_size=C)
    got = outs[0]
    if int_path:
        want = int_ref.mfcc_int(sig.astype(np.int64), cfg)
        assert np.array_equal(got, want)
    else:
        want = float_ref.mfcc_float(sig.astype(np.float64), cfg)
        assert got.shape == want.shape
        assert np.abs(got - want).max() < GATE


def test_mel_floor(geometry):
    """mel_floor=1 clamps the mel energies before log2 exactly like the
    oracle with the same clamp, and makes digital silence finite (the RTL's
    0 -> 1 clamp, mfcc/core/log.py:123-126)."""
    import scipy.fft
    cfg, sig = geometry
    fe = MFCC(cfg, mel_floor=1.0)
    _, inter = float_ref.mfcc_float(sig.astype(np.float64), cfg,
                                    return_intermediates=True)
    want = scipy.fft.dct(np.log2(np.maximum(inter["mel"], 1.0)), type=2,
                         norm="ortho", axis=-1)[:, :cfg.nceptrums]
    assert np.abs(np.asarray(fe(sig.astype(np.float32))) - want).max() < GATE
    silent = np.zeros_like(sig, dtype=np.float32)
    assert np.isfinite(np.asarray(fe(silent))).all()
    assert not np.isfinite(np.asarray(MFCC(cfg)(silent))).all()
