"""Model family, serving layer, differentiability, CLI selftest."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from mfcc_jax import MFCCConfig
from mfcc_jax.models import (Spectrogram, MelSpectrogram, LogMelSpectrogram,
                             MFCCFeatures, IntMFCCFeatures, LibrosaMFCC)
from mfcc_jax.ref import float_ref, int_ref

CFG = MFCCConfig()


def _cpu():
    """Server tests exercise protocol/slot semantics; pin the step to the
    host CPU so they need no accelerator (the server on the GPU is
    checked by chip_smoke.py's server phase)."""
    import jax
    return jax.devices("cpu")[0]


def test_model_family_consistency(audio_int16):
    """Each truncation of the pipeline agrees with the full oracle's
    intermediates."""
    _, inter = float_ref.mfcc_float(audio_int16, CFG, return_intermediates=True)
    spec = np.asarray(Spectrogram(CFG)(audio_int16))
    assert spec.shape == (5, 257)
    assert np.abs(spec - inter["power"]).max() / inter["power"].max() < 1e-5

    mel = np.asarray(MelSpectrogram(CFG)(audio_int16))
    assert np.abs(mel - inter["mel"]).max() / inter["mel"].max() < 1e-5

    logmel = np.asarray(LogMelSpectrogram(CFG)(audio_int16))
    assert np.abs(logmel - np.log2(inter["mel"])).max() < 5e-4

    cep = np.asarray(MFCCFeatures(CFG)(audio_int16))
    assert np.abs(cep - float_ref.mfcc_float(audio_int16, CFG)).max() < 5e-4

    icep = np.asarray(IntMFCCFeatures(CFG)(audio_int16.astype(np.int64)))
    assert np.array_equal(icep, int_ref.mfcc_int(audio_int16.astype(np.int64),
                                                 CFG))


def test_librosa_jax_matches_numpy_recipe(audio_int16):
    from mfcc_jax.compat import librosa_mfcc as lr
    want = lr.mfcc(audio_int16, sr=16000, hop=170, n_mfcc=32)
    got = np.asarray(LibrosaMFCC()(audio_int16))
    assert got.shape == want.shape
    assert np.abs(want - got).max() < 2e-2   # f32 vs f64, dB scale


def test_differentiable_front_end(audio_int16):
    """The float pipeline is a trainable front-end: grads flow to the audio
    (and would flow to any learnable filterbank)."""
    from mfcc_jax.ops import float_ops
    x = jnp.asarray(audio_int16[:852], jnp.float32)

    def loss(a):
        cep = float_ops.mfcc_batch(a[None], CFG, mel_floor=1e-6)
        return jnp.sum(cep ** 2)

    g = jax.jit(jax.grad(loss))(x)
    g = np.asarray(g)
    assert g.shape == x.shape
    assert np.isfinite(g).all()
    assert np.abs(g).max() > 0


def test_feature_server_roundtrip(audio_int16):
    """TCP serving: wire-protocol in/out, bit-exact vs the INT oracle,
    including a mid-stream soft reset."""
    from mfcc_jax.server import FeatureServer, stream_samples
    from mfcc_jax.io import transport
    import socket

    sig = audio_int16[:1024]
    want = int_ref.mfcc_int(sig.astype(np.int64), CFG)  # 4 frames
    srv = FeatureServer(CFG, max_streams=2, chunk=1024,
                        device=_cpu()).start()
    try:
        host, port = srv.address
        got = stream_samples(host, port, sig, CFG.nceptrums,
                             expect_frames=want.shape[0], timeout=90)
        assert got.shape[0] >= want.shape[0]
        assert np.array_equal(got[: len(want)], want.astype(np.int16))

        # mid-stream reset: [sig | RESET | sig] must produce want twice
        words = np.concatenate([
            transport.encode_stream(sig, reset_first=True),
            transport.encode_stream(sig, reset_first=True)])
        with socket.create_connection((host, port), timeout=90) as sock:
            sock.sendall(words.astype("<u4").tobytes())
            sock.settimeout(90)
            buf = b""
            while True:
                cols, _ = transport.decode_frames(buf, CFG.nceptrums)
                if len(cols) >= 2 * len(want):
                    break
                data = sock.recv(65536)
                if not data:
                    break
                buf += data
        assert np.array_equal(cols[: len(want)], want.astype(np.int16))
        assert np.array_equal(cols[len(want): 2 * len(want)],
                              want.astype(np.int16))

        # UNALIGNED reset (mid-chunk): the pre-reset run is flushed as a
        # length-limited chunk, so ALL its completable frames are emitted
        # (hardware emits frames continuously as samples arrive; a soft
        # reset drops only the in-flight partial window), then the
        # post-reset stream starts clean.
        pre = audio_int16[:1500]            # 1024 chunk + 476 residue
        words = np.concatenate([
            transport.encode_stream(pre, reset_first=True),
            transport.encode_stream(sig, reset_first=True)])
        want_pre = int_ref.mfcc_int(pre.astype(np.int64), CFG)  # 6 frames
        with socket.create_connection((host, port), timeout=90) as sock:
            sock.sendall(words.astype("<u4").tobytes())
            sock.settimeout(90)
            buf = b""
            target = len(want_pre) + len(want)
            while True:
                cols, _ = transport.decode_frames(buf, CFG.nceptrums)
                if len(cols) >= target:
                    break
                data = sock.recv(65536)
                if not data:
                    break
                buf += data
        assert np.array_equal(cols[: len(want_pre)],
                              want_pre.astype(np.int16))
        assert np.array_equal(cols[len(want_pre): target],
                              want.astype(np.int16))
    finally:
        srv.stop()


def test_server_status_plane(audio_int16):
    """The control/status register plane (FeatureServer(status_port=),
    the FT601WishboneBridge role, /root/reference/mfcc/io/ft601.py:214-330):
    PING/CONFIG/SLOTS/STATS/LOGLEVEL over the second port, with counters
    reflecting real traffic."""
    import logging as _logging
    from mfcc_jax.server import FeatureServer, stream_samples, query_status

    sig = audio_int16[:1024]
    want = int_ref.mfcc_int(sig.astype(np.int64), CFG)
    srv = FeatureServer(CFG, max_streams=2, chunk=1024, device=_cpu(),
                        status_port=0).start()
    try:
        host, port = srv.address
        shost, sport = srv.status_address
        pong, config, lvl = query_status(
            shost, sport, "PING", "CONFIG", "LOGLEVEL")
        assert pong == "PONG"
        assert config["nfft"] == CFG.nfft and config["chunk"] == 1024
        assert config["max_streams"] == 2 and config["int_path"] is True
        assert lvl["loglevel"] in ("DEBUG", "INFO", "WARNING", "ERROR")

        got = stream_samples(host, port, sig, CFG.nceptrums,
                             expect_frames=want.shape[0], timeout=90)
        assert got.shape[0] >= want.shape[0]
        stats, slots = query_status(shost, sport, "STATS", "SLOTS")
        assert stats["steps"] >= 1
        assert stats["frames_tx"] >= want.shape[0]
        assert sum(s["tx_frames"] for s in slots) >= want.shape[0]
        assert sum(s["rx_words"] for s in slots) >= len(sig)

        # control write: set, read back, restore (one connection each)
        old = _logging.getLogger("mfcc_jax.server").getEffectiveLevel()
        try:
            (set_r,) = query_status(shost, sport, "LOGLEVEL DEBUG")
            assert set_r["loglevel"] == "DEBUG"
            (err,) = query_status(shost, sport, "BOGUS")
            assert err.startswith("ERR")
        finally:
            _logging.getLogger("mfcc_jax.server").setLevel(old)
    finally:
        srv.stop()


def test_server_trailing_reset_and_eof_flush(audio_int16):
    """Round-1 ADVICE (high): a reset word sent as its OWN 4-byte write --
    landing alone at a TCP recv boundary -- must still reset the stream.
    Also: EOF flushes the final partial chunk (batch parity, no drop)."""
    import socket
    import time as _time
    from mfcc_jax.server import FeatureServer, stream_samples
    from mfcc_jax.io import transport
    from mfcc_jax.config import RESET_WORD

    a = audio_int16[:1024]
    b = audio_int16[:1500]
    srv = FeatureServer(CFG, max_streams=2, chunk=1024,
                        device=_cpu()).start()
    try:
        host, port = srv.address

        # EOF flush: 1500 samples (not a chunk multiple) must produce every
        # batch frame, exactly
        want_b = int_ref.mfcc_int(b.astype(np.int64), CFG)      # 6 frames
        got = stream_samples(host, port, b, CFG.nceptrums, timeout=90)
        assert np.array_equal(got, want_b.astype(np.int16))

        # reset word in its own sendall, with a delay so it is the sole
        # content of a recv: features after it must be a fresh stream
        want_a = int_ref.mfcc_int(a.astype(np.int64), CFG)      # 4 frames
        with socket.create_connection((host, port), timeout=90) as sock:
            sock.sendall(transport.encode_stream(a, reset_first=True)
                         .astype("<u4").tobytes())
            _time.sleep(0.2)
            sock.sendall(np.array([RESET_WORD], "<u4").tobytes())
            _time.sleep(0.2)
            sock.sendall(transport.encode_stream(a).astype("<u4").tobytes())
            sock.shutdown(socket.SHUT_WR)
            sock.settimeout(90)
            buf = b""
            while True:
                try:
                    data = sock.recv(65536)
                except socket.timeout:
                    break
                if not data:
                    break
                buf += data
        cols, _ = transport.decode_frames(buf, CFG.nceptrums)
        assert np.array_equal(cols[: len(want_a)], want_a.astype(np.int16))
        # the second run is bit-exact a fresh stream ONLY if the lone reset
        # word was honored
        assert len(cols) == 2 * len(want_a)
        assert np.array_equal(cols[len(want_a):], want_a.astype(np.int16))
    finally:
        srv.stop()


def test_f64_high_accuracy_mode(audio_int16):
    """Golden-accuracy mode: float64 pipeline under x64 (exactness vs
    the numpy oracle is ~1e-9)."""
    from mfcc_jax.ops import float_ops
    import functools
    want = float_ref.mfcc_float(audio_int16, CFG)
    with jax.enable_x64():
        fn = jax.jit(functools.partial(float_ops.mfcc_batch, cfg=CFG,
                                       method="rfft", dtype=jnp.float64))
        try:
            got = np.asarray(fn(jnp.asarray(audio_int16, jnp.float64)))
        except Exception as e:  # pragma: no cover - backend-dependent
            pytest.skip(f"f64 unsupported on this backend: {e}")
    assert np.abs(want - got).max() < 1e-8


def test_cli_serve_end_to_end(audio_int16):
    """`cli serve` as a process surface: start on the CPU backend for a
    bounded duration, stream a client through it, exact features."""
    import threading
    import time as _time
    from mfcc_jax import cli
    from mfcc_jax import server as srv_mod
    from mfcc_jax.ref import int_ref

    rc = {}

    def run():
        rc["rc"] = cli.main(["serve", "--port", "0", "--streams", "2",
                             "--chunk", "512", "--backend", "cpu",
                             "--duration", "25", "--stats-every", "5"])

    # capture the bound port: cli prints "serving on host:port"
    import io
    import sys as _sys
    buf = io.StringIO()
    old = _sys.stdout

    def run_capture():
        _sys.stdout = buf
        try:
            run()
        finally:
            _sys.stdout = old

    th = threading.Thread(target=run_capture, daemon=True)
    th.start()
    deadline = _time.time() + 60
    port = None
    while _time.time() < deadline and port is None:
        m = [l for l in buf.getvalue().splitlines()
             if l.startswith("serving on ")]
        if m:
            port = int(m[0].rsplit(":", 1)[1])
        else:
            _time.sleep(0.2)
    assert port is not None, buf.getvalue()
    sig = audio_int16.astype(np.int16)
    want = int_ref.mfcc_int(sig.astype(np.int64)).astype(np.int16)
    cols = srv_mod.stream_samples("127.0.0.1", port, sig, 32,
                                  expect_frames=want.shape[0], timeout=45.0)
    assert np.array_equal(cols, want)
    th.join(timeout=60)
    assert rc.get("rc") == 0
