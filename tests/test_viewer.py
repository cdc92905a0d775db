"""Live scrolling viewer (the recv.c role): renderer, follow decoder, and an
end-to-end run against a FeatureServer stream."""

import io
import socket
import threading

import numpy as np
import pytest

from mfcc_jax.config import MFCCConfig
from mfcc_jax.io import transport
from mfcc_jax.utils import viewer

CFG = MFCCConfig()


def _cpu():
    """Server tests exercise protocol/slot semantics; pin the step to the
    host CPU so they need no accelerator (the server on the GPU is
    checked by chip_smoke.py's server phase)."""
    import jax
    return jax.devices("cpu")[0]


def test_contrast_mapping_matches_reference():
    """recv.c:54-58: scale=(val+3000)*4, x=scale/65535, inferno."""
    cols = np.array([[-3000, 0, 13384]], np.int16)   # x = 0, ~0.183, 1.0
    rgb = viewer.columns_to_rgb(cols)
    lut = viewer._inferno_lut()
    assert np.array_equal(rgb[0, 0], lut[0])         # bottom of the map
    assert np.array_equal(rgb[0, 2], lut[255])       # top (clipped)
    assert np.array_equal(rgb[0, 1], lut[3000 * 4 * 255 // 65535])


def test_terminal_scroller_scrolls_and_reports_vad():
    out = io.StringIO()
    sc = viewer.TerminalScroller(ncep=4, height=3, out=out)
    quiet = np.zeros((2, 4), np.int16)
    loud = np.full((2, 4), 12000, np.int16)
    sc.push(quiet)
    assert "silence" in out.getvalue()
    for _ in range(40):                               # fill the VAD window
        sc.push(loud)
    text = out.getvalue()
    assert sc.n_frames == 82
    assert "VOICE" in text and "\x1b[38;2;" in text and "▀" in text
    # newest frames landed at the bottom of the ring
    assert np.array_equal(sc.ring[-1], loud[-1])
    sc.close()


def test_follow_frames_resyncs_and_times_out():
    cep = np.arange(12, dtype=np.int16).reshape(3, 4)
    enc = transport.encode_frames(cep)
    # byte loss mid-stream: drop one byte of the second frame
    frame_len = len(enc) // 3
    noisy = enc[:frame_len] + enc[frame_len + 1:]
    chunks = [noisy[:5], noisy[5:], b""]
    it = iter(chunks)
    read = lambda: next(it, None)
    got = np.concatenate(list(viewer.follow_frames(read, 4)))
    assert len(got) == 2                              # frame 2 lost, resynced
    assert np.array_equal(got[0], cep[0])
    assert np.array_equal(got[1], cep[2])


def test_live_viewer_against_feature_server(audio_int16):
    """End-to-end recv.c parity: a FeatureServer client feeds audio while the
    viewer follows the same connection's feature stream and scrolls."""
    from mfcc_jax.server import FeatureServer
    from mfcc_jax.ref import int_ref

    sig = audio_int16[:1192]
    want = int_ref.mfcc_int(sig.astype(np.int64), CFG)
    srv = FeatureServer(CFG, max_streams=1, chunk=1024,
                        device=_cpu()).start()
    try:
        host, port = srv.address
        sock = socket.create_connection((host, port), timeout=60)
        words = transport.encode_stream(sig, reset_first=True)

        def feed():
            sock.sendall(words.astype("<u4").tobytes())
            sock.shutdown(socket.SHUT_WR)
        t = threading.Thread(target=feed)
        t.start()

        sock.settimeout(0.05)

        def read():
            try:
                data = sock.recv(65536)
                return data if data else None
            except TimeoutError:
                return b""
            except OSError:
                return None

        out = io.StringIO()
        sc = viewer.TerminalScroller(CFG.nceptrums, height=8, out=out)
        for cols in viewer.follow_frames(read, CFG.nceptrums,
                                         idle_timeout=30.0):
            sc.push(cols)
        t.join()
        sock.close()
        assert sc.n_frames == want.shape[0]
        assert np.array_equal(sc.ring[-want.shape[0]:],
                              want.astype(np.int16))
        assert "\x1b[38;2;" in out.getvalue()
    finally:
        srv.stop()
