"""Native batch client (native/mfcc_client.cpp): the software/main.c role --
walk a wav directory, stream each file to the device link (here the
FeatureServer) with soft resets at file boundaries, write .mfcc files."""

import os
import struct
import subprocess

import numpy as np
import pytest

from mfcc_jax.config import MFCCConfig
from mfcc_jax.ref import int_ref

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CLIENT = os.path.join(REPO, "native", "mfcc_client")


def _write_wav(path, samples: np.ndarray, sr: int = 16000):
    data = np.asarray(samples, "<i2").tobytes()
    fmt = struct.pack("<HHIIHH", 1, 1, sr, sr * 2, 2, 16)
    body = (b"fmt " + struct.pack("<I", len(fmt)) + fmt
            + b"data" + struct.pack("<I", len(data)) + data)
    path.write_bytes(b"RIFF" + struct.pack("<I", 4 + len(body))
                     + b"WAVE" + body)


@pytest.mark.skipif(not os.path.exists(CLIENT),
                    reason="native client not built (make -C native)")
def test_native_client_end_to_end(tmp_path, audio_int16):
    """Three files of different lengths (incl. one needing a tail flush and
    one shorter than a chunk) convert bit-exactly, file boundaries honored."""
    from mfcc_jax.server import FeatureServer

    cfg = MFCCConfig()
    sigs = {
        "a/one.wav": audio_int16[:1024],
        "a/two.wav": audio_int16[:1500],          # tail flush mid-connection
        "three.wav": audio_int16[:700],           # < one chunk entirely
    }
    (tmp_path / "a").mkdir()
    for rel, sig in sigs.items():
        _write_wav(tmp_path / rel, sig)

    srv = FeatureServer(cfg, max_streams=2, chunk=1024).start()
    try:
        host, port = srv.address
        rc = subprocess.run([CLIENT, host, str(port), str(tmp_path)],
                            capture_output=True, text=True, timeout=300)
        assert rc.returncode == 0, rc.stderr[-2000:]
    finally:
        srv.stop()

    for rel, sig in sigs.items():
        want = int_ref.mfcc_int(sig.astype(np.int64), cfg)
        out = (tmp_path / rel).with_suffix(".mfcc")
        got = np.fromfile(out, np.int16).reshape(-1, cfg.nceptrums)
        assert np.array_equal(got, want.astype(np.int16)), rel
