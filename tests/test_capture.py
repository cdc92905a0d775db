"""Live capture bridge (the AudioReceiver / mic2mfcc ingest role), driven
with a fake capture device so no hardware is needed."""

import os
import subprocess
import sys

import numpy as np
import pytest

from mfcc_jax.config import MFCCConfig
from mfcc_jax.io import capture, transport
from mfcc_jax.ref import int_ref

CFG16 = MFCCConfig(nceptrums=16)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _fake_device(tmp_path, samples: np.ndarray) -> tuple[str, str]:
    """A 'microphone': a script that writes raw int16 PCM to stdout."""
    pcm = tmp_path / "mic.pcm"
    pcm.write_bytes(np.asarray(samples, "<i2").tobytes())
    script = tmp_path / "fakemic.sh"
    script.write_text(f"#!/bin/sh\ncat {pcm}\n")
    script.chmod(0o755)
    return str(script), str(pcm)


def test_capture_reads_blocks(tmp_path, audio_int16):
    script, _ = _fake_device(tmp_path, audio_int16)
    with capture.Capture(command=[script]) as cap:
        a = cap.read(500)
        b = cap.read(500)
        rest = cap.read(10 ** 6)
    got = np.concatenate([a, b, rest])
    assert np.array_equal(got, audio_int16)


def test_capture_command_detection():
    cmd = capture.capture_command(16000)
    if cmd is None:
        pytest.skip("no capture tool in this image")
    assert cmd[0] in ("arecord", "ffmpeg", "sox", "parec")


def test_cli_mic_end_to_end(tmp_path, audio_int16):
    """cli mic with a fake device produces the exact batch features,
    including the flushed partial final chunk."""
    script, _ = _fake_device(tmp_path, audio_int16)      # 1192 samples
    outfile = tmp_path / "mic.bin"
    rc = subprocess.run(
        [sys.executable, "-m", "mfcc_jax.cli", "mic", str(outfile),
         "--command", script, "--chunk", "1024"],
        capture_output=True, text=True, cwd=REPO, timeout=600)
    assert rc.returncode == 0, rc.stderr[-2000:]
    assert "captured 1192 samples" in rc.stderr
    cols, _ = transport.decode_frames(outfile.read_bytes(), 16)
    want = int_ref.mfcc_int(audio_int16.astype(np.int64), CFG16)
    assert np.array_equal(cols, want.astype(np.int16))
