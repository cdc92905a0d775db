"""Test configuration.

The suite runs on the CPU, on a virtual 8-device mesh (XLA's host platform
split into 8 devices), so sharding and collective code paths are exercised
without accelerators.  Tests that need the GPU carry the ``gpu`` marker and
skip here; ``make test-gpu`` runs them on a machine with the card.
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8").strip()

import numpy as np
import pytest


@pytest.fixture(scope="session")
def audio_int16():
    """Deterministic synthetic 16 kHz int16 test signal (~5 frames),
    spectrally rich: chirp + tones + noise."""
    rng = np.random.default_rng(1234)
    n = 512 + 4 * 170
    t = np.arange(n) / 16000.0
    sig = (
        9000 * np.sin(2 * np.pi * (200 + 3000 * t) * t)
        + 5000 * np.sin(2 * np.pi * 1200 * t)
        + 1500 * rng.standard_normal(n)
    )
    return np.clip(sig, -32768, 32767).astype(np.int16)


@pytest.fixture(scope="session")
def reference_wav():
    """The reference repo's bundled wav, if mounted (optional fixture)."""
    path = "/root/reference/f2bjrop1.0.wav"
    if not os.path.exists(path):
        pytest.skip("reference wav not available")
    from scipy.io import wavfile
    _, audio = wavfile.read(path)
    return audio


@pytest.fixture
def gpu_device():
    """The first GPU, decided when a ``gpu``-marked test runs (never at
    import, so every xdist worker collects the same tests)."""
    import jax
    devs = [d for d in jax.devices() if d.platform == "gpu"]
    if not devs:
        pytest.skip("needs an NVIDIA GPU (run with make test-gpu)")
    return devs[0]
