"""WAV ingestion: native (threaded C++) with scipy fallback.

The host half of the reference's data path (software/main.c:56-98 +
libwav submodule): decode wavs to 16 kHz int16 mono batches for the device
pipeline.
"""

from __future__ import annotations

import glob
import os

import numpy as np

from . import native


def read(path: str, prefer_native: bool = True):
    """-> (samples int16 1-D, sample_rate)."""
    if prefer_native and native.available():
        return native.wav_read(path)
    from scipy.io import wavfile
    rate, data = wavfile.read(path)
    if data.ndim > 1:
        data = data[:, 0]
    if data.dtype != np.int16:
        if np.issubdtype(data.dtype, np.floating):
            data = np.clip(data * 32767.0, -32768, 32767).astype(np.int16)
        else:
            data = data.astype(np.int16)
    return data, rate


def read_batch(paths: list[str], max_samples: int | None = None,
               prefer_native: bool = True):
    """Decode many wavs into one zero-padded (N, max_samples) int16 matrix.
    -> (matrix, lengths, rates).  Uses the threaded native loader when
    available."""
    if not paths:
        raise ValueError("no paths")
    if max_samples is None:
        # one cheap pass to size the batch
        max_samples = 0
        for p in paths:
            s, _ = read(p, prefer_native)
            max_samples = max(max_samples, len(s))
    if prefer_native and native.available():
        return native.wav_read_batch(paths, max_samples)
    mats = np.zeros((len(paths), max_samples), np.int16)
    lengths = np.zeros(len(paths), np.int64)
    rates = np.zeros(len(paths), np.int32)
    for i, p in enumerate(paths):
        s, r = read(p, prefer_native)
        keep = min(len(s), max_samples)
        mats[i, :keep] = s[:keep]
        lengths[i] = keep
        rates[i] = r
    return mats, lengths, rates


def walk_wavs(root: str) -> list[str]:
    """Recursive *.wav discovery (main.c:206-247 show_dir_content)."""
    out = []
    for dirpath, _dirs, files in os.walk(root):
        for f in sorted(files):
            if f.lower().endswith(".wav"):
                out.append(os.path.join(dirpath, f))
    return sorted(out)
