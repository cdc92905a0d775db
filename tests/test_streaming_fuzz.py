"""Streaming fuzz: fixed pseudo-random chunkings + reset schedules vs the
oracle (the batched restatement of the reference's randomized-backpressure
benches, kept to a small number of distinct jit shapes)."""

import numpy as np
import pytest

from mfcc_jax import MFCCConfig
from mfcc_jax.streaming import StreamingMFCC
from mfcc_jax.ref import int_ref

CFG = MFCCConfig()


def test_fuzz_chunkings_and_resets(audio_int16):
    """Three streams, one chunk size, adversarial reset schedule; INT path
    so equality is exact."""
    rng = np.random.default_rng(11)
    C = 173                      # coprime-ish with hop and nfft
    sig = np.concatenate([audio_int16, audio_int16])[: C * 12]
    sm = StreamingMFCC(CFG, int_path=True)
    S = 3
    batch = np.stack([sig, sig[::-1].copy(), np.roll(sig, 7)])
    state = sm.init(S)
    # reset stream 1 before chunk 4, stream 2 before chunk 9
    schedule = {4: np.array([False, True, False]),
                9: np.array([False, False, True])}
    outs = [[] for _ in range(S)]
    nchunks = len(sig) // C
    reset_points = {1: 4 * C, 2: 9 * C}
    for ci in range(nchunks):
        feats, mask, state = sm.step(
            batch[:, ci * C:(ci + 1) * C].astype(np.int64), state,
            schedule.get(ci))
        f, m = np.asarray(feats), np.asarray(mask)
        for s in range(S):
            outs[s].append(f[s][m[s]])
    for s in range(S):
        got = np.concatenate(outs[s]) if outs[s] else np.zeros((0, 32))
        start = reset_points.get(s, 0)
        usable = (nchunks * C - start)
        want = int_ref.mfcc_int(batch[s, start: start + usable]
                                .astype(np.int64), CFG)
        # pre-reset frames precede the post-reset stream in `got`
        n = want.shape[0]
        assert n > 0
        assert np.array_equal(got[-n:], want), f"stream {s}"
