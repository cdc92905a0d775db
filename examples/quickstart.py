#!/usr/bin/env python3
"""Quickstart: every major surface of mfcc_jax in one script.

Run: python examples/quickstart.py [path/to/16khz.wav]
"""

import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main():
    import jax.numpy as jnp
    from mfcc_jax import MFCC, MFCCConfig
    from mfcc_jax.io import wav
    from mfcc_jax.streaming import StreamingMFCC
    from mfcc_jax.utils.liftering import lifter
    from mfcc_jax.utils.vad import has_voice

    if len(sys.argv) > 1:
        audio, sr = wav.read(sys.argv[1])
        print(f"loaded {sys.argv[1]}: {len(audio)} samples @ {sr} Hz")
    else:
        t = np.arange(16000) / 16000.0
        audio = (10000 * np.sin(2 * np.pi * (300 + 2000 * t) * t)
                 ).astype(np.int16)
        print("using a synthetic 1 s chirp (pass a wav path for real audio)")

    cfg = MFCCConfig()                        # 512/170, 32 mel, 32 cepstra
    fe = MFCC(cfg)

    # 1. batch float path -----------------------------------------------------
    cep = np.asarray(fe(jnp.asarray(audio)))
    print(f"float cepstra: {cep.shape}  c0 range "
          f"[{cep[:, 0].min():.1f}, {cep[:, 0].max():.1f}]")

    # 2. bit-exact fixed-point path (the FPGA RTL's arithmetic) ---------------
    icep = np.asarray(fe.int(audio.astype(np.int64)))
    print(f"int cepstra:   {icep.shape}  (bit-exact vs the reference RTL)")
    print(f"voice activity: {bool(has_voice(icep))}")

    # 3. streaming with checkpointable state + soft reset ---------------------
    sm = StreamingMFCC(cfg)
    state = sm.init(n_streams=1)
    feats, mask, state = sm.step(audio[None, :1024], state)
    print(f"streaming step: {int(np.asarray(mask).sum())} frames emitted, "
          f"carry count = {int(np.asarray(state.count)[0])} samples")
    feats, dmask, state = sm.drain(state)     # flush the partial final frame
    print(f"drain: {int(np.asarray(dmask).sum())} residual frames flushed")

    # 4. liftered coefficients (software/lift.py role) ------------------------
    print(f"liftered c1 of frame 0: {float(lifter(cep)[0, 1]):.2f}")

    # 5. batch over many streams / many files ---------------------------------
    batch = np.stack([audio, audio[::-1].copy()])
    print(f"batch of 2 streams -> {np.asarray(fe(jnp.asarray(batch))).shape}")


if __name__ == "__main__":
    main()
