#!/usr/bin/env python3
"""Serving demo: one batched FeatureServer, many concurrent clients.

Spins up the TCP feature server (the reference's USB3/UART device link
as a TCP service), drives N concurrent client connections each streaming its own
audio, and checks every client's features are bit-exact with the fixed-point
oracle -- demonstrating that multiplexing onto one jit-compiled batch step
preserves per-stream numerics.

Run: python examples/serving_demo.py [n_clients] [seconds_of_audio]
"""

import os
import sys
import threading
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main():
    from mfcc_jax.config import MFCCConfig
    from mfcc_jax.ref import int_ref
    from mfcc_jax.server import FeatureServer, stream_samples

    n_clients = int(sys.argv[1]) if len(sys.argv) > 1 else 4
    seconds = float(sys.argv[2]) if len(sys.argv) > 2 else 1.0
    cfg = MFCCConfig()

    rng = np.random.default_rng(0)
    T = int(seconds * cfg.samplerate)
    t = np.arange(T) / cfg.samplerate
    sigs = [np.clip(8000 * np.sin(2 * np.pi * (200 + 150 * k) * t)
                    + rng.integers(-1500, 1500, T), -32768, 32767
                    ).astype(np.int16)
            for k in range(n_clients)]

    print(f"starting server ({n_clients} slots, compiling the batch step)...")
    srv = FeatureServer(cfg, max_streams=n_clients, chunk=1024).start()
    host, port = srv.address
    results = [None] * n_clients

    def client(k):
        results[k] = stream_samples(host, port, sigs[k], cfg.nceptrums,
                                    timeout=120)

    t0 = time.time()
    threads = [threading.Thread(target=client, args=(k,))
               for k in range(n_clients)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    dt = time.time() - t0

    total_frames = 0
    for k in range(n_clients):
        want = int_ref.mfcc_int(sigs[k].astype(np.int64), cfg)
        ok = np.array_equal(results[k], want.astype(np.int16))
        total_frames += len(want)
        print(f"client {k}: {results[k].shape[0]} frames "
              f"{'bit-exact' if ok else 'MISMATCH'}")
        assert ok
    audio_s = n_clients * seconds
    print(f"{n_clients} concurrent streams x {seconds:.1f} s audio "
          f"({total_frames} frames) served in {dt:.2f} s "
          f"= {audio_s / dt:.1f}x real time on the serving path")
    print("(a tiny-batch protocol demo, dominated by per-dispatch "
          "overhead; the dispatch-amortized step sustains tens of "
          "thousands of real-time streams -- docs/BENCH.md round 2f)")
    srv.stop()


if __name__ == "__main__":
    main()
