"""Randomized server protocol fuzz: arbitrary send fragmentation x arbitrary
reset placement must produce exactly the per-epoch batch results.

This is the round-2 analogue of the reference's randomized-backpressure
benches (mfcc/core/frame.py:157-255) aimed at the host-protocol state
machine (buffering, reset segmentation, boundary/EOF flush, in-flight
tracking) rather than the DSP: with flush-on-boundary semantics, the
expected output for any input [epoch_0 | RESET | epoch_1 | ...] is
``concat(mfcc_int(epoch_k) for all k)`` regardless of how the bytes were
fragmented into sends."""

import socket
import time

import numpy as np
import pytest

from mfcc_jax.config import MFCCConfig, RESET_WORD
from mfcc_jax.io import transport
from mfcc_jax.ref import int_ref

CFG = MFCCConfig()


def _cpu():
    """Server tests exercise protocol/slot semantics; pin the step to the
    host CPU so they need no accelerator (the server on the GPU is
    checked by chip_smoke.py's server phase)."""
    import jax
    return jax.devices("cpu")[0]


def _expected(epochs):
    outs = [int_ref.mfcc_int(e.astype(np.int64), CFG)
            for e in epochs if len(e) >= CFG.nfft]
    return (np.concatenate(outs) if outs
            else np.zeros((0, CFG.nceptrums), np.int64)).astype(np.int16)


def test_server_protocol_fuzz(audio_int16):
    from mfcc_jax.server import FeatureServer

    rng = np.random.default_rng(99)
    base = np.tile(audio_int16, 4)                     # 4768 samples
    srv = FeatureServer(CFG, max_streams=2, chunk=1024,
                        device=_cpu()).start()
    try:
        host, port = srv.address
        for trial in range(4):
            # random epochs (some shorter than a frame, some than a chunk)
            n_epochs = int(rng.integers(1, 4))
            epochs = []
            for _ in range(n_epochs):
                ln = int(rng.integers(200, 2200))
                st = int(rng.integers(0, len(base) - ln))
                epochs.append(base[st: st + ln])
            words = [np.array([RESET_WORD], np.uint32)]
            for e in epochs[:-1]:
                words.append(transport.encode_stream(e))
                words.append(np.array([RESET_WORD], np.uint32))
            words.append(transport.encode_stream(epochs[-1]))
            wire = np.concatenate(words).astype("<u4").tobytes()

            # random fragmentation, unaligned to the 4-byte word size
            cuts = np.sort(rng.integers(1, len(wire), rng.integers(1, 12)))
            parts = np.split(np.frombuffer(wire, np.uint8), cuts)

            with socket.create_connection((host, port), timeout=120) as sock:
                for j, p in enumerate(parts):
                    sock.sendall(p.tobytes())
                    if rng.random() < 0.4:
                        time.sleep(0.01)               # force recv boundaries
                sock.shutdown(socket.SHUT_WR)
                sock.settimeout(120)
                buf = b""
                while True:
                    try:
                        data = sock.recv(65536)
                    except socket.timeout:
                        break
                    if not data:
                        break
                    buf += data
            got, _ = transport.decode_frames(buf, CFG.nceptrums)
            want = _expected(epochs)
            assert got.shape == want.shape, \
                (trial, got.shape, want.shape, [len(e) for e in epochs])
            assert np.array_equal(got, want), (trial, [len(e) for e in epochs])
    finally:
        srv.stop()
