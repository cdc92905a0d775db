#!/usr/bin/env python3
"""Throughput of the plain XLA paths on one device, at the reference config.

Prints ONE JSON line:

  * ``value`` -- float-path frames/s (``MFCC()``), gated at 5e-4 max-abs
    vs the float64 oracle;
  * ``int_frames_per_second`` -- INT path, gated on element-exact equality
    with the RTL oracle (``int_bit_exact``);
  * ``f64ish_frames_per_second`` -- ``MFCC(precision="f64ish")``, gated at
    1e-5 (``f64ish_max_err``);
  * ``serving_streams_{float,int}`` -- real-time 16 kHz streams one
    ``StreamingMFCC`` step sustains: S * (C / 16 kHz) / step seconds, for
    S=4096 streams x C=1024-sample chunks, host-driven step by step;
  * ``platform`` / ``device_kind`` / ``device_count`` / ``card`` -- what it
    ran on (``card`` is the NVIDIA card's name and power limit).

A failed gate reports 0 for that key.  Every timed call ends in
``block_until_ready``.  ``vs_baseline`` divides by the reference FPGA's
derived ~50k frames/s (BASELINE.md).

A run that finds no GPU exits non-zero, unless ``JAX_PLATFORMS=cpu`` was
asked for explicitly (the CI harness smoke, ``--quick``): a CPU number is
never reported as a device number by accident.

    python bench.py            # S=1024 x 4 s batches, S=4096 serving step
    python bench.py --quick    # tiny shapes
    python bench.py --latency  # per-step time vs chunk size (stderr table)
"""

import argparse
import json
import os
import sys

import numpy as np

ACCURACY_GATE = 5e-4          # max-abs-err vs float64 oracle, real-scale audio
F64ISH_GATE = 1e-5            # the compensated double-f32 accuracy contract
BASELINE_FRAMES_PER_S = 50e3  # reference FPGA derived throughput (BASELINE.md)


def make_audio(S, T, seed=0):
    """Integer-valued samples (the 16-bit wire contract) as float32, so the
    float and INT paths see IDENTICAL values."""
    rng = np.random.default_rng(seed)
    t = np.arange(T) / 16000.0
    base = (9000 * np.sin(2 * np.pi * (200 + 3000 * t) * t)
            + 4000 * np.sin(2 * np.pi * 900 * t))
    noise = rng.integers(-1500, 1500, (S, T))
    return np.round(np.clip(base[None, :] + noise,
                            -32768, 32767)).astype(np.float32)


def require_gpu():
    """The device record; exits non-zero when JAX sees no GPU, unless the
    CPU was asked for explicitly with JAX_PLATFORMS=cpu."""
    from mfcc_jax.utils.devinfo import device_fields
    dev = device_fields()
    if dev["platform"] != "gpu" and os.environ.get("JAX_PLATFORMS") != "cpu":
        print(f"bench: no GPU (JAX sees {dev['platform']}); set "
              "JAX_PLATFORMS=cpu to time the CPU on purpose", file=sys.stderr)
        sys.exit(2)
    return dev


def _oracle_err(fe, audio, rows, cfg):
    from mfcc_jax.ref import float_ref
    got = np.asarray(fe(audio[rows]))
    return max(float(np.abs(float_ref.mfcc_float(
        audio[r].astype(np.float64), cfg) - got[i]).max())
        for i, r in enumerate(rows))


def bench_batch(cfg, S, T, iters):
    """float / INT / f64ish frames/s on an (S, T) batch, each gated."""
    import jax
    from mfcc_jax import MFCC
    from mfcc_jax.ref import int_ref
    from mfcc_jax.utils.devinfo import timed

    F = cfg.n_frames(T)
    audio = make_audio(S, T)
    rows = sorted({0, S // 2, S - 1})
    out = {}

    fe = MFCC(cfg)
    err = _oracle_err(fe, audio, rows, cfg)
    _, dt, _ = timed(fe, jax.device_put(audio), iters=iters)
    fps = S * F / dt
    print(f"# float: {fps / 1e6:.3f} Mframes/s ({dt * 1e3:.2f} ms/call), "
          f"err={err:.2e}", file=sys.stderr)
    out["value"] = fps if err <= ACCURACY_GATE else 0.0
    out["float_max_err"] = err

    xi = jax.device_put(audio.astype(np.int32))
    got = np.asarray(fe.int(xi[np.asarray(rows)]))
    exact = all(np.array_equal(
        int_ref.mfcc_int(audio[r].astype(np.int64), cfg), got[i])
        for i, r in enumerate(rows))
    _, dt, _ = timed(fe.int, xi, iters=iters)
    fps = S * F / dt
    print(f"# int: {fps / 1e6:.3f} Mframes/s ({dt * 1e3:.2f} ms/call), "
          f"bit-exact={exact}", file=sys.stderr)
    out["int_frames_per_second"] = fps if exact else 0.0
    out["int_bit_exact"] = exact

    S64 = max(1, S // 16)
    f64 = MFCC(cfg, precision="f64ish")
    err = _oracle_err(f64, audio, sorted({0, S64 - 1}), cfg)
    _, dt, _ = timed(f64, jax.device_put(audio[:S64]), iters=iters)
    fps = S64 * F / dt
    print(f"# f64ish: {fps / 1e6:.3f} Mframes/s (S={S64}), err={err:.2e}",
          file=sys.stderr)
    out["f64ish_frames_per_second"] = (fps if np.isfinite(err)
                                       and err <= F64ISH_GATE else 0.0)
    out["f64ish_max_err"] = err
    return out


def bench_serving(cfg, S=4096, C=1024, steps=32):
    """Real-time stream capacity of the streaming step, float and INT."""
    import jax
    from mfcc_jax.streaming import StreamingMFCC
    from mfcc_jax.utils.devinfo import step_seconds
    out = {}
    audio = make_audio(S, C, seed=11)
    for name, int_path in (("float", False), ("int", True)):
        sm = StreamingMFCC(cfg, int_path=int_path)
        chunk = jax.device_put(audio.astype(np.int32 if int_path
                                            else np.float32))
        dt = step_seconds(sm, chunk, S, steps)
        streams = S * (C / cfg.samplerate) / dt
        print(f"# serving {name}: {dt * 1e3:.3f} ms/step (S={S}, C={C}) -> "
              f"{streams / 1e3:.1f}k real-time streams", file=sys.stderr)
        out[f"serving_streams_{name}"] = streams
    return out


def bench_latency(cfg, S=4096, steps=24):
    """Per-step time and real-time capacity at small chunk sizes, down to
    the reference's per-hop lock-step operating point (the host reads 32
    cepstra back every 170 samples, software/main.c:128-165).  Latency for a
    feature ~= chunk fill time + step time + delivery."""
    import jax
    from mfcc_jax.streaming import StreamingMFCC
    from mfcc_jax.utils.devinfo import step_seconds
    print(f"# latency: S={S} streams; path C chunk_ms step_ms rt_streams "
          "latency_floor_ms", file=sys.stderr)
    for int_path in (False, True):
        name = "int" if int_path else "float"
        sm = StreamingMFCC(cfg, int_path=int_path)
        for C in (170, 256, 512, 1024):
            chunk = jax.device_put(make_audio(S, C, seed=13).astype(
                np.int32 if int_path else np.float32))
            dt = step_seconds(sm, chunk, S, steps)
            chunk_ms = C / cfg.samplerate * 1e3
            print(f"# {name:5s} {C:5d} {chunk_ms:6.1f} {dt * 1e3:8.3f} "
                  f"{S * chunk_ms / 1e3 / dt / 1e3:8.1f}k "
                  f"{chunk_ms + dt * 1e3:8.1f}", file=sys.stderr)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--quick", action="store_true",
                    help="small shapes / few iterations (harness smoke)")
    ap.add_argument("--streams", type=int, default=None)
    ap.add_argument("--seconds", type=float, default=None)
    ap.add_argument("--iters", type=int, default=None)
    ap.add_argument("--latency", action="store_true",
                    help="print the small-chunk latency table and exit")
    args = ap.parse_args(argv)

    from mfcc_jax import compile_cache
    from mfcc_jax.config import MFCCConfig
    compile_cache.enable()
    dev = require_gpu()
    cfg = MFCCConfig()

    if args.latency:
        bench_latency(cfg, S=args.streams or 4096)
        return 0
    if args.quick:
        S, secs, iters, serve = 8, 0.5, 2, dict(S=16, C=1024, steps=2)
    else:
        S, secs, iters, serve = 1024, 4.0, 5, {}
    S = args.streams or S
    secs = args.seconds or secs
    iters = args.iters or iters
    T = cfg.nfft + int(round((secs * cfg.samplerate - cfg.nfft)
                             / cfg.hop)) * cfg.hop

    rec = {"metric": "mfcc_frames_per_second", "unit": "frames/s"}
    rec.update(bench_batch(cfg, S, T, iters))
    rec.update(bench_serving(cfg, **serve))
    rec["vs_baseline"] = rec["value"] / BASELINE_FRAMES_PER_S
    rec["shape"] = [S, T]
    rec.update(dev)
    print(json.dumps(rec))
    return 0


if __name__ == "__main__":
    sys.exit(main())
