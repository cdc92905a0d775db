#!/usr/bin/env python3
"""Bring-up check of the MFCC front end on an NVIDIA GPU.

Drives the main path once through the public entry points, at the reference
configuration (``MFCCConfig()``: 16 kHz, nfft 512, hop 170, 32 mel bands,
32 cepstra) and at sizes a user would call real, and checks every result
against the repo's float64 / RTL oracles:

  1. device     -- JAX must see GPU devices; otherwise exit non-zero
  2. float      -- ``MFCC()(audio)``, S=1024 x 4 s, 5e-4 vs the float64 oracle
  3. int        -- ``MFCC().int(audio)``, same shape, element-exact vs the RTL
                   oracle on a few streams and vs the CPU backend on all
  4. f64ish     -- ``MFCC(precision="f64ish")``, S=64 x 4 s, 1e-5 on every
                   stream
  5. streaming  -- ``StreamingMFCC`` float and INT, S=4096 x C=1024 chunks;
                   chunked output equals batch output
  6. server     -- an in-process ``FeatureServer`` on the GPU; TCP clients
                   in the reference wire format get the batch INT columns

Each phase prints one line with its shape, wall time, throughput, error and
the card's name and power limit.  The last line is one JSON object:
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}``.
Any failed check raises, and the script exits non-zero without that line.

    python chip_smoke.py               # phases 1-6 on one card
    python chip_smoke.py --four-cards  # only the 4-device mesh path

``--four-cards`` runs ``mfcc_sharded_fn`` (float, INT), ``streaming_sharded_fn``
(float, INT) and the ppermute halo (``halo.mfcc_halo_fn``) on 4-GPU meshes
shaped (4, 1) and (2, 2), each against the one-card result.
"""

from __future__ import annotations

import argparse
import json
import sys
import threading
import time

import numpy as np

from mfcc_jax.utils.devinfo import card_info, step_seconds, timed

FLOAT_GATE = 5e-4     # float path vs the float64 oracle
F64ISH_GATE = 1e-5    # precision="f64ish" vs the float64 oracle
SAMPLERATE = 16000


# -- helpers -------------------------------------------------------------------

def make_audio(S: int, T: int, seed: int = 0) -> np.ndarray:
    """(S, T) int16 speech-band test signal: a shared chirp + tone plus
    per-stream noise, so every row differs."""
    rng = np.random.default_rng(seed)
    t = np.arange(T) / SAMPLERATE
    base = (9000 * np.sin(2 * np.pi * (200 + 3000 * t) * t)
            + 4000 * np.sin(2 * np.pi * 900 * t)).astype(np.float32)
    noise = rng.integers(-1500, 1500, (S, T), dtype=np.int16)
    return np.clip(base[None, :] + noise, -32768, 32767).astype(np.int16)


def check_rows(S: int, n: int = 4) -> list[int]:
    """A few rows spread over the batch for the (host-side) oracles."""
    return sorted({int(r) for r in np.linspace(0, S - 1, min(n, S))})


def entry_kernel_count(hlo_text: str) -> int:
    """Device kernels one call of a compiled program launches: instructions
    of the optimized HLO's ENTRY computation other than parameters,
    constants, tuples and bitcasts (each fusion or library call is one
    launch)."""
    free = {"parameter", "constant", "tuple", "get-tuple-element", "bitcast"}
    n, inside = 0, False
    for line in hlo_text.splitlines():
        if line.startswith("ENTRY "):
            inside = True
            continue
        if inside:
            if line.startswith("}"):
                break
            if " = " not in line:
                continue
            rhs = line.split(" = ", 1)[1]
            # "<shape> opcode(operands)": the opcode precedes the first '('
            # that follows the shape
            head = rhs.split("(", 1)[0] if not rhs.startswith("(") \
                else rhs[rhs.index(")") + 1:].split("(", 1)[0]
            opcode = head.split()[-1] if head.split() else ""
            if opcode not in free:
                n += 1
    return n


def emit(phase: str, card: str, **kv) -> None:
    fields = " ".join(f"{k}={v}" for k, v in kv.items())
    print(f"[{phase}] {fields} card=\"{card}\"", flush=True)


# -- phases --------------------------------------------------------------------

def phase_device(expect: int | None = None):
    """Phase 1: the GPU devices JAX sees.  Raises SystemExit off-GPU."""
    import jax
    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise SystemExit(f"chip_smoke: no GPU -- JAX sees "
                         f"{devs[0].platform} devices {devs}")
    if expect is not None and len(devs) < expect:
        raise SystemExit(f"chip_smoke: need {expect} GPUs, JAX sees "
                         f"{len(devs)}")
    return devs


def phase_float(device, S: int = 1024, T: int = 64000, iters: int = 5):
    """Phase 2: float batch path vs the float64 oracle."""
    import jax
    from mfcc_jax import MFCC, MFCCConfig
    from mfcc_jax.ref import float_ref
    cfg = MFCCConfig()
    audio = make_audio(S, T, seed=1)
    x = jax.device_put(audio.astype(np.float32), device)
    fe = MFCC(cfg)
    first, dt, out = timed(fe, x, iters=iters)
    got = np.asarray(out)
    F = cfg.n_frames(T)
    assert got.shape == (S, F, cfg.nceptrums), got.shape
    assert np.isfinite(got).all()
    err = max(float(np.abs(float_ref.mfcc_float(audio[r], cfg) - got[r]).max())
              for r in check_rows(S))
    assert err <= FLOAT_GATE, f"float path max|err| {err:.3e} > {FLOAT_GATE}"
    return dict(shape=f"{(S, T)}->{got.shape}", compile_s=round(first, 3),
                wall_s=dt, frames_per_s=S * F / dt, max_err=err)


def phase_int(device, S: int = 1024, T: int = 64000, iters: int = 5):
    """Phase 3: bit-exact INT batch path vs the RTL oracle, plus the number
    of kernels one call launches."""
    import jax
    import jax.numpy as jnp
    from mfcc_jax import MFCC, MFCCConfig
    from mfcc_jax.ref import int_ref
    cfg = MFCCConfig()
    audio = make_audio(S, T, seed=2)
    fe = MFCC(cfg)
    x = jax.device_put(audio.astype(np.int32), device)
    first, dt, out = timed(fe.int, x, iters=iters)
    got = np.asarray(out)
    F = cfg.n_frames(T)
    assert got.shape == (S, F, cfg.nceptrums), got.shape
    for r in check_rows(S):
        want = int_ref.mfcc_int(audio[r].astype(np.int64), cfg)
        assert np.array_equal(want, got[r]), f"INT row {r} differs"
    # every row, over repeated runs, against the CPU backend's compile of
    # the same program (bit-exact with the oracle in the test suite)
    cpu_want = np.asarray(fe._int_jit(
        jax.device_put(audio.astype(np.int32), jax.devices("cpu")[0])))
    for out in (got, *(fe.int(x) for _ in range(3))):
        bad = np.argwhere(np.asarray(out) != cpu_want)
        assert not len(bad), (f"INT: {len(bad)} elements in streams "
                              f"{sorted({int(b[0]) for b in bad})[:8]} "
                              "differ from the CPU backend")
    kernels = entry_kernel_count(
        fe._int_jit.lower(jnp.asarray(x, jnp.int32)).compile().as_text())
    return dict(shape=f"{(S, T)}->{got.shape}", compile_s=round(first, 3),
                wall_s=dt, frames_per_s=S * F / dt, max_err=0,
                kernels_per_call=kernels)


def phase_f64ish(device, S: int = 64, T: int = 64000, iters: int = 3):
    """Phase 4: the <=1e-5 mode vs the float64 oracle, every stream."""
    import jax
    from mfcc_jax import MFCC, MFCCConfig
    from mfcc_jax.ref import float_ref
    cfg = MFCCConfig()
    audio = make_audio(S, T, seed=3)
    x = jax.device_put(audio.astype(np.float32), device)
    fe = MFCC(cfg, precision="f64ish")
    first, dt, out = timed(fe, x, iters=iters)
    got = np.asarray(out)
    F = cfg.n_frames(T)
    assert got.shape == (S, F, cfg.nceptrums), got.shape
    err = max(float(np.abs(float_ref.mfcc_float(
        audio[r].astype(np.float64), cfg) - got[r]).max())
        for r in range(S))
    assert np.isfinite(err) and err <= F64ISH_GATE, \
        f"f64ish max|err| {err:.3e} > {F64ISH_GATE}"
    return dict(shape=f"{(S, T)}->{got.shape}", compile_s=round(first, 3),
                wall_s=dt, frames_per_s=S * F / dt, max_err=err)


def phase_streaming(device, S: int = 4096, C: int = 1024, n_chunks: int = 8,
                    steps: int = 16):
    """Phase 5: StreamingMFCC float and INT; chunked == batch."""
    import jax
    from mfcc_jax import MFCC, MFCCConfig
    from mfcc_jax.ref import float_ref, int_ref
    from mfcc_jax.streaming import StreamingMFCC
    cfg = MFCCConfig()
    T = C * n_chunks
    audio = make_audio(S, T, seed=4)
    F = cfg.n_frames(T)
    rows = check_rows(S)
    ism = StreamingMFCC(cfg, int_path=True, device=device)
    got_i = np.stack(ism.process(audio.astype(np.int32), chunk_size=C)[0])
    want_i = np.asarray(MFCC(cfg).int(jax.device_put(audio.astype(np.int32),
                                                     device)))
    assert got_i.shape == want_i.shape == (S, F, cfg.nceptrums)
    assert np.array_equal(got_i, want_i), "INT chunked != INT batch"
    for r in rows:
        assert np.array_equal(
            got_i[r], int_ref.mfcc_int(audio[r].astype(np.int64), cfg))
    fsm = StreamingMFCC(cfg, device=device)
    got_f = np.stack(fsm.process(audio.astype(np.float32), chunk_size=C)[0])
    assert got_f.shape == (S, F, cfg.nceptrums)
    err = max(float(np.abs(float_ref.mfcc_float(audio[r], cfg)
                           - got_f[r]).max()) for r in rows)
    assert err <= FLOAT_GATE, f"float stream max|err| {err:.3e}"
    res = {"shape": f"S={S} C={C} chunks={n_chunks}", "max_err_float": err}
    for name, sm, dt in (("int", ism, np.int32), ("float", fsm, np.float32)):
        chunk = jax.device_put(audio[:, :C].astype(dt), device)
        step_s = step_seconds(sm, chunk, S, steps)
        res[f"{name}_step_s"] = step_s
        res[f"{name}_realtime_streams"] = S * C / SAMPLERATE / step_s
    return res


def phase_server(device, clients: int = 8, seconds: float = 1.0):
    """Phase 6: an in-process FeatureServer on ``device``; each TCP client
    streams its own audio and must get the batch INT path's columns."""
    import jax
    from mfcc_jax import MFCC, MFCCConfig
    from mfcc_jax.server import FeatureServer, stream_samples
    cfg = MFCCConfig()
    T = int(seconds * SAMPLERATE)
    audio = make_audio(clients, T, seed=5)
    want = np.asarray(MFCC(cfg).int(
        jax.device_put(audio.astype(np.int32), device))).astype(np.int16)
    srv = FeatureServer(cfg, max_streams=clients, device=device)
    srv.start()
    got = [None] * clients
    errors = []

    def client(i):
        try:
            got[i] = stream_samples(*srv.address, audio[i], cfg.nceptrums,
                                    timeout=120.0)
        except Exception as e:        # re-raised below, after the join
            errors.append(e)

    try:
        # one untimed client first: the server compiles its rollback and
        # wire-format programs, and the step again for committed state, on
        # its first ticks
        client(0)
        if errors:
            raise errors[0]
        assert np.array_equal(got[0], want[0]), "warm-up client differs"
        t0 = time.perf_counter()
        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(clients)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        wall = time.perf_counter() - t0
    finally:
        srv.stop()
    if errors:
        raise errors[0]
    for i in range(clients):
        assert got[i].shape == want[i].shape, (i, got[i].shape)
        assert np.array_equal(got[i], want[i]), f"client {i} columns differ"
    frames = sum(g.shape[0] for g in got)
    return dict(shape=f"clients={clients} x {T} samples", wall_s=wall,
                frames=frames, frames_per_s=frames / wall, max_err=0)


# -- the four-card path --------------------------------------------------------

def phase_four_cards(devices, S: int = 1024, T: int = 64000,
                     C: int = 1024, n_chunks: int = 4):
    """dp x sp meshes (4, 1) and (2, 2) over 4 devices: sharded batch,
    sharded streaming and the ppermute halo, each against one device."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P
    from mfcc_jax import MFCC, MFCCConfig, streaming
    from mfcc_jax.parallel import (make_mesh, shard_streams, mfcc_sharded_fn,
                                   streaming_sharded_fn, halo)
    from mfcc_jax.ref import float_ref
    cfg = MFCCConfig()
    one = devices[0]
    audio = make_audio(S, T, seed=6)
    rows = check_rows(S)
    fe = MFCC(cfg)
    want_i = np.asarray(fe.int(jax.device_put(audio.astype(np.int32), one)))
    oracle = {r: float_ref.mfcc_float(audio[r], cfg) for r in rows}
    Ts = C * n_chunks
    want_si = np.asarray(fe.int(jax.device_put(
        audio[:, :Ts].astype(np.int32), one)))
    oracle_s = {r: float_ref.mfcc_float(audio[r, :Ts], cfg) for r in rows}
    results = []

    def float_err(got, ref, F):
        return max(float(np.abs(ref[r][:F] - got[r][:F]).max()) for r in rows)

    for shape in ((4, 1), (2, 2)):
        mesh = make_mesh(4, shape=shape)
        line = {"mesh": f"{shape}"}
        for int_path in (False, True):
            fn = mfcc_sharded_fn(mesh, cfg, int_path=int_path)
            x = shard_streams(jnp.asarray(
                audio.astype(np.int32 if int_path else np.float32)), mesh)
            first, dt, (cep, _) = timed(fn, x, iters=3)
            got = np.asarray(cep)
            F = got.shape[1]
            if int_path:
                assert np.array_equal(got, want_i), f"sharded INT {shape}"
            else:
                err = float_err(got, oracle, F)
                assert err <= FLOAT_GATE, f"sharded float {shape}: {err:.3e}"
                line["batch_float_err"] = err
            key = "int" if int_path else "float"
            line[f"batch_{key}_frames_per_s"] = S * F / dt

            Tp = halo.pad_for_halo(T, mesh, cfg)
            hx = np.pad(audio, ((0, 0), (0, Tp - T))).astype(
                np.int32 if int_path else np.float32)
            hfn = halo.mfcc_halo_fn(mesh, cfg, int_path=int_path)
            hx = jax.device_put(hx, NamedSharding(mesh, P("dp", "sp")))
            first, dt, hout = timed(hfn, hx, iters=3)
            hgot = np.asarray(hout)[:, :cfg.n_frames(T)]
            if int_path:
                assert np.array_equal(hgot, want_i), f"halo INT {shape}"
            else:
                err = float_err(hgot, oracle, hgot.shape[1])
                assert err <= FLOAT_GATE, f"halo float {shape}: {err:.3e}"
                line["halo_float_err"] = err
            line[f"halo_{key}_frames_per_s"] = S * hgot.shape[1] / dt

            step = streaming_sharded_fn(mesh, cfg, int_path=int_path)
            dt_ = jnp.int32 if int_path else jnp.float32
            dp = NamedSharding(mesh, P("dp"))
            # the shardings the step returns, so later steps reuse the
            # first step's executable instead of compiling a second one
            state = jax.device_put(
                streaming.init_state(S, cfg, dt_),
                streaming.StreamState(NamedSharding(mesh, P("dp", None)),
                                      dp, dp))
            reset = jax.device_put(jnp.zeros((S,), bool), dp)
            outs, step_s = [], []
            for k in range(n_chunks):
                t0 = time.perf_counter()
                chunk = jax.device_put(
                    jnp.asarray(audio[:, k * C:(k + 1) * C], dt_),
                    NamedSharding(mesh, P("dp", None)))
                feats, mask, state = step(chunk, state, reset)
                m = np.asarray(mask)
                n = int(m[0].sum())
                assert (m.sum(axis=1) == n).all()
                outs.append(np.asarray(feats)[:, :n])
                step_s.append(time.perf_counter() - t0)
            sgot = np.concatenate(outs, axis=1)
            if int_path:
                assert np.array_equal(sgot, want_si), \
                    f"sharded streaming INT {shape}"
            else:
                err = float_err(sgot, oracle_s, sgot.shape[1])
                assert err <= FLOAT_GATE, \
                    f"sharded streaming float {shape}: {err:.3e}"
                line["stream_float_err"] = err
            # the first step compiles; later ones are host-driven steady
            # steps, chunk upload and feature download included
            line[f"stream_{key}_step_s"] = float(np.mean(step_s[1:]))
        results.append(line)
    return results


# -- main ----------------------------------------------------------------------

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the 4-device mesh path")
    args = ap.parse_args(argv)
    if not __debug__:
        raise SystemExit("chip_smoke: its checks are asserts; run it "
                         "without python -O")

    devs = phase_device(expect=4 if args.four_cards else None)
    from mfcc_jax import compile_cache
    compile_cache.enable()
    card = card_info()
    dev = devs[0]
    emit("device", card, platform=dev.platform, kind=f"\"{dev.device_kind}\"",
         count=len(devs))

    if args.four_cards:
        for line in phase_four_cards(devs[:4]):
            emit("four_cards", card, **line)
        count = 4
    else:
        for name, fn in (("float", phase_float), ("int", phase_int),
                         ("f64ish", phase_f64ish),
                         ("streaming", phase_streaming),
                         ("server", phase_server)):
            emit(name, card, **fn(dev))
        count = len(devs)

    print(f"card: {card}", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
