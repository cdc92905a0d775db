#!/usr/bin/env python3
"""Executable walkthrough of the fixed-point MFCC arithmetic, stage by stage.

This is the narrative role of the reference's notebooks
(/root/reference/notebook/MFCC-INT.ipynb cells 2-11 and MFCC.ipynb cell 45):
run the INT pipeline on real audio one stage at a time, print the exact
integer values and bit-widths at every boundary, cross-check each stage
against the float pipeline, and (with --plots) save the per-stage figures
the notebooks display inline.

    python examples/int_walkthrough.py [--frames N] [--plots DIR] [--wav F]

Every stage cites the RTL it reproduces bit-for-bit; the numbers printed are
the same numbers the FPGA's stream endpoints would carry.
"""

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from mfcc_jax.config import MFCCConfig
from mfcc_jax.ref import int_ref, float_ref
from mfcc_jax import tables


def section(title):
    print(f"\n{'=' * 72}\n{title}\n{'=' * 72}")


def stats(name, arr, bits=None):
    arr = np.asarray(arr)
    span = f"[{arr.min()}, {arr.max()}]"
    need = max(int(arr.max()).bit_length(),
               int(-arr.min() - 1).bit_length() if arr.min() < 0 else 0) + 1
    fits = "" if bits is None else \
        f"  fits {bits}b: {'yes' if need <= bits else 'NO'}"
    print(f"  {name:<22s} shape={str(arr.shape):<14s} range={span}{fits}")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=3,
                    help="frames to walk through (default 3)")
    ap.add_argument("--plots", default=None,
                    help="directory to save per-stage PNGs (optional)")
    ap.add_argument("--wav", default="/root/reference/f2bjrop1.0.wav")
    args = ap.parse_args()

    cfg = MFCCConfig()
    F = args.frames
    T = cfg.nfft + (F - 1) * cfg.hop

    if os.path.exists(args.wav):
        from scipy.io import wavfile
        sr, audio = wavfile.read(args.wav)
        sig = audio[:T].astype(np.int64)
        print(f"input: {args.wav} ({sr} Hz), first {T} samples -> {F} frames")
    else:
        rng = np.random.default_rng(0)
        t = np.arange(T) / cfg.samplerate
        sig = np.round(8000 * np.sin(2 * np.pi * 700 * t)).astype(np.int64)
        print(f"input: synthetic 700 Hz tone, {T} samples -> {F} frames")
    stats("raw samples", sig, cfg.width)

    # -- stage 1: pre-emphasis --------------------------------------------------
    section("1. Pre-emphasis  y[t] = wrap16(x[t] + (x[t-1]>>5) - x[t-1])\n"
            "   = x[t] - (31/32) x[t-1]        (mfcc/core/preemph.py:20-27)")
    emph = int_ref.preemphasis_int(sig, cfg.width)
    stats("emphasized", emph, cfg.width)
    print(f"  first 8 in : {sig[:8].tolist()}")
    print(f"  first 8 out: {emph[:8].tolist()}")
    print("  note: >>5 then subtract is the RTL's shift-add form of *31/32;"
          "\n  wrap16 matches the signed-Signal overflow semantics.")

    # -- stage 2: framing -------------------------------------------------------
    section(f"2. Overlapped framing  window={cfg.windowlen}, hop={cfg.hop}\n"
            "   ring buffer re-reads windowlen-hop samples per frame "
            "(mfcc/core/frame.py:86-114)")
    frames = int_ref.frame_int(emph, cfg.nfft, cfg.hop, cfg.windowlen)[:F]
    stats("frames", frames)
    ov = cfg.windowlen - cfg.hop
    same = np.array_equal(frames[0][cfg.hop:cfg.windowlen], frames[1][:ov])
    print(f"  overlap check: frame0[{cfg.hop}:{cfg.windowlen}] == "
          f"frame1[:{ov}] -> {same}")

    # -- stage 3: Hamming window ------------------------------------------------
    section("3. Hamming window from a quarter-wave LUT + linear interpolation\n"
            "   64 entries x 8 bits for nfft=512 (mfcc/core/window.py:22-43)")
    lut, off_fst, off_lst = tables.hamming_lut(cfg.nfft, cfg.window_precision)
    print(f"  LUT entries={len(lut)}  off_fst={off_fst}  off_lst={off_lst}  "
          f"max={lut.max()}")
    curve = tables.int_window_curve(cfg.nfft, cfg.window_precision)
    stats("reconstructed curve", curve, cfg.window_precision + 2)
    win = int_ref.window_int(frames, cfg.nfft, cfg.window_precision,
                             cfg.width)
    stats("windowed frames", win, cfg.width)
    print("  multiply keeps the top 16 bits: (x * w) >> (precision+1) "
          "(window.py:84)")

    # -- stage 4: 512-pt radix-2 DIT FFT ---------------------------------------
    section("4. Radix-2 DIT FFT, 9 stages, twiddles round(2^14 e^(-j th))\n"
            "   bias-round (1<<13)-1 then >>14, /2 per stage "
            "(mfcc/misc/fft.py:93-96,188-191)")
    twr, twi = tables.twiddle_table(cfg.nfft, cfg.width)
    print(f"  twiddle table: {len(twr)} entries, re range "
          f"[{twr.min()}, {twr.max()}]  (stored quarter-circle in RTL, "
          "fft.py:29-36)")
    re, im = int_ref.fft_stream_int(win, cfg.width)
    stats("FFT real (bins 0..255)", re, cfg.width)
    stats("FFT imag", im, cfg.width)
    spec = np.fft.rfft(win[0].astype(np.float64))[:cfg.nfft // 2]
    scaled = spec / cfg.nfft               # the ladder's /2-per-stage = /N
    err = np.max(np.abs(scaled.real - re[0]))
    print(f"  vs numpy rfft/512 on frame 0: max |diff| = {err:.1f} "
          "(rounding each stage)")

    # -- stage 5: power spectrum -------------------------------------------------
    section("5. Power |X|^2 = r*r + i*i, keep top 30 of 33 bits\n"
            "   (mfcc/core/pow2.py:22-64, width_output=30)")
    power = int_ref.power_int(re, im, cfg.width, cfg.power_width)
    stats("power", power, cfg.power_width)

    # -- stage 6: mel filterbank --------------------------------------------------
    section("6. Mel filterbank: 32 triangles as ONE integer matrix\n"
            "   serial accumulator == closed-form matrix "
            "(mfcc/core/filterbank.py:22-34,90-115)")
    pts = tables.mel_filter_points(cfg.samplerate, cfg.nfft, cfg.nfilters)
    print(f"  mel bin edges: {pts.tolist()}")
    W = tables.int_filterbank_matrix(cfg.samplerate, cfg.nfft, cfg.nfilters,
                                     cfg.filter_wsize)
    print(f"  weight matrix: {W.shape}, max weight {W.max()} "
          f"(ascending = accumulator high half; descending = complement)")
    mel = int_ref.filterbank_int(power, cfg.samplerate, cfg.nfft,
                                 cfg.nfilters, cfg.filter_wsize,
                                 cfg.filter_gain, cfg.width,
                                 cfg.power_width)
    stats("mel energies", mel, cfg.width)

    # -- stage 7: fixed-point log2 -----------------------------------------------
    section("7. Log2, Clay S. Turner's method: normalize to [1,2) by\n"
            "   shifting, then 11 square-and-compare iterations -> Q4.11\n"
            "   (mfcc/core/log.py:57-102; zero clamps to 1, log.py:123-126)")
    logm = int_ref.log2fix_int(mel, cfg.width, cfg.log_width_output)
    stats("log2 (Q4.11)", logm, cfg.log_width_output + 1)
    v = int(mel[0, 0])
    print(f"  example: log2fix({v}) = {int(logm[0, 0])} "
          f"(= {int(logm[0, 0]) / 2048:.4f} * 2^11; float log2 = "
          f"{np.log2(max(v, 1)):.4f})")

    # -- stage 8: DCT-II via 4N FFT ----------------------------------------------
    section("8. DCT-II via a 128-pt FFT with zero-interleaved reflect fill\n"
            "   [0,a,0,b,...,0,d,0,d,...,0,a] (mfcc/core/dct_stream.py:29-37)")
    cep = int_ref.dct_int(logm, cfg.width)[:, :cfg.nceptrums]
    stats("cepstra", cep, cfg.width)
    print(f"\n  frame 0 cepstra: {cep[0].tolist()}")

    # -- cross-check ---------------------------------------------------------------
    section("Cross-checks (the notebooks' cell-45 role)")
    full = int_ref.mfcc_int(sig, cfg)[:F]
    print(f"  staged walk == int_ref.mfcc_int: {np.array_equal(cep, full)}")
    fl = float_ref.mfcc_float(sig.astype(np.float64), cfg)[:F]
    # the INT chain carries fixed-point scalings (Q4.11 log, filterbank
    # gain); fit the single scale factor and report the residual -- the
    # quantization cost the notebook quantifies (MFCC.ipynb cell 45)
    s = float((cep * fl).sum() / (fl * fl).sum())
    rel = np.abs(cep - s * fl).max() / np.abs(cep).max()
    print(f"  INT vs float pipeline: best-fit scale {s:.1f} "
          f"(~2^{np.log2(s):.2f}), residual {100 * rel:.2f}% of INT max -- "
          "\n  the quantization cost the notebook quantifies "
          "(MFCC.ipynb cell 45)")
    import jax.numpy as jnp
    from mfcc_jax import MFCC
    jcep = np.asarray(MFCC(cfg).int(jnp.asarray(sig, jnp.int32)))[:F]
    print(f"  JAX pipeline == oracle: {np.array_equal(jcep, cep)} "
          "(element-exact)")

    if args.plots:
        os.makedirs(args.plots, exist_ok=True)
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        figs = [
            ("1-preemph", lambda ax: (ax.plot(sig[:800], label="raw"),
                                      ax.plot(emph[:800], label="emphasized"),
                                      ax.legend())),
            ("3-window", lambda ax: (ax.plot(curve, label="int LUT curve"),
                                     ax.plot(win[0], label="windowed f0"),
                                     ax.legend())),
            ("4-fft", lambda ax: ax.plot(np.hypot(re[0], im[0]))),
            ("5-power", lambda ax: ax.semilogy(np.maximum(power[0], 1))),
            ("6-mel", lambda ax: ax.bar(range(cfg.nfilters), mel[0])),
            ("7-log", lambda ax: ax.plot(logm[0], "o-")),
            ("8-cepstra", lambda ax: ax.imshow(cep.T, aspect="auto",
                                               origin="lower")),
        ]
        for name, draw in figs:
            fig, ax = plt.subplots(figsize=(7, 3))
            draw(ax)
            ax.set_title(name)
            fig.tight_layout()
            fig.savefig(os.path.join(args.plots, f"{name}.png"), dpi=80)
            plt.close(fig)
        print(f"\nplots saved to {args.plots}/")


if __name__ == "__main__":
    main()
