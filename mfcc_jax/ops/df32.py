"""Compensated double-f32 ("f64ish") float pipeline.

The accuracy north star (BASELINE.md) is <=1e-5 max-abs-err vs the float64
oracle (the MFCC.ipynb cell-45 validation role); plain f32 bottoms out at
~1.2e-4 on real speech -- quiet mel bins amplify the DFT matmul's f32
accumulation error through log2.  The chain needs no f64 on the device
(its first target had none); on the GPU it meets the gate as it is.

This mode keeps every sensitive intermediate as an UNEVALUATED PAIR of f32
words (hi + lo, "double-word" arithmetic) and bounds the matmul's internal
f32 accumulation by CHUNKING each contraction:

  * operator constants enter as exact (hi, lo) f32 splits of their f64
    values (split in numpy, not on device -- astype-based on-device splits
    are silently broken by --xla_allow_excess_precision);
  * each K-chunk partial is ONE f32-HIGHEST matmul (short internal running
    sums), and partials combine across chunks with TwoSum compensation on
    elementwise, so the cross-chunk error is ~eps*|result| instead of
    ~eps*|running sum|*K;
  * the power / log stages propagate the lo words analytically:
    (s+e)^2 = s^2 + 2 s e + ... with s^2's rounding error recovered
    exactly via a mantissa-mask (Veltkamp-style) split, and
    log2(h + l) = log2(h) + l/(h ln 2) to O((l/h)^2).

Everything runs in plain XLA (jit-compatible, any backend); this is an
accuracy mode, not a throughput path.  Its error vs the float64 oracle
is checked by tests/test_float_parity.py and chip_smoke.py.
"""

from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp

from ..config import MFCCConfig
from .. import tables
from . import framing

_HIGHEST = jax.lax.Precision.HIGHEST


def _two_sum(a, b):
    """Knuth TwoSum: s + err == a + b exactly (f32)."""
    s = a + b
    bb = s - a
    err = (a - (s - bb)) + (b - bb)
    return s, err


def _acc(s, e, p):
    """Add p into the compensated accumulator (s, e)."""
    s, err = _two_sum(s, p)
    return s, e + err


def _split_hi(x):
    """Exact split x == hi + lo with hi holding the top 12 mantissa bits
    (mask the low 11): hi*hi, hi*lo and lo*lo are all exact in f32.
    Bit masking, NOT astype -- see module docstring."""
    xi = jax.lax.bitcast_convert_type(x, jnp.int32)
    hi = jax.lax.bitcast_convert_type(
        xi & jnp.int32(~np.int32(0x7FF)), jnp.float32)
    return hi, x - hi


def _square_df(s, e):
    """(s + e)^2 as a df32 pair: s*s plus its EXACT rounding error
    (recovered from the split pieces) plus the 2 s e cross term."""
    sh, sl = _split_hi(s)
    p = s * s
    perr = ((sh * sh - p) + 2.0 * sh * sl) + sl * sl
    corr = 2.0 * s * e + perr
    return _two_sum(p, corr)


def _np_split12(W: np.ndarray):
    """Exact numpy split of f32 W into a (top 12 mantissa bits) + b."""
    a = (W.view(np.int32) & np.int32(~np.int32(0x7FF))).view(np.float32)
    return np.ascontiguousarray(a), np.ascontiguousarray(W - a)


def _df_matmul(Xh, Xl, W64: np.ndarray, G: int):
    """df32 (Xh + Xl) @ W64 with EXACT hi-piece products and a chunked-
    compensated contraction.

    Both hi operands split into 12-bit-mantissa pieces (xa+xb, Wa+Wb) so
    every piece product is exact in f32 -- per-product rounding (the
    G-independent ~1e-5 floor measured without the split) vanishes, and
    only ACCUMULATION rounds.  The dominant xa@Wa term is chunked along K
    with TwoSum compensation across chunks (error ~eps*|result| instead of
    ~eps*running-sum*K); the 2^-12-scale cross terms, the W lo word and
    the X lo word ride single full-K matmuls (their internal error is
    ~2^-12 of the uncompensated one -- negligible)."""
    K = W64.shape[0]
    Wh = np.ascontiguousarray(W64.astype(np.float32))
    Wl = np.ascontiguousarray((W64 - Wh.astype(np.float64))
                              .astype(np.float32))
    Wa, Wb = _np_split12(Wh)
    xa, xb = _split_hi(Xh)
    s = e = None
    for g in range(0, K, G):
        sl = slice(g, g + G)
        # all three exact-product piece matmuls of this chunk go through
        # the compensated accumulator: leaving the 2^-12-scale cross terms
        # as full-K matmuls left a ~1.4e-5 G-independent floor (their own
        # f32 accumulation error; measured, docs/BENCH.md round 3b)
        for p in (jnp.matmul(xa[..., sl], jnp.asarray(Wa[sl]),
                             precision=_HIGHEST),
                  jnp.matmul(xa[..., sl], jnp.asarray(Wb[sl]),
                             precision=_HIGHEST),
                  jnp.matmul(xb[..., sl], jnp.asarray(Wa[sl]),
                             precision=_HIGHEST)):
            if s is None:
                s, e = p, jnp.zeros_like(p)
            else:
                s, e = _acc(s, e, p)
    # 2^-24-scale terms: single full-K matmuls (their internal error is
    # ~2^-24 of the uncompensated baseline -- negligible)
    for extra in (jnp.matmul(xb, jnp.asarray(Wb), precision=_HIGHEST),
                  jnp.matmul(Xh, jnp.asarray(Wl), precision=_HIGHEST)):
        s, e = _acc(s, e, extra)
    if Xl is not None:
        s, e = _acc(s, e, jnp.matmul(Xl, jnp.asarray(Wh),
                                     precision=_HIGHEST))
    return s, e


def _balanced_limbs_np(v: np.ndarray, n: int):
    """Balanced signed 7-bit limbs of integer v: v == sum li * 128^i,
    li in [-64, 63] (numpy int64, two's-complement & is mod-128)."""
    out = []
    r = v.astype(np.int64)
    for _ in range(n):
        li = ((r + 64) & 127) - 64
        out.append(li.astype(np.int8))
        r = (r - li) >> 7
    assert not r.any(), "value exceeds limb range"
    return out


def _int_limb_matmul(x, W64: np.ndarray, grid_bits: int = 5,
                     w_bits: int = 50):
    """EXACT contraction x @ W64 as int8 limb matmuls -> df32 result.

    Chunked f32 compensation bottoms out at ~2e-5 absolute for the DFT: the
    per-chunk partials' own f32 accumulation error is eps * |local term
    magnitude| regardless of chunk length (measured, docs/BENCH.md round
    3b).  But x here lies EXACTLY on the 2^-grid_bits grid (pre-emphasized
    integer samples), so the whole sum can be done in integers: x*2^grid
    and round(W*2^w_bits) decompose into balanced signed 7-bit limbs, every
    limb-pair product is exact in an int8 matmul with int32
    accumulation (|partial| <= K*64*64 < 2^24, no overflow), and the exact
    int32 partials recombine into a df32 pair with power-of-two scales.
    The ONLY error is the weight quantization: |x|_1 * 2^-(w_bits+1)
    ~ 3e-8 for the 512-point DFT.  This is the float twin of the INT
    path's limb filterbank (int_ops.filterbank_int32)."""
    K = W64.shape[0]
    xi = jnp.round(x * np.float32(1 << grid_bits)).astype(jnp.int32)
    xlimbs = []
    r = xi
    for _ in range(4):
        li = ((r + 64) & 127) - 64
        xlimbs.append(li.astype(jnp.int8))
        r = (r - li) >> 7
    Wq = np.round(W64 * float(1 << w_bits)).astype(np.int64)
    assert np.abs(Wq).max() < 1 << 62
    wlimbs = _balanced_limbs_np(Wq, -(-int(np.abs(Wq).max()).bit_length()
                                      // 7) + 1)
    s = e = None
    for i, xl in enumerate(xlimbs):
        for j, wl in enumerate(wlimbs):
            P = jnp.matmul(xl, jnp.asarray(wl),
                           preferred_element_type=jnp.int32)
            v = P.astype(jnp.float32) * np.float32(
                2.0 ** (7 * (i + j) - grid_bits - w_bits))
            if s is None:
                s, e = v, jnp.zeros_like(v)
            else:
                s, e = _acc(s, e, v)
    return s, e


def _pow2_dyn(g):
    """Exact f32 power of two 2**g for a traced int32 scalar g (clamped to
    the normal-exponent range): built by bit assembly, no transcendentals."""
    g = jnp.clip(g, -126, 127)
    return jax.lax.bitcast_convert_type(
        ((g + 127) << 23).astype(jnp.int32), jnp.float32)


def _limb_matmul_auto(x, W64: np.ndarray, w_bits: int = 50):
    """`_int_limb_matmul` for ARBITRARY-SCALE float input (ROADMAP item 5).

    The wire-grid variant is exact because x lies on the static 2^-5 grid;
    here the grid is chosen per call: g = 22 - floor(log2(max|x|)) so that
    xi = round(x * 2^g) fits 24 bits (xi, and xq = xi * 2^-g, are then
    EXACT in f32), the same 4 balanced 7-bit limbs cover it, and the
    off-grid residual r = x - xq (|r| <= 2^-(g+1), i.e. 2^-23 RELATIVE to
    the signal) rides one plain f32-HIGHEST matmul into the compensated
    accumulator -- its own rounding is ~2^-24 OF THE RESIDUAL, vanishing.
    Power-of-two scales are assembled by bit ops (`_pow2_dyn`), so the
    dynamic rescaling itself is exact; inputs with |x| outside
    ~[2^-100, 2^100] would hit the exponent clamp (audio never does)."""
    m = jnp.max(jnp.abs(x))
    mb = jax.lax.bitcast_convert_type(m, jnp.int32)
    g = jnp.where(m > 0, 22 - ((mb >> 23) - 127), 0)
    xi = jnp.round(x * _pow2_dyn(g)).astype(jnp.int32)
    xr = x - xi.astype(jnp.float32) * _pow2_dyn(-g)
    xlimbs = []
    r = xi
    for _ in range(4):
        li = ((r + 64) & 127) - 64
        xlimbs.append(li.astype(jnp.int8))
        r = (r - li) >> 7
    Wq = np.round(W64 * float(1 << w_bits)).astype(np.int64)
    assert np.abs(Wq).max() < 1 << 62
    wlimbs = _balanced_limbs_np(Wq, -(-int(np.abs(Wq).max()).bit_length()
                                      // 7) + 1)
    inv = _pow2_dyn(-g)
    s = e = None
    for i, xl in enumerate(xlimbs):
        for j, wl in enumerate(wlimbs):
            P = jnp.matmul(xl, jnp.asarray(wl),
                           preferred_element_type=jnp.int32)
            # static 2^(7(i+j)-w_bits) first, dynamic 2^-g second: both
            # power-of-two multiplies are exact and the split keeps each
            # factor inside the normal-f32 exponent range
            v = (P.astype(jnp.float32)
                 * np.float32(2.0 ** (7 * (i + j) - w_bits))) * inv
            if s is None:
                s, e = v, jnp.zeros_like(v)
            else:
                s, e = _acc(s, e, v)
    s, e = _acc(s, e, jnp.matmul(
        xr, jnp.asarray(W64.astype(np.float32)), precision=_HIGHEST))
    return s, e


_LOG2_LUT_N = 64
_log2_lut64 = np.log2(1.0 + np.arange(_LOG2_LUT_N + 1) / _LOG2_LUT_N)
_LOG2C_HI = _log2_lut64.astype(np.float32)
_LOG2C_LO = (_log2_lut64 - _LOG2C_HI.astype(np.float64)).astype(np.float32)
_INV_LN2 = 1.4426950408889634


def _log2_df(mh, ml):
    """df32 log2(mh + ml) WITHOUT device transcendentals (a device log2/exp2
    may carry several-ulp errors that alone exceed the 1e-5 budget).  Exact bit decomposition mh = 2^k * u,
    u in [1, 2); nearest LUT point c = 1 + i/64 with log2(c) stored as an
    (hi, lo) f64-accurate pair; u - c is EXACT (same binade), and the
    residual series log2(1 + v), v = (u-c)/c <= 1/128, needs only 4 terms.
    The lo word ml enters as ml/(mh ln 2)."""
    xi = jax.lax.bitcast_convert_type(mh, jnp.int32)
    k = (xi >> 23) - 127
    u = jax.lax.bitcast_convert_type(
        (xi & jnp.int32(0x7FFFFF)) | jnp.int32(127 << 23), jnp.float32)
    i = jnp.round((u - 1.0) * _LOG2_LUT_N).astype(jnp.int32)
    c = 1.0 + i.astype(jnp.float32) / np.float32(_LOG2_LUT_N)
    d = u - c                                  # exact: same binade
    v = d / c
    v2 = v * v
    p = v * (1.0 - v * (0.5 - v * np.float32(1.0 / 3.0))) \
        - v2 * v2 * np.float32(0.25)           # log(1+v) to O(v^5)
    hi_i = jnp.take(jnp.asarray(_LOG2C_HI), i)
    lo_i = jnp.take(jnp.asarray(_LOG2C_LO), i)
    s, e = _two_sum(k.astype(jnp.float32), hi_i)
    corr = lo_i + p * np.float32(_INV_LN2) \
        + ml / (mh * np.float32(np.log(2.0)))
    return _two_sum(s, e + corr)


@functools.lru_cache(maxsize=None)
def _operators64(cfg: MFCCConfig):
    C, S = tables.windowed_rdft_matrix(cfg.nfft)          # f64
    CS = np.concatenate([C, S], axis=1)                   # (nfft, 2*nbins)
    mel = tables.float_mel_matrix(cfg.samplerate, cfg.nfft, cfg.nfilters)
    dct = tables.dct2_ortho_matrix(cfg.nfilters)[:, : cfg.nceptrums]
    return CS, mel.astype(np.float64), dct.astype(np.float64)


def mfcc_frames_f64ish(frames: jnp.ndarray, cfg: MFCCConfig = MFCCConfig(),
                       *, group: int = 32,
                       wire_grid: bool = True) -> jnp.ndarray:
    """Compensated double-f32 MFCC on pre-emphasized frames:
    (..., F, nfft) -> (..., F, nceptrums), targeting <=1e-5 vs the float64
    oracle without f64 hardware support.  ``group``: contraction chunk
    length for the DFT/mel stages (shorter = less in-matmul f32
    accumulation, more compensation work).  ``wire_grid``: samples lie
    exactly on the 2^-5 grid (pre-emphasized integer wire samples -- the
    default contract); pass False for arbitrary-scale float input (e.g.
    librosa-style [-1, 1] audio), which (a) renormalizes the frames by an
    EXACT power of two 2^-G into the canonical int16 magnitude band -- a
    2^G input scale shifts every log-mel value by exactly 2G, which costs
    nothing in exact math but inflates the DCT stage's f32 partial-sum
    rounding ~linearly in |G| (measured 1.3e-5 at G=20 unnormalized) --
    and (b) switches the DFT to the dynamically-scaled limb contraction
    (`_limb_matmul_auto`).  The log-mel shift moves ONLY c0 (the k>0
    DCT-II rows sum to zero), restored as c0 += 2G*sqrt(nfilters) through
    a TwoSum so the restore adds no rounding of its own.  NB outputs are
    f32: a coefficient's best representable error is half its own ulp,
    which exceeds 1e-5 once |value| > ~168 (c0 at extreme input scales)."""
    CS64, mel64, dct64 = _operators64(cfg)
    nbins = cfg.nbins_float
    x = frames.astype(jnp.float32)       # int16-range samples: exact

    if wire_grid:
        G = None
        reim_h, reim_l = _int_limb_matmul(x, CS64)
    else:
        m = jnp.max(jnp.abs(x))
        mb = jax.lax.bitcast_convert_type(m, jnp.int32)
        G = jnp.where(m > 0, ((mb >> 23) - 127) - 14, 0)
        x = x * _pow2_dyn(-G)            # exact power-of-two rescale
        reim_h, reim_l = _limb_matmul_auto(x, CS64)
    re_h, im_h = reim_h[..., :nbins], reim_h[..., nbins:]
    re_l, im_l = reim_l[..., :nbins], reim_l[..., nbins:]
    ph, pl = _square_df(re_h, re_l)
    qh, ql = _square_df(im_h, im_l)
    pw_h, err = _two_sum(ph, qh)
    pw_l = pl + ql + err

    mh, ml = _df_matmul(pw_h, pw_l, mel64, group)
    y_h, y_l = _log2_df(mh, ml)

    out_h, out_l = _df_matmul(y_h, y_l, dct64, min(group, 8))
    if G is not None:
        # restore the renormalization's exact c0 shift (see docstring)
        c0fix = (2.0 * G.astype(jnp.float32)) * np.float32(
            np.sqrt(cfg.nfilters))
        s, err = _two_sum(out_h[..., 0], c0fix)
        out_h = out_h.at[..., 0].set(s)
        out_l = out_l.at[..., 0].add(err)
    return out_h + out_l


def mfcc_batch_f64ish(audio: jnp.ndarray, cfg: MFCCConfig = MFCCConfig(),
                      *, group: int = 32,
                      wire_grid: bool = True) -> jnp.ndarray:
    """Full compensated pipeline on raw signals: (..., T) -> (..., F, ncep).

    Pre-emphasis of int16-range samples is EXACT in f32 (x - (31/32)*prev:
    both operands are multiples of 2^-5 below 2^16, so the subtraction
    needs <= 21 significand bits).  With ``wire_grid=False`` (arbitrary
    float input) pre-emphasis rounds at f32 eps -- a ~2^-24 RELATIVE frame
    perturbation, i.e. ~1e-7 absolute in the log-mel domain, inside the
    1e-5 budget (measured: tests/test_float_parity.py)."""
    emph = framing.preemphasis(audio.astype(jnp.float32))
    frames = framing.extract_frames(emph, cfg.nfft, cfg.hop,
                                    windowlen=cfg.windowlen)
    return mfcc_frames_f64ish(frames, cfg, group=group, wire_grid=wire_grid)
