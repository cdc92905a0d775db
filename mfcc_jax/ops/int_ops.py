"""Bit-exact fixed-point MFCC pipeline, vectorized over frames.

Replicates the RTL's integer arithmetic (see mfcc_jax/ref/int_ref.py for the
per-stage derivations with reference file:line citations) with int32 lane
arithmetic wherever 32-bit wraparound provably preserves the reference's
truncated 16-bit outputs, and int64 only where the datapath genuinely wraps
mod 2^64 (the FilterBank o_regb accumulator, mfcc/core/filterbank.py:77).

Exactness argument for int32 in the FFT butterfly: the output keeps only
wrap16((x0 + (sub >> 14)) >> 1); for any k, (sub + k*2^32) >> 14 differs by
k*2^18 which is 0 mod 2^17, and only the sum mod 2^17 survives the final
>>1 + 16-bit truncation.  So natural int32 wraparound is invisible in the
result.  The same argument covers every other int32 stage; the test suite
asserts element-exact equality with the unbounded-int oracle.

int64 requires x64 mode: wrap public entry points in ``jax.enable_x64()``
(mfcc_jax.pipeline does this).  The int64 filterbank is written as
broadcast-multiply + sum rather than an s64 dot_general, which not every
XLA backend lowers.
"""

from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp

from ..config import MFCCConfig
from .. import tables
from .framing import wrap_signed, preemphasis_int  # noqa: F401  (re-export)


# ---------------------------------------------------------------------------
# Window (mfcc/core/window.py:84)
# ---------------------------------------------------------------------------

def window_int(frames: jnp.ndarray, nfft: int = 512, precision: int = 8,
               width: int = 16) -> jnp.ndarray:
    """(x * curve) >> (precision+1), truncated to ``width`` bits."""
    curve = jnp.asarray(tables.int_window_curve(nfft, precision), jnp.int32)
    prod = frames.astype(jnp.int32) * curve
    return wrap_signed(prod >> (precision + 1), width)


# ---------------------------------------------------------------------------
# Radix-2 DIT FFT (mfcc/misc/fft.py), int32, stages unrolled at trace time
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _stage_twiddles(size: int, width: int):
    """Per-stage twiddle vectors (length 2^s) as numpy int32 constants."""
    twr, twi = tables.twiddle_table(size, width)
    nstages = int(np.log2(size))
    out = []
    for s in range(nstages):
        stride = 1 << (nstages - 1 - s)
        out.append((twr[::stride][: 1 << s].astype(np.int32),
                    twi[::stride][: 1 << s].astype(np.int32)))
    return out


def _butterfly(x0r, x0i, x1r, x1i, twr, twi, width: int):
    """The Butterfly datapath (mfcc/misc/fft.py:140-192) in int32."""
    bias = (1 << (width - 3)) - 1          # (1 << bias_width-1) - 1, fft.py:94
    bias_width = width - 2
    m0 = (x1r + x1i) * twr
    m1 = x1i * (twr + twi)
    m2 = x1r * (twr - twi)
    sub1 = (m0 + bias - m1) >> bias_width
    sub2 = (m0 + bias - m2) >> bias_width
    y0r = wrap_signed((x0r + sub1) >> 1, width)
    y0i = wrap_signed((x0i + sub2) >> 1, width)
    y1r = wrap_signed((x0r - sub1) >> 1, width)
    y1i = wrap_signed((x0i - sub2) >> 1, width)
    return y0r, y0i, y1r, y1i


def fft_int(re: jnp.ndarray, im: jnp.ndarray | None = None,
            width: int = 16) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Block FFT over the last axis, (..., size) int32 -> (re, im) int32.

    Bit-reversed load (fft.py:413-418) is a constant gather; each of the
    log2(size) stages is a static reshape-split butterfly over the last
    dimension -- the vectorized replacement for the 3-bank RAM scheduler
    (fft.py:197-346), whose banking exists only to feed one butterfly/cycle.
    """
    size = re.shape[-1]
    nstages = int(np.log2(size))
    assert 1 << nstages == size
    perm = jnp.asarray(tables.bit_reverse_permutation(size))
    wr = re.astype(jnp.int32)[..., perm]
    wi = (jnp.zeros_like(wr) if im is None else im.astype(jnp.int32)[..., perm])
    lead = wr.shape[:-1]

    for s, (twr_np, twi_np) in enumerate(_stage_twiddles(size, width)):
        groups = size >> (s + 1)
        v_r = wr.reshape(lead + (groups, 2, 1 << s))
        v_i = wi.reshape(lead + (groups, 2, 1 << s))
        x0r, x1r = v_r[..., 0, :], v_r[..., 1, :]
        x0i, x1i = v_i[..., 0, :], v_i[..., 1, :]
        twr = jnp.asarray(twr_np)
        twi = jnp.asarray(twi_np)
        y0r, y0i, y1r, y1i = _butterfly(x0r, x0i, x1r, x1i, twr, twi, width)
        wr = jnp.stack([y0r, y1r], axis=-2).reshape(lead + (size,))
        wi = jnp.stack([y0i, y1i], axis=-2).reshape(lead + (size,))
    return wr, wi


def fft_stream_int(frames: jnp.ndarray, width: int = 16):
    """Real input, first nfft//2 bins (mfcc/core/fft_stream.py:24,28)."""
    re, im = fft_int(frames, None, width)
    half = frames.shape[-1] // 2
    return re[..., :half], im[..., :half]


# ---------------------------------------------------------------------------
# Power spectrum (mfcc/core/pow2.py:33,64)
# ---------------------------------------------------------------------------

def power_int(re: jnp.ndarray, im: jnp.ndarray, width: int = 16,
              width_output: int = 30) -> jnp.ndarray:
    """(r*r + i*i) as a 2*width-bit field, keep the top width_output bits.
    For 16->30: logical shift right by 2 of the mod-2^32 bit pattern."""
    s = re * re + im * im                      # wraps mod 2^32 in int32
    shift = jnp.asarray(2 * width - width_output, s.dtype)
    return jax.lax.shift_right_logical(s, shift)


# ---------------------------------------------------------------------------
# Mel filterbank (mfcc/core/filterbank.py) -- int64 required
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _fb_constants(sample_rate: int, nfft: int, ntap: int, wsize: int,
                  gain: int, width_output: int, width: int):
    import math
    points = tables.mel_filter_points(sample_rate, nfft, ntap)
    maxvalrange = int(math.log2(int(points[-1] - points[-3]))) + width + wsize
    shift = maxvalrange - gain - width_output
    W = tables.int_filterbank_matrix(sample_rate, nfft, ntap, wsize)
    return np.array([[int(v) for v in row] for row in W], dtype=np.int64), shift


def filterbank_int(power: jnp.ndarray, sample_rate: int = 16000,
                   nfft: int = 512, ntap: int = 32, wsize: int = 30,
                   gain: int = 18, width_output: int = 16,
                   width: int = 30) -> jnp.ndarray:
    """out[j] = ((power . W[:, j]) >> shift) & (2^width_output - 1) with the
    exact integer weight matrix (tables.int_filterbank_matrix).  Requires x64
    (the o_regb accumulator wraps mod 2^64, filterbank.py:77); implemented as
    broadcast-multiply + reduce because not every backend has an s64 dot.
    """
    if not jax.config.jax_enable_x64:
        raise RuntimeError(
            "filterbank_int needs int64: call under jax.enable_x64() "
            "(mfcc_jax.pipeline wraps this for you)")
    Wnp, shift = _fb_constants(sample_rate, nfft, ntap, wsize, gain,
                               width_output, width)
    W = jnp.asarray(Wnp)
    p64 = power.astype(jnp.int64)
    acc = jnp.sum(p64[..., :, None] * W, axis=-2)    # wraps mod 2^64
    return ((acc >> shift) & ((1 << width_output) - 1)).astype(jnp.int32)


_FB_NLIMB = 4                                  # 8-bit limbs of <=31-bit ints


@functools.lru_cache(maxsize=None)
def _fb_limb_operator(sample_rate: int, nfft: int, ntap: int, wsize: int,
                      gain: int, width_output: int, width: int):
    """The limb-pair products of filterbank_int32 as ONE matmul operand.

    Returns (rhs, pairs, shift): ``pairs`` lists the (d limb j, W limb i)
    pairs whose weight 2^(8(i+j)) matters mod 2^(shift + width_output), and
    ``rhs`` is (NLIMB*K, len(pairs)*N) with W limb i in row block j of pair
    p's column block, zeros elsewhere.  [d limb 0 | ... | d limb 3] @ rhs
    then yields every pair's partial sums side by side."""
    Wnp, shift = _fb_constants(sample_rate, nfft, ntap, wsize, gain,
                               width_output, width)
    need_bits = shift + width_output          # 47 for the default config
    w8 = [((Wnp >> (8 * i)) & 0xFF) for i in range(_FB_NLIMB)]
    # exactness bound: per-output partial sums d_limb . W_limb <= 255 * sum W_limb
    assert max(int((255 * w.sum(axis=0)).max()) for w in w8) < (1 << 24), \
        "limb partial sum would exceed f32 integer exactness"
    K, N = Wnp.shape
    pairs = [(j, i) for j in range(_FB_NLIMB) for i in range(_FB_NLIMB)
             if 8 * (i + j) < need_bits]      # the rest are 0 mod 2^need_bits
    rhs = np.zeros((_FB_NLIMB * K, len(pairs) * N), np.float32)
    for p, (j, i) in enumerate(pairs):
        rhs[j * K:(j + 1) * K, p * N:(p + 1) * N] = w8[i]
    return rhs, tuple(pairs), shift


def filterbank_int32(power: jnp.ndarray, sample_rate: int = 16000,
                     nfft: int = 512, ntap: int = 32, wsize: int = 30,
                     gain: int = 18, width_output: int = 16,
                     width: int = 30) -> jnp.ndarray:
    """x64-free exact filterbank: same result as filterbank_int, no int64.

    The emitted band value is ``(S >> shift) & (2^width_output - 1)`` with
    S = sum_k d_k * W[k, j] needed only mod 2^(shift + width_output) = 2^46
    for the default config.  Decompose d and W into 8-bit limbs: every
    limb-pair partial sum over the nbins axis is < 2^24 (asserted) and
    therefore EXACT in a matmul with f32 accumulation.  The 8-bit limb
    operands are themselves exact in bfloat16 (8 mantissa bits hold integers
    to 256), so the products run as single-pass bf16 matmul work (exact
    products, f32 accumulation) for bit-identical results.

    All limb pairs go through ONE matmul (see _fb_limb_operator) rather
    than one per pair: XLA's GPU backend merges same-operand matmuls into a
    GEMM whose row-concatenated prologue returned wrong rows in some runs on
    an H100, and a single dot gives it nothing to merge.  The limb partial
    sums are then recombined in int32 using base-2^23 digits covering bits
    [0, 46): the output field (bits shift..shift+15) lies entirely inside
    the digit window.
    """
    assert width_output <= 23
    rhs, pairs, shift = _fb_limb_operator(sample_rate, nfft, ntap, wsize,
                                          gain, width_output, width)
    lead, K = power.shape[:-1], power.shape[-1]
    N = rhs.shape[1] // len(pairs)
    d32 = power.astype(jnp.int32)
    limbs = (d32[..., None, :]
             >> jnp.asarray(8 * np.arange(_FB_NLIMB), jnp.int32)[:, None]) & 0xFF
    lhs = limbs.reshape(lead + (_FB_NLIMB * K,)).astype(jnp.bfloat16)
    prods = jnp.matmul(lhs, jnp.asarray(rhs, jnp.bfloat16),
                       preferred_element_type=jnp.float32)
    prods = prods.astype(jnp.int32).reshape(lead + (len(pairs), N))  # exact

    # base-2^23 digits D[0..3] of S; each stays < 2^28 before normalization
    ndig = 4
    D = [None] * ndig
    def _acc(d, v):
        D[d] = v if D[d] is None else D[d] + v
    for p, (j, i) in enumerate(pairs):
        P = prods[..., p, :]
        s = 8 * (i + j)
        t = s % 23
        d = s // 23
        _acc(d, (P & ((1 << (23 - t)) - 1)) << t)
        if d + 1 < ndig:
            _acc(d + 1, P >> (23 - t))
    zero = jnp.zeros(lead + (N,), jnp.int32)
    D = [zero if v is None else v for v in D]
    mask23 = (1 << 23) - 1
    for d in range(ndig - 1):                  # carry-normalize
        D[d + 1] = D[d + 1] + (D[d] >> 23)
        D[d] = D[d] & mask23
    q, r = divmod(shift, 23)
    out = (D[q] >> r)
    if r:
        out = out | (D[q + 1] << (23 - r))
    return (out & ((1 << width_output) - 1)).astype(jnp.int32)


# ---------------------------------------------------------------------------
# Fixed-point log2 (mfcc/core/log.py) -- int32, fixed iteration count
# ---------------------------------------------------------------------------

def log2fix_int(data: jnp.ndarray, width: int = 16,
                width_output: int = 15) -> jnp.ndarray:
    """Turner's method, branch-free: clz-style normalize then precision-1
    square-and-compare rounds (the RTL's serial FSM, log.py:57-102, has a
    statically bounded trip count so it unrolls exactly)."""
    import math
    precision = width_output - math.ceil(math.log2(width))
    d = data.astype(jnp.int32)
    d = jnp.where(d == 0, 1, d)                       # log.py:123-126
    # shifts = floor(log2(d)) via thresholds (d < 2^width)
    shifts = jnp.zeros_like(d)
    for j in range(1, width):
        shifts = shifts + (d >= (1 << j)).astype(jnp.int32)
    z = (d << precision) >> shifts                    # in [2^p, 2^(p+1))
    res = shifts << precision
    b = 1 << (precision - 1)
    for _ in range(precision - 1):
        c = z * z                                     # < 2^(2p+2) <= 2^24
        hi = (c >> (2 * precision + 1)) & 1
        res = res + jnp.where(hi == 1, b, 0)
        z = jnp.where(hi == 1, c >> (precision + 1), c >> precision)
        b >>= 1
    return res & ((1 << width_output) - 1)


def log2fixcalc_int(x: jnp.ndarray, width: int, precision: int,
                    allow_fraction_input: bool = False) -> jnp.ndarray:
    """Branch-free twin of the raw ``Log2FixCalc`` FSM (mfcc/core/log.py:8-102)
    including its SHIFT-LEFT fraction-input mode (log.py:47-55), which no
    reference target instantiates (Log2Fix always feeds ``data << precision``
    so the input is never below 2^precision) but the component offers.

    ``x`` is the ALREADY-SHIFTED register value.  In fraction mode, inputs in
    [1, 2^precision) are normalized UP, each left shift subtracting
    2^precision from the (width-bit, wrapping) result register -- negative
    log2 exponents.  Without fraction mode such inputs pass through the
    SHIFT-RIGHT state unnormalized, exactly as the RTL would.  Input domain
    x >= 1: the raw FSM would never leave SHIFT-LEFT on 0 (Log2Fix clamps
    0 -> 1 upstream, log.py:123-126).  Returns the raw width-bit register
    value (unsigned)."""
    assert precision <= 14, "z*z must stay exact in int32"
    d = x.astype(jnp.int32)
    # floor(log2(d)) via thresholds over the width-bit range
    shifts = jnp.zeros_like(d)
    for j in range(1, width):
        shifts = shifts + (d >= (1 << j)).astype(jnp.int32)
    e = shifts - precision                 # net normalize exponent
    if not allow_fraction_input:
        e = jnp.maximum(e, 0)
    z = jnp.where(e >= 0, d >> jnp.maximum(e, 0),
                  d << jnp.maximum(-e, 0))
    res = e << precision
    b = 1 << (precision - 1)
    for _ in range(precision - 1):
        c = z * z
        hi = (c >> (2 * precision + 1)) & 1
        res = res + jnp.where(hi == 1, b, 0)
        z = jnp.where(hi == 1, c >> (precision + 1), c >> precision)
        b >>= 1
    return res & ((1 << width) - 1)


# ---------------------------------------------------------------------------
# DCT via 4N FFT (mfcc/core/dct_stream.py:29-37)
# ---------------------------------------------------------------------------

def dct_int(x: jnp.ndarray, width: int = 16) -> jnp.ndarray:
    """buf[2k+1] = x[k], buf[4N-1-2k] = x[k], zeros elsewhere; 4N INT FFT;
    first N real bins.  The scatter is two static interleaves."""
    n = x.shape[-1]
    x = x.astype(jnp.int32)
    z = jnp.zeros_like(x)
    first = jnp.stack([z, x], axis=-1).reshape(x.shape[:-1] + (2 * n,))
    second = jnp.stack([z, x[..., ::-1]], axis=-1).reshape(
        x.shape[:-1] + (2 * n,))
    buf = jnp.concatenate([first, second], axis=-1)
    re, _ = fft_int(buf, None, width)
    return re[..., :n]


# ---------------------------------------------------------------------------
# Full INT pipeline (mfcc/core/mfcc.py:90-104)
# ---------------------------------------------------------------------------

def _fb_int32_layout_ok(cfg: MFCCConfig) -> bool:
    """filterbank_int32 covers any layout whose needed bits fit the 4-digit
    base-2^23 window (always true for the reference config family)."""
    _, shift = _fb_constants(cfg.samplerate, cfg.nfft, cfg.nfilters,
                             cfg.filter_wsize, cfg.filter_gain, 16,
                             cfg.power_width)
    return shift + 16 <= 23 * 3 + 1 and shift // 23 + 1 < 4


def mfcc_int_frames(frames: jnp.ndarray, cfg: MFCCConfig = MFCCConfig()
                    ) -> jnp.ndarray:
    """Fixed-point pipeline on pre-emphasized int frames:
    (..., F, nfft) int32 -> (..., F, nceptrums) int32 (int16-range values).

    Runs entirely in int32/f32 (no x64 needed) for the default config
    family; falls back to the int64 filterbank otherwise.  The sample
    datapath honors cfg.width (validated consistent); the filterbank output
    / log2 input width is the reference's architectural constant
    (config.FILTERBANK_WIDTH, mfcc/core/mfcc.py:69,82)."""
    from ..config import FILTERBANK_WIDTH
    cfg.validate_int()
    win = window_int(frames, cfg.nfft, cfg.window_precision, cfg.width)
    re, im = fft_stream_int(win, cfg.width)
    power = power_int(re, im, cfg.width, cfg.power_width)
    fb = filterbank_int32 if _fb_int32_layout_ok(cfg) else filterbank_int
    mel = fb(power, cfg.samplerate, cfg.nfft, cfg.nfilters,
             cfg.filter_wsize, cfg.filter_gain, FILTERBANK_WIDTH,
             cfg.power_width)
    logmel = log2fix_int(mel, FILTERBANK_WIDTH, cfg.log_width_output)
    cep = dct_int(logmel, cfg.width)
    return cep[..., : cfg.nceptrums]


def mfcc_int_batch(audio: jnp.ndarray, cfg: MFCCConfig = MFCCConfig()
                   ) -> jnp.ndarray:
    """Full INT pipeline on raw int16-range signals:
    (..., T) int32 -> (..., F, nceptrums) int32."""
    from .framing import extract_frames
    emph = preemphasis_int(audio.astype(jnp.int32), width=cfg.width)
    frames = extract_frames(emph, cfg.nfft, cfg.hop,
                            windowlen=cfg.windowlen)
    return mfcc_int_frames(frames, cfg)
