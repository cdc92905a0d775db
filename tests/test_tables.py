"""Constant-table generators vs values stated in / derived from the reference
source (pure numpy, no JAX)."""

import numpy as np
import scipy.fft

from mfcc_jax import tables
from mfcc_jax.ref import int_ref


def test_hamming_lut_documented_values():
    # window.py:42 prints mem.init; SURVEY.md records off_fst=40, off_lst=470,
    # max LUT value 233, 64 entries for nfft=512/precision=8.
    mem, off_fst, off_lst = tables.hamming_lut(512, 8)
    assert off_fst == 40
    assert off_lst == 470
    assert len(mem) == 64
    assert mem.max() == 233
    assert mem.min() == 0


def test_int_window_curve_tracks_float_window():
    curve = tables.int_window_curve(512, 8)
    ideal = tables.float_window(512) * 511
    assert curve.shape == (512,)
    # quarter-LUT + lerp reconstruction is within ~2.5 LSB of the ideal curve
    assert np.abs(curve - ideal).max() < 2.5
    # horizontal symmetry of the underlying window: curve is built from
    # reflected addresses; end of curve returns near off_fst
    assert curve[0] <= 45 and curve[256] >= 508


def test_mel_filter_points():
    # filterbank.py:15-20; SURVEY.md cites [0,1,3,5,8,10,13,...,235,256]
    pts = tables.mel_filter_points(16000, 512, 32)
    assert pts[0] == 0 and pts[1] == 1 and pts[2] == 3 and pts[3] == 5
    assert pts[-2] == 235 and pts[-1] == 256
    assert len(pts) == 34
    assert np.all(np.diff(pts) >= 1)


def test_mel_filter_steps_formula():
    pts = tables.mel_filter_points(16000, 512, 32)
    steps = tables.mel_filter_steps(pts, 30)
    max_acc = 1 << 60
    for i in range(len(pts) - 1):
        diff = int(pts[i + 1] - pts[i]) - 1
        expect = (max_acc // diff) - 1 if diff else max_acc - 1
        assert int(steps[i]) == expect


def test_int_filterbank_matrix_equals_sequential_datapath():
    rng = np.random.default_rng(7)
    for seed in range(3):
        power = rng.integers(0, 1 << 30, size=256).astype(np.int64)
        seq = int_ref.filterbank_int_sequential(power)
        mat = int_ref.filterbank_int(power)
        assert np.array_equal(seq, mat)
        assert len(seq) == 32


def test_twiddle_table_values():
    re, im = tables.twiddle_table(512, 16)
    assert re[0] == 1 << 14 and im[0] == 0
    # 90 degrees: entry 128 is e^{-j pi/2} -> (0, -2^14) via the decoder
    assert re[128] == 0 and im[128] == -(1 << 14)
    # magnitude close to 2^14 everywhere
    mag = np.hypot(re.astype(float), im.astype(float))
    assert np.abs(mag - (1 << 14)).max() < 1.0
    # matches round(2^14 e^{-j pi k/256}) in the first quarter
    k = np.arange(128)
    ideal = np.round((1 << 14) * np.exp(-1j * np.pi * k / 256))
    assert np.array_equal(re[:128], ideal.real.astype(np.int64))
    assert np.array_equal(im[:128], ideal.imag.astype(np.int64))


def test_bit_reverse_permutation():
    perm = tables.bit_reverse_permutation(8)
    assert list(perm) == [0, 4, 2, 6, 1, 5, 3, 7]


def test_dit_stage_plan_covers_all_pairs():
    for size in (8, 128, 512):
        for i0, i1, tw in tables.dit_stage_plan(size):
            touched = np.concatenate([i0, i1])
            assert sorted(touched) == list(range(size))
            assert tw.max() < size // 2


def test_dct2_ortho_matrix_matches_scipy():
    x = np.random.default_rng(3).standard_normal((4, 32))
    want = scipy.fft.dct(x, type=2, norm="ortho", axis=-1)
    got = x @ tables.dct2_ortho_matrix(32)
    np.testing.assert_allclose(got, want, atol=1e-12)


def test_windowed_rdft_matrix_matches_rfft():
    rng = np.random.default_rng(4)
    x = rng.standard_normal((3, 512))
    C, S = tables.windowed_rdft_matrix(512)
    got = (x @ C) + 1j * (x @ S)
    want = np.fft.rfft(x * tables.float_window(512), axis=-1) / 512
    np.testing.assert_allclose(got, want, atol=1e-10)


def test_dct_fill_layout():
    pos_a, pos_b = tables.dct_fill_layout(4)
    assert list(pos_a) == [1, 3, 5, 7]
    assert list(pos_b) == [15, 13, 11, 9]
