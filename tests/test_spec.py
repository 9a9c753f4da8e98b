"""Unit tests for SPEC.md tables and integer primitives (SURVEY.md §4.5,
"Unit (pure, device-free)" tier)."""

import numpy as np
import pytest

from video_encoder.codec import spec


def test_zigzag_is_permutation():
    assert sorted(spec.ZIGZAG.tolist()) == list(range(64))
    assert np.array_equal(spec.ZIGZAG[spec.UNZIGZAG], np.arange(64))
    assert np.array_equal(spec.UNZIGZAG[spec.ZIGZAG], np.arange(64))


def test_zigzag_roundtrip(rng):
    x = rng.integers(-100, 100, size=(7, 6, 64)).astype(np.int32)
    zz = x[..., spec.ZIGZAG]
    back = np.zeros_like(x)
    back[..., spec.ZIGZAG] = zz
    assert np.array_equal(back, x)


def test_zigzag_first_entries():
    # SPEC.md §5 pinned prefix
    assert spec.ZIGZAG[:8].tolist() == [0, 1, 8, 16, 9, 2, 3, 10]
    assert spec.ZIGZAG[-3:].tolist() == [55, 62, 63]


def test_b_matrix_is_rounded_dct():
    j = np.arange(8)
    o = np.zeros((8, 8))
    o[0] = 1.0 / (2.0 * np.sqrt(2.0))
    for i in range(1, 8):
        o[i] = 0.5 * np.cos((2 * j + 1) * i * np.pi / 16.0)
    expect = np.floor(1024 * o + 0.5).astype(np.int64)
    assert np.array_equal(spec.B_MATRIX.astype(np.int64), expect)


def test_b_matrix_symmetries():
    b = spec.B_MATRIX
    # even rows symmetric, odd rows antisymmetric
    for i in range(0, 8, 2):
        assert np.array_equal(b[i], b[i][::-1])
    for i in range(1, 8, 2):
        assert np.array_equal(b[i], -b[i][::-1])


def test_rshift_round():
    assert spec.rshift_round(np.array([5]), 1)[0] == 3          # 2.5 -> 3
    assert spec.rshift_round(np.array([-5]), 1)[0] == -3        # -2.5 -> -3
    assert spec.rshift_round(np.array([4]), 2)[0] == 1
    assert spec.rshift_round(np.array([6]), 2)[0] == 2          # 1.5 -> 2
    assert spec.rshift_round(np.array([-6]), 2)[0] == -2
    assert spec.rshift_round(np.array([0]), 10)[0] == 0


def test_qstep_table():
    assert spec.QSTEP[0] == 1
    assert spec.QSTEP[6] == 2
    assert spec.QSTEP[12] == 4
    assert spec.QSTEP[60] == 1024
    assert spec.QSTEP[63] == 1448
    assert np.all(np.diff(spec.QSTEP.astype(np.int64)) >= 0)


def test_transform_roundtrip_bound(rng):
    x = rng.integers(-255, 256, size=(64, 8, 8)).astype(np.int32)
    c = spec.forward_transform(x)
    assert np.abs(c).max() <= 4095  # SPEC.md §3 range proof
    r = spec.inverse_transform(c)
    assert np.abs(r - x).max() <= 2  # SPEC.md §11 invariant 3


def test_transform_dc():
    x = np.full((1, 8, 8), 100, dtype=np.int32)
    c = spec.forward_transform(x)
    # orthonormal-scale DC of a flat block = value * 8
    assert abs(c[0, 0, 0] - 800) <= 1
    assert np.abs(c[0].flatten()[1:]).max() <= 1  # AC ~ 0


def test_quant_roundtrip_bound(rng):
    c = rng.integers(-4095, 4096, size=(1000,)).astype(np.int32)
    for qp in (1, 10, 28, 45, 63):
        q = int(spec.QSTEP[qp])
        lev = spec.quantize(c, q)
        d = spec.dequantize(lev, q)
        assert np.abs(d - c).max() <= (q + 1) // 2
        assert np.abs(lev).max() <= 4095


def test_quant_rounding_pinned():
    # level = sign(C) * ((2|C| + q) // (2q)) — ties away from zero
    assert spec.quantize(np.array([5]), np.array([10]))[0] == 1   # 0.5 -> 1
    assert spec.quantize(np.array([4]), np.array([10]))[0] == 0
    assert spec.quantize(np.array([-5]), np.array([10]))[0] == -1
    assert spec.quantize(np.array([15]), np.array([10]))[0] == 2  # 1.5 -> 2


def test_bitlen(rng):
    vals = np.concatenate(
        [np.arange(0, 70), rng.integers(0, 1 << 40, size=100)]
    ).astype(np.int64)
    expect = np.array([int(v).bit_length() for v in vals])
    assert np.array_equal(spec.bitlen(vals), expect)


def test_ue_len_val():
    # v: 0→1 bit, 1..2→3 bits, 3..6→5 bits
    assert spec.ue_len(np.array([0]))[0] == 1
    assert spec.ue_len(np.array([1]))[0] == 3
    assert spec.ue_len(np.array([2]))[0] == 3
    assert spec.ue_len(np.array([3]))[0] == 5
    assert spec.ue_len(np.array([6]))[0] == 5
    assert spec.ue_len(np.array([7]))[0] == 7
    assert spec.ue_val(np.array([4]))[0] == 5


def test_se_map():
    assert spec.se_map(np.array([0]))[0] == 0
    assert spec.se_map(np.array([1]))[0] == 1
    assert spec.se_map(np.array([-1]))[0] == 2
    assert spec.se_map(np.array([2]))[0] == 3
    assert spec.se_map(np.array([-2]))[0] == 4


def test_adaptive_qp():
    assert spec.adaptive_qp(28, np.array([0]))[0] == 18
    assert spec.adaptive_qp(28, np.array([1 << 20]))[0] == 39
    assert spec.adaptive_qp(2, np.array([0]))[0] == 1    # clamps
    assert spec.adaptive_qp(62, np.array([1 << 30]))[0] == 63


def test_pad_and_blockify(rng):
    p = rng.integers(0, 256, size=(17, 33)).astype(np.int32)
    pp = spec.pad_plane(p, 16)
    assert pp.shape == (32, 48)
    assert np.array_equal(pp[:17, :33], p)
    assert np.array_equal(pp[17:, :33], np.repeat(p[16:17], 15, axis=0))
    b = spec.blockify(pp, 16)
    assert b.shape == (2, 3, 16, 16)
    assert np.array_equal(spec.unblockify(b), pp)
