"""Bit I/O round-trip and serialization tests (C12 bit layer)."""

import numpy as np

from video_encoder.codec.bitio import BitReader, BitWriter


def test_write_read_roundtrip(rng):
    codes = []
    bw = BitWriter()
    for _ in range(5000):
        length = int(rng.integers(1, 33))
        value = int(rng.integers(0, 1 << length))
        codes.append((value, length))
        bw.put(value, length)
    br = BitReader(bw.tobytes(), bw.nbits)
    for value, length in codes:
        assert br.get(length) == value


def test_ue_roundtrip():
    bw = BitWriter()
    vals = list(range(0, 200)) + [255, 1000, 65534]
    for v in vals:
        bw.put_ue(v)
    br = BitReader(bw.tobytes(), bw.nbits)
    for v in vals:
        assert br.get_ue() == v


def test_se_roundtrip():
    bw = BitWriter()
    vals = list(range(-100, 101)) + [4095, -4095]
    for v in vals:
        bw.put_se(v)
    br = BitReader(bw.tobytes(), bw.nbits)
    for v in vals:
        assert br.get_se() == v


def test_msb_first_layout():
    # SPEC.md §6: stream bit 0 is bit 7 of payload byte 0.
    bw = BitWriter()
    bw.put(1, 1)        # stream: 1
    bw.put(0b010, 3)    # stream: 1 010 ...
    data = bw.tobytes()
    assert data[0] == 0b10100000
    assert bw.nbits == 4
    assert len(data) == 4  # padded to a 32-bit word


def test_word_spanning_code():
    bw = BitWriter()
    bw.put(0, 20)
    bw.put((1 << 24) - 1, 24)  # spans the word boundary
    br = BitReader(bw.tobytes(), bw.nbits)
    assert br.get(20) == 0
    assert br.get(24) == (1 << 24) - 1


def test_ue_exact_bits():
    bw = BitWriter()
    bw.put_ue(0)
    assert bw.nbits == 1
    bw.put_ue(1)  # '010'
    assert bw.nbits == 4
    data = bw.tobytes()
    # stream: 1 010 -> byte 0b10100000
    assert data[0] == 0b10100000
