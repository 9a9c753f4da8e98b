"""Decoder robustness fuzzing (ROADMAP: bit-flip corpus): corrupt or truncate
valid TVC1 streams and assert every decoder either raises ValueError or
returns frames — never crashes, hangs, or reads out of bounds. The C++
BitReader treats past-end bits as 1 and every parse loop checks pos>nbits,
so truncation is always detected (oracle/oracle.cpp)."""

import io

import numpy as np
import pytest

from video_encoder.codec import native
from video_encoder.codec.config import EncoderConfig
from video_encoder.pipeline import decoder, encoder


def _make_stream(rng, w=64, h=48, n=4):
    base = rng.integers(0, 256, (h + 16, w + 16)).astype(np.int32)
    base = (base + np.roll(base, 1, 0) + np.roll(base, 1, 1)) // 3
    raw = []
    for t in range(n):
        y = base[t : t + h, 2 * t : 2 * t + w].astype(np.uint8)
        cb = np.full((h // 2, w // 2), 120, np.uint8)
        cr = np.full((h // 2, w // 2), 130, np.uint8)
        raw.append((y, cb, cr))
    cfg = EncoderConfig(width=w, height=h, gop_n=2, base_qp=18, search="full")
    out = io.BytesIO()
    encoder.encode_clip(cfg, iter(raw), out, n)
    return out.getvalue()


def _try_decode_all(data):
    """Run all decoders on possibly-corrupt data; crash = test failure."""
    outcomes = []
    for name, run in [
        ("golden", lambda: [f for _, fs in [decoder.decode_clip(io.BytesIO(data))] for f in fs]),
        ("native", lambda: [f for _, fs in [decoder.decode_clip_native(io.BytesIO(data))] for f in fs]),
        ("gop", lambda: [f for _, fs in [decoder.decode_clip_gop(io.BytesIO(data))] for f in fs]),
    ]:
        if name in ("native", "gop") and not native.available():
            continue
        try:
            frames = run()
            outcomes.append((name, "ok", len(frames)))
        except (ValueError, IndexError) as e:
            outcomes.append((name, "rejected", str(e)[:60]))
    return outcomes


def test_fuzz_bitflips(rng):
    data = bytearray(_make_stream(rng))
    hdr = 64  # keep the stream header mostly intact so frames are attempted
    for trial in range(24):
        buf = bytearray(data)
        for _ in range(rng.integers(1, 6)):
            pos = int(rng.integers(hdr, len(buf)))
            buf[pos] ^= 1 << int(rng.integers(0, 8))
        _try_decode_all(bytes(buf))  # must not crash/hang


def test_fuzz_truncation(rng):
    data = _make_stream(rng)
    for frac in (0.1, 0.35, 0.6, 0.9, 0.99):
        _try_decode_all(data[: int(len(data) * frac)])


def test_fuzz_garbage_payload(rng):
    data = bytearray(_make_stream(rng))
    # replace the tail (frame payloads) with random bytes
    buf = bytes(data[:80]) + bytes(rng.integers(0, 256, len(data) - 80, dtype=np.uint8))
    _try_decode_all(buf)


def test_valid_stream_still_decodes(rng):
    data = _make_stream(rng)
    outs = _try_decode_all(data)
    assert all(o[1] == "ok" for o in outs), outs
