"""Deadzone quantizer (EncoderConfig.quant_bias): encoder-side AC rounding
bias. The bitstream format and decoder are untouched — only which levels the
encoder picks changes — so every implementation must agree byte-for-byte at
each bias, and bias=8 must reproduce the historical midpoint quantizer
exactly.
"""

import io
import os
import subprocess

import numpy as np
import pytest

from video_encoder.codec import native, spec
from video_encoder.codec.config import EncoderConfig
from video_encoder.io import yuv
from video_encoder.ops import transform as tx
from video_encoder.pipeline.decoder import decode_clip
from video_encoder.pipeline.encoder import GoldenEngine, encode_clip
from video_encoder.pipeline.gop_engine import GopEngine
from video_encoder.utils.metrics import psnr

ORACLE = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "oracle", "oracle"
)


def test_bias8_is_midpoint(rng):
    """quantize(..., 8) == the original (2|C|+q)//(2q) formula, all qps."""
    c = rng.integers(-4095, 4096, (40, 8, 8)).astype(np.int32)
    for qp in (1, 13, 29, 46, 63):
        q = np.int64(spec.QSTEP[qp])
        mag = (2 * np.abs(c.astype(np.int64)) + q) // (2 * q)
        old = np.where(c < 0, -mag, mag).astype(np.int32)
        assert np.array_equal(spec.quantize(c, q), old)
        assert np.array_equal(spec.quantize(c, q, 8), old)
        assert np.array_equal(np.asarray(tx.quantize(c, np.int32(q))), old)


def test_jnp_matches_numpy_all_biases(rng):
    c = rng.integers(-4095, 4096, (24, 8, 8)).astype(np.int32)
    q = np.int32(spec.QSTEP[30])
    for bias in (1, 3, 5, 8):
        a = spec.quantize(c, q, bias)
        b = np.asarray(tx.quantize(c, q, bias))
        assert np.array_equal(a, b), bias


def test_dc_keeps_midpoint(rng):
    """The DC coefficient is always midpoint-rounded regardless of bias."""
    c = rng.integers(-4095, 4096, (16, 8, 8)).astype(np.int32)
    q = np.int32(spec.QSTEP[30])
    assert np.array_equal(
        spec.quantize(c, q, 2)[..., 0, 0], spec.quantize(c, q, 8)[..., 0, 0]
    )


def _clip(rng, w, h, n):
    base = rng.integers(0, 256, (h + 32, w + 32)).astype(np.int32)
    base = (base + np.roll(base, 1, 0) + np.roll(base, 1, 1)) // 3
    frames = []
    for t in range(n):
        y = base[t : t + h, 2 * t : 2 * t + w].astype(np.uint8)
        cb = np.full((h // 2, w // 2), 100 + t, np.uint8)
        cr = np.full((h // 2, w // 2), 140, np.uint8)
        frames.append((y, cb, cr))
    return frames


def _encode(cfg, frames, engine):
    buf = io.BytesIO()
    encode_clip(cfg, iter(frames), buf, n_frames=len(frames), engine=engine)
    return buf.getvalue()


def _encode_gop_resident(cfg, frames):
    """Mirror cli._encode_gop_resident: GopEngine + ordered mux."""
    from video_encoder.codec.bitstream import OrderedMux
    from video_encoder.codec.golden import Frame

    eng = GopEngine(cfg)
    buf = io.BytesIO()
    mux = OrderedMux(buf, cfg, len(frames))
    start = 0
    while start < len(frames):
        gop = [Frame.from_planes(*f) for f in frames[start:start + cfg.gop_n]]
        packets, _ = eng.encode_gop(gop, start)
        for p in packets:
            mux.push(p)
        start += len(gop)
    return buf.getvalue()


@pytest.mark.parametrize("fmt", [1, 2])
def test_golden_gop_engines_agree_with_deadzone(rng, fmt):
    w, h, n = 64, 48, 5
    frames = _clip(rng, w, h, n)
    cfg = EncoderConfig(width=w, height=h, gop_n=3, base_qp=26,
                        quant_bias=4, format_version=fmt)
    g = _encode(cfg, frames, GoldenEngine())
    d = _encode_gop_resident(cfg, frames)
    assert g == d
    # decodes cleanly and is sane
    info, it = decode_clip(io.BytesIO(g))
    ys = [y for (y, cb, cr) in it]
    assert len(ys) == n
    p = psnr(frames[0][0].astype(np.int32), ys[0].astype(np.int32))
    assert p > 28


def test_deadzone_saves_bits(rng):
    """On textured content a deadzone must strictly shrink the stream while
    keeping PSNR in the same ballpark (the rd tradeoff it exists for)."""
    w, h, n = 96, 64, 4
    base = rng.integers(0, 256, (h + 16, w + 16)).astype(np.uint8)
    frames = []
    for t in range(n):
        y = base[t : t + h, t : t + w]
        frames.append((y, np.full((h // 2, w // 2), 128, np.uint8),
                       np.full((h // 2, w // 2), 128, np.uint8)))
    sizes, psnrs = {}, {}
    for bias in (8, 4):
        cfg = EncoderConfig(width=w, height=h, gop_n=2, base_qp=24,
                            quant_bias=bias)
        s = _encode(cfg, frames, GoldenEngine())
        info, it = decode_clip(io.BytesIO(s))
        ys = [y for (y, _, _) in it]
        sizes[bias] = len(s)
        psnrs[bias] = np.mean([
            psnr(a[0].astype(np.int32), b.astype(np.int32))
            for a, b in zip(frames, ys)
        ])
    assert sizes[4] < sizes[8]
    assert psnrs[4] > psnrs[8] - 3.0  # bounded quality cost


def test_oracle_agrees_with_deadzone(rng, tmp_path):
    native.build(os.path.dirname(ORACLE), "oracle")
    w, h, n = 64, 48, 5
    frames = _clip(rng, w, h, n)
    path = tmp_path / "in.yuv"
    with open(path, "wb") as f:
        for y, cb, cr in frames:
            f.write(y.tobytes()); f.write(cb.tobytes()); f.write(cr.tobytes())
    cfg = EncoderConfig(width=w, height=h, gop_n=3, base_qp=26, quant_bias=4)
    g = _encode(cfg, frames, GoldenEngine())
    out = tmp_path / "o.tvc"
    r = subprocess.run(
        [ORACLE, "encode", str(path), str(out), str(w), str(h), "3", "26",
         "full", "none", "0", str(n), "1", "0", "4"], capture_output=True)
    assert r.returncode == 0, r.stderr
    assert out.read_bytes() == g
