"""Format v2 (SPEC.md §12): cross-engine bit-exactness and compression gain.

v2 = left-MB motion-vector prediction, per-plane left-block DC DPCM, and the
chroma QP offset. All predictors are left-only so MB rows stay independent
(tile-shard safe). Four implementations must agree byte-for-byte: golden
(numpy), the GOP device engine (jnp), the C++ native decoder, and the
C++ oracle encoder.
"""

import io
import os
import subprocess
import sys

import numpy as np
import pytest

from video_encoder.codec import golden, native
from video_encoder.codec.bitstream import OrderedMux
from video_encoder.codec.config import EncoderConfig
from video_encoder.pipeline import decoder
from video_encoder.pipeline.gop_engine import GopEngine

W, H, N = 96, 64, 6


def _clip(rng):
    base = rng.integers(0, 256, (H + 32, W + 32)).astype(np.int32)
    base = (base + np.roll(base, 1, 0) + np.roll(base, 1, 1)) // 3
    frames, raw = [], bytearray()
    for t in range(N):
        y = base[2 * t : 2 * t + H, 3 * t : 3 * t + W].astype(np.uint8)
        cb = (base[t : t + H : 2, t : t + W : 2] // 2 + 64).astype(np.uint8)
        cr = np.full((H // 2, W // 2), 130, np.uint8)
        frames.append(golden.Frame.from_planes(y, cb, cr))
        raw += y.tobytes() + cb.tobytes() + cr.tobytes()
    return frames, bytes(raw)


def _encode(cfg, frames):
    out = io.BytesIO()
    mux = OrderedMux(out, cfg, N)
    eng = GopEngine(cfg)
    for s0 in range(0, N, cfg.gop_n):
        pk, _ = eng.encode_gop(frames[s0 : s0 + cfg.gop_n], s0)
        for p in pk:
            mux.push(p)
    mux.close()
    return out.getvalue()


@pytest.mark.parametrize("cqpo", [0, 4])
def test_v2_cross_engine_bit_exact(rng, cqpo):
    frames, raw = _clip(rng)
    cfg = EncoderConfig(width=W, height=H, gop_n=3, base_qp=20, search="full",
                        format_version=2, chroma_qp_offset=cqpo)
    data = _encode(cfg, frames)

    _, g = decoder.decode_clip(io.BytesIO(data))
    gold = list(g)
    assert len(gold) == N

    if native.available():
        _, nf = decoder.decode_clip_native(io.BytesIO(data))
        for a, b in zip(gold, nf):
            assert all(np.array_equal(x, y) for x, y in zip(a, b))
        _, df = decoder.decode_clip_gop(io.BytesIO(data))
        for a, b in zip(gold, df):
            assert all(np.array_equal(x, y) for x, y in zip(a, b))

        # C++ oracle encoder produces the identical stream
        exe = os.path.join(os.path.dirname(native._LIB_PATH), "oracle")
        if os.path.exists(exe):
            import tempfile

            with tempfile.TemporaryDirectory() as td:
                yin = os.path.join(td, "in.yuv")
                open(yin, "wb").write(raw)
                otvc = os.path.join(td, "o.tvc")
                r = subprocess.run(
                    [exe, "encode", yin, otvc, str(W), str(H), "3", "20",
                     "full", "none", "0", str(N), "2", str(cqpo)],
                    capture_output=True,
                )
                assert r.returncode == 0
                assert open(otvc, "rb").read()[24:] == data[24:]


def test_v2_compresses_better_on_smooth_motion(rng):
    """On panning smooth content, v2 (mv pred + DC DPCM) must shrink the
    stream vs v1 at identical reconstruction quality."""
    base = rng.integers(0, 256, (H + 64, W + 64)).astype(np.int32)
    for _ in range(3):
        base = (base + np.roll(base, 1, 0) + np.roll(base, 1, 1)) // 3
    frames = []
    for t in range(N):
        y = base[2 * t : 2 * t + H, 3 * t : 3 * t + W].astype(np.uint8)
        cb = (base[t : t + H : 2, t : t + W : 2] // 2 + 64).astype(np.uint8)
        cr = (base[t + 1 : t + 1 + H : 2, t : t + W : 2] // 2 + 64).astype(np.uint8)
        frames.append(golden.Frame.from_planes(y, cb, cr))

    kw = dict(width=W, height=H, gop_n=6, base_qp=16, search="full")
    d1 = _encode(EncoderConfig(**kw), frames)
    d2 = _encode(EncoderConfig(**kw, format_version=2), frames)
    assert len(d2) < len(d1), (len(d2), len(d1))

    # identical reconstructions (cqpo=0 changes no math, only the coding)
    _, g1 = decoder.decode_clip(io.BytesIO(d1))
    _, g2 = decoder.decode_clip(io.BytesIO(d2))
    for a, b in zip(g1, g2):
        assert all(np.array_equal(x, y) for x, y in zip(a, b))


def test_v1_streams_unchanged(rng):
    """v1 output is byte-stable across the v2 introduction."""
    frames, _ = _clip(rng)
    cfg = EncoderConfig(width=W, height=H, gop_n=3, base_qp=20, search="full")
    data = _encode(cfg, frames)
    assert data[4:6] == b"\x01\x00"  # version 1
    _, g = decoder.decode_clip(io.BytesIO(data))
    assert len(list(g)) == N
