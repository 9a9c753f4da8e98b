"""rc=vbv buffer-model rate control and the two-pass allocator (reference
component C15 extensions; SPEC.md §10). The vbv update is spec'd as exact
integer arithmetic, so golden host loop, device GOP scan and C++ oracle must
produce byte-identical streams.
"""

import io
import os
import subprocess

import numpy as np
import pytest

from video_encoder.codec import native, spec
from video_encoder.codec.config import EncoderConfig
from video_encoder.pipeline.decoder import decode_clip
from video_encoder.pipeline.encoder import (
    GoldenEngine,
    allocate_gop_qps,
    encode_clip,
    encode_clip_twopass,
)
from video_encoder.pipeline.gop_engine import GopEngine

ORACLE = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "oracle", "oracle"
)


def _busy_clip(rng, w, h, n, amp=255):
    frames = []
    for t in range(n):
        y = (rng.integers(0, amp + 1, (h, w))).astype(np.uint8)
        frames.append((y, np.full((h // 2, w // 2), 128, np.uint8),
                       np.full((h // 2, w // 2), 128, np.uint8)))
    return frames


def _encode(cfg, frames, engine=None):
    buf = io.BytesIO()
    encode_clip(cfg, iter(frames), buf, n_frames=len(frames), engine=engine)
    return buf.getvalue()


def _encode_gop_resident(cfg, frames):
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


def test_vbv_next_properties():
    # buffer never leaves [0, B]; qp never leaves [QP_MIN, QP_MAX]
    B, R = 100_000, 10_000
    qp, f = 30, spec.vbv_init(B)
    rng = np.random.default_rng(0)
    for _ in range(200):
        bits = int(rng.integers(0, 4 * R))
        qp, f = spec.vbv_next(qp, f, bits, R, B)
        assert 0 <= f <= B
        assert spec.QP_MIN <= qp <= spec.QP_MAX
    # oversized frames drain the buffer -> qp must rise
    qp, f = 30, spec.vbv_init(B)
    for _ in range(6):
        qp2, f = spec.vbv_next(qp, f, 3 * R, R, B)
        assert qp2 >= qp
        qp = qp2
    assert qp > 30


def test_vbv_golden_equals_gop_engine(rng):
    w, h, n = 64, 48, 6
    frames = _busy_clip(rng, w, h, n)
    cfg = EncoderConfig(width=w, height=h, gop_n=6, base_qp=24, rc="vbv",
                        target_kbps=40, vbv_kbits=12)
    g = _encode(cfg, frames, GoldenEngine())
    d = _encode_gop_resident(cfg, frames)
    assert g == d
    info, it = decode_clip(io.BytesIO(g))
    assert len([1 for _ in it]) == n


def test_vbv_oracle_equality(rng, tmp_path):
    native.build(os.path.dirname(ORACLE), "oracle")
    w, h, n = 64, 48, 6
    frames = _busy_clip(rng, w, h, n)
    path = tmp_path / "in.yuv"
    with open(path, "wb") as f:
        for y, cb, cr in frames:
            f.write(y.tobytes()); f.write(cb.tobytes()); f.write(cr.tobytes())
    cfg = EncoderConfig(width=w, height=h, gop_n=6, base_qp=24, rc="vbv",
                        target_kbps=40, vbv_kbits=12)
    g = _encode(cfg, frames, GoldenEngine())
    out = tmp_path / "o.tvc"
    r = subprocess.run(
        [ORACLE, "encode", str(path), str(out), str(w), str(h), "6", "24",
         "full", "vbv", "40", str(n), "1", "0", "8", "12"],
        capture_output=True)
    assert r.returncode == 0, r.stderr
    assert out.read_bytes() == g


def test_vbv_tracks_target(rng):
    """vbv must land much closer to the bit budget than constant qp."""
    w, h, n = 96, 64, 12
    frames = _busy_clip(rng, w, h, n)
    kbps = 60  # per-frame target = 2000 bits, far below constant-qp size
    target = (kbps * 1000 // 30) * n
    cq = EncoderConfig(width=w, height=h, gop_n=12, base_qp=20)
    vb = EncoderConfig(width=w, height=h, gop_n=12, base_qp=20, rc="vbv",
                       target_kbps=kbps)
    bits_cq = len(_encode(cq, frames, GoldenEngine())) * 8
    bits_vb = len(_encode(vb, frames, GoldenEngine())) * 8
    assert abs(bits_vb - target) < abs(bits_cq - target)


def test_allocate_gop_qps_alpha1_is_uniform_shift():
    qps = allocate_gop_qps(30, [100_000, 400_000], [8, 8], 12_500, alpha=1.0)
    # alpha=1: budgets proportional to sizes -> same log-ratio for every GOP
    assert qps[0] == qps[1]


def test_allocate_gop_qps_direction():
    # over budget -> qp must rise; under budget -> fall
    hi = allocate_gop_qps(30, [800_000], [8], 12_500)  # 8x over
    lo = allocate_gop_qps(30, [12_500], [8], 12_500)   # 8x under
    assert hi[0] > 30
    assert lo[0] < 30


def test_twopass_hits_target(rng):
    """Two GOPs of very different complexity: two-pass must land near the
    clip budget and beat single-pass constant qp."""
    w, h, n = 96, 64, 8
    busy = _busy_clip(rng, w, h, 4)
    flat = [(np.full((h, w), 80, np.uint8),
             np.full((h // 2, w // 2), 128, np.uint8),
             np.full((h // 2, w // 2), 128, np.uint8)) for _ in range(4)]
    frames = busy + flat
    kbps = 90
    cfg = EncoderConfig(width=w, height=h, gop_n=4, base_qp=22, rc="bitrate",
                        target_kbps=kbps)
    target = cfg.target_bits_per_frame() * n

    buf = io.BytesIO()
    summary = encode_clip_twopass(cfg, lambda: iter(frames), buf, n)
    two_bits = summary.total_bits
    cq_bits = len(_encode(
        EncoderConfig(width=w, height=h, gop_n=4, base_qp=22), frames,
        GoldenEngine())) * 8
    assert abs(two_bits - target) < abs(cq_bits - target)
    # stream is valid and frame-complete
    buf.seek(0)
    info, it = decode_clip(buf)
    assert len([1 for _ in it]) == n

    # the GOP-resident engine must produce the identical two-pass stream
    buf2 = io.BytesIO()
    encode_clip_twopass(cfg, lambda: iter(frames), buf2, n,
                        engine=GopEngine(cfg))
    assert buf2.getvalue() == buf.getvalue()
