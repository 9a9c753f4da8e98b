"""Clip-level pipeline tests: container round trip, GOP scheduling, ordered
mux with out-of-order arrival, bitrate RC (C1/C2/C13/C15/C16)."""

import io

import numpy as np
import pytest

from video_encoder.codec import bitstream, golden
from video_encoder.codec.config import EncoderConfig
from video_encoder.pipeline.decoder import decode_clip
from video_encoder.pipeline.encoder import encode_clip, encode_gop, gop_schedule, GoldenEngine

from conftest import make_clip


def test_gop_schedule():
    sched = list(gop_schedule(7, 3))
    assert sched == [
        (0, 0, 0), (1, 0, 1), (2, 0, 1),
        (3, 1, 0), (4, 1, 1), (5, 1, 1),
        (6, 2, 0),
    ]


def test_clip_roundtrip_gop(small_clip):
    cfg = EncoderConfig(width=64, height=48, gop_n=3, base_qp=25)
    buf = io.BytesIO()
    summary = encode_clip(cfg, small_clip, buf, n_frames=5)
    assert summary.frames == 5

    buf.seek(0)
    info, frames = decode_clip(buf)
    assert (info.width, info.height, info.gop_n, info.frame_count) == (64, 48, 3, 5)
    decoded = list(frames)
    assert len(decoded) == 5

    # decoder output must equal the encoder's reconstruction chain, rebuilt here
    engine = GoldenEngine()
    ref = None
    for i, (y, cb, cr) in enumerate(small_clip):
        cur = golden.Frame.from_planes(y, cb, cr)
        ftype = 0 if i % 3 == 0 else 1
        if ftype == 0:
            ref = None
        res = engine.encode(cfg, cur, ref, ftype, cfg.base_qp)
        ref = res.recon
        dy, dcb, dcr = decoded[i]
        ey, ecb, ecr = res.recon.crop(64, 48)
        assert np.array_equal(dy, ey)
        assert np.array_equal(dcb, ecb)
        assert np.array_equal(dcr, ecr)


def test_mux_out_of_order(small_clip):
    """OrderedMux reorders GOP-sharded arrivals to the same bytes ([B:10])."""
    cfg = EncoderConfig(width=64, height=48, gop_n=2, base_qp=30)
    engine = GoldenEngine()
    frames = [golden.Frame.from_planes(*f) for f in small_clip[:4]]

    pk0, _ = encode_gop(cfg, engine, frames[0:2], 0, 0)
    pk1, _ = encode_gop(cfg, engine, frames[2:4], 1, 2)

    in_order = io.BytesIO()
    mux = bitstream.OrderedMux(in_order, cfg, 4)
    for p in pk0 + pk1:
        mux.push(p)
    mux.close()

    shuffled = io.BytesIO()
    mux2 = bitstream.OrderedMux(shuffled, cfg, 4)
    for p in [pk1[1], pk0[0], pk1[0], pk0[1]]:
        mux2.push(p)
    mux2.close()

    assert in_order.getvalue() == shuffled.getvalue()


def test_mux_rejects_duplicates(small_clip):
    cfg = EncoderConfig(width=64, height=48, gop_n=1, base_qp=30)
    engine = GoldenEngine()
    frames = [golden.Frame.from_planes(*small_clip[0])]
    pk, _ = encode_gop(cfg, engine, frames, 0, 0)
    mux = bitstream.OrderedMux(io.BytesIO(), cfg, 2)
    mux.push(pk[0])
    with pytest.raises(ValueError, match="already muxed"):
        mux.push(pk[0])


def test_bitrate_rc_adapts(rng):
    """High-motion noisy clip at a tight budget: QP must climb."""
    clip = make_clip(rng, 64, 48, 6, motion=True)
    cfg = EncoderConfig(
        width=64, height=48, gop_n=6, base_qp=10, rc="bitrate",
        target_kbps=30, fps_num=30,
    )
    buf = io.BytesIO()
    qps = []
    encode_clip(cfg, clip, buf, n_frames=6, on_frame=lambda s: qps.append(s.base_qp))
    assert qps[0] == 10
    assert qps[-1] > 10  # feedback raised QP under the tight budget
    buf.seek(0)
    info, frames = decode_clip(buf)
    assert len(list(frames)) == 6


def test_container_header_fields(small_clip):
    cfg = EncoderConfig(width=64, height=48, gop_n=3, base_qp=25, search="diamond")
    buf = io.BytesIO()
    encode_clip(cfg, small_clip, buf, n_frames=2)
    buf.seek(0)
    info = bitstream.read_stream_header(buf)
    assert info.search_mode == 1
    assert info.config_hash == cfg.config_hash()
    assert info.base_qp == 25
