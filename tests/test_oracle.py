"""C++ oracle cross-validation (SURVEY.md §4.3): the independent scalar
implementation must produce byte-identical streams and decodes."""

import io
import os
import subprocess

import numpy as np
import pytest

from video_encoder.codec import native
from video_encoder.codec.config import EncoderConfig
from video_encoder.io import yuv
from video_encoder.pipeline.decoder import decode_clip
from video_encoder.pipeline.encoder import encode_clip

ORACLE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "oracle", "oracle")


@pytest.fixture(scope="module")
def oracle_bin():
    native.build(os.path.dirname(ORACLE), "oracle")
    return ORACLE


@pytest.fixture
def clip_file(tmp_path, rng):
    w, h, n = 64, 48, 6
    base = rng.integers(0, 256, (h + 64, w + 64)).astype(np.int32)
    base = (base + np.roll(base, 1, 0) + np.roll(base, 1, 1)) // 3
    path = tmp_path / "in.yuv"
    with open(path, "wb") as f:
        for t in range(n):
            y = base[2 * t : 2 * t + h, 3 * t : 3 * t + w].astype(np.uint8)
            f.write(y.tobytes())
            f.write(np.full((h // 2, w // 2), 100 + t, np.uint8).tobytes())
            f.write(np.full((h // 2, w // 2), 140, np.uint8).tobytes())
    return str(path), w, h, n


@pytest.mark.parametrize(
    "search,rc,qp,kbps",
    [("full", "none", 28, 0), ("diamond", "none", 30, 0),
     ("full", "adaptive", 28, 0), ("full", "bitrate", 20, 30)],
)
def test_oracle_stream_equals_golden(oracle_bin, clip_file, tmp_path, search, rc, qp, kbps):
    path, w, h, n = clip_file
    cfg = EncoderConfig(width=w, height=h, gop_n=3, base_qp=qp, search=search,
                        rc=rc, target_kbps=kbps)
    buf = io.BytesIO()
    with open(path, "rb") as fi:
        encode_clip(cfg, yuv.read_yuv_frames(fi, w, h), buf, n_frames=n)
    out = tmp_path / "o.tvc"
    r = subprocess.run(
        [oracle_bin, "encode", path, str(out), str(w), str(h), "3", str(qp),
         search, rc, str(kbps)], capture_output=True)
    assert r.returncode == 0, r.stderr
    assert out.read_bytes() == buf.getvalue()


def test_oracle_decodes_golden_stream(oracle_bin, clip_file, tmp_path):
    path, w, h, n = clip_file
    cfg = EncoderConfig(width=w, height=h, gop_n=3, base_qp=28)
    buf = io.BytesIO()
    with open(path, "rb") as fi:
        encode_clip(cfg, yuv.read_yuv_frames(fi, w, h), buf, n_frames=n)
    tvc = tmp_path / "g.tvc"
    tvc.write_bytes(buf.getvalue())
    dec = tmp_path / "dec.yuv"
    r = subprocess.run([oracle_bin, "decode", str(tvc), str(dec)], capture_output=True)
    assert r.returncode == 0, r.stderr
    buf.seek(0)
    info, frames = decode_clip(buf)
    with open(dec, "rb") as f:
        for (gy, gcb, gcr), (oy, ocb, ocr) in zip(frames, yuv.read_yuv_frames(f, w, h)):
            assert np.array_equal(gy, oy)
            assert np.array_equal(gcb, ocb)
            assert np.array_equal(gcr, ocr)
