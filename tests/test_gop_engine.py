"""GOP-resident device engine vs golden: packet byte-equality (SPEC.md §11
invariant 2). One config only — XLA CPU compile of the full GOP program is
~60 s on this 2-core box."""

import numpy as np

from video_encoder.codec import golden
from video_encoder.codec.config import EncoderConfig
from video_encoder.pipeline.encoder import encode_gop, GoldenEngine
from video_encoder.pipeline.gop_engine import GopEngine


def test_gop_engine_matches_golden(rng):
    base = rng.integers(0, 256, (64, 80)).astype(np.int32)
    frames = []
    for t in range(3):
        y = base[2 * t : 2 * t + 32, 3 * t : 3 * t + 48].astype(np.uint8)
        frames.append(
            golden.Frame.from_planes(
                y, np.full((16, 24), 100, np.uint8), np.full((16, 24), 140, np.uint8)
            )
        )
    cfg = EncoderConfig(width=48, height=32, gop_n=3, base_qp=28, search="full")
    gpk, _ = encode_gop(cfg, GoldenEngine(), frames, 0, 0)
    dpk, dst = GopEngine(cfg).encode_gop(frames, 0)
    assert all(a.to_bytes() == b.to_bytes() for a, b in zip(gpk, dpk))
    assert dst[0].frame_type == 0 and dst[1].frame_type == 1
