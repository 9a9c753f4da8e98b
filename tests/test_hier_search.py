"""Hierarchical ME mode (SPEC.md §9 "hier"): coarse quarter-res full search
+ full-res refinement. Bit-exact across golden numpy / jnp / oracle, and
close to full-search quality on translational motion.
"""

import io
import os
import subprocess

import numpy as np
import pytest

from video_encoder.codec import golden, native, spec
from video_encoder.codec.config import EncoderConfig
from video_encoder.ops import motion
from video_encoder.pipeline.decoder import decode_clip
from video_encoder.pipeline.encoder import GoldenEngine, encode_clip

ORACLE = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "oracle", "oracle"
)


def test_down2_matches():
    rng = np.random.default_rng(1)
    p = rng.integers(0, 256, (32, 48)).astype(np.int32)
    import jax.numpy as jnp

    assert np.array_equal(spec.down2(p), np.asarray(motion.down2(jnp.asarray(p))))
    # round-half-up: (0+0+1+2+2)>>2 would be wrong; check a pinned case
    q = np.array([[0, 1], [0, 2]], np.int32)
    assert spec.down2(q)[0, 0] == (0 + 1 + 0 + 2 + 2) >> 2


@pytest.mark.parametrize("shift", [(0, 0), (3, -5), (-14, 15), (9, 9)])
def test_hier_finds_translation(rng, shift):
    """Pure translation within ±16 must be found exactly (SAD 0) on content
    with large-scale structure (a 16x-upsampled random field plus fine
    noise). Pure high-frequency noise aliases at quarter res by nature —
    that case is covered by the rd-quality bound below instead."""
    h, w = 160, 192
    base = rng.integers(0, 256, (h + 64, w + 64)).astype(np.float64)
    for k in (1, 2, 4, 8):  # heavy low-pass: locally distinctive, no repeats
        base = (base + np.roll(base, k, 0) + np.roll(base, -k, 0)
                + np.roll(base, k, 1) + np.roll(base, -k, 1)) / 5
    base = base - base.min()
    base = (base / base.max() * 255).astype(np.int32)
    sy, sx = shift
    cur = base[32 : 32 + h, 32 : 32 + w]
    ref = base[32 - sy : 32 - sy + h, 32 - sx : 32 - sx + w]
    dy, dx, sad = golden.sad_hier_search(cur, ref)
    # interior MBs (away from frame edges where the window clips): nearly
    # all must recover the exact shift with SAD 0
    inner = np.s_[2:-2, 2:-2]
    exact = (dy[inner] == sy) & (dx[inner] == sx)
    assert exact.mean() > 0.85
    assert np.median(sad[inner]) == 0


def test_jnp_matches_golden(rng):
    import jax.numpy as jnp

    h, w = 96, 128
    cur = rng.integers(0, 256, (h, w)).astype(np.int32)
    ref = np.clip(
        np.roll(cur, (2, -3), (0, 1)) + rng.integers(-6, 7, (h, w)), 0, 255
    ).astype(np.int32)
    g = golden.sad_hier_search(cur, ref)
    j = motion.hier_search(jnp.asarray(cur), jnp.asarray(ref))
    for a, b in zip(g, j):
        assert np.array_equal(np.asarray(a), np.asarray(b))


def _clip(rng, w, h, n):
    base = rng.integers(0, 256, (h + 32, w + 32)).astype(np.int32)
    base = (base + np.roll(base, 1, 0) + np.roll(base, 1, 1)) // 3
    frames = []
    for t in range(n):
        y = base[t : t + h, 2 * t : 2 * t + w].astype(np.uint8)
        frames.append((y, np.full((h // 2, w // 2), 100 + t, np.uint8),
                       np.full((h // 2, w // 2), 140, np.uint8)))
    return frames


def test_hier_golden_roundtrip_and_device_rejection(rng):
    """hier is golden/oracle-only: golden streams still encode+decode; the
    device engines
    must reject the mode with a clear ValueError, and the CLI must reject
    it at argument validation (not at trace time)."""
    from video_encoder import cli
    from video_encoder.codec.golden import Frame
    from video_encoder.pipeline.gop_engine import GopEngine

    w, h, n = 64, 48, 5
    frames = _clip(rng, w, h, n)
    cfg = EncoderConfig(width=w, height=h, gop_n=5, base_qp=26, search="hier")
    buf1 = io.BytesIO()
    encode_clip(cfg, iter(frames), buf1, n, engine=GoldenEngine())
    info, it = decode_clip(io.BytesIO(buf1.getvalue()))
    assert len(list(it)) == n

    with pytest.raises(ValueError, match="hier"):
        GopEngine(cfg)

    # CLI rejects --search hier with the device engines up front, including
    # the --gop-batch combination that used to die at trace time
    rc = cli.main(["encode", "-i", "x.yuv", "-o", "y.tvc", "-W", "64",
                   "-H", "48", "--search", "hier", "--gop-batch", "2"])
    assert rc == 2


def test_hier_oracle_equality(rng, tmp_path):
    native.build(os.path.dirname(ORACLE), "oracle")
    w, h, n = 64, 48, 5
    frames = _clip(rng, w, h, n)
    path = tmp_path / "in.yuv"
    with open(path, "wb") as f:
        for y, cb, cr in frames:
            f.write(y.tobytes()); f.write(cb.tobytes()); f.write(cr.tobytes())
    cfg = EncoderConfig(width=w, height=h, gop_n=5, base_qp=26, search="hier")
    buf = io.BytesIO()
    encode_clip(cfg, iter(frames), buf, n, engine=GoldenEngine())
    out = tmp_path / "o.tvc"
    r = subprocess.run(
        [ORACLE, "encode", str(path), str(out), str(w), str(h), "5", "26",
         "hier", "none", "0", str(n)], capture_output=True)
    assert r.returncode == 0, r.stderr
    assert out.read_bytes() == buf.getvalue()


def test_hier_quality_near_full(rng):
    """On panning content, hier PSNR must be within 0.5 dB of full search
    at equal qp (it evaluates ~10x fewer candidates)."""
    from video_encoder.utils.metrics import psnr

    w, h, n = 128, 96, 6
    base = rng.integers(0, 256, (h + 64, w + 64)).astype(np.float64)
    for k in (1, 2, 4):  # moderate low-pass: textured but multires-friendly
        base = (base + np.roll(base, k, 0) + np.roll(base, -k, 0)
                + np.roll(base, k, 1) + np.roll(base, -k, 1)) / 5
    base = ((base - base.min()) / (base.max() - base.min()) * 255).astype(np.int32)
    frames = []
    for t in range(n):
        y = base[3 * t : 3 * t + h, 5 * t : 5 * t + w].astype(np.uint8)
        frames.append((y, np.full((h // 2, w // 2), 128, np.uint8),
                       np.full((h // 2, w // 2), 128, np.uint8)))

    def run(search):
        cfg = EncoderConfig(width=w, height=h, gop_n=n, base_qp=26,
                            search=search)
        buf = io.BytesIO()
        encode_clip(cfg, iter(frames), buf, n, engine=GoldenEngine())
        buf.seek(0)
        info, it = decode_clip(buf)
        ys = [y for (y, _, _) in it]
        p = np.mean([psnr(a[0].astype(np.int32), b.astype(np.int32))
                     for a, b in zip(frames, ys)])
        return p, buf.getbuffer().nbytes

    p_full, s_full = run("full")
    p_hier, s_hier = run("hier")
    assert p_hier > p_full - 0.5
    assert s_hier < s_full * 1.15
