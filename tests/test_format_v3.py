"""Format v3 (SPEC.md §13): I-frame vertical intra prediction + optional
quant matrix. The v3 syntax is byte-identical to v2, so the cross-engine
contract is the usual one: golden, device GOP scan, and C++ oracle produce
identical streams; every decoder reconstructs them identically; and v3
compresses I frames better than v2 at equal qp on predictable content."""

import io
import os
import subprocess

import numpy as np
import pytest

from video_encoder.codec import golden, native, spec
from video_encoder.codec.config import EncoderConfig
from video_encoder.pipeline.decoder import (
    GoldenDecodeEngine,
    GopDecodeEngine,
    decode_clip,
    decode_clip_gop,
    decode_clip_native,
)
from video_encoder.pipeline.encoder import GoldenEngine, encode_clip
from video_encoder.pipeline.gop_engine import GopEngine

ORACLE = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "oracle", "oracle"
)


def _gradient_clip(rng, w, h, n):
    """Vertically predictable content (gradients) + noise + motion: the
    vertical intra predictor should shine on the gradient part."""
    yy, xx = np.mgrid[0:h, 0:w]
    frames = []
    for t in range(n):
        y = (yy * 2 + xx // 4 + 10 * t) % 256
        y = np.clip(y + rng.integers(-4, 5, y.shape), 0, 255).astype(np.uint8)
        frames.append((y, np.full((h // 2, w // 2), 110, np.uint8),
                       np.full((h // 2, w // 2), 140, np.uint8)))
    return frames


def _encode(cfg, frames, engine=None):
    buf = io.BytesIO()
    encode_clip(cfg, iter(frames), buf, n_frames=len(frames), engine=engine)
    return buf.getvalue()


def test_intra_rows_roundtrip(rng):
    """Encoder-side row coding reconstructs exactly what the decoder-side
    recon produces from its levels, with and without the quant matrix."""
    h, w = 32, 48
    cur = rng.integers(0, 256, (h, w)).astype(np.int32)
    for qmat in (False, True):
        qs = spec.qsteps_pos(np.full((h // 8, w // 8), 20, np.int64), qmat)
        lv, rec = spec.intra_rows_code_plane(cur, qs, 8)
        rec2 = spec.intra_rows_recon_plane(lv, qs)
        assert np.array_equal(rec, rec2)
        assert rec.min() >= 0 and rec.max() <= 255


def test_intra_rows_jnp_matches_numpy(rng):
    import jax.numpy as jnp

    from video_encoder.ops import transform as tx

    h, w = 32, 48
    cur = rng.integers(0, 256, (h, w)).astype(np.int32)
    for qmat in (False, True):
        qs = spec.qsteps_pos(
            np.asarray(spec.QSTEP)[rng.integers(10, 40, (h // 8, w // 8))], qmat
        )
        lv_np, rec_np = spec.intra_rows_code_plane(cur, qs, 6)
        lv_j, rec_j = tx.intra_rows_code_plane(
            jnp.asarray(cur), jnp.asarray(qs, jnp.int32), 6
        )
        assert np.array_equal(lv_np, np.asarray(lv_j))
        assert np.array_equal(rec_np, np.asarray(rec_j))
        rec2_j = tx.intra_rows_recon_plane(
            jnp.asarray(lv_np), jnp.asarray(qs, jnp.int32)
        )
        assert np.array_equal(rec_np, np.asarray(rec2_j))


@pytest.mark.parametrize("qmat", [False, True])
def test_v3_golden_equals_gop_engine(rng, qmat):
    w, h, n = 96, 64, 4
    frames = _gradient_clip(rng, w, h, n)
    cfg = EncoderConfig(width=w, height=h, gop_n=n, base_qp=26,
                        format_version=3, chroma_qp_offset=2,
                        quant_matrix=qmat)
    g = _encode(cfg, frames, GoldenEngine())

    from video_encoder.codec.bitstream import OrderedMux

    eng = GopEngine(cfg)
    buf = io.BytesIO()
    mux = OrderedMux(buf, cfg, n)
    packets, _ = eng.encode_gop(
        [golden.Frame.from_planes(*f) for f in frames], 0)
    for p in packets:
        mux.push(p)
    assert buf.getvalue() == g


@pytest.mark.parametrize("qmat", [False, True])
def test_v3_all_decoders_agree(rng, qmat):
    w, h, n = 96, 64, 4
    frames = _gradient_clip(rng, w, h, n)
    cfg = EncoderConfig(width=w, height=h, gop_n=n, base_qp=24,
                        format_version=3, quant_matrix=qmat)
    g = _encode(cfg, frames, GoldenEngine())

    _, golden_frames = decode_clip(io.BytesIO(g))
    want = [tuple(np.asarray(p) for p in f) for f in golden_frames]

    _, gop_frames = decode_clip_gop(io.BytesIO(g))
    got = list(gop_frames)
    assert len(got) == n
    for a, b in zip(want, got):
        for pa, pb in zip(a, b):
            assert np.array_equal(pa, pb)

    _, native_frames = decode_clip_native(io.BytesIO(g))
    for a, b in zip(want, native_frames):
        for pa, pb in zip(a, b):
            assert np.array_equal(np.asarray(pa, np.uint8), pb)


def test_v3_oracle_equality(rng, tmp_path):
    native.build(os.path.dirname(ORACLE), "oracle")
    w, h, n = 96, 64, 4
    frames = _gradient_clip(rng, w, h, n)
    path = tmp_path / "in.yuv"
    with open(path, "wb") as f:
        for y, cb, cr in frames:
            f.write(y.tobytes()); f.write(cb.tobytes()); f.write(cr.tobytes())
    for qmat in (0, 1):
        cfg = EncoderConfig(width=w, height=h, gop_n=n, base_qp=26,
                            format_version=3, chroma_qp_offset=2,
                            quant_matrix=bool(qmat))
        g = _encode(cfg, frames, GoldenEngine())
        out = tmp_path / f"o{qmat}.tvc"
        r = subprocess.run(
            [ORACLE, "encode", str(path), str(out), str(w), str(h), str(n),
             "26", "full", "none", "0", str(n), "3", "2", "8", "0",
             str(qmat)],
            capture_output=True)
        assert r.returncode == 0, r.stderr
        assert out.read_bytes() == g, f"qmat={qmat}"


def test_v3_beats_v2_on_iframes(rng):
    """The point of §13.1: replicating the recon row above predicts COLUMN
    structure, so content with vertical edges/stripes codes much cheaper
    than v2's flat-128 intra (measured ~6x here)."""
    w, h = 192, 128
    xx = np.mgrid[0:h, 0:w][1]
    y = np.clip((xx * 3) % 256 + rng.integers(-4, 5, (h, w)), 0, 255).astype(np.uint8)
    frame = golden.Frame.from_planes(
        y, np.full((h // 2, w // 2), 110, np.uint8),
        np.full((h // 2, w // 2), 140, np.uint8))
    bits = {}
    for v in (2, 3):
        cfg = EncoderConfig(width=w, height=h, gop_n=4, base_qp=28,
                            format_version=v)
        bits[v] = golden.encode_frame(cfg, frame, None, 0, 28).payload_bits
    assert bits[3] < 0.8 * bits[2], f"v3 {bits[3]} vs v2 {bits[2]}"


def test_v3_decode_psnr_sane(rng):
    w, h, n = 96, 64, 4
    frames = _gradient_clip(rng, w, h, n)
    cfg = EncoderConfig(width=w, height=h, gop_n=n, base_qp=20,
                        format_version=3, quant_matrix=True)
    g = _encode(cfg, frames, GoldenEngine())
    _, dec = decode_clip(io.BytesIO(g))
    for (y, cb, cr), d in zip(frames, dec):
        err = np.abs(d[0].astype(np.int64) - y.astype(np.int64))
        mse = (err ** 2).mean()
        psnr = 10 * np.log10(255 ** 2 / max(mse, 1e-9))
        assert psnr > 30, psnr


# ---- §13.3 intra slices (v3.1): the tile-sharding enabler ----

def test_intra_slice_reset_changes_prediction(rng):
    """reset_rows partitions the plane into independent slices: coding the
    slices separately must equal coding the whole plane with the reset."""
    h, w = 64, 48
    cur = rng.integers(0, 256, (h, w)).astype(np.int32)
    qs = spec.qsteps_pos(np.full((h // 8, w // 8), 20, np.int64), False)
    lv, rec = spec.intra_rows_code_plane(cur, qs, 8, reset_rows=4)
    # slice independence: rows [4:8) coded standalone give identical output
    lv2, rec2 = spec.intra_rows_code_plane(cur[32:], qs[4:], 8)
    assert np.array_equal(lv[4:], lv2)
    assert np.array_equal(rec[32:], rec2)
    # and the recon twin honors the same reset
    assert np.array_equal(rec, spec.intra_rows_recon_plane(lv, qs, 4))


def test_intra_slice_jnp_matches_numpy(rng):
    import jax.numpy as jnp

    from video_encoder.ops import transform as tx

    h, w = 64, 48
    cur = rng.integers(0, 256, (h, w)).astype(np.int32)
    qs = spec.qsteps_pos(
        np.asarray(spec.QSTEP)[rng.integers(10, 40, (h // 8, w // 8))], False
    )
    lv_np, rec_np = spec.intra_rows_code_plane(cur, qs, 6, reset_rows=2)
    lv_j, rec_j = tx.intra_rows_code_plane(
        jnp.asarray(cur), jnp.asarray(qs, jnp.int32), 6, 2
    )
    assert np.array_equal(lv_np, np.asarray(lv_j))
    assert np.array_equal(rec_np, np.asarray(rec_j))
    rec2 = tx.intra_rows_recon_plane(jnp.asarray(lv_np),
                                     jnp.asarray(qs, jnp.int32), 2)
    assert np.array_equal(rec_np, np.asarray(rec2))


@pytest.mark.parametrize("islice", [1, 2])
def test_v3_islice_golden_equals_gop_engine_and_decodes(rng, islice):
    w, h, n = 96, 64, 4
    frames = _gradient_clip(rng, w, h, n)
    cfg = EncoderConfig(width=w, height=h, gop_n=n, base_qp=26,
                        format_version=3, chroma_qp_offset=2,
                        intra_slice_mbrows=islice)
    g = _encode(cfg, frames, GoldenEngine())

    from video_encoder.codec.bitstream import OrderedMux

    eng = GopEngine(cfg)
    buf = io.BytesIO()
    mux = OrderedMux(buf, cfg, n)
    packets, _ = eng.encode_gop(
        [golden.Frame.from_planes(*f) for f in frames], 0)
    for p in packets:
        mux.push(p)
    assert buf.getvalue() == g

    # every decoder reconstructs the sliced stream identically
    _, golden_frames = decode_clip(io.BytesIO(g))
    want = [tuple(np.asarray(p) for p in f) for f in golden_frames]
    _, gop_frames = decode_clip_gop(io.BytesIO(g))
    for a, b in zip(want, gop_frames):
        for pa, pb in zip(a, b):
            assert np.array_equal(pa, pb)
    _, native_frames = decode_clip_native(io.BytesIO(g))
    for a, b in zip(want, native_frames):
        for pa, pb in zip(a, b):
            assert np.array_equal(np.asarray(pa, np.uint8), pb)
    # recon == source-side recon: decode must equal the encoder's recon
    from video_encoder.utils.metrics import psnr
    assert psnr(want[0][0], frames[0][0]) > 25


def test_v3_islice_oracle_equality(rng, tmp_path):
    native.build(os.path.dirname(ORACLE), "oracle")
    w, h, n = 96, 64, 4
    frames = _gradient_clip(rng, w, h, n)
    path = tmp_path / "in.yuv"
    with open(path, "wb") as f:
        for y, cb, cr in frames:
            f.write(y.tobytes()); f.write(cb.tobytes()); f.write(cr.tobytes())
    cfg = EncoderConfig(width=w, height=h, gop_n=n, base_qp=26,
                        format_version=3, chroma_qp_offset=2,
                        intra_slice_mbrows=2)
    g = _encode(cfg, frames, GoldenEngine())
    out = tmp_path / "o.tvc"
    r = subprocess.run(
        [ORACLE, "encode", str(path), str(out), str(w), str(h), str(n),
         "26", "full", "none", "0", str(n), "3", "2", "8", "0", "0", "2"],
        capture_output=True)
    assert r.returncode == 0, r.stderr
    assert out.read_bytes() == g
    # oracle CLI decode of the sliced stream == golden decode
    dec = tmp_path / "dec.yuv"
    r = subprocess.run([ORACLE, "decode", str(out), str(dec)],
                       capture_output=True)
    assert r.returncode == 0, r.stderr
    _, golden_frames = decode_clip(io.BytesIO(g))
    raw = dec.read_bytes()
    fsz = w * h * 3 // 2
    for i, f in enumerate(golden_frames):
        y = np.frombuffer(raw[i*fsz:i*fsz + w*h], np.uint8).reshape(h, w)
        assert np.array_equal(np.asarray(f.y if hasattr(f, 'y') else f[0],
                                         np.uint8), y)


def test_islice_requires_v3():
    with pytest.raises(ValueError):
        EncoderConfig(width=32, height=32, format_version=2,
                      intra_slice_mbrows=2)
