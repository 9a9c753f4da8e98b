"""rc=mb — per-MB quantizer rate control with bits-spent feedback
(SPEC.md §10.4; BASELINE.json config 3 "per-macroblock quantizer rate
control"). Exact integer spec, so golden / device GOP scan / C++ oracle
streams must be byte-identical, and the row-local definition must keep
tile-sharded encodes byte-identical too."""

import io
import os
import subprocess

import jax
import numpy as np
import pytest

from video_encoder.codec import golden, native, spec
from video_encoder.codec.config import EncoderConfig
from video_encoder.pipeline.decoder import decode_clip
from video_encoder.pipeline.encoder import GoldenEngine, encode_clip
from video_encoder.pipeline.gop_engine import GopEngine, mb_rc_offsets_jnp

ORACLE = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "oracle", "oracle"
)


def _skewed_clip(rng, w, h, n):
    """Left half: flat (cheap). Right half: noise (expensive). The pace
    error builds across each MB row, so rc=mb must raise qp on the right."""
    frames = []
    for t in range(n):
        y = np.full((h, w), 120, np.uint8)
        y[:, w // 2 :] = rng.integers(0, 256, (h, w // 2))
        y[t % h, :] = 200  # a little motion
        frames.append((y, np.full((h // 2, w // 2), 128, np.uint8),
                       np.full((h // 2, w // 2), 128, np.uint8)))
    return frames


def _encode(cfg, frames, engine=None):
    buf = io.BytesIO()
    encode_clip(cfg, iter(frames), buf, n_frames=len(frames), engine=engine)
    return buf.getvalue()


def test_mb_rc_offsets_properties(rng):
    est = rng.integers(0, 4000, (6, 20))
    d = spec.mb_rc_offsets(est)
    assert d.shape == est.shape and d.min() >= -2 and d.max() <= 2
    assert (d[:, 0] == 0).all()  # no feedback before any bits are spent
    # all bits in the first MB -> max positive offset right after it,
    # decaying to 0 as the uniform plan catches up by the row's end
    est2 = np.zeros((1, 10), np.int64)
    est2[0, 0] = 5000
    d2 = spec.mb_rc_offsets(est2)
    assert d2[0, 1] == 2 and (d2[0, 1:] >= 0).all() and d2[0, -1] <= 1
    # uniform row -> pace error stays inside one delta step
    est3 = np.full((1, 16), 100, np.int64)
    assert (np.abs(spec.mb_rc_offsets(est3)) <= 1).all()
    # jnp twin is the identical integer program
    dj = np.asarray(mb_rc_offsets_jnp(np.asarray(est, np.int32)))
    assert np.array_equal(dj, d)


@pytest.mark.parametrize("fmt", [1, 2])
def test_mb_golden_equals_gop_engine(rng, fmt):
    w, h, n = 96, 48, 5
    frames = _skewed_clip(rng, w, h, n)
    cfg = EncoderConfig(width=w, height=h, gop_n=n, base_qp=26, rc="mb",
                        target_kbps=64, format_version=fmt,
                        chroma_qp_offset=2 if fmt == 2 else 0)
    g = _encode(cfg, frames, GoldenEngine())

    from video_encoder.codec.bitstream import OrderedMux

    eng = GopEngine(cfg)
    buf = io.BytesIO()
    mux = OrderedMux(buf, cfg, n)
    packets, _ = eng.encode_gop([golden.Frame.from_planes(*f) for f in frames], 0)
    for p in packets:
        mux.push(p)
    assert buf.getvalue() == g

    # decodes cleanly and matches the encoder recon contract
    _, dec_frames = decode_clip(io.BytesIO(g))
    assert len(list(dec_frames)) == n


def test_mb_oracle_equality(rng, tmp_path):
    native.build(os.path.dirname(ORACLE), "oracle")
    w, h, n = 96, 48, 5
    frames = _skewed_clip(rng, w, h, n)
    path = tmp_path / "in.yuv"
    with open(path, "wb") as f:
        for y, cb, cr in frames:
            f.write(y.tobytes()); f.write(cb.tobytes()); f.write(cr.tobytes())
    cfg = EncoderConfig(width=w, height=h, gop_n=n, base_qp=26, rc="mb",
                        target_kbps=64)
    g = _encode(cfg, frames, GoldenEngine())
    out = tmp_path / "o.tvc"
    r = subprocess.run(
        [ORACLE, "encode", str(path), str(out), str(w), str(h), str(n), "26",
         "full", "mb", "64", str(n)],
        capture_output=True)
    assert r.returncode == 0, r.stderr
    assert out.read_bytes() == g


def test_mb_feedback_engages(rng):
    """On pace-skewed content the offsets must actually fire. Expensive
    LEFT half: the row overspends its uniform plan early, so later MBs get
    positive deltas (coarser qp) and the frame spends fewer bits than the
    flat-qp pass."""
    w, h = 128, 32
    y = np.full((h, w), 120, np.uint8)
    y[:, : w // 2] = rng.integers(0, 256, (h, w // 2))
    frame = golden.Frame.from_planes(
        y, np.full((h // 2, w // 2), 128, np.uint8),
        np.full((h // 2, w // 2), 128, np.uint8))
    cfg = EncoderConfig(width=w, height=h, gop_n=2, base_qp=30, rc="mb",
                        target_kbps=64)
    res = golden.encode_frame(cfg, frame, None, 0, 30)
    flat = golden.encode_frame(
        cfg, frame, None, 0, 30,
        _qp_mb=np.full((h // 16, w // 16), 30, np.int32))
    d = spec.mb_rc_offsets(flat.mb_bits)
    assert (d > 0).any(), "no positive pace feedback on skewed content"
    # feedback coarsens the overspending rows: pass-2 stream is smaller
    assert res.payload_bits < flat.payload_bits


@pytest.mark.skipif(len(jax.devices()) < 4, reason="needs 4 fake devices")
def test_mb_tile_sharded_equals_single(rng):
    """SPEC.md §10.4 is row-local, so MB-row tile sharding stays
    byte-identical under rc=mb."""
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from video_encoder.codec import entropy
    from video_encoder.parallel import tiles

    h, w, t, ntile = 64, 32, 3, 4
    base = rng.integers(0, 256, (h + 16, w + 16)).astype(np.int32)
    frames = []
    for k in range(t):
        y = base[k : k + h, 2 * k : 2 * k + w].astype(np.uint8)
        frames.append(golden.Frame.from_planes(
            y, np.full((h // 2, w // 2), 100, np.uint8),
            np.full((h // 2, w // 2), 140, np.uint8)))
    cfg = EncoderConfig(width=w, height=h, gop_n=t, base_qp=24, rc="mb",
                        target_kbps=50)
    ref_pk, _ = GopEngine(cfg).encode_gop(frames, 0)

    mesh = Mesh(np.array(jax.devices()[:ntile]), ("tile",))
    y = jnp.asarray(np.stack([f.y for f in frames]).astype(np.uint8))
    cb = jnp.asarray(np.stack([f.cb for f in frames]).astype(np.uint8))
    cr = jnp.asarray(np.stack([f.cr for f in frames]).astype(np.uint8))
    n_mbs_shard = (h // ntile // 16) * (w // 16)
    outs = tiles.encode_gop_tiled(
        y, cb, cr, 24, mesh=mesh, rc="mb",
        block_words=entropy.BLOCK_WORDS_MAX,
        cap_words=entropy.max_words(n_mbs_shard),
        target_bits=cfg.target_bits_per_frame(), ref_mode="halo",
    )
    assert not bool(np.asarray(outs["ovf"]).any())
    bits = np.asarray(outs["bits"])
    words = np.asarray(outs["words"])
    for k in range(t):
        payload, nbits = tiles.bit_concat(
            [(words[s, k], int(bits[s, k])) for s in range(ntile)]
        )
        assert nbits == ref_pk[k].payload_bits
        assert payload == ref_pk[k].payload
