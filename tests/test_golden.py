"""Golden-model integration tests (SURVEY.md §4.5 "Integration" tier):
encode→decode bit-exactness (SPEC.md §11 invariant 1), ME correctness,
mode decisions, rate-control variants."""

import numpy as np
import pytest

from video_encoder.codec import golden, spec
from video_encoder.codec.config import EncoderConfig


def assert_frames_equal(a: golden.Frame, b: golden.Frame):
    assert np.array_equal(a.y, b.y)
    assert np.array_equal(a.cb, b.cb)
    assert np.array_equal(a.cr, b.cr)


def roundtrip_frame(cfg, cur, ref, frame_type, base_qp):
    res = golden.encode_frame(cfg, cur, ref, frame_type, base_qp)
    dec = golden.decode_frame(
        cfg.width, cfg.height, frame_type, base_qp, res.payload, res.payload_bits, ref
    )
    assert_frames_equal(res.recon, dec)
    return res, dec


@pytest.mark.parametrize("qp", [1, 28, 50, 63])
def test_intra_roundtrip(small_clip, qp):
    y, cb, cr = small_clip[0]
    cfg = EncoderConfig(width=64, height=48, gop_n=1, base_qp=qp)
    cur = golden.Frame.from_planes(y, cb, cr)
    roundtrip_frame(cfg, cur, None, 0, qp)


def test_intra_high_quality_psnr(small_clip):
    from video_encoder.utils.metrics import psnr

    y, cb, cr = small_clip[0]
    cfg = EncoderConfig(width=64, height=48, gop_n=1, base_qp=1)
    cur = golden.Frame.from_planes(y, cb, cr)
    res, _ = roundtrip_frame(cfg, cur, None, 0, 1)
    assert psnr(res.recon.y[:48, :64], cur.y[:48, :64]) > 45.0


def test_inter_roundtrip_full(small_clip):
    cfg = EncoderConfig(width=64, height=48, gop_n=30, base_qp=28, search="full")
    prev = golden.Frame.from_planes(*small_clip[0])
    res0 = golden.encode_frame(cfg, prev, None, 0, 28)
    cur = golden.Frame.from_planes(*small_clip[1])
    roundtrip_frame(cfg, cur, res0.recon, 1, 28)


def test_inter_roundtrip_diamond(small_clip):
    cfg = EncoderConfig(width=64, height=48, gop_n=30, base_qp=28, search="diamond")
    prev = golden.Frame.from_planes(*small_clip[0])
    res0 = golden.encode_frame(cfg, prev, None, 0, 28)
    cur = golden.Frame.from_planes(*small_clip[1])
    roundtrip_frame(cfg, cur, res0.recon, 1, 28)


def test_full_search_exact_translation(rng):
    """A pure translation must be found exactly (zero residual SAD)."""
    big = rng.integers(0, 256, size=(96, 128)).astype(np.int32)
    ref = big[8 : 8 + 48, 8 : 8 + 64]
    dy_true, dx_true = 5, -7
    cur = big[8 + dy_true : 8 + dy_true + 48, 8 + dx_true : 8 + dx_true + 64]
    dy, dx, sad = golden.sad_full_search(cur, ref)
    # interior MBs (away from pad effects) must find the exact motion
    assert np.all(dy[1:-1, 1:-1] == dy_true)
    assert np.all(dx[1:-1, 1:-1] == dx_true)
    assert np.all(sad[1:-1, 1:-1] == 0)


def test_full_search_tie_break_first():
    """Uniform frame: every candidate has SAD 0 → first candidate wins."""
    ref = np.full((48, 64), 77, dtype=np.int32)
    cur = ref.copy()
    dy, dx, sad = golden.sad_full_search(cur, ref)
    assert np.all(sad == 0)
    assert np.all(dy == -16) and np.all(dx == -16)  # row-major first candidate


def test_diamond_finds_small_translation(rng):
    big = rng.integers(0, 256, size=(96, 128)).astype(np.int32)
    ref = big[8 : 8 + 48, 8 : 8 + 64]
    cur = big[8 + 2 : 8 + 2 + 48, 8 + 2 : 8 + 2 + 64]
    dy, dx, sad = golden.sad_diamond_search(cur, ref)
    assert np.all(sad[1:-1, 1:-1] == 0)
    assert np.all(dy[1:-1, 1:-1] == 2)
    assert np.all(dx[1:-1, 1:-1] == 2)


def test_mode_decision_scene_change(rng):
    """Completely new content → intra MBs chosen on a P frame."""
    cfg = EncoderConfig(width=64, height=48, gop_n=30, base_qp=28)
    ref = golden.Frame.from_planes(
        np.zeros((48, 64), np.uint8), np.zeros((24, 32), np.uint8), np.zeros((24, 32), np.uint8)
    )
    res0 = golden.encode_frame(cfg, ref, None, 0, 28)
    # flat mid-gray frame: intra (SAD vs DC = 0) always <= inter SAD
    cur = golden.Frame.from_planes(
        np.full((48, 64), 200, np.uint8),
        np.full((24, 32), 128, np.uint8),
        np.full((24, 32), 128, np.uint8),
    )
    res = golden.encode_frame(cfg, cur, res0.recon, 1, 28)
    assert res.n_inter >= 0  # inter may win ties (both SAD 0 after recon)
    dec = golden.decode_frame(64, 48, 1, 28, res.payload, res.payload_bits, res0.recon)
    assert_frames_equal(res.recon, dec)


def test_adaptive_rc_roundtrip(small_clip):
    cfg = EncoderConfig(width=64, height=48, gop_n=30, base_qp=28, rc="adaptive")
    prev = golden.Frame.from_planes(*small_clip[0])
    res0 = golden.encode_frame(cfg, prev, None, 0, 28)
    dec0 = golden.decode_frame(64, 48, 0, 28, res0.payload, res0.payload_bits, None)
    assert_frames_equal(res0.recon, dec0)
    cur = golden.Frame.from_planes(*small_clip[1])
    roundtrip_frame(cfg, cur, res0.recon, 1, 28)


def test_qp63_still_decodes(small_clip):
    cfg = EncoderConfig(width=64, height=48, gop_n=1, base_qp=63)
    cur = golden.Frame.from_planes(*small_clip[0])
    res, _ = roundtrip_frame(cfg, cur, None, 0, 63)
    # heavy quantization: tiny payload
    assert res.payload_bits < 64 * 48 * 2


def test_gop_chain_recon_matches_decode(small_clip):
    """Five-frame GOP: decoder tracking its own recon chain matches encoder."""
    cfg = EncoderConfig(width=64, height=48, gop_n=30, base_qp=30)
    enc_ref = None
    dec_ref = None
    for i, (y, cb, cr) in enumerate(small_clip):
        cur = golden.Frame.from_planes(y, cb, cr)
        ftype = 0 if i == 0 else 1
        res = golden.encode_frame(cfg, cur, enc_ref, ftype, 30)
        dec = golden.decode_frame(64, 48, ftype, 30, res.payload, res.payload_bits, dec_ref)
        assert_frames_equal(res.recon, dec)
        enc_ref, dec_ref = res.recon, dec


def test_odd_dimensions_pad_crop(rng):
    """Non-multiple-of-16 dims: encode padded, crop back to true size."""
    w, h = 50, 34
    y = rng.integers(0, 256, size=(h, w)).astype(np.uint8)
    cb = rng.integers(0, 256, size=(h // 2, w // 2)).astype(np.uint8)
    cr = rng.integers(0, 256, size=(h // 2, w // 2)).astype(np.uint8)
    cfg = EncoderConfig(width=w, height=h, gop_n=1, base_qp=20)
    cur = golden.Frame.from_planes(y, cb, cr)
    res, dec = roundtrip_frame(cfg, cur, None, 0, 20)
    yy, ccb, ccr = dec.crop(w, h)
    assert yy.shape == (h, w)
    assert ccb.shape == (h // 2, w // 2)
