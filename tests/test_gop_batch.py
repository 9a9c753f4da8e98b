"""Batched-GOP scan (gop_engine.encode_gop_batch_jit): G independent GOPs
encoded in lockstep by one program must be byte-identical to G sequential
single-GOP encodes, under every rc mode and format (SPEC.md §11 invariant 2;
r2 verdict item 1 — the floor-amortizing production shape for clip encode).
"""

import numpy as np
import pytest

from tests.conftest import make_clip
from video_encoder.codec.config import EncoderConfig
from video_encoder.codec.golden import Frame
from video_encoder.pipeline.gop_engine import GopEngine

W, H, T, G = 48, 32, 3, 3


def _gops(rng):
    frames = [Frame.from_planes(*p) for p in make_clip(rng, W, H, T * G)]
    return [frames[i * T : (i + 1) * T] for i in range(G)]


def _assert_batch_equals_sequential(cfg, gops, base_qps=None):
    eng = GopEngine(cfg)
    firsts = [i * T for i in range(G)]
    seq = [
        eng.encode_gop(g, f, None if base_qps is None else base_qps[i])
        for i, (g, f) in enumerate(zip(gops, firsts))
    ]
    bat = eng.encode_gops(gops, firsts, base_qps)
    for (sp, _), (bp, bs) in zip(seq, bat):
        assert len(sp) == len(bp)
        for a, b in zip(sp, bp):
            assert a.to_bytes() == b.to_bytes()
        for st in bs:
            assert st.bits >= 0


@pytest.mark.parametrize("rc,kbps", [
    ("none", 0), ("adaptive", 0), ("bitrate", 300), ("vbv", 300), ("mb", 300),
])
def test_batch_matches_sequential_rc(rng, rc, kbps):
    cfg = EncoderConfig(
        width=W, height=H, gop_n=T, base_qp=26, search="full",
        rc=rc, target_kbps=kbps,
        vbv_kbits=(kbps // 2 if rc == "vbv" else 0),
    )
    _assert_batch_equals_sequential(cfg, _gops(rng))


@pytest.mark.parametrize("fmt,qmat", [(1, False), (2, False), (3, False), (3, True), (4, False)])
def test_batch_matches_sequential_formats(rng, fmt, qmat):
    cfg = EncoderConfig(
        width=W, height=H, gop_n=T, base_qp=26, search="full",
        format_version=fmt, chroma_qp_offset=(2 if fmt >= 2 else 0),
        quant_matrix=qmat,
    )
    _assert_batch_equals_sequential(cfg, _gops(rng))


@pytest.mark.parametrize("search", ["diamond"])
def test_batch_matches_sequential_search(rng, search):
    cfg = EncoderConfig(width=W, height=H, gop_n=T, base_qp=26, search=search)
    _assert_batch_equals_sequential(cfg, _gops(rng))


def test_batch_per_gop_base_qps(rng):
    """Per-GOP base qp vector (the two-pass pass-2 shape)."""
    cfg = EncoderConfig(width=W, height=H, gop_n=T, base_qp=26, search="full")
    _assert_batch_equals_sequential(cfg, _gops(rng), base_qps=[22, 26, 31])


def test_batch_overflow_fallback(rng):
    """qp 4 floods the budgeted pack; the worst-case rerun must keep batched
    == sequential byte-exact."""
    cfg = EncoderConfig(width=W, height=H, gop_n=T, base_qp=4, search="full")
    _assert_batch_equals_sequential(cfg, _gops(rng))


def test_unroll_is_bit_identical(rng):
    import jax.numpy as jnp

    from video_encoder.codec import entropy
    from video_encoder.pipeline import gop_engine

    frames = [Frame.from_planes(*p) for p in make_clip(rng, W, H, 4)]
    y = jnp.asarray(np.stack([f.y for f in frames]))
    cb = jnp.asarray(np.stack([f.cb for f in frames]))
    cr = jnp.asarray(np.stack([f.cr for f in frames]))
    n_mbs = (H // 16) * (W // 16)
    kw = dict(search="full", rc="none", block_words=24,
              cap_words=entropy.max_words(n_mbs), target_bits=0)
    a = gop_engine.encode_gop_jit(y, cb, cr, 26, **kw)
    b = gop_engine.encode_gop_jit(y, cb, cr, 26, **kw, unroll=2)
    assert np.array_equal(np.asarray(a["words"]), np.asarray(b["words"]))
    assert np.array_equal(np.asarray(a["bits"]), np.asarray(b["bits"]))


def test_emit_chunks_matches_frame(rng):
    """The host-muxed chunk emission (SURVEY.md 7.0 'host does bytes') is
    byte-identical to the device-assembled frame path on every format/rc
    it runs under; GopEngine.emit selects it."""
    gops = _gops(rng)
    for fmt in (1, 2, 4):
        cfg = EncoderConfig(width=W, height=H, gop_n=T, base_qp=26,
                            search="full", format_version=fmt,
                            rc="mb" if fmt == 2 else "none",
                            target_kbps=300 if fmt == 2 else 0)
        ref_eng = GopEngine(cfg)
        ch_eng = GopEngine(cfg)
        ch_eng.emit = "chunks"
        for g, first in zip(gops, [0, T, 2 * T]):
            a, _ = ref_eng.encode_gop(g, first)
            b, _ = ch_eng.encode_gop(g, first)
            assert [p.to_bytes() for p in a] == [p.to_bytes() for p in b]
        # batched path too
        a = ref_eng.encode_gops(gops, [0, T, 2 * T])
        b = ch_eng.encode_gops(gops, [0, T, 2 * T])
        for (ap, _), (bp, _) in zip(a, b):
            assert [p.to_bytes() for p in ap] == [p.to_bytes() for p in bp]
