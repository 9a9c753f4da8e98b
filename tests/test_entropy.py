"""Entropy-pack equivalence and property tests (SURVEY.md §7.2 hard part 1):
the production tree pack must equal the reference symbol-stream pack on
adversarial patterns, and tree_concat must equal host bit-concatenation."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from video_encoder.codec import entropy
from video_encoder.codec.bitio import BitWriter


def _pack_both(lv, qpd, isin, dy, dx, is_p, bw=24):
    cap = entropy.capacity_words(lv.shape[0] * lv.shape[1], 16000)
    v, l = entropy.mb_symbols(
        jnp.asarray(lv), jnp.asarray(qpd), jnp.asarray(is_p), jnp.asarray(isin),
        jnp.asarray(dy), jnp.asarray(dx))
    w1, t1 = entropy.pack_bits(v, l, cap)
    w2, t2, mbb, ovf = entropy.pack_frame_blocked(
        jnp.asarray(lv), jnp.asarray(qpd), jnp.asarray(is_p), jnp.asarray(isin),
        jnp.asarray(dy), jnp.asarray(dx), bw, cap)
    return np.asarray(w1), int(t1), np.asarray(w2), int(t2), bool(ovf), np.asarray(mbb)


@pytest.mark.parametrize("density,is_p", [(0.0, False), (0.05, True), (0.5, True), (1.0, False)])
def test_tree_pack_equals_reference(rng, density, is_p):
    nby, nbx = 4, 6
    lv = rng.integers(-4095, 4096, (nby, nbx, 6, 64)).astype(np.int32)
    mask = rng.random(lv.shape) < density
    lv = np.where(mask, lv, 0).astype(np.int32)
    qpd = rng.integers(-31, 32, (nby, nbx)).astype(np.int32)
    isin = rng.random((nby, nbx)) < 0.5
    dy = rng.integers(-16, 17, (nby, nbx)).astype(np.int32)
    dx = rng.integers(-16, 17, (nby, nbx)).astype(np.int32)
    bw = entropy.BLOCK_WORDS_MAX if density > 0.3 else 24
    w1, t1, w2, t2, ovf, mbb = _pack_both(lv, qpd, isin, dy, dx, is_p, bw)
    assert not ovf
    assert t1 == t2
    nw = (t1 + 31) // 32
    assert np.array_equal(w1[:nw], w2[:nw])
    assert mbb.sum() == t1


def test_tree_pack_all_zero_levels(rng):
    nby, nbx = 2, 3
    lv = np.zeros((nby, nbx, 6, 64), np.int32)
    qpd = np.zeros((nby, nbx), np.int32)
    isin = np.zeros((nby, nbx), bool)
    z = np.zeros((nby, nbx), np.int32)
    w1, t1, w2, t2, ovf, _ = _pack_both(lv, qpd, isin, z, z, False)
    assert t1 == t2 and not ovf
    # I-frame, all-zero: per MB = se(0)=1 bit + 6 cbf bits = 7 bits
    assert t1 == nby * nbx * 7


def test_tree_concat_matches_host(rng):
    n, w = 13, 4
    bufs, bits, full = [], [], BitWriter()
    for i in range(n):
        bw_ = BitWriter()
        nbits = int(rng.integers(0, w * 32))
        while bw_.nbits + 24 <= nbits:
            v = int(rng.integers(0, 1 << 24))
            bw_.put(v, 24)
            full.put(v, 24)
        words = np.zeros(w, np.uint32)
        ww = bw_.words()
        words[: len(ww)] = ww
        bufs.append(words)
        bits.append(bw_.nbits)
    cap = 64
    out, total = jax.jit(lambda b, l: entropy.tree_concat(b, l, cap))(
        jnp.asarray(np.stack(bufs)), jnp.asarray(np.array(bits, np.int32))
    )
    assert int(total) == full.nbits
    nw = (full.nbits + 31) // 32
    assert np.array_equal(np.asarray(out)[:nw], full.words())


def test_block_overflow_flagged(rng):
    """Dense max-magnitude levels must trip the block budget flag."""
    nby, nbx = 1, 1
    lv = np.full((nby, nbx, 6, 64), 4095, np.int32)
    z = np.zeros((nby, nbx), np.int32)
    cap = entropy.capacity_words(1, entropy.MAX_MB_BITS)
    _, _, _, ovf = entropy.pack_frame_blocked(
        jnp.asarray(lv), jnp.asarray(z), jnp.asarray(False),
        jnp.asarray(z.astype(bool)), jnp.asarray(z), jnp.asarray(z), 8, cap)
    assert bool(ovf)


def test_pack_frame_planes_matches_blocked(rng):
    """pack_frame_planes (per-plane levels) is byte-identical to
    pack_frame_blocked (interleaved blocks6 levels)."""
    import jax
    import jax.numpy as jnp

    from video_encoder.codec import entropy

    nby, nbx = 6, 10
    lz6 = jnp.asarray(
        rng.integers(-40, 40, (nby, nbx, 6, 64)) * (rng.random((nby, nbx, 6, 64)) < 0.2),
        jnp.int32,
    )
    # split into per-plane layouts (inverse of the blocks6 interleave)
    lzy = jnp.zeros((2 * nby, 2 * nbx, 64), jnp.int32)
    lzy = lzy.at[0::2, 0::2].set(lz6[:, :, 0])
    lzy = lzy.at[0::2, 1::2].set(lz6[:, :, 1])
    lzy = lzy.at[1::2, 0::2].set(lz6[:, :, 2])
    lzy = lzy.at[1::2, 1::2].set(lz6[:, :, 3])
    lzcb, lzcr = lz6[:, :, 4], lz6[:, :, 5]

    qpd = jnp.asarray(rng.integers(-3, 4, (nby, nbx)), jnp.int32)
    is_inter = jnp.asarray(rng.integers(0, 2, (nby, nbx)).astype(bool))
    dy = jnp.asarray(rng.integers(-16, 17, (nby, nbx)), jnp.int32)
    dx = jnp.asarray(rng.integers(-16, 17, (nby, nbx)), jnp.int32)
    cap = entropy.capacity_words(nby * nbx, 2048)

    for is_p in (False, True):
        w1, t1, m1, o1 = entropy.pack_frame_blocked(
            lz6, qpd, jnp.asarray(is_p), is_inter, dy, dx, 24, cap
        )
        w2, t2, m2, o2 = entropy.pack_frame_planes(
            lzy, lzcb, lzcr, qpd, jnp.asarray(is_p), is_inter, dy, dx, 24, cap
        )
        assert int(t1) == int(t2)
        assert jax.numpy.array_equal(w1, w2)
        assert jax.numpy.array_equal(m1, m2)
        assert bool(o1) == bool(o2)


def test_mb_source_chunk_pack_equals_piece_array_path(rng):
    """pack_frame_chunks(_v2): the host bit-concat of the span strings is
    byte-identical to the device-assembled frame of pack_frame_planes(_v2),
    with the same mb_bits and ovf."""
    from video_encoder.parallel.tiles import bit_concat

    nby, nbx, bw = 6, 7, 16
    n_mbs = nby * nbx
    lvl = np.where(rng.random((2 * nby, 2 * nbx, 64)) < 0.15,
                   rng.integers(-200, 201, (2 * nby, 2 * nbx, 64)),
                   0).astype(np.int32)
    lc = np.where(rng.random((nby, nbx, 64)) < 0.1,
                  rng.integers(-90, 91, (nby, nbx, 64)), 0).astype(np.int32)
    qpd = jnp.asarray(rng.integers(-2, 3, (nby, nbx)), jnp.int32)
    dy = jnp.asarray(rng.integers(-16, 17, (nby, nbx)), jnp.int32)
    dxv = jnp.asarray(rng.integers(-16, 17, (nby, nbx)), jnp.int32)
    isin = jnp.asarray(rng.random((nby, nbx)) < 0.85)
    args = (jnp.asarray(lvl), jnp.asarray(lc), jnp.asarray(lc), qpd, True,
            isin, dy, dxv, bw)
    cap = entropy.max_words(n_mbs)

    for chunks, planes in ((entropy.pack_frame_chunks,
                            entropy.pack_frame_planes),
                           (entropy.pack_frame_chunks_v2,
                            entropy.pack_frame_planes_v2)):
        cw, cb, mb_c, ovf_c = jax.jit(chunks, static_argnums=8)(*args)
        words, bits, mb_p, ovf_p = jax.jit(
            planes, static_argnums=(8, 9))(*args, cap)
        cw, cb = np.asarray(cw), np.asarray(cb)
        payload, nbits = bit_concat([(cw[i], int(cb[i]))
                                     for i in range(len(cb))])
        assert nbits == int(bits)
        nw = (nbits + 31) // 32
        assert payload == np.asarray(words)[:nw].astype(">u4").tobytes()
        assert np.array_equal(np.asarray(mb_c), np.asarray(mb_p))
        assert bool(ovf_c) == bool(ovf_p)
