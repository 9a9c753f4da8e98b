"""The per-block pack and the span-string merge against sequential
references.

entropy._pack_blocks (block_symbols(_v2) + pack_dense) must write exactly
what codec/bitio.BitWriter writes for the same ue/se symbols (SPEC.md §5
and §12), across both syntaxes, word budgets, densities and the value
extremes of the quantizer range (|level| <= 3925, SPEC.md §4). The span
merge (span_geometry + _pieces_to_chunks) must glue to one whole-frame
tree_concat, also when the piece count is not a multiple of the span.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from video_encoder.codec import entropy
from video_encoder.codec.bitio import BitWriter
from video_encoder.parallel.tiles import bit_concat


def _levels(rng, n, density, mag=3000):
    lv = np.zeros((n, 64), np.int32)
    mask = rng.random((n, 64)) < density
    lv[mask] = rng.integers(-mag, mag + 1, mask.sum())
    if n >= 4:
        lv[0] = 0                                    # all-zero block
        lv[1] = rng.integers(-3925, 3926, 64)        # dense, extreme mags
        lv[2, 63] = 1                                # single trailing coef
        lv[3, 0] = -3925                             # DC-only
    return lv


def _write_block(zz, fmt, pdc):
    """One 8x8 block's symbols, written sequentially (golden's syntax)."""
    bw = BitWriter()
    nz = np.nonzero(zz)[0]
    if len(nz) == 0:
        bw.put(0, 1)
        return bw
    bw.put(1, 1)
    if fmt >= 2:
        bw.put_se(int(zz[0]) - int(pdc))
        nz = nz[nz > 0]
        bw.put_ue(len(nz))
        prev = 0
    else:
        bw.put_ue(len(nz) - 1)
        prev = -1
    for pos in nz:
        bw.put_ue(int(pos - prev - 1))
        bw.put_se(int(zz[pos]))
        prev = pos
    return bw


@pytest.mark.parametrize("fmt", [1, 2])
@pytest.mark.parametrize("density", [0.02, 0.2, 0.7])
@pytest.mark.parametrize("n,words", [(37, 16), (300, 24), (512, 78)])
def test_block_pack_matches_bitwriter(rng, fmt, density, n, words):
    lv = _levels(rng, n, density)
    dcp = rng.integers(-3925, 3926, n).astype(np.int32)
    got_w, got_b, ovf = entropy._pack_blocks(
        jnp.asarray(lv), jnp.asarray(dcp) if fmt >= 2 else None, fmt, words)
    got_w, got_b = np.asarray(got_w), np.asarray(got_b)
    over = False
    for i in range(n):
        want = _write_block(lv[i], fmt, dcp[i])
        assert int(got_b[i]) == want.nbits, i
        if want.nbits <= 32 * words:
            ww = want.words()
            assert np.array_equal(got_w[i, :len(ww)], ww), i
            assert not got_w[i, len(ww):].any(), i
        over |= want.nbits > 32 * words
    assert bool(ovf) == over


def test_block_pack_overflow_bits_visible(rng):
    """A too-small word budget truncates each string to its budget (the
    prefix is still the sequential stream) while the bit count reports the
    true length, so the engine's overflow flag fires and it reruns."""
    n, words = 256, 4  # far below the dense-block worst case
    lv = rng.integers(-3925, 3926, (n, 64)).astype(np.int32)
    got_w, got_b, ovf = entropy._pack_blocks(jnp.asarray(lv), None, 1, words)
    assert bool(ovf)
    got_w, got_b = np.asarray(got_w), np.asarray(got_b)
    for i in range(0, n, 17):
        want = _write_block(lv[i], 1, 0)
        assert int(got_b[i]) == want.nbits > 32 * words
        assert np.array_equal(got_w[i], want.words()[:words])


def _piece_strings(rng, n, w):
    """Valid MSB-first piece strings of random length (0 .. 32*w bits)."""
    bits = rng.integers(0, 32 * w + 1, n).astype(np.int32)
    bits[::7] = 0  # empty pieces, as the engine's padding piece
    words = rng.integers(0, 2**32, (n, w), dtype=np.uint64).astype(np.uint32)
    idx = np.arange(w)[None, :] * 32
    keep = np.clip(bits[:, None] - idx, 0, 32)
    mask = np.where(keep >= 32, 0xFFFFFFFF,
                    (0xFFFFFFFF << (32 - keep)) & 0xFFFFFFFF).astype(np.uint32)
    return words & np.where(keep > 0, mask, 0).astype(np.uint32), bits


@pytest.mark.parametrize("n,w", [(37, 16), (1000, 16), (5000, 16), (3001, 78)])
def test_pieces_to_chunks_equal_whole_frame_concat(rng, n, w):
    n2, h, cw, n_strings = entropy.span_geometry(n, w)
    assert n % h != 0  # the tail span is padded with empty pieces
    words, bits = _piece_strings(rng, n, w)
    cwords, cbits = jax.jit(entropy._pieces_to_chunks)(
        jnp.asarray(words), jnp.asarray(bits))
    assert cwords.shape == (n_strings, cw)
    cwords, cbits = np.asarray(cwords), np.asarray(cbits)
    got, nbits = bit_concat([(cwords[i], int(cbits[i]))
                             for i in range(n_strings)])
    total = int(bits.sum())
    full, fbits = jax.jit(entropy.tree_concat, static_argnums=2)(
        jnp.asarray(words), jnp.asarray(bits), (total + 31) // 32 + 1)
    assert nbits == int(fbits) == total
    want = np.asarray(full)[:(total + 31) // 32].astype(">u4").tobytes()
    assert got == want


@pytest.mark.parametrize("n,w", [(16, 16), (37, 16), (3073, 16), (259200, 16),
                                 (1800, 78), (129601, 78)])
def test_span_geometry_idempotent_and_covering(n, w):
    n2, h, cw, n_strings = entropy.span_geometry(n, w)
    assert n2 >= n and n2 == h * n_strings
    assert cw >= h * w  # a span string holds its h pieces at the worst case
    assert entropy.span_geometry(n2, w) == (n2, h, cw, n_strings)
