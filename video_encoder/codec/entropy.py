"""Device-side two-pass parallel entropy pack (SPEC.md §6–7).

The reference's serial bitwriter (SURVEY.md §3.1 hot loop; component C12) is
re-designed data-parallel per SURVEY.md §7.0: pass 1 computes every symbol's
(value, bit-length) in parallel over the whole MB grid with static
Exp-Golomb tables-as-formulas; pass 2 is an exclusive prefix-sum of lengths
plus a shifted scatter-add into the output uint32 word array. No sequential
bit I/O anywhere on the encode path.

Symbol slot layout per MB (fixed S slots; unused slots carry length 0 and
vanish in the pack — "early-exit becomes slot-freeze"):

  slot 0                  mb_mode   (ue; P frames only)
  slot 1, 2               se(dx), se(dy)   (inter MBs only)
  slot 3                  se(qp_delta)
  per block b in [0,6):   base = 4 + b*130
    base+0                cbf bit
    base+1                ue(nnz-1)        (if cbf)
    base+2+2i, base+3+2i  ue(run_i), se(level_i) for zigzag position i
                          (nonzero coefficients only)

S = 4 + 6*(2 + 128) = 784. Bit-exact against codec/bitio.BitWriter as used
by the golden model (tests/test_device.py).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from . import spec

SLOTS_PER_BLOCK = 2 + 2 * 64
SLOTS_PER_MB = 4 + 6 * SLOTS_PER_BLOCK  # 784
# Worst-case bits per MB: mode(3) + mv(2*11) + qp_delta(13)
#   + 6 * (cbf(1) + nnz(13) + 64 * (run(13) + level(25))) = 14714
MAX_MB_BITS = 3 + 22 + 13 + 6 * (1 + 13 + 64 * (13 + 25))


def _bitlen(x: jnp.ndarray) -> jnp.ndarray:
    """floor(log2(x)) + 1 for x>=1, 0 for x==0 (int32)."""
    return jnp.where(x > 0, 32 - jax.lax.clz(x.astype(jnp.int32)), 0)


def ue_code(v: jnp.ndarray):
    """(value, length) of ue(v): value = v+1 in 2*bitlen(v+1)-1 bits."""
    vp1 = v.astype(jnp.int32) + 1
    return vp1.astype(jnp.uint32), (2 * _bitlen(vp1) - 1).astype(jnp.int32)


def se_code(v: jnp.ndarray):
    """(value, length) of se(v) = ue(2v-1 if v>0 else -2v)."""
    m = jnp.where(v > 0, 2 * v - 1, -2 * v)
    return ue_code(m)


def mb_symbols(
    levels_zz: jnp.ndarray,  # [nby, nbx, 6, 64] int32, zigzag order
    qp_delta: jnp.ndarray,   # [nby, nbx] int32
    is_p_frame: jnp.ndarray, # scalar bool/int32
    is_inter: jnp.ndarray,   # [nby, nbx] bool
    dy: jnp.ndarray,         # [nby, nbx] int32
    dx: jnp.ndarray,
):
    """Pass 1: per-MB symbol (values, lengths) arrays [nby, nbx, S]."""
    nby, nbx = qp_delta.shape
    p = jnp.asarray(is_p_frame, jnp.bool_)

    # header symbols -------------------------------------------------------
    mode_val, mode_len = ue_code(jnp.where(is_inter, 0, 1))
    mode_len = jnp.where(p, mode_len, 0)
    inter_p = is_inter & p
    dx_val, dx_len = se_code(dx)
    dy_val, dy_len = se_code(dy)
    dx_len = jnp.where(inter_p, dx_len, 0)
    dy_len = jnp.where(inter_p, dy_len, 0)
    qpd_val, qpd_len = se_code(qp_delta)

    # coefficient symbols --------------------------------------------------
    nz = levels_zz != 0                       # [nby, nbx, 6, 64]
    nnz = nz.sum(axis=-1).astype(jnp.int32)   # [nby, nbx, 6]
    cbf = nnz > 0

    idx = jnp.arange(64, dtype=jnp.int32)
    masked_idx = jnp.where(nz, idx, -1)
    cm = jax.lax.cummax(masked_idx, axis=masked_idx.ndim - 1)
    prev_nz = jnp.concatenate(
        [jnp.full((*cm.shape[:-1], 1), -1, jnp.int32), cm[..., :-1]], axis=-1
    )
    run = idx - prev_nz - 1                   # valid where nz

    run_val, run_len = ue_code(jnp.where(nz, run, 0))
    lev_val, lev_len = se_code(levels_zz)
    run_len = jnp.where(nz, run_len, 0)
    lev_len = jnp.where(nz, lev_len, 0)

    cbf_val = cbf.astype(jnp.uint32)
    cbf_len = jnp.ones_like(nnz)
    nnz_val, nnz_len = ue_code(jnp.maximum(nnz - 1, 0))
    nnz_len = jnp.where(cbf, nnz_len, 0)

    # interleave run/level into [..., 6, 128] then assemble [..., S] -------
    coeff_val = jnp.stack([run_val, lev_val], axis=-1).reshape(nby, nbx, 6, 128)
    coeff_len = jnp.stack([run_len, lev_len], axis=-1).reshape(nby, nbx, 6, 128)
    block_val = jnp.concatenate(
        [cbf_val[..., None], nnz_val[..., None], coeff_val], axis=-1
    )  # [nby, nbx, 6, 130]
    block_len = jnp.concatenate(
        [cbf_len[..., None], nnz_len[..., None], coeff_len], axis=-1
    )

    head_val = jnp.stack([mode_val, dx_val, dy_val, qpd_val], axis=-1)
    head_len = jnp.stack([mode_len, dx_len, dy_len, qpd_len], axis=-1)

    values = jnp.concatenate(
        [head_val, block_val.reshape(nby, nbx, -1)], axis=-1
    ).astype(jnp.uint32)
    lengths = jnp.concatenate([head_len, block_len.reshape(nby, nbx, -1)], axis=-1)
    # zero the value wherever the length is zero (keeps the pack trivially safe)
    values = jnp.where(lengths > 0, values, 0)
    return values, lengths.astype(jnp.int32)


def pack_bits(values: jnp.ndarray, lengths: jnp.ndarray, n_words: int):
    """Pass 2: MSB-first scatter-pack of flat (value, length) symbol arrays.

    Returns (words uint32 [n_words], total_bits int32). Bit-exact with
    bitio.BitWriter.words(). Each symbol touches at most 2 output words;
    disjoint bit ranges make add equivalent to or.
    """
    values = values.reshape(-1).astype(jnp.uint32)
    lengths = lengths.reshape(-1).astype(jnp.int32)
    offsets = jnp.cumsum(lengths) - lengths  # exclusive prefix sum
    total_bits = offsets[-1] + lengths[-1] if lengths.size else jnp.int32(0)

    w = (offsets >> 5).astype(jnp.int32)
    s = (offsets & 31).astype(jnp.int32)
    fits = (s + lengths) <= 32

    sh1 = jnp.clip(jnp.where(fits, 32 - s - lengths, lengths - (32 - s)), 0, 31)
    c1 = jnp.where(
        fits, values << sh1.astype(jnp.uint32), values >> sh1.astype(jnp.uint32)
    )
    sh2 = jnp.clip(64 - s - lengths, 0, 31)
    c2 = jnp.where(fits, jnp.uint32(0), values << sh2.astype(jnp.uint32))

    live = lengths > 0
    c1 = jnp.where(live, c1, 0)
    c2 = jnp.where(live & ~fits, c2, 0)

    words = jnp.zeros((n_words,), jnp.uint32)
    words = words.at[w].add(c1, mode="drop")
    words = words.at[w + 1].add(c2, mode="drop")
    return words, total_bits


# ---------------------------------------------------------------------------
# Blocked pack — the production path.
#
# Packing per 8×8 *block* (S=130 symbols, W≈16 words) instead of per MB
# (S=784, W=64) cuts the S×W compare-reduce of pack_dense about 4×. The
# frame stream is then assembled from 7 pieces per MB (header + 6 block
# strings) by word-shift concatenation — the same trick the tile-parallel
# mux uses.
# ---------------------------------------------------------------------------

HEADER_SLOTS = 4
HEADER_WORDS = 2  # header ≤ 3+11+11+13 = 38 bits


def block_symbols(levels_zz: jnp.ndarray):
    """Per-block symbol arrays [..., 6, 130]: cbf, ue(nnz-1), (run, level)×64
    at their zigzag positions (length 0 where the coefficient is zero)."""
    nz = levels_zz != 0
    nnz = nz.sum(axis=-1).astype(jnp.int32)
    cbf = nnz > 0

    idx = jnp.arange(64, dtype=jnp.int32)
    masked_idx = jnp.where(nz, idx, -1)
    cm = jax.lax.cummax(masked_idx, axis=masked_idx.ndim - 1)
    prev_nz = jnp.concatenate(
        [jnp.full((*cm.shape[:-1], 1), -1, jnp.int32), cm[..., :-1]], axis=-1
    )
    run = idx - prev_nz - 1

    run_val, run_len = ue_code(jnp.where(nz, run, 0))
    lev_val, lev_len = se_code(levels_zz)
    run_len = jnp.where(nz, run_len, 0)
    lev_len = jnp.where(nz, lev_len, 0)

    cbf_val = cbf.astype(jnp.uint32)
    cbf_len = jnp.ones_like(nnz)
    nnz_val, nnz_len = ue_code(jnp.maximum(nnz - 1, 0))
    nnz_len = jnp.where(cbf, nnz_len, 0)

    pair_val = jnp.stack([run_val, lev_val], axis=-1).reshape(*nnz.shape, 128)
    pair_len = jnp.stack([run_len, lev_len], axis=-1).reshape(*nnz.shape, 128)
    values = jnp.concatenate([cbf_val[..., None], nnz_val[..., None], pair_val], -1)
    lengths = jnp.concatenate([cbf_len[..., None], nnz_len[..., None], pair_len], -1)
    values = jnp.where(lengths > 0, values.astype(jnp.uint32), 0)
    return values, lengths.astype(jnp.int32)


def _header_slots(qp_delta, is_p_frame, is_inter, dy, dx):
    """Per-MB header symbols with the slot axis LEADING: ([4, nby, nbx]
    uint32 values, [4, nby, nbx] int32 lengths) — mode, se(dx), se(dy),
    se(qpd). Slot-leading so pack_header's elementwise work runs over the
    (large) MB axes, not a trailing axis of 4."""
    p = jnp.asarray(is_p_frame, jnp.bool_)
    mode_val, mode_len = ue_code(jnp.where(is_inter, 0, 1))
    mode_len = jnp.where(p, mode_len, 0)
    inter_p = is_inter & p
    dx_val, dx_len = se_code(dx)
    dy_val, dy_len = se_code(dy)
    dx_len = jnp.where(inter_p, dx_len, 0)
    dy_len = jnp.where(inter_p, dy_len, 0)
    qpd_val, qpd_len = se_code(qp_delta)
    values = jnp.stack([mode_val, dx_val, dy_val, qpd_val], axis=0)
    lengths = jnp.stack([mode_len, dx_len, dy_len, qpd_len], axis=0)
    return jnp.where(lengths > 0, values.astype(jnp.uint32), 0), lengths


def header_symbols(qp_delta, is_p_frame, is_inter, dy, dx):
    """Per-MB header symbols [nby, nbx, 4]: mode, se(dx), se(dy), se(qpd)."""
    values, lengths = _header_slots(qp_delta, is_p_frame, is_inter, dy, dx)
    return jnp.moveaxis(values, 0, -1), jnp.moveaxis(lengths, 0, -1)


def pack_header(values, lengths, n_words: int = HEADER_WORDS):
    """pack_dense twin for slot-LEADING header symbols ([S, ...] from
    _header_slots/_header_slots_v2): identical bit placement (same slot
    order, same carry split), with every elementwise op on the [...] MB
    grid. Returns (words [..., W] uint32, bits [...] int32, overflow)."""
    off = jnp.cumsum(lengths, axis=0) - lengths
    bits = off[-1] + lengths[-1]
    overflow = (bits > 32 * n_words).any()

    sh = (off & 31).astype(jnp.int32)
    fits = (sh + lengths) <= 32
    sh1 = jnp.clip(jnp.where(fits, 32 - sh - lengths, lengths - (32 - sh)), 0, 31)
    c1 = jnp.where(fits, values << sh1.astype(jnp.uint32),
                   values >> sh1.astype(jnp.uint32))
    sh2 = jnp.clip(64 - sh - lengths, 0, 31)
    c2 = jnp.where(fits, jnp.uint32(0), values << sh2.astype(jnp.uint32))
    live = lengths > 0
    c1 = jnp.where(live, c1, 0)
    c2 = jnp.where(live & ~fits, c2, 0)

    w1 = (off >> 5).astype(jnp.int32)
    words = [
        (jnp.where(w1 == w, c1, 0).sum(axis=0, dtype=jnp.uint32)
         + jnp.where(w1 + 1 == w, c2, 0).sum(axis=0, dtype=jnp.uint32))
        for w in range(n_words)
    ]
    return jnp.stack(words, axis=-1), bits.astype(jnp.int32), overflow


def pack_dense(values: jnp.ndarray, lengths: jnp.ndarray, n_words: int):
    """Dense compare-select pack of [..., S] symbol strings into [..., W]
    word buffers: a broadcast compare-reduce, no gather, no scatter.

    Returns (words [..., W] uint32, bits [...], overflow flag)."""
    off = jnp.cumsum(lengths, axis=-1) - lengths
    bits = off[..., -1] + lengths[..., -1]
    overflow = (bits > 32 * n_words).any()

    sh = (off & 31).astype(jnp.int32)
    fits = (sh + lengths) <= 32
    sh1 = jnp.clip(jnp.where(fits, 32 - sh - lengths, lengths - (32 - sh)), 0, 31)
    c1 = jnp.where(fits, values << sh1.astype(jnp.uint32), values >> sh1.astype(jnp.uint32))
    sh2 = jnp.clip(64 - sh - lengths, 0, 31)
    c2 = jnp.where(fits, jnp.uint32(0), values << sh2.astype(jnp.uint32))
    live = lengths > 0
    c1 = jnp.where(live, c1, 0)
    c2 = jnp.where(live & ~fits, c2, 0)

    w1 = (off >> 5).astype(jnp.int32)
    wgrid = jnp.arange(n_words, dtype=jnp.int32)
    eq1 = w1[..., :, None] == wgrid
    eq2 = (w1 + 1)[..., :, None] == wgrid
    words = (
        jnp.where(eq1, c1[..., :, None], 0).sum(axis=-2, dtype=jnp.uint32)
        + jnp.where(eq2, c2[..., :, None], 0).sum(axis=-2, dtype=jnp.uint32)
    )
    return words, bits.astype(jnp.int32), overflow


def pack_frame_blocked(
    levels_zz: jnp.ndarray,  # [nby, nbx, 6, 64]
    qp_delta: jnp.ndarray,
    is_p_frame,
    is_inter: jnp.ndarray,
    dy: jnp.ndarray,
    dx: jnp.ndarray,
    block_words: int,
    n_words: int,
):
    """Production pack: per-block dense pack + one-pass frame assembly.

    Returns (words [n_words] uint32, total_bits, mb_bits [nby, nbx], ovf).
    Bit-exact with mb_symbols + pack_bits (tests/test_entropy.py).
    """
    nby, nbx = qp_delta.shape
    n_mbs = nby * nbx

    hv, hl = header_symbols(qp_delta, is_p_frame, is_inter, dy, dx)
    hwords, hbits, ovf_h = pack_dense(
        hv.reshape(n_mbs, HEADER_SLOTS), hl.reshape(n_mbs, HEADER_SLOTS), HEADER_WORDS
    )
    bv, bl = block_symbols(levels_zz)
    bwords, bbits, ovf_b = pack_dense(
        bv.reshape(n_mbs, 6, 130), bl.reshape(n_mbs, 6, 130), block_words
    )

    # pieces per MB: header, block 0..5, one empty (pads to 8 = 2^3 so the
    # reduction tree's first three levels stay inside the MB)
    hpad = jnp.pad(hwords, ((0, 0), (0, block_words - HEADER_WORDS)))
    piece_words = jnp.concatenate(
        [hpad[:, None], bwords, jnp.zeros((n_mbs, 1, block_words), jnp.uint32)],
        axis=1,
    )  # [n_mbs, 8, W]
    piece_bits = jnp.concatenate(
        [hbits[:, None], bbits, jnp.zeros((n_mbs, 1), jnp.int32)], axis=1
    )
    mb_bits = piece_bits[:, :7].sum(axis=1)

    words, total_bits = tree_concat(
        piece_words.reshape(n_mbs * 8, block_words),
        piece_bits.reshape(n_mbs * 8),
        n_words,
    )
    ovf_f = total_bits > 32 * n_words
    return words, total_bits, mb_bits.reshape(nby, nbx), ovf_h | ovf_b | ovf_f


def _header_slots_v2(qp_delta, is_p_frame, is_inter, dy, dx):
    """v2 per-MB header symbols, slot axis LEADING (see _header_slots):
    mv codes as se(mv − pred) with pred = the left MB's mv when both MBs
    are inter, else (0,0). Left-only prediction keeps MB rows independent
    (tile-shard safe). SPEC.md §12.3."""
    p = jnp.asarray(is_p_frame, jnp.bool_)
    mode_val, mode_len = ue_code(jnp.where(is_inter, 0, 1))
    mode_len = jnp.where(p, mode_len, 0)
    inter_p = is_inter & p

    left_inter = jnp.pad(is_inter[:, :-1], ((0, 0), (1, 0)))
    both = is_inter & left_inter
    pred_dx = jnp.where(both, jnp.pad(dx[:, :-1], ((0, 0), (1, 0))), 0)
    pred_dy = jnp.where(both, jnp.pad(dy[:, :-1], ((0, 0), (1, 0))), 0)

    dx_val, dx_len = se_code(dx - pred_dx)
    dy_val, dy_len = se_code(dy - pred_dy)
    dx_len = jnp.where(inter_p, dx_len, 0)
    dy_len = jnp.where(inter_p, dy_len, 0)
    qpd_val, qpd_len = se_code(qp_delta)
    values = jnp.stack([mode_val, dx_val, dy_val, qpd_val], axis=0)
    lengths = jnp.stack([mode_len, dx_len, dy_len, qpd_len], axis=0)
    return jnp.where(lengths > 0, values.astype(jnp.uint32), 0), lengths


def header_symbols_v2(qp_delta, is_p_frame, is_inter, dy, dx):
    """v2 per-MB header symbols [nby, nbx, 4] (SPEC.md §12.3)."""
    values, lengths = _header_slots_v2(qp_delta, is_p_frame, is_inter, dy, dx)
    return jnp.moveaxis(values, 0, -1), jnp.moveaxis(lengths, 0, -1)


BLOCK_SLOTS_V2 = 3 + 2 * 63  # cbf, se(dcd), ue(nnz_ac), (run, level) x 63


def block_symbols_v2(levels_zz: jnp.ndarray, dc_pred: jnp.ndarray):
    """v2 per-block symbols [..., 129] (SPEC.md §12.4-12.5): cbf,
    se(dc − dc_pred), ue(nnz_ac), then (run, level) for nonzero AC at
    zigzag positions 1..63 (runs counted from position 1)."""
    dc = levels_zz[..., 0]
    ac = levels_zz[..., 1:]
    nz_ac = ac != 0
    nnz_ac = nz_ac.sum(axis=-1).astype(jnp.int32)
    cbf = (dc != 0) | (nnz_ac > 0)

    idx = jnp.arange(63, dtype=jnp.int32)
    masked_idx = jnp.where(nz_ac, idx, -1)
    cm = jax.lax.cummax(masked_idx, axis=masked_idx.ndim - 1)
    prev_nz = jnp.concatenate(
        [jnp.full((*cm.shape[:-1], 1), -1, jnp.int32), cm[..., :-1]], axis=-1
    )
    run = idx - prev_nz - 1

    run_val, run_len = ue_code(jnp.where(nz_ac, run, 0))
    lev_val, lev_len = se_code(ac)
    run_len = jnp.where(nz_ac, run_len, 0)
    lev_len = jnp.where(nz_ac, lev_len, 0)

    cbf_val = cbf.astype(jnp.uint32)
    cbf_len = jnp.ones_like(nnz_ac)
    dcd_val, dcd_len = se_code(dc - dc_pred)
    dcd_len = jnp.where(cbf, dcd_len, 0)
    nnz_val, nnz_len = ue_code(nnz_ac)
    nnz_len = jnp.where(cbf, nnz_len, 0)

    pair_val = jnp.stack([run_val, lev_val], axis=-1).reshape(*nnz_ac.shape, 126)
    pair_len = jnp.stack([run_len, lev_len], axis=-1).reshape(*nnz_ac.shape, 126)
    values = jnp.concatenate(
        [cbf_val[..., None], dcd_val[..., None], nnz_val[..., None], pair_val], -1
    )
    lengths = jnp.concatenate(
        [cbf_len[..., None], dcd_len[..., None], nnz_len[..., None], pair_len], -1
    )
    values = jnp.where(lengths > 0, values.astype(jnp.uint32), 0)
    return values, lengths.astype(jnp.int32)


def _dc_pred_left(levels: jnp.ndarray) -> jnp.ndarray:
    """Left-block DC predictor on a [..., by, bx, 64] plane level array:
    pred(by, bx) = dc level of (by, bx−1), 0 at bx = 0 (SPEC.md §12.4)."""
    dc = levels[..., 0]
    return jnp.pad(dc[..., :, :-1], ((0, 0), (1, 0)))


def _pack_blocks(levels, dc_pred, fmt: int, block_words: int):
    """Per-block pack of a [..., 64] zigzag level array: returns
    ([..., W] word strings, [...] bit counts, overflow flag)."""
    if fmt >= 2:
        v, l = block_symbols_v2(levels, dc_pred)
    else:
        v, l = block_symbols(levels)
    w, b, _ = pack_dense(v, l, block_words)
    return w, b, (b > 32 * block_words).any()


def _keep_mbs(piece_words, piece_bits, mb_valid):
    """Empty the [n_mbs, 8] pieces of every MB outside mb_valid ([nby, nbx]
    bool; None keeps all): the MB rows that only pad a tile shard then add
    no bits to the concatenation."""
    if mb_valid is None:
        return piece_words, piece_bits
    m = mb_valid.reshape(-1, 1)
    return jnp.where(m[..., None], piece_words, 0), jnp.where(m, piece_bits, 0)


def _frame_pieces_v2(
    levels_y8, levels_cb, levels_cr, qp_delta, is_p_frame, is_inter,
    dy, dx, block_words, mb_valid=None,
):
    """v2 twin of _frame_pieces: per-MB [8, W] word strings + bit counts
    (header, Y00, Y01, Y10, Y11, Cb, Cr, empty)."""
    nby, nbx = qp_delta.shape
    n_mbs = nby * nbx

    hv, hl = _header_slots_v2(qp_delta, is_p_frame, is_inter, dy, dx)
    hwords, hbits, ovf_h = pack_header(hv, hl)
    hwords = hwords.reshape(n_mbs, HEADER_WORDS)
    hbits = hbits.reshape(n_mbs)

    ywords, ybits, ovf_y = _pack_blocks(
        levels_y8, _dc_pred_left(levels_y8), 2, block_words
    )
    ywords = ywords.reshape(nby, 2, nbx, 2, block_words).transpose(0, 2, 1, 3, 4)
    ywords = ywords.reshape(n_mbs, 4, block_words)
    ybits = ybits.reshape(nby, 2, nbx, 2).transpose(0, 2, 1, 3).reshape(n_mbs, 4)

    cbwords, cbbits, ovf_cb = _pack_blocks(
        levels_cb, _dc_pred_left(levels_cb), 2, block_words
    )
    crwords, crbits, ovf_cr = _pack_blocks(
        levels_cr, _dc_pred_left(levels_cr), 2, block_words
    )

    hpad = jnp.pad(hwords, ((0, 0), (0, block_words - HEADER_WORDS)))
    piece_words = jnp.concatenate(
        [
            hpad[:, None],
            ywords,
            cbwords.reshape(n_mbs, 1, block_words),
            crwords.reshape(n_mbs, 1, block_words),
            jnp.zeros((n_mbs, 1, block_words), jnp.uint32),
        ],
        axis=1,
    )
    piece_bits = jnp.concatenate(
        [
            hbits[:, None],
            ybits,
            cbbits.reshape(n_mbs, 1),
            crbits.reshape(n_mbs, 1),
            jnp.zeros((n_mbs, 1), jnp.int32),
        ],
        axis=1,
    )
    piece_words, piece_bits = _keep_mbs(piece_words, piece_bits, mb_valid)
    mb_bits = piece_bits[:, :7].sum(axis=1)
    return piece_words, piece_bits, mb_bits, ovf_h | ovf_y | ovf_cb | ovf_cr


def pack_frame_planes_v2(
    levels_y8: jnp.ndarray,
    levels_cb: jnp.ndarray,
    levels_cr: jnp.ndarray,
    qp_delta: jnp.ndarray,
    is_p_frame,
    is_inter: jnp.ndarray,
    dy: jnp.ndarray,
    dx: jnp.ndarray,
    block_words: int,
    n_words: int,
    mb_valid=None,
):
    """pack_frame_planes for format v2 (SPEC.md §12). Bit-exact with the
    golden v2 sequential writer (tests/test_format_v2.py)."""
    nby, nbx = qp_delta.shape
    n_mbs = nby * nbx
    piece_words, piece_bits, mb_bits, ovf = _frame_pieces_v2(
        levels_y8, levels_cb, levels_cr, qp_delta, is_p_frame, is_inter,
        dy, dx, block_words, mb_valid,
    )
    words, total_bits = tree_concat(
        piece_words.reshape(n_mbs * 8, block_words),
        piece_bits.reshape(n_mbs * 8),
        n_words,
    )
    ovf_f = total_bits > 32 * n_words
    return words, total_bits, mb_bits.reshape(nby, nbx), ovf | ovf_f


def _frame_pieces(
    levels_y8, levels_cb, levels_cr, qp_delta, is_p_frame, is_inter,
    dy, dx, block_words, mb_valid=None,
):
    """Shared v1 piece construction: per-MB [8, W] word strings + bit counts
    in the piece order header, Y00, Y01, Y10, Y11, Cb, Cr, (empty)."""
    nby, nbx = qp_delta.shape
    n_mbs = nby * nbx

    hv, hl = _header_slots(qp_delta, is_p_frame, is_inter, dy, dx)
    hwords, hbits, ovf_h = pack_header(hv, hl)
    hwords = hwords.reshape(n_mbs, HEADER_WORDS)
    hbits = hbits.reshape(n_mbs)

    ywords, ybits, ovf_y = _pack_blocks(levels_y8, None, 1, block_words)
    # [2nby, 2nbx, W] -> [n_mbs, 4, W] in (Y00, Y01, Y10, Y11) piece order
    ywords = ywords.reshape(nby, 2, nbx, 2, block_words).transpose(0, 2, 1, 3, 4)
    ywords = ywords.reshape(n_mbs, 4, block_words)
    ybits = ybits.reshape(nby, 2, nbx, 2).transpose(0, 2, 1, 3).reshape(n_mbs, 4)

    cbwords, cbbits, ovf_cb = _pack_blocks(levels_cb, None, 1, block_words)
    crwords, crbits, ovf_cr = _pack_blocks(levels_cr, None, 1, block_words)

    hpad = jnp.pad(hwords, ((0, 0), (0, block_words - HEADER_WORDS)))
    piece_words = jnp.concatenate(
        [
            hpad[:, None],
            ywords,
            cbwords.reshape(n_mbs, 1, block_words),
            crwords.reshape(n_mbs, 1, block_words),
            jnp.zeros((n_mbs, 1, block_words), jnp.uint32),
        ],
        axis=1,
    )  # [n_mbs, 8, W]
    piece_bits = jnp.concatenate(
        [
            hbits[:, None],
            ybits,
            cbbits.reshape(n_mbs, 1),
            crbits.reshape(n_mbs, 1),
            jnp.zeros((n_mbs, 1), jnp.int32),
        ],
        axis=1,
    )
    piece_words, piece_bits = _keep_mbs(piece_words, piece_bits, mb_valid)
    mb_bits = piece_bits[:, :7].sum(axis=1)
    return piece_words, piece_bits, mb_bits, ovf_h | ovf_y | ovf_cb | ovf_cr


def pack_frame_planes(
    levels_y8: jnp.ndarray,  # [2*nby, 2*nbx, 64] luma 8x8-block levels
    levels_cb: jnp.ndarray,  # [nby, nbx, 64]
    levels_cr: jnp.ndarray,  # [nby, nbx, 64]
    qp_delta: jnp.ndarray,
    is_p_frame,
    is_inter: jnp.ndarray,
    dy: jnp.ndarray,
    dx: jnp.ndarray,
    block_words: int,
    n_words: int,
    mb_valid=None,
):
    """pack_frame_blocked on per-plane level arrays (no blocks6 interleave).

    Reordering the packed per-block WORD buffers instead of interleaving
    residual PIXELS into the [nby, nbx, 6, 8, 8] layout touches 60x less
    data. Bit-exact with
    pack_frame_blocked (tests/test_entropy.py): the piece order per MB stays
    header, Y(2by,2bx), Y(2by,2bx+1), Y(2by+1,2bx), Y(2by+1,2bx+1), Cb, Cr.
    """
    nby, nbx = qp_delta.shape
    n_mbs = nby * nbx
    piece_words, piece_bits, mb_bits, ovf = _frame_pieces(
        levels_y8, levels_cb, levels_cr, qp_delta, is_p_frame, is_inter,
        dy, dx, block_words, mb_valid,
    )
    words, total_bits = tree_concat(
        piece_words.reshape(n_mbs * 8, block_words),
        piece_bits.reshape(n_mbs * 8),
        n_words,
    )
    ovf_f = total_bits > 32 * n_words
    return words, total_bits, mb_bits.reshape(nby, nbx), ovf | ovf_f


def pack_frame_rows(
    levels_y8: jnp.ndarray,
    levels_cb: jnp.ndarray,
    levels_cr: jnp.ndarray,
    qp_delta: jnp.ndarray,
    is_p_frame,
    is_inter: jnp.ndarray,
    dy: jnp.ndarray,
    dx: jnp.ndarray,
    block_words: int,
    row_words: int,
):
    """v1 pack emitting one bit string PER MB ROW: (row_strings
    [nby, row_words], row_bits [nby], mb_bits, ovf).

    The frame payload is the in-order bit-concatenation of the row strings;
    2-D (row x column) tile sharding needs this granularity because a
    frame's MB raster order interleaves the column shards within each row
    (parallel/tiles.encode_gop_tiled2d glues rows across 'tc' shards)."""
    nby, nbx = qp_delta.shape
    piece_words, piece_bits, mb_bits, ovf = _frame_pieces(
        levels_y8, levels_cb, levels_cr, qp_delta, is_p_frame, is_inter,
        dy, dx, block_words,
    )
    words, row_bits = jax.vmap(
        lambda pw, pb: tree_concat(pw, pb, row_words)
    )(
        piece_words.reshape(nby, nbx * 8, block_words),
        piece_bits.reshape(nby, nbx * 8),
    )
    ovf_f = (row_bits > 32 * row_words).any()
    return words, row_bits, mb_bits.reshape(nby, nbx), ovf | ovf_f


# ---------------------------------------------------------------------------
# Chunk-emitting packs — the production path for GOP-resident encode.
#
# The device merges pieces only up to fixed-size SPAN strings (a tree_concat
# per span), and the HOST mux bit-concatenates the span strings of a frame
# (SURVEY.md §7.0 "host does bytes") — the same shift-or glue the
# tile-sharded path uses. Concatenation is associative, so the bytes equal
# one whole-frame tree_concat. Span capacity is the exact worst case, so
# frame-level capacity overflow cannot occur.
# ---------------------------------------------------------------------------


def _stage1_k(w: int) -> int:
    """Pieces per first-stage merge group: <= 1024 AND <= 32768 words of
    input (span_geometry derives the span shape from it)."""
    k = 1024
    while k > 16 and k * w > 32768:
        k //= 2
    return k


def span_geometry(n_pieces: int, w: int):
    """(padded_n, pieces_per_string, words_per_string, n_strings) for the
    span merge of n_pieces piece strings of w words each. The span
    boundaries decide the chunk strings the host glues.

    IDEMPOTENT on its own padded_n (span_geometry(padded_n, w) returns the
    same tuple), so a caller that pads first and re-derives the geometry
    gets the same spans."""
    k1 = _stage1_k(w)
    if n_pieces > 3 * k1:
        f = 4 * k1
        n2 = -(-n_pieces // f) * f
        cw1 = (k1 // 8) * w + 1
        h = k1 // 2
        return n2, h, 4 * cw1 + 1, n2 // h
    k = 16
    while k * 2 <= n_pieces and k < k1:
        k *= 2
    n2 = -(-n_pieces // k) * k
    if n2 > n_pieces:
        return span_geometry(n2, w)  # geometry OF the padded count
    h = k // 8
    return n2, h, h * w + 1, (n2 // k) * 8


def _pieces_to_chunks(piece_words: jnp.ndarray, piece_bits: jnp.ndarray):
    """[n, W] piece strings -> ([C, cw] chunk strings, [C] chunk bits): one
    tree_concat per span of span_geometry, zero-length pieces padding the
    tail."""
    n, w = piece_words.shape
    n2, h, cw, n_strings = span_geometry(n, w)
    if n2 != n:
        piece_words = jnp.pad(piece_words, ((0, n2 - n), (0, 0)))
        piece_bits = jnp.pad(piece_bits, (0, n2 - n))
    return jax.vmap(
        lambda b, l: tree_concat(b, l, cw)
    )(piece_words.reshape(n_strings, h, w), piece_bits.reshape(n_strings, h))


def pack_frame_chunks(
    levels_y8, levels_cb, levels_cr, qp_delta, is_p_frame, is_inter,
    dy, dx, block_words: int, mb_valid=None,
):
    """v1 pack emitting chunk strings: (chunk_words [C, cw], chunk_bits [C],
    mb_bits [nby, nbx], ovf). The frame payload is the host bit-concat of
    the chunk strings in order (bit-exact with pack_frame_planes'
    device-assembled stream)."""
    nby, nbx = qp_delta.shape
    with jax.named_scope("block_pack"):
        piece_words, piece_bits, mb_bits, ovf = _frame_pieces(
            levels_y8, levels_cb, levels_cr, qp_delta, is_p_frame, is_inter,
            dy, dx, block_words, mb_valid,
        )
    with jax.named_scope("chunk_merge"):
        cwords, cbits = _pieces_to_chunks(
            piece_words.reshape(-1, block_words), piece_bits.reshape(-1)
        )
    return cwords, cbits, mb_bits.reshape(nby, nbx), ovf


def pack_frame_chunks_v2(
    levels_y8, levels_cb, levels_cr, qp_delta, is_p_frame, is_inter,
    dy, dx, block_words: int, mb_valid=None,
):
    """v2/v3-syntax twin of pack_frame_chunks."""
    nby, nbx = qp_delta.shape
    with jax.named_scope("block_pack"):
        piece_words, piece_bits, mb_bits, ovf = _frame_pieces_v2(
            levels_y8, levels_cb, levels_cr, qp_delta, is_p_frame, is_inter,
            dy, dx, block_words, mb_valid,
        )
    with jax.named_scope("chunk_merge"):
        cwords, cbits = _pieces_to_chunks(
            piece_words.reshape(-1, block_words), piece_bits.reshape(-1)
        )
    return cwords, cbits, mb_bits.reshape(nby, nbx), ovf


def _shift_words_right(x: jnp.ndarray, k: int) -> jnp.ndarray:
    """Static word shift along the last axis: out[..., i] = x[..., i-k]."""
    if k == 0:
        return x
    return jnp.pad(x, [(0, 0)] * (x.ndim - 1) + [(k, 0)])[..., : x.shape[-1]]


def _carry_shift(x: jnp.ndarray, s: jnp.ndarray) -> jnp.ndarray:
    """Bit-shift each row's MSB-first word string right by s ∈ [0,32) bits
    (one spill word appended): out[k] = (x[k] >> s) | (x[k-1] << (32-s))."""
    n, w = x.shape
    s = s.astype(jnp.uint32)[:, None]
    ext = jnp.concatenate([x, jnp.zeros((n, 1), jnp.uint32)], axis=1)
    prev = jnp.concatenate([jnp.zeros((n, 1), jnp.uint32), x], axis=1)
    return jnp.where(s > 0, (ext >> s) | (prev << (32 - s)), ext)


def tree_concat(buffers: jnp.ndarray, bits: jnp.ndarray, n_words: int):
    """Concatenate n MSB-first bit strings into one, as a binary reduction.

    buffers [n, W] uint32 word strings, bits [n] their lengths. At each
    level, pairs (A, B) merge: B is bit-shifted by len(A) % 32 (vector
    carry op) and word-placed at len(A) // 32 via *binary-decomposed static
    shifts* (log(W) select passes) — no scatter, no gather anywhere.
    Widths double per level until capped at n_words; no intermediate
    capacity parameter exists, so only the final cap can overflow.

    Returns (words [n_words], total_bits).
    """
    n, w = buffers.shape
    # pad the string count to a power of two with empty strings
    n2 = 1 << max(1, (n - 1).bit_length())
    if n2 != n:
        buffers = jnp.pad(buffers, ((0, n2 - n), (0, 0)))
        bits = jnp.pad(bits, (0, n2 - n))
    n = n2

    while n > 1:
        a = buffers[0::2]
        b = buffers[1::2]
        bits_a = bits[0::2]
        bits_b = bits[1::2]
        w_out = min(2 * w + 1, n_words)

        bs = _carry_shift(b, bits_a & 31)          # [n/2, w+1]
        if bs.shape[1] < w_out:
            bs = jnp.pad(bs, ((0, 0), (0, w_out - bs.shape[1])))
        else:
            bs = bs[:, :w_out]
        base = (bits_a >> 5).astype(jnp.int32)
        kbit = 0
        while (1 << kbit) < w_out:
            hit = (base & (1 << kbit)) != 0
            bs = jnp.where(hit[:, None], _shift_words_right(bs, 1 << kbit), bs)
            kbit += 1

        a_pad = jnp.pad(a, ((0, 0), (0, w_out - w))) if w < w_out else a[:, :w_out]
        buffers = a_pad | bs
        bits = bits_a + bits_b
        w = w_out
        n //= 2

    out = buffers[0]
    if out.shape[0] < n_words:
        out = jnp.pad(out, (0, n_words - out.shape[0]))
    return out[:n_words], bits[0]


BLOCK_WORDS_DEFAULT = 24  # 768 bits per 8x8 block budget
BLOCK_WORDS_MAX = (1 + 13 + 64 * (13 + 25) + 31) // 32 + 1  # exact worst case


def capacity_words(n_mbs: int, bits_per_mb: int = 1024) -> int:
    """Default payload capacity: generous vs typical (~100-400 bits/MB) but
    ~14× smaller than the worst case; overflow triggers the exact fallback."""
    return (n_mbs * bits_per_mb + 31) // 32 + 2


def max_words(n_mbs: int) -> int:
    """Static worst-case word count for a frame of n_mbs macroblocks."""
    return (n_mbs * MAX_MB_BITS + 31) // 32 + 1


def mb_bit_counts(lengths: jnp.ndarray) -> jnp.ndarray:
    """Per-MB bit totals [nby, nbx] from the [nby, nbx, S] length array."""
    return lengths.sum(axis=-1)
