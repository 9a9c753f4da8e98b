"""Device (jnp) integer transform + quantization (SPEC.md §3–4; reference
components C9/C10, SURVEY.md §2).

All int32, bit-exact with codec/spec.py numpy primitives — XLA integer
semantics are exact, so CPU and accelerator equality holds by construction.
Batched over the whole macroblock grid (SURVEY.md §7.0: "Batch over
macroblocks, not loops over them").
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from ..codec import spec

B = np.asarray(spec.B_MATRIX, dtype=np.int32)
QSTEP = np.asarray(spec.QSTEP, dtype=np.int32)


def qstep(qp: jnp.ndarray) -> jnp.ndarray:
    """QSTEP table lookup, traced-index safe (constant embedded at trace time)."""
    return jnp.asarray(QSTEP)[qp]


def rshift_round(v: jnp.ndarray, s: int) -> jnp.ndarray:
    mag = (jnp.abs(v) + (1 << (s - 1))) >> s
    return jnp.where(v < 0, -mag, mag)


def forward_transform(x: jnp.ndarray) -> jnp.ndarray:
    """ITX8 forward transform of int32 blocks [..., 8, 8]."""
    t1 = jnp.einsum("ij,...jk->...ik", B, x, preferred_element_type=jnp.int32)
    t1r = rshift_round(t1, spec.TX_SHIFT)
    t2 = jnp.einsum("...ij,kj->...ik", t1r, B, preferred_element_type=jnp.int32)
    return rshift_round(t2, spec.TX_SHIFT)


def inverse_transform(c: jnp.ndarray) -> jnp.ndarray:
    """ITX8 inverse transform of int32 coefficient blocks [..., 8, 8]."""
    u1 = jnp.einsum("ji,...jk->...ik", B, c, preferred_element_type=jnp.int32)
    u1r = rshift_round(u1, spec.TX_SHIFT)
    u2 = jnp.einsum("...ij,jk->...ik", u1r, B, preferred_element_type=jnp.int32)
    return rshift_round(u2, spec.TX_SHIFT)


def quantize(c: jnp.ndarray, q: jnp.ndarray, bias16_ac: int = 8) -> jnp.ndarray:
    """level = sign(C) * ((16|C| + bias*q) // (16q)) on [..., 8, 8] blocks;
    bias = 8 (midpoint) at the DC position, bias16_ac for ACs — bit-exact
    with codec/spec.py quantize. 16|C| ≤ 65520 and 16q ≤ 23168: int32 safe."""
    if bias16_ac == 8:
        mag = (2 * jnp.abs(c) + q) // (2 * q)
        return jnp.where(c < 0, -mag, mag)
    bias = np.full((8, 8), int(bias16_ac), dtype=np.int32)
    bias[0, 0] = 8
    mag = (16 * jnp.abs(c) + bias * q) // (16 * q)
    return jnp.where(c < 0, -mag, mag)


def dequantize(level: jnp.ndarray, q: jnp.ndarray) -> jnp.ndarray:
    return level * q


def blockify(plane: jnp.ndarray, n: int) -> jnp.ndarray:
    h, w = plane.shape
    return plane.reshape(h // n, n, w // n, n).transpose(0, 2, 1, 3)


def unblockify(blocks: jnp.ndarray) -> jnp.ndarray:
    by, bx, n, _ = blocks.shape
    return blocks.transpose(0, 2, 1, 3).reshape(by * n, bx * n)


# Zigzag as a gather; UNZIGZAG scatter for the decoder side. Numpy consts on
# purpose (see B above).
ZIGZAG = np.asarray(spec.ZIGZAG)
UNZIGZAG = np.asarray(spec.UNZIGZAG)


def zigzag(levels_8x8: jnp.ndarray) -> jnp.ndarray:
    """[..., 8, 8] -> [..., 64] in zigzag scan order (C11)."""
    flat = levels_8x8.reshape(*levels_8x8.shape[:-2], 64)
    return flat[..., ZIGZAG]


def unzigzag(levels_zz: jnp.ndarray) -> jnp.ndarray:
    """[..., 64] zigzag order -> [..., 8, 8] raster blocks."""
    flat = levels_zz[..., UNZIGZAG]
    return flat.reshape(*levels_zz.shape[:-1], 8, 8)


# ---------------------------------------------------------------------------
# Format v3 (SPEC.md §13): quant matrix + I-frame vertical intra prediction
# ---------------------------------------------------------------------------

QMAT = np.asarray(spec.QMAT, dtype=np.int32)  # numpy const on purpose (see B)


def qsteps_pos(q: jnp.ndarray, use_matrix: bool) -> jnp.ndarray:
    """jnp twin of spec.qsteps_pos: per-position steps [..., 8, 8] (§13.2),
    or the flat [..., 1, 1] broadcast when the matrix is off."""
    if not use_matrix:
        return q[..., None, None]
    return jnp.maximum(1, (q[..., None, None] * QMAT + 8) >> 4)


def intra_rows_code_plane(cur: jnp.ndarray, qsteps: jnp.ndarray, qbias: int,
                          reset_rows: int = 0):
    """jnp twin of spec.intra_rows_code_plane (§13.1): v3 I-frame vertical
    intra coding of one plane as a lax.scan over its h/8 block rows.

    cur: [h, w] int32; qsteps: [h/8, w/8, 1, 1] or [h/8, w/8, 8, 8].
    Returns (levels [h/8, w/8, 8, 8], recon [h, w]) — bit-exact with the
    numpy reference; the sequential row chain is the format's only serial
    dependency and runs entirely on device. reset_rows (static) > 0: §13.3
    intra-slice predictor reset every reset_rows block rows, making slices
    independent (the tile-sharding enabler).
    """
    import jax

    h, w = cur.shape
    stripes = cur.reshape(h // 8, 8, w)

    def body(prev, args):
        stripe, qj, j = args
        if reset_rows:
            prev = jnp.where(j % reset_rows == 0,
                             jnp.full_like(prev, 128), prev)
        pred = jnp.broadcast_to(prev[None, :], (8, w))
        resid = blockify(stripe - pred, 8)[0]        # [w/8, 8, 8]
        lv = quantize(forward_transform(resid), qj, qbias)
        rec = unblockify(inverse_transform(dequantize(lv, qj))[None]) + pred
        rec = jnp.clip(rec, 0, 255)
        return rec[-1], (lv, rec)

    init = jnp.full((w,), 128, jnp.int32)
    _, (levels, rec) = jax.lax.scan(
        body, init, (stripes, qsteps, jnp.arange(h // 8, dtype=jnp.int32))
    )
    return levels, rec.reshape(h, w)


def intra_rows_recon_plane(levels: jnp.ndarray, qsteps: jnp.ndarray,
                           reset_rows: int = 0):
    """jnp twin of spec.intra_rows_recon_plane (§13.1 decoder side).

    levels: [h/8, w/8, 8, 8]; returns recon [h, w]. reset_rows (static):
    §13.3 intra-slice predictor reset."""
    import jax

    nrows, ncols = levels.shape[:2]
    w = ncols * 8

    def body(prev, args):
        lvj, qj, j = args
        if reset_rows:
            prev = jnp.where(j % reset_rows == 0,
                             jnp.full_like(prev, 128), prev)
        pred = jnp.broadcast_to(prev[None, :], (8, w))
        rec = unblockify(inverse_transform(dequantize(lvj, qj))[None]) + pred
        rec = jnp.clip(rec, 0, 255)
        return rec[-1], rec

    init = jnp.full((w,), 128, jnp.int32)
    _, rec = jax.lax.scan(
        body, init, (levels, qsteps, jnp.arange(nrows, dtype=jnp.int32))
    )
    return rec.reshape(nrows * 8, w)
