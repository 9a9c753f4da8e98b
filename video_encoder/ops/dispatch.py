"""The device encoder's hot operations, in plain jax.numpy / lax.

One implementation per operation, compiled by XLA for whatever backend JAX
runs on; each is bit-exact with the golden model (SPEC.md), so the same code
produces the identical bitstream on the CPU and on the accelerator.
"""

from __future__ import annotations

import jax.numpy as jnp

from ..codec import spec
from . import motion
from . import transform as tx


def sad_at_mv(cur_y, ref_y, dy, dx):
    refpad = motion.pad_ref(ref_y, 16)
    return motion.sad_at(motion.blockify(cur_y, 16), refpad, dy, dx)


def mc_fetch_luma_plane(ref_y, dy, dx):
    """[H, W] luma predictor plane from per-MB mvs."""
    refpad = motion.pad_ref(ref_y, 16)
    return tx.unblockify(motion.mc_fetch(refpad, dy, dx, 16, 16))


def mc_fetch_chroma_plane(ref_c, cdy, cdx):
    """[H/2, W/2] chroma predictor plane from per-MB chroma mvs."""
    refpad = motion.pad_ref(ref_c, 8)
    return tx.unblockify(motion.mc_fetch(refpad, cdy, cdx, 8, 8))


def code_plane(cur, pred, q_blk, qbias: int = 8, qmat: bool = False):
    """Transform→quant→zigzag→recon of one plane (C9–C11, C14).

    Returns (levels zigzagged [nby, nbx, 64], recon [H, W]). qmat applies
    the v3 per-position quant matrix (SPEC.md §13.2)."""
    resid = tx.blockify(cur - pred, 8)
    q = tx.qsteps_pos(q_blk, qmat)
    coefs = tx.forward_transform(resid)
    lz = tx.zigzag(tx.quantize(coefs, q, qbias))
    deq = tx.dequantize(tx.unzigzag(lz), q)
    rec = jnp.clip(tx.unblockify(tx.inverse_transform(deq)) + pred, 0, 255)
    return lz, rec


def hpel_refine(cur_y, ref_y, dy, dx):
    """SPEC.md §14.4 half-pel refinement (format v4): evaluate the nine
    (2dy+u, 2dx+v) candidates row-major with first-minimum tie-break.

    Candidate (u, v) has fixed parity (|u|, |v|), so each evaluation is an
    INTEGER-mv SAD against the matching §14.2 parity plane; only the three
    parity planes are new (cheap elementwise averages). Bit-exact with
    golden.sad_hpel_refine."""
    hh, vv, dd = motion.hpel_planes(ref_y)
    planes = {(0, 0): ref_y, (0, 1): hh, (1, 0): vv, (1, 1): dd}
    r, r2 = spec.SEARCH_R, 2 * spec.SEARCH_R
    costs, cdy, cdx = [], [], []
    for u in (-1, 0, 1):
        for v in (-1, 0, 1):
            d2y, d2x = 2 * dy + u, 2 * dx + v
            valid = (jnp.abs(d2y) <= r2) & (jnp.abs(d2x) <= r2)
            iy = jnp.clip(d2y >> 1, -r, r)
            ix = jnp.clip(d2x >> 1, -r, r)
            c = sad_at_mv(cur_y, planes[(abs(u), abs(v))], iy, ix)
            costs.append(jnp.where(valid, c, motion.BIG))
            cdy.append(d2y)
            cdx.append(d2x)
    cc = jnp.stack(costs)
    widx = jnp.argmin(cc, axis=0)  # first occurrence == (u, v) row-major
    d2y = jnp.take_along_axis(jnp.stack(cdy), widx[None], 0)[0]
    d2x = jnp.take_along_axis(jnp.stack(cdx), widx[None], 0)[0]
    sad = jnp.take_along_axis(cc, widx[None], 0)[0]
    return d2y, d2x, sad


def _hpel_mc(plane, d2y, d2x, fetch, px: int):
    """Shared §14.2 half-pel MC: integer fetch from each parity plane,
    per-MB (fy, fx) select expanded to pixel resolution."""
    hh, vv, dd = motion.hpel_planes(plane)
    iy, ix = d2y >> 1, d2x >> 1
    sel = (d2y & 1) * 2 + (d2x & 1)
    sel_px = jnp.repeat(jnp.repeat(sel, px, 0), px, 1)
    f0 = fetch(plane, iy, ix)
    f1 = fetch(hh, iy, ix)
    f2 = fetch(vv, iy, ix)
    f3 = fetch(dd, iy, ix)
    return jnp.where(
        sel_px == 0, f0,
        jnp.where(sel_px == 1, f1, jnp.where(sel_px == 2, f2, f3)),
    )


def mc_fetch_luma_plane_hpel(ref_y, d2y, d2x):
    """[H, W] luma predictor plane from per-MB half-pel mvs (SPEC.md §14)."""
    return _hpel_mc(ref_y, d2y, d2x, mc_fetch_luma_plane, spec.MB)


def mc_fetch_chroma_plane_hpel(ref_c, cd2y, cd2x):
    """[H/2, W/2] chroma predictor plane from per-MB chroma half-pel mvs."""
    return _hpel_mc(ref_c, cd2y, cd2x, mc_fetch_chroma_plane, spec.BLK)
