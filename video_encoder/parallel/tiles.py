"""Tile-parallel (spatially sharded) encode with halo exchange
(BASELINE.json config 5; SURVEY.md §2.1 TP/SP rows).

One frame's MB grid is sharded along MB rows over the 'tile' mesh axis.
Motion search reads reference pixels up to ±16 px past the shard edge, so
each step exchanges 16-row boundary strips of the *reconstruction* with
mesh neighbors via `ppermute` (the halo), or optionally `all_gather`s the
whole reference frame (the Ulysses-shaped variant, [B:5]); boundary shards
edge-replicate instead, which keeps the sharded encode bit-identical to the
unsharded one (tile-seam invariant, SURVEY.md §4.5).

Because the TVC1 MB syntax has no cross-MB prediction chains (SPEC.md §7:
qp_delta codes against the frame base, raw mvs), a frame's payload is the
plain bit-concatenation of the per-shard payloads in tile order — the host
mux glues shards with a word-shift, no re-encoding.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax import shard_map
from jax.sharding import PartitionSpec as P

from ..codec import entropy, spec
from ..ops import motion, transform as tx
from ..pipeline.gop_engine import _code_frame, rc_carry_step

HALO_Y = spec.SEARCH_R  # 16 luma halo rows
HALO_C = spec.BLK       # 8 chroma halo rows


def shard_mb_rows(mb_rows: int, ntile: int) -> int:
    """MB rows per tile shard: the frame's rows split into ntile equal
    shards, the last one padded. Every shard must hold a frame row, because
    a shard extends the frame's bottom edge from its own rows."""
    per = -(-mb_rows // ntile)
    if per * (ntile - 1) >= mb_rows:
        raise ValueError(f"{mb_rows} MB rows cannot fill {ntile} row shards")
    return per


def _pad_to_shards(y, cb, cr, ntile: int):
    """Edge-pad the frame rows (axis -2) to ntile equal shards of whole MB
    rows. Returns the planes and the frame's MB rows, or None for the
    latter when the rows split evenly and nothing was padded."""
    mb_rows = y.shape[-2] // spec.MB
    per = shard_mb_rows(mb_rows, ntile)
    if per * ntile == mb_rows:
        return y, cb, cr, None

    def pad(p, rows):
        widths = [(0, 0)] * p.ndim
        widths[-2] = (0, rows - p.shape[-2])
        return jnp.pad(p, widths, mode="edge")

    n = per * ntile
    return (pad(y, n * spec.MB), pad(cb, n * spec.BLK), pad(cr, n * spec.BLK),
            mb_rows)


def _edge_rows(plane, n):
    """Rows n and on repeat row n-1: the frame's bottom edge carried over
    the rows that pad the last shard, as pad_ref extends it past the
    frame."""
    last = jax.lax.dynamic_slice_in_dim(plane, n - 1, 1, 0)
    return jnp.where(jnp.arange(plane.shape[0])[:, None] < n, plane, last)


def exchange_halo(plane, halo, axis_name, axis: int = 0):
    """[h, w] shard -> extended by 2*halo along `axis` with neighbor strips
    via ppermute.

    Boundary shards edge-replicate their own first/last rows, matching the
    unsharded pad_ref semantics exactly.
    """
    if axis == 1:
        return exchange_halo(plane.T, halo, axis_name).T
    n = jax.lax.axis_size(axis_name)
    idx = jax.lax.axis_index(axis_name)
    top_own = jnp.repeat(plane[:1], halo, axis=0)
    bot_own = jnp.repeat(plane[-1:], halo, axis=0)
    if n == 1:
        return jnp.concatenate([top_own, plane, bot_own], axis=0)
    # my bottom rows -> next shard's top halo; my top rows -> prev's bottom
    from_prev = jax.lax.ppermute(
        plane[-halo:], axis_name, [(i, (i + 1) % n) for i in range(n)]
    )
    from_next = jax.lax.ppermute(
        plane[:halo], axis_name, [(i, (i - 1) % n) for i in range(n)]
    )
    top = jnp.where(idx == 0, top_own, from_prev)
    bot = jnp.where(idx == n - 1, bot_own, from_next)
    return jnp.concatenate([top, plane, bot], axis=0)


def exchange_halo_2d(plane, halo, ar: str, ac: str):
    """[h, w] shard -> [h+2*halo, w+2*halo]: row halo along mesh axis `ar`,
    then column halo along `ac` ON THE ROW-EXTENDED plane, so the four
    corner patches arrive from the diagonal neighbors (two-hop corner
    exchange — SURVEY.md §2.1 TP row "2D-mesh neighbors")."""
    p = exchange_halo(plane, halo, ar, axis=0)
    return exchange_halo(p, halo, ac, axis=1)


def gather_ref(plane, halo, axis_name):
    """all_gather variant: full frame to every shard, then local+halo slice."""
    n = jax.lax.axis_size(axis_name)
    idx = jax.lax.axis_index(axis_name)
    full = jax.lax.all_gather(plane, axis_name, tiled=True)  # [h*n, w]
    h = plane.shape[0]
    padded = jnp.concatenate(
        [jnp.repeat(full[:1], halo, 0), full, jnp.repeat(full[-1:], halo, 0)], 0
    )
    return jax.lax.dynamic_slice_in_dim(padded, idx * h, h + 2 * halo, 0)


def _full_search_haloed(cur, ref_ext):
    """Full search where ref_ext already carries the vertical halo rows.
    When ref_ext is wider than cur (2-D tiles) it also carries the
    horizontal halo; otherwise the columns edge-replicate like pad_ref."""
    if ref_ext.shape[1] == cur.shape[1]:
        ref_ext = jnp.pad(
            ref_ext, ((0, 0), (spec.SEARCH_R, spec.SEARCH_R)), mode="edge"
        )
    return motion.full_search_padded(cur, ref_ext)


def _mc_haloed(ref_ext, dy, dx, bs, r):
    """Per-MB MC on a pre-haloed reference (columns edge-replicate like
    pad_ref unless the 2-D tile halo already carries them)."""
    if ref_ext.shape[1] == dy.shape[1] * bs:
        refpad = jnp.pad(ref_ext, ((0, 0), (r, r)), mode="edge")
    else:
        refpad = ref_ext  # 2-D tiles: horizontal halo already present
    return tx.unblockify(motion.mc_fetch(refpad, dy, dx, bs, r))


# ---- format v4 half-pel under row sharding (SPEC.md §14) ----
#
# The unsharded semantics are parity-planes-THEN-edge-pad
# (motion.hpel_planes on the full frame, then pad_ref inside mc/sad —
# ops/dispatch.py hpel_refine/_hpel_mc). Exchanging a pixel halo and averaging the
# extended plane would break that at the global TOP edge: a replicated
# row pair averages to p[0], but the global parity row that pad_ref
# replicates is (p[0]+p[1]+1)>>1. (The bottom edge happens to agree
# because hpel_planes' +1 clamp already makes the last parity row p[-1].)
# So: one-row pixel halo -> boundary-correct LOCAL parity rows -> halo-
# exchange the PARITY planes themselves. Byte-equality vs the unsharded
# v4 encode is asserted in tests/test_parallel.py.


def _parity_ext(ref, halo, axis_name, ref_mode):
    """Halo-extended §14.2 parity planes (H, V, D) of a row shard, exactly
    equal to slices of pad_ref(hpel_planes(full_frame), halo)."""
    if ref_mode == "halo":
        p1 = exchange_halo(ref, 1, axis_name)  # ±1 pixel row for +1 reads
        hh, vv, dd = motion.hpel_planes(p1)
        return tuple(
            exchange_halo(q[1:-1], halo, axis_name) for q in (hh, vv, dd)
        )
    # gather variant: global parity planes, then the local+halo slice
    n = jax.lax.axis_size(axis_name)
    idx = jax.lax.axis_index(axis_name)
    full = jax.lax.all_gather(ref, axis_name, tiled=True)
    h = ref.shape[0]
    out = []
    for q in motion.hpel_planes(full):
        padded = jnp.concatenate(
            [jnp.repeat(q[:1], halo, 0), q, jnp.repeat(q[-1:], halo, 0)], 0
        )
        out.append(jax.lax.dynamic_slice_in_dim(padded, idx * h, h + 2 * halo, 0))
    return tuple(out)


def _sad_at_haloed(cur_blocks, ref_ext, iy, ix, r):
    """Per-MB SAD at per-MB integer mv against a vertically halo-extended
    plane (columns edge-replicate like pad_ref)."""
    refpad = jnp.pad(ref_ext, ((0, 0), (spec.SEARCH_R, spec.SEARCH_R)),
                     mode="edge")
    pred = motion.mc_fetch(refpad, iy, ix, spec.MB, r)
    return jnp.abs(cur_blocks - pred).sum(axis=(2, 3))


def _hpel_refine_haloed(cur_y, planes_ext, dy, dx):
    """SPEC.md §14.4 refinement on halo-extended parity planes — the same
    nine-candidate row-major first-min program as dispatch.hpel_refine."""
    cur_blocks = tx.blockify(cur_y, spec.MB)
    r, r2 = spec.SEARCH_R, 2 * spec.SEARCH_R
    costs, cands_y, cands_x = [], [], []
    for u in (-1, 0, 1):
        for v in (-1, 0, 1):
            d2y, d2x = 2 * dy + u, 2 * dx + v
            valid = (jnp.abs(d2y) <= r2) & (jnp.abs(d2x) <= r2)
            iy = jnp.clip(d2y >> 1, -r, r)
            ix = jnp.clip(d2x >> 1, -r, r)
            c = _sad_at_haloed(
                cur_blocks, planes_ext[(abs(u), abs(v))], iy, ix, HALO_Y
            )
            costs.append(jnp.where(valid, c, motion.BIG))
            cands_y.append(d2y)
            cands_x.append(d2x)
    cc = jnp.stack(costs)
    widx = jnp.argmin(cc, axis=0)  # first occurrence == (u, v) row-major
    d2y = jnp.take_along_axis(jnp.stack(cands_y), widx[None], 0)[0]
    d2x = jnp.take_along_axis(jnp.stack(cands_x), widx[None], 0)[0]
    sad = jnp.take_along_axis(cc, widx[None], 0)[0]
    return d2y, d2x, sad


def _hpel_mc_haloed(planes_ext, d2y, d2x, bs, r):
    """§14.2 half-pel MC from halo-extended parity planes (the sharded twin
    of dispatch._hpel_mc): integer fetch per parity plane, per-MB select."""
    iy, ix = d2y >> 1, d2x >> 1
    sel = (d2y & 1) * 2 + (d2x & 1)
    sel_px = jnp.repeat(jnp.repeat(sel, bs, 0), bs, 1)
    f = [_mc_haloed(planes_ext[k], iy, ix, bs, r)
         for k in ((0, 0), (0, 1), (1, 0), (1, 1))]
    return jnp.where(
        sel_px == 0, f[0],
        jnp.where(sel_px == 1, f[1], jnp.where(sel_px == 2, f[2], f[3])),
    )


def predict_p_tile_traced(cur_y, ref_y, ref_cb, ref_cr, icost,
                          *, axis_name: str, ref_mode: str, fmt: int):
    """P-frame prediction on a row shard: halo exchange + full search
    (+ v4 half-pel refine) + MC — the sharded twin of
    gop_engine.predict_p_traced."""
    fetch = exchange_halo if ref_mode == "halo" else gather_ref
    ref_y_ext = fetch(ref_y, HALO_Y, axis_name)
    ref_cb_ext = fetch(ref_cb, HALO_C, axis_name)
    ref_cr_ext = fetch(ref_cr, HALO_C, axis_name)
    dy, dx, best_sad = _full_search_haloed(cur_y, ref_y_ext)
    if fmt >= 4:
        # v4 (SPEC.md §14): refine to half-pel against halo-extended
        # parity planes; dy/dx are half-pel units from here on, exactly
        # like the unsharded predict_p_traced
        py = _parity_ext(ref_y, HALO_Y, axis_name, ref_mode)
        planes_y = {(0, 0): ref_y_ext, (0, 1): py[0],
                    (1, 0): py[1], (1, 1): py[2]}
        dy, dx, best_sad = _hpel_refine_haloed(cur_y, planes_y, dy, dx)
    is_inter = best_sad <= icost
    m_y = jnp.repeat(jnp.repeat(is_inter, spec.MB, 0), spec.MB, 1)
    m_c = jnp.repeat(jnp.repeat(is_inter, spec.BLK, 0), spec.BLK, 1)
    cdy, cdx = dy >> 1, dx >> 1
    if fmt >= 4:
        pcb = _parity_ext(ref_cb, HALO_C, axis_name, ref_mode)
        pcr = _parity_ext(ref_cr, HALO_C, axis_name, ref_mode)
        planes_cb = {(0, 0): ref_cb_ext, (0, 1): pcb[0],
                     (1, 0): pcb[1], (1, 1): pcb[2]}
        planes_cr = {(0, 0): ref_cr_ext, (0, 1): pcr[0],
                     (1, 0): pcr[1], (1, 1): pcr[2]}
        pred_y = jnp.where(
            m_y, _hpel_mc_haloed(planes_y, dy, dx, spec.MB, HALO_Y), 128)
        pred_cb = jnp.where(
            m_c, _hpel_mc_haloed(planes_cb, cdy, cdx, spec.BLK, HALO_C), 128)
        pred_cr = jnp.where(
            m_c, _hpel_mc_haloed(planes_cr, cdy, cdx, spec.BLK, HALO_C), 128)
    else:
        pred_y = jnp.where(m_y, _mc_haloed(ref_y_ext, dy, dx, spec.MB, HALO_Y), 128)
        pred_cb = jnp.where(m_c, _mc_haloed(ref_cb_ext, cdy, cdx, spec.BLK, HALO_C), 128)
        pred_cr = jnp.where(m_c, _mc_haloed(ref_cr_ext, cdy, cdx, spec.BLK, HALO_C), 128)
    return dy, dx, is_inter, pred_y, pred_cb, pred_cr


def encode_frame_tile_traced(
    cur_y, cur_cb, cur_cr, ref_y, ref_cb, ref_cr, base_qp,
    *, is_p, rc: str, block_words: int, cap_words: int,
    axis_name: str = "tile", ref_mode: str = "halo",
    fmt: int = 1, cqpo: int = 0, qbias: int = 8, qmat: bool = False,
    islice: int = 0, emit: str = "frame", mb_rows: int | None = None,
):
    """Per-shard frame encode; cur_/ref_ planes are local row shards.

    Collectives: halo ppermute (or all_gather) for the reference, psum for
    the frame bit total. Returns local payload words/bits + recon shards.
    fmt=3 requires islice (SPEC.md §13.3) dividing the shard's MB rows: the
    I-frame vertical-intra chain then resets at (at least) every shard
    boundary, so each shard codes its rows with zero cross-shard state —
    byte-identical to the unsharded v3 encode at the same islice.

    is_p may be a python bool (static callers) or a traced scalar (the
    tile GOP scan): like the GOP scan, the I/P cond wraps ONLY the
    prediction stage, so code+pack compile once, outside the cond (see
    gop_engine.code_pack_traced).

    mb_rows, when given, is the frame's MB row count and the shards carry
    padding rows past it (_pad_to_shards): those MBs add no bits, and their
    reconstruction repeats the frame's last row, so the next frame's
    reference and halo equal the unsharded edge padding."""
    dc, icost = motion.intra_cost_and_dc(cur_y)
    nby, nbx = icost.shape
    mb_valid = None
    if mb_rows is not None:
        n_valid = jnp.clip(mb_rows - jax.lax.axis_index(axis_name) * nby, 0, nby)
        mb_valid = jnp.broadcast_to(jnp.arange(nby)[:, None] < n_valid,
                                    (nby, nbx))

    def p_branch():
        return predict_p_tile_traced(
            cur_y, ref_y, ref_cb, ref_cr, icost,
            axis_name=axis_name, ref_mode=ref_mode, fmt=fmt)

    def i_branch():
        return (
            jnp.zeros((nby, nbx), jnp.int32),
            jnp.zeros((nby, nbx), jnp.int32),
            jnp.zeros((nby, nbx), jnp.bool_),
            jnp.full_like(cur_y, 128),
            jnp.full_like(cur_cb, 128),
            jnp.full_like(cur_cr, 128),
        )

    if isinstance(is_p, bool):
        dy, dx, is_inter, pred_y, pred_cb, pred_cr = (
            p_branch() if is_p else i_branch())
    else:
        dy, dx, is_inter, pred_y, pred_cb, pred_cr = jax.lax.cond(
            is_p, p_branch, i_branch)

    # v2 prediction is left-only within MB rows (SPEC.md §12), so the
    # row-sharded pack needs no cross-shard state. emit="chunks" routes
    # the shard's pack through the span-string path (pack_frame_chunks)
    # instead of the device-assembled tree_concat — the host glue already
    # bit_concats per-shard strings, so span strings just extend that list.
    if emit == "chunks":
        packc = (entropy.pack_frame_chunks_v2 if fmt >= 2
                 else entropy.pack_frame_chunks)

        def pack(ly, lcb, lcr, qpd, p, inter, dyv, dxv, bw, _cap):
            return packc(ly, lcb, lcr, qpd, p, inter, dyv, dxv, bw, mb_valid)
    else:
        pack = functools.partial(
            entropy.pack_frame_planes_v2 if fmt >= 2
            else entropy.pack_frame_planes, mb_valid=mb_valid)

    def code_pred(qps):
        return _code_frame(
            cur_y, cur_cb, cur_cr, pred_y, pred_cb, pred_cr, qps,
            cqpo if fmt >= 2 else 0, qbias, qmat,
        )

    def code_intra3(qps):
        """v3+ I-frame vertical-intra rows with the §13.3 slice reset
        (shards start at slice boundaries, so local reset == global
        pattern)."""
        qs = tx.qstep(qps)
        qs_y = tx.qsteps_pos(jnp.repeat(jnp.repeat(qs, 2, 0), 2, 1), qmat)
        qs_c = tx.qsteps_pos(
            qs if cqpo == 0 else tx.qstep(
                jnp.clip(qps + cqpo, spec.QP_MIN, spec.QP_MAX)
            ),
            qmat,
        )
        lv_y, rec_y = tx.intra_rows_code_plane(cur_y, qs_y, qbias, 2 * islice)
        lv_cb, rec_cb = tx.intra_rows_code_plane(cur_cb, qs_c, qbias, islice)
        lv_cr, rec_cr = tx.intra_rows_code_plane(cur_cr, qs_c, qbias, islice)
        return (
            (tx.zigzag(lv_y), tx.zigzag(lv_cb), tx.zigzag(lv_cr)),
            rec_y, rec_cb, rec_cr,
        )

    def code(qps):
        """Levels + recon at the given qps — the predicted path, or the v3
        I-frame intra rows (the pack runs after)."""
        if fmt < 3:
            return code_pred(qps)
        if isinstance(is_p, bool):
            return code_pred(qps) if is_p else code_intra3(qps)
        return jax.lax.cond(
            is_p, lambda: code_pred(qps), lambda: code_intra3(qps))

    if rc == "adaptive":
        qp_mb = motion.adaptive_qp(base_qp, icost)
    elif rc == "mb":
        # SPEC.md §10.4 is row-local (pace vs the MB row's own total), so
        # each tile shard's pass-1 probe is self-contained — no collective
        flat = jnp.full((nby, nbx), base_qp, jnp.int32)
        (p_y, p_cb, p_cr), _, _, _ = code(flat)
        _, _, est, _ = pack(
            p_y, p_cb, p_cr, flat - base_qp, jnp.asarray(is_p), is_inter,
            dy, dx, block_words, cap_words,
        )
        from ..pipeline.gop_engine import mb_rc_offsets_jnp

        qp_mb = jnp.clip(
            base_qp + mb_rc_offsets_jnp(est), spec.QP_MIN, spec.QP_MAX
        )
    else:
        qp_mb = jnp.full((nby, nbx), base_qp, jnp.int32)

    (lz_y, lz_cb, lz_cr), rec_y, rec_cb, rec_cr = code(qp_mb)
    words, bits, mb_bits, ovf_p = pack(
        lz_y, lz_cb, lz_cr, qp_mb - base_qp, jnp.asarray(is_p), is_inter,
        dy, dx, block_words, cap_words,
    )
    # chunks: bits is the per-span vector; the frame/RC total sums it first
    shard_bits = bits.sum() if emit == "chunks" else bits
    frame_bits = jax.lax.psum(shard_bits, axis_name)  # RC/stats over tiles
    if mb_valid is not None:
        is_inter = is_inter & mb_valid
        rec_y = _edge_rows(rec_y, n_valid * spec.MB)
        rec_cb = _edge_rows(rec_cb, n_valid * spec.BLK)
        rec_cr = _edge_rows(rec_cr, n_valid * spec.BLK)
    return dict(
        words=words, bits=bits, frame_bits=frame_bits, ovf=ovf_p,
        n_inter=is_inter.sum().astype(jnp.int32),
        rec_y=rec_y, rec_cb=rec_cb, rec_cr=rec_cr,
    )


def tile_gop_scan(
    y, cb, cr, base_qp,
    *, rc, block_words, cap_words, target_bits, ref_mode="halo",
    fmt: int = 1, cqpo: int = 0, qbias: int = 8, vbv_bits: int = 0,
    qmat: bool = False, islice: int = 0, emit: str = "frame",
    mb_rows: int | None = None,
):
    """Per-shard GOP scan over one GOP's local row shards [T, H/ntile, W].

    Runs inside shard_map with a live 'tile' axis (halo ppermute + psum
    bit totals); shared by the 1-D tile program and the fused 2-D
    ('gop','tile') program, so both are byte-identical by construction."""

    def body(carry, xs):
        ref_y, ref_cb, ref_cr, qp, fullness = carry
        cur_y = xs["y"].astype(jnp.int32)
        cur_cb = xs["cb"].astype(jnp.int32)
        cur_cr = xs["cr"].astype(jnp.int32)
        kw = dict(rc=rc, block_words=block_words, cap_words=cap_words,
                  fmt=fmt, cqpo=cqpo, qbias=qbias, qmat=qmat, islice=islice,
                  emit=emit, mb_rows=mb_rows)
        # traced is_p: the I/P cond inside wraps only the prediction, so
        # the pack compiles once, outside any cond branch
        out = encode_frame_tile_traced(
            cur_y, cur_cb, cur_cr, ref_y, ref_cb, ref_cr, qp,
            is_p=xs["i"] > 0, ref_mode=ref_mode, **kw
        )
        qp_used = qp
        # rc carry on the psum'd frame total (out["frame_bits"]), so every
        # tile shard derives the identical next qp (gop_engine.rc_carry_step
        # semantics on the global bits)
        qp, fullness = rc_carry_step(
            rc, target_bits, vbv_bits, qp, fullness, out["frame_bits"]
        )
        carry = (out["rec_y"], out["rec_cb"], out["rec_cr"], qp, fullness)
        ys = dict(words=out["words"], bits=out["bits"], ovf=out["ovf"],
                  n_inter=out["n_inter"], qp=qp_used)
        return carry, ys

    t_frames = y.shape[0]
    init = (
        jnp.zeros(y.shape[1:], jnp.int32),
        jnp.zeros(cb.shape[1:], jnp.int32),
        jnp.zeros(cr.shape[1:], jnp.int32),
        jnp.asarray(base_qp, jnp.int32),
        jnp.asarray(spec.vbv_init(vbv_bits), jnp.int32),
    )
    xs = dict(y=y, cb=cb, cr=cr, i=jnp.arange(t_frames, dtype=jnp.int32))
    _, outs = jax.lax.scan(body, init, xs)
    return outs


@functools.partial(
    jax.jit,
    static_argnames=("mesh", "rc", "block_words", "cap_words",
                     "target_bits", "ref_mode", "fmt", "cqpo", "qbias",
                     "vbv_bits", "qmat", "islice", "emit"),
)
def encode_gop_tiled(
    y_u8, cb_u8, cr_u8, base_qp,
    *, mesh, rc, block_words, cap_words, target_bits, ref_mode="halo",
    fmt: int = 1, cqpo: int = 0, qbias: int = 8, vbv_bits: int = 0,
    qmat: bool = False, islice: int = 0, emit: str = "frame",
):
    """GOP encode with frames row-sharded over the 'tile' mesh axis.

    y_u8: [T, H, W] uint8. MB rows that do not split evenly over the tile
    devices are edge-padded (_pad_to_shards). Output words/bits are
    per-shard, P('tile') on their leading shard axis. v3 needs
    intra slices (SPEC.md §13.3): classic v3's I-frame vertical intra chain
    crosses MB-row shard boundaries, but with islice dividing the per-shard
    MB rows every shard starts at a slice boundary and the chain resets
    there — shards are independent by construction (the H.264-slice move),
    and the tiled stream equals the unsharded one at the same islice.
    """
    ntile = mesh.shape["tile"]
    y_u8, cb_u8, cr_u8, mb_rows = _pad_to_shards(y_u8, cb_u8, cr_u8, ntile)
    mb_rows_shard = y_u8.shape[1] // spec.MB // ntile
    if fmt >= 3 and (islice == 0 or mb_rows_shard % islice):
        raise ValueError(
            f"v3 tile sharding needs intra_slice_mbrows dividing the "
            f"per-shard MB rows ({mb_rows_shard}); got islice={islice} "
            "(SPEC.md §13.3)")
    kw = dict(rc=rc, block_words=block_words, cap_words=cap_words,
              target_bits=target_bits, ref_mode=ref_mode, fmt=fmt,
              cqpo=cqpo, qbias=qbias, vbv_bits=vbv_bits, qmat=qmat,
              islice=islice, emit=emit, mb_rows=mb_rows)

    def per_shard(y, cb, cr):
        outs = tile_gop_scan(y, cb, cr, base_qp, **kw)
        # add the shard axis so out_specs can map it to 'tile'
        return jax.tree.map(lambda a: a[None], outs)

    sharded = P(None, "tile", None)
    return shard_map(
        per_shard,
        mesh=mesh,
        in_specs=(sharded, sharded, sharded),
        out_specs=dict(
            words=P("tile"), bits=P("tile"), ovf=P("tile"),
            n_inter=P("tile"), qp=P("tile"),
        ),
        check_vma=False,
    )(y_u8, cb_u8, cr_u8)


@functools.partial(
    jax.jit,
    static_argnames=("mesh", "rc", "block_words", "cap_words",
                     "target_bits", "ref_mode", "fmt", "cqpo", "qbias",
                     "vbv_bits", "qmat", "islice", "emit"),
)
def encode_gop_batch_2d(
    y_u8, cb_u8, cr_u8, base_qp,
    *, mesh, rc, block_words, cap_words, target_bits, ref_mode="halo",
    fmt: int = 1, cqpo: int = 0, qbias: int = 8, vbv_bits: int = 0,
    qmat: bool = False, islice: int = 0, emit: str = "frame",
):
    """Fused 2-D program (SURVEY.md §3.4; VERDICT r1 missing #2): ONE
    shard_map shards the GOP batch over 'gop' AND every frame's MB rows
    over 'tile' simultaneously.

    y_u8: [G, T, H, W] uint8, G divisible by mesh 'gop' size; MB rows are
    edge-padded to split evenly over 'tile' (_pad_to_shards). Each (gop, tile) device runs the tile scan (halo ppermute +
    psum ride the 'tile' axis only) lax.map'd over its local GOPs; the
    'gop' axis carries no collectives — GOPs are closed under prediction.
    Outputs: words [G, ntile, T, cap/ntile], bits/qp/ovf [G, ntile, T]
    (host: bit_concat over the tile axis restores each frame's payload).
    v3 needs islice dividing the per-shard MB rows (SPEC.md §13.3, same
    rule as encode_gop_tiled).
    """
    y_u8, cb_u8, cr_u8, mb_rows = _pad_to_shards(
        y_u8, cb_u8, cr_u8, mesh.shape["tile"])
    mb_rows_shard = y_u8.shape[2] // spec.MB // mesh.shape["tile"]
    if fmt >= 3 and (islice == 0 or mb_rows_shard % islice):
        raise ValueError(
            f"v3 tile sharding needs intra_slice_mbrows dividing the "
            f"per-shard MB rows ({mb_rows_shard}); got islice={islice} "
            "(SPEC.md §13.3)")
    kw = dict(rc=rc, block_words=block_words, cap_words=cap_words,
              target_bits=target_bits, ref_mode=ref_mode, fmt=fmt,
              cqpo=cqpo, qbias=qbias, vbv_bits=vbv_bits, qmat=qmat,
              islice=islice, emit=emit, mb_rows=mb_rows)

    def per_device(y, cb, cr):
        def one(args):
            return tile_gop_scan(*args, base_qp, **kw)

        outs = jax.lax.map(one, (y, cb, cr))  # [Gl, T, ...] local
        # insert the tile shard axis after G so out_specs can map it
        return jax.tree.map(lambda a: a[:, None], outs)

    spec_in = P("gop", None, "tile", None)
    return shard_map(
        per_device,
        mesh=mesh,
        in_specs=(spec_in, spec_in, spec_in),
        out_specs=dict(
            words=P("gop", "tile"), bits=P("gop", "tile"),
            ovf=P("gop", "tile"), n_inter=P("gop", "tile"),
            qp=P("gop", "tile"),
        ),
        check_vma=False,
    )(y_u8, cb_u8, cr_u8)


def mb_rc_offsets_tile2d(est, ac: str):
    """SPEC.md §10.4 rc=mb offsets on a column-sharded MB grid: the pace
    needs each MB row's GLOBAL total and each MB's global prefix/position,
    so one psum (row totals) + one all_gather (per-shard share sums → the
    exclusive cross-shard prefix) ride the 'tc' axis. Bit-identical to
    gop_engine.mb_rc_offsets_jnp on the unsharded grid (r2 verdict item 4)."""
    est = est.astype(jnp.int32)
    nbx_local = est.shape[-1]
    sc = jax.lax.axis_size(ac)
    ci = jax.lax.axis_index(ac)
    row_tot = jnp.maximum(
        jax.lax.psum(est.sum(axis=-1, keepdims=True), ac), 1
    )
    share = est * 1024 // row_tot
    share_sum = share.sum(axis=-1, keepdims=True)            # [nby, 1]
    gathered = jax.lax.all_gather(share_sum, ac)             # [sc, nby, 1]
    mask = (jnp.arange(sc) < ci)[:, None, None]
    prefix = jnp.sum(jnp.where(mask, gathered, 0), axis=0)   # [nby, 1]
    spent = prefix + jnp.cumsum(share, axis=-1) - share
    gx = ci * nbx_local + jnp.arange(nbx_local, dtype=jnp.int32)
    plan = (gx * 1024) // (sc * nbx_local)
    return jnp.clip((spent - plan) >> 7, -2, 2)


def encode_frame_tile2d_traced(
    cur_y, cur_cb, cur_cr, ref_y, ref_cb, ref_cr, base_qp,
    *, is_p, rc: str, block_words: int, row_words: int,
    ar: str = "tr", ac: str = "tc", qbias: int = 8,
):
    """Per-shard frame encode on a 2-D (row x column) tile grid.

    cur_/ref_ planes are [h/Sr, w/Sc] shards. The reference halo comes from
    the 4-neighborhood + corners (exchange_halo_2d); the pack emits per-MB-
    row strings so the host can restore the frame's MB raster order across
    column shards. Format v1 only: v2's left-MV/DC prediction would need a
    boundary-column exchange along 'tc' (1-D row sharding covers v2).
    rc=mb runs its pass-1 probe per shard and derives the global pace via
    mb_rc_offsets_tile2d's 'tc' collectives. is_p may be traced: the I/P
    cond wraps only the prediction (pack stays outside any cond branch —
    see encode_frame_tile_traced).
    """
    dc, icost = motion.intra_cost_and_dc(cur_y)
    nby, nbx = icost.shape

    def p_branch():
        ref_y_ext = exchange_halo_2d(ref_y, HALO_Y, ar, ac)
        ref_cb_ext = exchange_halo_2d(ref_cb, HALO_C, ar, ac)
        ref_cr_ext = exchange_halo_2d(ref_cr, HALO_C, ar, ac)
        dy, dx, best_sad = _full_search_haloed(cur_y, ref_y_ext)
        is_inter = best_sad <= icost
        m_y = jnp.repeat(jnp.repeat(is_inter, spec.MB, 0), spec.MB, 1)
        m_c = jnp.repeat(jnp.repeat(is_inter, spec.BLK, 0), spec.BLK, 1)
        cdy, cdx = dy >> 1, dx >> 1
        pred_y = jnp.where(m_y, _mc_haloed(ref_y_ext, dy, dx, spec.MB, HALO_Y), 128)
        pred_cb = jnp.where(m_c, _mc_haloed(ref_cb_ext, cdy, cdx, spec.BLK, HALO_C), 128)
        pred_cr = jnp.where(m_c, _mc_haloed(ref_cr_ext, cdy, cdx, spec.BLK, HALO_C), 128)
        return dy, dx, is_inter, pred_y, pred_cb, pred_cr

    def i_branch():
        return (
            jnp.zeros((nby, nbx), jnp.int32),
            jnp.zeros((nby, nbx), jnp.int32),
            jnp.zeros((nby, nbx), jnp.bool_),
            jnp.full_like(cur_y, 128),
            jnp.full_like(cur_cb, 128),
            jnp.full_like(cur_cr, 128),
        )

    if isinstance(is_p, bool):
        dy, dx, is_inter, pred_y, pred_cb, pred_cr = (
            p_branch() if is_p else i_branch())
    else:
        dy, dx, is_inter, pred_y, pred_cb, pred_cr = jax.lax.cond(
            is_p, p_branch, i_branch)

    if rc == "adaptive":
        qp_mb = motion.adaptive_qp(base_qp, icost)
    elif rc == "mb":
        # SPEC.md §10.4 pass 1 at the flat qp; global pace via 'tc'
        # collectives (mb_rc_offsets_tile2d)
        flat = jnp.full((nby, nbx), base_qp, jnp.int32)
        (p_y, p_cb, p_cr), _, _, _ = _code_frame(
            cur_y, cur_cb, cur_cr, pred_y, pred_cb, pred_cr, flat, 0, qbias,
        )
        _, _, est, _ = entropy.pack_frame_rows(
            p_y, p_cb, p_cr, flat - base_qp, jnp.asarray(is_p), is_inter,
            dy, dx, block_words, row_words,
        )
        qp_mb = jnp.clip(
            base_qp + mb_rc_offsets_tile2d(est, ac), spec.QP_MIN, spec.QP_MAX
        )
    else:
        qp_mb = jnp.full((nby, nbx), base_qp, jnp.int32)

    (lz_y, lz_cb, lz_cr), rec_y, rec_cb, rec_cr = _code_frame(
        cur_y, cur_cb, cur_cr, pred_y, pred_cb, pred_cr, qp_mb, 0, qbias,
    )
    words, row_bits, mb_bits, ovf = entropy.pack_frame_rows(
        lz_y, lz_cb, lz_cr, qp_mb - base_qp, jnp.asarray(is_p), is_inter,
        dy, dx, block_words, row_words,
    )
    frame_bits = jax.lax.psum(jax.lax.psum(row_bits.sum(), ar), ac)
    return dict(
        words=words, row_bits=row_bits, frame_bits=frame_bits, ovf=ovf,
        n_inter=is_inter.sum().astype(jnp.int32),
        rec_y=rec_y, rec_cb=rec_cb, rec_cr=rec_cr,
    )


@functools.partial(
    jax.jit,
    static_argnames=("mesh", "rc", "block_words", "row_words",
                     "target_bits", "qbias", "vbv_bits", "fmt"),
)
def encode_gop_tiled2d(
    y_u8, cb_u8, cr_u8, base_qp,
    *, mesh, rc, block_words, row_words, target_bits,
    qbias: int = 8, vbv_bits: int = 0, fmt: int = 1,
):
    if fmt != 1:
        raise ValueError(
            f"encode_gop_tiled2d is format v1 only (got fmt={fmt}): v2's "
            "left-MV/DC prediction crosses 'tc' column-shard boundaries and "
            "v4's half-pel is not implemented on the 2-D grid; use the 1-D "
            "row sharding (encode_gop_tiled) for fmt>=2")
    """GOP encode with frames sharded over a 2-D ('tr', 'tc') tile mesh —
    MB rows over 'tr' AND MB columns over 'tc', corner-correct halo
    (SURVEY.md §2.1 TP row; VERDICT r1 missing #4 / next-step #6).

    y_u8: [T, H, W] uint8; H/16 divisible by Sr, W/16 by Sc. rc="mb" derives
    its row-spanning pace via one psum + one all_gather along 'tc'
    (mb_rc_offsets_tile2d). Outputs per shard, per frame, per local MB row:
    words [Sr, Sc, T, nby_s, roww], row_bits [Sr, Sc, T, nby_s].
    """

    def per_shard(y, cb, cr):
        def body(carry, xs):
            ref_y, ref_cb, ref_cr, qp, fullness = carry
            cur_y = xs["y"].astype(jnp.int32)
            cur_cb = xs["cb"].astype(jnp.int32)
            cur_cr = xs["cr"].astype(jnp.int32)
            kw = dict(rc=rc, block_words=block_words, row_words=row_words,
                      qbias=qbias)
            out = jax.lax.cond(
                xs["i"] > 0,
                lambda: encode_frame_tile2d_traced(
                    cur_y, cur_cb, cur_cr, ref_y, ref_cb, ref_cr, qp,
                    is_p=True, **kw),
                lambda: encode_frame_tile2d_traced(
                    cur_y, cur_cb, cur_cr, ref_y, ref_cb, ref_cr, qp,
                    is_p=False, **kw),
            )
            qp_used = qp
            qp, fullness = rc_carry_step(
                rc, target_bits, vbv_bits, qp, fullness, out["frame_bits"]
            )
            carry = (out["rec_y"], out["rec_cb"], out["rec_cr"], qp, fullness)
            emit = dict(words=out["words"], row_bits=out["row_bits"],
                        ovf=out["ovf"], qp=qp_used)
            return carry, emit

        t_frames = y.shape[0]
        init = (
            jnp.zeros(y.shape[1:], jnp.int32),
            jnp.zeros(cb.shape[1:], jnp.int32),
            jnp.zeros(cr.shape[1:], jnp.int32),
            jnp.asarray(base_qp, jnp.int32),
            jnp.asarray(spec.vbv_init(vbv_bits), jnp.int32),
        )
        xs = dict(y=y, cb=cb, cr=cr, i=jnp.arange(t_frames, dtype=jnp.int32))
        _, outs = jax.lax.scan(body, init, xs)
        # add the two shard axes so out_specs can map them
        return jax.tree.map(lambda a: a[None, None], outs)

    sharded = P(None, "tr", "tc")
    return shard_map(
        per_shard,
        mesh=mesh,
        in_specs=(sharded, sharded, sharded),
        out_specs=dict(
            words=P("tr", "tc"), row_bits=P("tr", "tc"),
            ovf=P("tr", "tc"), qp=P("tr", "tc"),
        ),
        check_vma=False,
    )(y_u8, cb_u8, cr_u8)


def assemble_frame_2d(words, row_bits, t: int) -> tuple[bytes, int]:
    """Host glue for encode_gop_tiled2d outputs: frame t's payload =
    rows in global order, each row = its column shards' strings in order."""
    sr, sc = words.shape[0], words.shape[1]
    nby_s = words.shape[3]
    chunks = []
    for r in range(sr):
        for row in range(nby_s):
            for c in range(sc):
                chunks.append((words[r, c, t, row], int(row_bits[r, c, t, row])))
    return bit_concat(chunks)


def bit_concat(payloads: list[tuple[np.ndarray, int]]) -> tuple[bytes, int]:
    """Host mux glue: bit-concatenate per-shard (words_u32_be, nbits) into
    one frame payload (bytes, total_bits). Pure numpy shift-or."""
    total_bits = sum(b for _, b in payloads)
    out = np.zeros((total_bits + 31) // 32 + 1, dtype=np.uint64)
    pos = 0
    for words, nbits in payloads:
        if nbits == 0:
            continue
        nw = (nbits + 31) // 32
        w = words[:nw].astype(np.uint64)
        word0, sh = pos >> 5, pos & 31
        if sh == 0:
            out[word0 : word0 + nw] |= w
        else:
            out[word0 : word0 + nw] |= w >> np.uint64(sh)
            out[word0 + 1 : word0 + 1 + nw] |= (w << np.uint64(32 - sh)) & np.uint64(
                0xFFFFFFFF
            )
        pos += nbits
    nw_total = (total_bits + 31) // 32
    return out[:nw_total].astype(np.uint32).astype(">u4").tobytes(), total_bits
