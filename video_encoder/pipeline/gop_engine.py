"""GOP-resident device encoder — the production path.

One jitted XLA program encodes an entire GOP: lax.scan over frames carries
the reconstruction (the §3.2 serial P-chain) entirely on device; uint8
frames are uploaded once per GOP and only packed payload words + per-frame
stats come back. This replaces the reference's pthread per-frame pipeline
hops ([B:5]) with zero host round-trips inside a GOP (SURVEY.md §2.1 PP
row: "within-device the stage fusion is one XLA program").

Payload capacity is budgeted (K coded coeffs/block, words/MB, words/frame)
with exact on-device overflow detection; an overflowing GOP is re-encoded
by the worst-case-capacity variant (bit-exact either way).
"""

from __future__ import annotations

import functools
import time

import jax
import jax.numpy as jnp
import numpy as np

from ..codec import entropy, spec
from ..codec.bitstream import FramePacket
from ..codec.config import EncoderConfig
from ..codec.golden import Frame
from ..ops import dispatch, motion, transform as tx
from ..utils.metrics import FrameStats


def _block_words_for_qp(qp: int) -> int:
    """Per-8x8-block word budget for the blocked pack (overflow -> exact
    worst-case rerun); finer quantizers keep more coefficients, and an
    overflowing GOP re-encodes bit-exactly at the worst case."""
    if qp >= 28:
        return 16
    if qp >= 20:
        return entropy.BLOCK_WORDS_DEFAULT  # 24 words = 768 bits/block
    if qp >= 14:
        return 48
    return entropy.BLOCK_WORDS_MAX


def _code_plane(cur, pred, q_blk, qbias: int = 8, qmat: bool = False):
    """Transform→quant→zigzag→recon of one plane (C9–C11, C14).

    q_blk: per-8x8-block quantizer steps [H/8, W/8]. Planes stay separate
    (no blocks6 pixel interleave); the per-MB piece order is restored at
    the word level in entropy.pack_frame_planes. qmat applies the v3
    per-position quant matrix.
    """
    return dispatch.code_plane(cur, pred, q_blk, qbias, qmat)


def _code_frame(cur_y, cur_cb, cur_cr, pred_y, pred_cb, pred_cr, qp_mb,
                cqpo: int = 0, qbias: int = 8, qmat: bool = False):
    """Shared transform→quant→zigzag→recon stages, per plane.

    cqpo: v2 chroma QP offset (SPEC.md §12.2); 0 reproduces v1 exactly.
    qbias: encoder-side AC quantizer rounding bias (codec/config.py).
    qmat: v3 per-position quant matrix (SPEC.md §13.2).
    Returns ((lz_y8 [2nby,2nbx,64], lz_cb, lz_cr), rec_y, rec_cb, rec_cr)."""
    qs = tx.qstep(qp_mb)
    qy = jnp.repeat(jnp.repeat(qs, 2, 0), 2, 1)
    qc = qs if cqpo == 0 else tx.qstep(
        jnp.clip(qp_mb + cqpo, spec.QP_MIN, spec.QP_MAX)
    )
    lz_y, rec_y = _code_plane(cur_y, pred_y, qy, qbias, qmat)
    lz_cb, rec_cb = _code_plane(cur_cb, pred_cb, qc, qbias, qmat)
    lz_cr, rec_cr = _code_plane(cur_cr, pred_cr, qc, qbias, qmat)
    return (lz_y, lz_cb, lz_cr), rec_y, rec_cb, rec_cr


def _sse(a, b):
    d = (a - b).astype(jnp.float32)
    return jnp.sum(d * d)


def mb_rc_offsets_jnp(est):
    """jnp twin of spec.mb_rc_offsets (SPEC.md §10.4) — identical integer
    program, int32 throughout (share/spent/plan <= ~1024+nbx)."""
    est = est.astype(jnp.int32)
    nbx = est.shape[-1]
    row_tot = jnp.maximum(est.sum(axis=-1, keepdims=True), 1)
    share = est * 1024 // row_tot
    spent = jnp.cumsum(share, axis=-1) - share
    plan = (jnp.arange(nbx, dtype=jnp.int32) * 1024) // nbx
    return jnp.clip((spent - plan) >> 7, -2, 2)


def rc_carry_step(rc: str, target_bits: int, vbv_bits: int, qp, fullness, bits):
    """Frame-level RC carry update (SPEC.md §10), shared by the GOP scan and
    the temporal ring (parallel/ring.py) so sharded streams stay
    byte-identical to single-device encodes under every rc mode."""
    if rc in ("bitrate", "mb") and target_bits > 0:
        # rc=mb frame-level carry == rc=bitrate; per-MB offsets are intra-frame
        t = max(target_bits, 1)
        delta = jnp.clip(((bits - t) * 4) // t, -2, 2)
        qp = jnp.clip(qp + delta, spec.QP_MIN, spec.QP_MAX)
    elif rc == "vbv" and target_bits > 0:
        # spec.vbv_next verbatim (jnp // floors like Python //)
        t = max(target_bits, 1)
        f = jnp.clip(fullness + target_bits - bits, 0, vbv_bits)
        delta = jnp.clip(((bits - target_bits) * 4) // t, -2, 2)
        delta = (delta + (f < vbv_bits // 4).astype(jnp.int32)
                 - (f > (3 * vbv_bits) // 4).astype(jnp.int32))
        qp = jnp.clip(qp + delta, spec.QP_MIN, spec.QP_MAX)
        fullness = f
    return qp, fullness


def predict_p_traced(cur_y, ref_y, ref_cb, ref_cr, icost,
                     *, search: str, fmt: int):
    """P-frame prediction stage (C5-C8): ME (+ the v4 half-pel refine),
    mode decision, MC. Returns (dy, dx, is_inter, pred_y, pred_cb,
    pred_cr); for fmt >= 4 the vectors are half-pel units (SPEC.md §14).

    hier is not a device-engine mode: it survives as a host-side search
    in the golden model + C++ oracle (SPEC.md §9)."""
    if search not in ("full", "diamond"):
        raise ValueError(
            f"search={search!r} is not a device-engine mode (full, "
            "diamond); hier is golden/oracle-only"
        )
    with jax.named_scope("me"):
        if search == "full":
            dy, dx, best_sad = motion.full_search(cur_y, ref_y)
        else:
            dy, dx, best_sad = motion.diamond_search(cur_y, ref_y)
        if fmt >= 4:
            # v4 (SPEC.md §14.4): refine to half-pel; dy/dx are half-pel
            # units from here on (mvd coding included)
            dy, dx, best_sad = dispatch.hpel_refine(cur_y, ref_y, dy, dx)
    with jax.named_scope("mc"):
        return _predict_planes(ref_y, ref_cb, ref_cr, dy, dx,
                               best_sad <= icost, fmt)


def _predict_planes(ref_y, ref_cb, ref_cr, dy, dx, is_inter, fmt: int):
    """MC of the three planes for inter MBs, flat 128 for intra MBs."""
    m_y = jnp.repeat(jnp.repeat(is_inter, spec.MB, 0), spec.MB, 1)
    m_c = jnp.repeat(jnp.repeat(is_inter, spec.BLK, 0), spec.BLK, 1)
    cdy, cdx = dy >> 1, dx >> 1
    if fmt >= 4:
        pred_y = jnp.where(
            m_y, dispatch.mc_fetch_luma_plane_hpel(ref_y, dy, dx), 128)
        pred_cb = jnp.where(
            m_c, dispatch.mc_fetch_chroma_plane_hpel(ref_cb, cdy, cdx), 128)
        pred_cr = jnp.where(
            m_c, dispatch.mc_fetch_chroma_plane_hpel(ref_cr, cdy, cdx), 128)
    else:
        pred_y = jnp.where(m_y, dispatch.mc_fetch_luma_plane(ref_y, dy, dx), 128)
        pred_cb = jnp.where(m_c, dispatch.mc_fetch_chroma_plane(ref_cb, cdy, cdx), 128)
        pred_cr = jnp.where(m_c, dispatch.mc_fetch_chroma_plane(ref_cr, cdy, cdx), 128)
    return dy, dx, is_inter, pred_y, pred_cb, pred_cr


def predict_i_traced(cur_y, cur_cb, cur_cr, nby: int, nbx: int):
    """I-frame 'prediction': flat 128 planes, zero vectors."""
    return (
        jnp.zeros((nby, nbx), jnp.int32),
        jnp.zeros((nby, nbx), jnp.int32),
        jnp.zeros((nby, nbx), jnp.bool_),
        jnp.full_like(cur_y, 128),
        jnp.full_like(cur_cb, 128),
        jnp.full_like(cur_cr, 128),
    )


def code_pack_traced(
    cur_y, cur_cb, cur_cr, pred_y, pred_cb, pred_cr,
    dy, dx, is_inter, is_p, base_qp, icost,
    *, rc: str, block_words: int, cap_words: int, fmt: int = 1,
    cqpo: int = 0, qbias: int = 8, qmat: bool = False, islice: int = 0,
    emit: str = "frame",
):
    """Shared transform/quant/recon + entropy pack stage.

    is_p may be a python bool (static callers: ring, tiles, entry) or a
    traced scalar (the GOP scan, where the I/P cond wraps ONLY the
    prediction stage, so the pack compiles once instead of once per
    branch).

    emit="frame": the device assembles the whole frame payload
    (tree_concat). emit="chunks": the device stops at span strings
    (entropy.pack_frame_chunks*) and the host mux concatenates them."""
    nby, nbx = icost.shape

    if emit == "chunks":
        packc = (entropy.pack_frame_chunks_v2 if fmt >= 2
                 else entropy.pack_frame_chunks)

        def pack(lz_y, lz_cb, lz_cr, qpd, p, inter, dy_, dx_, bw, cap):
            cw_, cb_, mb_b, ovf = packc(
                lz_y, lz_cb, lz_cr, qpd, p, inter, dy_, dx_, bw
            )
            return (cw_, cb_), cb_.sum().astype(jnp.int32), mb_b, ovf
    else:
        pack = (entropy.pack_frame_planes_v2 if fmt >= 2
                else entropy.pack_frame_planes)

    def code_pred(qps):
        """The predicted coding path (I frames hit it with flat-128 pred
        for fmt < 3)."""
        return _code_frame(
            cur_y, cur_cb, cur_cr, pred_y, pred_cb, pred_cr, qps,
            cqpo if fmt >= 2 else 0, qbias, qmat,
        )

    def code_intra3(qps):
        """v3+ I-frame vertical-intra row scan (SPEC.md §13.1)."""
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

    @jax.named_scope("code_plane")
    def code(qps):
        if fmt < 3:
            return code_pred(qps)
        if isinstance(is_p, bool):  # static callers resolve the branch now
            return code_pred(qps) if is_p else code_intra3(qps)
        return jax.lax.cond(
            is_p, lambda: code_pred(qps), lambda: code_intra3(qps)
        )

    if rc == "adaptive":
        qp_mb = motion.adaptive_qp(base_qp, icost)
    elif rc == "mb":
        # per-MB bits feedback (SPEC.md §10.4): pass 1 codes + packs the
        # frame at the flat qp purely for its per-MB bit counts; row-local
        # pace offsets then set the pass-2 quantizers. Both passes run on
        # device inside the same program — no host round-trip.
        flat = jnp.full((nby, nbx), base_qp, jnp.int32)
        (p_y, p_cb, p_cr), _, _, _ = code(flat)
        _, _, est, _ = pack(
            p_y, p_cb, p_cr, flat - base_qp, jnp.asarray(is_p), is_inter,
            dy, dx, block_words, cap_words,
        )
        qp_mb = jnp.clip(
            base_qp + mb_rc_offsets_jnp(est), spec.QP_MIN, spec.QP_MAX
        )
    else:
        qp_mb = jnp.full((nby, nbx), base_qp, jnp.int32)

    (lz_y, lz_cb, lz_cr), rec_y, rec_cb, rec_cr = code(qp_mb)

    words, total_bits, mb_bits, ovf_p = pack(
        lz_y, lz_cb, lz_cr, qp_mb - base_qp, jnp.asarray(is_p), is_inter,
        dy, dx, block_words, cap_words,
    )
    sse = jnp.stack([_sse(cur_y, rec_y), _sse(cur_cb, rec_cb), _sse(cur_cr, rec_cr)])
    out = dict(
        bits=total_bits,
        ovf=ovf_p,
        n_inter=is_inter.sum().astype(jnp.int32),
        rec_y=rec_y,
        rec_cb=rec_cb,
        rec_cr=rec_cr,
        sse=sse,
    )
    if emit == "chunks":
        out["words"], out["cbits"] = words
    else:
        out["words"] = words
    return out


def encode_frame_traced(
    cur_y, cur_cb, cur_cr, ref_y, ref_cb, ref_cr, base_qp,
    *, is_p: bool, search: str, rc: str, block_words: int, cap_words: int,
    fmt: int = 1, cqpo: int = 0, qbias: int = 8, qmat: bool = False,
    islice: int = 0, emit: str = "frame",
):
    """One frame, traceable, with STATIC is_p — the composition of
    predict_{p,i}_traced + code_pack_traced used by the ring/tile shards
    and __graft_entry__ (the GOP scan composes the stages itself so the
    I/P cond wraps only the prediction — see code_pack_traced)."""
    dc, icost = motion.intra_cost_and_dc(cur_y)
    nby, nbx = icost.shape
    if is_p:
        dy, dx, is_inter, pred_y, pred_cb, pred_cr = predict_p_traced(
            cur_y, ref_y, ref_cb, ref_cr, icost, search=search, fmt=fmt
        )
    else:
        dy, dx, is_inter, pred_y, pred_cb, pred_cr = predict_i_traced(
            cur_y, cur_cb, cur_cr, nby, nbx
        )
    return code_pack_traced(
        cur_y, cur_cb, cur_cr, pred_y, pred_cb, pred_cr,
        dy, dx, is_inter, is_p, base_qp, icost,
        rc=rc, block_words=block_words, cap_words=cap_words, fmt=fmt,
        cqpo=cqpo, qbias=qbias, qmat=qmat, islice=islice, emit=emit,
    )


@functools.partial(
    jax.jit,
    static_argnames=("search", "rc", "block_words", "cap_words", "target_bits",
                     "fmt", "cqpo", "qbias", "vbv_bits", "qmat", "unroll",
                     "islice", "emit"),
)
def encode_gop_jit(
    y_u8, cb_u8, cr_u8, base_qp,
    *, search: str, rc: str, block_words: int, cap_words: int,
    target_bits: int, fmt: int = 1, cqpo: int = 0, qbias: int = 8,
    vbv_bits: int = 0, qmat: bool = False, unroll: int = 1, islice: int = 0,
    emit: str = "frame",
):
    """Encode a [T, ...] uint8 GOP on device. Returns stacked per-frame
    outputs (words/bits/ovf/qp/n_inter/sse). unroll feeds lax.scan's
    unroll knob (perf experiment; bit-identical output)."""
    t_frames = y_u8.shape[0]

    def body(carry, xs):
        ref_y, ref_cb, ref_cr, qp, fullness = carry
        cur_y = xs["y"].astype(jnp.int32)
        cur_cb = xs["cb"].astype(jnp.int32)
        cur_cr = xs["cr"].astype(jnp.int32)
        idx = xs["i"]

        # the I/P cond wraps ONLY the prediction stage; code+pack run
        # unconditionally with a traced is_p (see code_pack_traced on why
        # this structure is required, not just cheaper to compile)
        dc, icost = motion.intra_cost_and_dc(cur_y)
        nby, nbx = icost.shape
        dy, dx, is_inter, pred_y, pred_cb, pred_cr = jax.lax.cond(
            idx > 0,
            lambda: predict_p_traced(
                cur_y, ref_y, ref_cb, ref_cr, icost, search=search, fmt=fmt
            ),
            lambda: predict_i_traced(cur_y, cur_cb, cur_cr, nby, nbx),
        )
        out = code_pack_traced(
            cur_y, cur_cb, cur_cr, pred_y, pred_cb, pred_cr,
            dy, dx, is_inter, idx > 0, qp, icost,
            rc=rc, block_words=block_words, cap_words=cap_words, fmt=fmt,
            cqpo=cqpo, qbias=qbias, qmat=qmat, islice=islice, emit=emit,
        )
        qp_used = qp
        qp, fullness = rc_carry_step(
            rc, target_bits, vbv_bits, qp, fullness, out["bits"]
        )
        carry = (out["rec_y"], out["rec_cb"], out["rec_cr"], qp, fullness)
        emitted = dict(
            words=out["words"], bits=out["bits"], ovf=out["ovf"],
            n_inter=out["n_inter"], qp=qp_used, sse=out["sse"],
        )
        if emit == "chunks":
            emitted["cbits"] = out["cbits"]
        return carry, emitted

    init = (
        jnp.zeros(y_u8.shape[1:], jnp.int32),
        jnp.zeros(cb_u8.shape[1:], jnp.int32),
        jnp.zeros(cr_u8.shape[1:], jnp.int32),
        jnp.asarray(base_qp, jnp.int32),
        jnp.asarray(spec.vbv_init(vbv_bits), jnp.int32),
    )
    xs = dict(
        y=y_u8, cb=cb_u8, cr=cr_u8, i=jnp.arange(t_frames, dtype=jnp.int32)
    )
    _, outs = jax.lax.scan(body, init, xs, unroll=unroll)
    return outs


@functools.partial(
    jax.jit,
    static_argnames=("search", "rc", "block_words", "cap_words", "target_bits",
                     "fmt", "cqpo", "qbias", "vbv_bits", "qmat", "unroll",
                     "islice", "emit"),
)
def encode_gop_batch_jit(
    y_u8, cb_u8, cr_u8, base_qp,
    *, search: str, rc: str, block_words: int, cap_words: int,
    target_bits: int, fmt: int = 1, cqpo: int = 0, qbias: int = 8,
    vbv_bits: int = 0, qmat: bool = False, unroll: int = 1, islice: int = 0,
    emit: str = "frame",
):
    """Encode G independent GOPs in lockstep on ONE chip: inputs [G, T, ...]
    uint8, one lax.scan over T whose body is vmapped over the GOP axis.

    Vectorizing G GOPs into each scan iteration amortizes the scan's
    per-iteration cost over G frames while remaining byte-identical to G
    separate encodes (GOPs are closed under prediction — SURVEY.md §3.2, [B:10]).
    This is also the natural production shape for clip encode: a clip IS a
    batch of GOPs.

    base_qp may be a scalar (broadcast) or a [G] array (per-GOP qp, used by
    two-pass). Returns outs with [T, G, ...] leading axes.
    """
    g, t_frames = y_u8.shape[0], y_u8.shape[1]
    ckw = dict(rc=rc, block_words=block_words, cap_words=cap_words, fmt=fmt,
               cqpo=cqpo, qbias=qbias, qmat=qmat, islice=islice, emit=emit)

    def body(carry, xs):
        ref_y, ref_cb, ref_cr, qp, fullness = carry
        cur_y = xs["y"].astype(jnp.int32)    # [G, H, W]
        cur_cb = xs["cb"].astype(jnp.int32)
        cur_cr = xs["cr"].astype(jnp.int32)
        idx = xs["i"]                        # scalar: GOPs run in lockstep,
        # so the I/P branch stays a scan-level cond outside the vmap — and
        # wraps ONLY the prediction stage (see code_pack_traced)
        dc_icost = jax.vmap(motion.intra_cost_and_dc)(cur_y)
        icost = dc_icost[1]
        nby, nbx = icost.shape[1], icost.shape[2]
        dy, dx, is_inter, pred_y, pred_cb, pred_cr = jax.lax.cond(
            idx > 0,
            lambda: jax.vmap(
                lambda cy, ry, rcb, rcr, ic: predict_p_traced(
                    cy, ry, rcb, rcr, ic, search=search, fmt=fmt
                )
            )(cur_y, ref_y, ref_cb, ref_cr, icost),
            lambda: jax.vmap(
                lambda cy, ccb, ccr: predict_i_traced(cy, ccb, ccr, nby, nbx)
            )(cur_y, cur_cb, cur_cr),
        )
        out = jax.vmap(
            lambda cy, ccb, ccr, py, pcb, pcr, dy_, dx_, it_, qp_, ic: (
                code_pack_traced(
                    cy, ccb, ccr, py, pcb, pcr, dy_, dx_, it_, idx > 0,
                    qp_, ic, **ckw
                )
            )
        )(cur_y, cur_cb, cur_cr, pred_y, pred_cb, pred_cr, dy, dx, is_inter,
          qp, icost)
        qp_used = qp
        # rc_carry_step is elementwise over [G] qp/fullness/bits
        qp, fullness = rc_carry_step(
            rc, target_bits, vbv_bits, qp, fullness, out["bits"]
        )
        carry = (out["rec_y"], out["rec_cb"], out["rec_cr"], qp, fullness)
        emitted = dict(
            words=out["words"], bits=out["bits"], ovf=out["ovf"],
            n_inter=out["n_inter"], qp=qp_used, sse=out["sse"],
        )
        if emit == "chunks":
            emitted["cbits"] = out["cbits"]
        return carry, emitted

    qp0 = jnp.broadcast_to(jnp.asarray(base_qp, jnp.int32), (g,))
    init = (
        jnp.zeros((g,) + y_u8.shape[2:], jnp.int32),
        jnp.zeros((g,) + cb_u8.shape[2:], jnp.int32),
        jnp.zeros((g,) + cr_u8.shape[2:], jnp.int32),
        qp0,
        jnp.full((g,), spec.vbv_init(vbv_bits), jnp.int32),
    )
    xs = dict(
        y=jnp.swapaxes(y_u8, 0, 1),   # [T, G, ...]
        cb=jnp.swapaxes(cb_u8, 0, 1),
        cr=jnp.swapaxes(cr_u8, 0, 1),
        i=jnp.arange(t_frames, dtype=jnp.int32),
    )
    _, outs = jax.lax.scan(body, init, xs, unroll=unroll)
    return outs


def _bucket(n: int) -> int:
    """Round a word count up to a coarse bucket to bound slice recompiles."""
    b = 4096
    while b < n:
        b *= 2
    return b


class GopEngine:
    """Host driver for the GOP-resident device path.

    encode_gop(frames, first_index, base_qp) -> (packets, stats); falls back
    to worst-case capacities when the budgeted pack overflows (bit-exact
    either way, SPEC.md §11 invariant 2).
    """

    # Device-side frame assembly vs host-muxed chunk strings: both are
    # bit-exact (tests/test_gop_engine.py runs the engine under each).
    # chunks is the production default: the span strings of a frame are
    # glued by the host mux, overlapped with device compute by the async
    # driver (SURVEY.md §7.0).
    emit = "chunks"

    def __init__(self, cfg: EncoderConfig):
        if cfg.search not in ("full", "diamond"):
            raise ValueError(
                f"search={cfg.search!r} is not a device-engine mode (full, "
                "diamond); hier is golden/oracle-only"
            )
        self.cfg = cfg

    def _run(self, y, cb, cr, base_qp: int, xl: bool):
        cfg = self.cfg
        n_mbs = (y.shape[1] // spec.MB) * (y.shape[2] // spec.MB)
        if xl:
            bw = entropy.BLOCK_WORDS_MAX
            cap = entropy.max_words(n_mbs)
        else:
            bw = _block_words_for_qp(base_qp)
            cap = entropy.capacity_words(n_mbs, 1024)
        return encode_gop_jit(
            y, cb, cr, base_qp,
            search=cfg.search, rc=cfg.rc, block_words=bw,
            cap_words=cap, target_bits=cfg.target_bits_per_frame(),
            fmt=cfg.format_version, cqpo=cfg.chroma_qp_offset,
            qbias=cfg.quant_bias, vbv_bits=cfg.vbv_bits(),
            qmat=cfg.quant_matrix, islice=cfg.intra_slice_mbrows,
            emit=self.emit,
        )

    def encode_gop_start(
        self, frames: list[Frame], first_index: int, base_qp: int | None = None
    ):
        """Upload a GOP and launch the device program WITHOUT blocking.

        JAX dispatch is async, so the returned handle lets the host overlap
        the next GOP's file read + upload with this GOP's device compute
        (SURVEY.md §2.1 PP row: "host-side async dispatch pipeline").
        Finish with encode_gop_finish(handle)."""
        cfg = self.cfg
        base_qp = cfg.base_qp if base_qp is None else base_qp
        t0 = time.perf_counter()
        y = jnp.asarray(np.stack([f.y for f in frames]).astype(np.uint8))
        cb = jnp.asarray(np.stack([f.cb for f in frames]).astype(np.uint8))
        cr = jnp.asarray(np.stack([f.cr for f in frames]).astype(np.uint8))
        outs = self._run(y, cb, cr, base_qp, xl=False)
        return dict(
            frames=frames, first_index=first_index, base_qp=base_qp,
            y=y, cb=cb, cr=cr, outs=outs, t0=t0,
        )

    def encode_gop_finish(
        self, handle
    ) -> tuple[list[FramePacket], list[FrameStats]]:
        frames = handle["frames"]
        first_index = handle["first_index"]
        t0 = handle["t0"]
        outs = handle["outs"]
        if bool(outs["ovf"].any()):
            outs = self._run(
                handle["y"], handle["cb"], handle["cr"], handle["base_qp"], xl=True
            )

        bits = np.asarray(outs["bits"])
        qps = np.asarray(outs["qp"])
        n_inter = np.asarray(outs["n_inter"])
        sse = np.asarray(outs["sse"])
        chunked = "cbits" in outs
        if chunked:
            cbits = np.asarray(outs["cbits"])      # [T, C]
            maxw = int((cbits.max() + 31) // 32) if cbits.size else 0
            bw = min(_bucket(max(maxw, 1)), outs["words"].shape[2])
            words_u8 = jax.lax.bitcast_convert_type(
                outs["words"][:, :, :bw], jnp.uint8
            )
            words_u32 = np.ascontiguousarray(
                np.asarray(words_u8)).view(np.uint32)[..., 0]  # [T, C, bw]
        else:
            # one bucketed slice + uint8-bitcast download for the whole GOP
            maxw = int(bits.max() + 31) // 32 if len(bits) else 0
            bw = min(_bucket(max(maxw, 1)), outs["words"].shape[1])
            words_u8 = jax.lax.bitcast_convert_type(
                outs["words"][:, :bw], jnp.uint8
            )
            words_host = np.ascontiguousarray(np.asarray(words_u8))
        ms_total = (time.perf_counter() - t0) * 1e3

        packets, stats = [], []
        n_mbs = (frames[0].y.shape[0] // spec.MB) * (frames[0].y.shape[1] // spec.MB)
        npix_y = frames[0].y.size
        npix_c = frames[0].cb.size
        from ..parallel.tiles import bit_concat
        for t in range(len(frames)):
            if chunked:
                payload, nbits = bit_concat(
                    [(words_u32[t, c], int(cbits[t, c]))
                     for c in range(cbits.shape[1]) if cbits[t, c]]
                )
                assert nbits == int(bits[t])
            else:
                nw = (int(bits[t]) + 31) // 32
                payload = (
                    words_host[t, :nw].view(np.uint32).byteswap().tobytes()
                )
            ftype = 0 if t == 0 else 1
            packets.append(
                FramePacket(first_index + t, ftype, int(qps[t]), int(bits[t]), payload)
            )
            def _psnr(s, n):
                return float(10 * np.log10(255.0**2 * n / s)) if s > 0 else float("inf")
            stats.append(
                FrameStats(
                    index=first_index + t,
                    frame_type=ftype,
                    base_qp=int(qps[t]),
                    bits=int(bits[t]),
                    psnr_y=_psnr(sse[t, 0], npix_y),
                    psnr_cb=_psnr(sse[t, 1], npix_c),
                    psnr_cr=_psnr(sse[t, 2], npix_c),
                    ms=ms_total / len(frames),
                    n_intra_mb=n_mbs - int(n_inter[t]) if ftype else n_mbs,
                    n_inter_mb=int(n_inter[t]) if ftype else 0,
                )
            )
        return packets, stats

    def encode_gop(
        self, frames: list[Frame], first_index: int, base_qp: int | None = None
    ) -> tuple[list[FramePacket], list[FrameStats]]:
        """Synchronous upload+encode+download of one GOP."""
        return self.encode_gop_finish(
            self.encode_gop_start(frames, first_index, base_qp)
        )

    # ---- batched-GOP path: G equal-length GOPs in one device program ----

    def _run_batch(self, y, cb, cr, base_qps, xl: bool):
        cfg = self.cfg
        n_mbs = (y.shape[2] // spec.MB) * (y.shape[3] // spec.MB)
        if xl:
            bw = entropy.BLOCK_WORDS_MAX
            cap = entropy.max_words(n_mbs)
        else:
            bw = _block_words_for_qp(int(np.min(base_qps)))
            cap = entropy.capacity_words(n_mbs, 1024)
        return encode_gop_batch_jit(
            y, cb, cr, jnp.asarray(base_qps, jnp.int32),
            search=cfg.search, rc=cfg.rc, block_words=bw,
            cap_words=cap, target_bits=cfg.target_bits_per_frame(),
            fmt=cfg.format_version, cqpo=cfg.chroma_qp_offset,
            qbias=cfg.quant_bias, vbv_bits=cfg.vbv_bits(),
            qmat=cfg.quant_matrix, islice=cfg.intra_slice_mbrows,
            emit=self.emit,
        )

    def encode_gops_start(
        self,
        gops: list[list[Frame]],
        first_indices: list[int],
        base_qps: list[int] | None = None,
    ):
        """Upload G equal-length GOPs and launch ONE lockstep device program
        (encode_gop_batch_jit) without blocking. Streams are byte-identical
        to per-GOP encodes."""
        cfg = self.cfg
        t = len(gops[0])
        assert all(len(g) == t for g in gops), "batched GOPs must be equal length"
        if base_qps is None:
            base_qps = [cfg.base_qp] * len(gops)
        t0 = time.perf_counter()
        y = jnp.asarray(
            np.stack([np.stack([f.y for f in g]) for g in gops]).astype(np.uint8)
        )
        cb = jnp.asarray(
            np.stack([np.stack([f.cb for f in g]) for g in gops]).astype(np.uint8)
        )
        cr = jnp.asarray(
            np.stack([np.stack([f.cr for f in g]) for g in gops]).astype(np.uint8)
        )
        outs = self._run_batch(y, cb, cr, base_qps, xl=False)
        return dict(
            gops=gops, first_indices=first_indices, base_qps=base_qps,
            y=y, cb=cb, cr=cr, outs=outs, t0=t0,
        )

    def encode_gops_finish(
        self, handle
    ) -> list[tuple[list[FramePacket], list[FrameStats]]]:
        """Per-GOP (packets, stats), in the order given to encode_gops_start."""
        gops = handle["gops"]
        first_indices = handle["first_indices"]
        outs = handle["outs"]
        if bool(np.asarray(outs["ovf"]).any()):
            outs = self._run_batch(
                handle["y"], handle["cb"], handle["cr"], handle["base_qps"],
                xl=True,
            )

        bits = np.asarray(outs["bits"])        # [T, G]
        qps = np.asarray(outs["qp"])
        n_inter = np.asarray(outs["n_inter"])
        sse = np.asarray(outs["sse"])          # [T, G, 3]
        chunked = "cbits" in outs
        if chunked:
            cbits = np.asarray(outs["cbits"])  # [T, G, C]
            maxw = int((cbits.max() + 31) // 32) if cbits.size else 0
            bw = min(_bucket(max(maxw, 1)), outs["words"].shape[3])
            words_u8 = jax.lax.bitcast_convert_type(
                outs["words"][:, :, :, :bw], jnp.uint8
            )
            words_u32 = np.ascontiguousarray(
                np.asarray(words_u8)).view(np.uint32)[..., 0]
        else:
            maxw = int(bits.max() + 31) // 32 if bits.size else 0
            bw = min(_bucket(max(maxw, 1)), outs["words"].shape[2])
            words_u8 = jax.lax.bitcast_convert_type(
                outs["words"][:, :, :bw], jnp.uint8
            )
            words_host = np.ascontiguousarray(np.asarray(words_u8))
        ms_total = (time.perf_counter() - handle["t0"]) * 1e3
        n_frames_total = sum(len(g) for g in gops)

        results = []
        f0 = gops[0][0]
        n_mbs = (f0.y.shape[0] // spec.MB) * (f0.y.shape[1] // spec.MB)
        npix_y, npix_c = f0.y.size, f0.cb.size
        from ..parallel.tiles import bit_concat
        for gi, (frames, first_index) in enumerate(zip(gops, first_indices)):
            packets, stats = [], []
            for t in range(len(frames)):
                if chunked:
                    payload, nbits = bit_concat(
                        [(words_u32[t, gi, c], int(cbits[t, gi, c]))
                         for c in range(cbits.shape[2]) if cbits[t, gi, c]]
                    )
                    assert nbits == int(bits[t, gi])
                else:
                    nw = (int(bits[t, gi]) + 31) // 32
                    payload = (
                        words_host[t, gi, :nw].view(np.uint32)
                        .byteswap().tobytes()
                    )
                ftype = 0 if t == 0 else 1
                packets.append(
                    FramePacket(first_index + t, ftype, int(qps[t, gi]),
                                int(bits[t, gi]), payload)
                )
                def _psnr(s, n):
                    return float(10 * np.log10(255.0**2 * n / s)) if s > 0 else float("inf")
                stats.append(
                    FrameStats(
                        index=first_index + t,
                        frame_type=ftype,
                        base_qp=int(qps[t, gi]),
                        bits=int(bits[t, gi]),
                        psnr_y=_psnr(sse[t, gi, 0], npix_y),
                        psnr_cb=_psnr(sse[t, gi, 1], npix_c),
                        psnr_cr=_psnr(sse[t, gi, 2], npix_c),
                        ms=ms_total / n_frames_total,
                        n_intra_mb=n_mbs - int(n_inter[t, gi]) if ftype else n_mbs,
                        n_inter_mb=int(n_inter[t, gi]) if ftype else 0,
                    )
                )
            results.append((packets, stats))
        return results

    def encode_gops(
        self,
        gops: list[list[Frame]],
        first_indices: list[int],
        base_qps: list[int] | None = None,
    ) -> list[tuple[list[FramePacket], list[FrameStats]]]:
        """Synchronous batched encode of G equal-length GOPs."""
        return self.encode_gops_finish(
            self.encode_gops_start(gops, first_indices, base_qps)
        )
