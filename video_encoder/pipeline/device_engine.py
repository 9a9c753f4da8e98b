"""Device (jnp/XLA) per-frame encode engine (the GOP-resident
pipeline/gop_engine.py is the production path).

One jitted XLA program per (geometry, frame type): ME → MC → transform →
quant → zigzag → recon → parallel entropy pack, all on device (SURVEY.md
§3.1–3.2 stages fused into a single XLA program; the reference's pthread
stage boundaries become nothing at all on-device, per SURVEY.md §2.1 "PP"
row). The host only fetches the packed payload words and wraps headers.

Bit-exact with the golden numpy engine (same SPEC.md formulas, integer
arithmetic only) — tests assert byte-identical streams on the CPU, on
fake-device meshes, and on the accelerator.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..codec import entropy, spec
from ..codec.config import EncoderConfig
from ..codec.golden import Frame, FrameEncodeResult
from ..ops import motion, transform as tx


def assemble_blocks(yb, cbb, crb):
    """Luma 8×8 grid [2nby,2nbx,8,8] + chroma [nby,nbx,8,8] → [nby,nbx,6,8,8]."""
    return jnp.stack(
        [yb[0::2, 0::2], yb[0::2, 1::2], yb[1::2, 0::2], yb[1::2, 1::2], cbb, crb],
        axis=2,
    )


def scatter_blocks(blocks6):
    """Inverse of assemble_blocks."""
    nby, nbx = blocks6.shape[:2]
    yb = jnp.zeros((2 * nby, 2 * nbx, 8, 8), blocks6.dtype)
    yb = yb.at[0::2, 0::2].set(blocks6[:, :, 0])
    yb = yb.at[0::2, 1::2].set(blocks6[:, :, 1])
    yb = yb.at[1::2, 0::2].set(blocks6[:, :, 2])
    yb = yb.at[1::2, 1::2].set(blocks6[:, :, 3])
    return yb, blocks6[:, :, 4], blocks6[:, :, 5]


def encode_frame_device(
    cur_y, cur_cb, cur_cr, ref_y, ref_cb, ref_cr, base_qp,
    *, is_p: bool, search: str, rc: str, n_words: int, qbias: int = 8,
):
    """The full per-frame encode as one traceable function (int32 in/out).

    Returns dict of device arrays; see DeviceEngine.encode for host glue.
    """
    dc, icost = motion.intra_cost_and_dc(cur_y)
    nby, nbx = icost.shape

    if is_p:
        if search == "full":
            dy, dx, best_sad = motion.full_search(cur_y, ref_y)
        elif search == "diamond":
            dy, dx, best_sad = motion.diamond_search(cur_y, ref_y)
        else:  # hier: golden/oracle-only
            raise ValueError(f"search={search!r} is not a device-engine mode")
        is_inter = best_sad <= icost  # ties → inter (SPEC.md §9)
    else:
        dy = jnp.zeros((nby, nbx), jnp.int32)
        dx = jnp.zeros((nby, nbx), jnp.int32)
        is_inter = jnp.zeros((nby, nbx), jnp.bool_)

    if rc == "adaptive":
        qp_mb = motion.adaptive_qp(base_qp, icost)
    else:
        qp_mb = jnp.full((nby, nbx), base_qp, jnp.int32)

    # predictors (SPEC.md §2)
    m = is_inter[:, :, None, None]
    if is_p:
        refpad_y = motion.pad_ref(ref_y, spec.SEARCH_R)
        refpad_cb = motion.pad_ref(ref_cb, spec.BLK)
        refpad_cr = motion.pad_ref(ref_cr, spec.BLK)
        cdy, cdx = dy >> 1, dx >> 1
        pred_y = jnp.where(
            m, motion.mc_fetch(refpad_y, dy, dx, spec.MB, spec.SEARCH_R), 128
        )
        pred_cb = jnp.where(m, motion.mc_fetch(refpad_cb, cdy, cdx, spec.BLK, spec.BLK), 128)
        pred_cr = jnp.where(m, motion.mc_fetch(refpad_cr, cdy, cdx, spec.BLK, spec.BLK), 128)
    else:
        pred_y = jnp.full((nby, nbx, spec.MB, spec.MB), 128, jnp.int32)
        pred_cb = jnp.full((nby, nbx, spec.BLK, spec.BLK), 128, jnp.int32)
        pred_cr = jnp.full((nby, nbx, spec.BLK, spec.BLK), 128, jnp.int32)

    # residual → transform → quant → zigzag (C8–C11)
    cur_yb = tx.blockify(cur_y, spec.MB)
    resid_y8 = tx.blockify(tx.unblockify(cur_yb - pred_y), spec.BLK)
    resid_cb = tx.blockify(cur_cb, spec.BLK) - pred_cb
    resid_cr = tx.blockify(cur_cr, spec.BLK) - pred_cr
    blocks6 = assemble_blocks(resid_y8, resid_cb, resid_cr)

    q = tx.qstep(qp_mb)[:, :, None, None, None]
    coefs = tx.forward_transform(blocks6)
    levels = tx.quantize(coefs, q, qbias)
    levels_zz = tx.zigzag(levels)

    # reconstruction loop (C14) — shared formulas with the decoder
    deq = tx.dequantize(tx.unzigzag(levels_zz), q)
    resid_rec = tx.inverse_transform(deq)
    yb, cbb, crb = scatter_blocks(resid_rec)
    rec_y = jnp.clip(tx.unblockify(yb) + tx.unblockify(pred_y), 0, 255)
    rec_cb = jnp.clip(tx.unblockify(cbb) + tx.unblockify(pred_cb), 0, 255)
    rec_cr = jnp.clip(tx.unblockify(crb) + tx.unblockify(pred_cr), 0, 255)

    # entropy pack (C12, two-pass parallel)
    values, lengths = entropy.mb_symbols(
        levels_zz, qp_mb - base_qp, jnp.asarray(is_p), is_inter, dy, dx
    )
    words, total_bits = entropy.pack_bits(values, lengths, n_words)

    return dict(
        words=words,
        payload_bits=total_bits,
        rec_y=rec_y.astype(jnp.int32),
        rec_cb=rec_cb.astype(jnp.int32),
        rec_cr=rec_cr.astype(jnp.int32),
        n_inter=is_inter.sum().astype(jnp.int32),
        mb_bits=entropy.mb_bit_counts(lengths),
    )


class DeviceEngine:
    """Engine adapter: numpy Frames in, FrameEncodeResult out, XLA inside.

    Drop-in replacement for pipeline.encoder.GoldenEngine; jit cache is
    keyed on (geometry, frame type, search, rc).
    """

    def __init__(self, device=None):
        self._device = device

    @functools.lru_cache(maxsize=16)
    def _compiled(self, shape, is_p: bool, search: str, rc: str, qbias: int = 8):
        hp, wp = shape
        n_mbs = (hp // spec.MB) * (wp // spec.MB)
        n_words = entropy.max_words(n_mbs)
        fn = functools.partial(
            encode_frame_device, is_p=is_p, search=search, rc=rc,
            n_words=n_words, qbias=qbias,
        )
        return jax.jit(fn)

    def encode(
        self, cfg: EncoderConfig, cur: Frame, ref: Frame | None, frame_type: int, base_qp: int
    ) -> FrameEncodeResult:
        is_p = frame_type == 1
        shape = cur.y.shape
        fn = self._compiled(shape, is_p, cfg.search, cfg.rc,
                            cfg.quant_bias)
        if ref is None:
            ref = cur  # unused by the I-frame path; keeps signatures uniform
        out = fn(
            jnp.asarray(cur.y, jnp.int32),
            jnp.asarray(cur.cb, jnp.int32),
            jnp.asarray(cur.cr, jnp.int32),
            jnp.asarray(ref.y, jnp.int32),
            jnp.asarray(ref.cb, jnp.int32),
            jnp.asarray(ref.cr, jnp.int32),
            jnp.int32(base_qp),
        )
        payload_bits = int(out["payload_bits"])
        nw = (payload_bits + 31) // 32
        payload = np.asarray(out["words"][:nw]).astype(">u4").tobytes()
        n_mbs = (shape[0] // spec.MB) * (shape[1] // spec.MB)
        n_inter = int(out["n_inter"])
        return FrameEncodeResult(
            payload=payload,
            payload_bits=payload_bits,
            recon=Frame(
                np.asarray(out["rec_y"]),
                np.asarray(out["rec_cb"]),
                np.asarray(out["rec_cr"]),
            ),
            mb_bits=np.asarray(out["mb_bits"]),
            n_intra=n_mbs - n_inter if is_p else n_mbs,
            n_inter=n_inter if is_p else 0,
        )
