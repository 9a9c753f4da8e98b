"""Clip-level decoder drivers (reference component C16, SURVEY.md §3.3):
demux → entropy decode → reconstruction per frame → raw YUV out.

Three engines, all bit-identical (SPEC.md §11):
- GoldenDecodeEngine: pure-python reference (slow; tests / tiny clips).
- DeviceDecodeEngine: host C++ entropy parse (codec/native.py) + on-device
  reconstruction (unzigzag→dequant→ITX→MC→clip as one jitted program) —
  the decode mirror of the encode split "host does bytes, device does math".
- native decode_clip_native: whole decode in C++ (fastest host-only path).
"""

from __future__ import annotations

import functools
from typing import BinaryIO, Iterator

import numpy as np

from ..codec import bitstream, spec
from ..codec.golden import Frame, decode_frame


class GoldenDecodeEngine:
    def __init__(self, version: int = 1, chroma_qp_offset: int = 0,
                 quant_matrix: bool = False, intra_slice: int = 0):
        self.version = version
        self.chroma_qp_offset = chroma_qp_offset
        self.quant_matrix = quant_matrix
        self.intra_slice = intra_slice

    def decode(self, width, height, pkt: bitstream.FramePacket, ref: Frame | None) -> Frame:
        return decode_frame(
            width, height, pkt.frame_type, pkt.base_qp, pkt.payload,
            pkt.payload_bits, ref, self.version, self.chroma_qp_offset,
            self.quant_matrix, self.intra_slice,
        )


class DeviceDecodeEngine:
    """C++ entropy parse on host, reconstruction on device (C14 shared math)."""

    def __init__(self, version: int = 1, chroma_qp_offset: int = 0,
                 quant_matrix: bool = False, intra_slice: int = 0):
        from ..codec import native

        self._native = native
        self.version = version
        self.chroma_qp_offset = chroma_qp_offset
        self.quant_matrix = quant_matrix
        self.intra_slice = intra_slice
        # materialize module-level jnp constants eagerly, outside any trace
        from ..ops import transform as _tx  # noqa: F401
        from .device_engine import scatter_blocks  # noqa: F401

    @staticmethod
    @functools.partial(
        __import__("jax").jit,
        static_argnames=("is_p", "fmt", "cqpo", "qmat", "islice"),
    )
    def _recon(levels_zz, dy, dx, is_inter, qp_mb, ref_y, ref_cb, ref_cr,
               *, is_p, fmt=1, cqpo=0, qmat=False, islice=0):
        # imports resolved at module scope (importing inside the trace would
        # turn the modules' jnp table constants into leaked tracers)
        import jax.numpy as jnp

        from ..ops import dispatch
        from ..ops import transform as tx
        from .device_engine import scatter_blocks

        nby, nbx = qp_mb.shape
        qs = tx.qstep(qp_mb)
        qc = qs if (fmt < 2 or cqpo == 0) else tx.qstep(
            jnp.clip(qp_mb + cqpo, spec.QP_MIN, spec.QP_MAX)
        )

        if not is_p and fmt >= 3:
            # v3 I-frame: vertical-intra row recon (SPEC.md §13.1)
            lv6 = tx.unzigzag(levels_zz)  # [nby, nbx, 6, 8, 8]
            yb, cbb, crb = scatter_blocks(lv6)
            qs_y = tx.qsteps_pos(jnp.repeat(jnp.repeat(qs, 2, 0), 2, 1), qmat)
            qs_c = tx.qsteps_pos(qc, qmat)
            rec_y = tx.intra_rows_recon_plane(yb, qs_y, 2 * islice)
            rec_cb = tx.intra_rows_recon_plane(cbb, qs_c, islice)
            rec_cr = tx.intra_rows_recon_plane(crb, qs_c, islice)
            return rec_y, rec_cb, rec_cr

        if is_p:
            m_y = jnp.repeat(jnp.repeat(is_inter, spec.MB, 0), spec.MB, 1)
            m_c = jnp.repeat(jnp.repeat(is_inter, spec.BLK, 0), spec.BLK, 1)
            cdy, cdx = dy >> 1, dx >> 1
            if fmt >= 4:  # half-pel mvs (SPEC.md §14)
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
        else:
            pred_y = jnp.full_like(ref_y, 128)
            pred_cb = jnp.full_like(ref_cb, 128)
            pred_cr = jnp.full_like(ref_cr, 128)

        q6 = jnp.stack([qs, qs, qs, qs, qc, qc], axis=2)  # [nby, nbx, 6]
        q = tx.qsteps_pos(q6, qmat) if qmat else q6[..., None, None]
        deq = tx.dequantize(tx.unzigzag(levels_zz), q)
        resid = tx.inverse_transform(deq)
        yb, cbb, crb = scatter_blocks(resid)
        rec_y = jnp.clip(tx.unblockify(yb) + pred_y, 0, 255)
        rec_cb = jnp.clip(tx.unblockify(cbb) + pred_cb, 0, 255)
        rec_cr = jnp.clip(tx.unblockify(crb) + pred_cr, 0, 255)
        return rec_y, rec_cb, rec_cr

    def decode(self, width, height, pkt: bitstream.FramePacket, ref: Frame | None) -> Frame:
        import jax.numpy as jnp

        hp, wp = spec.ceil_to(height, spec.MB), spec.ceil_to(width, spec.MB)
        nby, nbx = hp // spec.MB, wp // spec.MB
        is_p = pkt.frame_type == 1
        levels, dy, dx, inter, qps = self._native.parse_frame(
            pkt.payload, pkt.payload_bits, is_p, pkt.base_qp, nby, nbx,
            version=self.version, cqpo=self.chroma_qp_offset,
        )
        if ref is None:
            ref = Frame(
                np.zeros((hp, wp), np.int32),
                np.zeros((hp // 2, wp // 2), np.int32),
                np.zeros((hp // 2, wp // 2), np.int32),
            )
        ry, rcb, rcr = self._recon(
            jnp.asarray(levels), jnp.asarray(dy), jnp.asarray(dx),
            jnp.asarray(inter), jnp.asarray(qps),
            jnp.asarray(ref.y, jnp.int32), jnp.asarray(ref.cb, jnp.int32),
            jnp.asarray(ref.cr, jnp.int32), is_p=is_p, fmt=self.version,
            cqpo=self.chroma_qp_offset, qmat=self.quant_matrix,
            islice=self.intra_slice,
        )
        return Frame(np.asarray(ry), np.asarray(rcb), np.asarray(rcr))


def _decode_gop_jit():
    """Build the jitted whole-GOP device decoder (lazy: keeps jax out of the
    golden/native import path)."""
    import functools as _ft

    import jax
    import jax.numpy as jnp

    from ..ops import dispatch
    from ..ops import transform as tx

    @functools.partial(jax.jit, static_argnames=("cqpo", "fmt", "qmat", "islice"))
    def decode_gop(ly, lcb, lcr, dy, dx, inter, qp, cqpo=0, fmt=1, qmat=False,
                   islice=0):
        """Reconstruct a [T, ...] GOP on device in one lax.scan program —
        the decode mirror of gop_engine.encode_gop_jit. Frame 0 is the I
        frame (its `inter` mask is all-False, so the MC path is masked off
        and no real reference is needed — except v3, whose I frame runs the
        vertical-intra row recon of SPEC.md §13.1); later frames chain
        through the carried reconstruction, bit-exact with the encoder.

        ly: [T, 2nby, 2nbx, 64] int16; lcb/lcr: [T, nby, nbx, 64] int16;
        dy/dx/qp: [T, nby, nbx] int32; inter: [T, nby, nbx] bool.
        Returns uint8 planes ([T,H,W], [T,H/2,W/2] x2).
        """
        t_frames, by8, bx8, _ = ly.shape
        hp, wp = by8 * 8, bx8 * 8

        def recon_plane(lz, pred, q_blk):
            q = tx.qsteps_pos(q_blk, qmat)
            deq = tx.dequantize(tx.unzigzag(lz), q)
            rec = tx.unblockify(tx.inverse_transform(deq)) + pred
            return jnp.clip(rec, 0, 255)

        def recon_frame_v3_intra(xs, qy, qc):
            rec_y = tx.intra_rows_recon_plane(
                tx.unzigzag(xs["ly"].astype(jnp.int32)),
                tx.qsteps_pos(qy, qmat), 2 * islice,
            )
            rec_cb = tx.intra_rows_recon_plane(
                tx.unzigzag(xs["lcb"].astype(jnp.int32)),
                tx.qsteps_pos(qc, qmat), islice,
            )
            rec_cr = tx.intra_rows_recon_plane(
                tx.unzigzag(xs["lcr"].astype(jnp.int32)),
                tx.qsteps_pos(qc, qmat), islice,
            )
            return rec_y, rec_cb, rec_cr

        def body(carry, xs):
            ref_y, ref_cb, ref_cr = carry
            dy_f, dx_f, inter_f, qp_f = xs["dy"], xs["dx"], xs["inter"], xs["qp"]
            m_y = jnp.repeat(jnp.repeat(inter_f, spec.MB, 0), spec.MB, 1)
            m_c = jnp.repeat(jnp.repeat(inter_f, spec.BLK, 0), spec.BLK, 1)
            if fmt >= 4:  # half-pel mvs (SPEC.md §14)
                pred_y = jnp.where(
                    m_y, dispatch.mc_fetch_luma_plane_hpel(ref_y, dy_f, dx_f),
                    128,
                )
                pred_cb = jnp.where(
                    m_c, dispatch.mc_fetch_chroma_plane_hpel(
                        ref_cb, dy_f >> 1, dx_f >> 1), 128,
                )
                pred_cr = jnp.where(
                    m_c, dispatch.mc_fetch_chroma_plane_hpel(
                        ref_cr, dy_f >> 1, dx_f >> 1), 128,
                )
            else:
                pred_y = jnp.where(
                    m_y, dispatch.mc_fetch_luma_plane(ref_y, dy_f, dx_f), 128
                )
                pred_cb = jnp.where(
                    m_c, dispatch.mc_fetch_chroma_plane(ref_cb, dy_f >> 1, dx_f >> 1), 128
                )
                pred_cr = jnp.where(
                    m_c, dispatch.mc_fetch_chroma_plane(ref_cr, dy_f >> 1, dx_f >> 1), 128
                )
            qs = tx.qstep(qp_f)
            qy = jnp.repeat(jnp.repeat(qs, 2, 0), 2, 1)
            qc = qs if cqpo == 0 else tx.qstep(
                jnp.clip(qp_f + cqpo, spec.QP_MIN, spec.QP_MAX)
            )
            if fmt >= 3:
                # v3: only frame 0 (the GOP's I frame) takes the intra path;
                # P frames never do (their intra MBs stay flat-128)
                rec_y, rec_cb, rec_cr = jax.lax.cond(
                    xs["i"] > 0,
                    lambda: (
                        recon_plane(xs["ly"].astype(jnp.int32), pred_y, qy),
                        recon_plane(xs["lcb"].astype(jnp.int32), pred_cb, qc),
                        recon_plane(xs["lcr"].astype(jnp.int32), pred_cr, qc),
                    ),
                    lambda: recon_frame_v3_intra(xs, qy, qc),
                )
            else:
                rec_y = recon_plane(xs["ly"].astype(jnp.int32), pred_y, qy)
                rec_cb = recon_plane(xs["lcb"].astype(jnp.int32), pred_cb, qc)
                rec_cr = recon_plane(xs["lcr"].astype(jnp.int32), pred_cr, qc)
            out = (
                rec_y.astype(jnp.uint8),
                rec_cb.astype(jnp.uint8),
                rec_cr.astype(jnp.uint8),
            )
            return (rec_y, rec_cb, rec_cr), out

        init = (
            jnp.zeros((hp, wp), jnp.int32),
            jnp.zeros((hp // 2, wp // 2), jnp.int32),
            jnp.zeros((hp // 2, wp // 2), jnp.int32),
        )
        xs = dict(ly=ly, lcb=lcb, lcr=lcr, dy=dy, dx=dx, inter=inter, qp=qp,
                  i=jnp.arange(t_frames, dtype=jnp.int32))
        _, outs = jax.lax.scan(body, init, xs)
        return outs

    return decode_gop


class GopDecodeEngine:
    """Whole-GOP device decode: C++ entropy parse per frame on the host
    (int16 per-plane layout, half the upload), then ONE jitted lax.scan
    program reconstructs the entire GOP on device — no per-frame host
    round-trips (the decode mirror of GopEngine)."""

    def __init__(self, version: int = 1, chroma_qp_offset: int = 0,
                 quant_matrix: bool = False, intra_slice: int = 0):
        from ..codec import native

        self._native = native
        native._load()
        self._jit = _decode_gop_jit()
        self.version = version
        self.chroma_qp_offset = chroma_qp_offset
        self.quant_matrix = quant_matrix
        self.intra_slice = intra_slice

    def decode_gop(self, width: int, height: int, packets) -> list[Frame]:
        """packets: one GOP (first packet is the I frame)."""
        import jax.numpy as jnp

        hp, wp = spec.ceil_to(height, spec.MB), spec.ceil_to(width, spec.MB)
        nby, nbx = hp // spec.MB, wp // spec.MB
        ly, lcb, lcr, dy, dx, inter, qps = self._native.parse_gop_planes(
            [p.payload for p in packets],
            [p.payload_bits for p in packets],
            [p.frame_type == 1 for p in packets],
            [p.base_qp for p in packets],
            nby, nbx, version=self.version,
        )
        ry, rcb, rcr = self._jit(
            jnp.asarray(ly), jnp.asarray(lcb), jnp.asarray(lcr),
            jnp.asarray(dy), jnp.asarray(dx), jnp.asarray(inter),
            jnp.asarray(qps), cqpo=self.chroma_qp_offset, fmt=self.version,
            qmat=self.quant_matrix, islice=self.intra_slice,
        )
        ry = np.asarray(ry).astype(np.int32)
        rcb = np.asarray(rcb).astype(np.int32)
        rcr = np.asarray(rcr).astype(np.int32)
        return [Frame(ry[t], rcb[t], rcr[t]) for t in range(len(packets))]


def decode_clip_gop(
    f: BinaryIO, engine: "GopDecodeEngine | None" = None
) -> tuple[bitstream.StreamInfo, Iterator[tuple[np.ndarray, np.ndarray, np.ndarray]]]:
    """Decode a TVC1 stream GOP-at-a-time on device (GopDecodeEngine)."""
    info, packets = bitstream.demux(f)
    if engine is None:
        engine = GopDecodeEngine(info.version, info.chroma_qp_offset,
                                 info.quant_matrix, info.intra_slice_mbrows)
    else:
        engine.version = info.version
        engine.chroma_qp_offset = info.chroma_qp_offset
        engine.quant_matrix = info.quant_matrix
        engine.intra_slice = info.intra_slice_mbrows

    def frames():
        gop: list = []
        for pkt in packets:
            if pkt.frame_type == 0 and gop:
                for rec in engine.decode_gop(info.width, info.height, gop):
                    yield rec.crop(info.width, info.height)
                gop = []
            gop.append(pkt)
        if gop:
            for rec in engine.decode_gop(info.width, info.height, gop):
                yield rec.crop(info.width, info.height)

    return info, frames()


def decode_clip(
    f: BinaryIO, engine=None
) -> tuple[bitstream.StreamInfo, Iterator[tuple[np.ndarray, np.ndarray, np.ndarray]]]:
    """Decode a TVC1 stream → (info, iterator of cropped (y, cb, cr))."""
    info, packets = bitstream.demux(f)
    if engine is None:
        engine = GoldenDecodeEngine(info.version, info.chroma_qp_offset,
                                    info.quant_matrix, info.intra_slice_mbrows)
    elif getattr(engine, "version", None) is not None:
        engine.version = info.version
        engine.chroma_qp_offset = info.chroma_qp_offset
        engine.quant_matrix = info.quant_matrix
        if hasattr(engine, "intra_slice"):
            engine.intra_slice = info.intra_slice_mbrows

    def frames():
        ref: Frame | None = None
        for pkt in packets:
            if pkt.frame_type == 0:
                ref = None  # GOP boundary: I frames never reference
            rec = engine.decode(info.width, info.height, pkt, ref)
            ref = rec
            yield rec.crop(info.width, info.height)

    return info, frames()


def decode_clip_native(f: BinaryIO):
    """Whole-stream decode in C++ → (info, iterator of (y, cb, cr))."""
    from ..codec import native

    data = f.read()
    import io

    info = bitstream.read_stream_header(io.BytesIO(data))
    frames_flat = native.decode_stream(data, info.width, info.height, info.frame_count)

    def frames():
        from ..io import yuv

        for i in range(info.frame_count):
            yield yuv.split_i420(frames_flat[i].tobytes(), info.width, info.height)

    return info, frames()


def _substream_header(info: bitstream.StreamInfo, n_frames: int) -> bytes:
    """Stream header bytes for a GOP sub-stream: the clip's header with the
    frame count replaced (GOPs are closed under prediction — SURVEY.md
    §3.2 — so a GOP's packets form a valid standalone stream)."""
    import struct

    hdr = struct.pack(
        bitstream.STREAM_HEADER_FMT, bitstream.MAGIC, info.version,
        info.flags, info.width, info.height, info.gop_n, info.base_qp,
        info.search_mode, n_frames, info.config_hash,
    )
    if info.version >= 3:
        hdr += struct.pack("<I", info.intra_slice_mbrows & 0xFFFF)
    return hdr


def decode_clip_parallel(f: BinaryIO, workers: int = 0):
    """GOP-parallel native decode (reference decode driver scaled out —
    r4 verdict missing #3): the demuxed GOPs are independent sub-streams,
    so each is decoded whole by the C++ decoder on its own worker THREAD
    (ctypes releases the GIL for the duration of the native call, so
    threads scale across cores without pickling ~frame-sized results
    through process pipes). Frames are yielded strictly in order.

    workers=0 picks min(cpu_count, number of GOPs). Byte-identical to
    decode_clip_native (tests/test_parallel_decode.py); fps scaling is
    measured in tools/decode_scaling.py."""
    import os
    from concurrent.futures import ThreadPoolExecutor

    from ..codec import native

    data = f.read()
    import io

    info = bitstream.read_stream_header(io.BytesIO(data))
    _, packets = bitstream.demux(io.BytesIO(data))

    gops: list[list[bitstream.FramePacket]] = []
    for pkt in packets:
        if pkt.frame_type == 0 or not gops:
            gops.append([])
        gops[-1].append(pkt)

    native._load()  # load once before the pool (dlopen is not re-entrant)
    nw = workers or min(os.cpu_count() or 1, max(len(gops), 1))

    def decode_gop(gop):
        sub = _substream_header(info, len(gop)) + b"".join(
            p.to_bytes() for p in gop
        )
        return native.decode_stream(sub, info.width, info.height, len(gop))

    def frames():
        from ..io import yuv

        with ThreadPoolExecutor(max_workers=nw) as pool:
            futs = [pool.submit(decode_gop, g) for g in gops]
            for fut in futs:  # submit order == frame order
                flat = fut.result()
                for row in flat:
                    yield yuv.split_i420(row.tobytes(), info.width,
                                         info.height)

    return info, frames()
