"""Temporal ring pipeline — the sequence-parallel analogue (SURVEY.md §2.1
SP/ring-attention row; [B:5] "reference frames ... exchanged via ppermute").

The P-frame chain frame t -> t+1 is serial, so a single GOP cannot be
frame-parallel; but D independent streams can share D devices in a rotating
schedule: at micro-step m, device d encodes frame m of stream
(d - m) mod D, then `ppermute`s its reconstruction to device d+1, which
encodes frame m+1 of the same stream at the next step. Every device is busy
every step and each reconstruction crosses exactly one ICI hop — the direct
analogue of ring-attention's neighbor exchange.

Bitstreams are byte-identical to per-stream single-device encodes (tested),
because nothing but the schedule changes: the ring hop carries BOTH the
reconstruction and the stream's rate-control state (qp, vbv fullness), so
rc="bitrate"/"vbv" streams follow the exact single-device RC trajectory.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from ..codec import entropy, spec
from ..codec.bitstream import FramePacket
from ..codec.golden import Frame
from ..ops import motion
from ..pipeline.gop_engine import (_block_words_for_qp, code_pack_traced,
                                   predict_i_traced, predict_p_traced,
                                   rc_carry_step)


@functools.partial(
    jax.jit,
    static_argnames=("mesh", "search", "rc", "block_words", "cap_words",
                     "fmt", "cqpo", "qbias", "target_bits", "vbv_bits",
                     "qmat", "islice"),
)
def encode_ring_jit(
    y_u8, cb_u8, cr_u8, base_qp,
    *, mesh, search, rc, block_words, cap_words, fmt: int = 1, cqpo: int = 0,
    qbias: int = 8, target_bits: int = 0, vbv_bits: int = 0,
    qmat: bool = False, islice: int = 0,
):
    """y_u8: [T, D, H, W] uint8 pre-rotated so that xs[m] on device d is
    frame m of stream (d - m) mod D. Outputs words/bits in the same rotated
    layout; the host derotates."""

    def per_device(y, cb, cr):
        # local shapes [T, 1, H, W] — squeeze the device axis
        y = y[:, 0]
        cb = cb[:, 0]
        cr = cr[:, 0]

        def body(carry, xs):
            ref_y, ref_cb, ref_cr, qp, fullness = carry
            cur_y = xs["y"].astype(jnp.int32)
            cur_cb = xs["cb"].astype(jnp.int32)
            cur_cr = xs["cr"].astype(jnp.int32)
            # like the GOP scan (gop_engine.encode_gop_jit): the I/P cond
            # wraps ONLY the prediction stage; code+pack run unconditionally
            # with a traced is_p, so the pack compiles once, outside any
            # cond branch
            dc, icost = motion.intra_cost_and_dc(cur_y)
            nby, nbx = icost.shape
            dy, dx, is_inter, pred_y, pred_cb, pred_cr = jax.lax.cond(
                xs["m"] > 0,
                lambda: predict_p_traced(
                    cur_y, ref_y, ref_cb, ref_cr, icost,
                    search=search, fmt=fmt),
                lambda: predict_i_traced(cur_y, cur_cb, cur_cr, nby, nbx),
            )
            out = code_pack_traced(
                cur_y, cur_cb, cur_cr, pred_y, pred_cb, pred_cr,
                dy, dx, is_inter, xs["m"] > 0, qp, icost,
                rc=rc, block_words=block_words, cap_words=cap_words,
                fmt=fmt, cqpo=cqpo, qbias=qbias, qmat=qmat, islice=islice,
            )
            qp_used = qp
            qp, fullness = rc_carry_step(
                rc, target_bits, vbv_bits, qp, fullness, out["bits"]
            )
            # ring hop: my stream's recon AND its RC state move to the next
            # device, which encodes that stream's next frame at the next
            # micro-step — identical single-device RC trajectory by
            # construction (gop_engine.rc_carry_step is the same function).
            n = jax.lax.axis_size("ring")
            perm = [(i, (i + 1) % n) for i in range(n)]
            nref_y = jax.lax.ppermute(out["rec_y"], "ring", perm)
            nref_cb = jax.lax.ppermute(out["rec_cb"], "ring", perm)
            nref_cr = jax.lax.ppermute(out["rec_cr"], "ring", perm)
            nqp = jax.lax.ppermute(qp, "ring", perm)
            nfull = jax.lax.ppermute(fullness, "ring", perm)
            return (nref_y, nref_cb, nref_cr, nqp, nfull), dict(
                words=out["words"], bits=out["bits"], ovf=out["ovf"],
                qp=qp_used,
            )

        t = y.shape[0]
        init = (
            jnp.zeros(y.shape[1:], jnp.int32),
            jnp.zeros(cb.shape[1:], jnp.int32),
            jnp.zeros(cr.shape[1:], jnp.int32),
            jnp.asarray(base_qp, jnp.int32),
            jnp.asarray(spec.vbv_init(vbv_bits), jnp.int32),
        )
        xs = dict(y=y, cb=cb, cr=cr, m=jnp.arange(t, dtype=jnp.int32))
        _, outs = jax.lax.scan(body, init, xs)
        return jax.tree.map(lambda a: a[:, None], outs)  # restore device axis

    sh = P(None, "ring", None, None)
    return shard_map(
        per_device,
        mesh=mesh,
        in_specs=(sh, sh, sh),
        out_specs=dict(words=P(None, "ring"), bits=P(None, "ring"),
                       ovf=P(None, "ring"), qp=P(None, "ring")),
        check_vma=False,
    )(y_u8, cb_u8, cr_u8)


class RingEncoder:
    """Host driver: D equal-length streams of T frames, one ring pass."""

    def __init__(self, cfg, mesh: Mesh):
        self.cfg = cfg
        self.mesh = mesh
        self.d = mesh.shape["ring"]

    def encode_streams(
        self, streams: list[list[Frame]], first_indices: list[int]
    ) -> list[list[FramePacket]]:
        """streams: up to D streams of any (nonzero) lengths.

        Drain/fill generalization: shorter streams are padded with repeats
        of their last frame up to the longest length, and missing streams
        with a dummy stream; padded slots ride the ring like real work but
        their packets are dropped on the host. Per-stream outputs stay
        byte-identical to a single-device encode because streams are
        independent and padding follows each stream's real frames (RC state
        only flows forward within a stream)."""
        cfg = self.cfg
        d = self.d
        if not 0 < len(streams) <= d:
            raise ValueError(
                f"need 1..{d} streams for a {d}-device ring, got {len(streams)}"
            )
        real_t = [len(s) for s in streams]
        n_real = len(streams)
        t = max(real_t)
        streams = [s + [s[-1]] * (t - len(s)) for s in streams]
        while len(streams) < d:
            streams.append([streams[0][0]] * t)
            first_indices = list(first_indices) + [0]
        h, w = streams[0][0].y.shape
        n_mbs = (h // spec.MB) * (w // spec.MB)

        # rotate: xs[m, dev] = stream (dev - m) % d, frame m
        y = np.zeros((t, d, h, w), np.uint8)
        cb = np.zeros((t, d, h // 2, w // 2), np.uint8)
        cr = np.zeros((t, d, h // 2, w // 2), np.uint8)
        for m in range(t):
            for dev in range(d):
                s = (dev - m) % d
                y[m, dev] = streams[s][m].y
                cb[m, dev] = streams[s][m].cb
                cr[m, dev] = streams[s][m].cr

        def run(xl: bool):
            # budgeted capacities first (the same block-word budget + exact
            # overflow detection + worst-case rerun contract as GopEngine)
            if xl:
                bw, cap = entropy.BLOCK_WORDS_MAX, entropy.max_words(n_mbs)
            else:
                bw = _block_words_for_qp(cfg.base_qp)
                cap = entropy.capacity_words(n_mbs, 1024)
            return encode_ring_jit(
                jnp.asarray(y), jnp.asarray(cb), jnp.asarray(cr), cfg.base_qp,
                mesh=self.mesh, search=cfg.search, rc=cfg.rc,
                block_words=bw, cap_words=cap,
                fmt=cfg.format_version, cqpo=cfg.chroma_qp_offset,
                islice=cfg.intra_slice_mbrows,
                qbias=cfg.quant_bias, target_bits=cfg.target_bits_per_frame(),
                qmat=cfg.quant_matrix,
                vbv_bits=cfg.vbv_bits(),
            )

        outs = run(xl=False)
        if bool(np.asarray(outs["ovf"]).any()):
            outs = run(xl=True)  # bit-exact worst-case rerun
        if bool(np.asarray(outs["ovf"]).any()):
            raise RuntimeError(
                "ring encode overflowed worst-case payload capacity "
                "(corrupt input or internal bug)"
            )
        bits = np.asarray(outs["bits"])      # [T, D]
        words = np.asarray(outs["words"])    # [T, D, cap]
        qps = np.asarray(outs["qp"])         # [T, D]

        packets: list[list[FramePacket]] = [[] for _ in range(n_real)]
        for m in range(t):
            for dev in range(d):
                s = (dev - m) % d
                if s >= n_real or m >= real_t[s]:
                    continue  # padded slot: drop
                nw = (int(bits[m, dev]) + 31) // 32
                payload = words[m, dev, :nw].astype(">u4").tobytes()
                packets[s].append(
                    FramePacket(
                        first_indices[s] + m, 0 if m == 0 else 1,
                        int(qps[m, dev]), int(bits[m, dev]), payload,
                    )
                )
        return packets
