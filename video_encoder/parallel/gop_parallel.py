"""GOP-parallel multi-chip encode (BASELINE.json config 4; SURVEY.md §2.1
DP row): independent GOPs sharded over the 'gop' mesh axis, zero inter-chip
data during encode, `psum` only for global bit-count stats (the rate-control
aggregate of SURVEY.md §5), ordered host mux reconciling frame order
([B:10] "mux in frame order").

The N-chip bitstream equals the 1-chip bitstream byte-for-byte after the
mux (SPEC.md §11 invariant 2) because RC state is GOP-local (SPEC.md §10).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import PartitionSpec as P
from jax import shard_map

from ..codec import entropy, spec
from ..codec.bitstream import FramePacket
from ..codec.config import EncoderConfig
from ..codec.golden import Frame
from .mesh import make_codec_mesh
from .tiles import shard_mb_rows
from ..pipeline.gop_engine import encode_gop_jit, _bucket, _block_words_for_qp


@functools.partial(
    jax.jit,
    static_argnames=(
        "mesh", "search", "rc", "block_words", "cap_words", "target_bits",
        "fmt", "cqpo", "qbias", "vbv_bits", "qmat", "islice",
    ),
)
def encode_gop_batch_sharded(
    y_u8, cb_u8, cr_u8, base_qp,
    *, mesh, search, rc, block_words, cap_words, target_bits,
    fmt: int = 1, cqpo: int = 0, qbias: int = 8, vbv_bits: int = 0,
    qmat: bool = False, islice: int = 0,
):
    """Encode [G, T, ...] uint8 GOP batch, G sharded over the 'gop' axis.

    Each device runs the full GOP-resident scan on its local GOPs
    (lax.map over the local batch); a psum of total bits rides the mesh as
    the global RC/stats aggregate.
    """
    kw = dict(
        search=search, rc=rc, block_words=block_words,
        cap_words=cap_words, target_bits=target_bits, fmt=fmt, cqpo=cqpo,
        qbias=qbias, vbv_bits=vbv_bits, qmat=qmat, islice=islice,
    )

    def per_device(y, cb, cr):
        def one(args):
            yy, bb, rr = args
            return encode_gop_jit(yy, bb, rr, base_qp, **kw)

        outs = jax.lax.map(one, (y, cb, cr))
        total_bits = jax.lax.psum(outs["bits"].sum(), "gop")
        return outs, total_bits

    spec_in = P("gop")
    outs, total = shard_map(
        per_device,
        mesh=mesh,
        in_specs=(spec_in, spec_in, spec_in),
        out_specs=(
            dict(
                words=P("gop"), bits=P("gop"), ovf=P("gop"),
                n_inter=P("gop"), qp=P("gop"), sse=P("gop"),
            ),
            P(),
        ),
        check_vma=False,
    )(y_u8, cb_u8, cr_u8)
    return outs, total


class ShardedGopEncoder:
    """Host driver: groups GOPs into device-count batches, encodes them in
    parallel, emits FramePackets for the ordered mux (C13).

    With a 2-D mesh (tile axis > 1) the fused program shards the GOP batch
    over 'gop' AND each frame's MB rows over 'tile' in one shard_map
    (parallel/tiles.encode_gop_batch_2d); frame payloads are restored by
    bit-concatenating the tile shards in order."""

    def __init__(self, cfg: EncoderConfig, mesh=None):
        self.cfg = cfg
        self.mesh = mesh or make_codec_mesh(tile_devices=1)
        self.n_gop_devices = self.mesh.shape["gop"]
        self.n_tile_devices = self.mesh.shape.get("tile", 1)

    def encode_gop_batch(
        self, gops: list[list[Frame]], first_indices: list[int], base_qp: int | None = None
    ) -> list[FramePacket]:
        """gops: equal-length GOPs, len(gops) divisible by gop devices."""
        cfg = self.cfg
        base_qp = cfg.base_qp if base_qp is None else base_qp
        y = jnp.asarray(np.stack([[f.y for f in g] for g in gops]).astype(np.uint8))
        cb = jnp.asarray(np.stack([[f.cb for f in g] for g in gops]).astype(np.uint8))
        cr = jnp.asarray(np.stack([[f.cr for f in g] for g in gops]).astype(np.uint8))
        ntile = self.n_tile_devices
        n_mbs = (y.shape[3] // spec.MB) * (
            shard_mb_rows(y.shape[2] // spec.MB, ntile))

        def run(xl: bool):
            if xl:
                bw = entropy.BLOCK_WORDS_MAX
                cap = entropy.max_words(n_mbs)
            else:
                bw = _block_words_for_qp(base_qp)
                cap = entropy.capacity_words(n_mbs, 1024)
            kw = dict(
                mesh=self.mesh, rc=cfg.rc, block_words=bw, cap_words=cap,
                target_bits=cfg.target_bits_per_frame(),
                fmt=cfg.format_version, cqpo=cfg.chroma_qp_offset,
                qbias=cfg.quant_bias, vbv_bits=cfg.vbv_bits(),
                qmat=cfg.quant_matrix, islice=cfg.intra_slice_mbrows,
            )
            if ntile > 1:
                from .tiles import encode_gop_batch_2d

                # tile path uses the haloed full search (cfg.search other
                # than "full" is rejected by the caller contract) and the
                # span-string pack; the host glue below bit_concats spans
                # across the tile axis in order
                return encode_gop_batch_2d(
                    y, cb, cr, base_qp, emit="chunks", **kw), None
            return encode_gop_batch_sharded(
                y, cb, cr, base_qp, search=cfg.search, **kw
            )

        outs, _ = run(False)
        if bool(np.asarray(outs["ovf"]).any()):
            outs, _ = run(True)

        if ntile > 1:
            from .tiles import bit_concat

            bits = np.asarray(outs["bits"])   # [G, S, T, C] span bits
            qps = np.asarray(outs["qp"])      # [G, S, T]
            words = np.asarray(outs["words"])  # [G, S, T, C, cw]
            packets = []
            for g in range(len(gops)):
                for t in range(len(gops[g])):
                    payload, nbits = bit_concat(
                        [(words[g, s, t, c], int(bits[g, s, t, c]))
                         for s in range(ntile)
                         for c in range(bits.shape[3])
                         if bits[g, s, t, c]]
                    )
                    packets.append(
                        FramePacket(
                            first_indices[g] + t, 0 if t == 0 else 1,
                            int(qps[g, 0, t]), nbits, payload,
                        )
                    )
            return packets

        bits = np.asarray(outs["bits"])      # [G, T]
        qps = np.asarray(outs["qp"])
        maxw = (int(bits.max()) + 31) // 32 if bits.size else 1
        bw = min(_bucket(max(maxw, 1)), outs["words"].shape[2])
        words_host = np.ascontiguousarray(
            np.asarray(jax.lax.bitcast_convert_type(outs["words"][:, :, :bw], jnp.uint8))
        )

        packets = []
        for g in range(len(gops)):
            for t in range(len(gops[g])):
                nw = (int(bits[g, t]) + 31) // 32
                payload = words_host[g, t, :nw].view(np.uint32).byteswap().tobytes()
                packets.append(
                    FramePacket(
                        first_indices[g] + t,
                        0 if t == 0 else 1,
                        int(qps[g, t]),
                        int(bits[g, t]),
                        payload,
                    )
                )
        return packets
