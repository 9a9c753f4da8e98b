"""Device (jnp) motion estimation + compensation (SPEC.md §9; reference
components C5–C8, SURVEY.md §2).

Full search is a lax.scan over the 1089 candidate offsets with an
incremental first-occurrence argmin (memory-light: no [1089, nMB] cost
volume materialized); diamond search is the SPMD masked fixed-budget loop of
SPEC.md §9.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..codec import spec
from .transform import blockify

R = spec.SEARCH_R
BIG = 1 << 30


def pad_ref(plane: jnp.ndarray, r: int) -> jnp.ndarray:
    return jnp.pad(plane, r, mode="edge")


def _mb_sums(x: jnp.ndarray, n: int) -> jnp.ndarray:
    """Per-n×n-block sums of a [H, W] array → [H//n, W//n] (int32)."""
    return blockify(x, n).sum(axis=(2, 3))


def full_search(cur_y: jnp.ndarray, ref_y: jnp.ndarray):
    """Exhaustive ±16 SAD search. Returns (dy, dx, best_sad) per MB.

    Candidate order row-major (dy, dx); strict-< update keeps the first
    minimum, matching golden.sad_full_search / SPEC.md §9.
    """
    return full_search_padded(cur_y, pad_ref(ref_y, R))


def full_search_padded(cur_y: jnp.ndarray, refpad: jnp.ndarray):
    """full_search against a reference already extended by R on every
    side (edge-replicated, or carrying a tile shard's halo)."""
    h, w = cur_y.shape

    def step(carry, k):
        best_sad, best_k = carry
        dy, dx = k // (2 * R + 1), k % (2 * R + 1)
        shifted = jax.lax.dynamic_slice(refpad, (dy, dx), (h, w))
        sad = _mb_sums(jnp.abs(cur_y - shifted), spec.MB)
        better = sad < best_sad
        return (jnp.where(better, sad, best_sad), jnp.where(better, k, best_k)), None

    nby, nbx = h // spec.MB, w // spec.MB
    init = (jnp.full((nby, nbx), BIG, jnp.int32), jnp.zeros((nby, nbx), jnp.int32))
    (best_sad, best_k), _ = jax.lax.scan(step, init, jnp.arange(spec.N_CAND, dtype=jnp.int32))
    dy = best_k // (2 * R + 1) - R
    dx = best_k % (2 * R + 1) - R
    return dy, dx, best_sad


def mc_fetch(refpad: jnp.ndarray, dy: jnp.ndarray, dx: jnp.ndarray, bs: int, r: int):
    """Per-MB predictor gather [nby, nbx, bs, bs] (C8), refpad padded by r."""
    nby, nbx = dy.shape
    my = jnp.arange(nby)[:, None, None, None] * bs
    mx = jnp.arange(nbx)[None, :, None, None] * bs
    ii = jnp.arange(bs)[None, None, :, None]
    jj = jnp.arange(bs)[None, None, None, :]
    rows = r + my + dy[:, :, None, None] + ii
    cols = r + mx + dx[:, :, None, None] + jj
    return refpad[rows, cols]


def sad_at(cur_blocks: jnp.ndarray, refpad: jnp.ndarray, dy, dx):
    """SAD per MB at per-MB mv; cur_blocks = blockify(cur_y, 16)."""
    pred = mc_fetch(refpad, dy, dx, spec.MB, R)
    return jnp.abs(cur_blocks - pred).sum(axis=(2, 3))


def diamond_search(cur_y: jnp.ndarray, ref_y: jnp.ndarray):
    """Masked fixed-budget diamond search (SPEC.md §9), bit-exact with
    golden.sad_diamond_search (early-exit becomes early-freeze)."""
    refpad = pad_ref(ref_y, R)
    cur_blocks = blockify(cur_y, spec.MB)

    def sad_fn(dy, dx):
        return sad_at(cur_blocks, refpad, dy, dx)

    h, w = cur_y.shape
    nby, nbx = h // spec.MB, w // spec.MB

    dy = jnp.zeros((nby, nbx), jnp.int32)
    dx = jnp.zeros((nby, nbx), jnp.int32)
    cost = sad_fn(dy, dx)
    frozen = cost < spec.DIAMOND_EARLY_SAD

    def evaluate(dy, dx, cost, frozen, offsets):
        ndy = jnp.stack([dy + ody for ody, _ in offsets])
        ndx = jnp.stack([dx + odx for _, odx in offsets])
        valid = (jnp.abs(ndy) <= R) & (jnp.abs(ndx) <= R)
        cdy, cdx = jnp.clip(ndy, -R, R), jnp.clip(ndx, -R, R)
        cs = jnp.stack([sad_fn(cdy[i], cdx[i]) for i in range(len(offsets))])
        cc = jnp.concatenate([cost[None], jnp.where(valid, cs, BIG)])
        cand_dy = jnp.concatenate([dy[None], ndy])
        cand_dx = jnp.concatenate([dx[None], ndx])
        widx = jnp.argmin(cc, axis=0)  # first occurrence == candidate order
        wdy = jnp.take_along_axis(cand_dy, widx[None], 0)[0]
        wdx = jnp.take_along_axis(cand_dx, widx[None], 0)[0]
        wcost = jnp.take_along_axis(cc, widx[None], 0)[0]
        ndy = jnp.where(frozen, dy, wdy)
        ndx = jnp.where(frozen, dx, wdx)
        ncost = jnp.where(frozen, cost, wcost)
        moved = (widx != 0) & ~frozen
        return ndy, ndx, ncost, moved

    large = ((-2, 0), (0, -2), (0, 2), (2, 0))
    small = ((-1, 0), (0, -1), (0, 1), (1, 0))

    def cond(state):
        # a step where every MB is frozen is the identity, so stopping at
        # all-frozen is bit-exact with the fixed-budget loop
        step, _, _, _, frozen = state
        return (step < spec.DIAMOND_MAX_STEPS) & ~jnp.all(frozen)

    def body(state):
        step, dy, dx, cost, frozen = state
        dy, dx, cost, moved = evaluate(dy, dx, cost, frozen, large)
        frozen = frozen | ~moved | (cost < spec.DIAMOND_EARLY_SAD)
        return step + 1, dy, dx, cost, frozen

    _, dy, dx, cost, frozen = jax.lax.while_loop(
        cond, body, (jnp.int32(0), dy, dx, cost, frozen)
    )
    dy, dx, cost, _ = evaluate(dy, dx, cost, jnp.zeros_like(frozen), small)
    return dy, dx, cost


# spec.down2 is pure reshape/sum/shift, so it traces as-is: one normative
# implementation of the (a+b+c+d+2)>>2 rule serves numpy and jnp callers.
down2 = spec.down2


def hier_coarse(cur_y: jnp.ndarray, ref_y: jnp.ndarray):
    """Coarse stage of the hier search (SPEC.md §9): ±HIER_COARSE_R full
    SAD search of each MB's 4×4 block on the 4x-downsampled planes,
    row-major first-min, scaled ×4. Returns (cdy, cdx) per MB."""
    cq = down2(down2(cur_y))
    rq = down2(down2(ref_y))
    rc = spec.HIER_COARSE_R
    nd = 2 * rc + 1
    rqpad = pad_ref(rq, rc)
    hq, wq = cq.shape

    keys = []
    for k in range(nd * nd):
        shifted = jax.lax.slice(
            rqpad, (k // nd, k % nd), (k // nd + hq, k % nd + wq)
        )
        sad = _mb_sums(jnp.abs(cq - shifted), 4)  # each MB's 4x4 block
        # sad <= 4080; 128 > nd*nd: packed-key min == first-min
        keys.append(sad * 128 + k)
    best = jnp.min(jnp.stack(keys), axis=0)
    k = best & 127
    return (k // nd - rc) * 4, (k % nd - rc) * 4


def hier_search(cur_y: jnp.ndarray, ref_y: jnp.ndarray):
    """Hierarchical search (SPEC.md §9 "hier"), bit-exact with
    golden.sad_hier_search: coarse quarter-res full search, then
    HIER_REFINE_STEPS chained ±HIER_REFINE_R full-res refinements."""
    cdy, cdx = hier_coarse(cur_y, ref_y)
    cur_blocks = blockify(cur_y, spec.MB)
    refpad = pad_ref(ref_y, R)

    rr = spec.HIER_REFINE_R
    nd = 2 * rr + 1
    dy, dx = cdy, cdx
    sad = None
    offs = jnp.arange(-rr, rr + 1, dtype=jnp.int32)
    for _ in range(spec.HIER_REFINE_STEPS):
        # candidates in row-major (u, v) order: argmin's first-occurrence
        # tie-break then matches golden.sad_hier_search exactly
        ndy = dy[None] + jnp.repeat(offs, nd)[:, None, None]
        ndx = dx[None] + jnp.tile(offs, nd)[:, None, None]
        valid = (jnp.abs(ndy) <= R) & (jnp.abs(ndx) <= R)
        cdy_c = jnp.clip(ndy, -R, R)
        cdx_c = jnp.clip(ndx, -R, R)
        cc = jnp.stack([
            sad_at(cur_blocks, refpad, cdy_c[k], cdx_c[k])
            for k in range(nd * nd)
        ])
        cc = jnp.where(valid, cc, BIG)
        widx = jnp.argmin(cc, axis=0)
        dy = jnp.take_along_axis(ndy, widx[None], 0)[0]
        dx = jnp.take_along_axis(ndx, widx[None], 0)[0]
        sad = jnp.take_along_axis(cc, widx[None], 0)[0]
    return dy, dx, sad


def intra_cost_and_dc(cur_y: jnp.ndarray):
    """Per-MB DC and SAD-vs-DC (SPEC.md §9/§10), as two-stage axis
    reductions (rows in groups, then columns in groups): no 16x16-block
    transpose, and integer addition is associative, so the values equal
    the blockify sums exactly."""
    h, w = cur_y.shape
    nby, nbx = h // spec.MB, w // spec.MB

    def mb_sums(p):
        rows = p.reshape(nby, spec.MB, w).sum(axis=1)        # [nby, W]
        return rows.reshape(nby, nbx, spec.MB).sum(axis=2)   # [nby, nbx]

    dc = (mb_sums(cur_y) + 128) >> 8
    dc_px = jnp.repeat(jnp.repeat(dc, spec.MB, 0), spec.MB, 1)
    cost = mb_sums(jnp.abs(cur_y - dc_px))
    return dc, cost


def adaptive_qp(base_qp, act):
    """rc=adaptive per-MB QP (SPEC.md §10); bitlen via 32 - clz."""
    blen = jnp.where(act > 0, 32 - jax.lax.clz(act.astype(jnp.int32)), 0)
    return jnp.clip(base_qp + (blen - 10), spec.QP_MIN, spec.QP_MAX).astype(jnp.int32)


def hpel_planes(p: jnp.ndarray):
    """SPEC.md §14.2 parity planes (H, V, D) on the plane grid — jnp twin
    of golden.hpel_planes, +1 reads edge-clamped."""
    b = jnp.concatenate([p[:, 1:], p[:, -1:]], axis=1)   # p[y, x+1]
    c = jnp.concatenate([p[1:, :], p[-1:, :]], axis=0)   # p[y+1, x]
    d = jnp.concatenate([b[1:, :], b[-1:, :]], axis=0)   # p[y+1, x+1]
    return (p + b + 1) >> 1, (p + c + 1) >> 1, (p + b + c + d + 2) >> 2
