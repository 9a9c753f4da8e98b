"""TVC1 codec spec constants and integer primitives (numpy).

Single source of truth for every pinned table/formula in /root/repo/SPEC.md.
All implementations (numpy golden, jnp device path, C++ oracle) must match
these bit-exactly. Everything here is integer math — no floats anywhere in
the codec path (SURVEY.md §7.0: bit-exactness across CPU, accelerator and
device counts requires exactly-specified integer arithmetic).

Capability parity: reference components C9 (8x8 DCT), C10 (quant), C11
(zigzag) of SURVEY.md §2 (reference mount empty; spec is our own design).
"""

from __future__ import annotations

import numpy as np

# --------------------------------------------------------------------------
# Transform (SPEC.md §3): B = round(1024 * orthonormal DCT-II 8x8), pinned.
# --------------------------------------------------------------------------

B_MATRIX = np.array(
    [
        [362, 362, 362, 362, 362, 362, 362, 362],
        [502, 426, 284, 100, -100, -284, -426, -502],
        [473, 196, -196, -473, -473, -196, 196, 473],
        [426, -100, -502, -284, 284, 502, 100, -426],
        [362, -362, -362, 362, 362, -362, -362, 362],
        [284, -502, 100, 426, -426, -100, 502, -284],
        [196, -473, 473, -196, -196, 473, -473, 196],
        [100, -284, 426, -502, 502, -426, 284, -100],
    ],
    dtype=np.int32,
)

TX_SHIFT = 10  # both passes of forward and inverse

# --------------------------------------------------------------------------
# Quantizer step table (SPEC.md §4): QSTEP[qp] = max(1, floor(2^(qp/6)+0.5))
# --------------------------------------------------------------------------

QSTEP = np.array(
    [max(1, int(2.0 ** (qp / 6.0) + 0.5)) for qp in range(64)], dtype=np.int32
)

QP_MIN, QP_MAX = 1, 63

# --------------------------------------------------------------------------
# Zigzag (SPEC.md §5): ZIGZAG[k] = raster index of k-th scan position.
# --------------------------------------------------------------------------

ZIGZAG = np.array(
    # fmt: off
    [
         0,  1,  8, 16,  9,  2,  3, 10,
        17, 24, 32, 25, 18, 11,  4,  5,
        12, 19, 26, 33, 40, 48, 41, 34,
        27, 20, 13,  6,  7, 14, 21, 28,
        35, 42, 49, 56, 57, 50, 43, 36,
        29, 22, 15, 23, 30, 37, 44, 51,
        58, 59, 52, 45, 38, 31, 39, 46,
        53, 60, 61, 54, 47, 55, 62, 63,
    ],
    # fmt: on
    dtype=np.int32,
)

# Inverse: UNZIGZAG[raster] = scan position.
UNZIGZAG = np.zeros(64, dtype=np.int32)
UNZIGZAG[ZIGZAG] = np.arange(64, dtype=np.int32)

# --------------------------------------------------------------------------
# Geometry
# --------------------------------------------------------------------------

MB = 16          # luma macroblock size
BLK = 8          # transform block size
SEARCH_R = 16    # motion search radius (±16)
N_CAND = (2 * SEARCH_R + 1) ** 2  # 33*33 = 1089 full-search candidates
# hierarchical search (SPEC.md §9 "hier"): coarse full search over ±HIER_
# COARSE_R on the 4x-downsampled planes (covers the full ±16 at 1/4 scale),
# then HIER_REFINE_STEPS chained ±HIER_REFINE_R full-resolution refinements
# (each re-centered on the current winner; two steps absorb up to ±4 px of
# coarse-grid aliasing error).
HIER_COARSE_R = 4
HIER_REFINE_R = 2
HIER_REFINE_STEPS = 2
DIAMOND_MAX_STEPS = 16
DIAMOND_EARLY_SAD = 512

# Block offsets within an MB, spec order: Y00, Y08, Y80, Y88, Cb, Cr.
LUMA_BLOCK_OFFSETS = ((0, 0), (0, 8), (8, 0), (8, 8))


def rshift_round(v: np.ndarray, s: int) -> np.ndarray:
    """sign(v) * ((|v| + 2^(s-1)) >> s) — round half away from zero."""
    v = np.asarray(v)
    mag = (np.abs(v) + (1 << (s - 1))) >> s
    return np.where(v < 0, -mag, mag).astype(v.dtype)


def forward_transform(x: np.ndarray) -> np.ndarray:
    """ITX8 forward transform of int32 blocks shaped [..., 8, 8]."""
    x = x.astype(np.int64)  # headroom; values bounded so int32 is safe, but
    b = B_MATRIX.astype(np.int64)  # int64 avoids any numpy overflow warnings
    t1 = np.einsum("ij,...jk->...ik", b, x)
    t1r = rshift_round(t1, TX_SHIFT)
    t2 = np.einsum("...ij,kj->...ik", t1r, b)
    return rshift_round(t2, TX_SHIFT).astype(np.int32)


def inverse_transform(c: np.ndarray) -> np.ndarray:
    """ITX8 inverse transform of int32 coefficient blocks [..., 8, 8]."""
    c = c.astype(np.int64)
    b = B_MATRIX.astype(np.int64)
    u1 = np.einsum("ji,...jk->...ik", b, c)  # B^T · D
    u1r = rshift_round(u1, TX_SHIFT)
    u2 = np.einsum("...ij,jk->...ik", u1r, b)  # · B
    return rshift_round(u2, TX_SHIFT).astype(np.int32)


def quantize(c: np.ndarray, q: np.ndarray, bias16_ac: int = 8) -> np.ndarray:
    """level = sign(C) * ((16|C| + bias*q) // (16q)); q broadcastable to c.

    bias is per coefficient of the [..., 8, 8] block: 8 (midpoint rounding)
    for the DC coefficient [..., 0, 0], bias16_ac for the 63 ACs.
    bias16_ac=8 is the historical midpoint quantizer, bit-identical to
    sign(C)*((2|C|+q)//(2q)); smaller values open a deadzone that drops
    isolated small ACs (fewer run/level pairs) — an ENCODER-side choice:
    dequantization and the bitstream are unchanged, any decoder reads the
    result."""
    c = np.asarray(c, dtype=np.int64)
    q = np.asarray(q, dtype=np.int64)
    if bias16_ac == 8:  # midpoint: shape-agnostic (historical formula)
        mag = (2 * np.abs(c) + q) // (2 * q)
        return np.where(c < 0, -mag, mag).astype(np.int32)
    assert c.shape[-2:] == (8, 8), "deadzone bias needs [..., 8, 8] blocks"
    bias = np.full((8, 8), int(bias16_ac), dtype=np.int64)
    bias[0, 0] = 8
    mag = (16 * np.abs(c) + bias * q) // (16 * q)
    return np.where(c < 0, -mag, mag).astype(np.int32)


def dequantize(level: np.ndarray, q: np.ndarray) -> np.ndarray:
    return (level.astype(np.int64) * np.asarray(q, dtype=np.int64)).astype(np.int32)


# --------------------------------------------------------------------------
# Exp-Golomb (SPEC.md §6). Codes are (value, length) pairs, MSB-first.
# --------------------------------------------------------------------------


def ue_len(v: np.ndarray) -> np.ndarray:
    """Bit length of ue(v) = 2*floor(log2(v+1)) + 1. Vectorized."""
    v = np.asarray(v, dtype=np.int64)
    # floor(log2(v+1)) == bit_length(v+1) - 1
    k = bitlen(v + 1) - 1
    return (2 * k + 1).astype(np.int32)


def ue_val(v: np.ndarray) -> np.ndarray:
    """Code value of ue(v) = v + 1 (occupying ue_len(v) bits MSB-first)."""
    return (np.asarray(v, dtype=np.int64) + 1).astype(np.uint32)


def se_map(v: np.ndarray) -> np.ndarray:
    """Signed→unsigned map for se(v): v>0 → 2v-1, v<=0 → -2v."""
    v = np.asarray(v, dtype=np.int64)
    return np.where(v > 0, 2 * v - 1, -2 * v).astype(np.int64)


def bitlen(x: np.ndarray) -> np.ndarray:
    """floor(log2(x)) + 1 for x >= 1; 0 for x == 0. Vectorized, integer."""
    x = np.asarray(x, dtype=np.int64)
    out = np.zeros_like(x)
    cur = x.copy()
    for shift in (32, 16, 8, 4, 2, 1):
        big = cur >= (1 << shift)
        out = np.where(big, out + shift, out)
        cur = np.where(big, cur >> shift, cur)
    return out + (cur > 0)


# --------------------------------------------------------------------------
# Rate control (SPEC.md §10)
# --------------------------------------------------------------------------


def adaptive_qp(base_qp: np.ndarray, act: np.ndarray) -> np.ndarray:
    """rc=adaptive: qp_mb = clamp(base_qp + (bitlen(act) - 10), 1, 63)."""
    qp = np.asarray(base_qp, dtype=np.int64) + (bitlen(act) - 10)
    return np.clip(qp, QP_MIN, QP_MAX).astype(np.int32)


def bitrate_next_qp(qp: int, bits_spent: int, target_bits: int) -> int:
    """rc=bitrate frame-level update (GOP-local, SPEC.md §10)."""
    t = max(target_bits, 1)
    delta = ((bits_spent - target_bits) * 4) // t
    delta = max(-2, min(2, delta))
    return max(QP_MIN, min(QP_MAX, qp + delta))


def vbv_init(vbv_bits: int) -> int:
    """rc=vbv buffer fullness at a GOP start (half full; GOP-local so GOPs
    stay closed under the data-parallel sharding, SPEC.md §10)."""
    return vbv_bits // 2


def vbv_next(qp: int, fullness: int, bits_spent: int, target_bits: int,
             vbv_bits: int) -> tuple[int, int]:
    """rc=vbv frame-level update: the bitrate proportional term plus a
    buffer-pressure term. Exact integer arithmetic; the device scan
    (pipeline/gop_engine.py), the host loop (pipeline/encoder.py) and the
    C++ oracle implement this formula verbatim.

      fullness' = clip(fullness + target - bits, 0, vbv)
      delta     = clip((bits - target)*4 // target, -2, 2)
                  + (fullness' <  vbv/4)           # draining -> coarser
                  - (fullness' > 3*vbv/4)          # filling  -> finer
      qp'       = clip(qp + delta, QP_MIN, QP_MAX)
    """
    t = max(target_bits, 1)
    f = fullness + target_bits - bits_spent
    f = max(0, min(vbv_bits, f))
    delta = max(-2, min(2, ((bits_spent - target_bits) * 4) // t))
    if f < vbv_bits // 4:
        delta += 1
    if f > (3 * vbv_bits) // 4:
        delta -= 1
    return max(QP_MIN, min(QP_MAX, qp + delta)), f


# --------------------------------------------------------------------------
# Format v3 (SPEC.md §13): quant matrix + I-frame vertical intra prediction
# --------------------------------------------------------------------------

# §13.2 per-coefficient quantizer scale in 16ths (16 = unity). A gentle CSF
# ramp: step grows with spatial frequency, up to 2.75x at (7,7); DC stays
# unity so DPCM'd DC precision is unchanged.
QMAT = np.array(
    [[16 + 2 * (i + j) for j in range(8)] for i in range(8)], dtype=np.int64
)
QMAT[0, 0] = 16


def qsteps_pos(qstep, use_matrix: bool):
    """Per-position quantizer steps from per-block scalars.

    qstep: int array [...]; returns [..., 8, 8]:
      q[..., i, j] = max(1, (qstep * QMAT[i, j] + 8) >> 4)   (§13.2)
    or the flat broadcast [..., 1, 1] when the matrix is off."""
    qstep = np.asarray(qstep, dtype=np.int64)
    if not use_matrix:
        return qstep[..., None, None]
    return np.maximum(1, (qstep[..., None, None] * QMAT + 8) >> 4)


def intra_rows_recon_plane(
    levels: np.ndarray, qsteps: np.ndarray, reset_rows: int = 0
) -> np.ndarray:
    """§13.1 decoder-side recon of a v3 I-frame plane.

    levels: [h/8, w/8, 8, 8] quantized levels (raster block layout);
    qsteps: broadcastable per-block steps ([h/8, w/8, 1, 1] or [..., 8, 8]).
    Block row j predicts every pixel from the reconstructed pixel row
    directly above the block (128 above row 0); rows are sequential, all
    blocks within a row are independent.

    reset_rows > 0 (§13.3 "intra slices"): the predictor resets to 128 at
    every block row j with j % reset_rows == 0 — slices of reset_rows block
    rows are then independent by construction, which is what lets v3 frames
    tile-shard without any cross-shard sequential chain."""
    nrows, ncols = levels.shape[:2]
    w = ncols * BLK
    rec = np.zeros((nrows * BLK, w), dtype=np.int32)
    prev = np.full((w,), 128, dtype=np.int32)
    for j in range(nrows):
        if reset_rows and j % reset_rows == 0:
            prev = np.full((w,), 128, dtype=np.int32)
        resid = inverse_transform(dequantize(levels[j], qsteps[j]))
        pred = np.broadcast_to(prev[None, :], (BLK, w))
        r = np.clip(unblockify(resid[None])[0:BLK] + pred, 0, 255)
        rec[j * BLK : (j + 1) * BLK] = r
        prev = r[-1]
    return rec


def intra_rows_code_plane(
    cur: np.ndarray, qsteps: np.ndarray, qbias: int, reset_rows: int = 0
):
    """§13.1 encoder-side v3 I-frame plane coding (vertical intra).

    cur: [h, w] int32; qsteps: [h/8, w/8, 1, 1] or [h/8, w/8, 8, 8].
    Returns (levels [h/8, w/8, 8, 8], recon [h, w]) — recon identical to
    intra_rows_recon_plane(levels) by construction. reset_rows: §13.3
    intra-slice predictor reset (see intra_rows_recon_plane)."""
    h, w = cur.shape
    nrows = h // BLK
    levels = np.zeros((nrows, w // BLK, BLK, BLK), dtype=np.int32)
    rec = np.zeros((h, w), dtype=np.int32)
    prev = np.full((w,), 128, dtype=np.int32)
    for j in range(nrows):
        if reset_rows and j % reset_rows == 0:
            prev = np.full((w,), 128, dtype=np.int32)
        pred = np.broadcast_to(prev[None, :], (BLK, w))
        resid = blockify(cur[j * BLK : (j + 1) * BLK] - pred, BLK)[0]
        lv = quantize(forward_transform(resid), qsteps[j], qbias)
        levels[j] = lv
        r = np.clip(
            unblockify(inverse_transform(dequantize(lv, qsteps[j]))[None])[
                0:BLK
            ]
            + pred,
            0,
            255,
        )
        rec[j * BLK : (j + 1) * BLK] = r
        prev = r[-1]
    return levels, rec


def mb_rc_offsets(est: np.ndarray) -> np.ndarray:
    """rc=mb per-MB qp offsets (SPEC.md §10.4) — per-macroblock quantizer
    rate control with feedback from bits spent (BASELINE.json config 3).

    est[i, j]: pass-1 per-MB bit counts at the frame qp. Feedback is a
    ROW-LOCAL pace error — how far MB row i has overspent a uniform pace by
    the time it reaches MB j, in 1/1024ths of the row's own total:

        row_tot[i]   = max(sum_j est[i, j], 1)
        share[i, j]  = est[i, j] * 1024 // row_tot
        spent[i, j]  = sum_{k<j} share[i, k]       (exclusive prefix)
        plan[j]      = j * 1024 // nbx             (uniform pace)
        delta[i, j]  = clip((spent - plan) >> 7, -2, 2)

    delta hits +-1 at 12.5% of-row overspend, +-2 at 25%. Every quantity
    fits int32 at any resolution (share, spent, plan <= ~1024+nbx), so the
    numpy / jnp / C++ implementations are identical integer programs; >> is
    the arithmetic shift (== floor division by 128 for either sign). Row
    locality keeps tile (MB-row) sharded encodes byte-identical to
    single-device. qp_mb = clip(frame_qp + delta, QP_MIN, QP_MAX).
    """
    est = np.asarray(est, dtype=np.int64)
    nbx = est.shape[-1]
    row_tot = np.maximum(est.sum(axis=-1, keepdims=True), 1)
    share = est * 1024 // row_tot
    spent = np.cumsum(share, axis=-1) - share
    plan = (np.arange(nbx, dtype=np.int64) * 1024) // nbx
    return np.clip((spent - plan) >> 7, -2, 2).astype(np.int32)


# --------------------------------------------------------------------------
# Geometry helpers
# --------------------------------------------------------------------------


def ceil_to(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def pad_plane(plane: np.ndarray, mult: int) -> np.ndarray:
    """Edge-replicate pad a 2-D plane to multiples of `mult` (SPEC.md §1)."""
    h, w = plane.shape
    hp, wp = ceil_to(h, mult), ceil_to(w, mult)
    return np.pad(plane, ((0, hp - h), (0, wp - w)), mode="edge")


def pad_ref(plane: np.ndarray, r: int) -> np.ndarray:
    """Edge-replicate pad a reference plane by r on all sides (SPEC.md §2)."""
    return np.pad(plane, r, mode="edge")


def down2(plane: np.ndarray) -> np.ndarray:
    """2x2 box downsample, round half up: (a+b+c+d+2) >> 2 (SPEC.md §9,
    hier search). Dimensions must be even (MB-padded planes always are)."""
    h, w = plane.shape
    q = plane.reshape(h // 2, 2, w // 2, 2).sum(axis=(1, 3))
    return (q + 2) >> 2


def blockify(plane: np.ndarray, n: int) -> np.ndarray:
    """[H, W] -> [H//n, W//n, n, n]."""
    h, w = plane.shape
    return plane.reshape(h // n, n, w // n, n).transpose(0, 2, 1, 3)


def unblockify(blocks: np.ndarray) -> np.ndarray:
    """[by, bx, n, n] -> [by*n, bx*n]."""
    by, bx, n, _ = blocks.shape
    return blocks.transpose(0, 2, 1, 3).reshape(by * n, bx * n)
