"""Headline benchmark: 1080p 4:2:0 encode frames/s on one GPU.

Measures the steady-state device-resident GOP encode rate at GOP=30
(full-search ME; one XLA program per GOP, span-string emit as GopEngine
runs it). Aux rows report the GOP=8 variant and an upload-inclusive rate
with the double-buffered dispatch the CLI uses. Every device rate is taken
around work that ends in jax.block_until_ready.

vs_baseline: ratio against the C++ oracle encoder (oracle/, same spec,
single core, same operating point), measured on this host in the same run.

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline", "device", ...}.
Refuses to run without a GPU.
"""

import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np


def synth_clip(t, h, w, seed=0):
    """Realistic-ish content: smoothed texture background, global pan,
    a moving high-detail patch, mild noise."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 256, (h + 128, w + 128)).astype(np.int32)
    for _ in range(2):
        base = (
            base
            + np.roll(base, 1, 0)
            + np.roll(base, 1, 1)
            + np.roll(base, 2, 0)
            + np.roll(base, 2, 1)
        ) // 5
    ys, cbs, crs = [], [], []
    for k in range(t):
        oy, ox = (2 * k) % 128, (3 * k) % 128  # the pan wraps after 42 frames
        y = base[oy : oy + h, ox : ox + w].astype(np.int32)
        noise = rng.integers(-2, 3, y.shape)
        sq = rng.integers(0, 256, (64, 64))
        yy = y + noise
        px, py = (200 + 11 * k) % max(w - 64, 1), (300 + 7 * k) % max(h - 64, 1)
        yy[py : py + 64, px : px + 64] = sq
        ys.append(np.clip(yy, 0, 255).astype(np.uint8))
        cbs.append(np.full((h // 2, w // 2), 108 + k, np.uint8))
        crs.append(np.full((h // 2, w // 2), 148, np.uint8))
    return np.stack(ys), np.stack(cbs), np.stack(crs)


def oracle_baseline_fps(w, h, frames=16, tries=3):
    """Single-core C++ oracle encoder fps at the same resolution and
    operating point (GOP=30, qp 30, full search, rc none): >=16 frames,
    best of 3 runs, measured on this host."""
    import tempfile

    from video_encoder.codec import native

    root = os.path.dirname(os.path.abspath(__file__))
    odir = os.path.join(root, "oracle")
    native.build(odir, "oracle")
    y, cb, cr = synth_clip(frames, h, w, seed=1)
    per_try = []
    with tempfile.TemporaryDirectory(dir=root) as td:
        raw = os.path.join(td, "in.yuv")
        out = os.path.join(td, "out.tvc")
        with open(raw, "wb") as f:
            for k in range(frames):
                f.write(y[k].tobytes() + cb[k].tobytes() + cr[k].tobytes())
        for _ in range(tries):
            t0 = time.perf_counter()
            subprocess.run(
                [os.path.join(odir, "oracle"), "encode", raw, out, str(w),
                 str(h), "30", "30", "full", "none", "0"],
                capture_output=True, check=True,
            )
            per_try.append(frames / (time.perf_counter() - t0))
    return max(per_try)


def main():
    import jax
    import jax.numpy as jnp

    from video_encoder.codec import entropy, spec
    from video_encoder.pipeline.gop_engine import _block_words_for_qp, encode_gop_jit

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"bench: needs a GPU, JAX has {dev.platform}", file=sys.stderr)
        return 1
    H, W = 1080, 1920
    hp = spec.ceil_to(H, 16)
    n_mbs = (hp // 16) * (W // 16)
    kw = dict(
        search="full", rc="none", block_words=_block_words_for_qp(30),
        cap_words=entropy.capacity_words(n_mbs, 1024), target_bits=0,
        emit="chunks",
    )

    def device_fps(t, reps):
        """Steady-state device-resident rate at GOP length t: upload once,
        loop the GOP program, block until the last one is done."""
        y, cb, cr = synth_clip(t, hp, W)
        yd, cbd, crd = jnp.asarray(y), jnp.asarray(cb), jnp.asarray(cr)
        outs = encode_gop_jit(yd, cbd, crd, 30, **kw)
        if bool(np.asarray(outs["ovf"]).any()):
            raise RuntimeError("capacity overflow")
        t0 = time.perf_counter()
        for _ in range(reps):
            outs = encode_gop_jit(yd, cbd, crd, 30, **kw)
        jax.block_until_ready(outs)
        return t * reps / (time.perf_counter() - t0)

    def e2e_fps(t, n_gops=3):
        """Upload-inclusive clip shape with the async double buffer the CLI
        uses: GOP k's upload+dispatch overlaps GOP k-1's device compute."""
        gops = [synth_clip(t, hp, W, seed=s) for s in range(n_gops)]
        y, cb, cr = gops[0]
        jax.block_until_ready(encode_gop_jit(
            jnp.asarray(y), jnp.asarray(cb), jnp.asarray(cr), 30, **kw))
        t0 = time.perf_counter()
        pending = None
        for y, cb, cr in gops:
            outs = encode_gop_jit(
                jnp.asarray(y), jnp.asarray(cb), jnp.asarray(cr), 30, **kw
            )
            if pending is not None:
                jax.block_until_ready(pending)
            pending = outs
        jax.block_until_ready(pending)
        return n_gops * t / (time.perf_counter() - t0)

    fps30 = device_fps(30, 4)
    fps8 = device_fps(8, 5)
    fpse2e = e2e_fps(30)
    base = oracle_baseline_fps(W, H)
    print(
        json.dumps(
            {
                "metric": "1080p 4:2:0 device-resident encode fps (full-search ME, GOP=30 scan)",
                "value": round(fps30, 2),
                "unit": "frames/s",
                "vs_baseline": round(fps30 / base, 2),
                "baseline_fps": round(base, 3),
                "baseline_source": "cpp-oracle-1core, this host",
                "device": {"platform": dev.platform, "kind": dev.device_kind,
                           "count": len(jax.devices())},
                "aux": {
                    "gop8_fps": round(fps8, 2),
                    "e2e_upload_inclusive_fps": round(fpse2e, 2),
                },
            }
        )
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
