#!/usr/bin/env python3
"""Smoke test of the production encode/decode path on one GPU.

    python3 chip_smoke.py                  # one card: every phase below
    python3 chip_smoke.py --cards 4        # four cards: the sharded path only

Content is a seeded synthetic clip (bench.synth_clip) written to disk as raw
I420 and run through the CLI entry point (video_encoder.cli.main) in this
one process, so only this process holds the card. Each .tvc must equal the
C++ oracle's stream byte for byte (oracle/oracle.cpp, an independent scalar
implementation of SPEC.md, run on the host in parallel with the device
work), and the device GOP decode (--engine gop) must equal the native C++
decode and the oracle's decode of the same stream.

Phases (one JSON line each, then the card's name and power limit, then the
result line):
  device   JAX version, devices, backend; fails unless the backend is gpu
  enc1080  1920x1080, 60 frames, --gop 30 --qp 30 (defaults otherwise)
  enc4k    3840x2160, 16 frames, --gop 8 --qp 30; PSNR-Y vs float64 numpy
  modes    1080p 16 frames: diamond + rc adaptive; v4 + rc mb 4000 kbps;
           v3 + quant matrix + intra slices of 17 MB rows
  lowqp    3840x2160, 8 frames, --gop 8 --qp 4 (worst-case block budget,
           largest transform coefficients)
  multi    (--cards 4 only) 4K 32 frames GOP 8 on one card (against the
           oracle), then with --devices 4 and with --devices 4 --tile 2
           (135 MB rows in shards of 68, the last padded), each against the
           one-card stream

first_gop_s is the wall time of the first GOP, which includes compiling the
GOP program; steady_fps is the rate over the remaining GOPs; peak_bytes is
the process's device peak so far (memory_stats()["peak_bytes_in_use"]).

Any failed comparison or exception exits non-zero and prints no ok line.
The last line is {"ok": true, "device": {"platform", "kind", "count"}}.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import contextlib
import io
import json
import os
import shutil
import subprocess
import sys
import time
import traceback

ROOT = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(ROOT, ".smoke_work")
ORACLE_DIR = os.path.join(ROOT, "oracle")
ORACLE = os.path.join(ORACLE_DIR, "oracle")
PSNR_TOL_DB = 0.01


class SmokeFailure(Exception):
    pass


def check(cond, what):
    if not cond:
        raise SmokeFailure(what)


def emit(rec):
    print(json.dumps(rec), flush=True)


def write_clip(path, t, h, w, seed):
    from bench import synth_clip

    y, cb, cr = synth_clip(t, h, w, seed=seed)
    with open(path, "wb") as f:
        for k in range(t):
            f.write(y[k].tobytes() + cb[k].tobytes() + cr[k].tobytes())
    return y


def oracle_job(clip, w, h, gop, qp, search="full", rc="none", kbps=0,
               frames=0, fmt=1, cqpo=0, qbias=8, vbv=0, qmat=0, islice=0):
    """Oracle encode + decode of one configuration on the host; returns
    (stream bytes, decoded yuv bytes)."""
    tag = f"{os.path.basename(clip)}.{gop}.{qp}.{search}.{rc}.{fmt}.{qmat}.{islice}.{frames}"
    tvc = os.path.join(WORK, f"oracle.{tag}.tvc")
    yuv = os.path.join(WORK, f"oracle.{tag}.yuv")
    cmd = [ORACLE, "encode", clip, tvc, str(w), str(h), str(gop), str(qp),
           search, rc, str(kbps), str(frames or 2**31 - 1), str(fmt),
           str(cqpo), str(qbias), str(vbv), str(qmat), str(islice)]
    r = subprocess.run(cmd, capture_output=True, text=True)
    check(r.returncode == 0, f"oracle encode failed: {r.stderr[-400:]}")
    r = subprocess.run([ORACLE, "decode", tvc, yuv], capture_output=True,
                       text=True)
    check(r.returncode == 0, f"oracle decode failed: {r.stderr[-400:]}")
    with open(tvc, "rb") as f:
        stream = f.read()
    with open(yuv, "rb") as f:
        dec = f.read()
    os.remove(tvc)
    os.remove(yuv)
    return stream, dec


def run_cli(argv):
    """cli.main in this process; returns (summary dict, per-frame dicts)."""
    from video_encoder import cli

    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = cli.main([str(a) for a in argv])
    check(rc == 0, f"cli {argv[0]} rc={rc}: {err.getvalue()[-600:]}")
    lines = [json.loads(x) for x in out.getvalue().splitlines()
             if x.startswith("{")]
    frames = [json.loads(x) for x in err.getvalue().splitlines()
              if x.startswith('{"index"')]
    return lines[-1], frames


def peak_bytes(dev=None):
    import jax

    dev = dev or jax.devices()[0]
    return int(dev.memory_stats()["peak_bytes_in_use"])


def psnr_f64(a, b):
    import numpy as np

    d = a.astype(np.float64) - b.astype(np.float64)
    mse = float(np.mean(d * d))
    return 10 * np.log10(255.0**2 / mse)


def encode_phase(name, clip, w, h, n, gop, cli_args, oracle, src_y=None):
    """Encode through the CLI, decode on the device and natively, compare
    against the oracle's stream and decode; one JSON line."""
    import numpy as np

    tvc = os.path.join(WORK, f"{name}.tvc")
    t0 = time.perf_counter()
    summary, frames = run_cli(["encode", "-i", clip, "-W", w, "-H", h,
                               "-o", tvc, "--frames", n, "--gop", gop, "-v",
                               *cli_args])
    wall = time.perf_counter() - t0
    check(summary["frames"] == n, f"{name}: encoded {summary['frames']} of {n}")
    first_gop_s = frames[0]["ms"] * min(gop, n) / 1e3
    rest = n - min(gop, n)
    steady = rest / (wall - first_gop_s) if rest and wall > first_gop_s else None
    with open(tvc, "rb") as f:
        stream = f.read()

    rec = dict(phase=name, args=" ".join(map(str, cli_args)), frames=n,
               wall_s=round(wall, 3), first_gop_s=round(first_gop_s, 3),
               steady_fps=round(steady, 2) if steady else None,
               kbits_per_frame=summary["kbits_per_frame"])
    dec = {}
    for engine in ("gop", "native"):
        out = os.path.join(WORK, f"{name}.{engine}.yuv")
        t1 = time.perf_counter()
        dsum, _ = run_cli(["decode", "-i", tvc, "-o", out, "--engine", engine])
        rec[f"decode_{engine}_s"] = round(time.perf_counter() - t1, 3)
        check(dsum["frames"] == n, f"{name}: {engine} decoded {dsum['frames']}")
        with open(out, "rb") as f:
            dec[engine] = f.read()
        os.remove(out)
    rec["peak_bytes"] = peak_bytes()

    o_stream, o_dec = oracle.result()
    rec["tvc_matches_oracle"] = stream == o_stream
    rec["gop_decode_matches_native"] = dec["gop"] == dec["native"]
    rec["decode_matches_oracle"] = dec["native"] == o_dec
    if src_y is not None:
        fsz = w * h * 3 // 2
        ys = np.frombuffer(dec["native"], np.uint8).reshape(n, fsz)[:, : w * h]
        ref = float(np.mean([psnr_f64(src_y[k], ys[k].reshape(h, w))
                             for k in range(n)]))
        rec["psnr_y_device"] = summary["mean_psnr_y"]
        rec["psnr_y_f64"] = round(ref, 4)
        rec["psnr_ok"] = abs(summary["mean_psnr_y"] - ref) <= PSNR_TOL_DB
    os.remove(tvc)
    emit(rec)
    for k in ("tvc_matches_oracle", "gop_decode_matches_native",
              "decode_matches_oracle", "psnr_ok"):
        check(rec.get(k, True), f"{name}: {k} is false")


def one_card(pool):
    w1, h1, w4, h4 = 1920, 1080, 3840, 2160
    c1080 = os.path.join(WORK, "c1080.yuv")
    c4k = os.path.join(WORK, "c4k.yuv")
    write_clip(c1080, 60, h1, w1, seed=1)
    y4k = write_clip(c4k, 16, h4, w4, seed=2)

    modes = [
        (["--search", "diamond", "--rc", "adaptive"],
         dict(search="diamond", rc="adaptive")),
        (["--format", "4", "--rc", "mb", "--kbps", "4000"],
         dict(rc="mb", kbps=4000, fmt=4)),
        (["--format", "3", "--quant-matrix", "--intra-slice", "17"],
         dict(fmt=3, qmat=1, islice=17)),
    ]
    jobs = {
        "enc1080": pool.submit(oracle_job, c1080, w1, h1, 30, 30),
        "enc4k": pool.submit(oracle_job, c4k, w4, h4, 8, 30),
        "lowqp": pool.submit(oracle_job, c4k, w4, h4, 8, 4, frames=8),
    }
    for i, (_, okw) in enumerate(modes):
        jobs[f"modes{i}"] = pool.submit(oracle_job, c1080, w1, h1, 30, 30,
                                        frames=16, **okw)

    failed = []

    def guarded(name, *a, **kw):
        try:
            encode_phase(name, *a, jobs[name], **kw)
        except Exception as e:  # report every phase, fail at the end
            traceback.print_exc()
            emit(dict(phase=name, error=f"{type(e).__name__}: {e}"))
            failed.append(name)

    guarded("enc1080", c1080, w1, h1, 60, 30, ["--qp", 30])
    guarded("enc4k", c4k, w4, h4, 16, 8, ["--qp", 30], src_y=y4k)
    for i, (args, _) in enumerate(modes):
        guarded(f"modes{i}", c1080, w1, h1, 16, 30, ["--qp", 30, *args])
    guarded("lowqp", c4k, w4, h4, 8, 8, ["--qp", 4], src_y=y4k[:8])
    return failed


def four_cards(pool):
    """GOP- and tile-sharded encode over four cards from this one process,
    each stream against the one-card stream of the same clip and the
    oracle's."""
    import jax

    from video_encoder.parallel import gop_parallel, tiles

    check(len(jax.devices()) >= 4, f"--cards 4 needs 4 GPUs, have "
          f"{len(jax.devices())}")
    device_sets = []

    def recording(fn):
        def wrapped(*a, **kw):
            out = fn(*a, **kw)
            leaf = jax.tree_util.tree_leaves(out)[0]
            device_sets.append(sorted(d.id for d in leaf.sharding.device_set))
            return out
        return wrapped

    gop_parallel.encode_gop_batch_sharded = recording(
        gop_parallel.encode_gop_batch_sharded)
    tiles.encode_gop_batch_2d = recording(tiles.encode_gop_batch_2d)

    w, h, n = 3840, 2160, 32
    clip = os.path.join(WORK, "multi4k.yuv")
    write_clip(clip, n, h, w, seed=3)
    oracle = pool.submit(oracle_job, clip, w, h, 8, 30)

    def encode(label, extra):
        tvc = os.path.join(WORK, f"multi.{label}.tvc")
        device_sets.clear()
        t0 = time.perf_counter()
        summary, _ = run_cli(["encode", "-i", clip, "-W", w, "-H", h, "-o", tvc,
                              "--gop", 8, "--qp", 30, *extra])
        wall = round(time.perf_counter() - t0, 3)
        check(summary["frames"] == n, f"{label}: {summary}")
        with open(tvc, "rb") as f:
            stream = f.read()
        os.remove(tvc)
        return stream, wall, device_sets[:]

    try:
        one, one_wall, _ = encode("one", [])
        o_stream, _ = oracle.result()
        emit(dict(phase="multi_one_card", wall_s=one_wall,
                  matches_oracle=one == o_stream))
        check(one == o_stream, "one-card stream differs from the oracle's")
    except Exception as e:
        traceback.print_exc()
        emit(dict(phase="multi_one_card", error=f"{type(e).__name__}: {e}"))
        return ["multi_one_card"]

    cards = [d.id for d in jax.devices()[:4]]
    failed = []
    for name, extra in (("dp", ["--devices", 4]),
                        ("tile", ["--devices", 4, "--tile", 2])):
        try:
            stream, wall, sets = encode(name, extra)
            rec = dict(phase=f"multi_{name}", args=" ".join(map(str, extra)),
                       wall_s=wall, output_device_sets=sets,
                       peak_bytes_per_device=[peak_bytes(d)
                                              for d in jax.devices()[:4]],
                       sharded_matches_one_card=stream == one,
                       all_cards_hold_shards=bool(sets) and all(
                           s == cards for s in sets))
            emit(rec)
            for k in ("sharded_matches_one_card", "all_cards_hold_shards"):
                check(rec[k], f"{name}: {k} is false")
        except Exception as e:
            traceback.print_exc()
            emit(dict(phase=f"multi_{name}", error=f"{type(e).__name__}: {e}"))
            failed.append(name)
    return failed


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cards", type=int, choices=[1, 4], default=1)
    a = ap.parse_args()

    import jax

    t0 = time.perf_counter()
    backend = jax.default_backend()
    devs = jax.devices()
    if backend != "gpu" or not devs or devs[0].platform != "gpu":
        print(f"chip_smoke: needs a GPU backend, JAX has {backend!r}",
              file=sys.stderr)
        return 1
    emit(dict(phase="device", jax=jax.__version__, backend=backend,
              devices=[str(d) for d in devs],
              device_kind=devs[0].device_kind))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    if smi.returncode != 0:
        print(f"chip_smoke: nvidia-smi failed: {smi.stderr}", file=sys.stderr)
        return 1
    cards = smi.stdout.strip()

    sys.path.insert(0, ROOT)
    from video_encoder.codec import native

    os.makedirs(WORK, exist_ok=True)
    try:
        native.build(ORACLE_DIR, "oracle")
        native.build(ORACLE_DIR, "liboracle.so")
        with concurrent.futures.ThreadPoolExecutor(8) as pool:
            failed = four_cards(pool) if a.cards == 4 else one_card(pool)
    finally:
        shutil.rmtree(WORK, ignore_errors=True)

    print(cards, flush=True)
    if failed:
        print(f"chip_smoke: FAILED phases {failed}", file=sys.stderr)
        return 1
    print(f"chip_smoke: all phases passed in {time.perf_counter() - t0:.1f} s",
          file=sys.stderr)
    d = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
