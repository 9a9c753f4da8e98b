"""CLI driver (reference component C1, SURVEY.md §2): parse args, open
files, run the pipeline, report stats.

    python -m video_encoder.cli encode -i in.yuv -W 1920 -H 1080 -o out.tvc
    python -m video_encoder.cli decode -i out.tvc -o dec.yuv
    python -m video_encoder.cli info   -i out.tvc
    python -m video_encoder.cli psnr   -a ref.yuv -b dec.yuv -W 1920 -H 1080
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

from .codec.bitstream import read_stream_header
from .codec.config import EncoderConfig
from .io import yuv
from .utils.metrics import FrameStats, RunSummary, psnr


def _add_dims(p):
    p.add_argument("-W", "--width", type=int, default=0)
    p.add_argument("-H", "--height", type=int, default=0)


def cmd_encode(a) -> int:
    if a.search == "hier" and a.engine != "golden":
        # hier is not a device-engine mode; it remains reproducible via the
        # host-side golden model and the C++ oracle (SPEC.md §9)
        print("error: --search hier is golden/oracle-only (not a device "
              "engine mode); use --search full, or --engine golden to "
              "reproduce hier streams", file=sys.stderr)
        return 2
    w, h, fps, frames = yuv.open_clip(a.input, a.width, a.height)
    cfg = EncoderConfig(
        width=w, height=h, gop_n=a.gop, base_qp=a.qp, search=a.search,
        rc=a.rc, target_kbps=a.kbps, fps_num=fps[0], fps_den=fps[1],
        format_version=a.format, chroma_qp_offset=a.chroma_qp_offset,
        quant_bias=a.quant_bias, vbv_kbits=a.vbv_kbits,
        quant_matrix=a.quant_matrix, intra_slice_mbrows=a.intra_slice,
    )
    n_frames = a.frames
    if n_frames == 0:
        if a.input.endswith(".y4m"):
            print("error: --frames required for y4m input", file=sys.stderr)
            return 2
        n_frames = yuv.count_yuv_frames(a.input, w, h)

    from .pipeline.encoder import encode_clip, GoldenEngine

    if a.engine == "golden":
        engine = GoldenEngine()
    elif a.engine == "device":
        if a.format != 1:
            print("error: --engine device is the v1-only per-frame engine; "
                  "use --engine gop for formats 2-3", file=sys.stderr)
            return 2
        from .pipeline.device_engine import DeviceEngine

        engine = DeviceEngine()
    else:  # "gop" — the production GOP-resident path
        engine = None

    # validate two-pass preconditions BEFORE truncating the output file
    if a.two_pass:
        import dataclasses

        if a.kbps <= 0:
            print("error: --two-pass requires --kbps", file=sys.stderr)
            return 2
        if cfg.rc == "adaptive":
            print("error: --two-pass allocates qp at the GOP level; "
                  "use --rc none|bitrate|vbv", file=sys.stderr)
            return 2
        if cfg.rc == "none":
            cfg = dataclasses.replace(cfg, rc="bitrate")

    if a.devices > 1 or a.tile > 1:
        if a.engine != "gop" or a.two_pass or a.multiprocess:
            print("error: --devices/--tile need the gop engine, single pass, "
                  "no --multiprocess", file=sys.stderr)
            return 2
    if a.multiprocess > 1 and (a.two_pass or a.engine != "gop"):
        print("error: --multiprocess needs the gop engine, single pass",
              file=sys.stderr)
        return 2
    if a.multiprocess > 1:
        import jax

        if jax.default_backend() != "cpu":
            # the workers are localhost CPU processes (gloo); one process
            # drives every accelerator of a host
            print(f"error: --multiprocess runs CPU worker processes only; "
                  f"on {jax.default_backend()} use --devices N to encode "
                  f"across the accelerators from one process",
                  file=sys.stderr)
            return 2
    if a.checkpoint and (a.two_pass or a.multiprocess > 1 or a.devices > 1
                         or a.tile > 1 or a.gop_batch > 1):
        print("error: --checkpoint is the single-engine serial path (no "
              "--two-pass/--multiprocess/--devices/--tile/--gop-batch); "
              "GOPs are the resume unit", file=sys.stderr)
        return 2
    if a.failover and (a.two_pass or a.multiprocess > 1 or a.engine != "gop"):
        print("error: --failover wraps the gop/sharded engines, single pass",
              file=sys.stderr)
        return 2

    from .utils.trace import EventLog, StageTimer, trace

    timer = StageTimer() if a.stage_timers else None
    on_frame = (lambda s: print(s.to_json(), file=sys.stderr)) if a.verbose else None
    t0 = time.perf_counter()
    with trace(a.trace):
        if a.checkpoint:
            # resume path: must NOT truncate the output — the writer seeks
            # to the checkpointed byte offset (pipeline/bitstream_writer.py)
            from .pipeline.encoder import encode_clip_resumable
            from .pipeline.gop_engine import GopEngine

            eng = engine
            if eng is None:
                eng = GopEngine(cfg)
            elif not hasattr(eng, "encode_gop"):
                from .pipeline import encoder as enc_mod

                per_frame = eng

                class _PerFrameGopAdapter:
                    def encode_gop(self, gframes, first):
                        return enc_mod.encode_gop(
                            cfg, per_frame, gframes, 0, first
                        )

                eng = _PerFrameGopAdapter()
            summary = encode_clip_resumable(
                cfg, frames, a.output, n_frames, eng, a.checkpoint,
                timer=timer,
                log=EventLog(sys.stderr) if a.verbose else None,
            )
        else:
            with open(a.output, "wb") as fo:
                if a.two_pass:
                    from .pipeline.encoder import encode_clip_twopass

                    if engine is None:
                        from .pipeline.gop_engine import GopEngine

                        engine = GopEngine(cfg)  # GOP-resident, both passes
                    summary = encode_clip_twopass(
                        cfg,
                        lambda: yuv.open_clip(a.input, a.width, a.height)[3],
                        fo, n_frames, engine=engine, on_frame=on_frame,
                    )
                elif a.multiprocess > 1:
                    summary = _encode_multiprocess(
                        cfg, a.input, a.width, a.height, fo, n_frames,
                        a.multiprocess
                    )
                elif a.devices > 1 or a.tile > 1:
                    summary = _encode_sharded(
                        cfg, frames, fo, n_frames, a.devices, a.tile,
                        a.verbose, failover=a.failover,
                    )
                elif a.failover:
                    summary = _encode_failover(cfg, frames, fo, n_frames)
                elif engine is None:
                    summary = _encode_gop_resident(
                        cfg, frames, fo, n_frames, a.verbose, a.gop_batch,
                        timer=timer,
                    )
                else:
                    summary = encode_clip(
                        cfg, frames, fo, n_frames, engine=engine,
                        on_frame=on_frame,
                    )
    wall = time.perf_counter() - t0
    out = json.loads(summary.to_json())
    out["wall_s"] = round(wall, 3)
    out["wall_fps"] = round(summary.frames / wall, 2) if wall else 0
    if timer is not None:
        out["stages"] = timer.report()
    if a.failover:
        out["survivor_gops"] = summary.survivor_gops
    print(json.dumps(out))
    return 0


def _encode_failover(cfg, frames, fo, n_frames):
    """--failover: per-GOP retry + engine failover around the GOP engine
    (SURVEY.md §5 failure row; parallel/failover.py). The golden GOP
    adapter is the always-alive survivor — same bytes by construction,
    encoded on the host; the summary counts its GOPs (survivor_gops).
    TVC_FAULT_GOPS=0,30 (first-frame indices) + TVC_FAULT_TIMES inject
    faults to exercise the re-dispatch path from the real CLI."""
    import os

    from .codec.bitstream import OrderedMux
    from .codec.golden import Frame
    from .parallel.failover import FaultInjector, encode_gops_with_recovery
    from .pipeline.encoder import GoldenGopAdapter
    from .pipeline.gop_engine import GopEngine

    fault = None
    if os.environ.get("TVC_FAULT_GOPS"):
        fault = FaultInjector(
            {int(x) for x in os.environ["TVC_FAULT_GOPS"].split(",")},
            times=int(os.environ.get("TVC_FAULT_TIMES", "1")),
        )
    eng = GopEngine(cfg)
    mux = OrderedMux(fo, cfg, n_frames)
    summary = RunSummary()
    golden = GoldenGopAdapter(cfg)
    gop: list = []
    start = 0
    count = 0

    class Survivor:
        def encode_gop(self, frames, first):
            summary.survivor_gops += 1
            return golden.encode_gop(frames, first)

    def flush(gop, start):
        packets = encode_gops_with_recovery(
            eng, [gop], [start], fallback=Survivor(), fault=fault
        )
        for p in packets:
            mux.push(p)
            summary.add(FrameStats(index=p.index, frame_type=p.frame_type,
                                   base_qp=p.base_qp, bits=p.payload_bits))

    for planes in frames:
        if count >= n_frames:
            break
        gop.append(Frame.from_planes(*planes))
        count += 1
        if len(gop) == cfg.gop_n:
            flush(gop, start)
            start += len(gop)
            gop = []
    if gop:
        flush(gop, start)
    mux.close()
    if fault is not None:
        print(json.dumps({"faults_injected": fault.injected}), file=sys.stderr)
    return summary


def _encode_gop_resident(cfg, frames, fo, n_frames, verbose, gop_batch=1,
                         timer=None):
    """Production path: GOP-resident device encode + ordered mux.

    gop_batch=G > 1 groups G full GOPs into one lockstep device program
    (gop_engine.encode_gop_batch_jit) — amortizes the scan's per-iteration
    cost over G frames; byte-identical to G=1 (tests/test_gop_batch.py).
    The tail (< G full GOPs, or a short last GOP) goes through the
    single-GOP program. timer (--stage-timers) splits upload/dispatch vs
    device-drain+mux wall time."""
    import contextlib

    from .codec.bitstream import OrderedMux
    from .codec.golden import Frame
    from .pipeline.gop_engine import GopEngine

    def stage(name):
        return timer.stage(name) if timer else contextlib.nullcontext()

    eng = GopEngine(cfg)
    mux = OrderedMux(fo, cfg, n_frames)
    summary = RunSummary()
    gop: list[Frame] = []
    batch: list[list[Frame]] = []
    batch_firsts: list[int] = []
    start = 0
    count = 0
    pending = None  # double-buffer: batch k computes while k+1 reads/uploads

    def emit(pk, st):
        for p in pk:
            mux.push(p)
        for s in st:
            summary.add(s)
            if verbose:
                print(s.to_json(), file=sys.stderr)

    def drain(handle):
        with stage("drain+mux"):
            if handle["kind"] == "batch":
                for pk, st in eng.encode_gops_finish(handle["h"]):
                    emit(pk, st)
            else:
                emit(*eng.encode_gop_finish(handle["h"]))

    def launch(kind, starter, *sargs):
        nonlocal pending
        with stage("upload+dispatch"):
            handle = dict(kind=kind, h=starter(*sargs))
        if pending is not None:
            drain(pending)
        pending = handle

    for planes in frames:
        if count >= n_frames:
            break
        gop.append(Frame.from_planes(*planes))
        count += 1
        if len(gop) == cfg.gop_n:
            if gop_batch > 1:
                batch.append(gop)
                batch_firsts.append(start)
                if len(batch) == gop_batch:
                    launch("batch", eng.encode_gops_start, batch,
                           batch_firsts)
                    batch, batch_firsts = [], []
            else:
                launch("one", eng.encode_gop_start, gop, start)
            start += len(gop)
            gop = []
    # tail: leftover full GOPs (batched if >1 of them), then the short GOP
    if len(batch) > 1:
        launch("batch", eng.encode_gops_start, batch, batch_firsts)
    elif batch:
        launch("one", eng.encode_gop_start, batch[0], batch_firsts[0])
    if gop:
        launch("one", eng.encode_gop_start, gop, start)
    if pending is not None:
        drain(pending)
    mux.close()
    return summary


def _encode_sharded(cfg, frames, fo, n_frames, devices, tile, verbose,
                    failover=False):
    """Multi-device clip encode from the command line (BASELINE configs
    4–5): GOPs sharded over the ('gop','tile') mesh via ShardedGopEncoder;
    byte-identical to the single-device stream (tests/test_cli_parallel.py).
    Runs on real devices or the fake CPU mesh (JAX_PLATFORMS=cpu; the CLI
    sets xla_force_host_platform_device_count automatically).

    failover=True re-dispatches a failed device batch GOP-by-GOP through
    the single-device engine with per-GOP retry (parallel/failover.py) —
    the surviving-engine path a real chip loss takes; exercised from the
    CLI via TVC_FAULT_GOPS (fault-injection, first-frame indices)."""
    import os

    import jax

    from .codec.bitstream import OrderedMux
    from .codec.golden import Frame
    from .parallel.gop_parallel import ShardedGopEncoder
    from .parallel.mesh import make_codec_mesh
    from .parallel.tiles import shard_mb_rows
    from .pipeline.gop_engine import GopEngine

    devices = devices or (len(jax.devices()) // tile * tile)
    if devices % tile:
        raise ValueError(f"--devices {devices} not divisible by --tile {tile}")
    n_gop_dev = devices // tile
    mesh = make_codec_mesh(gop_devices=n_gop_dev, tile_devices=tile)
    if tile > 1 and cfg.search != "full":
        raise ValueError("--tile needs --search full (haloed full search)")
    shard_mb_rows(-(-cfg.height // 16), tile)
    senc = ShardedGopEncoder(cfg, mesh=mesh)
    eng = GopEngine(cfg)  # leftover GOPs that don't fill a device batch
    mux = OrderedMux(fo, cfg, n_frames)
    summary = RunSummary()

    gop: list[Frame] = []
    batch: list[list[Frame]] = []
    firsts: list[int] = []
    start = 0
    count = 0

    fault = None
    if failover and os.environ.get("TVC_FAULT_GOPS"):
        from .parallel.failover import FaultInjector

        fault = FaultInjector(
            {int(x) for x in os.environ["TVC_FAULT_GOPS"].split(",")},
            times=int(os.environ.get("TVC_FAULT_TIMES", "1")),
        )

    def flush_batch():
        nonlocal batch, firsts
        if not batch:
            return
        if len(batch) == n_gop_dev:
            try:
                if fault is not None:
                    for fi in firsts:
                        fault.check(fi)
                packets = senc.encode_gop_batch(batch, firsts)
            except Exception as e:
                if not failover:
                    raise
                from .parallel.failover import (RECOVERABLE,
                                                encode_gops_with_recovery)

                if not isinstance(e, RECOVERABLE):
                    raise
                print(json.dumps({"failover": "device batch failed, "
                                  "re-dispatching on survivor",
                                  "firsts": firsts, "err": str(e)}),
                      file=sys.stderr)
                packets = encode_gops_with_recovery(eng, batch, firsts)
                summary.survivor_gops += len(batch)
            for p in packets:
                mux.push(p)
                summary.add(FrameStats(index=p.index, frame_type=p.frame_type,
                                       base_qp=p.base_qp, bits=p.payload_bits))
        else:  # tail short of a full device batch: single-device, same bytes
            for g, fi in zip(batch, firsts):
                pk, st = eng.encode_gop(g, fi)
                for p in pk:
                    mux.push(p)
                for s in st:
                    summary.add(s)
        batch, firsts = [], []

    for planes in frames:
        if count >= n_frames:
            break
        gop.append(Frame.from_planes(*planes))
        count += 1
        if len(gop) == cfg.gop_n:
            batch.append(gop)
            firsts.append(start)
            start += len(gop)
            gop = []
            if len(batch) == n_gop_dev:
                flush_batch()
    flush_batch()
    if gop:
        pk, st = eng.encode_gop(gop, start)
        for p in pk:
            mux.push(p)
        for s in st:
            summary.add(s)
    mux.close()
    return summary


def _encode_multiprocess(cfg, in_path, width, height, fo, n_frames, nproc):
    """Distributed clip encode from the command line: N localhost worker
    processes under jax.distributed (gloo) encode strided shares of the
    clip's full GOPs; the parent muxes their packets in frame order and
    encodes the tail itself. Byte-identical to single-process
    (tests/test_cli_parallel.py). On a pod the same worker runs once per
    host with --coordinator/--process-id instead of being spawned."""
    from .codec.bitstream import OrderedMux
    from .codec.golden import Frame
    from .parallel import multiprocess as mp
    from .pipeline.gop_engine import GopEngine

    rows, packets = mp.spawn_clip_encode(cfg, in_path, width, height,
                                         n_frames, nproc)
    mux = OrderedMux(fo, cfg, n_frames)
    summary = RunSummary()
    for p in packets:
        mux.push(p)
        summary.add(FrameStats(index=p.index, frame_type=p.frame_type,
                               base_qp=p.base_qp, bits=p.payload_bits))

    # tail: frames beyond the workers' equal share of full GOPs
    done = len(packets)
    if done < n_frames:
        eng = GopEngine(cfg)
        _, _, _, frames = yuv.open_clip(in_path, width, height)
        gop: list[Frame] = []
        start = done
        for i, planes in enumerate(frames):
            if i >= n_frames:
                break
            if i < done:
                continue
            gop.append(Frame.from_planes(*planes))
            if len(gop) == cfg.gop_n:
                pk, st = eng.encode_gop(gop, start)
                for p in pk:
                    mux.push(p)
                for s in st:
                    summary.add(s)
                start += len(gop)
                gop = []
        if gop:
            pk, st = eng.encode_gop(gop, start)
            for p in pk:
                mux.push(p)
            for s in st:
                summary.add(s)
    mux.close()
    print(json.dumps({"multiprocess_workers": rows}), file=sys.stderr)
    return summary


def cmd_decode(a) -> int:
    from .pipeline import decoder

    t0 = time.perf_counter()
    with open(a.input, "rb") as fi:
        if a.engine == "native":
            from .codec import native

            if not native.available():
                print("warning: native lib unavailable, using golden", file=sys.stderr)
                a.engine = "golden"
        if a.engine == "native" and a.workers != 1:
            info, frames = decoder.decode_clip_parallel(fi, a.workers)
        elif a.engine == "native":
            info, frames = decoder.decode_clip_native(fi)
        elif a.engine == "gop":
            info, frames = decoder.decode_clip_gop(fi)
        elif a.engine == "device":
            info, frames = decoder.decode_clip(fi, decoder.DeviceDecodeEngine())
        else:
            info, frames = decoder.decode_clip(fi)
        n = 0
        with open(a.output, "wb") as fo:
            for y, cb, cr in frames:
                yuv.write_yuv_frame(fo, y, cb, cr)
                n += 1
    wall = time.perf_counter() - t0
    print(json.dumps({"frames": n, "width": info.width, "height": info.height,
                      "wall_s": round(wall, 3),
                      "fps": round(n / wall, 2) if wall else 0}))
    return 0


def cmd_info(a) -> int:
    with open(a.input, "rb") as f:
        info = read_stream_header(f)
    print(json.dumps(info.__dict__))
    return 0


def cmd_psnr(a) -> int:
    with open(a.a, "rb") as fa, open(a.b, "rb") as fb:
        stats = []
        for (ya, cba, cra), (yb, cbb, crb) in zip(
            yuv.read_yuv_frames(fa, a.width, a.height),
            yuv.read_yuv_frames(fb, a.width, a.height),
        ):
            stats.append(
                (psnr(ya, yb), psnr(cba, cbb), psnr(cra, crb))
            )
    if not stats:
        print("error: no frames", file=sys.stderr)
        return 1
    arr = np.minimum(np.array(stats), 999.0)  # lossless planes -> cap (valid JSON)
    print(json.dumps({
        "frames": len(stats),
        "psnr_y": round(float(arr[:, 0].mean()), 3),
        "psnr_cb": round(float(arr[:, 1].mean()), 3),
        "psnr_cr": round(float(arr[:, 2].mean()), 3),
    }))
    return 0


def main(argv=None) -> int:
    import os

    if os.environ.get("JAX_PLATFORMS") == "cpu":
        # --devices N on the CPU platform: make a fake N-device mesh
        # (SURVEY.md §4.4) before the backend initializes. Accepts both
        # '--devices N' and '--devices=N' argument forms.
        args_l = list(argv) if argv is not None else sys.argv[1:]

        def _flag_val(name: str, default: int) -> int:
            for i, arg in enumerate(args_l):
                if arg == name and i + 1 < len(args_l):
                    try:
                        return int(args_l[i + 1])
                    except ValueError:
                        return default
                if arg.startswith(name + "="):
                    try:
                        return int(arg.split("=", 1)[1])
                    except ValueError:
                        return default
            return default

        n = _flag_val("--devices", 0)
        t = _flag_val("--tile", 1)
        need = n if n else t  # --devices is the mesh total
        if need > 1:
            flags = os.environ.get("XLA_FLAGS", "")
            if "xla_force_host_platform_device_count" not in flags:
                os.environ["XLA_FLAGS"] = (
                    flags + f" --xla_force_host_platform_device_count={need}"
                ).strip()
            # XLA_FLAGS is read at backend init: if the backend already
            # exists in-process with fewer devices, the flag is a no-op
            # and the mesh build below would fail confusingly.
            import jax
            import jax._src.xla_bridge as xb

            if getattr(xb, "_backends", None) and len(jax.devices()) < need:
                print(
                    f"warning: JAX backend already initialized with "
                    f"{len(jax.devices())} device(s) < {need} requested; "
                    "set XLA_FLAGS=--xla_force_host_platform_device_count"
                    f"={need} before starting Python", file=sys.stderr)
    ap = argparse.ArgumentParser(prog="video_encoder")
    sub = ap.add_subparsers(dest="cmd", required=True)

    e = sub.add_parser("encode", help="raw YUV/Y4M -> TVC1")
    e.add_argument("-i", "--input", required=True)
    e.add_argument("-o", "--output", required=True)
    _add_dims(e)
    e.add_argument("--gop", type=int, default=30)
    e.add_argument("--qp", type=int, default=28)
    e.add_argument("--search", choices=["full", "diamond", "hier"],
                   default="full",
                   help="ME mode: full (exhaustive ±16, the default), "
                        "diamond, or hier (golden engine only)")
    e.add_argument("--rc", choices=["none", "adaptive", "bitrate", "vbv", "mb"],
                   default="none")
    e.add_argument("--kbps", type=int, default=0)
    e.add_argument("--vbv-kbits", type=int, default=0,
                   help="rc=vbv buffer size (0 = 8x per-frame target)")
    e.add_argument("--two-pass", action="store_true",
                   help="two-pass GOP-level rate allocation (needs --kbps; "
                        "reads the input twice)")
    e.add_argument("--frames", type=int, default=0, help="0 = all")
    e.add_argument("--engine", choices=["gop", "device", "golden"], default="gop")
    e.add_argument("--format", type=int, choices=[1, 2, 3, 4], default=1,
                   help="bitstream format: 1=TVC1, 2=v2 (mv pred, DC DPCM), "
                        "3=v3 (I-frame intra pred, quant matrix), "
                        "4=v4 (half-pel motion)")
    e.add_argument("--quant-matrix", action="store_true",
                   help="v3: per-frequency quant matrix (SPEC.md 13.2)")
    e.add_argument("--intra-slice", type=int, default=0,
                   help="v3: reset the I-frame vertical-intra predictor "
                        "every N MB rows (SPEC.md 13.3) - slices are "
                        "independent, enabling --tile with --format 3")
    e.add_argument("--quant-bias", type=int, default=8,
                   help="AC quantizer rounding bias /16; 8=midpoint, "
                        "lower=deadzone (fewer bits, encoder-side only)")
    e.add_argument("--chroma-qp-offset", type=int, default=0,
                   help="v2 only: chroma QP offset in [-12, 12]")
    e.add_argument("--gop-batch", type=int, default=1,
                   help="encode G full GOPs per device program (lockstep "
                        "batched scan; amortizes per-frame overhead)")
    e.add_argument("--devices", type=int, default=0,
                   help="shard GOPs over N devices of a ('gop','tile') mesh "
                        "(0 = single-device path); with JAX_PLATFORMS=cpu a "
                        "fake N-device mesh is created automatically")
    e.add_argument("--tile", type=int, default=1,
                   help="spatial tile devices per GOP (devices = gop x tile; "
                        "needs --search full)")
    e.add_argument("--multiprocess", type=int, default=0,
                   help="spawn N localhost jax.distributed CPU worker "
                        "processes and mux their packets (CPU backend only; "
                        "use --devices on an accelerator)")
    e.add_argument("--checkpoint", default="",
                   help="checkpoint file for killable encodes: resumes "
                        "losslessly at the last GOP boundary (byte-identical "
                        "stream); cleared on completion")
    e.add_argument("--trace", default="",
                   help="write a jax.profiler device trace (TensorBoard "
                        "format) of the encode to this directory")
    e.add_argument("--stage-timers", action="store_true",
                   help="report per-stage host wall time (upload/dispatch "
                        "vs drain+mux) in the summary JSON")
    e.add_argument("--failover", action="store_true",
                   help="per-GOP retry + engine failover (GOPs are the "
                        "recovery unit); with --devices, a failed device "
                        "batch re-dispatches on the single-device survivor; "
                        "the summary reports survivor_gops. "
                        "TVC_FAULT_GOPS=i,j injects faults for testing")
    e.add_argument("-v", "--verbose", action="store_true")
    e.set_defaults(fn=cmd_encode)

    d = sub.add_parser("decode", help="TVC1 -> raw YUV")
    d.add_argument("-i", "--input", required=True)
    d.add_argument("-o", "--output", required=True)
    d.add_argument("--engine", choices=["native", "gop", "device", "golden"], default="native")
    d.add_argument("--workers", type=int, default=0,
                   help="GOP-parallel native decode threads (0 = one per "
                        "core, 1 = serial); GOPs are independent "
                        "sub-streams, frames mux in order")
    d.set_defaults(fn=cmd_decode)

    inf = sub.add_parser("info", help="dump stream header")
    inf.add_argument("-i", "--input", required=True)
    inf.set_defaults(fn=cmd_info)

    p = sub.add_parser("psnr", help="PSNR between two raw YUV files")
    p.add_argument("-a", required=True)
    p.add_argument("-b", required=True)
    _add_dims(p)
    p.set_defaults(fn=cmd_psnr)

    a = ap.parse_args(argv)
    try:
        return a.fn(a)
    except (ValueError, FileNotFoundError, OSError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 1


if __name__ == "__main__":
    sys.exit(main())
