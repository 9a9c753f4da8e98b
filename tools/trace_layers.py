"""Per-layer device time of the GOP-resident encode, from a profiler trace.

    python tools/trace_layers.py [--out .smoke_work/trace]

For each configuration (1080p GOP=30 qp30 and 4K GOP=8 qp30; full search,
format 1, span-string emit — what GopEngine runs for `cli encode` with
defaults) the GOP program is compiled, run once to warm up, timed over
TIMED_GOPS device-resident GOPs, then TRACED_GOPS more are traced with
jax.profiler. Device events are attributed to the engine's jax.named_scope
layers (me, mc, code_plane, block_pack, chunk_merge; the rest is "other")
through the op_name metadata of their hlo_op in the compiled program's HLO
text.

Prints one JSON line per configuration: device kind and the card's power
limit, the untraced and traced wall ms/frame, the device ms/frame in all
and per layer (sum of device event durations / frames), the untraced idle
(untraced wall - device time) per frame and per full-search step, the
device busy share of the traced window, the memory copies per GOP, which
HLO operations carry the 8x8 transform products, and the costliest device
and host events. Device events inside a CUDA graph (XLA command buffer)
show as one command_buffer event; run again with
XLA_FLAGS=--xla_gpu_enable_command_buffer= to attribute every kernel to
its layer. The raw traces stay under --out for offline reading.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import re
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

LAYERS = ("chunk_merge", "block_pack", "code_plane", "mc", "me")
CONFIGS = (("1080p_gop30_qp30", 1080, 1920, 30, 30),
           ("4k_gop8_qp30", 2160, 3840, 8, 30))
TIMED_GOPS = 5
TRACED_GOPS = 2


def op_names(hlo_text: str) -> dict[str, str]:
    """HLO instruction name -> op_name metadata; a fusion without its own
    metadata takes its fused computation's root op_name."""
    names, calls, roots = {}, {}, {}
    comp = None
    for line in hlo_text.splitlines():
        m = re.match(r"^%?([\w.\-]+) .*\{$", line)
        if m and not line.startswith(" "):
            comp = m.group(1)
            continue
        m = re.match(r"\s*(ROOT )?%([\w.\-]+) = ", line)
        if not m:
            continue
        name = m.group(2)
        on = re.search(r'op_name="([^"]*)"', line)
        if on:
            names[name] = on.group(1)
            if m.group(1) and comp:
                roots[comp] = on.group(1)
        c = re.search(r"calls=%([\w.\-]+)", line)
        if c:
            calls[name] = c.group(1)
    for name, c in calls.items():
        if name not in names and c in roots:
            names[name] = roots[c]
    return names


def layer_of(op_name: str) -> str:
    parts = op_name.split("/")
    for layer in LAYERS:
        if layer in parts:
            return layer
    return "other"


def reduce_trace(path: str, names: dict[str, str]):
    """(per-layer device ns, busy ns, device event counts by name, top
    device events, top host events). Device events without an hlo_op
    (copies, syncs) count as "other"."""
    from jax.profiler import ProfileData

    pd = ProfileData.from_file(path)
    per_layer: dict[str, int] = {}
    intervals, top, host, counts = [], {}, {}, {}
    for plane in pd.planes:
        on_device = plane.name.startswith("/device:")
        for line in plane.lines:
            for ev in line.events:
                dur = int(ev.duration_ns)
                if not on_device:
                    key = f"{line.name[:24]}:{ev.name[:60]}"
                    n, t = host.get(key, (0, 0))
                    host[key] = (n + 1, t + dur)
                    continue
                counts[ev.name] = counts.get(ev.name, 0) + 1
                op = dict(ev.stats).get("hlo_op", "")
                layer = layer_of(names.get(op, ""))
                per_layer[layer] = per_layer.get(layer, 0) + dur
                intervals.append((int(ev.start_ns), int(ev.start_ns) + dur))
                key = f"{layer}:{op or ev.name[:60]}"
                n, t = top.get(key, (0, 0))
                top[key] = (n + 1, t + dur)
    busy, end = 0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            busy += e - s
            end = e
        elif e > end:
            busy += e - end
            end = e
    def ranked(d, k):
        return [(name, n, round(t / 1e6, 3))
                for name, (n, t) in sorted(d.items(), key=lambda kv: -kv[1][1])[:k]]

    return per_layer, busy, counts, ranked(top, 25), ranked(host, 25)


def transform_ops(hlo_text: str) -> list[str]:
    """The distinct kinds of HLO op that carry the code_plane products."""
    kinds = set()
    for line in hlo_text.splitlines():
        if "/code_plane/" not in line:
            continue
        m = re.search(r"= \S+ (dot|custom-call|convolution|fusion)\(", line)
        if m:
            tgt = re.search(r'custom_call_target="([^"]+)"', line)
            kind = re.search(r"kind=(\w+)", line)
            kinds.add(m.group(1) + (f"[{tgt.group(1)}]" if tgt else "")
                      + (f"[{kind.group(1)}]" if kind else ""))
    return sorted(kinds)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=".smoke_work/trace",
                    help="trace directory (xplane files are tens of MB)")
    a = ap.parse_args()

    import jax
    import jax.numpy as jnp

    from bench import synth_clip
    from video_encoder.codec import entropy, spec
    from video_encoder.pipeline.gop_engine import (_block_words_for_qp,
                                                   encode_gop_jit)

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"trace_layers: needs a GPU, JAX has {dev.platform}",
              file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    for name, h, w, gop, qp in CONFIGS:
        hp = spec.ceil_to(h, spec.MB)
        n_mbs = (hp // spec.MB) * (w // spec.MB)
        kw = dict(search="full", rc="none", block_words=_block_words_for_qp(qp),
                  cap_words=entropy.capacity_words(n_mbs, 1024), target_bits=0,
                  emit="chunks")
        y, cb, cr = (jnp.asarray(p) for p in synth_clip(gop, hp, w))
        t0 = time.perf_counter()
        hlo = encode_gop_jit.lower(y, cb, cr, qp, **kw).compile().as_text()
        compile_s = time.perf_counter() - t0
        jax.block_until_ready(encode_gop_jit(y, cb, cr, qp, **kw))
        t0 = time.perf_counter()
        for _ in range(TIMED_GOPS):
            out = encode_gop_jit(y, cb, cr, qp, **kw)
        jax.block_until_ready(out)
        untraced_ms = (time.perf_counter() - t0) * 1e3 / (TIMED_GOPS * gop)
        outdir = os.path.join(a.out, name)
        t0 = time.perf_counter()
        with jax.profiler.trace(outdir):
            for _ in range(TRACED_GOPS):
                jax.block_until_ready(encode_gop_jit(y, cb, cr, qp, **kw))
        window_ns = (time.perf_counter() - t0) * 1e9
        path = sorted(glob.glob(os.path.join(outdir, "**", "*.xplane.pb"),
                                recursive=True))[-1]
        per_layer, busy, counts, top, host = reduce_trace(path, op_names(hlo))
        frames = gop * TRACED_GOPS
        device_ms = sum(per_layer.values()) / 1e6 / frames
        # full-search steps: launches of the scan body's costliest kernel
        me_steps = max((n for k, n, _ in top if k.startswith("me:")),
                       default=0) / frames
        print(json.dumps({
            "config": name, "device_kind": dev.device_kind, "card": card,
            "xla_flags": os.environ.get("XLA_FLAGS", ""),
            "compile_s": round(compile_s, 2),
            "untraced_ms_per_frame": round(untraced_ms, 3),
            "window_ms_per_frame": round(window_ns / 1e6 / frames, 3),
            "device_ms_per_frame": round(device_ms, 3),
            "ms_per_frame": {k: round(v / 1e6 / frames, 3)
                             for k, v in sorted(per_layer.items())},
            "idle_ms_per_frame": round(untraced_ms - device_ms, 3),
            "me_steps_per_frame": round(me_steps, 1),
            "idle_us_per_me_step": (round((untraced_ms - device_ms) * 1e3
                                          / me_steps, 2) if me_steps else None),
            "busy_share": round(busy / window_ns, 4),
            "memcpy_per_gop": {k: n / TRACED_GOPS for k, n in sorted(counts.items())
                               if k.startswith("Memcpy")},
            "transform_ops": transform_ops(hlo),
            "top_device_events": top,
            "top_host_events": host,
        }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
