"""CLI access to the parallel layer (r2 verdict item 3): --devices/--tile,
--gop-batch and --multiprocess must produce byte-identical streams to the
single-device CLI encode (SPEC.md §11 invariant 2; BASELINE configs 4–5
driven end-to-end from the command line)."""

import json
import os

import jax
import numpy as np
import pytest

from tests.conftest import make_clip
from video_encoder import cli

needs_devices = pytest.mark.skipif(
    len(jax.devices()) < 4, reason="needs >=4 (fake) devices"
)

W, H = 64, 64  # 4 MB rows/cols: divisible for --tile 2 row sharding


@pytest.fixture
def clip_file(tmp_path, rng):
    # 11 frames = 3 full GOPs of 3 + tail of 2 (exercises every tail path)
    path = tmp_path / "in.yuv"
    with open(path, "wb") as f:
        for y, cb, cr in make_clip(rng, W, H, 11):
            f.write(y.tobytes() + cb.tobytes() + cr.tobytes())
    return str(path)


def _encode(clip_file, tmp_path, name, *extra):
    out = str(tmp_path / name)
    rc = cli.main([
        "encode", "-i", clip_file, "-o", out, "-W", str(W), "-H", str(H),
        "--gop", "3", "--qp", "26", "--search", "full", *extra,
    ])
    assert rc == 0
    with open(out, "rb") as f:
        return f.read()


def test_cli_devices_matches_single(clip_file, tmp_path, capsys):
    ref = _encode(clip_file, tmp_path, "a.tvc")
    capsys.readouterr()
    got = _encode(clip_file, tmp_path, "b.tvc", "--devices", "2")
    assert got == ref


@needs_devices
def test_cli_devices_tile_matches_single(clip_file, tmp_path, capsys):
    ref = _encode(clip_file, tmp_path, "a.tvc")
    capsys.readouterr()
    got = _encode(clip_file, tmp_path, "b.tvc", "--devices", "4", "--tile", "2")
    assert got == ref


def test_cli_gop_batch_matches_single(clip_file, tmp_path, capsys):
    ref = _encode(clip_file, tmp_path, "a.tvc")
    capsys.readouterr()
    got = _encode(clip_file, tmp_path, "b.tvc", "--gop-batch", "2")
    assert got == ref


def test_cli_gop_batch_rc_matches_single(clip_file, tmp_path, capsys):
    ref = _encode(clip_file, tmp_path, "a.tvc", "--rc", "vbv", "--kbps", "200")
    capsys.readouterr()
    got = _encode(clip_file, tmp_path, "b.tvc", "--rc", "vbv", "--kbps", "200",
                  "--gop-batch", "3")
    assert got == ref


def test_cli_multiprocess_matches_single(clip_file, tmp_path, capsys):
    ref = _encode(clip_file, tmp_path, "a.tvc")
    capsys.readouterr()
    got = _encode(clip_file, tmp_path, "b.tvc", "--multiprocess", "2")
    assert got == ref


def _odd_clip(tmp_path, rng):
    """48 px = 3 MB rows, which do not split evenly in two or four."""
    path = tmp_path / "odd.yuv"
    with open(path, "wb") as f:
        for y, cb, cr in make_clip(rng, 64, 48, 6):
            f.write(y.tobytes() + cb.tobytes() + cr.tobytes())
    return str(path)


def _encode_odd(path, tmp_path, name, *extra):
    out = str(tmp_path / name)
    rc = cli.main(["encode", "-i", path, "-o", out, "-W", "64", "-H", "48",
                   "--gop", "3", "--search", "full", *extra])
    return rc, out


@needs_devices
def test_cli_tile_rejects_uneven_mb_rows(tmp_path, rng, capsys):
    """Uneven MB rows are padded to equal row shards, but only while every
    shard holds a frame row: 3 MB rows over --tile 4 is a clear error, not
    a trace failure."""
    path = _odd_clip(tmp_path, rng)
    rc, _ = _encode_odd(path, tmp_path, "o.tvc", "--devices", "4", "--tile", "4")
    assert rc == 1
    assert "row shards" in capsys.readouterr().err


@needs_devices
def test_cli_tile_uneven_mb_rows_matches_single(tmp_path, rng, capsys):
    """3 MB rows over --tile 2 (shards of 2, the last padded) give the
    single-device stream."""
    path = _odd_clip(tmp_path, rng)
    rc, ref = _encode_odd(path, tmp_path, "a.tvc")
    assert rc == 0
    rc, got = _encode_odd(path, tmp_path, "b.tvc", "--devices", "4", "--tile", "2")
    assert rc == 0
    with open(ref, "rb") as a, open(got, "rb") as b:
        assert a.read() == b.read()


def test_cli_devices_rejects_twopass(clip_file, tmp_path, capsys):
    out = str(tmp_path / "x.tvc")
    rc = cli.main([
        "encode", "-i", clip_file, "-o", out, "-W", str(W), "-H", str(H),
        "--devices", "2", "--two-pass", "--kbps", "200",
    ])
    assert rc == 2
