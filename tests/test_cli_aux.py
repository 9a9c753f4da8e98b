"""CLI wiring of the aux subsystems (r4 verdict weak #6: checkpoint/
failover/tracing existed as tested libraries but were unreachable from the
product). Each flag is exercised end-to-end through cli.main on small
clips: --checkpoint resumes byte-identically after a mid-clip kill,
--failover absorbs injected faults byte-identically, --stage-timers lands
in the summary JSON, and the validation rejections fire."""

import json
import os

import numpy as np
import pytest

from video_encoder import cli
from video_encoder.codec.config import EncoderConfig


W, H, N = 96, 64, 5


@pytest.fixture()
def clip(tmp_path, rng):
    path = tmp_path / "in.yuv"
    with open(path, "wb") as f:
        base = rng.integers(0, 256, (H + 8, W + 8)).astype(np.int32)
        for k in range(N):
            y = np.clip(base[k:k + H, k:k + W] + rng.integers(-2, 3, (H, W)),
                        0, 255).astype(np.uint8)
            f.write(y.tobytes())
            f.write(np.full((H // 2, W // 2), 120, np.uint8).tobytes())
            f.write(np.full((H // 2, W // 2), 130, np.uint8).tobytes())
    return str(path)


def _encode(clip, out, *extra):
    rc = cli.main(["encode", "-i", clip, "-W", str(W), "-H", str(H),
                   "-o", out, "--gop", "2", "--qp", "26", "--search", "full",
                   *extra])
    assert rc == 0
    return open(out, "rb").read()


def test_checkpoint_resume_byte_identical(clip, tmp_path, capsys):
    ref = _encode(clip, str(tmp_path / "ref.tvc"))

    # interrupt mid-GOP-1 (after GOP 0 flushed) via the library, then let
    # the CLI --checkpoint path resume and finish
    from video_encoder.io import yuv
    from video_encoder.pipeline.encoder import encode_clip_resumable
    from video_encoder.pipeline.gop_engine import GopEngine

    cfg = EncoderConfig(width=W, height=H, gop_n=2, base_qp=26, search="full")
    _, _, _, frames = yuv.open_clip(clip, W, H)
    out = str(tmp_path / "resumed.tvc")
    ck = str(tmp_path / "ck.json")

    def interrupted():
        for i, f in enumerate(frames):
            if i == 3:
                raise KeyboardInterrupt
            yield f

    with pytest.raises(KeyboardInterrupt):
        encode_clip_resumable(cfg, interrupted(), out, N, GopEngine(cfg), ck)
    assert os.path.exists(ck)

    got = _encode(clip, out, "--checkpoint", ck)
    assert got == ref
    assert not os.path.exists(ck)  # cleared on completion
    # a second run with the same flag re-encodes from scratch, same bytes
    assert _encode(clip, out, "--checkpoint", ck) == ref


def test_checkpoint_config_mismatch_rejected(clip, tmp_path, capsys):
    ck = str(tmp_path / "ck.json")
    out = str(tmp_path / "o.tvc")
    from video_encoder.pipeline import checkpoint as ckpt

    cfg_other = EncoderConfig(width=W, height=H, gop_n=3, base_qp=30)
    ckpt.save(ck, ckpt.EncodeState(cfg_other.config_hash(), 3, 100, 3,
                                   1000, 1.0, 30.0))
    rc = cli.main(["encode", "-i", clip, "-W", str(W), "-H", str(H),
                   "-o", out, "--gop", "2", "--qp", "26",
                   "--checkpoint", ck])
    assert rc == 1
    assert "config hash" in capsys.readouterr().err


def test_failover_injected_fault_byte_identical(clip, tmp_path, capsys,
                                                monkeypatch):
    ref = _encode(clip, str(tmp_path / "ref.tvc"))
    monkeypatch.setenv("TVC_FAULT_GOPS", "2")
    got = _encode(clip, str(tmp_path / "fo.tvc"), "--failover")
    assert got == ref
    assert '"faults_injected": 1' in capsys.readouterr().err


def test_failover_survivor_gops_in_summary(clip, tmp_path, capsys,
                                           monkeypatch):
    """A GOP that fails past the primary's retries is encoded by the host
    survivor; the summary JSON counts it, and the bytes still match."""
    ref = _encode(clip, str(tmp_path / "ref.tvc"))
    capsys.readouterr()
    clean = _encode(clip, str(tmp_path / "clean.tvc"), "--failover")
    assert json.loads(capsys.readouterr().out.splitlines()[-1])[
        "survivor_gops"] == 0
    monkeypatch.setenv("TVC_FAULT_GOPS", "2")
    monkeypatch.setenv("TVC_FAULT_TIMES", "2")
    got = _encode(clip, str(tmp_path / "fo.tvc"), "--failover")
    out = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert got == ref == clean
    assert out["survivor_gops"] == 1


def test_stage_timers_in_summary(clip, tmp_path, capsys):
    _encode(clip, str(tmp_path / "o.tvc"), "--stage-timers")
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert "stages" in out
    assert "upload+dispatch" in out["stages"]
    assert "drain+mux" in out["stages"]
    assert out["stages"]["upload+dispatch"]["count"] == 3  # 2 GOPs + tail


def test_stage_timers_with_checkpoint(clip, tmp_path, capsys):
    ck = str(tmp_path / "ck.json")
    _encode(clip, str(tmp_path / "o.tvc"), "--checkpoint", ck,
            "--stage-timers")
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert "encode_gop" in out["stages"]
    assert "write+checkpoint" in out["stages"]


def test_checkpoint_flag_combinations_rejected(clip, tmp_path, capsys):
    out = str(tmp_path / "o.tvc")
    for extra in (["--two-pass"], ["--gop-batch", "2"], ["--devices", "2"]):
        rc = cli.main(["encode", "-i", clip, "-W", str(W), "-H", str(H),
                       "-o", out, "--checkpoint", str(tmp_path / "c.json"),
                       *extra])
        assert rc == 2, extra
