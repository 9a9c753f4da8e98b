"""What the package does about the platform it runs on: the compile-cache
location, no silent fallback that hides the device (a refused
--multiprocess off the CPU, a profiler that cannot start, a library that
cannot build), and chip_smoke.py refusing to report success without a GPU."""

import contextlib
import os
import shutil
import subprocess
import sys

import pytest

from video_encoder import cli
from video_encoder.codec import native
from video_encoder.utils import trace as trace_mod

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cache_dir(env_value):
    env = dict(os.environ, PYTHONPATH=REPO)
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    if env_value is not None:
        env["JAX_COMPILATION_CACHE_DIR"] = env_value
    r = subprocess.run(
        [sys.executable, "-c",
         "import video_encoder, jax; print(jax.config.jax_compilation_cache_dir)"],
        capture_output=True, text=True, env=env, cwd="/", timeout=120)
    assert r.returncode == 0, r.stderr
    return r.stdout.strip().splitlines()[-1]


@pytest.mark.parametrize("env_value", [None, "given"])
def test_compile_cache_dir(tmp_path, env_value):
    """JAX_COMPILATION_CACHE_DIR wins when set; otherwise the fixed
    <checkout>/.jax_cache, whatever the working directory."""
    if env_value is None:
        assert _cache_dir(None) == os.path.join(REPO, ".jax_cache")
    else:
        d = str(tmp_path / "cache")
        assert _cache_dir(d) == d


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_refuses_without_gpu(tmp_path, alone):
    """On the CPU backend, in the checkout or copied alone into an empty
    directory, chip_smoke.py exits non-zero and prints no ok line."""
    script = os.path.join(REPO, "chip_smoke.py")
    if alone:
        shutil.copy(script, tmp_path / "chip_smoke.py")
        script = str(tmp_path / "chip_smoke.py")
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("PYTHONPATH", None)
    r = subprocess.run([sys.executable, script], capture_output=True,
                       text=True, env=env, cwd=str(tmp_path), timeout=120)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def test_cli_refuses_multiprocess_on_accelerator(tmp_path, monkeypatch,
                                                 capsys):
    import jax

    (tmp_path / "in.yuv").write_bytes(bytes(64 * 64 * 3 // 2 * 2))
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    rc = cli.main(["encode", "-i", str(tmp_path / "in.yuv"), "-W", "64",
                   "-H", "64", "-o", str(tmp_path / "o.tvc"),
                   "--multiprocess", "2"])
    assert rc == 2
    assert "--devices" in capsys.readouterr().err


def test_trace_failure_propagates(monkeypatch):
    import jax

    @contextlib.contextmanager
    def broken(log_dir):
        raise RuntimeError("profiler unavailable")
        yield

    monkeypatch.setattr(jax.profiler, "trace", broken)
    with pytest.raises(RuntimeError, match="profiler unavailable"):
        with trace_mod.trace("some_dir"):
            pass
    with trace_mod.trace(""):  # no trace requested: no profiler involved
        pass


def test_native_build_raises_on_failure(tmp_path):
    (tmp_path / "Makefile").write_text("broken:\n\tfalse\n")
    with pytest.raises(RuntimeError, match="broken build failed"):
        native.build(str(tmp_path), "broken")
