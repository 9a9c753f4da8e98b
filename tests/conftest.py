"""Test config: JAX on the CPU with 8 fake devices (SURVEY.md §4.4), unless
JAX_PLATFORMS names another platform.

The codec is integer/bit-exact by design, so CPU-vs-accelerator equality is
a hard test, not a tolerance test. The device-equality suites run on the
card with JAX_PLATFORMS=cuda in ONE process (no -n), so that only one
process holds the card (README.md, "Tests").
"""

import os
import sys

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()
os.environ.setdefault("JAX_PLATFORMS", "cpu")

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import pytest


@pytest.fixture
def rng():
    return np.random.default_rng(1234)


def make_clip(rng, w, h, n, motion=True):
    """Synthetic 4:2:0 clip: textured background + moving square + noise."""
    frames = []
    base_y = rng.integers(0, 256, size=(h + 64, w + 64), dtype=np.uint8)
    # smooth the background so it is compressible
    base_y = (
        base_y.astype(np.int32)
        + np.roll(base_y, 1, 0)
        + np.roll(base_y, 1, 1)
        + np.roll(base_y, 2, 0)
    ) // 4
    base_cb = rng.integers(96, 160, size=((h + 64) // 2, (w + 64) // 2), dtype=np.uint8)
    base_cr = rng.integers(96, 160, size=((h + 64) // 2, (w + 64) // 2), dtype=np.uint8)
    for t in range(n):
        ox = (3 * t) % 32 if motion else 0
        oy = (2 * t) % 32 if motion else 0
        y = base_y[oy : oy + h, ox : ox + w].astype(np.uint8).copy()
        cb = base_cb[oy // 2 : oy // 2 + h // 2, ox // 2 : ox // 2 + w // 2].copy()
        cr = base_cr[oy // 2 : oy // 2 + h // 2, ox // 2 : ox // 2 + w // 2].copy()
        # moving bright square (new content each frame)
        sx, sy = (7 * t) % max(w - 24, 1), (5 * t) % max(h - 24, 1)
        y[sy : sy + 16, sx : sx + 16] = 230
        frames.append((y, cb, cr))
    return frames


@pytest.fixture
def small_clip(rng):
    return make_clip(rng, 64, 48, 5)


@pytest.fixture(autouse=True, scope="module")
def _bound_jax_executable_state():
    """Drop live compiled executables at module boundaries: with ~100
    accumulated jit programs the XLA:CPU client segfaults compiling the
    vmapped batch programs (reproducible at the same suite position,
    absent in any standalone run). The persistent on-disk cache keeps the
    recompiles cheap; only in-process state is bounded here."""
    yield
    import jax

    jax.clear_caches()
