"""Real multi-process jax.distributed exercise (SURVEY.md §2.1/§5 comm
backend rows; VERDICT r1 missing #1): N localhost CPU processes + gloo run
the SAME shard_map GOP-parallel program as single-process, and every worker
asserts its shard's bytes equal the single-device encode.

Spawns subprocesses (one jax runtime each), so this test is slower than the
fake-device ones and skips cleanly where process spawn is unavailable.
"""

import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from video_encoder.parallel import multiprocess as mp


@pytest.mark.parametrize("n,rc", [(2, "none"), (2, "bitrate")])
def test_multiprocess_gop_parallel_byte_equal(n, rc):
    extra = ["--gops", "4", "--frames", "3", "--width", "96", "--height", "64",
             "--qp", "28", "--search", "diamond", "--rc", rc]
    try:
        rows = mp.spawn(n, 13200 + n + (7 if rc != "none" else 0), extra)
    except (OSError, RuntimeError) as e:
        if "worker exited" in str(e):
            raise
        pytest.skip(f"cannot spawn workers here: {e}")
    assert len(rows) == n
    assert sum(len(r["owned_gops"]) for r in rows) == 4
    assert all(r["mismatched_gops"] == 0 for r in rows)
