"""Tracing / profiling / observability (SURVEY.md §5 rows 1 and 5).

- StageTimer: per-stage wall-clock accumulation for the host pipeline
  (read, dispatch, collective, mux — the reference's at-most-printf timing
  surface, made structured).
- trace(): context manager around jax.profiler for TensorBoard-format
  device traces of the XLA programs.
- EventLog: JSONL structured event stream ({ts, event, **fields}) so runs
  are machine-parseable.
"""

from __future__ import annotations

import contextlib
import json
import time
from collections import defaultdict
from typing import IO


class StageTimer:
    """Accumulates wall-clock per named stage; thread-unsafe by design
    (single-writer host pipeline, SURVEY.md §5 race-detection row)."""

    def __init__(self):
        self.totals: dict[str, float] = defaultdict(float)
        self.counts: dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def report(self) -> dict:
        return {
            name: {"total_s": round(t, 4), "count": self.counts[name],
                   "mean_ms": round(1e3 * t / max(self.counts[name], 1), 3)}
            for name, t in sorted(self.totals.items())
        }

    def to_json(self) -> str:
        return json.dumps(self.report())


@contextlib.contextmanager
def trace(log_dir: str | None):
    """Device-side profiler trace (TensorBoard format); no-op if log_dir is
    empty. A profiler that cannot start raises: a requested trace is never
    silently skipped."""
    if not log_dir:
        yield
        return
    import jax

    with jax.profiler.trace(log_dir):
        yield


class EventLog:
    """JSONL event stream; one line per event, flushed eagerly."""

    def __init__(self, sink: IO[str]):
        self._sink = sink
        self._t0 = time.time()

    def emit(self, event: str, **fields) -> None:
        rec = {"ts": round(time.time() - self._t0, 4), "event": event, **fields}
        self._sink.write(json.dumps(rec) + "\n")
        self._sink.flush()
