"""Failure detection and elastic recovery (SURVEY.md §5 failure row).

GOPs are the recovery unit: they are closed under prediction (SURVEY.md
§3.2), so a failed shard's GOP list can be re-encoded on any surviving
engine and the ordered mux is indifferent to who produced a packet. The
fault-injection hook exercises the re-dispatch path in CI (the driver-less
stand-in for real chip loss).
"""

from __future__ import annotations

import logging
from typing import Callable

from ..codec.bitstream import FramePacket
from ..codec.golden import Frame

log = logging.getLogger("video_encoder.failover")


class GopFailure(RuntimeError):
    """Raised when a GOP's encode result is lost or invalid."""


# What counts as a recoverable engine failure. XLA device errors
# (jaxlib's XlaRuntimeError, device OOMs) are RuntimeError subclasses, so
# catching RuntimeError covers real chip loss as well as injected
# GopFailure; OSError covers transport/tunnel drops. Programming errors
# (TypeError, ValueError, AssertionError) still propagate — retrying those
# would loop forever on a deterministic bug.
RECOVERABLE = (RuntimeError, OSError)


class FaultInjector:
    """Test hook: fails the Nth encode attempt of the listed GOP indices."""

    def __init__(self, fail_gops: set[int], times: int = 1):
        self._remaining = {g: times for g in fail_gops}
        self.injected = 0

    def check(self, gop_index: int) -> None:
        if self._remaining.get(gop_index, 0) > 0:
            self._remaining[gop_index] -= 1
            self.injected += 1
            raise GopFailure(f"injected fault on gop {gop_index}")


def encode_gops_with_recovery(
    primary,
    gops: list[list[Frame]],
    first_indices: list[int],
    fallback=None,
    max_retries: int = 2,
    fault: FaultInjector | None = None,
) -> list[FramePacket]:
    """Encode GOPs with per-GOP retry and engine failover.

    primary/fallback expose encode_gop(frames, first_index) ->
    (packets, stats). A GOP that fails `max_retries` times on the primary
    is re-dispatched to the fallback engine (the "survivors"); packets
    arrive whenever they arrive — the OrderedMux reorders (C13).
    """
    packets: list[FramePacket] = []
    for gop, first in zip(gops, first_indices):
        attempt = 0
        while True:
            engine = primary if attempt < max_retries or fallback is None else fallback
            try:
                if fault is not None:
                    fault.check(first)
                pk, _ = engine.encode_gop(gop, first)
                packets.extend(pk)
                break
            except RECOVERABLE as e:
                attempt += 1
                log.warning("gop %d failed (attempt %d): %s", first, attempt, e)
                # bounded total budget: the fallback gets its own max_retries
                # window, then the failure propagates (never loop forever on
                # a persistently failing pair of engines)
                budget = max_retries if fallback is None else 2 * max_retries
                if attempt > budget:
                    raise
    return packets
