"""PSNR and per-frame stats (reference component C17, SURVEY.md §2/§5).

Structured per-frame records {frame, type, qp, bits, psnr_y/cb/cr, ms} and a
run summary, so BASELINE.md rows are machine-generated (SURVEY.md §5
"Metrics / logging / observability").
"""

from __future__ import annotations

import dataclasses
import json
import math

import numpy as np


def psnr(a: np.ndarray, b: np.ndarray, peak: float = 255.0) -> float:
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    mse = float(np.mean((a - b) ** 2))
    if mse == 0:
        return math.inf
    return 10.0 * math.log10(peak * peak / mse)


@dataclasses.dataclass
class FrameStats:
    index: int
    frame_type: int           # 0=I, 1=P
    base_qp: int
    bits: int
    psnr_y: float = 0.0
    psnr_cb: float = 0.0
    psnr_cr: float = 0.0
    ms: float = 0.0
    n_intra_mb: int = 0
    n_inter_mb: int = 0

    def to_json(self) -> str:
        d = dataclasses.asdict(self)
        d["frame_type"] = "IP"[self.frame_type]
        return json.dumps(d)


@dataclasses.dataclass
class RunSummary:
    frames: int = 0
    total_bits: int = 0
    total_ms: float = 0.0
    sum_psnr_y: float = 0.0
    survivor_gops: int = 0  # GOPs a failover survivor engine encoded

    def add(self, s: FrameStats) -> None:
        self.frames += 1
        self.total_bits += s.bits
        self.total_ms += s.ms
        if math.isfinite(s.psnr_y):
            self.sum_psnr_y += s.psnr_y

    @property
    def fps(self) -> float:
        return self.frames / (self.total_ms / 1000.0) if self.total_ms else 0.0

    @property
    def mean_psnr_y(self) -> float:
        return self.sum_psnr_y / self.frames if self.frames else 0.0

    @property
    def kbits_per_frame(self) -> float:
        return self.total_bits / 1000.0 / self.frames if self.frames else 0.0

    def to_json(self) -> str:
        return json.dumps(
            {
                "frames": self.frames,
                "fps": round(self.fps, 3),
                "mean_psnr_y": round(self.mean_psnr_y, 3),
                "kbits_per_frame": round(self.kbits_per_frame, 2),
                "total_bits": self.total_bits,
            }
        )
