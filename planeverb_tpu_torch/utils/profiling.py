"""Per-stage timing + throughput accounting (ScopedTimer/PROFILE_* analog).

The reference gates RAII microsecond timers behind compile-time flags
(PvDefinitions.h:31-58, Util/ScopedTimer.h). Here timing is
always collected (cheap) and surfaced as a structured dict; cell-updates/s
and recording-bandwidth metrics derive from the grid parameters.

Host clock only: on a CUDA device a stage that does not end in a host copy
or ``torch.cuda.synchronize()`` times the enqueue, not the device work.
Kernel times come from CUDA events (``chip_smoke.py``).
"""

from __future__ import annotations

import contextlib
import time

__all__ = ["StageTimer", "Stats", "throughput"]


class Stats:
    """Rolling per-stage wall-clock stats."""

    def __init__(self):
        self.totals: dict[str, float] = {}
        self.counts: dict[str, int] = {}
        self.last: dict[str, float] = {}

    def record(self, stage: str, seconds: float) -> None:
        self.totals[stage] = self.totals.get(stage, 0.0) + seconds
        self.counts[stage] = self.counts.get(stage, 0) + 1
        self.last[stage] = seconds

    def mean(self, stage: str) -> float:
        c = self.counts.get(stage, 0)
        return self.totals.get(stage, 0.0) / c if c else 0.0

    def summary(self) -> dict:
        return {s: {"mean_s": self.mean(s), "last_s": self.last[s],
                    "count": self.counts[s]} for s in self.totals}


class StageTimer:
    def __init__(self, stats: Stats | None = None):
        self.stats = stats or Stats()

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.stats.record(name, time.perf_counter() - t0)


def throughput(params, seconds: float) -> dict:
    """Roofline accounting for one sim pass (cell-updates/s headline)."""
    cells = params.nx * params.ny
    updates = cells * params.response_length
    rec_bytes = updates * 4  # f32 pressure recording
    return {
        "cell_updates": updates,
        "cell_updates_per_s": updates / seconds if seconds > 0 else 0.0,
        "recording_bytes": rec_bytes,
        "recording_gb_per_s": rec_bytes / seconds / 1e9 if seconds > 0 else 0.0,
    }
