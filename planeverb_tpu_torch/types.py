"""Public output/value types (analog of reference PvTypes.h:63-80)."""

from __future__ import annotations

import dataclasses

__all__ = ["PlaneverbOutput", "INVALID_DRY_GAIN", "INVALID_ID", "vec2"]

INVALID_DRY_GAIN = -1.0   # PV_INVALID_DRY_GAIN sentinel (PvTypes.h:80)
INVALID_ID = -1


@dataclasses.dataclass(frozen=True)
class vec2:
    x: float = 0.0
    y: float = 0.0


@dataclasses.dataclass(frozen=True)
class PlaneverbOutput:
    """Final acoustic output for an emitter (PvTypes.h:63-71).

    ``occlusion == INVALID_DRY_GAIN`` marks an invalid emitter/position.
    """

    occlusion: float = 0.0
    wet_gain: float = 0.0
    rt60: float = 0.0
    lowpass: float = 0.0
    direction: vec2 = vec2()
    source_directivity: vec2 = vec2()

    @property
    def valid(self) -> bool:
        return self.occlusion != INVALID_DRY_GAIN


def invalid_output() -> PlaneverbOutput:
    return PlaneverbOutput(occlusion=INVALID_DRY_GAIN)
