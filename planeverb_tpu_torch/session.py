"""Engine-state checkpoint/resume: save a running Context, restore it later.

The reference has no engine persistence at all — the only artifacts are the
editor's .pv scene files and WAV dumps, and ``PlaneverbConfig.
tempFileDirectory`` is validated but never used (SURVEY.md §5,
PvContext.cpp:103). This module is the missing capability: one JSON document
captures the full dynamic engine state — config (including overridden
physical constants), geometry registry *with ids and paint order*, live
emitters with ids, and the listener — so a game session or long experiment
can stop and resume with every handle still valid.

Device state is deliberately NOT saved: the wave field is transient (each
iteration re-simulates from silence) and the analyzer results are a pure
function of (geometry, listener), so ``Context.step()`` after restore
reproduces them.
"""

from __future__ import annotations

import dataclasses
import json

from planeverb_tpu_torch.config import (BoundaryType, PhysicalConstants,
                                  PlaneverbConfig)
from planeverb_tpu_torch.scene import AABB

__all__ = ["save_session", "load_session", "SESSION_FORMAT"]

SESSION_FORMAT = "planeverb_tpu.session"
# v3 adds the multi-listener list ("listeners"); v2 added emit-time
# emitter attributes (forward, volume_db, pattern); v1 documents
# (position-only emitter rows) still load.
SESSION_VERSION = 3


def _session_dict(ctx) -> dict:
    geo = [[gid, b.x, b.y, b.width, b.height, b.absorption]
           for gid, b in ctx.geometry.items()]
    emitters = [[eid, *em.position, *em.forward, em.volume_db, em.pattern]
                for eid, em in
                sorted(ctx.emissions.snapshot_emissions().items())]
    cfg = dataclasses.asdict(ctx.config)
    cfg["grid_boundary_type"] = int(ctx.config.grid_boundary_type)
    return {
        "format": SESSION_FORMAT,
        "version": SESSION_VERSION,
        "config": cfg,
        "listener": list(ctx.get_listener_position()),
        "listeners": [list(p) for p in ctx.get_listener_positions()],
        "geometry": geo,
        "geometry_free": ctx.geometry.free_ids(),
        "emitters": emitters,
        "emitters_free": ctx.emissions.free_ids(),
    }


def save_session(ctx, path_or_file) -> None:
    """Serialize a Context's full dynamic state to JSON."""
    data = json.dumps(_session_dict(ctx), indent=1)
    if hasattr(path_or_file, "write"):
        path_or_file.write(data)
    else:
        with open(path_or_file, "w") as f:
            f.write(data)


def load_session(path_or_file, **context_kwargs):
    """Reconstruct a Context from :func:`save_session` output.

    Geometry and emitter ids are restored exactly, so handles saved by the
    caller (e.g. in game-object components) remain valid. Run ``step()`` on
    the returned context to repopulate analyzer results.
    """
    from planeverb_tpu_torch.core.context import Context

    if hasattr(path_or_file, "read"):
        doc = json.load(path_or_file)
    else:
        with open(path_or_file) as f:
            doc = json.load(f)
    if doc.get("format") != SESSION_FORMAT:
        raise ValueError(f"not a {SESSION_FORMAT} document")
    if doc.get("version", 0) > SESSION_VERSION:
        raise ValueError(f"session version {doc['version']} is newer than "
                         f"supported ({SESSION_VERSION})")

    cfg_d = dict(doc["config"])
    cfg_d["grid_boundary_type"] = BoundaryType(cfg_d["grid_boundary_type"])
    cfg_d["constants"] = PhysicalConstants(**cfg_d["constants"])
    config = PlaneverbConfig(**cfg_d)

    ctx = Context(config, **context_kwargs)
    ctx.geometry.restore(
        [(gid, AABB(x, y, w, h, a)) for gid, x, y, w, h, a
         in doc["geometry"]],
        free=doc.get("geometry_free"))
    ctx.emissions.restore(
        [(row[0], _emission_row(row[1:])) for row in doc["emitters"]],
        free=doc.get("emitters_free"))
    listeners = doc.get("listeners")       # v3 multi-listener list
    if listeners:
        ctx.set_listener_positions([tuple(p) for p in listeners])
    else:
        ctx.set_listener_position(*doc["listener"])
    return ctx


def _emission_row(vals):
    """[x,y,z] (v1) or [x,y,z,fx,fy,fz,volume_db,pattern] (v2) -> Emission."""
    from planeverb_tpu_torch.core.emissions import Emission

    if len(vals) == 3:
        return Emission(tuple(vals))
    x, y, z, fx, fy, fz, vol, pat = vals
    return Emission((x, y, z), (fx, fy, fz), float(vol), int(pat))
