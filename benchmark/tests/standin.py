"""The 10 m, 275 Hz stand-in cell the CPU tests run: the real traffic files
and end-to-end metrics on a small world (29 x 29 cells, 435 steps)."""

from __future__ import annotations

import json
import os

from benchmark import cells

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
ROOT = os.path.dirname(cells.HERE)


def config(publish: str = "grids") -> dict:
    with open(os.path.join(DATA, "standin-10m-275hz.json")) as f:
        cfg = json.load(f)
    cfg["publish"] = publish
    return cfg


def limits() -> dict:
    with open(os.path.join(DATA, "standin-limits.json")) as f:
        return json.load(f)


def cell(traffic: str = "walk", publish: str = "grids") -> cells.Cell:
    bench = cells.load(ROOT)
    with open(os.path.join(cells.HERE, "traffic", traffic + ".json")) as f:
        mix = json.load(f)
    name = f"standin.{traffic}"

    def applies(m):
        return ("workloads" not in m
                or any(w.endswith("." + traffic) for w in m["workloads"]))

    return cells.Cell(name, 1, config(publish), mix, limits(),
                      [m for m in bench["end_to_end"] if applies(m)],
                      [m for m in bench["per_layer"] if applies(m)])
