"""The cells of ``BENCHMARK.json`` and the files they name.

Everything that belongs to one configuration, traffic mix, per-layer metric
or cell sits in a file of its own, found by its name:

- a configuration: the ``file`` its entry names (``configs/<name>.json``);
- a traffic mix: ``traffic/<traffic>.json``, read by ``traffic.py``;
- a per-layer metric: ``metrics/<name>.py``, with ``UNIT``, ``MOVES``,
  ``SPANS`` and ``read(trace, info)``;
- a cell's limits for the comparison that decides ``correct``:
  ``limits/<cell>.json``.

Which cells a metric is read in is said only in ``BENCHMARK.json``: its
``workloads`` key, or every cell where it has none (:func:`applies`). A later
change adds a cell, a configuration or a metric as new files and new
entries, and edits none of these.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os

HERE = os.path.dirname(os.path.abspath(__file__))


def load(root: str) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def _json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list
    per_layer: list

    def reference_params(self) -> dict:
        """The configuration as the reference takes it."""
        c = self.config
        return {"world_x": float(c["world_m"][0]),
                "world_y": float(c["world_m"][1]),
                "resolution": int(c["resolution_hz"]),
                "offset_x": float(c["offset_m"][0]),
                "offset_y": float(c["offset_m"][1]),
                "absorbing": c["boundary"] == "absorbing"}

    def metric_modules(self) -> dict:
        """{name: module} of this cell's per-layer metrics."""
        return {m["name"]: metric_module(m["name"]) for m in self.per_layer}


def applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def resolve(bench: dict, workload: str, root: str) -> Cell:
    """The cell named ``workload``, with its files read."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    w = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    config = _json(os.path.join(root, configs[w["config"]]["file"]))
    traffic = _json(os.path.join(HERE, "traffic", w["traffic"] + ".json"))
    limits = _json(os.path.join(HERE, "limits", workload + ".json"))
    return Cell(workload, int(w["chips"]), config, traffic, limits,
                [m for m in bench["end_to_end"] if applies(m, workload)],
                [m for m in bench["per_layer"] if applies(m, workload)])


def metric_module(name: str):
    """The reader of per-layer metric ``name``: ``metrics/<name>.py``."""
    path = os.path.join(HERE, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(
        "benchmark_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
