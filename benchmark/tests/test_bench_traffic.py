"""The traffic generator: the same seed gives the same inputs, and every
listener position, emitter and door lies where the scene leaves room,
including the 5 x 5 FloorPlanScene tiling of the 126 m world."""

import numpy as np
import pytest
import torch

import standin
from benchmark import cells, reference, scenes, traffic

BENCH = cells.load(standin.ROOT)
SEEDS = (0, 2 ** 31 + 7, 987654321123)
REFRESHES = 1500


def _cell(workload):
    cell = cells.resolve(BENCH, workload, standin.ROOT)
    p = cell.reference_params()
    g = reference.grid(p["world_x"], p["world_y"], p["resolution"])
    return cell, g, scenes.load(cell.config["scene"])


def _free(g, boxes):
    beta, _ = reference.fields(g, boxes, "cpu")
    return beta.numpy() == 1.0


def test_floorplan_tiling():
    _, g, scene = _cell("floorplan-126m.walk-cells")
    assert len(scene["boxes"]) == 450
    xs = [b[0] for b in scene["boxes"]]
    assert min(xs) == pytest.approx(0.5) and max(xs) == pytest.approx(125.5)
    assert g.nx == g.ny == 964


@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_positions_lie_in_free_cells(workload):
    cell, g, scene = _cell(workload)
    static = _free(g, scene["boxes"])
    for seed in SEEDS:
        t = traffic.make(g, scene, cell.traffic, seed)
        doors = ([t.door(i) for i in range(t.door_positions)]
                 if t.door_way is not None else [])
        free = static.copy()
        for d in doors:
            free &= _free(g, [d])
        if doors:
            # closed, the door blocks the doorway; open, it lies inside
            # the divider it slides under
            closed = min(range(len(doors)), key=lambda k: abs(
                doors[k][0] - sum(t.door_way["x"]) / 2))
            opened = max(range(len(doors)), key=lambda k: abs(
                doors[k][0] - sum(t.door_way["x"]) / 2))
            assert (~_free(g, [doors[closed]]) & static).sum() > 0
            assert not (~_free(g, [doors[opened]]) & static).any()
        points = list(t.emitters)
        for i in range(0, REFRESHES, 7):
            points += t.listeners(i)
        for x, z in points:
            i, j = g.cell(x, z)
            assert 0 <= i < g.grid_x and 0 <= j < g.grid_y
            assert free[i, j], (workload, seed, x, z)


def test_same_seed_same_inputs():
    cell, g, scene = _cell("hugeroom-25m.door")
    a = traffic.make(g, scene, cell.traffic, 42)
    b = traffic.make(g, scene, cell.traffic, 42)
    # b's walk is asked out of order: positions do not depend on the order
    late = b.listeners(900)
    assert [a.listeners(i) for i in range(0, 1000, 50)] == \
        [b.listeners(i) for i in range(0, 1000, 50)]
    assert a.listeners(900) == late
    assert a.emitters == b.emitters and a.boxes_at(5) == b.boxes_at(5)
    c = traffic.make(g, scene, cell.traffic, 43)
    assert c.emitters != a.emitters


def test_split_screen_walks_apart():
    cell, g, scene = _cell("hugeroom-25m.split4")
    t = traffic.make(g, scene, cell.traffic, 5)
    assert len(t.listeners(0)) == 4
    assert len({w.start for w in t.walks}) == 4


def test_walk_speed():
    cell, g, scene = _cell("hugeroom-25m.walk")
    t = traffic.make(g, scene, cell.traffic, 9)
    step = cell.traffic["speed_m_s"] * cell.traffic["refresh_period_s"]
    pts = np.array([t.listeners(i)[0] for i in range(400)])
    d = np.hypot(*np.diff(pts, axis=0).T)
    assert d.max() <= step * (1 + 1e-9)
    assert d.sum() == pytest.approx(step * 399, rel=0.05)


# digests of each mix's inputs (emitters, listeners of every 7th of 3000
# refreshes, boxes of every 13th of 300) for seeds 0-2, pinned before the
# audio mix and its clips' stream existed: adding a stream moved none
PINNED = {
    "hugeroom-25m.walk": ("a21b9d99e0e8303a", "6d00c3f9fb7d01b5",
                          "5af96df54e368449"),
    "hugeroom-25m.split4": ("97d161622bd169b5", "d90cb67f48b891df",
                            "332fad51d0fc139a"),
    "hugeroom-25m.door": ("7e1eed6a28591c05", "0ebff5abbd238064",
                          "2855f1b6e902c663"),
}


@pytest.mark.parametrize("workload", sorted(PINNED))
def test_inputs_pinned(workload):
    import hashlib
    import json

    cell, g, scene = _cell(workload)
    for seed, want in enumerate(PINNED[workload]):
        t = traffic.make(g, scene, cell.traffic, seed)
        got = hashlib.sha256(json.dumps(
            [t.emitters, [t.listeners(i) for i in range(0, 3000, 7)],
             [t.boxes_at(i) for i in range(0, 300, 13)]]).encode())
        assert got.hexdigest()[:16] == want, (workload, seed)
        assert t.audio is None and t.clips is None
