"""The port's engine server (``planeverb_tpu_torch.server``) and its C ABI
client (``planeverb_tpu_torch.native.NativeEngineClient``, the g++ build of
``native/src/pv_engine_client.cpp``) on the CPU.

The cases of tests/test_server.py and tests/test_native_engine_client.py,
run against ``EngineServer(device="cpu")`` at 275 Hz, and one scripted
session through the JAX package's server and the port's: the JAX package's
own ``EngineClient`` speaks to both (the protocol is the same byte for
byte), and their answers agree at the golden tolerances of
tests/test_golden_scenes.py (occlusion and wet gain rtol 2e-4 atol 1e-5,
lowpass rtol 2e-4 atol 1e-2, RT60 rtol 5e-3, source directivity rtol 1e-3
atol 1e-4, direction within 1e-4), impulse responses within C1's 1e-6 of
the recording's peak, the delay bit-equal.
"""

import os
import subprocess

import numpy as np
import pytest
import torch

from planeverb_tpu.server import EngineClient as JaxClient
from planeverb_tpu.server import EngineServer as JaxServer
from planeverb_tpu_torch.config import MATERIALS
from planeverb_tpu_torch.server import EngineClient, EngineServer

WALLS = [(5.0, 2.5, 10.0, 1.0), (5.0, 7.5, 10.0, 1.0),
         (2.5, 5.0, 1.0, 10.0), (7.5, 5.0, 1.0, 10.0)]


@pytest.fixture()
def server():
    srv = EngineServer(port=0, device="cpu")
    srv.start_background()
    yield srv
    srv.shutdown()


@pytest.fixture()
def client(server):
    c = EngineClient(*server.address)
    yield c
    c.close()


@pytest.fixture()
def cabi(server):
    from planeverb_tpu_torch.native import NativeEngineClient

    c = NativeEngineClient(*server.address)
    yield c
    c.close()


# ------------------------------------------------ tests/test_server.py cases
def test_full_session(client):
    r = client.call("init", grid_size_x=10, grid_size_y=10,
                    grid_resolution=275, background=False)
    assert r["ok"] and r["fs"] > 0 and r["grid"][0] > 0
    for wall in WALLS:
        r = client.call("add_geometry", x=wall[0], y=wall[1],
                        width=wall[2], height=wall[3], absorption=0.969536)
        assert r["ok"]
    client.call("set_listener_position", x=5.0, z=5.0)
    eid = client.call("emit", x=6.5, z=5.0)["id"]
    r = client.call("step")
    assert r["ok"] and r["iteration"] == 1

    out = client.call("get_output", id=eid)
    assert out["ok"] and out["valid"]
    assert out["occlusion"] > 0 and out["rt60"] > 0
    assert abs(np.hypot(*out["direction"]) - 1.0) < 1e-4

    blocker = client.call("add_geometry", x=5.75, y=5.0, width=0.8,
                          height=3.0, absorption=0.98)["id"]
    client.call("step")
    out2 = client.call("get_output", id=eid)
    assert out2["occlusion"] != out["occlusion"]
    client.call("remove_geometry", id=blocker)

    ir = client.call("get_impulse_response", x=6.5, z=5.0)
    assert ir["ok"] and len(ir["ir"]) > 100
    prof = client.call("profile")
    assert prof["ok"] and "simulate+analyze" in prof["stages"]
    assert client.call("end_emission", id=eid)["ok"]
    assert client.call("exit")["ok"]


def test_geometry_material_names(server, client):
    assert client.call("init", grid_size_x=6, grid_size_y=6,
                       grid_resolution=275, background=False)["ok"]
    r = client.call("add_geometry", x=3.0, y=3.0, width=1.0, height=1.0,
                    absorption="CONCRETE_ROUGH")
    assert r["ok"]
    gid = r["id"]
    ctx = server._ctx
    assert ctx.geometry.get(gid).absorption == MATERIALS.CONCRETE_ROUGH
    assert client.call("update_geometry", id=gid, x=3.0, y=3.0, width=1.0,
                       height=1.0, absorption="grass")["ok"]
    assert ctx.geometry.get(gid).absorption == MATERIALS.GRASS
    r = client.call("add_geometry", x=1.0, y=1.0, width=1.0, height=1.0,
                    absorption="NOT_A_MATERIAL")
    assert not r["ok"] and "unknown material" in r["error"]
    client.call("exit")


def test_manual_step_rejected_while_background(client):
    assert client.call("init", grid_size_x=6, grid_size_y=6,
                       grid_resolution=275, background=True)["ok"]
    r = client.call("step")
    assert not r["ok"] and "background" in r["error"]
    r = client.call("wait_iteration", n=1, timeout=120.0)
    assert r["ok"] and r["iteration"] >= 1
    client.call("exit")


def test_errors_do_not_kill_connection(client):
    r = client.call("get_output", id=0)
    assert not r["ok"] and "init" in r["error"]
    r = client.call("frobnicate")
    assert not r["ok"] and "unknown cmd" in r["error"]
    assert client.call("init", grid_size_x=6, grid_size_y=6,
                       grid_resolution=275, background=False)["ok"]
    r = client.call("emit")
    assert not r["ok"] and "KeyError" in r["error"]
    assert client.call("exit")["ok"]


def test_two_clients_share_engine(server):
    a = EngineClient(*server.address)
    b = EngineClient(*server.address)
    try:
        a.call("init", grid_size_x=6, grid_size_y=6, grid_resolution=275,
               background=False)
        r = b.call("emit", x=3.0, z=3.0)
        assert r["ok"]
        a.call("step")
        assert b.call("get_output", id=r["id"])["ok"]
    finally:
        a.close()
        b.close()


def _mesh_session(client, **init):
    r = client.call("init", grid_size_x=10, grid_size_y=10,
                    grid_resolution=275, background=False, **init)
    assert r["ok"]
    assert client.call("add_geometry", x=5.0, y=5.0, width=1.0, height=1.0,
                       absorption=0.9)["ok"]
    client.call("set_listener_position", x=3.0, y=0.0, z=5.0)
    e = client.call("emit", x=7.0, y=0.0, z=5.0)["id"]
    client.call("step")
    return r, client.call("get_output", id=e)


def test_init_with_mesh(client):
    """init with a mesh count shards the CPU server's Context over that
    many positions of the CPU (factor_mesh: 8 -> 2 x 4); the sharded
    engine publishes the single-device engine's bits."""
    r, sharded = _mesh_session(client, mesh=8)
    assert r["mesh"] == {"x": 2, "y": 4}
    r, single = _mesh_session(client)
    assert "mesh" not in r
    assert sharded == single


def test_cuda_server_never_opens_a_cpu_context():
    """A CUDA server answers init with ok false (a mesh beyond the card
    count; on a host without a card, any init) and keeps the connection:
    it never runs the engine on the CPU instead."""
    srv = EngineServer(port=0)
    srv.start_background()
    c = EngineClient(*srv.address)
    try:
        r = c.call("init", mesh=512)
        assert not r["ok"] and "devices" in r["error"]
        if not torch.cuda.is_available():
            r = c.call("init", grid_resolution=275, background=False)
            assert not r["ok"] and "no CUDA device" in r["error"]
            assert srv._ctx is None
        assert not c.call("step")["ok"]          # still connected
    finally:
        c.close()
        srv.shutdown()


def test_multi_listener_over_wire(client):
    assert client.call("init", grid_size_x=10, grid_size_y=10,
                       grid_resolution=275, background=False,
                       publish="grids")["ok"]
    r = client.call("set_listener_positions",
                    positions=[[3.0, 0.0, 3.0], [7.0, 0.0, 6.0]])
    assert r["ok"] and r["count"] == 2
    eid = client.call("emit", x=6.0, z=5.0)["id"]
    client.call("step")
    v0 = client.call("get_output", id=eid, listener=0)
    v1 = client.call("get_output", id=eid, listener=1)
    assert v0["valid"] and v1["valid"]
    assert v0["occlusion"] != v1["occlusion"]
    v2 = client.call("get_output", id=eid, listener=5)
    assert v2["ok"] and not v2["valid"]
    rows = client.call("get_outputs", listener=1)
    assert rows["ok"] and rows["count"] == 1
    assert rows["rows"][0] == v1["occlusion"]

    assert client.call("init", grid_size_x=10, grid_size_y=10,
                       grid_resolution=275, background=False,
                       publish="cells")["ok"]
    assert client.call("set_listener_positions",
                       positions=[[3.0, 0.0, 3.0], [7.0, 0.0, 6.0]])["ok"]
    eid = client.call("emit", x=6.0, z=5.0)["id"]
    client.call("step")
    c0 = client.call("get_output", id=eid, listener=0)
    c1 = client.call("get_output", id=eid, listener=1)
    assert c0 == v0 and c1 == v1     # the publish modes publish equal rows


# ------------------------------ tests/test_native_engine_client.py cases
def test_full_lifecycle_through_c_abi(cabi, server):
    fs = cabi.init(10.0, 10.0, resolution=275, background=False)
    assert fs > 1000
    gids = [cabi.add_geometry(x, y, w, h, 0.969536) for x, y, w, h in WALLS]
    assert gids == list(range(4))
    cabi.set_listener_position(5.0, 0.0, 5.0)
    eid = cabi.emit(6.5, 0.0, 5.0)
    assert eid == 0
    assert cabi.step() >= 1
    out = cabi.get_output(eid)
    assert out is not None
    assert out["occlusion"] > 0 and out["rt60"] > 0.1
    assert out["direction"][0] > 0.9

    # the C client parses the same floats the Python client reads
    py = EngineClient(*server.address)
    ref = py.call("get_output", id=eid)
    py.close()
    for k in ("occlusion", "wet_gain", "rt60", "lowpass"):
        assert out[k] == ref[k], k
    assert list(out["direction"]) == ref["direction"]

    cabi.update_geometry(gids[0], 5.0, 2.0, 10.0, 1.0, 0.9)
    cabi.remove_geometry(gids[1])
    cabi.update_emission(eid, 4.0, 0.0, 5.0)
    assert cabi.step() >= 2
    out2 = cabi.get_output(eid)
    assert out2 is not None and out2["direction"][0] < -0.9
    cabi.end_emission(eid)
    assert cabi.get_output(eid) is None
    cabi.exit()


def test_invalid_before_init_and_unknown_ids(cabi):
    assert cabi.step() == -1
    assert cabi.init(10.0, 10.0, resolution=275, background=False) > 0
    assert cabi.get_output(12345) is None


def test_connect_refused():
    from planeverb_tpu_torch.native import NativeEngineClient

    with pytest.raises(ConnectionError):
        NativeEngineClient("127.0.0.1", 1)


def test_background_loop_with_wait_iteration(cabi):
    assert cabi.init(10.0, 10.0, resolution=275, background=True) > 1000
    cabi.set_listener_position(5.0, 0.0, 5.0)
    eid = cabi.emit(6.5, 0.0, 5.0)
    assert cabi.wait_iteration(2, timeout_s=120.0)
    out = cabi.get_output(eid)
    assert out is not None and out["occlusion"] > 0
    cabi.exit()


def test_emit_ex_carries_attributes(cabi, server):
    cabi.init(10.0, 10.0, resolution=275, background=False)
    eid = cabi.emit_ex(6.0, 0.0, 5.0, forward=(0.0, 0.0, -1.0),
                       volume_db=-6.0, pattern=1)
    assert eid >= 0
    em = server._ctx.emissions.get_emission(eid)
    assert em.position == (6.0, 0.0, 5.0)
    assert em.forward == (0.0, 0.0, -1.0)
    assert em.volume_db == -6.0 and em.pattern == 1
    assert em.volume_gain == pytest.approx(10 ** (-6.0 / 20.0))


def _fifty(cabi):
    cabi.set_listener_position(5.0, 0.0, 5.0)
    return [cabi.emit(1.0 + 8.0 * (i % 10) / 9.0, 0.0,
                      1.0 + 8.0 * (i // 10) / 4.0) for i in range(50)]


def test_batched_get_outputs_fifty_emitters(cabi, server):
    """50 emitters in one PlaneverbGetOutputs call: every row equals the
    per-id path and the in-process Context's output; an unknown id is
    None."""
    cabi.init(10.0, 10.0, resolution=275, background=False)
    ids = _fifty(cabi)
    cabi.step()
    batch = cabi.get_outputs(ids + [777])
    assert len(batch) == 51 and batch[-1] is None
    assert sum(o is not None for o in batch[:-1]) == 50
    for eid, row in zip(ids, batch):
        single = cabi.get_output(eid)
        assert row == single
        o = server._ctx.get_output(eid)
        assert (row["occlusion"], row["rt60"]) == (np.float32(o.occlusion),
                                                   np.float32(o.rt60))
    cabi.exit()


def test_add_geometry_material_through_c_abi(cabi, server):
    cabi.init(10.0, 10.0, resolution=275, background=False)
    gid = cabi.add_geometry(5.0, 5.0, 2.0, 2.0, "WOOD_PANEL")
    assert gid >= 0
    assert server._ctx.geometry.get(gid).absorption == MATERIALS.WOOD_PANEL
    cabi.update_geometry(gid, 4.0, 4.0, 2.0, 2.0, "CONCRETE_ROUGH")
    box = server._ctx.geometry.get(gid)
    assert box.x == 4.0 and box.absorption == MATERIALS.CONCRETE_ROUGH
    assert cabi.add_geometry(1.0, 1.0, 1.0, 1.0, 'BO"G\\US') == -1
    assert cabi.add_geometry(1.0, 1.0, 1.0, 1.0, "BOGUS") == -1
    cabi.exit()


def test_c_demo_compiles_and_runs(server, tmp_path):
    """examples/engine_client_demo.c, built with gcc against the port's
    library, runs against the port's server, its 50-emitter batched poll
    included."""
    from planeverb_tpu_torch.native import build_engine_client_library

    lib = build_engine_client_library()
    assert os.sep + os.path.join("planeverb_tpu_torch", "build",
                                 "native") + os.sep in lib
    demo = os.path.join(os.path.dirname(__file__), "..", "examples",
                        "engine_client_demo.c")
    exe = tmp_path / "pv_demo"
    subprocess.run(["gcc", demo, "-o", str(exe), lib,
                    f"-Wl,-rpath,{os.path.dirname(lib)}"],
                   check=True, capture_output=True)
    host, port = server.address
    r = subprocess.run([str(exe), host, str(port)], capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert "occlusion" in r.stdout
    assert "batched poll: 50/50 emitters valid in one call" in r.stdout


def test_multi_listener_through_c_abi(cabi, server):
    cabi.init(10.0, 10.0, resolution=275, background=False)
    for x, y, w, h in WALLS:
        cabi.add_geometry(x, y, w, h, 0.969536)
    with pytest.raises(ValueError, match="triples"):
        cabi.set_listener_positions([(1.0, 2.0)])
    assert cabi.set_listener_positions([(5.0, 0.0, 5.0), (4.0, 0.0, 6.0)])
    eid = cabi.emit(6.5, 0.0, 5.0)
    cabi.step()
    v0 = cabi.get_outputs([eid], listener=0)[0]
    v1 = cabi.get_outputs([eid], listener=1)[0]
    assert v0 is not None and v1 is not None
    assert v0["occlusion"] != v1["occlusion"]
    assert cabi.get_outputs([eid], listener=9)[0] is None
    py = EngineClient(*server.address)
    ref = py.call("get_output", id=eid, listener=1)
    py.close()
    assert v1["occlusion"] == ref["occlusion"] and v1["rt60"] == ref["rt60"]
    cabi.exit()


# --------------------------------------- the JAX server against the port's
def _session(client):
    """One scripted session; returns every answer in order."""
    out = [client.call("init", grid_size_x=10, grid_size_y=10,
                       grid_resolution=275, background=False)]
    for x, y, w, h in WALLS:
        out.append(client.call("add_geometry", x=x, y=y, width=w, height=h,
                               absorption=0.969536))
    out.append(client.call("add_geometry", x=6.0, y=4.0, width=0.5,
                           height=0.5, absorption="WOOD_PANEL"))
    out.append(client.call("set_listener_position", x=5.0, z=5.0))
    for x, z in ((6.5, 5.0), (4.0, 4.0), (5.5, 6.2)):
        out.append(client.call("emit", x=x, z=z))
    out.append(client.call("step"))
    out += [client.call("get_output", id=i) for i in range(3)]
    out.append(client.call("get_outputs"))
    out.append(client.call("get_impulse_response", x=6.5, z=5.0))
    out.append(client.call("set_listener_positions",
                           positions=[[5.0, 0.0, 5.0], [4.0, 0.0, 6.0]]))
    out.append(client.call("step"))
    out += [client.call("get_outputs", listener=v) for v in (0, 1)]
    return out


_PARAM_TOL = {"occlusion": (2e-4, 1e-5), "wet_gain": (2e-4, 1e-5),
              "lowpass": (2e-4, 1e-2), "rt60": (5e-3, 0.0)}


def _assert_params(got, want):
    for k, (rtol, atol) in _PARAM_TOL.items():
        np.testing.assert_allclose(got[k], want[k], rtol=rtol, atol=atol,
                                   err_msg=k)
    np.testing.assert_allclose(got["source_directivity"],
                               want["source_directivity"], rtol=1e-3,
                               atol=1e-4)
    assert np.abs(np.subtract(got["direction"], want["direction"])).max() \
        <= 1e-4


def test_session_matches_the_jax_server():
    """The same session through the JAX server and the port's (the JAX
    package's client on both): the same answer keys, integers and flags,
    parameters at the golden tolerances, the IR within 1e-6 of its peak,
    and the published delays bit-equal."""
    answers, delays = [], []
    for srv in (JaxServer(port=0), EngineServer(port=0, device="cpu")):
        srv.start_background()
        c = JaxClient(*srv.address)
        try:
            answers.append(_session(c))
            cells = srv._ctx._published["cells"]
            delays.append({cell: np.asarray(row)[..., 8]
                           for cell, row in cells.items()})
        finally:
            c.close()
            srv.shutdown()
    jax_a, port_a = answers
    assert len(jax_a) == len(port_a)
    for j, t in zip(jax_a, port_a):
        assert sorted(j) == sorted(t) and t["ok"], (j, t)
        if "valid" in j:
            assert j["valid"] and t["valid"]
            _assert_params(t, j)
        elif "rows" in j:
            assert (t["count"], t["ids"]) == (j["count"], j["ids"])
            jr = np.reshape(j["rows"], (-1, 9))
            tr = np.reshape(t["rows"], (-1, 9))
            np.testing.assert_array_equal(tr[:, 8], jr[:, 8])  # valid flags
            for jrow, trow in zip(jr, tr):
                names = ("occlusion", "wet_gain", "rt60", "lowpass")
                _assert_params(
                    dict(zip(names, trow[:4]), direction=trow[4:6],
                         source_directivity=trow[6:8]),
                    dict(zip(names, jrow[:4]), direction=jrow[4:6],
                         source_directivity=jrow[6:8]))
        elif "ir" in j:
            assert t["fs"] == j["fs"] and len(t["ir"]) == len(j["ir"])
            peak = np.abs(j["ir"]).max()
            assert peak > 0
            assert np.abs(np.subtract(t["ir"], j["ir"])).max() <= 1e-6 * peak
        else:
            assert t == j
    assert delays[0].keys() == delays[1].keys()
    for cell in delays[0]:
        np.testing.assert_array_equal(delays[1][cell], delays[0][cell])
