"""The port's ObjectManager and sessions (planeverb_tpu_torch.core.objects,
planeverb_tpu_torch.session) on its CPU Context: the cases of
tests/test_objects.py and tests/test_session.py, a session saved by either
package loaded by the other, and the Context's device reaching
``load_session``.
"""

import io
import re

import numpy as np
import pytest

import planeverb_tpu as jpv
import planeverb_tpu_torch as pv
from planeverb_tpu_torch.core.objects import SIZE_EPSILON

CFG = pv.PlaneverbConfig(grid_size_x=10.0, grid_size_y=10.0,
                         grid_resolution=275)
JCFG = jpv.PlaneverbConfig(grid_size_x=10.0, grid_size_y=10.0,
                           grid_resolution=275)


def _ctx(scene=None):
    c = pv.Context(CFG, scene=scene, device="cpu")
    c.set_listener_position(5.0, 1.6, 5.0)   # standing listener head height
    return c


# ------------------------------------------------------------ ObjectManager
def test_head_slice_culling_and_sync():
    ctx = _ctx()
    om = pv.ObjectManager(ctx)
    wall = pv.AABB3D(x=5.0, y=1.5, z=5.0, width=1.0, height=3.0, depth=4.0,
                     absorption=0.95)
    oid = om.add(wall)
    assert om.in_head_slice(oid)
    assert len(ctx.geometry.snapshot()[1]) == 1
    crate = pv.AABB3D(x=3.0, y=0.25, z=3.0, width=0.5, height=0.5, depth=0.5)
    oid2 = om.add(crate)
    assert not om.in_head_slice(oid2)
    assert len(ctx.geometry.snapshot()[1]) == 1

    ctx.set_listener_position(5.0, 0.4, 5.0)
    stats = om.sync()
    assert om.in_head_slice(oid2)
    assert stats["added"] == 1 and stats["updated"] == 1
    assert len(ctx.geometry.snapshot()[1]) == 2

    ctx.set_listener_position(5.0, 10.0, 5.0)
    stats = om.sync()
    assert stats["removed"] == 2
    assert ctx.geometry.snapshot()[1] == []

    ctx.set_listener_position(5.0, 1.0, 5.0)
    om.sync()
    assert om.in_head_slice(oid) and not om.in_head_slice(oid2)


def test_projection_matches_calculate_aabb():
    ctx = _ctx()
    om = pv.ObjectManager(ctx)
    om.add(pv.AABB3D(x=2.0, y=1.0, z=7.0, width=1.5, height=4.0, depth=0.6,
                     absorption=0.9))
    b = ctx.geometry.snapshot()[1][0]
    assert (b.x, b.y) == (2.0, 7.0)
    assert b.width == pytest.approx(1.5 - SIZE_EPSILON)
    assert b.height == pytest.approx(0.6 - SIZE_EPSILON)
    assert b.absorption == 0.9


def test_child_bounds_merge_update_and_remove():
    ctx = _ctx()
    om = pv.ObjectManager(ctx)
    children = [
        pv.AABB3D(x=0.0, y=1.0, z=4.0, width=1.0, height=2.0, depth=1.0,
                  absorption=0.9),
        pv.AABB3D(x=2.0, y=2.0, z=6.0, width=1.0, height=4.0, depth=1.0),
    ]
    oid = om.add(children)
    merged = om.get_bounds(oid)
    assert merged.width == pytest.approx(3.0)
    assert merged.absorption == 0.9
    om.update(oid, pv.AABB3D(x=8.0, y=1.0, z=8.0, width=1.0, height=3.0,
                             depth=1.0, absorption=0.8))
    boxes = ctx.geometry.snapshot()[1]
    assert len(boxes) == 1 and boxes[0].x == 8.0
    with pytest.raises(KeyError):
        om.update(999, children[0])
    om.remove(oid)
    assert ctx.geometry.snapshot()[1] == []
    om.remove(oid)  # idempotent


def test_object_material_names():
    ctx = _ctx()
    om = pv.ObjectManager(ctx)
    oid = om.add(pv.AABB3D(5.0, 1.0, 5.0, 1.0, 4.0, 1.0),
                 absorption="WOOD_PANEL")
    assert om.get_bounds(oid).absorption == pv.MATERIALS.WOOD_PANEL
    om.update(oid, pv.AABB3D(5.0, 1.0, 5.0, 1.0, 4.0, 1.0),
              absorption="drapery_heavy")
    assert om.get_bounds(oid).absorption == pv.MATERIALS.DRAPERY_HEAVY


def test_objects_change_acoustics_as_in_jax():
    """An ObjectManager wall blocks sound only while the listener's head is
    in its slice; the port's occlusions equal the JAX Context's within the
    golden occlusion tolerance (rel 1e-4) at each stage."""
    def run(mod, ctx):
        ctx.set_listener_position(2.0, 1.5, 5.0)
        ctx.step()
        occ = [ctx.result_at(8.0, 5.0).occlusion]
        om = mod.ObjectManager(ctx)
        om.add(mod.AABB3D(x=5.0, y=1.5, z=5.0, width=0.75, height=3.0,
                          depth=8.0, absorption=0.98))
        ctx.step()
        occ.append(ctx.result_at(8.0, 5.0).occlusion)
        ctx.set_listener_position(2.0, -5.0, 5.0)
        om.sync()
        ctx.step()
        occ.append(ctx.result_at(8.0, 5.0).occlusion)
        return occ

    got = run(pv, pv.Context(CFG, device="cpu"))
    want = run(jpv, jpv.Context(JCFG))
    assert got[1] < 0.6 * got[0]
    assert abs(got[2] - got[0]) < 1e-5 * max(got[0], 1.0)
    np.testing.assert_allclose(got, want, rtol=1e-4)


# ----------------------------------------------------------------- sessions
def _build(mod, ctx):
    ctx.set_listener_position(5.0, 0.0, 5.0)
    extra = ctx.geometry.add(mod.AABB(4.0, 4.0, 0.5, 0.5, 0.5))
    hole = ctx.geometry.add(mod.AABB(6.0, 6.0, 0.5, 0.5, 0.5))
    ctx.geometry.remove(hole)            # free-list hole to round-trip
    e0 = ctx.emissions.emit(6.5, 0.0, 5.0)
    e1 = ctx.emissions.emit(3.0, 0.0, 5.0, forward=(0.0, 0.0, 1.0),
                            volume_db=-4.0, pattern=1)
    ctx.emissions.end(e0)                # emitter hole too
    return extra, hole, e1


def _roundtrip(ctx, **kw):
    buf = io.StringIO()
    pv.save_session(ctx, buf)
    buf.seek(0)
    return pv.load_session(buf, device="cpu", **kw)


def test_session_state_survives_roundtrip():
    ctx = pv.Context(CFG, scene=pv.demo_scene("SmallRoom"), device="cpu")
    extra, hole, e1 = _build(pv, ctx)
    ctx2 = _roundtrip(ctx)
    assert ctx2.device.type == "cpu"
    assert ctx2.config == ctx.config
    assert ctx2.get_listener_position() == (5.0, 0.0, 5.0)
    assert ctx2.geometry.items() == ctx.geometry.items()
    assert ctx2.geometry.get(extra) is not None
    assert ctx2.geometry.get(hole) is None
    assert ctx2.emissions.snapshot() == ctx.emissions.snapshot()
    assert ctx2.emissions.get_emission(e1) == ctx.emissions.get_emission(e1)
    # freed ids are reused after the restore, in the live order
    assert ctx2.geometry.add(pv.AABB(1.0, 1.0, 0.5, 0.5, 0.5)) == hole
    assert ctx2.emissions.emit(1.0, 0.0, 1.0) == 0
    # the same geometry and listener reproduce the results
    ctx.step()
    ctx2.step()
    a, b = ctx.get_output(e1), ctx2.get_output(e1)
    assert a.valid and a == b


def test_session_rejects_foreign_and_newer_documents(tmp_path):
    with pytest.raises(ValueError, match="not a"):
        pv.load_session(io.StringIO('{"format": "something-else"}'),
                        device="cpu")
    ctx = pv.Context(CFG, device="cpu")
    _build(pv, ctx)
    buf = io.StringIO()
    pv.save_session(ctx, buf)
    doc = re.sub(r'"version": \d+', '"version": 99', buf.getvalue())
    with pytest.raises(ValueError, match="newer"):
        pv.load_session(io.StringIO(doc), device="cpu")
    path = str(tmp_path / "session.json")
    pv.save_session(ctx, path)
    assert pv.load_session(path, device="cpu").geometry.items() == \
        ctx.geometry.items()


def test_session_free_list_order_and_listeners():
    ctx = pv.Context(CFG, device="cpu")
    ids = [ctx.geometry.add(pv.AABB(float(i), 1.0, 0.5, 0.5, 0.5))
           for i in range(4)]
    ctx.geometry.remove(ids[3])
    ctx.geometry.remove(ids[1])
    e = [ctx.emissions.emit(float(i), 0.0, 1.0) for i in range(3)]
    ctx.emissions.end(e[2])
    ctx.emissions.end(e[0])
    positions = [(3.0, 0.0, 3.0), (7.0, 0.0, 6.0)]
    ctx.set_listener_positions(positions)
    ctx2 = _roundtrip(ctx)
    assert ctx2.get_listener_positions() == positions
    assert ctx2.geometry.add(pv.AABB(9.0, 9.0, 0.5, 0.5, 0.5)) == ids[1]
    assert ctx2.geometry.add(pv.AABB(9.0, 8.0, 0.5, 0.5, 0.5)) == ids[3]
    assert ctx2.emissions.emit(9.0, 0.0, 9.0) == e[0]
    assert ctx2.emissions.emit(9.0, 0.0, 8.0) == e[2]


def test_load_session_defaults_to_cuda():
    """load_session's Context keywords reach the port's Context: without
    device= it asks for the card, which this host lacks."""
    ctx = pv.Context(CFG, device="cpu")
    buf = io.StringIO()
    pv.save_session(ctx, buf)
    buf.seek(0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pv.load_session(buf)


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_session_crosses_packages(direction):
    """Both packages write the same v3 document: a session saved by one
    loads in the other with every id, free list, emitter attribute and
    listener, and the loaded Context's emitter outputs equal the saving
    Context's within the golden tolerances (rel 1e-4)."""
    if direction == "jax_to_port":
        src = jpv.Context(JCFG, scene=jpv.demo_scene("SmallRoom"))
        _, _, e1 = _build(jpv, src)
        buf = io.StringIO()
        jpv.save_session(src, buf)
        buf.seek(0)
        dst = pv.load_session(buf, device="cpu")
    else:
        src = pv.Context(CFG, scene=pv.demo_scene("SmallRoom"), device="cpu")
        _, _, e1 = _build(pv, src)
        buf = io.StringIO()
        pv.save_session(src, buf)
        buf.seek(0)
        dst = jpv.load_session(buf)
    assert dst.geometry.items() == [(g, type(dst.geometry.get(g))(
        b.x, b.y, b.width, b.height, b.absorption))
        for g, b in src.geometry.items()]
    assert dst.emissions.snapshot() == src.emissions.snapshot()
    a, b = src.emissions.get_emission(e1), dst.emissions.get_emission(e1)
    assert (a.position, a.forward, a.volume_db, a.pattern) == \
        (b.position, b.forward, b.volume_db, b.pattern)
    assert dst.get_listener_positions() == src.get_listener_positions()
    src.step()
    dst.step()
    x, y = src.get_output(e1), dst.get_output(e1)
    assert x.valid and y.valid
    for f in ("occlusion", "wet_gain", "rt60", "lowpass"):
        np.testing.assert_allclose(getattr(y, f), getattr(x, f), rtol=1e-4,
                                   err_msg=f)
    # ids freed before the save are reused as the saving Context would
    box = (1.0, 1.0, 0.5, 0.5, 0.5)
    assert dst.geometry.add(type(dst.geometry.get(0))(*box)) == \
        src.geometry.add(type(src.geometry.get(0))(*box))
    assert dst.emissions.emit(1.0, 0.0, 1.0) == \
        src.emissions.emit(1.0, 0.0, 1.0)
