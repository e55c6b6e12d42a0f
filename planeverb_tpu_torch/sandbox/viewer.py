"""Interactive web sandbox — the reference's ImGui editor as a browser app.

The reference ships a GLFW/ImGui editor (reference PlaneverbSandbox/
Editor/Editor.cpp): a 2D grid viewer with a draggable emitter and listener
that live-update the engine (Editor.cpp:563-651), geometry CRUD windows,
``.pv`` scene save/load (Editor.cpp:219-281), acoustic parameter readouts in
dB (Editor.cpp:396-434), and linear+dB impulse-response plots
(Editor.cpp:449-477). Here the engine is a Python host process driving a
CUDA card (counterpart of ``planeverb_tpu/sandbox/viewer.py``, whose page
this module serves unchanged), so the natural interactive surface is a
small HTTP server + single-page canvas app with the same feature set:

  - live grid view of the voxelized scene with click-to-place listener,
    emitters, and geometry boxes;
  - per-emitter parameter readout (dry/wet dB, RT60, lowpass, DOA,
    directivity) refreshed every engine iteration;
  - IR plot (linear + dB) for any probe position;
  - ``.pv`` scene download and demo-scene loading.

Run it with ``python -m planeverb_tpu_torch view [scene]``. Everything is stdlib:
``http.server`` + JSON — no web framework, mirroring the reference's
zero-dependency sandbox philosophy.
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

import numpy as np

from planeverb_tpu_torch.config import PlaneverbConfig, material_r
from planeverb_tpu_torch.core.context import Context
from planeverb_tpu_torch.ops import voxelize
from planeverb_tpu_torch.scene import (AABB, DEMO_SCENES, Scene, demo_scene,
                                       save_pv)

__all__ = ["ViewerServer"]


class ViewerServer:
    """HTTP front-end wrapping a live :class:`Context`.

    ``background=True`` runs the engine loop continuously (the reference's
    BackgroundProcessor behavior); ``background=False`` leaves stepping to
    explicit ``{"cmd": "step"}`` calls (deterministic for tests).

    The Context runs on ``device`` (default the card); ``mesh_devices`` > 0
    shards it over that many distinct cards (``parallel.mesh_from_count``,
    a ValueError beyond the host's count), or that many positions of the
    CPU on ``device="cpu"``.
    """

    def __init__(self, config: PlaneverbConfig | None = None,
                 scene: Scene | None = None, host: str = "127.0.0.1",
                 port: int = 0, background: bool = True,
                 mesh_devices: int = 0, device="cuda"):
        self.config = config or PlaneverbConfig()
        mesh = None
        if mesh_devices > 0:
            from planeverb_tpu_torch.parallel import mesh_for

            mesh = mesh_for(mesh_devices, device)
        self.ctx = Context(self.config, scene=scene, mesh=mesh, device=device)
        self.scene_name = scene.name if scene is not None else ""
        self._lock = threading.Lock()   # serializes mutating commands
        # occupancy strings memoized per geometry version: clients poll
        # /api/state continuously, and re-voxelizing + string-joining the
        # whole grid per poll is O(nx*ny) host work that only changes when
        # the geometry does (quadratically unpleasant at 459x459)
        self._occupancy_cache: tuple[int, list[str]] | None = None
        self._httpd = ThreadingHTTPServer((host, port), _make_handler(self))
        self._httpd.daemon_threads = True
        self.address = self._httpd.server_address[:2]
        if background:
            self.ctx.start()

    # ------------------------------------------------------------ lifecycle
    def serve_forever(self) -> None:
        self._httpd.serve_forever()

    def start_background(self) -> threading.Thread:
        t = threading.Thread(target=self.serve_forever, daemon=True,
                             name="planeverb-viewer")
        t.start()
        return t

    def shutdown(self) -> None:
        self.ctx.stop()
        self._httpd.shutdown()
        self._httpd.server_close()

    # ------------------------------------------------------------- GET data
    def _occupancy(self, version: int, boxes) -> list[str]:
        cached = self._occupancy_cache
        if cached is not None and cached[0] == version:
            return cached[1]
        p = self.ctx.params
        beta, _ = voxelize.voxelize_np(p, boxes)
        rows = ["".join("." if beta[i, j] > 0 else "#"
                        for j in range(p.ny))
                for i in range(p.nx)]
        self._occupancy_cache = (version, rows)
        return rows

    def state(self) -> dict:
        p = self.ctx.params
        version, boxes = self.ctx.geometry.snapshot()
        lx, _, lz = self.ctx.get_listener_position()
        return {
            "grid": {"nx": p.nx, "ny": p.ny, "dx": p.dx, "fs": p.fs,
                     "size_x": p.grid_size_x, "size_y": p.grid_size_y,
                     "offset_x": p.grid_offset_x, "offset_y": p.grid_offset_y,
                     "resolution": p.resolution,
                     "response_length": p.response_length},
            # one string per solver row: '#' solid, '.' air (PrintGrid analog)
            "occupancy": self._occupancy(version, boxes),
            "geometry": [{"id": gid, "cx": b.x, "cy": b.y, "w": b.width,
                          "h": b.height, "absorption": b.absorption}
                         for gid, b in self.ctx.geometry.items()],
            "emitters": [{"id": eid, "x": em.position[0],
                          "z": em.position[2], "volume_db": em.volume_db,
                          "pattern": em.pattern}
                         for eid, em in
                         sorted(self.ctx.emissions.snapshot_emissions()
                                .items())],
            "listener": {"x": lx, "z": lz},
            "iteration": self.ctx.iteration,
            "running": self.ctx._thread is not None,
            "scene": self.scene_name,
            "scenes": sorted(DEMO_SCENES),
            "profile": self.ctx.profile_summary(),
        }

    def output_at(self, x: float, z: float) -> dict:
        out = self.ctx.result_at(x, z)
        return {
            "valid": out.valid, "occlusion": out.occlusion,
            "wet_gain": out.wet_gain, "rt60": out.rt60,
            "lowpass": out.lowpass,
            "direction": [out.direction.x, out.direction.y],
            "source_directivity": [out.source_directivity.x,
                                   out.source_directivity.y],
            # dB readouts as in the editor's parameter window
            # (Editor.cpp:396-434)
            "dry_db": _db(out.occlusion), "wet_db": _db(out.wet_gain),
        }

    def ir_at(self, x: float, z: float) -> dict:
        ir = np.asarray(self.ctx.get_impulse_response(x, z), np.float64)
        return {"fs": self.ctx.params.fs, "samples": ir.tolist()}

    def scene_pv(self) -> str:
        import io

        _, boxes = self.ctx.geometry.snapshot()
        buf = io.StringIO()
        save_pv(Scene(boxes=boxes, name=self.scene_name or "viewer"), buf)
        return buf.getvalue()

    # ------------------------------------------------------------- commands
    def command(self, req: dict) -> dict:
        cmd = req.get("cmd")
        fn = getattr(self, f"_cmd_{cmd}", None)
        if fn is None:
            return {"ok": False, "error": f"unknown cmd {cmd!r}"}
        with self._lock:
            try:
                resp = fn(req) or {}
            except Exception as e:  # noqa: BLE001 — protocol boundary
                return {"ok": False, "error": f"{type(e).__name__}: {e}"}
        resp.setdefault("ok", True)
        return resp

    def _cmd_listener(self, req):
        self.ctx.set_listener_position(float(req["x"]), 0.0, float(req["z"]))

    def _cmd_emit(self, req):
        eid = self.ctx.emissions.emit(
            float(req["x"]), 0.0, float(req["z"]),
            volume_db=float(req.get("volume_db", 0.0)),
            pattern=int(req.get("pattern", 0)))
        return {"id": eid}

    def _cmd_update_emission(self, req):
        self.ctx.emissions.update(
            int(req["id"]), float(req["x"]), 0.0, float(req["z"]),
            volume_db=(float(req["volume_db"]) if "volume_db" in req
                       else None),
            pattern=int(req["pattern"]) if "pattern" in req else None)

    def _cmd_end_emission(self, req):
        self.ctx.emissions.end(int(req["id"]))

    def _cmd_add_geometry(self, req):
        gid = self.ctx.geometry.add(_box(req))
        return {"id": gid}

    def _cmd_update_geometry(self, req):
        gid = int(req["id"])
        if self.ctx.geometry.get(gid) is None:
            raise KeyError(f"no geometry id {gid}")
        self.ctx.geometry.update(gid, _box(req))

    def _cmd_remove_geometry(self, req):
        gid = int(req["id"])
        if self.ctx.geometry.get(gid) is None:
            raise KeyError(f"no geometry id {gid}")
        self.ctx.geometry.remove(gid)

    def _cmd_load_scene(self, req):
        scene = demo_scene(req["name"])
        self.ctx.geometry.clear()
        self.ctx.geometry.load_scene(scene)
        self.scene_name = scene.name

    def _cmd_clear_scene(self, req):
        self.ctx.geometry.clear()
        self.scene_name = ""

    def _cmd_step(self, req):
        if self.ctx._thread is None:
            self.ctx.step()
        return {"iteration": self.ctx.iteration}

    def _cmd_start(self, req):
        self.ctx.start()

    def _cmd_stop(self, req):
        self.ctx.stop()


def _box(req: dict) -> AABB:
    # "absorption" accepts an R float or a material name ("CONCRETE_ROUGH")
    return AABB(float(req["cx"]), float(req["cy"]), float(req["w"]),
                float(req["h"]), material_r(req.get("absorption", 0.9)))


def _db(gain: float) -> float:
    return float(20.0 * np.log10(max(gain, 1e-6)))


def _make_handler(viewer: ViewerServer):
    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, *args):  # quiet
            pass

        def _send(self, body: bytes, ctype: str, code: int = 200):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _json(self, obj, code: int = 200):
            self._send(json.dumps(obj).encode(),
                       "application/json; charset=utf-8", code)

        def do_GET(self):
            url = urlparse(self.path)
            q = {k: v[0] for k, v in parse_qs(url.query).items()}
            try:
                if url.path == "/":
                    self._send(_PAGE.encode(), "text/html; charset=utf-8")
                elif url.path == "/api/state":
                    self._json(viewer.state())
                elif url.path == "/api/output":
                    self._json(viewer.output_at(float(q["x"]), float(q["z"])))
                elif url.path == "/api/ir":
                    self._json(viewer.ir_at(float(q["x"]), float(q["z"])))
                elif url.path == "/api/scene.pv":
                    self._send(viewer.scene_pv().encode(),
                               "text/plain; charset=utf-8")
                else:
                    self._json({"ok": False, "error": "not found"}, 404)
            except Exception as e:  # noqa: BLE001 — protocol boundary
                self._json({"ok": False,
                            "error": f"{type(e).__name__}: {e}"}, 500)

        def do_POST(self):
            url = urlparse(self.path)
            n = int(self.headers.get("Content-Length", 0))
            try:
                req = json.loads(self.rfile.read(n) or b"{}")
            except json.JSONDecodeError as e:
                self._json({"ok": False, "error": f"bad json: {e}"}, 400)
                return
            if url.path != "/api/command":
                self._json({"ok": False, "error": "not found"}, 404)
                return
            # Always 200: command failures are application-level, reported in
            # the {"ok": false, "error": ...} body so clients can read them
            # (urllib raises on 4xx before the body is reachable).
            self._json(viewer.command(req))

    return Handler


# --------------------------------------------------------------------------
# Single-page app. Canvas grid view + readouts + IR plot; no dependencies.
# --------------------------------------------------------------------------
_PAGE = r"""<!doctype html>
<html><head><meta charset="utf-8"><title>planeverb_tpu sandbox</title>
<style>
  body { font: 13px system-ui, sans-serif; margin: 0; display: flex;
         background: #14161a; color: #d8dce2; }
  #left { padding: 12px; }
  #side { padding: 12px; width: 360px; }
  canvas { background: #1d2026; border: 1px solid #333; display: block; }
  #grid { cursor: crosshair; }
  h1 { font-size: 15px; margin: 0 0 8px; color: #fff; }
  h2 { font-size: 13px; margin: 12px 0 4px; color: #9ab; }
  table { border-collapse: collapse; width: 100%; }
  td { padding: 1px 6px 1px 0; }
  td.v { text-align: right; font-variant-numeric: tabular-nums; color: #9fd; }
  select, button, input { background: #262a31; color: #d8dce2;
    border: 1px solid #444; border-radius: 3px; padding: 2px 6px; }
  button.on { background: #2f6feb; border-color: #2f6feb; color: #fff; }
  .row { margin: 4px 0; display: flex; gap: 6px; flex-wrap: wrap; }
  #geo { max-height: 160px; overflow-y: auto; font-size: 12px; }
  .dim { color: #778; }
</style></head><body>
<div id="left">
  <h1>planeverb_tpu &mdash; interactive sandbox</h1>
  <div class="row">
    <select id="scene"></select>
    <button onclick="loadScene()">load</button>
    <a id="savepv" href="/api/scene.pv" download="scene.pv"><button>save .pv</button></a>
    <span class="dim" id="meta"></span>
  </div>
  <div class="row">
    mode:
    <button id="m-listener" class="on" onclick="setMode('listener')">listener</button>
    <button id="m-emitter" onclick="setMode('emitter')">add emitter</button>
    <button id="m-probe" onclick="setMode('probe')">probe</button>
    <button id="m-box" onclick="setMode('box')">add box</button>
    <span class="dim">click the grid to place</span>
  </div>
  <canvas id="grid" width="640" height="640"></canvas>
  <h2>impulse response at probe <span id="irpos" class="dim"></span>
      <button id="irdb" onclick="irDb=!irDb;drawIR()">linear/dB</button></h2>
  <canvas id="ir" width="640" height="160"></canvas>
</div>
<div id="side">
  <h2>acoustic parameters at probe</h2>
  <table id="params"></table>
  <h2>emitters</h2>
  <div id="emitters"></div>
  <h2>geometry <span class="dim">(click id to remove)</span></h2>
  <div id="geo"></div>
  <h2>engine</h2>
  <table id="prof"></table>
</div>
<script>
let S = null, mode = 'listener', probe = null, ir = null, irDb = false;
let lastIter = -1;

function setMode(m) {
  mode = m;
  for (const b of ['listener','emitter','probe','box'])
    document.getElementById('m-'+b).classList.toggle('on', b===m);
}

async function post(req) {
  const r = await fetch('/api/command', {method:'POST', body: JSON.stringify(req)});
  return r.json();
}

async function refresh() {
  S = await (await fetch('/api/state')).json();
  const sel = document.getElementById('scene');
  if (!sel.options.length)
    for (const n of S.scenes) sel.add(new Option(n, n));
  if (S.scene) sel.value = S.scene;
  document.getElementById('meta').textContent =
    `${S.grid.nx}×${S.grid.ny} cells  dx=${S.grid.dx.toFixed(3)} m  ` +
    `fs=${S.grid.fs} Hz  iter=${S.iteration}`;
  drawGrid();
  renderEmitters(); renderGeo(); renderProf();
  if (S.iteration !== lastIter) { lastIter = S.iteration; await refreshProbe(); }
}

function w2px(x, z) {  // world -> canvas
  const c = document.getElementById('grid');
  return [ (x + S.grid.offset_x) / (S.grid.nx * S.grid.dx) * c.width,
           (z + S.grid.offset_y) / (S.grid.ny * S.grid.dx) * c.height ];
}
function px2w(px, py) {
  const c = document.getElementById('grid');
  return [ px / c.width * S.grid.nx * S.grid.dx - S.grid.offset_x,
           py / c.height * S.grid.ny * S.grid.dx - S.grid.offset_y ];
}

function drawGrid() {
  const c = document.getElementById('grid'), g = c.getContext('2d');
  g.fillStyle = '#1d2026'; g.fillRect(0, 0, c.width, c.height);
  const cw = c.width / S.grid.nx, ch = c.height / S.grid.ny;
  g.fillStyle = '#5b6270';
  for (let i = 0; i < S.grid.nx; i++) {
    const row = S.occupancy[i];
    for (let j = 0; j < S.grid.ny; j++)
      if (row[j] === '#') g.fillRect(i*cw, j*ch, cw+0.5, ch+0.5);
  }
  g.strokeStyle = '#3a4150';
  for (const b of S.geometry) {
    const [x0,y0] = w2px(b.cx-b.w/2, b.cy-b.h/2), [x1,y1] = w2px(b.cx+b.w/2, b.cy+b.h/2);
    g.strokeRect(x0, y0, x1-x0, y1-y0);
  }
  const [lx, ly] = w2px(S.listener.x, S.listener.z);
  g.fillStyle = '#4fd26f'; g.beginPath(); g.arc(lx, ly, 6, 0, 7); g.fill();
  g.fillStyle = '#14161a'; g.fillText('L', lx-3, ly+4);
  g.fillStyle = '#e8c34f';
  for (const e of S.emitters) {
    const [x, y] = w2px(e.x, e.z);
    g.beginPath(); g.moveTo(x, y-6); g.lineTo(x+6, y); g.lineTo(x, y+6);
    g.lineTo(x-6, y); g.fill();
  }
  if (probe) {
    const [x, y] = w2px(probe[0], probe[1]);
    g.strokeStyle = '#ff6f6f'; g.beginPath(); g.arc(x, y, 7, 0, 7); g.stroke();
    g.beginPath(); g.moveTo(x-10, y); g.lineTo(x+10, y);
    g.moveTo(x, y-10); g.lineTo(x, y+10); g.stroke();
  }
}

async function refreshProbe() {
  if (!probe) return;
  const [x, z] = probe;
  const o = await (await fetch(`/api/output?x=${x}&z=${z}`)).json();
  const deg = Math.atan2(o.direction[1], o.direction[0]) * 180 / Math.PI;
  const rows = [
    ['valid', o.valid], ['dry gain (occlusion)', o.occlusion.toFixed(4)],
    ['dry level', o.dry_db.toFixed(1) + ' dB'],
    ['wet gain', o.wet_gain.toFixed(4)],
    ['wet level', o.wet_db.toFixed(1) + ' dB'],
    ['RT60', o.rt60.toFixed(3) + ' s'],
    ['lowpass cutoff', o.lowpass.toFixed(0) + ' Hz'],
    ['direction of arrival', deg.toFixed(1) + '°'],
    ['source directivity', `(${o.source_directivity[0].toFixed(2)}, ` +
                           `${o.source_directivity[1].toFixed(2)})`],
  ];
  document.getElementById('params').innerHTML =
    rows.map(r => `<tr><td>${r[0]}</td><td class="v">${r[1]}</td></tr>`).join('');
  ir = await (await fetch(`/api/ir?x=${x}&z=${z}`)).json();
  document.getElementById('irpos').textContent =
    `(${x.toFixed(2)}, ${z.toFixed(2)})`;
  drawIR();
}

function drawIR() {
  if (!ir) return;
  const c = document.getElementById('ir'), g = c.getContext('2d');
  g.fillStyle = '#1d2026'; g.fillRect(0, 0, c.width, c.height);
  const s = ir.samples, n = s.length;
  g.strokeStyle = '#4fc3d2'; g.beginPath();
  if (!irDb) {
    let peak = 1e-9; for (const v of s) peak = Math.max(peak, Math.abs(v));
    for (let i = 0; i < n; i++) {
      const y = c.height/2 - (s[i]/peak) * (c.height/2 - 4);
      i ? g.lineTo(i/n*c.width, y) : g.moveTo(0, y);
    }
  } else {
    let peak = 1e-9; for (const v of s) peak = Math.max(peak, Math.abs(v));
    for (let i = 0; i < n; i++) {
      const db = 20*Math.log10(Math.max(Math.abs(s[i])/peak, 1e-5));
      const y = (-db/100) * (c.height - 8) + 4;
      i ? g.lineTo(i/n*c.width, y) : g.moveTo(0, y);
    }
  }
  g.stroke();
}

function renderEmitters() {
  document.getElementById('emitters').innerHTML = S.emitters.map(e =>
    `<div class="row">#${e.id} (${e.x.toFixed(2)}, ${e.z.toFixed(2)})
     ${e.volume_db.toFixed(0)} dB ${e.pattern ? 'cardioid' : 'omni'}
     <button onclick="post({cmd:'update_emission',id:${e.id},x:${e.x},z:${e.z},volume_db:${e.volume_db-3}}).then(refresh)">−3dB</button>
     <button onclick="post({cmd:'update_emission',id:${e.id},x:${e.x},z:${e.z},volume_db:${e.volume_db+3}}).then(refresh)">+3dB</button>
     <button onclick="post({cmd:'update_emission',id:${e.id},x:${e.x},z:${e.z},pattern:${e.pattern?0:1}}).then(refresh)">pattern</button>
     <button onclick="post({cmd:'end_emission',id:${e.id}}).then(refresh)">end</button>
     <button onclick="probe=[${e.x},${e.z}];refreshProbe();drawGrid()">probe</button></div>`
  ).join('') || '<span class="dim">none — use "add emitter" mode</span>';
}

function renderGeo() {
  document.getElementById('geo').innerHTML = S.geometry.map(b =>
    `<div><a href="#" onclick="post({cmd:'remove_geometry',id:${b.id}}).then(refresh);return false">
     #${b.id}</a> c=(${b.cx}, ${b.cy}) w×h=${b.w}×${b.h} R=${b.absorption}</div>`
  ).join('') || '<span class="dim">empty scene</span>';
}

function renderProf() {
  const p = S.profile || {};
  const rows = Object.entries(p).filter(([k,v]) => v && v.mean_s !== undefined)
    .map(([k,v]) => `<tr><td>${k}</td><td class="v">${(v.mean_s*1e3).toFixed(1)} ms</td></tr>`);
  if (p.throughput) rows.push(
    `<tr><td>cell-updates/s</td><td class="v">${(p.throughput.cell_updates_per_s/1e9).toFixed(2)} G</td></tr>`);
  document.getElementById('prof').innerHTML = rows.join('');
}

document.getElementById('grid').addEventListener('click', async ev => {
  const r = ev.target.getBoundingClientRect();
  const [x, z] = px2w(ev.clientX - r.left, ev.clientY - r.top);
  if (mode === 'listener') await post({cmd: 'listener', x, z});
  else if (mode === 'emitter') await post({cmd: 'emit', x, z});
  else if (mode === 'box')
    await post({cmd: 'add_geometry', cx: x, cy: z, w: 1, h: 1, absorption: 0.9});
  else { probe = [x, z]; refreshProbe(); }
  refresh();
});

async function loadScene() {
  await post({cmd: 'load_scene', name: document.getElementById('scene').value});
  refresh();
}

setMode('probe');
refresh();
setInterval(refresh, 700);
</script></body></html>
"""
