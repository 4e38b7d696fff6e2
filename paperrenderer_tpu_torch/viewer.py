"""Live viewer: the present-loop + GUI analogue for a headless renderer.

PyTorch-port counterpart of ``paperrenderer_tpu/viewer.py``. The reference
presents frames through a GLFW window swapchain (Swapchain.cpp:109-160
acquire/present) and draws an ImGui panel with material sliders, a
raster<->RT mode switch, and per-frame statistics (example
GuiRender.cpp:62-118). A card in a server has no window; the equivalent is
a small dependency-free HTTP server that

  * streams the latest rendered frame (``GET /frame.png`` — the "present"),
  * serves a single-page GUI (``GET /``) with live material editing
    (GuiRender.cpp:65-77 sliders -> ``POST /material`` ->
    ``MaterialRegistry.update`` + ``invalidate()``),
  * switches between registered render modes, e.g. raster vs. ray tracing
    (GuiRender.cpp:79-87 -> ``POST /mode``; ``GET /modes`` lists them),
  * lists the active mode's materials (``GET /materials``),
  * reports frame statistics (GuiRender.cpp:89-118 -> ``GET /stats``), and
  * moves the camera (``POST /camera`` -> ``Camera.update_view``).

The render loop runs in a background thread at whatever rate the device
sustains; HTTP handlers only swap pointers under a lock, so presenting
never blocks rendering (the double-buffered swapchain analogue). Frames
are copied to the host (``.cpu()``) and encoded with ``io.image.
encode_png`` (zlib; no imaging library). A frame that raises is reported
in ``/stats`` under ``error`` and the loop keeps serving, as in the JAX
package; the render objects' CUDA kernels are built at their first
frame, so render one frame on the calling thread before ``start()`` to
keep the compiler out of the render thread.

Usage::

    rp, cam = build_example_scene(512, 512)
    rp.render(cam)       # builds the kernels on this thread
    v = Viewer({"raster": rp}, cam, port=8000)
    v.start()            # -> http://127.0.0.1:8000
    ...
    v.stop()
"""

from __future__ import annotations

import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Dict, Optional

from .io.image import encode_png

__all__ = ["Viewer"]


_PAGE = """<!doctype html>
<html><head><title>paperrenderer_tpu_torch viewer</title>
<style>
 body {{ font-family: sans-serif; background: #181818; color: #ddd;
        display: flex; gap: 16px; margin: 16px; }}
 img {{ image-rendering: pixelated; border: 1px solid #444; }}
 .panel {{ min-width: 320px; }}
 h3 {{ border-bottom: 1px solid #444; padding-bottom: 4px; }}
 label {{ display: inline-block; width: 90px; }}
 input[type=range] {{ width: 140px; }}
 pre {{ font-size: 11px; color: #9c9; }}
 button {{ margin: 2px; }}
</style></head><body>
<div><img id="frame" width="{w}" height="{h}" alt="frame"/></div>
<div class="panel">
 <h3>paperrenderer_tpu_torch</h3>
 <div id="modes"></div>
 <h3>Materials</h3><div id="mats"></div>
 <h3>Camera</h3>
 <div>pos <input id="cx" size=4> <input id="cy" size=4> <input id="cz" size=4>
  yaw <input id="yaw" size=4> pitch <input id="pitch" size=4>
  <button onclick="setCam()">apply</button></div>
 <h3>Last frame statistics</h3><pre id="stats"></pre>
</div>
<script>
const img = document.getElementById('frame');
function tick() {{
  img.src = '/frame.png?t=' + Date.now();
}}
img.onload = () => setTimeout(tick, 30);
img.onerror = () => setTimeout(tick, 250);
tick();
async function refreshStats() {{
  const s = await (await fetch('/stats')).json();
  let txt = 'fps: ' + s.fps.toFixed(1) + '  frame #' + s.frame + '\\n';
  for (const [name, ms] of s.timers) txt += name + ': ' + ms.toFixed(3) + ' ms\\n';
  for (const k in s.counters) txt += k + ': ' + s.counters[k] + '\\n';
  document.getElementById('stats').textContent = txt;
  setTimeout(refreshStats, 500);
}}
refreshStats();
async function buildPanels() {{
  const modes = await (await fetch('/modes')).json();
  let mh = '';
  for (const m of modes.modes)
    mh += `<button onclick="setMode('${{m}}')">` +
          (m === modes.active ? '<b>' + m + '</b>' : m) + '</button>';
  document.getElementById('modes').innerHTML = mh;
  // the panel binds to the ACTIVE mode's registry; edits carry that mode so
  // a later mode switch can't retarget a slider to the wrong registry
  const mats = await (await fetch('/materials?mode=' + modes.active)).json();
  let h = '';
  for (const m of mats.materials) {{
    h += `<div><b>${{m.name}}</b> `;
    for (const p of ['roughness', 'metallic', 'alpha'])
      h += `<div><label>${{p}}</label><input type=range min=0 max=1 step=0.01 value=${{m[p]}}
            oninput="fetch('/material', {{method:'POST',
            body: JSON.stringify({{id: ${{m.id}}, mode: '${{mats.mode}}',
            updates: {{${{p}}: parseFloat(this.value)}}}})}})"></div>`;
    h += '</div>';
  }}
  document.getElementById('mats').innerHTML = h;
}}
async function setMode(m) {{
  await fetch('/mode', {{method: 'POST', body: JSON.stringify({{mode: m}})}});
  buildPanels();   // rebuild: panels must follow the new mode's registry
}}
buildPanels();
function setCam() {{
  const g = id => parseFloat(document.getElementById(id).value);
  fetch('/camera', {{method: 'POST', body: JSON.stringify(
    {{pos: [g('cx'), g('cy'), g('cz')], yaw: g('yaw'), pitch: g('pitch')}})}});
}}
</script></body></html>
"""


class Viewer:
    """Serve live frames + a control GUI over HTTP (present-loop analogue).

    ``renders``: dict of name -> render object (``RenderPass``,
    ``RayTraceRender`` or ``HybridRender`` — anything with
    ``.render(camera) -> (ldr, aux)``, ``.materials`` and
    ``.invalidate()``); the first key is the initial mode
    (GuiRender.cpp:79-87's raster/RT switch generalized to N modes).
    ``on_frame(viewer, frame_index, dt)`` runs before each render — the
    per-frame animation hook of the example main loop (main.cpp frame loop).
    """

    def __init__(
        self,
        renders: Dict[str, object],
        camera,
        *,
        host: str = "127.0.0.1",
        port: int = 0,
        statistics=None,
        on_frame: Optional[Callable] = None,
    ):
        if not renders:
            raise ValueError("need at least one render mode")
        self.renders = dict(renders)
        self.mode = next(iter(renders))
        self.camera = camera
        self.on_frame = on_frame
        self.statistics = statistics
        self._host, self._port = host, port
        self._lock = threading.Lock()          # frame buffer + camera + mode
        self._frame_png: Optional[bytes] = None
        self._frame_event = threading.Event()  # set after every presented frame
        self._frame_index = 0
        self._fps = 0.0
        self._stop = threading.Event()
        self._server: Optional[ThreadingHTTPServer] = None
        self._threads = []

    # -- render loop (the main.cpp while(!glfwWindowShouldClose) analogue) --

    def _render_once(self) -> None:
        t0 = time.perf_counter()
        if self.on_frame is not None:
            self.on_frame(self, self._frame_index, self._last_dt)
        with self._lock:
            mode = self.mode
            cam = self.camera
        ldr, _ = self.renders[mode].render(cam)
        png = encode_png(ldr.cpu())
        dt = time.perf_counter() - t0
        with self._lock:
            self._frame_png = png
            self._frame_index += 1
            self._fps = 0.8 * self._fps + 0.2 * (1.0 / max(dt, 1e-6))
        self._last_dt = dt
        self._error = None        # a successful frame clears a stale error
        self._frame_event.set()

    def _loop(self) -> None:
        self._last_dt = 0.0
        while not self._stop.is_set():
            try:
                self._render_once()
            except Exception as e:  # keep serving; report in stats
                self._error = f"{type(e).__name__}: {e}"
                self._stop.wait(0.25)

    # -- control operations (called from HTTP handlers) ---------------------

    def snapshot_stats(self) -> dict:
        with self._lock:
            out = {
                "fps": self._fps,
                "frame": self._frame_index,
                "mode": self.mode,
                "width": self.renders[self.mode].width,
                "height": self.renders[self.mode].height,
                "timers": [],
                "counters": {},
            }
        if getattr(self, "_error", None):
            out["error"] = self._error
        if self.statistics is not None:
            times, counters = self.statistics.snapshot()
            out["timers"] = [[name, sec * 1e3] for name, _, sec in times]
            out["counters"] = counters
        return out

    def list_materials(self, mode: Optional[str] = None) -> list:
        reg = self.renders[mode or self.mode].materials
        mats = []
        for i, (obj, vals) in enumerate(zip(reg.objects(), reg.rows())):
            name = getattr(obj, "name", None) or getattr(
                getattr(obj, "base", None), "name", f"material{i}")
            mats.append({
                "id": i, "name": name,
                "albedo": list(map(float, vals["albedo"])),
                "emissive": list(map(float, vals["emissive"])),
                "roughness": float(vals["roughness"]),
                "metallic": float(vals["metallic"]),
                "alpha": float(vals["alpha"]),
            })
        return mats

    def update_material(self, mat_id: int, updates: dict,
                        mode: Optional[str] = None) -> None:
        """Live material edit (GuiRender.cpp:65-77 sliders ->
        DefaultMaterialInstance parameter write).

        ``mode`` names the render whose registry ``mat_id`` indexes (the GUI
        sends the mode its panel was built for, so a mode switch between
        panel build and slider move can't edit the wrong registry). The
        edited OBJECT may be registered in several modes' registries —
        every registry holding it is refreshed."""
        allowed = {"albedo", "emissive", "roughness", "metallic", "alpha"}
        bad = set(updates) - allowed
        if bad:
            raise ValueError(f"uneditable parameters: {sorted(bad)}")
        reg = self.renders[mode or self.mode].materials
        obj = reg.objects()[mat_id]
        for k, v in updates.items():
            v = tuple(v) if isinstance(v, (list, tuple)) else float(v)
            if hasattr(obj, "overrides"):       # MaterialInstance
                obj.overrides[k] = v
            else:                               # Material
                setattr(obj, k, v)
        for r in self.renders.values():
            try:
                r.materials.update(obj)
            except KeyError:                    # not in this mode's registry
                continue
            r.invalidate()

    def set_mode(self, mode: str) -> None:
        if mode not in self.renders:
            raise KeyError(mode)
        with self._lock:
            self.mode = mode

    def update_camera(self, pos=None, yaw=None, pitch=None) -> None:
        with self._lock:
            if yaw is not None or pitch is not None:
                self._yaw = float(yaw) if yaw is not None else getattr(self, "_yaw", 0.0)
                self._pitch = float(pitch) if pitch is not None else getattr(self, "_pitch", 0.0)
                self.camera.update_view(pos=pos, yaw_pitch=(self._yaw, self._pitch))
            elif pos is not None:
                self.camera.update_view(pos=pos)

    # -- lifecycle -----------------------------------------------------------

    @property
    def url(self) -> str:
        assert self._server is not None, "not started"
        return f"http://{self._server.server_address[0]}:{self._server.server_address[1]}"

    def start(self) -> "Viewer":
        viewer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet
                pass

            def _send(self, code, body, ctype="application/json"):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.send_header("Cache-Control", "no-store")
                self.end_headers()
                self.wfile.write(body)

            def _json(self, obj, code=200):
                self._send(code, json.dumps(obj).encode())

            def do_GET(self):
                path = self.path.split("?", 1)[0]
                if path == "/":
                    r = viewer.renders[viewer.mode]
                    page = _PAGE.format(w=r.width, h=r.height)
                    self._send(200, page.encode(), "text/html")
                elif path == "/frame.png":
                    with viewer._lock:
                        png = viewer._frame_png
                    if png is None:
                        self._json({"error": "no frame yet"}, 503)
                    else:
                        self._send(200, png, "image/png")
                elif path == "/stats":
                    self._json(viewer.snapshot_stats())
                elif path == "/materials":
                    q = self.path.split("?", 1)
                    mode = None
                    if len(q) == 2 and q[1].startswith("mode="):
                        mode = q[1][5:] or None
                    if mode is not None and mode not in viewer.renders:
                        return self._json({"error": "unknown mode"}, 400)
                    self._json({"materials": viewer.list_materials(mode),
                                "mode": mode or viewer.mode})
                elif path == "/modes":
                    self._json({"modes": list(viewer.renders),
                                "active": viewer.mode})
                else:
                    self._json({"error": "not found"}, 404)

            def do_POST(self):
                n = int(self.headers.get("Content-Length", 0))
                try:
                    body = json.loads(self.rfile.read(n) or b"{}")
                    if self.path == "/material":
                        viewer.update_material(int(body["id"]),
                                               body.get("updates", {}),
                                               mode=body.get("mode"))
                    elif self.path == "/mode":
                        viewer.set_mode(body["mode"])
                    elif self.path == "/camera":
                        viewer.update_camera(body.get("pos"),
                                             body.get("yaw"),
                                             body.get("pitch"))
                    else:
                        return self._json({"error": "not found"}, 404)
                    self._json({"ok": True})
                except Exception as e:
                    self._json({"error": f"{type(e).__name__}: {e}"}, 400)

        self._server = ThreadingHTTPServer((self._host, self._port), Handler)
        self._server.daemon_threads = True
        st = threading.Thread(target=self._server.serve_forever, daemon=True)
        rt = threading.Thread(target=self._loop, daemon=True)
        self._threads = [st, rt]
        st.start()
        rt.start()
        return self

    def wait_frame(self, min_index: int = 1, timeout: float = 120.0) -> bool:
        """Block until at least ``min_index`` frames have been presented."""
        end = time.monotonic() + timeout
        while time.monotonic() < end:
            with self._lock:
                if self._frame_index >= min_index:
                    return True
            self._frame_event.wait(0.1)
            self._frame_event.clear()
        return False

    def stop(self) -> None:
        self._stop.set()
        if self._server is not None:
            self._server.shutdown()
            self._server.server_close()
        for t in self._threads:
            t.join(timeout=10)

