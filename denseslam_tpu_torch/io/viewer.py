"""Live web viewer — the reference's Pangolin GUI re-imagined headless
(port of denseslam_tpu/io/viewer.py, without cv2).

The reference GUI (src/DenseSLAM/DenseSLAMGUI.cpp:312-542) shows a main
raycast pane, the sparse-map pane, RGB/depth/raycast-depth detail panes and
a live memory plotter, with autoplay and telemetry. A GPU node is headless
too, so the equivalent here is a zero-dependency HTTP dashboard: the
pipeline pushes its latest preview panes + stats to a `LiveViewer`, a
stdlib ThreadingHTTPServer serves them, and a small HTML page polls:

  /        dashboard (panes + top-down trajectory + memory/FPS charts)
  /pane/X  latest PNG for pane X (rgb, depth, raycast, raycast_depth, ...)
  /state   JSON telemetry (frame, fps, blocks, memory history, trajectory)
  /freeview/nav   orbit/pan/zoom the free camera (DSHandler3D equivalent)
  /record         start/stop recording a pane to an .avi on disk

Everything is push-based from the pipeline loop (`--live_viewer PORT` in
main.py); the server thread never touches torch state. The free camera
works the same way: nav requests only mutate host-side orbit state, and the
pipeline loop polls `freeview_pose()` once per frame — it renders only when
the camera actually moved and a client is watching, so an idle freeview
pane costs the card nothing.

Where the JAX version calls cv2, this one has its own numpy code, each
giving cv2's result: panes are PNGs from io/png.py `encode_png` (cv2's
pixels, BGR order); the feature and flow overlays are drawn by io/draw.py,
cv2's fixed-point anti-aliased line and circle rules; a recording is an
MJPG .avi from io/mjpeg.py (baseline JPEG at quality 95, 4:2:0, in a RIFF
AVI with an index). The panes are numpy arrays on the host: a caller
holding a tensor on the card moves it across once per pane.
"""

from __future__ import annotations

import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, Optional

import numpy as np

from .draw import Canvas
from .mjpeg import AviWriter
from .png import encode_png

_MAX_HIST = 4096


def _encode_png(img: np.ndarray) -> bytes:
    img = np.asarray(img)
    if img.dtype != np.uint8 and img.dtype != np.uint16:
        img = np.clip(img, 0, 255).astype(np.uint8)
    return encode_png(img)


def colorize_depth(depth_m: np.ndarray, max_depth: float = 30.0) -> np.ndarray:
    """Depth (m) -> uint8 single-hue image (near = bright, far = dim,
    invalid = surface black). Sequential = one hue, light->dark."""
    d = np.asarray(depth_m, np.float32)
    t = np.clip(d / max_depth, 0.0, 1.0)
    # blue ramp on dark surface: lerp #cde2fb (near) -> #104281 (far), BGR
    near = np.array([251, 226, 205], np.float32)
    far = np.array([129, 66, 16], np.float32)
    img = near[None, None] * (1 - t[..., None]) + far[None, None] * t[..., None]
    img = np.where((d > 0)[..., None], img, 0.0)
    return img.astype(np.uint8)


def _canvas(img: np.ndarray) -> Canvas:
    img = np.asarray(img)
    if img.ndim == 2:
        img = np.stack([img] * 3, axis=-1)
    return Canvas(np.clip(img, 0, 255).astype(np.uint8).copy())


def draw_features(img: np.ndarray, uv: np.ndarray,
                  valid: np.ndarray) -> np.ndarray:
    """Input image with detected-feature overlay — the reference's
    FrameDrawer pane (ORB features drawn over the RGB input,
    DenseSLAMGUI.cpp:216-220). Marks in the dashboard's series green:
    cv2.circle(radius 2, thickness 1, LINE_AA) at each valid feature."""
    cv = _canvas(img)
    color = (112, 158, 25)  # #199e70 in BGR
    for (u, v), ok in zip(np.asarray(uv), np.asarray(valid)):
        if ok:
            cv.circle((int(round(u)), int(round(v))), 2, color, False)
    return cv.render()


def draw_flow(img: np.ndarray, uv_prev: np.ndarray, uv_curr: np.ndarray,
              valid: np.ndarray) -> np.ndarray:
    """Input image with the matched prev->curr scene-flow vectors — the
    reference GUI's sparse-scene-flow overlay (VisoSparseSFProvider::
    GetFlow drawn at DenseSLAMGUI.cpp:216-220): a line from the previous
    position to the current one with a dot at the current end (cv2.line
    and a filled cv2.circle of radius 2, LINE_AA)."""
    cv = _canvas(img)
    line_c = (22, 128, 233)   # amber in BGR
    dot_c = (112, 158, 25)
    for (up, vp), (uc, vc), ok in zip(np.asarray(uv_prev),
                                      np.asarray(uv_curr),
                                      np.asarray(valid)):
        if ok:
            cv.line((int(round(up)), int(round(vp))),
                    (int(round(uc)), int(round(vc))), line_c)
            cv.circle((int(round(uc)), int(round(vc))), 2, dot_c, True)
    return cv.render()


class _OrbitCam:
    """Host-side orbit-camera state (azimuth/elevation/radius around a
    target) — the DSHandler3D eye/center model. World convention is the
    KITTI camera frame (x right, y DOWN, z forward), so elevation raises
    the eye along -y and the camera's y axis tracks world-down."""

    def __init__(self):
        self.az = 0.0
        self.el = 0.35
        self.radius = 10.0
        self.target = np.zeros(3)
        self.follow = True        # target tracks the live camera pose
        self.dirty = False

    def nav(self, daz=0.0, delv=0.0, scale=1.0, dpx=0.0, dpy=0.0,
            follow=None, reset=False) -> None:
        if reset:
            self.__init__()
            self.dirty = True
            return
        self.az += daz
        self.el = float(np.clip(self.el + delv, -1.45, 1.45))
        self.radius = float(np.clip(self.radius * scale, 0.5, 500.0))
        if dpx or dpy:                      # pan in the view plane
            T = self.pose()
            self.target = self.target + T[:3, 0] * (dpx * self.radius) \
                + T[:3, 1] * (dpy * self.radius)
            self.follow = False
        if follow is not None:
            self.follow = bool(follow)
        self.dirty = True

    def pose(self) -> np.ndarray:
        """4x4 T_wc of the orbit camera (x right, y down, z forward)."""
        ca, sa = np.cos(self.az), np.sin(self.az)
        ce, se = np.cos(self.el), np.sin(self.el)
        fwd = np.array([ce * sa, -se, ce * ca])      # eye -> target
        eye = self.target - self.radius * fwd
        down = np.array([0.0, 1.0, 0.0])
        x = np.cross(down, fwd)
        x /= max(np.linalg.norm(x), 1e-9)
        y = np.cross(fwd, x)
        T = np.eye(4)
        T[:3, 0], T[:3, 1], T[:3, 2], T[:3, 3] = x, y, fwd, eye
        return T


class LiveViewer:
    """Thread-safe pane/stat store + HTTP server (daemon thread)."""

    def __init__(self, port: int = 8080, host: str = "127.0.0.1",
                 record_dir: str = "."):
        self._lock = threading.Lock()
        self._panes: Dict[str, bytes] = {}
        self._stats: Dict[str, object] = {}
        self._traj: list = []
        self._mem: list = []
        self._fps: list = []
        self._frames: list = []
        self._t0 = time.time()
        self._cam = _OrbitCam()
        self._record_dir = record_dir
        self._rec = None          # (pane, AviWriter, path, (w,h))
        self._rec_frames = 0
        self._last_poll = 0.0     # last /state request (client watching?)

        viewer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # silence request logging
                pass

            def _send(self, code: int, ctype: str, body: bytes) -> None:
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.send_header("Cache-Control", "no-store")
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                from urllib.parse import parse_qs, urlsplit

                parts = urlsplit(self.path)
                path = parts.path
                q = {k: v[-1] for k, v in parse_qs(parts.query).items()}
                if path == "/":
                    self._send(200, "text/html; charset=utf-8",
                               _DASHBOARD_HTML.encode())
                elif path == "/state":
                    viewer._last_poll = time.time()
                    self._send(200, "application/json",
                               viewer._state_json().encode())
                elif path == "/freeview/nav":
                    with viewer._lock:
                        viewer._cam.nav(
                            daz=float(q.get("daz", 0)),
                            delv=float(q.get("del", 0)),
                            scale=float(q.get("scale", 1)),
                            dpx=float(q.get("dpx", 0)),
                            dpy=float(q.get("dpy", 0)),
                            follow=(None if "follow" not in q
                                    else q["follow"] == "1"),
                            reset=q.get("reset") == "1",
                        )
                    self._send(200, "application/json", b"{}")
                elif path == "/record":
                    msg = viewer._record_ctl(q.get("action", ""),
                                             q.get("pane", "freeview"))
                    self._send(200, "application/json",
                               json.dumps(msg).encode())
                elif path.startswith("/pane/"):
                    name = path[len("/pane/"):]
                    with viewer._lock:
                        data = viewer._panes.get(name)
                    if data is None:
                        self._send(404, "text/plain", b"no such pane")
                    else:
                        self._send(200, "image/png", data)
                else:
                    self._send(404, "text/plain", b"not found")

        self._server = ThreadingHTTPServer((host, port), Handler)
        self.port = self._server.server_address[1]
        self._thread = threading.Thread(
            target=self._server.serve_forever, daemon=True)
        self._thread.start()

    # -- pipeline-side API ---------------------------------------------------

    def update(self, panes: Optional[Dict[str, np.ndarray]] = None,
               stats: Optional[Dict[str, object]] = None,
               pose: Optional[np.ndarray] = None) -> None:
        """Push the latest panes (HxW[x3] arrays), scalar stats, and camera
        pose (4x4 T_wc). Called from the pipeline loop."""
        encoded = {k: _encode_png(v) for k, v in (panes or {}).items()}
        with self._lock:
            self._panes.update(encoded)
            if stats:
                self._stats.update(stats)
                if "frame" in stats:
                    self._frames.append(int(stats["frame"]))
                    self._mem.append(
                        float(stats.get("memory_mb", 0.0)))
                    self._fps.append(float(stats.get("fps", 0.0)))
                    if len(self._frames) > _MAX_HIST:
                        del self._frames[0], self._mem[0], self._fps[0]
            if pose is not None:
                p = np.asarray(pose, np.float64)
                self._traj.append([float(p[0, 3]), float(p[1, 3]),
                                   float(p[2, 3])])
                if len(self._traj) > _MAX_HIST:
                    del self._traj[0]
                if self._cam.follow:
                    moved = np.linalg.norm(self._cam.target - p[:3, 3])
                    self._cam.target = p[:3, 3].copy()
                    if moved > 0.05:
                        self._cam.dirty = True
        if panes and self._rec is not None:
            self._record_frames(panes)

    def freeview_pose(self) -> Optional[np.ndarray]:
        """Poll from the pipeline loop: 4x4 T_wc of the free camera if it
        moved since the last poll, else None (skip the render). Renders are
        additionally gated on a dashboard client having fetched /state
        within 5 s (or an active recording) — a headless run in follow mode
        must not pay a composite render per frame for a pane nobody sees."""
        with self._lock:
            watching = (time.time() - self._last_poll < 5.0
                        or self._rec is not None)
            if not (self._cam.dirty and watching):
                return None
            self._cam.dirty = False
            return self._cam.pose()

    def close(self) -> None:
        with self._lock:
            self._rec_close()
        self._server.shutdown()
        self._server.server_close()

    # -- recording (GUI video-record equivalent) -------------------------------

    def _record_ctl(self, action: str, pane: str) -> Dict[str, object]:
        import os

        with self._lock:
            if action == "start":
                self._rec_close()
                path = os.path.join(
                    self._record_dir,
                    f"record_{pane}_{time.strftime('%H%M%S')}.avi")
                # writer is created lazily on the first frame (size unknown)
                self._rec = [pane, None, path, None]
                self._rec_frames = 0
            elif action == "stop":
                self._rec_close()
            return dict(
                recording=(self._rec[0] if self._rec else None),
                path=(self._rec[2] if self._rec else None),
                frames=self._rec_frames,
            )

    def _rec_close(self) -> None:
        if self._rec is not None and self._rec[1] is not None:
            self._rec[1].release()
        self._rec = None

    def _record_frames(self, panes: Dict[str, np.ndarray]) -> None:
        with self._lock:
            if self._rec is None or self._rec[0] not in panes:
                return
            img = np.asarray(panes[self._rec[0]])
            if img.ndim == 2:
                img = np.stack([img] * 3, axis=-1)
            img = np.clip(img, 0, 255).astype(np.uint8)
            hw = (img.shape[1], img.shape[0])
            if self._rec[1] is None:
                self._rec[1] = AviWriter(self._rec[2], 10.0, hw)
                self._rec[3] = hw
            if hw == self._rec[3]:
                self._rec[1].write(img)
                self._rec_frames += 1

    # -- server-side ----------------------------------------------------------

    def _state_json(self) -> str:
        with self._lock:
            return json.dumps(dict(
                stats=self._stats,
                panes=sorted(self._panes),
                frames=self._frames,
                memory_mb=self._mem,
                fps=self._fps,
                trajectory=self._traj,
                uptime_s=time.time() - self._t0,
                freeview=dict(az=self._cam.az, el=self._cam.el,
                              radius=self._cam.radius,
                              follow=self._cam.follow),
                recording=(self._rec[0] if self._rec else None),
                recorded_frames=self._rec_frames,
            ))


# --------------------------------------------------------------------------
# Dashboard page. Dark telemetry surface; charts are single-series (no
# legend — the title names the series), 2px lines, recessive grid, direct
# label on the latest value, crosshair hover readout. Palette: validated
# dark-mode steps (surface #1a1a19, text #ffffff/#c3c2b7, series blue
# #3987e5 for memory, aqua #199e70 for FPS; trajectory in the same blue).
# --------------------------------------------------------------------------

_DASHBOARD_HTML = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>denseslam_tpu live</title>
<style>
  :root { --surface:#1a1a19; --panel:#222221; --ink:#ffffff;
          --ink2:#c3c2b7; --grid:#383835; --blue:#3987e5; --aqua:#199e70; }
  body { background:var(--surface); color:var(--ink);
         font:13px/1.45 system-ui,sans-serif; margin:16px; }
  h1 { font-size:15px; font-weight:600; margin:0 0 4px; }
  .sub { color:var(--ink2); margin-bottom:12px; }
  .row { display:flex; flex-wrap:wrap; gap:12px; }
  .card { background:var(--panel); border-radius:8px; padding:10px; }
  .card h2 { font-size:12px; font-weight:600; color:var(--ink2);
             margin:0 0 6px; text-transform:uppercase; letter-spacing:.04em; }
  img.pane { display:block; max-width:480px; image-rendering:pixelated; }
  canvas { display:block; }
  .stats { display:flex; gap:18px; margin-bottom:12px; flex-wrap:wrap; }
  .tile .v { font-size:22px; font-weight:650; }
  .tile .k { color:var(--ink2); font-size:11px; text-transform:uppercase;
             letter-spacing:.05em; }
</style></head><body>
<h1>denseslam_tpu — live pipeline</h1>
<div class="sub">headless dashboard (Pangolin-GUI equivalent); polls 2 Hz</div>
<div class="stats" id="tiles"></div>
<div class="row" id="panes"></div>
<div class="row" style="margin-top:12px">
  <div class="card"><h2>freeview — drag orbit · shift-drag pan · wheel zoom</h2>
    <img class="pane" id="fv" src="/pane/freeview"
         style="min-width:360px;min-height:120px;cursor:grab"
         draggable="false"
         onerror="this.style.opacity=.15">
    <div style="margin-top:6px;display:flex;gap:8px">
      <button id="fv-follow">follow</button>
      <button onclick="nav({reset:1})">reset</button>
      <button id="fv-rec">record</button>
      <span id="fv-info" style="color:var(--ink2)"></span>
    </div>
  </div>
</div>
<div class="row" style="margin-top:12px">
  <div class="card"><h2>trajectory (top-down, x–z)</h2>
    <canvas id="traj" width="360" height="360"></canvas></div>
  <div class="card"><h2>map memory (MB)</h2>
    <canvas id="mem" width="420" height="180"></canvas></div>
  <div class="card"><h2>pipeline FPS</h2>
    <canvas id="fps" width="420" height="180"></canvas></div>
</div>
<script>
const fmt = (x, d=1) => x == null ? "–" : (+x).toFixed(d);
function tile(k, v) {
  return `<div class="card tile"><div class="v">${v}</div><div class="k">${k}</div></div>`;
}
let paneNames = [];
function drawSeries(id, xs, ys, color, hover) {
  const c = document.getElementById(id), g = c.getContext("2d");
  const W = c.width, H = c.height, padL = 42, padB = 18, padT = 8, padR = 8;
  g.clearRect(0, 0, W, H);
  if (!ys.length) return;
  const ymax = Math.max(...ys) * 1.1 || 1, ymin = 0;
  const x0 = xs[0], x1 = xs[xs.length-1] || 1;
  const X = x => padL + (W-padL-padR) * (x1 === x0 ? 1 : (x-x0)/(x1-x0));
  const Y = y => padT + (H-padT-padB) * (1 - (y-ymin)/(ymax-ymin));
  g.strokeStyle = "#383835"; g.fillStyle = "#c3c2b7";
  g.font = "10px system-ui"; g.lineWidth = 1;
  for (let i = 0; i <= 3; i++) {               // recessive grid, 4 lines
    const yv = ymin + (ymax-ymin)*i/3, y = Y(yv);
    g.beginPath(); g.moveTo(padL, y); g.lineTo(W-padR, y); g.stroke();
    g.fillText(fmt(yv), 4, y+3);
  }
  g.strokeStyle = color; g.lineWidth = 2; g.beginPath();
  ys.forEach((y, i) => i ? g.lineTo(X(xs[i]), Y(y)) : g.moveTo(X(xs[i]), Y(y)));
  g.stroke();
  const last = ys[ys.length-1];                 // direct label, latest value
  g.fillStyle = "#ffffff";
  g.fillText(fmt(last), Math.min(X(x1)+4, W-34), Y(last)+3);
  if (hover != null) {                          // crosshair readout
    let best = 0, bd = 1e18;
    xs.forEach((x, i) => { const d = Math.abs(X(x)-hover); if (d<bd){bd=d;best=i;} });
    const hx = X(xs[best]), hy = Y(ys[best]);
    g.strokeStyle = "#52514e"; g.lineWidth = 1;
    g.beginPath(); g.moveTo(hx, padT); g.lineTo(hx, H-padB); g.stroke();
    g.fillStyle = color; g.beginPath(); g.arc(hx, hy, 4, 0, 7); g.fill();
    g.fillStyle = "#ffffff";
    g.fillText(`f${xs[best]}: ${fmt(ys[best],2)}`, Math.min(hx+6, W-70), Math.max(hy-6, 10));
  }
}
function nav(p) {
  const qs = Object.entries(p).map(([k,v]) => `${k}=${v}`).join("&");
  fetch(`/freeview/nav?${qs}`);
}
let fvState = {follow: true}, recState = null;
{
  const fv = document.getElementById("fv");
  let drag = null;
  fv.addEventListener("mousedown", e => { drag = [e.clientX, e.clientY, e.shiftKey]; e.preventDefault(); });
  window.addEventListener("mouseup", () => { drag = null; });
  window.addEventListener("mousemove", e => {
    if (!drag) return;
    const dx = e.clientX - drag[0], dy = e.clientY - drag[1];
    drag = [e.clientX, e.clientY, drag[2]];
    if (drag[2]) nav({dpx: -dx*0.002, dpy: -dy*0.002});
    else nav({daz: dx*0.008, del: dy*0.008});
  });
  fv.addEventListener("wheel", e => {
    nav({scale: e.deltaY > 0 ? 1.12 : 0.89}); e.preventDefault();
  }, {passive: false});
  document.getElementById("fv-follow").onclick =
    () => nav({follow: fvState.follow ? 0 : 1});
  document.getElementById("fv-rec").onclick = () => {
    fetch(`/record?action=${recState ? "stop" : "start"}&pane=freeview`);
  };
}
const hovers = {};
["mem","fps"].forEach(id => {
  const c = document.getElementById(id);
  c.addEventListener("mousemove", e => { hovers[id] = e.offsetX; });
  c.addEventListener("mouseleave", () => { hovers[id] = null; });
});
function drawTraj(traj) {
  const c = document.getElementById("traj"), g = c.getContext("2d");
  const W = c.width, H = c.height; g.clearRect(0, 0, W, H);
  if (traj.length < 2) return;
  const xs = traj.map(p => p[0]), zs = traj.map(p => p[2]);
  const xmin = Math.min(...xs), xmax = Math.max(...xs);
  const zmin = Math.min(...zs), zmax = Math.max(...zs);
  const s = 0.9 * Math.min(W / Math.max(xmax-xmin, 1e-3),
                           H / Math.max(zmax-zmin, 1e-3));
  const X = x => W/2 + (x - (xmin+xmax)/2) * s;
  const Z = z => H/2 - (z - (zmin+zmax)/2) * s;
  g.strokeStyle = "#3987e5"; g.lineWidth = 2; g.beginPath();
  traj.forEach((p, i) => i ? g.lineTo(X(p[0]), Z(p[2])) : g.moveTo(X(p[0]), Z(p[2])));
  g.stroke();
  const last = traj[traj.length-1];             // current camera marker
  g.fillStyle = "#ffffff";
  g.beginPath(); g.arc(X(last[0]), Z(last[2]), 5, 0, 7); g.fill();
}
async function tick() {
  try {
    const st = await (await fetch("/state")).json();
    const s = st.stats || {};
    document.getElementById("tiles").innerHTML =
      tile("frame", s.frame ?? "–") +
      tile("fps", fmt(s.fps, 2)) +
      tile("blocks", s.blocks ?? "–") +
      tile("memory", fmt(s.memory_mb) + " MB") +
      tile("tracking", s.tracking_ok === false ? "LOST" : "OK") +
      tile("keyframes", s.keyframes ?? "–");
    if (JSON.stringify(st.panes) !== JSON.stringify(paneNames)) {
      paneNames = st.panes;
      document.getElementById("panes").innerHTML = paneNames
        .filter(n => n !== "freeview").map(n =>
        `<div class="card"><h2>${n}</h2>
         <img class="pane" id="pane-${n}" src="/pane/${n}"></div>`).join("");
    }
    const t = Date.now();
    paneNames.forEach(n => {
      const el = document.getElementById(`pane-${n}`);
      if (el) el.src = `/pane/${n}?t=${t}`;
    });
    if (paneNames.includes("freeview")) {
      const fv = document.getElementById("fv");
      fv.style.opacity = 1; fv.src = `/pane/freeview?t=${t}`;
    }
    fvState = st.freeview || fvState;
    recState = st.recording;
    document.getElementById("fv-follow").style.outline =
      fvState.follow ? "2px solid #199e70" : "none";
    document.getElementById("fv-rec").style.outline =
      recState ? "2px solid #e5483d" : "none";
    document.getElementById("fv-info").textContent =
      `r=${fmt(fvState.radius)}m` +
      (recState ? ` · REC ${st.recorded_frames}f` : "");
    drawSeries("mem", st.frames, st.memory_mb, "#3987e5", hovers.mem);
    drawSeries("fps", st.frames, st.fps, "#199e70", hovers.fps);
    drawTraj(st.trajectory);
  } catch (e) { /* server gone */ }
}
setInterval(tick, 500); tick();
</script></body></html>
"""
