"""Live viewer: the reference's interactive Pangolin window
(src/Viewer.cc:56-70) re-imagined for a headless host.

Port of ``iv_slam_tpu/slam/live_viewer.py``: the same routes, controls and
multipart boundary. The reference opens an OpenGL window on the machine
running SLAM. A GPU host is typically remote, so the interactive answer here is a built-in
HTTP server streaming the existing FrameDrawer/MapDrawer renders as
MJPEG (multipart/x-mixed-replace — natively animated by every browser,
no client code): point a browser at http://<host>:<port>/ and watch the
current-frame overlay and the top-down map update live while tracking
runs. Pure stdlib (http.server + threading) + the port's JPEG encoder
(io/jpeg.py: the bytes cv2.imencode writes at the same quality).

Endpoints:
  /              HTML page with both streams + live stats + controls
  /frame.mjpg    current-frame keypoint/match overlay stream
  /map.mjpg      top-down map/trajectory stream
  /stats.json    {"frame_id", "state", "n_kfs", "n_points", ...}
  /controls.json current view options + registered actions
  /control       POST {"action": <name>, "value": <bool>} — the
                 reference Viewer's menu (src/Viewer.cc:96-102, acted on
                 at 123-141): menuFollowCamera / menuShowPoints /
                 menuShowKeyFrames / menuShowGraph become view-option
                 toggles the render loop reads from viewer.options;
                 menuLocalizationMode / menuReset dispatch to callbacks
                 registered with register_control (wired to
                 System.activate_localization_mode / System.reset by
                 iv_slam_tpu_torch/examples/run_stereo.py).
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import numpy as np

from ..io import jpeg

_PAGE = b"""<!doctype html>
<html><head><title>iv_slam_tpu_torch live viewer</title>
<style>body{background:#111;color:#ddd;font-family:monospace}
img{border:1px solid #444;margin:4px;max-width:48vw}
label{margin-right:12px}button{margin-right:8px}</style></head>
<body><h3>iv_slam_tpu_torch &mdash; live viewer</h3>
<div id="c"></div>
<img src="/frame.mjpg"/><img src="/map.mjpg"/>
<pre id="s"></pre>
<script>
async function post(action,value){await fetch('/control',{method:'POST',
headers:{'Content-Type':'application/json'},
body:JSON.stringify({action:action,value:value})});render();}
async function render(){const r=await fetch('/controls.json');
const c=await r.json();const d=document.getElementById('c');d.innerHTML='';
for(const [k,v] of Object.entries(c.options)){
const l=document.createElement('label');
const b=document.createElement('input');b.type='checkbox';b.checked=v;
b.onchange=()=>post(k,b.checked);l.appendChild(b);
l.appendChild(document.createTextNode(' '+k));d.appendChild(l);}
for(const a of c.actions){const b=document.createElement('button');
b.textContent=a;b.onclick=()=>post(a,true);d.appendChild(b);}}
render();
setInterval(async()=>{const r=await fetch('/stats.json');
document.getElementById('s').textContent=JSON.stringify(
await r.json(),null,1);},500);</script>
</body></html>"""


class LiveViewer:
    """Start with start(); feed frames with publish(); stop() on
    shutdown. Thread-safe single-producer/any-consumers."""

    def __init__(self, port: int = 8780, quality: int = 80):
        self.port = port
        self.quality = quality
        self._jpeg = {"frame": None, "map": None}
        self._stats = {}
        self._cond = threading.Condition()
        self._seq = 0
        self._server: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None
        # view-option toggles (the reference's menuFollowCamera/
        # menuShowPoints/menuShowKeyFrames/menuShowGraph booleans,
        # Viewer.cc:96-100): the producer render loop reads these
        self.options = {
            "follow_camera": True,
            "show_points": True,
            "show_keyframes": True,
            "show_graph": True,
        }
        # action callbacks (menuLocalizationMode / menuReset,
        # Viewer.cc:101-102, dispatched at 123-141): name -> fn(value)
        self._controls = {}

    def register_control(self, name: str, fn):
        """Register an action callback (e.g. 'localization_mode' ->
        System.activate/deactivate, 'reset' -> System.reset)."""
        self._controls[name] = fn
        return self

    def apply_control(self, action: str, value) -> bool:
        """Dispatch one control message (shared by the POST handler and
        tests). Returns False for an unknown action."""
        fn = self._controls.get(action)
        if fn is not None:
            fn(value)
            return True
        if action in self.options:
            self.options[action] = bool(value)
            return True
        return False

    # ------------------------------------------------------------ producer

    def publish(self, frame_img: Optional[np.ndarray] = None,
                map_img: Optional[np.ndarray] = None,
                stats: Optional[dict] = None):
        """Swap in the latest renders (BGR uint8), encoded here (producer
        side) as JPEG at `quality`."""
        enc = {}
        for key, img in (("frame", frame_img), ("map", map_img)):
            if img is not None:
                enc[key] = jpeg.encode(img, self.quality)
        with self._cond:
            self._jpeg.update(enc)
            if stats:
                self._stats = dict(stats)
            self._seq += 1
            self._cond.notify_all()

    # ------------------------------------------------------------- server

    def start(self):
        viewer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet
                pass

            def do_GET(self):
                if self.path in ("/", "/index.html"):
                    self.send_response(200)
                    self.send_header("Content-Type", "text/html")
                    self.end_headers()
                    self.wfile.write(_PAGE)
                elif self.path == "/stats.json":
                    body = json.dumps(viewer._stats).encode()
                    self.send_response(200)
                    self.send_header("Content-Type", "application/json")
                    self.end_headers()
                    self.wfile.write(body)
                elif self.path == "/controls.json":
                    body = json.dumps({
                        "options": viewer.options,
                        "actions": sorted(viewer._controls),
                    }).encode()
                    self.send_response(200)
                    self.send_header("Content-Type", "application/json")
                    self.end_headers()
                    self.wfile.write(body)
                elif self.path in ("/frame.mjpg", "/map.mjpg"):
                    key = "frame" if "frame" in self.path else "map"
                    self.send_response(200)
                    self.send_header(
                        "Content-Type",
                        "multipart/x-mixed-replace; boundary=ivframe",
                    )
                    self.end_headers()
                    last = -1
                    try:
                        while True:
                            with viewer._cond:
                                viewer._cond.wait_for(
                                    lambda: viewer._seq != last
                                    and viewer._jpeg[key] is not None,
                                    timeout=2.0,
                                )
                                data = viewer._jpeg[key]
                                last = viewer._seq
                            if data is None:
                                continue
                            self.wfile.write(
                                b"--ivframe\r\nContent-Type: image/jpeg"
                                b"\r\nContent-Length: "
                                + str(len(data)).encode()
                                + b"\r\n\r\n" + data + b"\r\n"
                            )
                    except (BrokenPipeError, ConnectionResetError):
                        return
                else:
                    self.send_error(404)

            def do_POST(self):
                if self.path != "/control":
                    self.send_error(404)
                    return
                try:
                    n = int(self.headers.get("Content-Length", 0))
                    msg = json.loads(self.rfile.read(n) or b"{}")
                    action = str(msg.get("action", ""))
                    value = msg.get("value", True)
                except (ValueError, json.JSONDecodeError):
                    self.send_error(400)
                    return
                ok = viewer.apply_control(action, value)
                body = json.dumps({
                    "ok": ok, "options": viewer.options,
                }).encode()
                self.send_response(200 if ok else 422)
                self.send_header("Content-Type", "application/json")
                self.end_headers()
                self.wfile.write(body)

        self._server = ThreadingHTTPServer(("0.0.0.0", self.port), Handler)
        self.port = self._server.server_address[1]  # resolve port 0
        self._thread = threading.Thread(
            target=self._server.serve_forever, daemon=True,
            name="iv-live-viewer",
        )
        self._thread.start()
        return self

    def stop(self):
        if self._server is not None:
            self._server.shutdown()
            self._server.server_close()
            self._server = None
        with self._cond:
            self._cond.notify_all()
