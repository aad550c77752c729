"""HTTP live preview — the headless replacement for the reference's
GLFW/OpenGL interactive window (reference: src/preview.cpp). Counterpart of
project3_cuda_path_tracer_tpu/app/preview.py, with the same routes and
page.

Serves:
  GET /            — live page with the current render and MOUSE controls
                     mirroring the reference (src/main.cpp:169-205):
                     left-drag orbit, right-drag / wheel zoom,
                     middle-drag (or shift-drag) ground-plane pan
  GET /frame.png   — current tonemapped frame (live iteration count header)
  GET /state       — JSON {iteration, width, height}
  POST /orbit?dphi=&dtheta=&dzoom=&dpanx=&dpany= — camera motion (resets
                     accumulation, matching the reference contract
                     src/main.cpp:102-120)

Security note: the server binds 127.0.0.1 by default and has no
authentication — it exposes camera control and the rendered image to
anyone who can reach the port. Pass a non-loopback `host` only on
trusted networks (or tunnel via ssh -L).

The render loop keeps running in the caller's thread. The accumulator is
a tensor updated in place, so the loop steps under the server's lock
(`step_many`), which the HTTP thread's frame copy and orbit take as well:
a frame never shows a half-reset accumulator, and an orbit never lands
inside a step. After an orbit the renderer's `reset()` repacks what caches
the camera (K1's table on the megakernel route) and overwrites the camera
tensors and the accumulator in place, so on the card's wavefront route the
renderer's captured iteration (`Renderer.step_many`) replays on at the new
camera. The lock is held for one iteration at a time, and on the card at
most two iterations are queued on the device: the loop enqueues faster than
the device renders (a replay is one launch), and a frame or an orbit waits
for what is queued before it.
"""
from __future__ import annotations

import collections
import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import urlparse, parse_qs

import numpy as np
import torch

from ..utils import image as img_io
from .orbit import OrbitState

_PAGE = b"""<!doctype html><html><head><title>path tracer</title>
<style>body{background:#111;color:#ddd;font-family:monospace;text-align:center}
img{image-rendering:pixelated;max-width:90vmin;cursor:grab;user-select:none}
</style></head><body>
<h3 id=s>rendering...</h3>
<div>left-drag orbit &middot; right-drag / wheel zoom &middot;
shift/middle-drag pan</div>
<img id=f src=/frame.png draggable=false>
<script>
const img=document.getElementById('f');
let drag=null;
const post=q=>fetch('/orbit?'+q,{method:'POST'});
img.addEventListener('contextmenu',e=>e.preventDefault());
img.addEventListener('mousedown',e=>{drag={b:e.button,s:e.shiftKey,
  x:e.clientX,y:e.clientY};e.preventDefault();});
window.addEventListener('mouseup',()=>drag=null);
window.addEventListener('mousemove',e=>{
  if(!drag)return;
  const dx=e.clientX-drag.x, dy=e.clientY-drag.y;
  if(Math.abs(dx)<3&&Math.abs(dy)<3)return;
  drag.x=e.clientX;drag.y=e.clientY;
  if(drag.b===0&&!drag.s)      post(`dphi=${dx/100}&dtheta=${dy/100}`);
  else if(drag.b===2)          post(`dzoom=${dy/50}`);
  else                         post(`dpanx=${dx/100}&dpany=${-dy/100}`);
});
img.addEventListener('wheel',e=>{e.preventDefault();
  post(`dzoom=${e.deltaY/200}`);},{passive:false});
setInterval(async()=>{
  const st=await (await fetch('/state')).json();
  document.getElementById('s').textContent=
    `iteration ${st.iteration} - ${st.width}x${st.height}`;
  img.src='/frame.png?'+Date.now();
},1000);
</script></body></html>"""


class PreviewServer:
    """The preview of `renderer` (an integrator.Renderer) on host:port;
    port 0 takes an ephemeral port (`self.port` after construction)."""

    def __init__(self, renderer, host: str = "127.0.0.1", port: int = 8650):
        self.renderer = renderer
        self.lock = threading.Lock()
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def _send(self, code, ctype, body):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                path = urlparse(self.path).path
                if path == "/":
                    self._send(200, "text/html", _PAGE)
                elif path == "/frame.png":
                    with outer.lock:
                        img = outer.renderer.image()
                    rgb8 = (np.clip(img, 0, 1) * 255).astype(np.uint8)
                    self._send(200, "image/png", img_io.encode_png(rgb8))
                elif path == "/state":
                    with outer.lock:
                        it = outer.renderer.iteration
                        w, h = outer.renderer.scene.camera.resolution
                    self._send(200, "application/json", json.dumps(
                        dict(iteration=it, width=w, height=h)).encode())
                else:
                    self._send(404, "text/plain", b"not found")

            def do_POST(self):
                u = urlparse(self.path)
                if u.path == "/orbit":
                    q = parse_qs(u.query)
                    g = lambda k: float(q.get(k, ["0"])[0])
                    with outer.lock:
                        cam = outer.renderer.scene.camera
                        st = OrbitState.from_camera(cam)
                        st = st.rotate(g("dphi"), g("dtheta"))
                        st = st.dolly(g("dzoom"))
                        dpx, dpy = g("dpanx"), g("dpany")
                        if dpx or dpy:
                            st = st.pan(dpx, dpy, cam)
                        st.apply(cam)
                        # any camera change resets accumulation
                        # (reference: src/main.cpp:102-120); reset()
                        # repacks the renderer's camera caches
                        outer.renderer.reset()
                    self._send(200, "application/json", b'{"ok": true}')
                else:
                    self._send(404, "text/plain", b"not found")

        self.server = ThreadingHTTPServer((host, port), Handler)
        self.port = self.server.server_address[1]
        self.thread = threading.Thread(target=self.server.serve_forever,
                                       daemon=True)

    def step_many(self, n: int) -> None:
        """`n` iterations of the renderer, each under the lock
        (`Renderer.step_many(1)`: a replay of its captured iteration on the
        card's wavefront route). On the card the loop waits, outside the
        lock, until at most two iterations are queued."""
        queued = collections.deque()
        for _ in range(n):
            with self.lock:
                self.renderer.step_many(1)
                if self.renderer.device.type == "cuda":
                    queued.append(torch.cuda.Event())
                    queued[-1].record()
            if len(queued) > 1:
                queued.popleft().synchronize()

    def start(self):
        self.thread.start()
        return self

    def stop(self):
        """Stop serving and close the socket."""
        self.server.shutdown()
        self.server.server_close()
