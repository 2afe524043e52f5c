"""Web viewer: the live map rendered in the browser (port of
monogs_tpu/viewer/server.py).

A background thread serves an HTML page with orbit / fly controls; every
requested view is rendered with the SLAM's own rasterizer (`render`, so
`slab_fwd` on a card), in the shader modes of the reference's GUI: rgb,
depth, segmentation, time (a keyframe-index colour map) and ellipsoids.
Pause / resume goes back to the SLAM loop through a ViewerToMainPacket.
The standard library's `http.server` serves it; PNG goes through the
port's own codec (`utils/images.encode_png`), and OpenCV draws only the
input strip's colour maps and the frusta's antialiased lines.

Streams: `ThreadingHTTPServer` answers each request on a thread of its
own, while the SLAM writes its state on the tracker's or the mapper's
stream. The render runs on a CUDA stream of the viewer's own, after the
state's event (`SLAM.read_state`, which also marks the tensors it reads
as used on that stream); the input strip's copies wait for the packet's
event the same way. Its launches are counted under that stream.
"""

from __future__ import annotations

import json
import os
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

import numpy as np
import torch

from ..utils.images import encode_png
from .packets import LatestSlot, MainToViewerPacket, ViewerToMainPacket

_PAGE = """<!DOCTYPE html>
<html><head><title>monogs_torch viewer</title><style>
body{margin:0;background:#111;color:#ddd;font-family:monospace}
#hud{position:fixed;top:8px;left:8px;background:#0008;padding:8px}
img{display:block;margin:auto;image-rendering:pixelated}
button,select{background:#333;color:#ddd;border:1px solid #555;margin:2px}
</style></head><body>
<div id="hud">
  <div>frame <span id="fidx">-</span> | drag=orbit wheel=zoom shift-drag=pan</div>
  <select id="shader"><option>rgb</option><option>depth</option>
  <option>segmentation</option><option>time</option>
  <option>ellipsoids</option></select>
  <label><input type="checkbox" id="frusta" checked>frusta</label>
  <select id="kf"><option value="">live cam</option></select>
  <button id="pause">pause</button>
  <button id="follow">follow cam</button>
  <button id="shot">screenshot</button>
</div>
<img id="view" width="960">
<img id="inputs" width="960" style="opacity:0.9">
<script>
let yaw=0,pitch=0,dist=0,panx=0,pany=0,follow=true,paused=false,busy=false;
const img=document.getElementById('view');
function view_q(){
  const kf=document.getElementById('kf').value;
  const fr=document.getElementById('frusta').checked?1:0;
  return `yaw=${yaw}&pitch=${pitch}&dist=${dist}&panx=${panx}&pany=${pany}&follow=${follow?1:0}&frusta=${fr}&shader=${document.getElementById('shader').value}`+(kf?`&kf=${kf}`:'');
}
function refresh(){ if(busy) return; busy=true;
  fetch('/render?'+view_q()).then(r=>r.blob()).then(b=>{img.src=URL.createObjectURL(b);busy=false;});
  fetch('/state').then(r=>r.json()).then(s=>{
    document.getElementById('fidx').textContent=s.frame;
    const sel=document.getElementById('kf');
    const cur=sel.value;
    const want=[''].concat(s.kfs||[]);
    if(want.length!=sel.options.length){
      sel.innerHTML=want.map(k=>`<option value="${k}">${k===''?'live cam':'kf '+k}</option>`).join('');
      sel.value=cur;
    }});
  fetch('/input').then(r=>r.blob()).then(b=>{document.getElementById('inputs').src=URL.createObjectURL(b);});
}
setInterval(refresh, 250);
let drag=false,px=0,py=0;
img.onmousedown=e=>{drag=true;px=e.x;py=e.y;follow=false;};
window.onmouseup=()=>drag=false;
window.onmousemove=e=>{if(!drag)return;
  if(e.shiftKey){panx+=(e.x-px)*0.003;pany+=(e.y-py)*0.003;}
  else{yaw+=(e.x-px)*0.005;pitch+=(e.y-py)*0.005;}
  px=e.x;py=e.y;};
img.onwheel=e=>{dist+=e.deltaY*0.002;e.preventDefault();follow=false;};
document.getElementById('pause').onclick=()=>{paused=!paused;fetch('/pause?on='+(paused?1:0));};
document.getElementById('follow').onclick=()=>{follow=true;yaw=pitch=dist=panx=pany=0;document.getElementById('kf').value='';};
document.getElementById('shot').onclick=()=>{fetch('/screenshot?'+view_q()).then(r=>r.json()).then(s=>alert('saved '+s.path));};
</script></body></html>"""


def _png(img8: np.ndarray) -> bytes:
    return encode_png(img8)[0]


class ViewerServer:
    def __init__(self, render_fn, port: int = 8890, save_dir: str | None = None):
        """render_fn(R, t, shader, full=False) -> ((H, W, 3) float numpy
        image in [0, 1], the view's Intrinsics), rendered by the SLAM's
        rasterizer on its device. save_dir receives /screenshot captures.
        Port 0 binds a free port (`self.port` after `start`)."""
        self.slot = LatestSlot()
        self.control = ViewerToMainPacket()
        self.port = port
        self._render_fn = render_fn
        self._save_dir = save_dir
        self._shot_count = 0
        self._lock = threading.Lock()
        self._streams: dict = {}
        self._httpd = None
        self._thread = None

    # -- the SLAM side ---------------------------------------------------------

    def push(self, packet: MainToViewerPacket):
        self.slot.put(packet)

    @property
    def paused(self) -> bool:
        return self.control.paused

    def start(self):
        viewer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *args):  # quiet
                pass

            def _send(self, code, body, ctype="text/html"):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                url = urlparse(self.path)
                q = {k: v[0] for k, v in parse_qs(url.query).items()}
                if url.path == "/":
                    self._send(200, _PAGE.encode())
                elif url.path == "/state":
                    pkt = viewer.slot.get()
                    kfs = sorted(pkt.kf_poses) if pkt and pkt.kf_poses else []
                    body = json.dumps({"frame": pkt.cur_frame_idx if pkt else -1,
                                       "paused": viewer.control.paused,
                                       "kfs": kfs}).encode()
                    self._send(200, body, "application/json")
                elif url.path == "/pause":
                    viewer.control.paused = q.get("on") == "1"
                    self._send(200, b"ok", "text/plain")
                elif url.path == "/render":
                    self._send(200, viewer._render_view(q), "image/png")
                elif url.path == "/input":
                    self._send(200, viewer._input_view(), "image/png")
                elif url.path == "/screenshot":
                    self._send(200, viewer._screenshot(q), "application/json")
                else:
                    self._send(404, b"not found")

        self._httpd = ThreadingHTTPServer(("0.0.0.0", self.port), Handler)
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        name="viewer", daemon=True)
        self._thread.start()
        return self

    def stop(self):
        if self._httpd:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._thread.join(timeout=10.0)

    # -- rendering -------------------------------------------------------------

    def _host(self, pkt, x) -> np.ndarray:
        """A packet tensor as a numpy array, copied on a viewer stream after
        the packet's event."""
        if pkt.ready is None:
            return x.numpy() if torch.is_tensor(x) else np.asarray(x)
        with self._lock:
            stream = self._streams.get(x.device)
            if stream is None:
                stream = self._streams[x.device] = torch.cuda.Stream(x.device)
        with torch.cuda.stream(stream):
            stream.wait_event(pkt.ready)
            return x.cpu().numpy()

    def _orbit_pose(self, pkt, q):
        """The user's orbit controls composed with the followed camera pose;
        `kf=<idx>` takes a keyframe's estimated pose as the base view."""
        from ..ops import lie

        R, t = pkt.cur_pose if pkt.cur_pose else (np.eye(3), np.zeros(3))
        kf = q.get("kf")
        if kf and pkt.kf_poses:
            try:
                R, t = pkt.kf_poses[int(kf)]
            except (KeyError, ValueError):
                pass
        elif q.get("follow") == "1":
            return np.asarray(R), np.asarray(t)
        yaw = float(q.get("yaw", 0.0))
        pitch = float(q.get("pitch", 0.0))
        dist = float(q.get("dist", 0.0))
        panx = float(q.get("panx", 0.0))
        pany = float(q.get("pany", 0.0))
        d_R = lie.so3_exp(torch.tensor([pitch, yaw, 0.0], dtype=torch.float32)).numpy()
        R2 = d_R @ np.asarray(R)
        t2 = d_R @ np.asarray(t) + np.array([panx, pany, dist])
        return R2, t2

    def _input_view(self) -> bytes:
        """The current input frame as an rgb | jet depth | segmentation
        strip (the reference's input widgets, slam_viewer.py:542-585)."""
        import cv2

        pkt = self.slot.get()
        if pkt is None or pkt.gt_rgb is None:
            return _png(np.zeros((8, 8, 3), np.uint8))
        rgb = (np.clip(self._host(pkt, pkt.gt_rgb), 0, 1) * 255).astype(np.uint8)
        panels = [rgb]
        if pkt.gt_depth is not None:
            d = self._host(pkt, pkt.gt_depth)
            dn = (255 * d / max(float(d.max()), 1e-6)).astype(np.uint8)
            panels.append(cv2.applyColorMap(dn, cv2.COLORMAP_JET)[..., ::-1])
        if pkt.gt_segmentation is not None:
            seg = self._host(pkt, pkt.gt_segmentation).astype(np.uint8)
            segn = (seg * (255 // max(int(seg.max()), 1))).astype(np.uint8)
            panels.append(cv2.applyColorMap(segn, cv2.COLORMAP_HSV)[..., ::-1])
        return _png(np.ascontiguousarray(np.concatenate(panels, axis=1)))

    def _render_view(self, q, full: bool = False) -> bytes:
        pkt = self.slot.get()
        if pkt is None or pkt.params is None:
            return _png(np.zeros((16, 16, 3), np.uint8))
        R, t = self._orbit_pose(pkt, q)
        img, view_intr = self._render_fn(R, t, q.get("shader", "rgb"), full=full)
        img8 = np.ascontiguousarray((np.clip(img, 0, 1) * 255).astype(np.uint8))
        if q.get("frusta", "1") == "1":
            self._draw_frusta(img8, view_intr, np.asarray(R), np.asarray(t), pkt)
        return _png(img8)

    def _draw_frusta(self, img8, view_intr, Rv, tv, pkt):
        """Camera-frustum wireframes over the rendered view (the reference's
        slam_viewer.py:442-540): the current estimate red, the ground truth
        green, the window keyframes cyan; host lines, no device work."""
        import cv2

        intr = pkt.intrinsics
        d = 0.12 * max(1.0, float(np.linalg.norm(np.asarray(tv))) or 1.0)
        hx = (intr.width * 0.5 / intr.fx) * d
        hy = (intr.height * 0.5 / intr.fy) * d
        corners_cam = np.array([[-hx, -hy, d], [hx, -hy, d], [hx, hy, d], [-hx, hy, d]])

        def project(Xw):
            xc = Rv @ Xw + tv
            if xc[2] <= 0.02:
                return None
            return (int(round(view_intr.fx * xc[0] / xc[2] + view_intr.cx)),
                    int(round(view_intr.fy * xc[1] / xc[2] + view_intr.cy)))

        def draw_one(R, t, color, thick=1):
            R = np.asarray(R, np.float64)
            t = np.asarray(t, np.float64)
            C = -R.T @ t                    # the camera centre in the world
            pts = [project(C)] + [project(R.T @ (c - t)) for c in corners_cam]
            if any(p is None for p in pts):
                return
            for k in range(1, 5):
                cv2.line(img8, pts[0], pts[k], color, thick, cv2.LINE_AA)
                cv2.line(img8, pts[k], pts[1 + (k % 4)], color, thick, cv2.LINE_AA)

        for R, t in (pkt.kf_poses or {}).values():
            draw_one(R, t, (0, 220, 220))              # window keyframes: cyan
        if pkt.gt_pose is not None:
            draw_one(*pkt.gt_pose, (0, 220, 0), 2)     # ground truth: green
        if pkt.cur_pose is not None:
            draw_one(*pkt.cur_pose, (255, 60, 60), 2)  # estimate: red

    def _screenshot(self, q) -> bytes:
        """The requested view at the sensor's full resolution, saved under
        <save_dir>/screenshots/."""
        png = self._render_view(q, full=True)
        out_dir = os.path.join(self._save_dir or ".", "screenshots")
        os.makedirs(out_dir, exist_ok=True)
        with self._lock:
            self._shot_count += 1
            path = os.path.join(out_dir, f"shot_{self._shot_count:04d}.png")
        with open(path, "wb") as f:
            f.write(png)
        return json.dumps({"path": path}).encode()


def make_render_fn(slam, max_width: int = 480):
    """A render_fn over a SLAM's current state in the reference's shader
    modes (slam_viewer.py:695-727): segmentation colours and the keyframe-
    index "time" colour map replace the Gaussians' colours before the
    rasterizer. -> render_fn(R, t, shader="rgb", full=False) -> (the (H, W,
    3) float32 numpy image, the view's Intrinsics); numpy (R, t) in.

    On a card it renders on a CUDA stream of its own, after the state's
    event (`SLAM.read_state`), and copies the image to the host there."""
    from ..models import gaussian_map as gm
    from ..ops.graphics import Intrinsics
    from ..ops.render import render

    dev = slam.device
    stream = torch.cuda.Stream(dev) if dev.type == "cuda" else None
    f32 = torch.float32

    @torch.no_grad()
    def render_fn(R, t, shader="rgb", full=False):
        intr = slam.intr
        scale = 1.0 if full else min(1.0, max_width / intr.width)
        view_intr = Intrinsics(fx=intr.fx * scale, fy=intr.fy * scale,
                               cx=intr.cx * scale, cy=intr.cy * scale,
                               width=int(intr.width * scale),
                               height=int(intr.height * scale))
        with torch.cuda.stream(stream):
            st = slam.read_state().gmap
            p = st.params
            rgb = p["rgb"]
            opacity = gm.get_opacity(p)
            scales = gm.get_scales(p, slam.mcfg.isotropic)
            if shader == "ellipsoids":
                # Opaque splats at about one sigma, shaded by the scale
                # anisotropy (the reference's GL renderer, viewer/gl_render).
                opacity = torch.clamp_max(opacity * 4.0, 0.99)
                scales = scales * 0.5
                aniso = scales / (scales.amax(1, keepdim=True) + 1e-8)
                rgb = torch.clamp(rgb * (0.6 + 0.4 * aniso), 0.0, 1.0)
            if shader == "segmentation":
                k = st.obj_prob.shape[1]
                palette = torch.as_tensor(
                    np.random.RandomState(0).uniform(0.2, 1.0, (max(k, 1), 3)),
                    dtype=f32, device=dev)
                rgb = st.obj_prob @ palette
            elif shader == "time":
                kf = st.kf_idx.to(f32)
                tt = (kf / torch.clamp_min(kf.max(), 1.0))[:, None]
                rgb = (tt * torch.tensor([[1.0, 0.2, 0.1]], device=dev)
                       + (1 - tt) * torch.tensor([[0.1, 0.3, 1.0]], device=dev))
            out = render(p["xyz"], scales, p["quats"], opacity, rgb,
                         torch.as_tensor(np.asarray(R), dtype=f32, device=dev),
                         torch.as_tensor(np.asarray(t), dtype=f32, device=dev),
                         view_intr, active=st.active,
                         tile_capacity=slam.mcfg.tile_capacity, max_dup=slam.mcfg.max_dup,
                         backend=slam.mcfg.backend, with_n_touched=False)
            if shader == "depth":
                d = out.depth / torch.clamp_min(out.depth.max(), 1e-6)
                img = torch.stack([d, d, torch.sqrt(d)], dim=-1)
            else:
                img = out.rgb
            return img.cpu().numpy(), view_intr

    render_fn.stream = stream
    return render_fn
