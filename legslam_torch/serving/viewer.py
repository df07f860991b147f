"""Live map viewer (C18 equivalent of the ImGui/OpenGL viewer).

Counterpart of legslam_tpu/serving/viewer.py, with the same routes:

  GET /            interactive HTML viewer (WASD + drag orbit)
  GET /render?...  JPEG render from an arbitrary pose (renderFromPose);
                   overlay=1 draws the sparse map points + keyframe
                   frusta + current camera on top (the map drawer,
                   viewer/map_drawer.cpp:130 DrawMapPoints, :173
                   DrawKeyFrames, :393 DrawCurrentCamera)
  GET /slam_frame  current tracked frame with keypoint overlay (the
                   SLAM-frame pane of the reference viewer)
  GET /state       live stats (iteration, gaussians, ema loss)
  POST /params     live optimization-parameter overrides (the
                   get/setVaribleParameters round-trip,
                   viewer/imgui_viewer.cpp:385-466)

View-only mode (examples/view_result.cpp): `attach_ply` loads a saved map
without a mapper and renders it on the "cuda" backend on `device`.

The image is computed apart from its JPEG: `render_rgb` is the [H, W, 3]
render of a query (the mapper's render_from_pose, on the map's device)
and `slam_frame_input` is what the SLAM pane draws. Drawing and encoding
use OpenCV; where cv2 is not installed the JPEG routes answer 500 with a
message that says so, and /state and /params still work.
"""
from __future__ import annotations

import dataclasses
import json
import math
import threading
from typing import Optional

import numpy as np
import torch

_PAGE = """<!doctype html><html><head><title>legslam viewer</title>
<style>body{background:#111;color:#ddd;font-family:monospace;margin:12px}
img{border:1px solid #444}</style></head><body>
<div>legslam live viewer — drag to orbit, wheel to zoom, WASD to pan,
 o toggles the map overlay (points+frusta)</div>
<img id=v width=640 height=360>
<img id=f width=320 height=180 title="SLAM frame + keypoints">
<pre id=s></pre>
<script>
let yaw=0,pitch=0,r=3,cx=0,cy=0,cz=0,busy=false,ov=0;
async function refresh(){
 if(busy)return;busy=true;
 const u=`/render?yaw=${yaw}&pitch=${pitch}&r=${r}&cx=${cx}&cy=${cy}&cz=${cz}&w=640&h=360&overlay=${ov}`;
 document.getElementById('f').src=`/slam_frame?t=${Date.now()}`;
 const img=document.getElementById('v');
 img.src=u+`&t=${Date.now()}`;
 img.onload=()=>{busy=false};img.onerror=()=>{busy=false};
 try{const st=await fetch('/state');document.getElementById('s').textContent=
   JSON.stringify(await st.json());}catch(e){}
}
let drag=null;
document.getElementById('v').onmousedown=e=>{drag=[e.clientX,e.clientY]};
window.onmouseup=()=>{drag=null};
window.onmousemove=e=>{if(drag){yaw+=(e.clientX-drag[0])*0.01;
 pitch+=(e.clientY-drag[1])*0.01;drag=[e.clientX,e.clientY];refresh();}};
window.onwheel=e=>{r*=e.deltaY>0?1.1:0.9;refresh();};
window.onkeydown=e=>{const s=0.1;
 if(e.key=='w')cz+=s;if(e.key=='s')cz-=s;
 if(e.key=='a')cx-=s;if(e.key=='d')cx+=s;
 if(e.key=='q')cy-=s;if(e.key=='e')cy+=s;
 if(e.key=='o')ov=1-ov;refresh();};
setInterval(refresh,500);refresh();
</script></body></html>"""


def _cv2():
    """OpenCV, for drawing the overlays and encoding the JPEGs."""
    try:
        import cv2
    except ImportError as e:
        raise RuntimeError(
            "the viewer's JPEG routes need OpenCV (cv2), which is not "
            "installed; render_rgb and slam_frame_input give the images "
            "as arrays, and /state and /params still work") from e
    return cv2


def jpeg_available() -> bool:
    try:
        _cv2()
    except RuntimeError:
        return False
    return True


def _jpeg(img8: np.ndarray) -> bytes:
    cv2 = _cv2()
    ok, buf = cv2.imencode(".jpg", cv2.cvtColor(img8, cv2.COLOR_RGB2BGR))
    return buf.tobytes()


def orbit_pose(yaw: float, pitch: float, radius: float,
               center: np.ndarray):
    """World->camera (R, t) of a camera on an orbit around `center`,
    looking at it."""
    eye = center + radius * np.array([
        math.cos(pitch) * math.sin(yaw),
        math.sin(pitch),
        math.cos(pitch) * math.cos(yaw)])
    fwd = center - eye
    fwd = fwd / np.linalg.norm(fwd)
    up = np.array([0.0, -1.0, 0.0])
    right = np.cross(fwd, up)
    nr = np.linalg.norm(right)
    if nr < 1e-6:
        right = np.array([1.0, 0.0, 0.0])
    else:
        right = right / nr
    down = np.cross(fwd, right)
    c2w = np.eye(4, dtype=np.float32)
    c2w[:3, 0], c2w[:3, 1], c2w[:3, 2], c2w[:3, 3] = right, down, fwd, eye
    w2c = np.linalg.inv(c2w)
    return w2c[:3, :3].astype(np.float32), w2c[:3, 3].astype(np.float32)


def query_pose(q: dict):
    """(R, t, w, h) of a /render query."""
    w = int(q.get("w", 640))
    h = int(q.get("h", 360))
    center = np.array([float(q.get("cx", 0)), float(q.get("cy", 0)),
                       float(q.get("cz", 0))])
    R, t = orbit_pose(float(q.get("yaw", 0)), float(q.get("pitch", 0)),
                      float(q.get("r", 3)), center)
    return R, t, w, h


class ViewerServer:
    def __init__(self, mapper=None, host: str = "0.0.0.0",
                 port: int = 8006, frontend=None,
                 device: str | torch.device = "cuda"):
        self.mapper = mapper
        self.frontend = frontend  # TrackingFrontend for the SLAM pane
        self.host, self.port = host, port
        self.device = torch.device(device)   # of a view-only map
        self._static = None   # (GaussianState, renderer) for view-only

    def attach_ply(self, ply_path: str, capacity: Optional[int] = None):
        """View-only mode (examples/view_result.cpp:54-56)."""
        from legslam_torch.apps.find_objects import make_renderer
        from legslam_torch.mapper.checkpoint import state_from_ply
        from legslam_torch.utils.ply import load_gaussian_ply
        n = load_gaussian_ply(ply_path)["xyz"].shape[0]
        cap = capacity or max(1 << int(np.ceil(np.log2(max(n, 2)))), 256)
        st = state_from_ply(ply_path, cap, self.device)
        self._static = (st, make_renderer(st))

    @torch.no_grad()
    def render_rgb(self, q: dict) -> np.ndarray:
        """[h, w, 3] float32 render of a /render query: the mapper's
        render_from_pose, else the attached PLY (fx = fy = 0.7 w), else
        black."""
        R, t, w, h = query_pose(q)
        if self.mapper is not None and self.mapper.state is not None:
            color = self.mapper.render_from_pose(R, t, w, h).color
        elif self._static is not None:
            color = self._static[1](R, t, w, h, 0.7 * w, 0.7 * w,
                                    include_lang_feat=False).color
        else:
            return np.zeros((h, w, 3), np.float32)
        return color.float().cpu().numpy()

    def _render(self, q: dict) -> bytes:
        R, t, w, h = query_pose(q)
        img8 = (np.clip(self.render_rgb(q), 0, 1) * 255).astype(np.uint8)
        if q.get("overlay") in ("1", "true") and self.frontend is not None:
            img8 = self._draw_map_overlay(np.ascontiguousarray(img8),
                                          R, t, w, h)
        return _jpeg(img8)

    def _project(self, world: np.ndarray, R, t, fx, fy, cx, cy):
        cam = world @ R.T + t
        z = cam[:, 2]
        ok = z > 1e-3
        px = np.stack([fx * cam[:, 0] / np.maximum(z, 1e-3) + cx,
                       fy * cam[:, 1] / np.maximum(z, 1e-3) + cy], -1)
        return px, ok

    def _draw_map_overlay(self, img8, R, t, w, h):
        """Sparse map points (black, map_drawer.cpp:130-171), keyframe
        frusta (blue wireframes, :173-210) and the current camera (green,
        :393-430), projected into the orbit view and drawn in 2D."""
        cv2 = _cv2()
        fe = self.frontend
        fx = fy = 0.7 * w
        cx, cy = w / 2 - 0.5, h / 2 - 0.5
        lms = getattr(fe, "landmarks", {})
        if len(lms):
            world = np.stack([lm.world for lm in lms.values()])
            px, ok = self._project(world, R, t, fx, fy, cx, cy)
            for p in px[ok].astype(int):
                if 0 <= p[0] < w and 0 <= p[1] < h:
                    cv2.circle(img8, tuple(p), 1, (20, 20, 20), -1)
        # frustum template in camera coords (z forward)
        s = 0.1
        frust = np.array([[0, 0, 0], [-s, -0.6 * s, s], [s, -0.6 * s, s],
                          [s, 0.6 * s, s], [-s, 0.6 * s, s]], np.float32)
        edges = [(0, 1), (0, 2), (0, 3), (0, 4), (1, 2), (2, 3), (3, 4),
                 (4, 1)]

        def draw_frustum(kr, kt, color):
            world = (frust - kt) @ kr  # camera->world
            px, ok = self._project(world, R, t, fx, fy, cx, cy)
            for a, b in edges:
                if ok[a] and ok[b]:
                    cv2.line(img8, tuple(px[a].astype(int)),
                             tuple(px[b].astype(int)), color, 1)

        for kf in getattr(fe, "keyframes", {}).values():
            draw_frustum(kf.R, kf.t, (60, 60, 255))
        if getattr(fe, "_cur_R", None) is not None:
            draw_frustum(fe._cur_R, fe._cur_t, (0, 255, 0))
        return img8

    def slam_frame_input(self) -> Optional[dict]:
        """What the SLAM pane draws: the tracker's last frame snapshot
        (gray image, tracked keypoints [N, 2], inlier count), or None."""
        if self.frontend is None:
            return None
        return getattr(self.frontend, "last_vis", None)

    def _slam_frame(self) -> bytes:
        """Current tracked frame + keypoints (the reference viewer's SLAM
        pane; keypoint overlay like ORB-SLAM3's FrameDrawer)."""
        cv2 = _cv2()
        vis = self.slam_frame_input()
        if vis is None:
            img8 = np.zeros((180, 320, 3), np.uint8)
        else:
            g = (np.clip(vis["gray"], 0, 1) * 255).astype(np.uint8)
            img8 = np.ascontiguousarray(np.stack([g, g, g], -1))
            for p in np.asarray(vis["pts"]).astype(int):
                cv2.circle(img8, tuple(p), 2, (0, 255, 0), 1)
            cv2.putText(img8, f"kps {len(vis['pts'])} inl {vis['inliers']}",
                        (4, 14), cv2.FONT_HERSHEY_SIMPLEX, 0.4,
                        (0, 255, 255), 1)
        return _jpeg(img8)

    def _state(self) -> dict:
        if self.mapper is None:
            n = 0 if self._static is None else \
                int(self._static[0].num_valid())
            return dict(mode="view_only", gaussians=n)
        m = self.mapper
        return dict(iteration=m.iteration,
                    gaussians=int(m.state.num_valid()) if m.state else 0,
                    ema_loss=round(m.ema_loss, 5),
                    keyframes=len(m.keyframes),
                    sh_degree=m.active_sh_degree)

    def _set_params(self, payload: dict) -> dict:
        """Live hyperparameter overrides (VariableParameters,
        include/gaussian_mapper.h:77-94)."""
        if self.mapper is None:
            return dict(error="no mapper attached")
        allowed = {f.name for f in
                   dataclasses.fields(self.mapper.opt)}
        updates = {k: v for k, v in payload.items() if k in allowed}
        self.mapper.opt = dataclasses.replace(self.mapper.opt, **updates)
        return dict(updated=sorted(updates))

    def serve(self):
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
        from urllib.parse import parse_qsl, urlparse

        viewer = self

        class Handler(BaseHTTPRequestHandler):
            def _send(self, code, body, ctype="application/json"):
                data = body if isinstance(body, bytes) else \
                    json.dumps(body).encode()
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def do_GET(self):  # noqa: N802
                u = urlparse(self.path)
                q = dict(parse_qsl(u.query))
                try:
                    if u.path == "/":
                        self._send(200, _PAGE.encode(), "text/html")
                    elif u.path == "/render":
                        self._send(200, viewer._render(q), "image/jpeg")
                    elif u.path == "/slam_frame":
                        self._send(200, viewer._slam_frame(), "image/jpeg")
                    elif u.path == "/state":
                        self._send(200, viewer._state())
                    else:
                        self._send(404, dict(error="not found"))
                except Exception as e:  # noqa: BLE001
                    self._send(500, dict(error=str(e)))

            def do_POST(self):  # noqa: N802
                if urlparse(self.path).path != "/params":
                    return self._send(404, dict(error="not found"))
                n = int(self.headers.get("Content-Length", 0))
                payload = json.loads(self.rfile.read(n)) if n else {}
                self._send(200, viewer._set_params(payload))

            def log_message(self, *a):
                pass

        server = ThreadingHTTPServer((self.host, self.port), Handler)
        return server

    def serve_background(self):
        server = self.serve()
        t = threading.Thread(target=server.serve_forever, daemon=True)
        t.start()
        return server


def main(argv=None):
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("--ply", required=True)
    ap.add_argument("--port", type=int, default=8006)
    ap.add_argument("--device", default="cuda",
                    help="torch device the map is rendered on")
    args = ap.parse_args(argv)
    v = ViewerServer(port=args.port, device=args.device)
    v.attach_ply(args.ply)
    print(f"viewer on :{args.port}")
    v.serve().serve_forever()


if __name__ == "__main__":
    main()
