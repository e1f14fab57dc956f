"""HTTP render server and browser client (PyTorch port of
``gsplat_tpu/viz/render_app.py``; the reference's visual_res_app/render_app.py,
a Flask app, on the stdlib http.server).

GET /api/generate-image?type=<key> maps WASD-style keys to camera moves and
returns a PNG of the re-rendered view (render_app.py:24-160); ``/`` serves a
minimal JS client, ``/viewer`` the client-side WebGL2 page
(``viz/webgl_viewer.py``), ``/api/splats`` the packed model and
``/api/viewer-info`` its framing.  The HTML strings are the JAX module's,
byte for byte.

The taichi visualizer's keyframe->video session (visualizer.py:436-499):
``,``/``.`` capture/drop camera keyframes, SPACE toggles a live slerp path
preview (each refresh advances one interpolated pose), ``y`` exports the
path as poses_render.npy and an mp4, ``p`` toggles the projections overlay
(scene cameras, keyframe frusta, the preview path; visualizer.py:559-716),
and ``b`` toggles the camera-bounds limit mode (visualizer.py:365-374).

Every frame is ``renderer.render`` on the model's device: with the
``"auto"`` backend one launch each of the expansion kernel K3 and the
forward composite kernel K1.  ``ThreadingHTTPServer`` serves each request
on a thread of its own; the server's one lock serialises every render and
every read of the model, as in the JAX module.
"""
from __future__ import annotations

import io
import json
import os
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

import numpy as np

from gsplat_tpu_torch.core.cameras import MiniCam, get_projection_matrix
from gsplat_tpu_torch.renderer import render
from gsplat_tpu_torch.scripts.visualize import frame_for_mode
from gsplat_tpu_torch.viz import camera_trajectory as traj
from gsplat_tpu_torch.viz import webgl_viewer
from gsplat_tpu_torch.viz.video import save_video

_CLIENT_HTML = """<!doctype html><html><head><meta charset="utf-8">
<title>gsplat_tpu viewer</title></head>
<body style="background:#111;color:#eee;font-family:monospace">
<h3>gsplat_tpu live viewer</h3>
<p>keys: w/s forward/back &nbsp; a/d left/right &nbsp; q/e up/down &nbsp;
i/k pitch &nbsp; j/l yaw &nbsp; m cycle mode<br>
, capture keyframe &nbsp; . drop keyframe &nbsp; SPACE preview path &nbsp;
y export video &nbsp; p projections overlay &nbsp; b camera-bounds limit</p>
<img id="v" width="80%%"/>
<script>
const img = document.getElementById('v');
function refresh(key) {
  img.src = '/api/generate-image?type=' +
      encodeURIComponent(key||'none') + '&t=' + Date.now();
}
document.addEventListener('keydown', e => refresh(e.key));
refresh();
</script></body></html>"""


def _project_points(pts: np.ndarray, full_proj: np.ndarray, W: int, H: int):
    """World points -> pixel coords via the row-vector full projection;
    returns ([N,2] float pixels, [N] bool in-front mask)."""
    h = np.concatenate([pts, np.ones((len(pts), 1), np.float32)], axis=1)
    clip = h @ full_proj
    wcl = clip[:, 3:4]
    ok = wcl[:, 0] > 1e-4
    ndc = clip[:, :3] / np.maximum(wcl, 1e-4)
    px = (ndc[:, 0] + 1) * 0.5 * W
    py = (ndc[:, 1] + 1) * 0.5 * H
    return np.stack([px, py], axis=1), ok


def _draw_line(frame: np.ndarray, p0, p1, color):
    """Sampled line segment into an HWC float frame (overlay drawing)."""
    H, W = frame.shape[:2]
    n = int(max(abs(p1[0] - p0[0]), abs(p1[1] - p0[1]), 1))
    n = min(n, 4 * max(H, W))
    ts = np.linspace(0.0, 1.0, n + 1)
    xs = np.clip((p0[0] + (p1[0] - p0[0]) * ts).astype(int), 0, W - 1)
    ys = np.clip((p0[1] + (p1[1] - p0[1]) * ts).astype(int), 0, H - 1)
    inb = ((p0[0] + (p1[0] - p0[0]) * ts) >= 0) & \
          ((p0[0] + (p1[0] - p0[0]) * ts) < W) & \
          ((p0[1] + (p1[1] - p0[1]) * ts) >= 0) & \
          ((p0[1] + (p1[1] - p0[1]) * ts) < H)
    frame[ys[inb], xs[inb]] = color


_FRUSTUM_EDGES = [(0, 1), (0, 2), (0, 3), (0, 4),
                  (1, 2), (2, 3), (3, 4), (4, 1)]


def _cam_center(world_view: np.ndarray) -> np.ndarray:
    """c2w translation of a row-vector world_view matrix."""
    return np.linalg.inv(np.asarray(world_view, np.float64).T)[:3, 3]




def encode_png(frame: np.ndarray) -> bytes:
    """The PNG of an [H, W, 3] float frame: clipped to [0, 1], scaled by 255
    and truncated to uint8, as the JAX module encodes it."""
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray((np.clip(frame, 0, 1) * 255).astype(np.uint8)).save(
        buf, "PNG")
    return buf.getvalue()


class RenderServer:
    """Holds the model + camera state and serves rendered frames."""

    KEY_ACTIONS = {
        "w": ("translate", dict(dz=1)), "s": ("translate", dict(dz=-1)),
        "a": ("translate", dict(dx=-1)), "d": ("translate", dict(dx=1)),
        "q": ("translate", dict(dy=-1)), "e": ("translate", dict(dy=1)),
        "j": ("rotate", ("y", -5)), "l": ("rotate", ("y", 5)),
        "i": ("rotate", ("x", -5)), "k": ("rotate", ("x", 5)),
        "u": ("rotate", ("z", -5)), "o": ("rotate", ("z", 5)),
    }
    MODES = ["rgb", "depth", "segment"]

    def __init__(self, gaussians, template_cam, backend="auto", step=0.15,
                 scene_cams=None, out_dir=".", n_path_frames=120):
        self.gaussians = gaussians
        self.cam = template_cam
        self.backend = backend
        self.step = step
        self.world_view = np.array(template_cam.world_view_transform)
        self.proj = getattr(template_cam, "projection_matrix", None)
        if self.proj is None:
            self.proj = get_projection_matrix(
                0.01, 100.0, template_cam.FoVx, template_cam.FoVy).T
        self.mode = "rgb"
        self.lock = threading.Lock()
        # keyframe->video session state (visualizer.py:436-499)
        self.keyframes = []          # captured world_view matrices
        self.preview = False
        self._preview_poses = None
        self._preview_i = 0
        self.overlay = False
        # camera-bounds "limit mode" (visualizer.py:365-374, latent in the
        # reference: cam_pan_bbox is initialized to None at :169 and never
        # assigned, so its in-bbox test is dead code; here `b` builds the
        # bounds from the scene cameras and makes the mode functional)
        self.limit = False
        self.cam_bounds = None       # (lo[3], hi[3]) over c2w centers
        self.outbound = False        # last move was rejected (red border)
        self.scene_cams = [np.array(c.world_view_transform)
                           for c in (scene_cams or [])]
        self.out_dir = out_dir
        self.n_path_frames = n_path_frames
        self.last_export = None
        self.httpd = None            # set by serve(); its shutdown() ends it
        self.serving = threading.Event()

    def handle_key(self, key: str):
        if key == "m":
            self.mode = self.MODES[
                (self.MODES.index(self.mode) + 1) % len(self.MODES)]
            return
        if key == ",":
            self.keyframes.append(self.world_view.copy())
            return
        if key == ".":
            if self.keyframes:
                self.keyframes.pop()
            return
        if key in (" ", "space", "Space"):
            self.preview = bool(self.keyframes) and not self.preview
            self._preview_poses = None
            self._preview_i = 0
            return
        if key == "p":
            self.overlay = not self.overlay
            return
        if key == "y":
            self.export_video()
            return
        if key == "b":
            if self.limit:
                self.limit = False
                return
            if not self.scene_cams:
                # nothing to bound by: refuse rather than silently enable
                # a mode that constrains nothing
                print("[viewer] limit mode unavailable: no scene cameras")
                return
            # rebuild on every enable so the bounds track scene_cams changes
            centers = np.stack([_cam_center(wv) for wv in self.scene_cams])
            lo, hi = centers.min(0), centers.max(0)
            pad = 0.25 * np.maximum(hi - lo, 1e-3)
            self.cam_bounds = (lo - pad, hi + pad)
            self.limit = True
            return
        action = self.KEY_ACTIONS.get(key)
        if action is None:
            return
        self.preview = False  # any motion key cancels the path preview
        kind, arg = action
        if kind == "translate":
            nxt = traj.translate(self.world_view, step=self.step,
                                 **{k: v for k, v in arg.items()})
            if self.limit and self.cam_bounds is not None:
                c = _cam_center(nxt)
                lo, hi = self.cam_bounds
                self.outbound = bool(np.any(c < lo) or np.any(c > hi))
                if self.outbound:   # reject the move (visualizer.py:369-374)
                    return
            self.world_view = nxt
        else:
            self.world_view = traj.rotate(self.world_view, arg[0], arg[1])

    def _path_poses(self):
        if self._preview_poses is None and self.keyframes:
            self._preview_poses = traj.inter_poses(self.keyframes,
                                                   self.n_path_frames)
        return self._preview_poses

    def export_video(self):
        """Slerp the keyframe path, save poses_render.npy (replayable by
        render.py --render_file) and an mp4: the ``y`` export of
        visualizer.py:436-463, headless.  The frames reach ``save_video`` as
        uint8, as in the JAX module, whose ``save_frames`` clips them to
        [0, 1] before scaling: the exported frames are the JAX module's."""
        if not self.keyframes:
            return None
        os.makedirs(self.out_dir, exist_ok=True)
        poses_path = os.path.join(self.out_dir, "poses_render.npy")
        poses = traj.inter_poses(self.keyframes, self.n_path_frames,
                                 save_path=poses_path)
        frames = [np.asarray(self._render_frame(p)) for p in poses]
        video_path = save_video(
            [(np.clip(f, 0, 1) * 255).astype(np.uint8) for f in frames],
            os.path.join(self.out_dir, "keyframe_path.mp4"))
        self.last_export = (poses_path, video_path)
        print(f"[viewer] exported {len(frames)} frames -> {video_path} "
              f"(+ {poses_path})")
        return video_path

    def _render_frame(self, world_view) -> np.ndarray:
        wv = np.asarray(world_view, np.float32)
        cam = MiniCam(self.cam.image_width, self.cam.image_height,
                      self.cam.FoVy, self.cam.FoVx, 0.01, 100.0,
                      wv, (wv @ self.proj).astype(np.float32))
        out = render(cam, self.gaussians, backend=self.backend,
                     device=self.gaussians.device)
        return frame_for_mode(out, self.mode, self.gaussians.num_class)

    def _draw_overlay(self, frame: np.ndarray, view_wv: np.ndarray):
        """Project scene-camera frusta (cyan), keyframe frusta (yellow) and
        the interpolated path (green) into the frame
        (visualizer.py:559-716's projections overlay, headless)."""
        H, W = frame.shape[:2]
        full = (view_wv @ self.proj).astype(np.float32)

        def draw_frustum(wv, color):
            pts = traj.cam_frustum_points(wv)
            pix, ok = _project_points(pts, full, W, H)
            for i, j in _FRUSTUM_EDGES:
                if ok[i] and ok[j]:
                    _draw_line(frame, pix[i], pix[j], color)

        for wv in self.scene_cams:
            draw_frustum(wv, np.array([0.2, 0.9, 0.9], np.float32))
        for wv in self.keyframes:
            draw_frustum(wv, np.array([1.0, 0.9, 0.1], np.float32))
        poses = self._path_poses()
        if poses is not None:
            centers = np.stack([
                np.linalg.inv(np.asarray(p, np.float64).T)[:3, 3]
                for p in poses]).astype(np.float32)
            pix, ok = _project_points(centers, full, W, H)
            for i in range(len(pix) - 1):
                if ok[i] and ok[i + 1]:
                    _draw_line(frame, pix[i], pix[i + 1],
                               np.array([0.2, 1.0, 0.2], np.float32))
        return frame

    def render_png(self) -> bytes:
        wv = self.world_view
        if self.preview:
            poses = self._path_poses()
            if poses is not None:
                wv = poses[self._preview_i % len(poses)]
                self._preview_i += 1
        frame = np.array(self._render_frame(wv), copy=True)
        if frame.ndim == 2:
            frame = np.repeat(frame[..., None], 3, axis=-1)
        if self.overlay:
            frame = self._draw_overlay(frame, np.asarray(wv, np.float32))
        if self.outbound:           # rejected move: flash a red border
            frame[:3, :] = frame[-3:, :] = [1.0, 0.15, 0.15]
            frame[:, :3] = frame[:, -3:] = [1.0, 0.15, 0.15]
            self.outbound = False
        return encode_png(frame)

    def make_handler(server_self):
        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet
                pass

            def do_GET(self):
                parsed = urlparse(self.path)
                if parsed.path == "/":
                    body = _CLIENT_HTML.encode()
                    self.send_response(200)
                    self.send_header("Content-Type", "text/html")
                    self.end_headers()
                    self.wfile.write(body)
                elif parsed.path == "/viewer":
                    # client-side WebGL2 splatting page (the SIBR desktop
                    # viewer's interactive role, web-native)
                    body = webgl_viewer.VIEWER_HTML.encode()
                    self.send_response(200)
                    self.send_header("Content-Type", "text/html")
                    self.end_headers()
                    self.wfile.write(body)
                elif parsed.path == "/api/splats":
                    with server_self.lock:
                        buf = webgl_viewer.pack_splats(server_self.gaussians)
                    self.send_response(200)
                    self.send_header("Content-Type",
                                     "application/octet-stream")
                    self.send_header("Content-Length", str(len(buf)))
                    self.end_headers()
                    self.wfile.write(buf)
                elif parsed.path == "/api/viewer-info":
                    with server_self.lock:
                        info = webgl_viewer.scene_info(
                            server_self.gaussians, server_self.cam)
                    body = json.dumps(info).encode()
                    self.send_response(200)
                    self.send_header("Content-Type", "application/json")
                    self.end_headers()
                    self.wfile.write(body)
                elif parsed.path == "/api/generate-image":
                    q = parse_qs(parsed.query)
                    key = (q.get("type") or ["none"])[0]
                    with server_self.lock:
                        server_self.handle_key(key)
                        png = server_self.render_png()
                    self.send_response(200)
                    self.send_header("Content-Type", "image/png")
                    self.end_headers()
                    self.wfile.write(png)
                else:
                    self.send_response(404)
                    self.end_headers()

        return Handler

    def serve(self, host="127.0.0.1", port=5000):
        """Serve until ``self.httpd.shutdown()``; port 0 takes a free port
        (``self.httpd.server_address`` names it once ``self.serving`` is
        set)."""
        self.httpd = ThreadingHTTPServer((host, port), self.make_handler())
        print(f"render server on http://{host}:{port}")
        self.serving.set()
        try:
            self.httpd.serve_forever()
        finally:
            self.httpd.server_close()


def main(argv=None):
    import sys
    from argparse import ArgumentParser

    from gsplat_tpu_torch.config import (ModelParams, PipelineParams,
                                         get_combined_args)
    from gsplat_tpu_torch.data.scene import Scene
    from gsplat_tpu_torch.device import resolve_device
    from gsplat_tpu_torch.models.gaussians import GaussianModel

    parser = ArgumentParser()
    model = ModelParams(parser, sentinel=True)
    PipelineParams(parser)
    parser.add_argument("--iteration", default=-1, type=int)
    parser.add_argument("--port", default=5000, type=int)
    parser.add_argument("--backend", default="auto", type=str)
    args = get_combined_args(parser, sys.argv[1:] if argv is None else argv)

    dataset = model.extract(args)
    device = resolve_device(dataset.data_device or "cuda")
    # sized to the PLY, as the render CLI (the JAX CLI allocates 2^19)
    gaussians = GaussianModel(dataset.sh_degree,
                              num_class=getattr(dataset, "num_class", 2),
                              capacity=1, device=device)
    scene = Scene(dataset, gaussians, load_iteration=args.iteration,
                  shuffle=False, low_memory=True)
    cams = scene.getTrainCameras() or scene.getTestCameras()
    RenderServer(gaussians, cams[0], backend=args.backend,
                 scene_cams=cams[:24], out_dir=args.model_path).serve(
        port=args.port)


if __name__ == "__main__":
    main()
