"""Serve the HTTP viewer (server-side renders and the /viewer WebGL page) on
a bare PLY or NPZ asset, no model directory needed (PyTorch port of the JAX
package's ``tools/serve_asset_viewer.py``):

    python -m gsplat_tpu_torch.tools.serve_asset_viewer \\
        assets/trained_scene.ply --port 5005

The frames render on ``--data_device`` (``cuda`` by default; ``cpu`` runs
every kernel's plain version).  The camera looks down -z at the alive
gaussians' mean from 2.2 times their 95th-percentile radius.
"""
from __future__ import annotations

import argparse
import math


def build_server(argv=None):
    """The ``RenderServer`` of the command line ``argv`` and its port."""
    import numpy as np

    from gsplat_tpu_torch.core.cameras import Camera
    from gsplat_tpu_torch.device import resolve_device
    from gsplat_tpu_torch.models.gaussians import GaussianModel
    from gsplat_tpu_torch.viz.render_app import RenderServer

    ap = argparse.ArgumentParser()
    ap.add_argument("asset")
    ap.add_argument("--port", type=int, default=5005)
    ap.add_argument("--backend", default="auto")
    ap.add_argument("--width", type=int, default=960)
    ap.add_argument("--height", type=int, default=540)
    ap.add_argument("--data_device", default="cuda")
    args = ap.parse_args(argv)

    m = GaussianModel(3, num_class=2, capacity=1,
                      device=resolve_device(args.data_device))
    if args.asset.endswith(".npz"):
        # the compressed bench asset (raw parameter fields, geometry f32,
        # SH bands fp16); its SH degree stays 0, as the JAX tool leaves it
        m.load_npz(args.asset)
        m.active_sh_degree = 0
    else:
        m.load_ply(args.asset)

    pts = m.get_xyz[m.aux.alive].cpu().numpy()
    center = pts.mean(axis=0)
    extent = float(np.percentile(np.linalg.norm(pts - center, axis=1), 95))
    fovx = math.radians(60.0)
    fovy = 2 * math.atan(math.tan(fovx / 2) * args.height / args.width)
    cam = Camera(colmap_id=0, R=np.eye(3), T=center + [0, 0, 2.2 * extent],
                 FoVx=fovx, FoVy=fovy,
                 image=np.zeros((3, args.height, args.width), np.float32),
                 image_name="viewer", uid=0)
    return RenderServer(m, cam, backend=args.backend), args.port


def main(argv=None):
    server, port = build_server(argv)
    server.serve(port=port)


if __name__ == "__main__":
    main()
