"""Video compositing (PyTorch port of ``gsplat_tpu/viz/video.py``; reference
composite_video.py:35-78).

Frames arrive as host numpy arrays, ``[3, H, W]`` (or ``[H, W, 3]``) float
in [0, 1], as the render CLI reads them back from the card.  The primary
writer is OpenCV's mp4 writer like the reference (save_vidio_no_depth,
composite_video.py:53-65); then ffmpeg; then the numbered PNG frames
(which every downstream tool accepts) are left where they are.  Each call
prints which of the three it took.
"""
from __future__ import annotations

import os
import shutil
import subprocess
from typing import List

import numpy as np


def save_frames(frames: List[np.ndarray], out_dir: str) -> List[str]:
    from PIL import Image

    os.makedirs(out_dir, exist_ok=True)
    paths = []
    for i, f in enumerate(frames):
        arr = np.clip(f, 0, 1)
        if arr.ndim == 3 and arr.shape[0] in (1, 3):
            arr = arr.transpose(1, 2, 0)
        if arr.shape[-1] == 1:
            arr = np.repeat(arr, 3, axis=-1)
        p = os.path.join(out_dir, f"{i:05d}.png")
        Image.fromarray((arr * 255).astype(np.uint8)).save(p)
        paths.append(p)
    return paths


def _write_cv2(paths: List[str], out_path: str, fps: int) -> bool:
    """OpenCV's mp4 writer; False when it wrote nothing.  Any cv2 error
    (no cv2, a codec it lacks, an unreadable frame) is printed and taken as
    False, so that ``save_video`` falls through to ffmpeg, as the JAX
    package does."""
    try:
        import cv2
        first = cv2.imread(paths[0])
        h, w = first.shape[:2]
        vw = cv2.VideoWriter(out_path, cv2.VideoWriter_fourcc(*"mp4v"), fps,
                             (w, h))
        if not vw.isOpened():
            return False
        for p in paths:
            vw.write(cv2.imread(p))
        vw.release()
        return os.path.exists(out_path) and os.path.getsize(out_path) > 0
    except Exception as e:  # noqa: BLE001
        print(f"[video] cv2 writer unavailable ({e}); trying ffmpeg")
        return False


def save_video(frames: List[np.ndarray], out_path: str, fps: int = 30) -> str:
    """Write an mp4 (cv2, then ffmpeg) or fall back to a PNG sequence dir;
    returns what was written and prints which encoder wrote it."""
    frame_dir = os.path.splitext(out_path)[0] + "_frames"
    paths = save_frames(frames, frame_dir)
    if _write_cv2(paths, out_path, fps):
        print(f"[video] encoder cv2: {out_path}")
        return out_path
    ffmpeg = shutil.which("ffmpeg")
    if ffmpeg:
        subprocess.run(
            [ffmpeg, "-y", "-loglevel", "error", "-framerate", str(fps),
             "-i", os.path.join(frame_dir, "%05d.png"),
             "-pix_fmt", "yuv420p", out_path],
            check=True)
        print(f"[video] encoder ffmpeg: {out_path}")
        return out_path
    print(f"[video] encoder none (no cv2/ffmpeg); frames left in {frame_dir}")
    return frame_dir


def _read_rgb(path: str) -> np.ndarray:
    from PIL import Image

    with Image.open(path) as im:
        arr = np.asarray(im.convert("RGB"))
    return arr


def save_vidio(model_path: str, name: str, step,
               fps: int = 30) -> str:
    """Depth-composited set video: each rendered frame beside its depth
    pane, written as ``<name>-step_<step>-test.mp4`` — the reference's
    ``save_vidio`` (composite_video.py:35-52; the function name's spelling
    is the reference's API).  Reads the ``<model>/<name>/ours_<step>/
    {renders,depth}`` folders ``render_set`` writes."""
    base = os.path.join(model_path, name, f"ours_{step}")
    renders = sorted(os.listdir(os.path.join(base, "renders")))
    depths = sorted(os.listdir(os.path.join(base, "depth")))
    frames = []
    for rp, dp in zip(renders, depths):
        im = _read_rgb(os.path.join(base, "renders", rp))
        d = _read_rgb(os.path.join(base, "depth", dp))
        frames.append(np.concatenate([im, d], axis=1).astype(np.float32)
                      / 255.0)
    return save_video(frames,
                      os.path.join(model_path,
                                   f"{name}-step_{step}-test.mp4"), fps)


def save_vidio_no_depth(model_path: str, name: str, step,
                        fps: int = 30) -> str:
    """Set video without the depth pane (composite_video.py:53-65)."""
    base = os.path.join(model_path, name, f"ours_{step}")
    renders = sorted(os.listdir(os.path.join(base, "renders")))
    frames = [
        _read_rgb(os.path.join(base, "renders", rp)).astype(np.float32)
        / 255.0 for rp in renders]
    return save_video(frames,
                      os.path.join(model_path,
                                   f"{name}-step_{step}-test.mp4"), fps)
