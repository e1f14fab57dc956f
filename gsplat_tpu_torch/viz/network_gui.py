"""Live-training GUI socket server (PyTorch port of
``gsplat_tpu/viz/network_gui.py``; reference gaussian_renderer/
network_gui.py).

A non-blocking TCP server polled from the train loop: it receives a JSON
camera message {resolution_x/y, fov_y/x, z_near/far, view_matrix,
view_projection_matrix, train flags, scaling_modifier, keep_alive}, renders
one frame, and replies with the raw RGB bytes and the source-path string:
the SIBR remote viewer protocol (network_gui.py:26-85).  The JAX package's
semantics are kept, quirks included, so that one client sees the same
bytes from either package: one ``recv`` per message, the frame clipped,
times 255 and truncated to uint8 HWC, ``keep_training`` always True, and a
failed exchange drops the connection (``conn = None``).  A failed render is
not an exchange: it raises (``poll_and_render``).
"""
from __future__ import annotations

import json
import socket
import traceback
from typing import Optional

import numpy as np

from gsplat_tpu_torch.utils.general import quantize

host = "127.0.0.1"
port = 6009
listener: Optional[socket.socket] = None
conn: Optional[socket.socket] = None
addr = None


def init(wish_host: str, wish_port: int):
    global host, port, listener
    host = wish_host
    port = wish_port
    listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    listener.bind((host, port))
    listener.listen()
    listener.settimeout(0)


def try_connect():
    global conn, addr
    if listener is None:
        return
    try:
        conn, addr = listener.accept()
        print(f"\nConnected by {addr}")
        conn.settimeout(None)
    except Exception:
        pass


def read() -> Optional[dict]:
    """One JSON message framed by a u32 length (network_gui.py:38-48)."""
    if conn is None:
        return None
    messageLength = conn.recv(4)
    messageLength = int.from_bytes(messageLength, "little")
    message = conn.recv(messageLength)
    return json.loads(message.decode("utf-8"))


def send(message_bytes: Optional[bytes], verify: str):
    if conn is None:
        return
    if message_bytes is not None:
        conn.sendall(message_bytes)
    conn.sendall(len(verify).to_bytes(4, "little"))
    conn.sendall(bytes(verify, "ascii"))


def receive():
    """Parse one camera message -> (MiniCam | None, flags)
    (network_gui.py:57-85)."""
    from gsplat_tpu_torch.core.cameras import MiniCam

    message = read()
    width = message["resolution_x"]
    height = message["resolution_y"]
    if width != 0 and height != 0:
        try:
            do_training = bool(message["train"])
            fovy = message["fov_y"]
            fovx = message["fov_x"]
            znear = message["z_near"]
            zfar = message["z_far"]
            do_shs_python = bool(message["shs_python"])
            do_rot_scale_python = bool(message["rot_scale_python"])
            keep_alive = bool(message["keep_alive"])
            scaling_modifier = message["scaling_modifier"]
            world_view_transform = np.reshape(
                np.array(message["view_matrix"]), (4, 4))
            world_view_transform[:, 1] = -world_view_transform[:, 1]
            world_view_transform[:, 2] = -world_view_transform[:, 2]
            full_proj_transform = np.reshape(
                np.array(message["view_projection_matrix"]), (4, 4))
            full_proj_transform[:, 1] = -full_proj_transform[:, 1]
            custom_cam = MiniCam(width, height, fovy, fovx, znear, zfar,
                                 world_view_transform, full_proj_transform)
        except Exception:
            print("")
            traceback.print_exc()
            raise
        return (custom_cam, do_training, do_shs_python,
                do_rot_scale_python, keep_alive, scaling_modifier)
    return None, None, None, None, None, None


def frame_bytes(image) -> memoryview:
    """A rendered ``[3, H, W]`` image (a tensor on any device) as the bytes
    the client reads: ``quantize``'s ``[H, W, 3]`` uint8, in C order."""
    return memoryview(np.ascontiguousarray(
        quantize(image.detach().cpu().numpy())))


def poll_and_render(gaussians, pipe_source_path: str, render_fn) -> bool:
    """One train-loop poll (train.py:71-84): serves messages until the
    client asks to train on (``train`` without ``keep_alive``) or an
    exchange fails.  Returns ``keep_training``, always True as in the
    reference.  Unlike the JAX package's poll, the render sits outside the
    exchange's ``try``: a failed kernel build or launch raises instead of
    dropping the connection."""
    global conn
    if conn is None:
        try_connect()
    keep_training = True
    while conn is not None:
        try:
            (custom_cam, do_training, _, _, keep_alive,
             scaling_modifier) = receive()
        except Exception:
            conn = None
            break
        net_image_bytes = None
        if custom_cam is not None:
            out = render_fn(custom_cam, gaussians, scaling_modifier)
            net_image_bytes = frame_bytes(out["render"])
        try:
            send(net_image_bytes, pipe_source_path)
        except Exception:
            conn = None
            break
        if do_training and ((not keep_alive)):
            break
    return keep_training
