"""The live-viewer socket of the port (``gsplat_tpu_torch/viz/
network_gui.py``) on the CPU: its wire bytes against the JAX module's, a
``Trainer`` serving a loopback client, and the training command line's
default of opening the socket.  Every client socket has a timeout, so no
test can hang on the network."""
import json
import os
import socket
import threading

import numpy as np
import pytest
import torch

from gsplat_tpu.viz import network_gui as jgui
from gsplat_tpu_torch import renderer
from gsplat_tpu_torch.core.cameras import MiniCam
from gsplat_tpu_torch.data.scene import Scene
from gsplat_tpu_torch.models import gaussians as tgauss
from gsplat_tpu_torch.scripts import render as trender
from gsplat_tpu_torch.scripts import train as ttrain
from gsplat_tpu_torch.train.trainer import Trainer
from gsplat_tpu_torch.viz import network_gui as tgui

from torch_helpers import (SCENE_CLASSES, RecordSteps, dataset_args,  # noqa: F401
                           port_opt, scene_dir)

TIMEOUT = 20.0


@pytest.fixture(autouse=True)
def closed_sockets():
    """Each test starts and ends with no listener and no connection in
    either package's module."""
    yield
    for mod in (tgui, jgui):
        for name in ("conn", "listener"):
            s = getattr(mod, name)
            if s is not None:
                s.close()
            setattr(mod, name, None)


def _message(cam, **flags):
    """A SIBR camera message for ``cam``: the view matrix with columns 1
    and 2 negated and the projection with column 1 negated, as the viewer
    sends them (``receive`` negates them back)."""
    vm = np.array(cam.world_view_transform, np.float64)
    vm[:, 1:3] *= -1
    pm = np.array(cam.full_proj_transform, np.float64)
    pm[:, 1] *= -1
    msg = {"resolution_x": cam.image_width, "resolution_y": cam.image_height,
           "train": False, "fov_y": cam.FoVy, "fov_x": cam.FoVx,
           "z_near": 0.01, "z_far": 100.0, "shs_python": False,
           "rot_scale_python": False, "keep_alive": True,
           "scaling_modifier": 1.0, "view_matrix": vm.ravel().tolist(),
           "view_projection_matrix": pm.ravel().tolist()}
    msg.update(flags)
    payload = json.dumps(msg).encode("utf-8")
    return len(payload).to_bytes(4, "little") + payload


def _recv_exactly(s, n):
    buf = b""
    while len(buf) < n:
        chunk = s.recv(n - len(buf))
        assert chunk, "the server closed the connection"
        buf += chunk
    return buf


def test_wire_bytes_match_jax():
    """The port's ``send`` writes, and its ``read`` and ``receive``
    consume, the JAX module's bytes (``tests/test_viz_tools.py``'s golden
    exchange) over a socketpair."""
    golden = bytes.fromhex(
        "000102030405060708090a0b0c0d0e0f1011121314151617"  # 24 image bytes
        "10000000"                                           # u32le 16
        "2f7265662f736f757263652f70617468")                  # "/ref/source/path"
    replies = {}
    for name, mod in (("jax", jgui), ("port", tgui)):
        a, b = socket.socketpair()
        with a, b:
            b.settimeout(TIMEOUT)
            mod.conn = a
            mod.send(bytes(range(24)), "/ref/source/path")
            mod.send(None, "/only/verify")
            a.shutdown(socket.SHUT_WR)
            reply = b""
            while chunk := b.recv(4096):
                reply += chunk
            replies[name] = reply
            mod.conn = None
    assert replies["port"] == replies["jax"]
    assert replies["port"][:len(golden)] == golden

    vm0 = np.eye(4)
    vm0[3, :3] = [1.0, -2.0, 3.0]
    pm0 = np.diag([1.0, 2.0, 3.0, 4.0])
    msg = {"resolution_x": 4, "resolution_y": 2, "train": True,
           "fov_y": 0.8, "fov_x": 1.2, "z_near": 0.01, "z_far": 100.0,
           "shs_python": False, "rot_scale_python": False,
           "keep_alive": True, "scaling_modifier": 1.0,
           "view_matrix": list(vm0.ravel()),
           "view_projection_matrix": list(pm0.ravel())}
    payload = json.dumps(msg).encode("utf-8")
    framed = len(payload).to_bytes(4, "little") + payload
    got = {}
    for name, mod in (("jax", jgui), ("port", tgui)):
        a, b = socket.socketpair()
        with a, b:
            a.settimeout(TIMEOUT)
            mod.conn = a
            b.sendall(framed + framed)
            assert mod.read() == msg
            got[name] = mod.receive()
            mod.conn = None
    (jcam, *jflags), (tcam, *tflags) = got["jax"], got["port"]
    assert isinstance(tcam, MiniCam) and tflags == jflags
    assert tflags == [True, False, False, True, 1.0]
    for k in ("world_view_transform", "full_proj_transform",
              "camera_center"):
        np.testing.assert_array_equal(getattr(tcam, k),
                                      np.asarray(getattr(jcam, k)), err_msg=k)
    for k in ("image_width", "image_height", "FoVx", "FoVy", "znear",
              "zfar"):
        assert getattr(tcam, k) == getattr(jcam, k), k
    # a message with no resolution is answered with the path alone
    a, b = socket.socketpair()
    with a, b:
        a.settimeout(TIMEOUT)
        tgui.conn = a
        empty = json.dumps(dict(msg, resolution_x=0)).encode("utf-8")
        b.sendall(len(empty).to_bytes(4, "little") + empty)
        assert tgui.receive() == (None,) * 6
        tgui.conn = None


def _scene_model(scene_dir, out):
    m = tgauss.GaussianModel(3, num_class=SCENE_CLASSES, capacity=512,
                             device="cpu")
    scene = Scene(dataset_args(scene_dir, out), m)
    m.training_setup()
    return m, scene


def test_trainer_serves_frames(scene_dir, tmp_path):
    """A ``Trainer`` with ``gui_source_path`` serves a loopback client at
    the top of its first iteration: each frame equals the quantised
    ``renderer.render`` of the model before training, byte for byte, and
    the path follows it; training goes on after the client leaves."""
    import copy
    m, scene = _scene_model(scene_dir, str(tmp_path / "m"))
    before = copy.deepcopy(m)
    cam = scene.getTrainCameras()[1]
    tgui.init("127.0.0.1", 0)
    port = tgui.listener.getsockname()[1]
    tr = Trainer(m, scene, port_opt(), max_instances=1 << 14,
                 gui_source_path="/the/source")
    frames, errors = [], []
    n = cam.image_width * cam.image_height * 3

    def client(s):
        try:
            for last in (False, False, True):
                s.sendall(_message(cam, train=last, keep_alive=not last))
                img = _recv_exactly(s, n)
                k = int.from_bytes(_recv_exactly(s, 4), "little")
                frames.append((img, _recv_exactly(s, k).decode("ascii")))
        except Exception as e:  # noqa: BLE001
            errors.append(e)
        finally:
            # the server reads the close as the end of the exchange, so a
            # failing client cannot leave it waiting
            s.close()

    with socket.create_connection(("127.0.0.1", port),
                                  timeout=TIMEOUT) as s:
        th = threading.Thread(target=client, args=(s,), daemon=True)
        th.start()
        rec = RecordSteps()
        # the first poll serves all three messages; the client closes
        # while iteration 1 trains, and a later poll drops it
        tr.train(1, log_every=1, callback=rec)
        th.join(TIMEOUT)
    assert not th.is_alive() and not errors, errors
    tr.train(4, first_iter=1, log_every=1, callback=rec)
    assert [r[0] for r in rec.rows] == [1, 2, 3, 4]
    assert tgui.conn is None
    want = trender.quantize(renderer.render(
        cam, before, bg_color=tr.bg, max_instances=tr.max_instances,
        device="cpu")["render"].numpy())
    assert len(frames) == 3
    for img, path in frames:
        assert path == "/the/source"
        assert img == want.tobytes()
    assert not torch.equal(m.params.xyz, before.params.xyz)


def test_cli_opens_the_socket(scene_dir, tmp_path, capsys):
    """Without ``--disable_gui_server`` the command line opens the socket
    (``--port 0``: any free port) and trains; on a port already bound it
    prints the JAX CLI's line and trains on without it."""
    base = ["-s", scene_dir, "--data_device", "cpu", "--capacity", "512",
            "--max_instances", "16384", "--iterations_override", "2",
            "--test_iterations", "99", "--densify_from_iter", "99",
            "--ip", "127.0.0.1"]
    out = str(tmp_path / "open")
    ttrain.main(base + ["-m", out, "--port", "0"])
    assert tgui.listener is not None and tgui.listener.getsockname()[1] > 0
    assert "[gui]" not in capsys.readouterr().out
    tgui.listener.close()
    tgui.listener = None

    with socket.socket() as taken:
        taken.bind(("127.0.0.1", 0))
        taken.listen()
        out = str(tmp_path / "taken")
        ttrain.main(base + ["-m", out, "--port",
                            str(taken.getsockname()[1])])
    said = capsys.readouterr().out
    assert "[gui] socket server disabled: " in said
    assert os.path.exists(os.path.join(out, "point_cloud", "iteration_2",
                                       "point_cloud.ply"))
    with open(os.path.join(out, "train_log.jsonl")) as f:
        assert [json.loads(x)["iter"] for x in f] == [2]
