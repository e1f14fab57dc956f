"""The visualize CLI, the HTTP viewer's frames and endpoints and the bare
asset viewer of the port on the CPU, against the JAX package's
(``scripts/visualize.py``, ``viz/render_app.py``,
``tools/serve_asset_viewer.py``).

One module fixture writes a 64x48 scene with the port
(``torch_helpers.make_scene_port``), a model directory whose PLY the JAX
package writes from seeded parameters, and a sub-scene PLY, then runs
both visualize CLIs on it with a merge, a rotated box, a class filter and
a clip.  The JAX CLI (``--backend jnp``, JAX's ``"auto"`` on the CPU)
compiles the file's one JAX render; the JAX viewer's frames below reuse it
(the same model size, image size and capacity).  Its model gets 512 slots
in place of the default 2^19 (the class is patched for the call): dead
slots render nothing, and a 2^19-slot render takes about half a second on
the CPU.  The port renders with
``"auto"``, K1's plain version on the CPU.  Frames are held within the
render parity tolerance (``torch_helpers.ATOL``); a segment frame's colour
may differ only where JAX's two likeliest classes are within it."""
import argparse
import io
import json
import os
import sys
import threading
import urllib.error
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest
from PIL import Image

from gsplat_tpu.models import gaussians as jgauss
from gsplat_tpu.scripts import visualize as jviz
from gsplat_tpu.viz import render_app as japp
from gsplat_tpu.viz import webgl_viewer as jwv
from gsplat_tpu_torch import renderer as trenderer
from gsplat_tpu_torch.data import ply as tply
from gsplat_tpu_torch.models import gaussians as tgauss
from gsplat_tpu_torch.scripts import visualize as tviz
from gsplat_tpu_torch.tools import serve_asset_viewer as tasset
from gsplat_tpu_torch.viz import render_app as tapp
from gsplat_tpu_torch.viz import webgl_viewer as twv

from torch_helpers import ATOL, make_camera, make_scene_port, model_state_np

W, H = 64, 48
FRAMES = 3
TIMEOUT = 30.0      # every client socket's
JAX_SLOTS = 512     # the JAX CLI's model, in place of its 2^19 slots
CLI_ARGS = ["--mode", "segment", "--bbox", "0.1", "0", "0", "1.4", "1.6",
            "1.5", "--bbox_rot", "10", "20", "5", "--segment_class", "1",
            "--orbit_frames", str(FRAMES)]


def _jax_model(p, alive):
    m = jgauss.GaussianModel(3, num_class=2, capacity=len(alive))
    m.params = jgauss.GaussianParams(**{k: jnp.asarray(p[k]) for k in
                                        tgauss.GaussianParams._fields})
    m.aux = m.aux._replace(alive=jnp.asarray(alive))
    return m


@pytest.fixture(scope="module")
def viz(tmp_path_factory):
    root = tmp_path_factory.mktemp("visualize")
    scene = str(root / "scene")
    make_scene_port(scene, n_gauss=150, n_cams=4, width=W, height=H)
    model = root / "model"
    ply = str(model / "point_cloud" / "iteration_1" / "point_cloud.ply")
    rng = np.random.default_rng(60)
    p = model_state_np(rng, n=200, capacity=200)
    _jax_model(p, p.pop("alive")).save_ply(ply)
    sub = str(root / "sub.ply")
    q = model_state_np(rng, n=40, capacity=40)
    _jax_model(q, q.pop("alive")).save_ply(sub)
    (model / "cfg_args").write_text(str(argparse.Namespace(
        sh_degree=3, source_path=scene, model_path=str(model),
        images="images", resolution=-1, white_background=False,
        data_device="cpu", eval=False, using_depth=False, using_seg=False,
        num_class=2, able_appearance_embedding=False)))
    argv = sys.argv

    class SmallModel(jgauss.GaussianModel):
        def __init__(self, sh_degree, num_class=2, capacity=JAX_SLOTS):
            super().__init__(sh_degree, num_class=num_class,
                             capacity=capacity)

    try:
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jgauss, "GaussianModel", SmallModel)
            jviz.main(["-m", str(model), *CLI_ARGS, "--sub_scene", sub,
                       "--backend", "jnp", "--save_clip",
                       str(root / "j.ply"), "--out", str(root / "jax")])
    finally:
        sys.argv = argv
    frames = tviz.main(["-m", str(model), *CLI_ARGS, "--sub_scene", sub,
                        "--save_clip", str(root / "t.ply"), "--out",
                        str(root / "port")])
    jm = jgauss.GaussianModel(3, num_class=2, capacity=JAX_SLOTS)
    jm.load_ply(ply)
    tm = tgauss.GaussianModel(3, num_class=2, capacity=1, device="cpu")
    tm.load_ply(ply)
    return dict(root=root, ply=ply, jm=jm, tm=tm, frames=frames,
                cam=make_camera(W, H))


def _png(data):
    return np.asarray(Image.open(io.BytesIO(data))).astype(np.int32)


def _assert_segment_frames(got, want, seg):
    """Equal wherever JAX's two likeliest classes differ by more than the
    segment tolerance."""
    top2 = np.sort(seg, axis=0)[-2:]
    tie = (top2[1] - top2[0]) <= ATOL["segment"]
    differ = np.any(got != want, axis=-1)
    assert not np.any(differ & ~tie), int((differ & ~tie).sum())


def test_frame_for_mode_matches_jax(viz):
    """``frame_for_mode`` of the port's ``renderer.render`` (CPU tensors)
    against JAX's of its own, one camera, in all three modes: rgb within
    3e-5, depth within 3e-4, segment as above; the palette is the same
    array."""
    from gsplat_tpu.renderer import render as jrender
    cam = viz["cam"]
    jo = jrender(cam, viz["jm"], backend="jnp")
    to = trenderer.render(cam, viz["tm"], device="cpu")
    np.testing.assert_array_equal(tviz.segment_palette(8),
                                  jviz.segment_palette(8))
    for mode, tol in (("rgb", ATOL["render"]), ("depth", ATOL["depth"])):
        got = tviz.frame_for_mode(to, mode, 2)
        want = jviz.frame_for_mode(jo, mode, 2)
        assert got.shape == want.shape == (H, W, 3) and got.dtype == want.dtype
        np.testing.assert_allclose(got, want, atol=tol, rtol=0, err_msg=mode)
    got = tviz.frame_for_mode(to, "segment", 2)
    want = jviz.frame_for_mode(jo, "segment", 2)
    assert got.shape == want.shape and got.dtype == want.dtype
    _assert_segment_frames(got, want, np.asarray(jo["segment"]))


def _servers(viz, **kw):
    cams = [make_camera(W, H, dist=d) for d in (3.6, 4.4)]
    return (japp.RenderServer(viz["jm"], viz["cam"], backend="jnp",
                              scene_cams=cams, **kw),
            tapp.RenderServer(viz["tm"], viz["cam"], scene_cams=cams, **kw))


def test_render_png_matches_jax(viz):
    """``render_png`` decoded against JAX's after the same keys: rgb,
    depth and segment frames, a keyframe path previewed with the
    projections overlay drawn, and a rejected move's red border; each
    within one level of 255 (the truncation of a float within the
    tolerance) on all but 0.2% of the values, segment frames on all but
    0.2% of the pixels."""
    js, ts = _servers(viz, n_path_frames=4)
    script = [["m"], ["m"], ["m", ",", "d", "l", ",", "p", "space"],
              ["b", "w"]]
    differing = total = borders = 0
    for keys in script:
        for key in keys:
            js.handle_key(key)
            ts.handle_key(key)
        border = js.outbound
        a, b = _png(js.render_png()), _png(ts.render_png())
        assert a.shape == b.shape == (H, W, 3), keys
        if border:
            borders += 1
            red = np.array([255, 38, 38])
            assert (b[:3] == red).all() and (b[:, -3:] == red).all()
        d = np.abs(a - b)
        if js.mode == "segment":
            assert (d.max(axis=-1) > 1).mean() <= 0.002, keys
        else:
            differing += int((d > 1).sum())
        total += d.size
    assert differing <= 0.002 * total, differing
    print(f"render_png: {differing} of {total} rgb and depth values differ "
          "by more than one level")
    assert borders == 1 and ts.overlay and ts._preview_i == js._preview_i == 1


def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=TIMEOUT) as r:
        return r.read(), r.headers.get("Content-Type")


def _serving(srv):
    t = threading.Thread(target=srv.serve, kwargs=dict(port=0), daemon=True)
    t.start()
    assert srv.serving.wait(TIMEOUT)
    return t, srv.httpd.server_address[1]


def test_http_endpoints(viz, capsys):
    """``RenderServer.serve`` on a loopback thread, every client socket
    with a timeout: ``/`` and ``/viewer`` are JAX's pages byte for byte,
    ``/api/splats`` is ``pack_splats``' buffer, ``/api/viewer-info`` JAX's
    ``scene_info``, ``/api/generate-image`` the PNG ``render_png`` makes
    of a twin server after the same key, an unknown path 404; then
    ``tools/serve_asset_viewer`` on the model's PLY answers both APIs."""
    _, ts = _servers(viz)
    _, twin = _servers(viz)
    t, port = _serving(ts)
    try:
        assert _get(port, "/")[0] == japp._CLIENT_HTML.encode()
        assert _get(port, "/viewer")[0] == jwv.VIEWER_HTML.encode()
        body, kind = _get(port, "/api/splats")
        assert kind == "application/octet-stream"
        assert body == twv.pack_splats(viz["tm"])
        pos = twv.unpack_splats(body)[0]
        np.testing.assert_array_equal(
            pos, viz["tm"].params.xyz[viz["tm"].aux.alive].numpy())
        info = json.loads(_get(port, "/api/viewer-info")[0])
        assert info == json.loads(json.dumps(jwv.scene_info(viz["jm"],
                                                            viz["cam"])))
        for key in ("w", "m", "p"):
            png, kind = _get(port, f"/api/generate-image?type={key}")
            twin.handle_key(key)
            assert kind == "image/png" and png == twin.render_png(), key
        with pytest.raises(urllib.error.HTTPError) as e:
            _get(port, "/nothing")
        assert e.value.code == 404
    finally:
        ts.httpd.shutdown()
        t.join(TIMEOUT)
    assert not t.is_alive()

    srv, p0 = tasset.build_server([viz["ply"], "--data_device", "cpu",
                                   "--width", str(W), "--height", str(H),
                                   "--port", "0"])
    assert p0 == 0 and srv.gaussians.num_alive == 200
    t, port = _serving(srv)
    try:
        png, _ = _get(port, "/api/generate-image?type=none")
        assert _png(png).shape == (H, W, 3)
        assert _get(port, "/api/splats")[0] == twv.pack_splats(srv.gaussians)
    finally:
        srv.httpd.shutdown()
        t.join(TIMEOUT)
    assert "render server on http://127.0.0.1:0" in capsys.readouterr().out


def test_visualize_cli_matches_jax(viz):
    """The two CLIs on the same model, sub-scene, box, class filter and
    orbit: the same frame files, each within the segment rule of JAX's
    (``main`` returns the frames, which are the PNGs' source), and the clip
    PLY JAX's byte for byte."""
    root = viz["root"]
    names = sorted(os.listdir(root / "jax"))
    assert names == sorted(os.listdir(root / "port"))
    assert len(names) == FRAMES == len(viz["frames"])
    for name, frame in zip(names, viz["frames"]):
        a = np.asarray(Image.open(root / "jax" / name)).astype(np.int32)
        b = np.asarray(Image.open(root / "port" / name)).astype(np.int32)
        np.testing.assert_array_equal(
            b, (np.clip(frame, 0, 1) * 255).astype(np.uint8))
        assert (np.abs(a - b).max(axis=-1) > 0).mean() <= 0.002, name
    with open(root / "j.ply", "rb") as a, open(root / "t.ply", "rb") as b:
        assert a.read() == b.read()
    assert len(tply.read_ply(str(root / "t.ply"))["x"]) > 0
