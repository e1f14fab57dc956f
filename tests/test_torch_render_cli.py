"""The render and evaluation command lines of the port on the CPU, against
the JAX package's: ``scripts/render.py`` (with ``viz/camera_trajectory.py``
and ``viz/video.py``), ``scripts/metrics.py``, ``scripts/full_eval.py``,
``scripts/train_segment.py`` and ``utils/general.py``.

One module fixture writes ``make_synthetic_scene.make_scene``'s NeRFstudio
scene with the port (``torch_helpers.make_scene_port``: 64x64, 200
gaussians, 6 cameras, one of them the test split) and a model directory
holding ``cfg_args`` and one PLY at iteration 1, written by the JAX
package's ``save_ply`` from seeded parameters, with no training.  Two
copies of it are rendered, by the JAX CLI (``--backend jnp``, compiled
once here) and by the port's (``--data_device cpu``)."""
import argparse
import itertools
import os
import random
import shutil
import sys

import numpy as np
import pytest
import torch
from PIL import Image

import jax.numpy as jnp
from gsplat_tpu.models import gaussians as jgauss
from gsplat_tpu.scripts import full_eval as jfull
from gsplat_tpu.scripts import metrics as jmetrics
from gsplat_tpu.scripts import render as jrender
from gsplat_tpu.scripts import train_segment as jseg
from gsplat_tpu.utils import general as jgeneral
from gsplat_tpu.viz import camera_trajectory as jtraj
from gsplat_tpu.viz import video as jvideo
from gsplat_tpu_torch.scripts import full_eval as tfull
from gsplat_tpu_torch.scripts import metrics as tmetrics
from gsplat_tpu_torch.scripts import render as trender
from gsplat_tpu_torch.scripts import train_segment as tseg
from gsplat_tpu_torch.utils import general as tgeneral
from gsplat_tpu_torch.viz import camera_trajectory as ttraj
from gsplat_tpu_torch.viz import video as tvideo

from torch_helpers import ATOL, SCENE_CLASSES, make_scene_port, model_state_np

SIZE = 64
PATH_FRAMES = 3


def _png(path):
    return np.asarray(Image.open(path)).astype(np.int32)


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


@pytest.fixture(scope="module")
def rendered(tmp_path_factory):
    """(JAX-rendered copy, port-rendered copy, scene dir)."""
    root = tmp_path_factory.mktemp("render_cli")
    scene = str(root / "scene")
    make_scene_port(scene, n_gauss=200, n_cams=6, width=SIZE, height=SIZE)
    model = root / "model"
    p = model_state_np(np.random.default_rng(4), n=200, capacity=256,
                       num_class=SCENE_CLASSES)
    alive = p.pop("alive")
    m = jgauss.GaussianModel(3, num_class=SCENE_CLASSES, capacity=256)
    m.params = jgauss.GaussianParams(**{k: jnp.asarray(v)
                                        for k, v in p.items()})
    m.aux = m.aux._replace(alive=jnp.asarray(alive))
    m.save_ply(str(model / "point_cloud" / "iteration_1" / "point_cloud.ply"))
    (model / "cfg_args").write_text(str(argparse.Namespace(
        sh_degree=3, source_path=scene, model_path=str(model),
        images="images", resolution=-1, white_background=False,
        data_device="cpu", eval=True, using_depth=False, using_seg=False,
        num_class=SCENE_CLASSES, able_appearance_embedding=False)))
    d1, d2 = str(root / "jax"), str(root / "port")
    shutil.copytree(model, d1)
    shutil.copytree(model, d2)
    argv = sys.argv
    try:
        jrender.main(["-m", d1, "--backend", "jnp", "--inter_test_frames",
                      str(PATH_FRAMES)])
    finally:
        sys.argv = argv
    trender.main(["-m", d2, "--data_device", "cpu", "--inter_test_frames",
                  str(PATH_FRAMES)])
    return d1, d2, scene


def test_render_cli_matches_jax(rendered, capsys, monkeypatch):
    """(a) The same files; gt PNGs bit-equal; every render, depth and path
    PNG within one level of 255 of JAX's (truncation turns a float
    difference of about 1e-6 at a level boundary into one level).  Then
    the depth-pane set video from both sets of PNGs: its frames within one
    level, and the encoder named; with a cv2 writer that raises, the frame
    directory."""
    d1, d2, _ = rendered
    files = _files(d2)
    assert files == _files(d1)
    pngs = [f for f in files if f.endswith(".png")]
    assert len([f for f in pngs if "ours_1" + os.sep + "renders" in f]) == 6
    assert len([f for f in pngs if f.startswith("path_renders")]) == \
        PATH_FRAMES
    differing = total = 0
    for f in pngs:
        a, b = _png(os.path.join(d1, f)), _png(os.path.join(d2, f))
        assert a.shape == b.shape, f
        if os.sep + "gt" + os.sep in f:
            np.testing.assert_array_equal(b, a, err_msg=f)
            continue
        d = np.abs(a - b)
        assert d.max() <= 1, f
        differing += int((d > 0).sum())
        total += d.size
    print(f"render CLI: {differing} of {total} values differ by one level "
          f"({differing / total:.2e})")

    jvid = jvideo.save_vidio(d1, "train", 1)
    capsys.readouterr()
    tvid = tvideo.save_vidio(d2, "train", 1)
    said = capsys.readouterr().out
    assert "[video] encoder " in said and os.path.exists(tvid)
    assert os.path.basename(tvid) == os.path.basename(jvid)
    fdir = "train-step_1-test_frames"
    frames = sorted(os.listdir(os.path.join(d2, fdir)))
    assert frames == sorted(os.listdir(os.path.join(d1, fdir)))
    assert len(frames) == 5
    for f in frames:
        a = _png(os.path.join(d1, fdir, f))
        b = _png(os.path.join(d2, fdir, f))
        assert a.shape == (SIZE, 2 * SIZE, 3)
        assert np.abs(a - b).max() <= 1, f

    # a cv2 writer that raises: the port falls back as the JAX package does
    # (ffmpeg, then the frame directory; no ffmpeg here)
    cv2 = pytest.importorskip("cv2")

    def broken_writer(*a, **k):
        raise RuntimeError("no mp4v encoder")

    monkeypatch.setattr(cv2, "VideoWriter", broken_writer)
    monkeypatch.setattr(tvideo.shutil, "which", lambda name: None)
    got = tvideo.save_vidio(d2, "train", 1)
    said = capsys.readouterr().out
    assert got == os.path.join(d2, fdir)
    assert "cv2 writer unavailable (no mp4v encoder)" in said
    assert "[video] encoder none" in said


def test_trajectory_and_general_match_jax(rendered, tmp_path, monkeypatch):
    """(b) ``inter_poses`` (and its saved file through ``load_poses``)
    bit-equal to JAX's on seeded keyframes; ``render_path_frames`` on them
    within the render parity tests' image tolerance of JAX's; the host
    utilities of ``utils/general.py`` against JAX's."""
    from scipy.spatial.transform import Rotation

    from gsplat_tpu.data.scene import Scene as JScene
    from gsplat_tpu_torch.data.scene import Scene as TScene
    from gsplat_tpu_torch.models.gaussians import GaussianModel

    rng = np.random.default_rng(9)
    keys = []
    for i in range(3):
        M = np.eye(4)
        M[:3, :3] = Rotation.random(random_state=i).as_matrix()
        M[:3, 3] = rng.standard_normal(3)
        keys.append(M.T)
    for n in (1, 7):
        jp = jtraj.inter_poses(keys[:max(1, n // 3)], n,
                               save_path=str(tmp_path / f"j{n}.npy"))
        tp = ttraj.inter_poses(keys[:max(1, n // 3)], n,
                               save_path=str(tmp_path / f"t{n}.npy"))
        np.testing.assert_array_equal(tp, jp)
        np.testing.assert_array_equal(
            ttraj.load_poses(str(tmp_path / f"t{n}.npy")),
            jtraj.load_poses(str(tmp_path / f"j{n}.npy")))

    d1, d2, _ = rendered
    wv = keys[1]
    for f in ("translate", "orbit", "cam_frustum_points"):
        args = {"translate": (wv, 0.1, -0.2, 0.3), "orbit": (wv, 20.0, -5.0),
                "cam_frustum_points": (wv,)}[f]
        np.testing.assert_array_equal(getattr(ttraj, f)(*args),
                                      getattr(jtraj, f)(*args))

    # the path through the port's and JAX's own scene loading
    margs = lambda d: argparse.Namespace(  # noqa: E731
        sh_degree=3, source_path=rendered[2], model_path=d, images="images",
        resolution=-1, white_background=False, eval=True, using_depth=False,
        using_seg=False)
    jm = jgauss.GaussianModel(3, num_class=SCENE_CLASSES)
    js = JScene(margs(d1), jm, load_iteration=-1, shuffle=False)
    tm = GaussianModel(3, num_class=SCENE_CLASSES, capacity=1, device="cpu")
    ts = TScene(margs(d2), tm, load_iteration=-1, shuffle=False)
    assert ts.loaded_iter == js.loaded_iter == 1
    path = ttraj.inter_poses([c.world_view_transform
                              for c in ts.getTestCameras()]
                             + [ts.getTrainCameras()[2].world_view_transform],
                             PATH_FRAMES)
    jf = jrender.render_path_frames(path, js.getTrainCameras()[0], jm,
                                    jnp.zeros(3), "jnp")
    tf = trender.render_path_frames(path, ts.getTrainCameras()[0], tm,
                                    np.zeros(3))
    assert len(tf) == len(jf) == PATH_FRAMES
    for a, b in zip(tf, jf):
        assert a.shape == (3, SIZE, SIZE)
        np.testing.assert_allclose(a, np.asarray(b), atol=ATOL["render"],
                                   rtol=0)

    pc = tmp_path / "point_cloud"
    for it in (1, 30, 7):
        os.makedirs(pc / f"iteration_{it}")
    assert tgeneral.searchForMaxIteration(str(pc)) == \
        jgeneral.searchForMaxIteration(str(pc)) == 30
    tgeneral.mkdir_p(str(tmp_path / "a" / "b"))
    assert (tmp_path / "a" / "b").is_dir()
    draws = []
    for safe_state in (jgeneral.safe_state, tgeneral.safe_state):
        out = []
        monkeypatch.setattr(sys, "stdout", type(
            "Buf", (), {"write": lambda self, x: out.append(x),
                        "flush": lambda self: None})())
        safe_state(seed=3)
        print("line")
        draws.append((random.random(), float(np.random.rand())))
        monkeypatch.undo()
        assert out[0] == "line" and out[1].startswith(" [")
        assert out[1].endswith("]\n")
    assert draws[0] == draws[1]
    assert float(torch.rand(1)) == float(torch.rand(
        1, generator=torch.Generator().manual_seed(3)))


def test_metrics_match_jax(rendered):
    """(c) The port's ``evaluate`` against JAX's on the same directory: per
    view SSIM within 1e-5 and PSNR within 1e-4 dB, and the same keys in
    ``results.json`` and ``per_view.json``."""
    import json

    d1 = rendered[0]

    def written():
        return [json.load(open(os.path.join(d1, f)))
                for f in ("results.json", "per_view.json")]

    want = jmetrics.evaluate([d1])[d1]
    jres, jview = written()
    got = tmetrics.evaluate([d1], device="cpu")[d1]
    tres, tview = written()
    assert set(got) == set(want) == set(jres) == set(tres) == {"ours_1"}
    assert set(got["ours_1"]) == set(want["ours_1"]) == {"SSIM", "PSNR"}
    assert set(tview["ours_1"]) == set(jview["ours_1"]) == {"SSIM", "PSNR"}
    names = sorted(jview["ours_1"]["PSNR"])
    assert sorted(tview["ours_1"]["PSNR"]) == names == ["00000.png"]
    for n in names:
        assert abs(tview["ours_1"]["SSIM"][n]
                   - jview["ours_1"]["SSIM"][n]) <= 1e-5
        assert abs(tview["ours_1"]["PSNR"][n]
                   - jview["ours_1"]["PSNR"][n]) <= 1e-4
    assert 0 <= got["ours_1"]["SSIM"] <= 1 and np.isfinite(
        got["ours_1"]["PSNR"])


def test_full_eval_train_segment_and_refusals(rendered, monkeypatch):
    """(d) ``full_eval``'s commands, with ``run`` recording them, equal
    JAX's with the package swapped under every combination of the
    ``--skip_*`` flags; ``train_segment`` hands the training CLI JAX's arguments; the
    render CLI refuses ``--tile_parallel 2`` (item 7) and another
    backend, and renders with the pipe's debug flags, which reach
    ``renderer.render``, within one level of JAX's default render."""
    from gsplat_tpu.scripts import train as jtrain
    from gsplat_tpu_torch.scripts import train as ttrain

    roots = ["-m360", "/data/m360", "-tat", "/data/tat", "-db", "/data/db",
             "--output_path", "/out", "--iterations", "100"]
    for flags in itertools.product(*[((), (f,)) for f in (
            "--skip_training", "--skip_rendering", "--skip_metrics")]):
        cmds = {}
        for name, mod in (("jax", jfull), ("port", tfull)):
            cmds[name] = []
            monkeypatch.setattr(mod, "run", cmds[name].append)
            mod.main(roots + [f for fl in flags for f in fl])
        swapped = [[a.replace("gsplat_tpu.", "gsplat_tpu_torch.")
                    for a in c] for c in cmds["jax"]]
        assert cmds["port"] == swapped, flags
        assert len(cmds["port"]) == (
            (0 if "--skip_training" in sum(flags, ()) else 13)
            + (0 if "--skip_rendering" in sum(flags, ()) else 26)
            + (0 if "--skip_metrics" in sum(flags, ()) else 1))

    for argv in ([], ["-s", "x", "--using_seg"],
                 ["--test_iterations", "5"], ["--save_iterations", "9"]):
        seen = {}
        monkeypatch.setattr(jtrain, "main", lambda a: seen.update(jax=a))
        monkeypatch.setattr(ttrain, "main", lambda a: seen.update(port=a))
        jseg.main(list(argv))
        tseg.main(list(argv))
        assert seen["port"] == seen["jax"], argv
        assert "--using_seg" in seen["port"]

    d1, d2, _ = rendered
    trender.main(["-m", d2, "--data_device", "cpu", "--skip_train",
                  "--convert_SHs_python", "--compute_cov3D_python"])
    f = os.path.join("test", "ours_1", "renders", "00000.png")
    assert np.abs(_png(os.path.join(d2, f))
                  - _png(os.path.join(d1, f))).max() <= 1
    with pytest.raises(NotImplementedError, match="item 7"):
        trender.main(["-m", d2, "--data_device", "cpu", "--tile_parallel",
                      "2", "--skip_test"])
    with pytest.raises(ValueError, match="backend"):
        trender.main(["-m", d2, "--data_device", "cpu", "--backend", "jnp",
                      "--skip_test"])
