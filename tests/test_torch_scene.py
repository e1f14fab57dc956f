"""Scene loading, PLY export and checkpoints of the port on the CPU against
the JAX package, on ``make_synthetic_scene.make_scene``'s NeRFstudio scene
written with the port (``torch_helpers.make_scene_port``: 48x48, 150
gaussians, 6 cameras with depth and segment labels)."""
import os
import random

import jax.numpy as jnp
import numpy as np
import torch

from gsplat_tpu.data import ply as jply
from gsplat_tpu.models import adam as jadam
from gsplat_tpu.models.gaussians import GaussianModel as JModel
from gsplat_tpu.models.gaussians import GaussianParams as JParams
from gsplat_tpu_torch.data import ply as tply
from gsplat_tpu_torch.data.scene import Scene as TScene
from gsplat_tpu_torch.models import gaussians as tgauss
from gsplat_tpu_torch.train.trainer import camera_batch

from torch_helpers import (SCENE_CLASSES, dataset_args, model_pair,  # noqa: F401
                           scene_dir, scenes, tree_np)


def test_scene_matches_jax(scenes, scene_dir):
    js, ts = scenes
    assert ts.cameras_extent == js.cameras_extent
    for split in ("getTrainCameras", "getTestCameras"):
        jc, tc = getattr(js, split)(), getattr(ts, split)()
        assert len(tc) == len(jc) and len(tc) > 0
        for a, b in zip(tc, jc):
            assert (a.image_name, a.uid) == (b.image_name, b.uid)
            for k in ("world_view_transform", "full_proj_transform",
                      "camera_center", "image", "depth", "segment"):
                np.testing.assert_array_equal(getattr(a, k), getattr(b, k),
                                              err_msg=k)
            assert a.depth.shape == (1, 48, 48) and a.depth.max() > 255
            assert a.segment.dtype == np.int32
    # create_from_pcd: the same initial parameters and liveness
    jm, tm = js.gaussians, ts.gaussians
    assert tm.num_alive == jm.num_alive == 150
    assert tm.spatial_lr_scale == jm.spatial_lr_scale
    for k, v in tree_np(jm.params).items():
        np.testing.assert_allclose(getattr(tm.params, k).numpy(), v,
                                   rtol=1e-6, atol=1e-7, err_msg=k)
    for name in ("cameras.json", "input.ply"):
        with open(os.path.join(js.model_path, name), "rb") as a, \
                open(os.path.join(ts.model_path, name), "rb") as b:
            assert a.read() == b.read(), name

    # the bounded-memory mode: pixels decoded per access, one decode per
    # batch, the same batch as the eager camera's
    random.seed(0)
    lazy = TScene(dataset_args(scene_dir, ts.model_path),
                  tgauss.GaussianModel(3, num_class=SCENE_CLASSES, capacity=512,
                                       device="cpu"), lazy_images=True)
    a, b = (camera_batch(s.getTrainCameras()[0], device="cpu")
            for s in (lazy, ts))
    assert not hasattr(ts.getTrainCameras()[0], "_pixels")
    for k in b:
        assert (torch.equal(a[k], b[k]) if torch.is_tensor(b[k])
                else a[k] == b[k]), k


def test_save_ply_matches_jax(tmp_path):
    rng = np.random.default_rng(90)
    jm, tm = model_pair(rng)
    mask = rng.uniform(size=96) < 0.7
    for m in (None, mask):
        jp, tp = str(tmp_path / "j.ply"), str(tmp_path / "t" / "t.ply")
        jm.save_ply(jp, mask=m)
        tm.save_ply(tp, mask=m)
        a, b = jply.read_ply(jp), tply.read_ply(tp)
        assert list(a) == list(b)
        for k in a:
            np.testing.assert_array_equal(b[k], a[k], err_msg=k)
        with open(jp, "rb") as fa, open(tp, "rb") as fb:
            assert fa.read() == fb.read()
    assert len(a["x"]) == int((mask & (np.arange(96) < 80)).sum())


def test_checkpoints_restore_across_packages(tmp_path):
    rng = np.random.default_rng(91)
    jm, tm = model_pair(rng)
    jm.training_setup()
    mu = {k: rng.standard_normal(v.shape).astype(np.float32)
          for k, v in tree_np(jm.params).items()}
    nu = {k: v * v for k, v in mu.items()}
    jm.opt_state = jadam.AdamState(
        jnp.int32(37), JParams(**{k: jnp.asarray(v) for k, v in mu.items()}),
        JParams(**{k: jnp.asarray(v) for k, v in nu.items()}))
    jm.aux = jm.aux._replace(denom=jnp.asarray(
        rng.integers(0, 5, 96).astype(np.float32)))
    jm.spatial_lr_scale = 2.5
    jpath = str(tmp_path / "j.npz")
    jm.save_checkpoint(jpath, 123)

    back = tgauss.GaussianModel(3, num_class=SCENE_CLASSES, capacity=4,
                                device="cpu")
    assert back.restore_checkpoint(jpath) == 123
    assert (back.capacity, back.active_sh_degree, back.spatial_lr_scale,
            back.num_class) == (96, 2, 2.5, SCENE_CLASSES)
    cap = back.capture()["arrays"]
    z = np.load(jpath, allow_pickle=True)
    assert set(cap) == {k for k in z.files if not k.startswith("__")}
    for k, v in cap.items():
        assert v.dtype == z[k].dtype, k
        np.testing.assert_array_equal(v, z[k], err_msg=k)
    assert int(back.opt_state.count) == 37

    # and the other way: the port's checkpoint restores in the JAX model
    tpath = str(tmp_path / "t" / "t.npz")
    back.save_checkpoint(tpath, 124)
    jback = JModel(3, num_class=SCENE_CLASSES, capacity=4)
    assert jback.restore_checkpoint(tpath) == 124
    for k, v in jback.capture()["arrays"].items():
        np.testing.assert_array_equal(np.asarray(v), cap[k], err_msg=k)
    assert jback.capture()["meta"] == back.capture()["meta"]


def _png(path):
    from PIL import Image
    with Image.open(path) as im:
        return np.asarray(im, np.int64)


def test_make_scene_port_matches_jax_scene(tmp_path):
    """``make_scene_port`` writes ``make_synthetic_scene.make_scene``'s files
    (held at 8 gaussians, 1 camera, 16x12): images and segment labels
    equal, 16-bit depth within 1 (the two oracles' float sums differ in
    the last bit), transforms.json within float rounding, and the
    reference's own points3d.ply byte for byte, which the port's reader
    loads as the JAX reader does."""
    import json

    from gsplat_tpu.data.readers import fetch_ply as jfetch
    from gsplat_tpu_torch.data.readers import fetch_ply as tfetch
    from make_synthetic_scene import make_scene
    from torch_helpers import make_scene_port

    kw = dict(n_gauss=8, n_cams=1, width=16, height=12,
              num_class=SCENE_CLASSES)
    ref, port = str(tmp_path / "ref"), str(tmp_path / "port")
    make_scene(ref, with_depth=True, **kw)
    make_scene_port(port, **kw)
    for sub, tol in (("images", 0), ("segment", 0), ("depth", 1)):
        names = sorted(os.listdir(os.path.join(ref, sub)))
        assert names == sorted(os.listdir(os.path.join(port, sub))) != []
        for n in names:
            a, b = (_png(os.path.join(d, sub, n)) for d in (ref, port))
            assert a.shape == b.shape and np.abs(a - b).max() <= tol, (sub, n)
    ja, jb = ({}, {})
    for d, into in ((ref, ja), (port, jb)):
        with open(os.path.join(d, "transforms.json")) as f:
            into.update(json.load(f))
    assert [f["file_path"] for f in ja["frames"]] == [
        f["file_path"] for f in jb["frames"]]
    np.testing.assert_allclose(
        [f["transform_matrix"] for f in jb["frames"]],
        [f["transform_matrix"] for f in ja["frames"]], rtol=0, atol=1e-12)
    for k in ("fl_x", "fl_y", "w", "h", "cx", "cy"):
        np.testing.assert_allclose(jb[k], ja[k], rtol=1e-12, err_msg=k)
    ply = "points3d.ply"
    with open(os.path.join(ref, ply), "rb") as fa, \
            open(os.path.join(port, ply), "rb") as fb:
        assert fa.read() == fb.read()
    pa, pb = jfetch(os.path.join(ref, ply)), tfetch(os.path.join(ref, ply))
    for a, b in zip(pa, pb):
        np.testing.assert_array_equal(np.asarray(b), np.asarray(a))
