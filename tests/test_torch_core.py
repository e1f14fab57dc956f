"""Port core parity: transforms, SH, cameras, PLY reading and the model
loaders against the JAX package; import hygiene and device defaults."""
import os
import re
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gsplat_tpu.core import sh as jsh
from gsplat_tpu.core import transforms as jT
from gsplat_tpu.core.cameras import Camera as JCamera
from gsplat_tpu.data import ply as jply
from gsplat_tpu.models import gaussians as jgauss
from gsplat_tpu_torch.core import sh as tsh
from gsplat_tpu_torch.core import transforms as tT
from gsplat_tpu_torch.core.cameras import Camera as TCamera
from gsplat_tpu_torch.data import ply as tply
from gsplat_tpu_torch.models import gaussians as tgauss

import torch_helpers  # noqa: F401  (thread count)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "gsplat_tpu_torch")


def _close(a, b, tol=1e-5):
    np.testing.assert_allclose(np.asarray(a), b.numpy(), rtol=tol, atol=tol)


def test_transforms_match_jax(rng):
    q = rng.standard_normal((50, 4)).astype(np.float32)
    s = np.exp(rng.standard_normal((50, 3)).astype(np.float32) * 0.5)
    _close(jT.quat_to_rotmat(jnp.asarray(q)), tT.quat_to_rotmat(torch.from_numpy(q)))
    _close(jT.covariance_from_scaling_rotation(jnp.asarray(s), 1.3, jnp.asarray(q)),
           tT.covariance_from_scaling_rotation(torch.from_numpy(s), 1.3,
                                               torch.from_numpy(q)))
    x = rng.uniform(0.05, 0.95, 40).astype(np.float32)
    for jf, tf in ((jT.opacity_activation, tT.opacity_activation),
                   (jT.scaling_activation, tT.scaling_activation),
                   (jT.inverse_sigmoid, tT.inverse_sigmoid),
                   (jT.normalize, tT.normalize)):
        _close(jf(jnp.asarray(x)), tf(torch.from_numpy(x)), 1e-5)


@pytest.mark.parametrize("deg", [0, 1, 2, 3, 4])
def test_sh_matches_jax(rng, deg):
    K = (deg + 1) ** 2
    sh = (rng.standard_normal((30, K, 3)) * 0.4).astype(np.float32)
    means = rng.standard_normal((30, 3)).astype(np.float32)
    campos = np.array([0.1, -0.3, 4.0], np.float32)
    dirs = means / np.linalg.norm(means, axis=1, keepdims=True)
    _close(jsh.eval_sh(deg, jnp.asarray(sh), jnp.asarray(dirs)),
           tsh.eval_sh(deg, torch.from_numpy(sh), torch.from_numpy(dirs)), 1e-5)
    _close(jsh.sh_to_rgb(deg, jnp.asarray(sh), jnp.asarray(means), jnp.asarray(campos)),
           tsh.sh_to_rgb(deg, torch.from_numpy(sh), torch.from_numpy(means),
                         torch.from_numpy(campos)), 1e-5)
    rgb = rng.uniform(size=(30, 3)).astype(np.float32)
    _close(jsh.rgb_to_sh(jnp.asarray(rgb)), tsh.rgb_to_sh(torch.from_numpy(rgb)))


def test_camera_copy_matches_jax():
    kw = dict(colmap_id=0, R=np.eye(3), T=np.array([0.2, 0.6, 4.2]),
              FoVx=1.08, FoVy=0.66, image=np.zeros((3, 36, 64), np.float32),
              image_name="c", uid=0)
    a, b = JCamera(**kw), TCamera(**kw)
    for f in ("world_view_transform", "full_proj_transform", "camera_center"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    assert (a.tan_fovx, a.tan_fovy) == (b.tan_fovx, b.tan_fovy)


def _random_model_ply(rng, path, n=40):
    m = jgauss.GaussianModel(3, num_class=2, capacity=64)
    m.create_from_pcd(rng.standard_normal((n, 3)).astype(np.float32),
                      rng.uniform(size=(n, 3)).astype(np.float32), 1.0)
    p = m.params
    m.params = p._replace(
        features_rest=jnp.asarray(rng.standard_normal(p.features_rest.shape),
                                  jnp.float32),
        rotation=jnp.asarray(rng.standard_normal(p.rotation.shape), jnp.float32),
        segment=jnp.asarray(rng.standard_normal(p.segment.shape), jnp.float32))
    m.save_ply(path)
    return m


def test_read_ply_and_load_ply_match_jax(rng, tmp_path):
    path = str(tmp_path / "m.ply")
    _random_model_ply(rng, path)
    a, b = jply.read_ply(path), tply.read_ply(path)
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])

    jm = jgauss.GaussianModel(3, num_class=2, capacity=16)
    jm.load_ply(path)
    tm = tgauss.GaussianModel(3, num_class=2, capacity=16, device="cpu")
    tm.load_ply(path)
    assert (tm.capacity, tm.num_class, tm.active_sh_degree) == \
        (jm.capacity, jm.num_class, jm.active_sh_degree)
    assert tm.num_alive == jm.num_alive
    for k, v in jm.params._asdict().items():
        np.testing.assert_array_equal(np.asarray(v),
                                      getattr(tm.params, k).numpy(), err_msg=k)


def test_params_from_numpy_and_npz(rng, tmp_path):
    path = str(tmp_path / "m.ply")
    jm = _random_model_ply(rng, path)
    d = {k: np.asarray(v) for k, v in jm.params._asdict().items()}
    d["alive"] = np.asarray(jm.aux.alive)
    tm = tgauss.params_from_numpy(d, device="cpu")
    assert (tm.capacity, tm.num_class, tm.max_sh_degree) == (64, 2, 3)
    np.testing.assert_array_equal(tm.aux.alive.numpy(), d["alive"])
    for k in tgauss.GaussianParams._fields:
        np.testing.assert_array_equal(getattr(tm.params, k).numpy(), d[k])
    assert tgauss.params_from_numpy(d, "cpu", num_class=0).num_class == 0

    # the bench asset's layout: raw fields, SH bands in fp16, no segment
    npz = str(tmp_path / "a.npz")
    np.savez(npz, xyz=d["xyz"], scaling=d["scaling"], rotation=d["rotation"],
             opacity=d["opacity"], features_dc=d["features_dc"].astype(np.float16),
             features_rest=d["features_rest"].astype(np.float16))
    am = tgauss.GaussianModel(3, num_class=2, device="cpu")
    am.load_npz(npz)
    assert am.capacity == 64 and am.num_alive == 64
    np.testing.assert_array_equal(
        am.params.features_rest.numpy(),
        d["features_rest"].astype(np.float16).astype(np.float32))
    assert am.params.segment.shape == (64, 2)


def test_import_is_jax_free():
    code = ("import sys, gsplat_tpu_torch, gsplat_tpu_torch.renderer, "
            "gsplat_tpu_torch.ops.composite_ref, gsplat_tpu_torch._kernels, "
            "gsplat_tpu_torch.train.trainer, gsplat_tpu_torch.train.schedules, "
            "gsplat_tpu_torch.models.densify, gsplat_tpu_torch.config, "
            "gsplat_tpu_torch.data.ply, gsplat_tpu_torch.data.colmap, "
            "gsplat_tpu_torch.data.readers, gsplat_tpu_torch.data.scene, "
            "gsplat_tpu_torch.scripts.train, gsplat_tpu_torch.tools, "
            "gsplat_tpu_torch.scripts.render, gsplat_tpu_torch.scripts.metrics, "
            "gsplat_tpu_torch.scripts.full_eval, "
            "gsplat_tpu_torch.scripts.train_segment, "
            "gsplat_tpu_torch.utils.general, gsplat_tpu_torch.viz.lpips, "
            "gsplat_tpu_torch.viz.video, gsplat_tpu_torch.viz.camera_trajectory, "
            "gsplat_tpu_torch.viz.network_gui, "
            "gsplat_tpu_torch.viz.webgl_viewer, gsplat_tpu_torch.viz.editor, "
            "gsplat_tpu_torch.viz.render_app, "
            "gsplat_tpu_torch.scripts.visualize, "
            "gsplat_tpu_torch.tools.serve_asset_viewer, "
            "gsplat_tpu_torch.ops.composite_tiled, "
            "gsplat_tpu_torch.models.appearance, gsplat_tpu_torch.models.pose, "
            "gsplat_tpu_torch.parallel, gsplat_tpu_torch.parallel.multihost, "
            "gsplat_tpu_torch.parallel.data_parallel, "
            "gsplat_tpu_torch.parallel.tile_parallel, "
            "gsplat_tpu_torch.parallel.mesh2d, "
            "gsplat_tpu_torch.tools.probes, gsplat_tpu_torch.tools.timing, "
            "gsplat_tpu_torch.tools.workload, "
            "gsplat_tpu_torch.tools.bench_fwd_attrib, "
            "gsplat_tpu_torch.tools.bench_bwd_attrib, "
            "gsplat_tpu_torch.tools.bench_kernels, "
            "gsplat_tpu_torch.tools.bench_dma_overhead, "
            "gsplat_tpu_torch.tools.bench_inkernel_gather, "
            "gsplat_tpu_torch.tools.bench_vpu_dtype, "
            "gsplat_tpu_torch.tools.k2_trees, "
            "gsplat_tpu_torch.tools.sass_diff, "
            "gsplat_tpu_torch.depth, gsplat_tpu_torch.depth.dpt, "
            "gsplat_tpu_torch.depth.weights, "
            "gsplat_tpu_torch.depth.transforms, "
            "gsplat_tpu_torch.scripts.run_monodepth, "
            "gsplat_tpu_torch.scripts.run_segmentation, "
            "gsplat_tpu_torch.scripts.convert, "
            "gsplat_tpu_torch.data.converters, gsplat_tpu_torch.data.native\n"
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
            " or m == 'gsplat_tpu' or m.startswith('gsplat_tpu.')]\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    subprocess.run([sys.executable, "-c", code], check=True, env=env,
                   cwd=REPO, timeout=120)


def test_no_port_file_imports_the_jax_package():
    pat = re.compile(r"^\s*(from|import)\s+(jax|gsplat_tpu)(\.|\s|$)", re.M)
    files = [os.path.join(d, f) for d, _, fs in os.walk(PORT)
             for f in fs if f.endswith(".py")]
    files.append(os.path.join(REPO, "chip_smoke.py"))
    assert len(files) > 20
    for f in files:
        with open(f) as fh:
            hits = pat.findall(fh.read())
        assert not hits, f"{f} imports {hits}"


def test_device_defaults_to_cuda():
    from gsplat_tpu_torch.device import resolve_device
    from gsplat_tpu_torch.ops.rasterize import RasterizeConfig, rasterize
    from gsplat_tpu_torch.renderer import render

    if torch.cuda.is_available():
        assert resolve_device().type == "cuda"
        assert tgauss.GaussianModel(3, capacity=4).params.xyz.is_cuda
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        tgauss.GaussianModel(3, capacity=4)
    with pytest.raises(RuntimeError, match="CUDA"):
        tgauss.empty_params(4, 3, 0)
    x = torch.zeros(4, 3)
    with pytest.raises(RuntimeError, match="CUDA"):
        rasterize(RasterizeConfig(width=32, height=32), x, x,
                  torch.zeros(4, 4), torch.zeros(4), None, np.eye(4),
                  np.eye(4), np.zeros(3), 0.5, 0.5, np.zeros(3))
    cpu_model = tgauss.GaussianModel(3, capacity=4, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        # a CPU model is not quietly rendered on the CPU by default
        render(torch_helpers.make_camera(32, 32), cpu_model)
    # the training slice's entry points
    from gsplat_tpu_torch.config import OptimizationParams
    from gsplat_tpu_torch.train import trainer
    with pytest.raises(RuntimeError, match="CUDA"):
        tgauss.empty_aux(4)
    with pytest.raises(RuntimeError, match="CUDA"):
        tgauss.aux_from_numpy({k: np.zeros(4) for k in
                               tgauss.GaussianAux._fields})
    with pytest.raises(RuntimeError, match="CUDA"):
        trainer.camera_batch(torch_helpers.make_camera(32, 32))
    with pytest.raises(RuntimeError, match="CUDA"):
        trainer.make_train_step(RasterizeConfig(width=32, height=32),
                                OptimizationParams(), 3, None, False,
                                np.zeros(3, np.float32))
    # the kernel probes' entry modules measure, so they need the card
    from gsplat_tpu_torch.tools import (bench_bwd_attrib, bench_dma_overhead,
                                        bench_fwd_attrib,
                                        bench_inkernel_gather, bench_kernels,
                                        bench_vpu_dtype, timing)
    for mod in (bench_fwd_attrib, bench_bwd_attrib, bench_kernels,
                bench_dma_overhead, bench_inkernel_gather, bench_vpu_dtype):
        with pytest.raises(RuntimeError, match="CUDA"):
            mod.main()
    with pytest.raises(RuntimeError, match="CUDA"):
        timing.cuda_device("cpu")
    # DPT and its CLIs: the card unless the CPU is asked for
    from gsplat_tpu_torch.depth import dpt, weights
    from gsplat_tpu_torch.scripts import run_monodepth, run_segmentation
    cfg = dpt.DPTConfig(features=32, reassemble=(16, 24, 32, 40),
                        hooks=(0, 1, 2, 3), vit_dim=48, vit_depth=4,
                        vit_heads=4, vit_mlp=64)
    gen = torch.Generator().manual_seed(0)
    with pytest.raises(RuntimeError, match="CUDA"):
        dpt.init_params(cfg, gen, grid=4)
    model = dpt.init_params(cfg, gen, grid=4, device="cpu")
    assert next(model.parameters()).device.type == "cpu"
    with pytest.raises(RuntimeError, match="CUDA"):
        weights.load_torch("no_such.pt", cfg)
    for cli in (run_monodepth, run_segmentation):
        with pytest.raises(RuntimeError, match="CUDA"):
            cli.main(["-i", "no_such_dir"])


def test_kernel_wrappers_validate_inputs():
    from gsplat_tpu_torch.ops.binning import expand
    from gsplat_tpu_torch.ops.composite_cuda import (composite_backward,
                                                     composite_forward)
    off = torch.zeros(3, dtype=torch.int64)
    with pytest.raises(ValueError, match="int32"):
        expand(off, off, off, 128, 2, 1, 1)
    i32 = torch.zeros(1, dtype=torch.int32)
    with pytest.raises(ValueError, match="float32"):
        composite_forward(torch.zeros((4, 9), dtype=torch.float64), i32, i32,
                          i32, 1)
    with pytest.raises(ValueError, match="contiguous"):
        composite_forward(torch.zeros((9, 4)).t(), i32, i32, i32, 1)
    table = torch.zeros((4, 9))
    from gsplat_tpu_torch.ops.composite_cuda import TILE_PIX
    packed = torch.zeros((1, 5, TILE_PIX))
    with pytest.raises(ValueError, match="Cg"):
        composite_backward(table, i32, i32, i32, 1, packed, packed, 4)
    with pytest.raises(ValueError, match="d_packed must be"):
        composite_backward(table, i32, i32, i32, 1, packed, packed[:, :4], 3)
    # K1's and K2's forms: a packed table is [P, 6 + ceil(Cg/2)], and the
    # ones channel is a form of the packed table only
    from gsplat_tpu_torch.ops.composite_cuda import Form
    with pytest.raises(ValueError, match="packed table"):
        composite_forward(table, i32, i32, i32, 1, Form(feat_packed=True), 3)
    with pytest.raises(ValueError, match="Cg >= 1"):
        composite_forward(table, i32, i32, i32, 1, Form(feat_packed=True))
    with pytest.raises(ValueError, match="with_ones"):
        composite_forward(table, i32, i32, i32, 1, Form(with_ones=True))
    with pytest.raises(ValueError, match="packed table"):
        composite_backward(table, i32, i32, i32, 1, packed, packed, 4,
                           Form(mxu_power=True, feat_packed=True))
    # the kernel probes share these checks and add their own
    from gsplat_tpu_torch.tools import probes
    with pytest.raises(ValueError, match="unknown variant"):
        probes.probe_forward("no_such", table, i32, i32, i32, 1)
    with pytest.raises(ValueError, match="d_packed must be"):
        probes.probe_backward("base", table, i32, i32, i32, 1, packed,
                              packed[:, :4], 3)
    with pytest.raises(ValueError, match="limits"):
        probes.probe_load("load_only", table, i32, i32, i32, 1,
                          limits=torch.zeros(2, dtype=torch.int32))
    with pytest.raises(ValueError, match="takes ids"):
        probes.probe_gather("block_copy", table, i32)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        probes.probe_dtype(torch.zeros(4, dtype=torch.float64))
