"""Shared inputs for the parity tests of the PyTorch port (tests/test_torch_*).

Inputs are made once in numpy from a seeded generator and handed to both
packages; JAX stays on the CPU and the port runs with ``device="cpu"``,
where every kernel wrapper uses its plain PyTorch version.
"""
import argparse
import math
import random

import numpy as np
import pytest
import torch

# xdist runs several workers on the machine and the test sizes are tiny:
# one intra-op thread per worker
torch.set_num_threads(1)

GAUSS_KEYS = ("means3d", "scales", "rotations", "opacities", "shs")


def make_gaussians_np(rng, n=200, num_class=0, spread=1.2, sh_degree=3):
    """Random gaussian cloud near the origin (tests/helpers.make_gaussians'
    distributions), as numpy float32 arrays."""
    K = (sh_degree + 1) ** 2
    g = dict(
        means3d=rng.standard_normal((n, 3)).astype(np.float32) * spread,
        scales=np.exp(rng.standard_normal((n, 3)).astype(np.float32) * 0.5
                      - 2.5),
        rotations=rng.standard_normal((n, 4)).astype(np.float32),
        opacities=rng.uniform(0.2, 0.95, n).astype(np.float32),
        shs=(rng.standard_normal((n, K, 3)) * 0.3).astype(np.float32),
    )
    if num_class:
        g["segments"] = rng.uniform(0.05, 0.95, (n, num_class)).astype(
            np.float32)
    return g


def make_camera(width=64, height=64, fov_deg=60.0, dist=4.0):
    from gsplat_tpu_torch.core.cameras import Camera
    fovx = math.radians(fov_deg)
    fovy = 2 * math.atan(math.tan(fovx / 2) * height / width)
    return Camera(colmap_id=0, R=np.eye(3), T=np.array([0.0, 0.0, dist]),
                  FoVx=fovx, FoVy=fovy,
                  image=np.zeros((3, height, width), np.float32),
                  image_name="test", uid=0)


def cam_np(cam):
    return dict(viewmatrix=cam.world_view_transform,
                projmatrix=cam.full_proj_transform,
                campos=cam.camera_center,
                tan_fovx=cam.tan_fovx, tan_fovy=cam.tan_fovy)


def to_jax(d):
    import jax.numpy as jnp
    return {k: jnp.asarray(v) if isinstance(v, np.ndarray) else v
            for k, v in d.items()}


def to_torch(d):
    return {k: torch.from_numpy(np.array(v)) if isinstance(v, np.ndarray)
            else v for k, v in d.items()}


def jax_pre_to_torch(pre):
    """A JAX PreprocessOut as the port's, field by field."""
    from gsplat_tpu_torch.ops.preprocess import PreprocessOut
    return PreprocessOut(*[torch.from_numpy(np.array(x)) for x in pre])


def preprocess_both(g, cam, width, height, sh_degree=3, **kw):
    """(JAX PreprocessOut, port PreprocessOut) of the same numpy inputs."""
    import jax.numpy as jnp
    from gsplat_tpu.ops import preprocess as jpre
    from gsplat_tpu_torch.ops import preprocess as tpre
    c = cam_np(cam)
    arrays = [g[k] for k in GAUSS_KEYS] + [
        c["viewmatrix"], c["projmatrix"], c["campos"]]
    ja = [jnp.asarray(a) for a in arrays]
    ta = [torch.from_numpy(np.array(a)) for a in arrays]
    pj = jpre.preprocess(*ja[:5], sh_degree, *ja[5:], c["tan_fovx"],
                         c["tan_fovy"], width, height, **to_jax(kw))
    pt = tpre.preprocess(*ta[:5], sh_degree, *ta[5:], c["tan_fovx"],
                         c["tan_fovy"], width, height, **to_torch(kw))
    return pj, pt


def rasterize_both(g, cam, width, height, bg, num_class=0,
                   max_instances=1 << 14, render_only=False, **cfg_kw):
    """Port rasterize (CPU) and JAX rasterize (Pallas path, interpret mode
    on the CPU) of the same numpy inputs; outputs as numpy dicts.
    ``cfg_kw`` (e.g. ``cull``, ``max_rows``) goes to both configs."""
    import jax.numpy as jnp
    from gsplat_tpu.ops.rasterize import RasterizeConfig as JCfg
    from gsplat_tpu.ops.rasterize import rasterize as jrast
    from gsplat_tpu_torch.ops.rasterize import RasterizeConfig, rasterize
    c = cam_np(cam)
    jcfg = JCfg(width=width, height=height, num_class=num_class,
                max_instances=max_instances, backend="pallas",
                render_only=render_only, **cfg_kw)
    tcfg = RasterizeConfig(width=width, height=height, num_class=num_class,
                           max_instances=max_instances,
                           render_only=render_only, **cfg_kw)
    seg = g.get("segments") if num_class else None
    jo = jrast(jcfg, *[jnp.asarray(g[k]) for k in GAUSS_KEYS],
               **to_jax(c), bg=jnp.asarray(bg),
               segments=None if seg is None else jnp.asarray(seg))
    to = rasterize(tcfg, *[torch.from_numpy(g[k]) for k in GAUSS_KEYS],
                   **c, bg=bg,
                   segments=None if seg is None else torch.from_numpy(seg),
                   device="cpu")
    return ({k: np.asarray(v) for k, v in jo.items()},
            {k: v.numpy() for k, v in to.items()})


# The JAX tests' forward tolerances between the Pallas path and the oracle
# (tests/test_pallas_composite.py:35-43): float32 sums taken in another
# order, and a transmittance product taken as a log-step scan on the JAX
# side against a running product here.
ATOL = {"render": 3e-5, "alpha": 3e-5, "segment": 3e-5, "T_final": 3e-5,
        "depth": 3e-4}


def assert_images_close(got, want, keys):
    for k in keys:
        np.testing.assert_allclose(got[k], want[k], atol=ATOL[k], rtol=0,
                                   err_msg=k)


def model_state_np(rng, n=150, capacity=192, num_class=2, sh_degree=3):
    """Raw ``GaussianParams`` fields of a model with ``n`` random live
    gaussians and ``capacity - n`` dead slots (xyz 1e8, opacity logit -30),
    plus ``alive``, as float32 numpy arrays for both packages."""
    K = (sh_degree + 1) ** 2
    S = max(num_class, 1)
    f32 = np.float32
    p = dict(
        xyz=np.full((capacity, 3), 1e8, f32),
        features_dc=np.zeros((capacity, 1, 3), f32),
        features_rest=np.zeros((capacity, K - 1, 3), f32),
        scaling=np.zeros((capacity, 3), f32),
        rotation=np.tile(np.array([1, 0, 0, 0], f32), (capacity, 1)),
        opacity=np.full((capacity, 1), -30.0, f32),
        segment=np.zeros((capacity, S), f32),
    )
    p["xyz"][:n] = rng.standard_normal((n, 3)) * 1.2
    p["features_dc"][:n] = rng.standard_normal((n, 1, 3)) * 0.8
    p["features_rest"][:n] = rng.standard_normal((n, K - 1, 3)) * 0.2
    p["scaling"][:n] = rng.standard_normal((n, 3)) * 0.5 - 2.5
    p["rotation"][:n] = rng.standard_normal((n, 4))
    p["opacity"][:n] = rng.standard_normal((n, 1)) * 1.5
    p["segment"][:n] = rng.standard_normal((n, S))
    p["alive"] = np.arange(capacity) < n
    return p


def tree_np(tree):
    """A NamedTuple of JAX arrays or torch tensors as a dict of numpy
    arrays."""
    return {k: np.asarray(v.detach() if isinstance(v, torch.Tensor) else v)
            for k, v in tree._asdict().items()}


# --- the synthetic scene of the command-line tests -----------------------------

SCENE_CLASSES = 2


def make_scene_port(out_dir, n_gauss=150, n_cams=6, width=48, height=48,
                    num_class=SCENE_CLASSES, seed=0):
    """``make_synthetic_scene.make_scene(..., with_depth=True)`` written with
    the port: the same seeded cloud and orbiting cameras, ground truth from
    the port's O(P*H*W) oracle (``ops/composite_ref.py``) on the CPU, the
    same files (images, 16-bit depth, segment labels, transforms.json,
    points3d.ply).  The JAX original composites with eager JAX ops, about
    ten seconds for this scene; this takes well under one."""
    import json
    import os

    from PIL import Image

    from gsplat_tpu_torch.core import sh as sh_lib
    from gsplat_tpu_torch.core.cameras import Camera, fov2focal
    from gsplat_tpu_torch.data.readers import store_ply
    from gsplat_tpu_torch.ops import preprocess as tpre
    from gsplat_tpu_torch.ops.composite_ref import composite_reference

    rng = np.random.default_rng(seed)
    for sub in ("images", "depth", "segment"):
        os.makedirs(os.path.join(out_dir, sub), exist_ok=True)
    n = n_gauss
    pts = rng.standard_normal((n, 3)).astype(np.float32) * 0.8
    cols = rng.uniform(0.1, 0.9, (n, 3)).astype(np.float32)
    scales = np.exp(rng.standard_normal((n, 3)).astype(np.float32) * 0.3
                    - 2.2)
    quats = rng.standard_normal((n, 4)).astype(np.float32)
    opac = rng.uniform(0.5, 0.95, n).astype(np.float32)
    labels = rng.integers(0, num_class, n)
    seg_probs = np.full((n, num_class), 0.05, np.float32)
    seg_probs[np.arange(n), labels] = 0.95
    shs = np.zeros((n, 16, 3), np.float32)
    shs[:, 0] = sh_lib.rgb_to_sh(cols)
    fovx = math.radians(60.0)
    fovy = 2 * math.atan(math.tan(fovx / 2) * height / width)
    t = [torch.from_numpy(a) for a in (pts, scales, quats, opac, shs)]
    frames = []
    for i in range(n_cams):
        ang = 2 * math.pi * i / n_cams
        campos = np.array([4 * math.sin(ang), 0.6, 4 * math.cos(ang)])
        fwd = -campos / np.linalg.norm(campos)
        right = np.cross(fwd, np.array([0.0, 1.0, 0.0]))
        right /= np.linalg.norm(right)
        up = np.cross(fwd, right)
        up /= np.linalg.norm(up)
        r_w2c = np.stack([right, up, fwd], axis=0)
        t_w2c = -r_w2c @ campos
        cam = Camera(colmap_id=i, R=r_w2c.T, T=t_w2c, FoVx=fovx, FoVy=fovy,
                     image=np.zeros((3, height, width), np.float32),
                     image_name=f"frame_{i:03d}", uid=i)
        pre = tpre.preprocess(*t, 3, *[torch.from_numpy(np.array(m)) for m in (
            cam.world_view_transform, cam.full_proj_transform,
            cam.camera_center)], cam.tan_fovx, cam.tan_fovy, width, height)
        ref = composite_reference(pre, width, height, torch.zeros(3),
                                  segments=torch.from_numpy(seg_probs))
        name = f"frame_{i:03d}.png"
        img = ref["render"].clamp(0, 1).permute(1, 2, 0).numpy()
        Image.fromarray((img * 255).astype(np.uint8)).save(
            os.path.join(out_dir, "images", name))
        d = ref["depth"].numpy()
        Image.fromarray((d / (d.max() + 1e-9) * 65535).astype(np.uint16)).save(
            os.path.join(out_dir, "depth", name))
        Image.fromarray(ref["segment"].argmax(0).numpy().astype(np.uint8)).save(
            os.path.join(out_dir, "segment", name))
        w2c = np.eye(4)
        w2c[:3, :3], w2c[:3, 3] = r_w2c, t_w2c
        c2w = np.linalg.inv(w2c)
        c2w[:, 1:3] *= -1          # the readers flip NeRF axes back
        frames.append({"file_path": f"images/{name}",
                       "transform_matrix": c2w.tolist()})
    with open(os.path.join(out_dir, "transforms.json"), "w") as f:
        json.dump({"fl_x": fov2focal(fovx, width),
                   "fl_y": fov2focal(fovy, height), "w": width, "h": height,
                   "cx": width / 2, "cy": height / 2, "frames": frames},
                  f, indent=1)
    store_ply(os.path.join(out_dir, "points3d.ply"), pts,
              (cols * 255).astype(np.uint8))
    return out_dir


@pytest.fixture(scope="module")
def scene_dir(tmp_path_factory):
    """``make_synthetic_scene.make_scene``'s NeRFstudio scene at 48x48,
    written with the port (``make_scene_port``): 150 gaussians, 6 cameras
    with depth and segment labels (once per file)."""
    return make_scene_port(str(tmp_path_factory.mktemp("synth")))


def dataset_args(scene_dir, model_path):
    return argparse.Namespace(
        source_path=scene_dir, model_path=model_path, images="images",
        resolution=-1, white_background=False, eval=True, using_depth=True,
        using_seg=True)


@pytest.fixture(scope="module")
def scenes(scene_dir, tmp_path_factory):
    """(JAX Scene with its model, port Scene with its CPU model), loaded
    with the same shuffle."""
    from gsplat_tpu.data.scene import Scene as JScene
    from gsplat_tpu.models.gaussians import GaussianModel as JModel
    from gsplat_tpu_torch.data.scene import Scene as TScene
    from gsplat_tpu_torch.models.gaussians import GaussianModel
    out = []
    for name, scene_cls, model in (
            ("jax", JScene, JModel(3, num_class=SCENE_CLASSES, capacity=512)),
            ("port", TScene, GaussianModel(3, num_class=SCENE_CLASSES,
                                           capacity=512, device="cpu"))):
        random.seed(0)
        args = dataset_args(scene_dir, str(tmp_path_factory.mktemp(name)))
        out.append(scene_cls(args, model))
    return out


def model_pair(rng, capacity=96, n=80):
    """A JAX model and a port model (CPU) of the same random state
    (``model_state_np``), active SH degree 2."""
    import jax.numpy as jnp
    from gsplat_tpu.models.gaussians import GaussianModel as JModel
    from gsplat_tpu.models.gaussians import GaussianParams as JParams
    from gsplat_tpu_torch.models.gaussians import params_from_numpy
    p = model_state_np(rng, n=n, capacity=capacity, num_class=SCENE_CLASSES)
    alive = p.pop("alive")
    jm = JModel(3, num_class=SCENE_CLASSES, capacity=capacity)
    jm.params = JParams(**{k: jnp.asarray(v) for k, v in p.items()})
    jm.aux = jm.aux._replace(alive=jnp.asarray(alive))
    jm.active_sh_degree = 2
    tm = params_from_numpy(dict(p, alive=alive), device="cpu",
                           active_sh_degree=2)
    return jm, tm


def port_opt(**kw):
    """The port's ``OptimizationParams`` with the given fields changed."""
    from gsplat_tpu_torch.config import OptimizationParams
    o = OptimizationParams()
    for k, v in kw.items():
        setattr(o, k, v)
    return o


class RecordSteps:
    """A ``Trainer.train`` callback keeping (iteration, loss, overflow,
    instance capacity) of every call."""

    def __init__(self):
        self.rows = []

    def __call__(self, it, metrics, tr):
        self.rows.append((it, float(metrics["loss"]),
                          bool(metrics["overflow"]), tr.max_instances))
