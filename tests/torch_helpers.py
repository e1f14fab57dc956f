"""Shared inputs for the parity tests of the PyTorch port (tests/test_torch_*).

Inputs are made once in numpy from a seeded generator and handed to both
packages; JAX stays on the CPU and the port runs with ``device="cpu"``,
where every kernel wrapper uses its plain PyTorch version.
"""
import math

import numpy as np
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
                   max_instances=1 << 14, render_only=False):
    """Port rasterize (CPU) and JAX rasterize (Pallas path, interpret mode
    on the CPU) of the same numpy inputs; outputs as numpy dicts."""
    import jax.numpy as jnp
    from gsplat_tpu.ops.rasterize import RasterizeConfig as JCfg
    from gsplat_tpu.ops.rasterize import rasterize as jrast
    from gsplat_tpu_torch.ops.rasterize import RasterizeConfig, rasterize
    c = cam_np(cam)
    jcfg = JCfg(width=width, height=height, num_class=num_class,
                max_instances=max_instances, backend="pallas",
                render_only=render_only)
    tcfg = RasterizeConfig(width=width, height=height, num_class=num_class,
                           max_instances=max_instances,
                           render_only=render_only)
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
