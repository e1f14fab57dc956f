"""The benchmark's inputs, made on the device from the committed asset and
the seed: the scene of a configuration (the asset's rows, segment logits
from a generator seeded ``segment_seed``, and ``splits`` rounds of 3DGS's
split from a generator seeded ``split_seed``), the seeded perturbation of a
training run's starting point, and the port's model holding them."""
from __future__ import annotations

import os

import numpy as np
import torch

from splatbench.reference import splat

FIELDS = splat.FIELDS


def load(config: dict, root: str, device) -> splat.Params:
    """The configuration's scene as raw parameters, one row a gaussian."""
    sc = config["scene"]
    z = np.load(os.path.join(root, sc["asset"]))
    n = int(sc.get("take") or z["xyz"].shape[0])

    def t(key):
        return torch.from_numpy(np.ascontiguousarray(z[key][:n])).to(
            device=device, dtype=torch.float32)

    gen = torch.Generator(device=device)
    gen.manual_seed(int(sc["segment_seed"]))
    seg = torch.randn((n, config["num_class"]), generator=gen, device=device)
    p = splat.Params(t("xyz"), t("features_dc"), t("features_rest"),
                     t("scaling"), t("rotation"), t("opacity"), seg)
    if sc.get("splits"):
        gen.manual_seed(int(sc["split_seed"]))
        for _ in range(int(sc["splits"])):
            p = splat.split(p, gen)
    if p.xyz.shape[0] != config["num_gaussians"]:
        raise ValueError(f"{config['name']}: the scene has "
                         f"{p.xyz.shape[0]} gaussians, the configuration "
                         f"{config['num_gaussians']}")
    return p


def perturb(p: splat.Params, noise: dict, seed: int) -> splat.Params:
    """``p`` with every field moved by N(0, noise[field]) drawn from a
    generator seeded ``seed`` on ``p``'s device."""
    gen = torch.Generator(device=p.xyz.device)
    gen.manual_seed(int(seed))
    return splat.Params(*[
        x + noise[f] * torch.randn(x.shape, generator=gen, device=x.device)
        for f, x in zip(FIELDS, p)])


def port_model(p: splat.Params, config: dict, capacity: int, device,
               train: bool):
    """The port's ``GaussianModel`` of ``capacity`` slots with ``p`` in its
    first rows, at its full SH degree; with ``train``, its Adam state set
    up."""
    from gsplat_tpu_torch.models.gaussians import GaussianModel
    m = GaussianModel(config["sh_degree"], num_class=config["num_class"],
                      capacity=capacity, device=device)
    n = p.xyz.shape[0]
    for dst, src in zip(m.params, p):
        dst[:n] = src
    m.aux.alive[:n] = True
    m.active_sh_degree = config["sh_degree"]
    if train:
        m.training_setup()
    return m


def port_camera(pose: dict, config: dict, image=None, depth=None,
                segment=None, uid=0):
    """A port camera of ``pose``: a ``Camera`` with its targets for
    training, else the viewer's ``MiniCam`` of its matrices."""
    from splatbench.reference.camera import ZFAR, ZNEAR, matrices
    W, H = config["width"], config["height"]
    if image is None:
        from gsplat_tpu_torch.core.cameras import MiniCam
        view, full, _ = matrices(pose, W, H)
        return MiniCam(W, H, pose["fovy"], pose["fovx"], ZNEAR, ZFAR, view,
                       full)
    from gsplat_tpu_torch.core.cameras import Camera
    return Camera(colmap_id=uid, R=np.asarray(pose["R"]),
                  T=np.asarray(pose["T"]), FoVx=pose["fovx"],
                  FoVy=pose["fovy"], image=image, image_name=f"view{uid}",
                  uid=uid, depth=depth, segment=segment)
