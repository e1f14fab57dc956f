"""Gaussian parameter state (PyTorch port of ``gsplat_tpu/models/gaussians.py``).

Parameters live in fixed-capacity tensors ``[capacity, ...]`` with an
``alive`` mask, as in the JAX package: dead slots carry opacity logit -30 so
the rasterizer's own alpha test culls them.  This slice carries what the
renderer needs: the parameter layout, PLY / npz loading and
``params_from_numpy``, which takes the JAX model's fields as numpy arrays so
both packages render one scene.  The optimizer, densification and KNN
initialisation come with the training slice.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from gsplat_tpu_torch.data import ply as ply_io
from gsplat_tpu_torch.device import resolve_device

DEAD_OPACITY_LOGIT = -30.0
DEAD_XYZ = 1e8  # park dead gaussians far outside every frustum


class GaussianParams(NamedTuple):
    """Raw (pre-activation) parameters, all [capacity, ...] float32."""
    xyz: torch.Tensor            # [C,3]
    features_dc: torch.Tensor    # [C,1,3]
    features_rest: torch.Tensor  # [C,K-1,3]
    scaling: torch.Tensor        # [C,3] log-scale
    rotation: torch.Tensor       # [C,4] quaternion (unnormalized)
    opacity: torch.Tensor        # [C,1] logit
    segment: torch.Tensor        # [C,S] logit


def empty_params(capacity: int, sh_degree: int, num_class: int,
                 device="cuda") -> GaussianParams:
    dev = resolve_device(device)
    K = (sh_degree + 1) ** 2
    f32 = dict(dtype=torch.float32, device=dev)
    rotation = torch.zeros((capacity, 4), **f32)
    rotation[:, 0] = 1.0
    return GaussianParams(
        xyz=torch.full((capacity, 3), DEAD_XYZ, **f32),
        features_dc=torch.zeros((capacity, 1, 3), **f32),
        features_rest=torch.zeros((capacity, K - 1, 3), **f32),
        scaling=torch.zeros((capacity, 3), **f32),
        rotation=rotation,
        opacity=torch.full((capacity, 1), DEAD_OPACITY_LOGIT, **f32),
        segment=torch.zeros((capacity, max(num_class, 1)), **f32),
    )


class GaussianModel:
    """Host-side container of the parameter tensors and the alive mask."""

    def __init__(self, sh_degree: int, num_class: int = 2,
                 capacity: int = 1 << 19, device="cuda"):
        self.device = resolve_device(device)
        self.max_sh_degree = int(sh_degree)
        self.active_sh_degree = 0
        self.num_class = int(num_class)
        self.capacity = int(capacity)
        self.params = empty_params(self.capacity, sh_degree, num_class,
                                   self.device)
        self.alive = torch.zeros((self.capacity,), dtype=torch.bool,
                                 device=self.device)

    # --- activated views (scene/gaussian_model.py:100-131) -------------------
    @property
    def get_features(self):
        return torch.cat([self.params.features_dc, self.params.features_rest],
                         dim=1)

    @property
    def num_alive(self) -> int:
        return int(self.alive.sum())

    def _set_rows(self, xyz, f_dc, f_rest, scaling, rot, opacity, seg,
                  capacity: int):
        """Fresh params of ``capacity`` slots with the first n rows set from
        numpy arrays (f_dc [n,1,3], f_rest [n,K-1,3], opacity [n,1])."""
        n = xyz.shape[0]
        self.capacity = int(capacity)
        p = empty_params(self.capacity, self.max_sh_degree, seg.shape[1],
                         self.device)
        for dst, src in zip(p, (xyz, f_dc, f_rest, scaling, rot, opacity,
                                seg)):
            dst[:n] = torch.from_numpy(np.array(src, np.float32)).to(
                self.device)
        self.params = p
        self.alive = torch.zeros((self.capacity,), dtype=torch.bool,
                                 device=self.device)
        self.alive[:n] = True
        self.active_sh_degree = self.max_sh_degree

    # --- loading ---------------------------------------------------------------
    def load_ply(self, path: str):
        """Reference-schema PLY (scene/gaussian_model.py:229-260).  Grows the
        capacity to the next power of two above the vertex count, as the JAX
        model does."""
        d = ply_io.read_ply(path)
        n = len(d["x"])
        capacity = self.capacity
        if n > capacity:
            capacity = 1 << int(np.ceil(np.log2(n + 1)))
        xyz = np.stack([d["x"], d["y"], d["z"]], axis=1)
        K = (self.max_sh_degree + 1) ** 2
        f_dc = np.stack([d[f"f_dc_{i}"] for i in range(3)], axis=1)[:, None]
        rest_names = sorted(
            [k for k in d if k.startswith("f_rest_")],
            key=lambda s: int(s.split("_")[-1]))
        if len(rest_names) != 3 * (K - 1):
            raise ValueError(
                f"expected {3 * (K - 1)} f_rest, got {len(rest_names)}")
        f_rest = np.stack([d[k] for k in rest_names], axis=1)
        f_rest = f_rest.reshape(n, 3, K - 1).transpose(0, 2, 1)
        seg_names = sorted(
            [k for k in d if k.startswith("segment_")],
            key=lambda s: int(s.split("_")[-1]))
        if seg_names:
            seg = np.stack([d[k] for k in seg_names], axis=1)
            self.num_class = seg.shape[1]
        else:
            seg = np.zeros((n, max(self.num_class, 1)), np.float32)
        scaling = np.stack([d[f"scale_{i}"] for i in range(3)], axis=1)
        rot = np.stack([d[f"rot_{i}"] for i in range(4)], axis=1)
        opacity = np.asarray(d["opacity"])[:, None]
        self._set_rows(xyz, f_dc, f_rest, scaling, rot, opacity, seg,
                       capacity)

    def load_npz(self, path: str):
        """The compressed bench asset (``assets/trained_scene_big.npz``: raw
        parameter fields, geometry f32, SH bands fp16, no segment logits).
        The capacity is sized to the asset, as bench.py renders it."""
        z = np.load(path)
        n = z["xyz"].shape[0]
        K = (self.max_sh_degree + 1) ** 2
        if z["features_rest"].shape[1] != K - 1:
            raise ValueError(f"asset has {z['features_rest'].shape[1] + 1} "
                             f"SH bands, model expects {K}")
        seg = np.zeros((n, max(self.num_class, 1)), np.float32)
        self._set_rows(z["xyz"], z["features_dc"], z["features_rest"],
                       z["scaling"], z["rotation"], z["opacity"], seg, n)


def params_from_numpy(d: dict, device="cuda", num_class: Optional[int] = None,
                      active_sh_degree: Optional[int] = None
                      ) -> GaussianModel:
    """A port model from the JAX ``GaussianParams`` fields as numpy arrays
    (``{k: np.asarray(v) for k, v in jax_model.params._asdict().items()}``,
    optionally plus ``alive``).  ``num_class`` defaults to the segment
    width; pass 0 for a JAX model built with ``num_class=0`` (whose segment
    field is one dead column).  ``active_sh_degree`` defaults to the
    degree the SH bands allow."""
    capacity = d["xyz"].shape[0]
    sh_degree = int(math.isqrt(d["features_rest"].shape[1] + 1)) - 1
    m = GaussianModel(sh_degree, num_class=d["segment"].shape[1]
                      if num_class is None else num_class,
                      capacity=capacity, device=device)
    m._set_rows(d["xyz"], d["features_dc"], d["features_rest"],
                d["scaling"], d["rotation"], d["opacity"], d["segment"],
                capacity)
    if "alive" in d:
        m.alive = torch.from_numpy(np.array(d["alive"], bool)).to(m.device)
    if active_sh_degree is not None:
        m.active_sh_degree = int(active_sh_degree)
    return m
