"""Gaussian parameter state (PyTorch port of ``gsplat_tpu/models/gaussians.py``).

Parameters live in fixed-capacity tensors ``[capacity, ...]`` with an
``alive`` mask, as in the JAX package: dead slots carry opacity logit -30 so
the rasterizer's own alpha test culls them.  Carried here: the parameter
and bookkeeping layout, initialisation from a point cloud (KNN scales), the
Adam state, capacity growth, PLY / npz loading, PLY export, the full
checkpoints, and ``params_from_numpy`` / ``aux_from_numpy`` /
``adam_state_from_numpy`` / ``appearance_params_from_numpy``, which take
the JAX model's fields as numpy arrays so both packages start from one
state.  The checkpoints use the JAX
package's npz keys, so a checkpoint written by either package restores in
the other: a second way of carrying weights across.  Clone, split and prune
live in ``models/densify.py``.
"""
from __future__ import annotations

import ast
import math
import os
from typing import NamedTuple, Optional

import numpy as np
import torch

from gsplat_tpu_torch.core import sh as sh_lib
from gsplat_tpu_torch.core import transforms as T
from gsplat_tpu_torch.data import ply as ply_io
from gsplat_tpu_torch.device import resolve_device
from gsplat_tpu_torch.models import adam
from gsplat_tpu_torch.ops.knn import dist2_knn

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


class GaussianAux(NamedTuple):
    """Non-trainable per-gaussian state (densification bookkeeping)."""
    alive: torch.Tensor               # [C] bool
    max_radii2d: torch.Tensor         # [C] f32
    xyz_gradient_accum: torch.Tensor  # [C] f32
    denom: torch.Tensor               # [C] f32


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


def empty_aux(capacity: int, device="cuda") -> GaussianAux:
    dev = resolve_device(device)
    return GaussianAux(
        alive=torch.zeros((capacity,), dtype=torch.bool, device=dev),
        max_radii2d=torch.zeros((capacity,), dtype=torch.float32, device=dev),
        xyz_gradient_accum=torch.zeros((capacity,), dtype=torch.float32,
                                       device=dev),
        denom=torch.zeros((capacity,), dtype=torch.float32, device=dev),
    )


def _pad_rows(tree_old, tree_empty):
    """``tree_empty`` (more rows) with ``tree_old``'s rows copied in front."""
    out = []
    for o, e in zip(tree_old, tree_empty):
        e[:o.shape[0]] = o
        out.append(e)
    return type(tree_old)(*out)


class GaussianModel:
    """Host-side container of the functional state: parameters, bookkeeping
    (``aux``) and, after ``training_setup``, the Adam state."""

    def __init__(self, sh_degree: int, num_class: int = 2,
                 capacity: int = 1 << 19, device="cuda"):
        self.device = resolve_device(device)
        self.max_sh_degree = int(sh_degree)
        self.active_sh_degree = 0
        self.num_class = int(num_class)
        self.capacity = int(capacity)
        self.spatial_lr_scale = 1.0
        self.params = empty_params(self.capacity, sh_degree, num_class,
                                   self.device)
        self.aux = empty_aux(self.capacity, self.device)
        self.opt_state: Optional[adam.AdamState] = None

    # --- activated views (scene/gaussian_model.py:100-131) -------------------
    @property
    def get_xyz(self):
        return self.params.xyz

    @property
    def get_scaling(self):
        return T.scaling_activation(self.params.scaling)

    @property
    def get_rotation(self):
        return T.rotation_activation(self.params.rotation)

    @property
    def get_opacity(self):
        return T.opacity_activation(self.params.opacity)

    @property
    def get_segment(self):
        return T.segment_activation(self.params.segment)

    @property
    def get_features(self):
        return torch.cat([self.params.features_dc, self.params.features_rest],
                         dim=1)

    @property
    def num_alive(self) -> int:
        return int(self.aux.alive.sum())

    def oneup_sh_degree(self):
        if self.active_sh_degree < self.max_sh_degree:
            self.active_sh_degree += 1

    # --- init (scene/gaussian_model.py:133-160) ------------------------------
    def create_from_pcd(self, points: np.ndarray, colors: np.ndarray,
                        spatial_lr_scale: float):
        n = points.shape[0]
        if n > self.capacity:
            raise ValueError(
                f"point cloud ({n}) exceeds capacity ({self.capacity})")
        self.spatial_lr_scale = float(spatial_lr_scale)
        f32 = dict(dtype=torch.float32, device=self.device)
        pts = torch.as_tensor(np.asarray(points, np.float32), **f32)
        dist2 = torch.clamp(dist2_knn(pts), min=1e-7)
        scales = torch.log(torch.sqrt(dist2))[:, None].repeat(1, 3)
        fused_color = sh_lib.rgb_to_sh(
            torch.as_tensor(np.asarray(colors, np.float32), **f32))
        p = self.params
        p.xyz[:n] = pts
        p.features_dc[:n, 0] = fused_color
        p.scaling[:n] = scales
        p.opacity[:n] = T.inverse_sigmoid(torch.full((n, 1), 0.1, **f32))
        p.segment[:n] = T.inverse_sigmoid(
            torch.full((n, p.segment.shape[1]), 0.1, **f32))
        self.aux.alive[:n] = True
        print(f"Number of points at initialisation : {n}")

    def training_setup(self):
        self.opt_state = adam.init(self.params)

    def grow_capacity(self, new_capacity: int):
        """Reallocate to a larger fixed capacity, keeping slot indices
        (existing rows copy over; new slots are dead).  Adam moments (if
        any) are carried over with zeroed state for the new slots."""
        new_capacity = int(new_capacity)
        if new_capacity <= self.capacity:
            return
        old_cap = self.capacity
        self.capacity = new_capacity
        self.params = _pad_rows(self.params, empty_params(
            new_capacity, self.max_sh_degree, self.params.segment.shape[1],
            self.device))
        self.aux = _pad_rows(self.aux, empty_aux(new_capacity, self.device))
        if self.opt_state is not None:
            zeros = adam.init(self.params)
            self.opt_state = adam.AdamState(
                count=self.opt_state.count,
                mu=_pad_rows(self.opt_state.mu, zeros.mu),
                nu=_pad_rows(self.opt_state.nu, zeros.nu))
        print(f"[model] capacity grown {old_cap} -> {new_capacity}")

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
        self.aux = empty_aux(self.capacity, self.device)
        self.aux.alive[:n] = True
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

    def save_ply(self, path: str, mask: Optional[np.ndarray] = None):
        """Reference-schema PLY of the ALIVE gaussians (compacted), byte for
        byte the JAX package's ``save_ply``."""
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        alive = self.aux.alive.cpu().numpy()
        if mask is not None:
            alive = alive & np.asarray(mask)
        sel = np.nonzero(alive)[0]
        p = GaussianParams(*[x.detach().cpu().numpy() for x in self.params])
        n = len(sel)
        xyz = p.xyz[sel]
        f_dc = p.features_dc[sel].transpose(0, 2, 1).reshape(n, -1)
        f_rest = p.features_rest[sel].transpose(0, 2, 1).reshape(n, -1)
        props = {}
        for i, k in enumerate("xyz"):
            props[k] = xyz[:, i].astype(np.float32)
        for k in ("nx", "ny", "nz"):
            props[k] = np.zeros(n, np.float32)
        for i in range(f_dc.shape[1]):
            props[f"f_dc_{i}"] = f_dc[:, i].astype(np.float32)
        for i in range(f_rest.shape[1]):
            props[f"f_rest_{i}"] = f_rest[:, i].astype(np.float32)
        props["opacity"] = p.opacity[sel, 0].astype(np.float32)
        for i in range(p.segment.shape[1]):
            props[f"segment_{i}"] = p.segment[sel, i].astype(np.float32)
        for i in range(3):
            props[f"scale_{i}"] = p.scaling[sel, i].astype(np.float32)
        for i in range(4):
            props[f"rot_{i}"] = p.rotation[sel, i].astype(np.float32)
        # the comment names the file format's family, as the JAX package
        # writes it, so both packages write the same bytes
        ply_io.write_ply(path, props, comment="gsplat_tpu")

    # --- full checkpoint (capture/restore, scene/gaussian_model.py:64-98) ----
    def capture(self) -> dict:
        """Scalars under "meta", and every state tensor as a numpy array
        under the JAX package's npz key ("params.<f>", "aux.<f>",
        "opt.count", "opt.mu.<f>", "opt.nu.<f>")."""
        state = {
            "active_sh_degree": self.active_sh_degree,
            "max_sh_degree": self.max_sh_degree,
            "num_class": self.num_class,
            "capacity": self.capacity,
            "spatial_lr_scale": self.spatial_lr_scale,
        }

        def host(x):
            return x.detach().cpu().numpy()

        arrays = {}
        for k, v in self.params._asdict().items():
            arrays[f"params.{k}"] = host(v)
        for k, v in self.aux._asdict().items():
            arrays[f"aux.{k}"] = host(v)
        if self.opt_state is not None:
            arrays["opt.count"] = host(self.opt_state.count)
            for k, v in self.opt_state.mu._asdict().items():
                arrays[f"opt.mu.{k}"] = host(v)
            for k, v in self.opt_state.nu._asdict().items():
                arrays[f"opt.nu.{k}"] = host(v)
        return {"meta": state, "arrays": arrays}

    def save_checkpoint(self, path: str, iteration: int):
        cap = self.capture()
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        np.savez_compressed(
            path, __iteration=iteration,
            __meta=np.array(repr(cap["meta"]), dtype=object), **cap["arrays"])

    def restore_checkpoint(self, path: str) -> int:
        """Restore a checkpoint of either package onto this model's device;
        returns its iteration."""
        z = np.load(path, allow_pickle=True)
        meta = ast.literal_eval(str(z["__meta"].item()))
        self.active_sh_degree = meta["active_sh_degree"]
        self.max_sh_degree = meta["max_sh_degree"]
        self.num_class = meta["num_class"]
        self.capacity = meta["capacity"]
        self.spatial_lr_scale = meta["spatial_lr_scale"]

        def tree(cls, prefix):
            return cls(**{k: torch.from_numpy(np.array(z[prefix + k])).to(
                self.device) for k in cls._fields})

        self.params = tree(GaussianParams, "params.")
        self.aux = tree(GaussianAux, "aux.")
        if "opt.count" in z:
            self.opt_state = adam.AdamState(
                count=torch.from_numpy(np.array(z["opt.count"])).to(
                    self.device),
                mu=tree(GaussianParams, "opt.mu."),
                nu=tree(GaussianParams, "opt.nu."))
        return int(z["__iteration"])

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
        m.aux = m.aux._replace(alive=_tensor(d["alive"], m.device, bool))
    if active_sh_degree is not None:
        m.active_sh_degree = int(active_sh_degree)
    return m


def _tensor(a, device, dtype=None):
    return torch.from_numpy(np.array(a, dtype)).to(resolve_device(device))


def aux_from_numpy(d: dict, device="cuda") -> GaussianAux:
    """The port's ``GaussianAux`` from the JAX one's fields as numpy arrays
    (``{k: np.asarray(v) for k, v in jax_aux._asdict().items()}``)."""
    return GaussianAux(
        alive=_tensor(d["alive"], device, bool),
        **{k: _tensor(d[k], device, np.float32)
           for k in GaussianAux._fields[1:]})


def appearance_params_from_numpy(d: dict, device="cuda"):
    """The port's ``models.appearance.AppearanceParams`` from the JAX
    ones' fields as numpy arrays (``{k: np.asarray(v) for k, v in
    jax_app_params._asdict().items()}``, or an npz of them)."""
    from gsplat_tpu_torch.models.appearance import AppearanceParams
    return AppearanceParams(**{k: _tensor(d[k], device, np.float32)
                               for k in AppearanceParams._fields})


def adam_state_from_numpy(count, mu: dict, nu: dict, device="cuda",
                          tree_type=GaussianParams) -> adam.AdamState:
    """The port's ``AdamState`` over ``tree_type`` (``GaussianParams``, or
    ``AppearanceParams``) from the JAX one's ``count`` and the fields of
    its ``mu`` and ``nu`` as numpy arrays."""
    def tree(d):
        return tree_type(**{k: _tensor(d[k], device, np.float32)
                            for k in tree_type._fields})
    return adam.AdamState(count=_tensor(count, device, np.int32),
                          mu=tree(mu), nu=tree(nu))
