"""Per-camera appearance embedding (PyTorch port of
``gsplat_tpu/models/appearance.py``; the reference's tiny-cuda-nn module,
gaussian_renderer/__init__.py:112-199).

A 16-dim learned per-camera embedding concatenated with the flattened 4x4
view matrix (32 inputs) -> Frequency(4) sin/cos encoding (256 dims) -> an
MLP of two hidden layers of 32 (ReLU) and a sigmoid output -> 3 RGB factors
multiplied into the rendered image.  Own Adam (lr 1e-4, eps 1e-15).  Plain
torch matmuls, as the JAX package computes them outside any kernel.

``init_params`` draws glorot-uniform weights from a ``torch.Generator``
(seeded 1337 when none is given), not from JAX's threefry stream: the same
distribution, other numbers (ROADMAP Queue 3, "intended").  ``save`` and
``load`` use the JAX package's npz keys, so a file written by either
package loads in the other (through ``models/gaussians.py``'s
``appearance_params_from_numpy`` and ``adam_state_from_numpy``, which also
take the JAX parameters' fields as numpy arrays).
"""
from __future__ import annotations

import math
import os
from typing import NamedTuple

import numpy as np
import torch

from gsplat_tpu_torch.device import resolve_device
from gsplat_tpu_torch.models import adam
from gsplat_tpu_torch.models.gaussians import (adam_state_from_numpy,
                                               appearance_params_from_numpy)

N_FREQ = 4
EMB_DIM = 16
IN_DIM = 32
HIDDEN = 32


class AppearanceParams(NamedTuple):
    emb: torch.Tensor        # [num_cameras, 16]
    w0: torch.Tensor         # [enc, 32]
    b0: torch.Tensor
    w1: torch.Tensor         # [32, 32]
    b1: torch.Tensor
    w2: torch.Tensor         # [32, 3]
    b2: torch.Tensor


def frequency_encoding(x, n_freq: int = N_FREQ):
    """tiny-cuda-nn 'Frequency' encoding: sin/cos(2^i * pi * x).  The
    frequencies are float32 products taken as the JAX package takes them
    (2^i in float32, times pi rounded to float32), so that the angles
    agree to the last bit."""
    freqs = (2.0 ** torch.arange(n_freq, dtype=torch.float32,
                                 device=x.device)) * torch.tensor(
        math.pi, dtype=torch.float32, device=x.device)
    ang = x[..., None] * freqs  # [..., D, F]
    enc = torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)
    return enc.reshape(x.shape[:-1] + (-1,))


def init_params(num_cameras: int, generator=None,
                device="cuda") -> AppearanceParams:
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev)
        generator.manual_seed(1337)
    enc_dim = IN_DIM * 2 * N_FREQ

    def glorot(fan_in, fan_out):
        lim = float(np.sqrt(6.0 / (fan_in + fan_out)))
        u = torch.rand((fan_in, fan_out), generator=generator,
                       device=generator.device, dtype=torch.float32)
        return (u * (2 * lim) - lim).to(dev)

    def zeros(*shape):
        return torch.zeros(shape, dtype=torch.float32, device=dev)

    return AppearanceParams(
        emb=zeros(num_cameras, EMB_DIM),
        w0=glorot(enc_dim, HIDDEN), b0=zeros(HIDDEN),
        w1=glorot(HIDDEN, HIDDEN), b1=zeros(HIDDEN),
        w2=glorot(HIDDEN, 3), b2=zeros(3),
    )


def apply(params: AppearanceParams, cam_uid, viewmatrix):
    """-> [3] RGB appearance factors for one camera."""
    emb = params.emb[cam_uid]
    x = torch.cat([emb, viewmatrix.reshape(-1)])
    h = frequency_encoding(x)
    h = torch.relu(h @ params.w0 + params.b0)
    h = torch.relu(h @ params.w1 + params.b1)
    return torch.sigmoid(h @ params.w2 + params.b2)


class AppearanceOptimizer:
    """Host container mirroring the reference class's API."""

    def __init__(self, num_cameras: int, lr: float = 1e-4, device="cuda"):
        self.num_cameras = num_cameras
        self.lr = lr
        self.device = resolve_device(device)
        self.params = init_params(num_cameras, device=self.device)
        self.opt_state = adam.init(self.params)
        print("using appearance embedding!")

    def __call__(self, viewpoint_cam):
        return apply(self.params, int(viewpoint_cam.uid),
                     torch.as_tensor(viewpoint_cam.world_view_transform,
                                     dtype=torch.float32, device=self.device))

    def update(self, grads):
        lrs = tuple(self.lr for _ in self.params)
        self.params, self.opt_state = adam.update(
            grads, self.opt_state, self.params, lrs)

    def save(self, path: str, with_opt: bool = False):
        """Model state beside the PLY (reference save_appearance_embedding,
        gaussian_renderer/__init__.py:163-170); ``with_opt`` adds the Adam
        moments and count for an exact resume, under the JAX package's
        keys (``opt_count``, ``mu_<field>``, ``nu_<field>``)."""
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)

        def host(x):
            return x.detach().cpu().numpy()

        arrays = {k: host(v) for k, v in self.params._asdict().items()}
        if with_opt:
            arrays["opt_count"] = host(self.opt_state.count)
            for k, v in self.opt_state.mu._asdict().items():
                arrays[f"mu_{k}"] = host(v)
            for k, v in self.opt_state.nu._asdict().items():
                arrays[f"nu_{k}"] = host(v)
        np.savez(path, **arrays)

    def load(self, path: str) -> bool:
        if not os.path.exists(path):
            print("disable appearance embedding")
            return False
        z = np.load(path)
        self.params = appearance_params_from_numpy(z, self.device)
        if "opt_count" in z.files:
            self.opt_state = adam_state_from_numpy(
                z["opt_count"],
                {k: z[f"mu_{k}"] for k in AppearanceParams._fields},
                {k: z[f"nu_{k}"] for k in AppearanceParams._fields},
                self.device, tree_type=AppearanceParams)
        else:
            self.opt_state = adam.init(self.params)
        return True
