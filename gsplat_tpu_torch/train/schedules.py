"""Learning-rate schedules (PyTorch port of ``gsplat_tpu/train/schedules.py``;
host-side numpy, no tensors).

Behavioral spec: utils/general_utils.py:37-70 (get_expon_lr_func, from
Plenoxels/JaxNeRF) and the per-group lr table in
scene/gaussian_model.py:166-181.
"""
from __future__ import annotations

import numpy as np


def expon_lr(step, lr_init, lr_final, lr_delay_steps=0, lr_delay_mult=1.0,
             max_steps=1_000_000):
    if step < 0 or (lr_init == 0.0 and lr_final == 0.0):
        return 0.0
    if lr_delay_steps > 0:
        delay_rate = lr_delay_mult + (1 - lr_delay_mult) * np.sin(
            0.5 * np.pi * np.clip(step / lr_delay_steps, 0, 1))
    else:
        delay_rate = 1.0
    t = np.clip(step / max_steps, 0, 1)
    log_lerp = np.exp(np.log(lr_init) * (1 - t) + np.log(lr_final) * t)
    return float(delay_rate * log_lerp)


def make_lr_fn(opt, spatial_lr_scale: float):
    """Returns step -> dict of per-group lrs (gaussian_model.py:166-189)."""

    def lrs(step: int) -> dict:
        return {
            "xyz": expon_lr(step,
                            opt.position_lr_init * spatial_lr_scale,
                            opt.position_lr_final * spatial_lr_scale,
                            lr_delay_mult=opt.position_lr_delay_mult,
                            max_steps=opt.position_lr_max_steps),
            "features_dc": opt.feature_lr,
            "features_rest": opt.feature_lr / 20.0,
            "opacity": opt.opacity_lr,
            "segment": opt.segment_lr,
            "scaling": opt.scaling_lr,
            "rotation": opt.rotation_lr,
        }

    return lrs
