"""Optimization constants (PyTorch port of ``gsplat_tpu/config.py``, the
``OptimizationParams`` group only).

Behavioral spec: reference arguments/__init__.py:90-113, identical schedule
constants.  The argparse machinery and the other groups (model, pipeline,
performance) come with the command-line slice.
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass
class OptimizationParams:
    iterations: int = 30_000
    position_lr_init: float = 0.00008
    position_lr_final: float = 0.0000016
    position_lr_delay_mult: float = 0.01
    position_lr_max_steps: int = 30_000
    feature_lr: float = 0.0025
    opacity_lr: float = 0.05
    segment_lr: float = 0.05
    scaling_lr: float = 0.002
    rotation_lr: float = 0.001
    percent_dense: float = 0.01
    lambda_dssim: float = 0.2
    lambda_depth: float = 0.1
    lambda_segment: float = 0.01
    lambda_rank_depth: float = 0.2
    lambda_continue_depth: float = 0.02
    densification_interval: int = 100
    opacity_reset_interval: int = 3000
    densify_from_iter: int = 500
    densify_until_iter: int = 15_000
    densify_grad_threshold: float = 0.0002
