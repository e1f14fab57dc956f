"""Misc host utilities (PyTorch port of ``gsplat_tpu/utils/general.py``).

Behavioral spec: reference utils/general_utils.py:120-141 (``safe_state``:
timestamped stdout and global seeding) and utils/system_utils.py:16-28
(``mkdir_p``, ``searchForMaxIteration``), and ``quantize``, the uint8 image
the render CLI and the viewer socket both write.
"""
from __future__ import annotations

import os
import random
import sys
from datetime import datetime

import numpy as np
import torch


class _TimestampedStdout:
    def __init__(self, old, silent: bool):
        self.old = old
        self.silent = silent

    def write(self, x):
        if self.silent:
            return
        if x.endswith("\n"):
            ts = datetime.now().strftime("%d/%m %H:%M:%S")
            self.old.write(x.replace("\n", f" [{ts}]\n"))
        else:
            self.old.write(x)

    def flush(self):
        self.old.flush()


def safe_state(silent: bool = False, seed: int = 0) -> torch.Generator:
    """Timestamp stdout lines and seed ``random``, numpy and torch (CPU and
    every card) with ``seed`` (general_utils.py:120-141); returns torch's
    default generator."""
    sys.stdout = _TimestampedStdout(sys.stdout, silent)
    random.seed(seed)
    np.random.seed(seed)
    return torch.manual_seed(seed)


def quantize(img: np.ndarray) -> np.ndarray:
    """[3, H, W] float -> [H, W, 3] uint8 as the JAX CLIs write their PNGs
    and the viewer socket sends its frames: clipped to [0, 1], times 255,
    truncated."""
    return (np.clip(img, 0, 1).transpose(1, 2, 0) * 255).astype(np.uint8)


def mkdir_p(folder_path: str):
    os.makedirs(folder_path, exist_ok=True)


def search_for_max_iteration(folder: str) -> int:
    """The largest ``<name>_<iteration>`` entry of ``folder``
    (system_utils.py:22-28): the iteration ``Scene`` loads for -1."""
    return max(int(f.split("_")[-1]) for f in os.listdir(folder))


searchForMaxIteration = search_for_max_iteration
