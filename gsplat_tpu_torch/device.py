"""Device selection for the port's entry points.

Every entry point takes ``device="cuda"`` by default.  The CPU is used only
when the caller asks for it (the tests do); a CUDA request on a machine
without a usable GPU raises instead of quietly running elsewhere.
"""
from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "gsplat_tpu_torch: a CUDA device was requested but "
            "torch.cuda.is_available() is False; pass device='cpu' to run "
            "the plain PyTorch versions on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}")
    return dev


def check_on(device: torch.device, **tensors):
    """Raise unless every given tensor lies on ``device`` (None is skipped)."""
    for name, t in tensors.items():
        if t is not None and t.device.type != device.type:
            raise ValueError(
                f"{name} is on {t.device}, expected {device}; move the model "
                "or pass a matching device=")
