"""The numbers that decide ``correct``: what the timed path produced against
the plain reference, each held to its limit from
``splatbench/checks/<cell>.json``."""
from __future__ import annotations

import math
import statistics

import numpy as np
import torch

from splatbench.reference import splat

# a leaf whose reference gradient is under this share of the median leaf's
# moves by round-off alone under Adam and is left out of the comparison
NOUGHT = 1e-3


def leaf_norms(tree) -> dict:
    """Per field, the L2 norm (float64) of its tensor."""
    return {f: float(torch.linalg.vector_norm(x.double()))
            for f, x in zip(splat.FIELDS, tree)}


def norm_gap(got: dict, want: dict, ref_grad: dict) -> float:
    """The worst leaf's |norm - reference norm| over the larger of its
    reference norm and the median leaf's, over the leaves whose reference
    gradient is not nought."""
    med = statistics.median(want.values())
    gmed = statistics.median(ref_grad.values())
    gaps = [abs(got[f] - want[f]) / max(want[f], med, 1e-30)
            for f in want if ref_grad[f] >= NOUGHT * gmed]
    return max(gaps)


def train_numbers(prog: dict, ref: dict) -> dict:
    """prog and ref: dict(losses [3], grad {field: norm} of the first
    step's gradient, change {field: norm} of the parameters after three)."""
    loss = max(abs(a - b) / max(abs(b), 1e-30)
               for a, b in zip(prog["losses"], ref["losses"]))
    return dict(loss_gap=loss,
                grad_gap=norm_gap(prog["grad"], ref["grad"], ref["grad"]),
                change_gap=norm_gap(prog["change"], ref["change"],
                                    ref["grad"]))


def quantize(image) -> np.ndarray:
    """[3,H,W] float -> [H,W,3] uint8: clipped to [0, 1], times 255,
    truncated (the viewer's wire format)."""
    x = image.detach().float().clamp(0, 1).permute(1, 2, 0) * 255
    return x.to(torch.uint8).cpu().numpy()


def frame_numbers(image, frame: np.ndarray, ref_image) -> dict:
    """image_gap: the L2 distance of the rgb frame from the reference's
    over the reference's norm; byte_share: the share of the frame's bytes
    more than one level from the reference quantised the same way."""
    a = image.detach().double()
    b = ref_image.detach().double().to(a.device)
    img = float(torch.linalg.vector_norm(a - b)
                / torch.linalg.vector_norm(b).clamp_min(1e-30))
    want = quantize(ref_image).astype(np.int16)
    got = np.asarray(frame, dtype=np.uint8).reshape(want.shape)
    share = float(np.mean(np.abs(got.astype(np.int16) - want) > 1))
    return dict(image_gap=img, byte_share=share)


def worst(rows: list) -> dict:
    return {k: max(r[k] for r in rows) for k in rows[0]}


def judge(numbers: dict, limits: dict) -> tuple:
    """(correct, {name: {"value", "limit"}}): every number finite and at or
    under its limit."""
    out, ok = {}, True
    for name, limit in limits.items():
        v = numbers.get(name, math.nan)
        ok = ok and math.isfinite(v) and v <= limit
        out[name] = {"value": v, "limit": limit}
    return ok, out
