"""The work a training step and a viewer frame need, and the least time an
H100 could take for it.

A frozen copy of the arithmetic of ``gsplat_tpu_torch/tools/workload.py``
(its per-pair operation counts, its peaks and its two operations a fused
multiply-add), applied to counts that the benchmark's own reference
(``splatbench/reference``) makes: the pairs a frame needs come from the
reference's preprocess, binning and compositing at the cell's cameras, never
from the program's binning, so a kernel's roofline reads the same work
whatever implements it.  Every count is of what the function needs, the
least any implementation does; a design's own costs (padding, culling,
per-instance rows reduced later) are not counted.
"""
from __future__ import annotations

# Published peaks of one H100 SXM at its 700 W limit (NVIDIA's data sheet).
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12          # float32 outside the tensor cores
# Base-2 exponentials on the special function units: 16 results a clock an
# SM (compute capability 9.0), 132 SMs at 1980 MHz.
SFU_RESULTS_PER_S = 132 * 16 * 1.98e9

# The forward composite per (pixel, instance) pair it must evaluate (a pair
# whose alpha passes the skip tests, composited or stopping the pixel):
# dx, dy (2), the power (9), the exponential's argument, the exponential,
# the opacity product and the cap (4) and the two skip tests (2); then the
# transmittance test (3); a composited pair also takes alpha T and a
# multiply-add per channel (1 + 2C).
K1_TEST_OPS = 17
K1_STEP_OPS = 3
# The backward composite per composited pair: the forward's 17 and the
# n_contrib gate, then 24 + 2C + 2Cg (the cotangent, the prefix and suffix,
# d alpha, d power, the five moment products, the transmittance, the
# feature products and one add per summed value).
K2_TEST_OPS = 18


def k2_pair_ops(C: int, Cg: int) -> int:
    return 24 + 2 * C + 2 * Cg


# Per visible gaussian, counted from the formulas of the reference's
# preprocess and rounded down: the view and projective transforms (42), the
# quaternion's normalisation and rotation (40), R S S^T R^T (45), the EWA
# Jacobian and 2D covariance (60), the conic, radius and rectangle (40),
# the direction and degree-3 SH colour (16 coefficients by 3 channels as
# multiply-adds, 96, the basis 30, the normalisation and clamp 15).
PRE_FWD_OPS = 368
# Its adjoint takes at least as many operations again.
PRE_BWD_OPS = 368
# Adam per parameter entry: the two moments (3 + 4) and the update (7).
ADAM_OPS = 14
# Per pixel and colour channel: L1 (3), SSIM's five maps by a separable
# 11-tap window (3 products, 5 maps x 2 passes x 11 taps x 2), its map (18)
# and mean (1); its adjoint through the three maps of the rendered image
# (3 x 2 x 11 x 2) and the map (30), L1's (2).
LOSS_CHANNEL_OPS = 3 + 3 + 220 + 18 + 1 + 132 + 30 + 2
# Per pixel: the depth term (max-normalise, inverse, L1: 8, adjoint 8) and
# the two-class cross-entropy (12, adjoint 8).
LOSS_PIXEL_OPS = 36
# The viewer's quantise per byte: clip (2), scale and truncate (2).
QUANT_OPS = 4


def bound_s(nbytes: float, nops: float, nexp: float = 0.0):
    """(seconds, "bytes" | "operations" | "exponentials"): the largest of
    the bytes over HBM, the operations over the fp32 rate and the
    exponentials over the SFU rate."""
    terms = {"bytes": nbytes / HBM_BYTES_PER_S,
             "operations": nops / FP32_OPS_PER_S,
             "exponentials": nexp / SFU_RESULTS_PER_S}
    by = max(terms, key=terms.get)
    return terms[by], by


def k1_work(c: dict, C: int, width: int, height: int, tiles: int) -> dict:
    """The forward composite of one frame: ``c`` holds the reference's
    counts (composited and stopping pairs, visible gaussians, instances).
    Bytes: each visible gaussian's row (mean, conic, opacity, C features)
    and each instance id read once, two words a tile, the C + 2 planes
    written once."""
    needed = c["composited"] + c["stopping"]
    ops = ((K1_TEST_OPS + K1_STEP_OPS) * needed
           + (1 + 2 * C) * c["composited"])
    nbytes = (c["visible"] * (6 + C) * 4 + c["instances"] * 4 + 8 * tiles
              + width * height * (C + 2) * 4)
    return dict(bytes=nbytes, ops=ops, exps=needed)


def k2_work(c: dict, C: int, Cg: int, width: int, height: int,
            tiles: int) -> dict:
    """The backward composite of one frame: the forward's inputs, its
    planes and their cotangents read once, one gradient row of 6 + Cg
    values a visible gaussian written once."""
    ops = (K2_TEST_OPS + k2_pair_ops(C, Cg)) * c["composited"]
    nbytes = (c["visible"] * (6 + C) * 4 + c["instances"] * 4 + 8 * tiles
              + 2 * width * height * (C + 2) * 4
              + c["visible"] * (6 + Cg) * 4)
    return dict(bytes=nbytes, ops=ops, exps=c["composited"])


def mean_counts(counts: list) -> dict:
    """The mean of per-camera count dicts."""
    return {k: sum(c[k] for c in counts) / len(counts) for k in counts[0]}


def step_work(c: dict, alive: int, entries: int, C: int, Cg: int,
              width: int, height: int, tiles: int) -> dict:
    """One training step at mean counts ``c``: its kernels' work and the
    operations of the whole step (preprocess and its adjoint, both
    composites, the per-gaussian sum of the composite's gradient, the
    losses and their adjoint, Adam over ``alive`` gaussians of ``entries``
    values each)."""
    k1 = k1_work(c, C, width, height, tiles)
    k2 = k2_work(c, C, Cg, width, height, tiles)
    pix = width * height
    ops = (k1["ops"] + k2["ops"]
           + (PRE_FWD_OPS + PRE_BWD_OPS) * c["visible"]
           + (6 + Cg) * c["instances"]
           + 3 * LOSS_CHANNEL_OPS * pix + LOSS_PIXEL_OPS * pix
           + ADAM_OPS * alive * entries)
    return dict(k1=k1, k2=k2, ops=ops)


def frame_work(c: dict, C: int, width: int, height: int, tiles: int) -> dict:
    """One viewer frame at counts ``c``: preprocess, the forward composite
    and the quantise of the frame's 3 H W bytes."""
    k1 = k1_work(c, C, width, height, tiles)
    ops = (k1["ops"] + PRE_FWD_OPS * c["visible"]
           + QUANT_OPS * 3 * width * height)
    return dict(k1=k1, ops=ops)
