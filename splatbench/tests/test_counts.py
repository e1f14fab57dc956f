"""The frozen counts of ``splatbench/counts`` against
``gsplat_tpu_torch/tools/workload.py``: the same constants and bounds, and
on a small scene the reference's composited and stopping pairs equal to
those of the port's K1 walk (its plain version)."""
import math

import torch

from conftest import ROOT, tiny
from splatbench.counts import work
from splatbench.harness import scene
from splatbench.reference import camera, splat


def test_constants_and_bound_match_workload():
    from gsplat_tpu_torch.tools import workload as wl
    for name in ("HBM_BYTES_PER_S", "FP32_OPS_PER_S", "SFU_RESULTS_PER_S",
                 "K1_TEST_OPS", "K1_STEP_OPS", "K2_TEST_OPS"):
        assert getattr(work, name) == getattr(wl, name), name
    assert work.k2_pair_ops(7, 6) == wl.k2_pair_ops(7, 6)
    for b, o, e in ((1e9, 1e9, 1e9), (1e6, 1e12, 0), (0, 1e6, 1e12)):
        s, by = work.bound_s(b, o, e)
        ms, by_wl = wl.bound_ms(b, o, nexp=e)
        assert math.isclose(s * 1e3, ms, rel_tol=1e-12) and by == by_wl


def test_pair_counts_match_port_walk():
    from gsplat_tpu_torch.core import transforms as T
    from gsplat_tpu_torch.ops import binning as bin_lib
    from gsplat_tpu_torch.ops import composite_cuda as comp
    from gsplat_tpu_torch.ops import preprocess as pre_lib
    from gsplat_tpu_torch.tools import workload as wl
    cell = tiny("trained262k.view", 2000)
    cfg = cell.config
    W, H = cfg["width"], cfg["height"]
    p = scene.load(cfg, ROOT, "cpu")
    pose = camera.poses(cell.traffic["poses"], W, H)[1]
    counts = {}
    splat.render(p, camera.cam(pose, W, H, "cpu"), 3, torch.zeros(3),
                 counts=counts)
    view, full, centre = camera.matrices(pose, W, H)
    pre = pre_lib.preprocess(
        p.xyz, T.scaling_activation(p.scaling), p.rotation,
        T.opacity_activation(p.opacity[:, 0]),
        torch.cat([p.features_dc, p.features_rest], 1), 3,
        torch.as_tensor(view), torch.as_tensor(full), torch.as_tensor(centre),
        pose_tan(pose["fovx"]), pose_tan(pose["fovy"]), W, H)
    gx, gy = -(-W // pre_lib.TILE_X), -(-H // pre_lib.TILE_Y)
    bins = bin_lib.bin_gaussians(pre, gx, gy, 1 << 18)
    feats = torch.cat([pre.rgb, pre.depths[:, None],
                       T.segment_activation(p.segment),
                       torch.ones_like(pre.depths[:, None])], 1)
    table = torch.cat([pre.means2d, pre.conic, pre.opacity[:, None], feats],
                      1).contiguous()
    starts, cnt = comp.tile_ranges(bins)
    args = (table, bins.gauss_id.contiguous(), starts, cnt, gx)
    packed = comp.composite_forward_plain(*args)
    port = wl.k1_pair_counts(*args, packed[:, feats.shape[1] + 1])
    assert counts["composited"] > 0
    assert counts["composited"] == port["composited"]
    assert counts["stopping"] == port["stopping"]
    assert counts["visible"] == int(pre.visible.sum())


def pose_tan(fov):
    return math.tan(fov * 0.5)
