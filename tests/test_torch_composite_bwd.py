"""Port compositor gradients on the CPU: K2's plain version against
``torch.autograd`` through K1's plain version (an independent check), and
``rasterize`` gradients against ``jax.grad`` of the JAX Pallas path
(interpret mode), at the JAX tests' gradient tolerances
(tests/test_pallas_composite.py:73-137)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gsplat_tpu.ops.rasterize import RasterizeConfig as JCfg
from gsplat_tpu.ops.rasterize import rasterize as jrast
from gsplat_tpu_torch.ops import binning as tbin
from gsplat_tpu_torch.ops import composite_cuda as tcomp
from gsplat_tpu_torch.ops import segment_reduce as tseg
from gsplat_tpu_torch.ops.preprocess import TILE_X, TILE_Y
from gsplat_tpu_torch.ops.rasterize import RasterizeConfig, rasterize

from torch_helpers import (GAUSS_KEYS, cam_np, make_camera,
                           make_gaussians_np, preprocess_both, to_jax)


def _k1_inputs(g, W, H, C, seed, cap=1 << 13):
    """A [P, 6+C] table and the binning of a random cloud."""
    _, pre = preprocess_both(g, make_camera(W, H), W, H)
    gx, gy = (W + TILE_X - 1) // TILE_X, (H + TILE_Y - 1) // TILE_Y
    bins = tbin.bin_gaussians(pre, gx, gy, cap)
    assert not bool(bins.overflow)
    rng = np.random.default_rng(seed)
    P = pre.depths.shape[0]
    feats = torch.from_numpy(rng.uniform(0.1, 1.0, (P, C)).astype(np.float32))
    table = torch.cat([pre.means2d, pre.conic, pre.opacity[:, None], feats],
                      dim=1).contiguous()
    starts, counts = tcomp.tile_ranges(bins)
    return table, bins.gauss_id.contiguous(), starts, counts, gx


@pytest.mark.parametrize("Cg", [4, 5])
def test_backward_plain_matches_autograd_of_forward_plain(Cg):
    """K2's plain version, reduced per gaussian, equals autograd through
    K1's plain version; with Cg = C - 1 the last feature column gets no
    gradient row."""
    rng = np.random.default_rng(200)
    C = 5
    g = make_gaussians_np(rng, n=220)
    table, gid, starts, counts, gx = _k1_inputs(g, 64, 64, C, 201)
    P = table.shape[0]
    t = table.clone().requires_grad_(True)
    packed = tcomp.composite_forward_plain(t, gid, starts, counts, gx)
    cot = torch.from_numpy(rng.standard_normal(
        tuple(packed.shape)).astype(np.float32))
    cot[:, C + 1] = 7.0          # the n_contrib row's cotangent is ignored
    (want,) = torch.autograd.grad((packed[:, :C + 1] * cot[:, :C + 1]).sum(),
                                  t)
    d_inst = tcomp.composite_backward_plain(
        table, gid, starts, counts, gx, packed.detach(), cot, Cg)
    assert d_inst.shape == (gid.shape[0], 6 + Cg)
    assert torch.isfinite(d_inst).all()
    # pad slots (sentinel id P) carry zero rows
    assert float(d_inst[gid >= P].abs().max()) == 0.0
    got = tseg.scatter_add_rows(d_inst, gid, P).numpy()
    want = want.numpy()[:, :6 + Cg]
    for j in range(6 + Cg):
        scale = np.abs(want[:, j]).max() + 1e-12
        # float32 sums in another order (prefix by cumsum, per-pixel sums)
        np.testing.assert_allclose(got[:, j] / scale, want[:, j] / scale,
                                   atol=1e-4, err_msg=f"column {j}")

    # the Function: the same numbers through K1/K2's wrappers and the
    # gather adjoint, with a zero column for the constant feature
    t2 = table.clone().requires_grad_(True)
    packed2 = tcomp._Composite.apply(t2, gid, starts, counts, gx, Cg)
    (g2,) = torch.autograd.grad((packed2 * cot).sum(), t2)
    np.testing.assert_array_equal(g2.numpy()[:, :6 + Cg], got)
    assert float(g2[:, 6 + Cg:].abs().sum()) == 0.0


def _grads_both(g, W, H, num_class, loss_j, loss_t, max_instances):
    cam = make_camera(W, H)
    c = cam_np(cam)
    names = list(GAUSS_KEYS) + (["segments"] if num_class else []) + [
        "means2d_offset"]
    g = dict(g, means2d_offset=np.zeros((g["means3d"].shape[0], 2),
                                        np.float32))
    jcfg = JCfg(width=W, height=H, num_class=num_class,
                max_instances=max_instances, backend="pallas")
    tcfg = RasterizeConfig(width=W, height=H, num_class=num_class,
                           max_instances=max_instances)
    bg = np.array([0.1, 0.2, 0.3], np.float32)

    def jloss(p):
        out = jrast(jcfg, *[p[k] for k in GAUSS_KEYS], **to_jax(c),
                    bg=jnp.asarray(bg), segments=p.get("segments"),
                    means2d_offset=p["means2d_offset"])
        return loss_j(out)

    gj = jax.grad(jloss)({k: jnp.asarray(g[k]) for k in names})
    pt = {k: torch.from_numpy(g[k]).requires_grad_(True) for k in names}
    out = rasterize(tcfg, *[pt[k] for k in GAUSS_KEYS], **c, bg=bg,
                    segments=pt.get("segments"),
                    means2d_offset=pt["means2d_offset"], device="cpu")
    gt = torch.autograd.grad(loss_t(out), [pt[k] for k in names])
    return ({k: np.asarray(gj[k]) for k in names},
            {k: v.numpy() for k, v in zip(names, gt)})


def _assert_grads_close(gt, gj, atol):
    for k in gj:
        assert np.isfinite(gt[k]).all(), k
        scale = np.abs(gj[k]).max() + 1e-12
        assert scale > 1e-9, f"{k}: the reference gradient is all zero"
        np.testing.assert_allclose(gt[k] / scale, gj[k] / scale, atol=atol,
                                   err_msg=f"rasterize grad mismatch for {k}")


def test_rasterize_gradients_match_jax_single_chunk():
    """All seven inputs, every composited channel and T_final in the loss
    (scaled atol 1e-3, tests/test_pallas_composite.py:96-100)."""
    rng = np.random.default_rng(210)
    W, H = 48, 32
    g = make_gaussians_np(rng, n=150, num_class=2)
    tgt = rng.uniform(size=(3, H, W)).astype(np.float32)
    wseg = rng.uniform(size=(2, H, W)).astype(np.float32)

    def loss_j(out):
        return (jnp.mean((out["render"] - jnp.asarray(tgt)) ** 2)
                + 0.05 * jnp.mean(out["depth"])
                + 0.02 * jnp.mean(out["alpha"])
                + 0.03 * jnp.mean(out["segment"] * jnp.asarray(wseg)))

    def loss_t(out):
        return (torch.mean((out["render"] - torch.from_numpy(tgt)) ** 2)
                + 0.05 * torch.mean(out["depth"])
                + 0.02 * torch.mean(out["alpha"])
                + 0.03 * torch.mean(out["segment"] * torch.from_numpy(wseg)))

    gj, gt = _grads_both(g, W, H, 2, loss_j, loss_t, 1 << 13)
    _assert_grads_close(gt, gj, 1e-3)


def test_rasterize_gradients_match_jax_multichunk_termination():
    """Several 128-instance chunks per tile and an opaque front layer that
    ends pixels early (scaled atol 2e-3,
    tests/test_pallas_composite.py:103-137)."""
    rng = np.random.default_rng(220)
    n = 600
    g = make_gaussians_np(rng, n=n, spread=0.5)
    g["scales"] = (np.array([0.3, 0.12, 0.2], np.float32)[None]
                   * np.exp(rng.standard_normal((n, 3)).astype(np.float32)
                            * 0.2))
    op = np.full(n, 0.4, np.float32)
    op[:50] = 0.97
    g["opacities"] = op
    tgt = rng.uniform(size=(3, 32, 32)).astype(np.float32)

    def loss_j(out):
        return jnp.mean(jnp.abs(out["render"] - jnp.asarray(tgt)))

    def loss_t(out):
        return torch.mean(torch.abs(out["render"] - torch.from_numpy(tgt)))

    gj, gt = _grads_both(g, 32, 32, 0, loss_j, loss_t, 1 << 15)
    _assert_grads_close(gt, gj, 2e-3)


def test_clamped_alpha_passes_no_gradient():
    """The 0.99 cap is a true min: a pixel where opacity * G >= 0.99 passes
    no gradient to opacity, conic or mean2d; below the cap it does."""
    C = 3
    gx = 1
    i32 = dict(dtype=torch.int32)
    gid = torch.zeros(128, **i32)
    gid[1:] = 1                                    # pad sentinel (P = 1)
    starts = torch.tensor([0], **i32)
    counts = torch.tensor([1], **i32)
    cx, cy = TILE_X // 2, TILE_Y // 2
    grads = {}
    for name, opacity in (("capped", 0.999), ("free", 0.5)):
        table = torch.tensor([[float(cx), float(cy), 1e-5, 0.0, 1e-5,
                               opacity, 0.3, 0.6, 0.9]])
        packed = tcomp.composite_forward_plain(table, gid, starts, counts, gx)
        cot = torch.zeros_like(packed)
        cot[0, :C] = 1.0
        grads[name] = tcomp.composite_backward_plain(
            table, gid, starts, counts, gx, packed, cot, C)[0]
    # G >= 0.997 over the whole tile, so 0.999 * G >= 0.99 everywhere
    assert float(grads["capped"][:6].abs().max()) == 0.0
    assert float(grads["capped"][6:].min()) > 0.0   # features still learn
    assert float(grads["free"][5]) > 0.0
    assert float(grads["free"][2:5].abs().max()) > 0.0
