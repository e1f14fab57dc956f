"""The bf16 pair numerics of the port on the CPU against the JAX package:
the pack, unpack and round helpers bit for bit, ``gather_rows``' forward
and adjoint with ``grad_precision`` and ``packed_tail``, the ``pack_feats``
adjoint, and the finite half of the composite backward's scrub
(composite_pallas.py:666-677) in the f32 and the packed form."""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from gsplat_tpu.ops import composite_pallas as jcp
from gsplat_tpu.ops import segment_reduce as jseg
from gsplat_tpu.ops.rasterize import RasterizeConfig as JCfg
from gsplat_tpu.ops.rasterize import rasterize as jrast
from gsplat_tpu_torch.ops import composite_cuda as tcomp
from gsplat_tpu_torch.ops import segment_reduce as tseg
from gsplat_tpu_torch.ops.rasterize import RasterizeConfig, rasterize

from torch_helpers import (GAUSS_KEYS, cam_np, make_camera, make_gaussians_np,
                           to_jax)


def _bits(x):
    return np.ascontiguousarray(np.asarray(x, np.float32)).view(np.uint32)


def _values(rng, shape):
    """Finite normal float32 values over a wide exponent range, both signs,
    a third of them exact ties of the bf16 rounding (low 16 bits 0x8000)
    with the bit above both even and odd."""
    x = (rng.standard_normal(shape)
         * np.exp2(rng.integers(-60, 60, shape))).astype(np.float32)
    u = x.view(np.uint32)
    tie = rng.uniform(size=shape) < 1 / 3
    u[tie] = (u[tie] & np.uint32(0xFFFF0000)) | np.uint32(0x8000)
    return u.view(np.float32)


def _within_bf16_ulp(got, want):
    """Packed words, unpacked: each value within one bf16 ulp of the
    other's (the RNE of f32 sums that differ in their last bits)."""
    a = np.asarray(got, np.float64)
    b = np.asarray(want, np.float64)
    mag = np.maximum(np.abs(a), np.abs(b))
    ulp = np.exp2(np.floor(np.log2(np.where(mag > 0, mag, 1.0))) - 7)
    assert (np.abs(a - b) <= ulp).all(), float(np.abs(a - b).max())


def test_bf16_pair_helpers_bit_equal_to_jax():
    rng = np.random.default_rng(600)
    x = _values(rng, (64, 9))
    assert np.isfinite(x).all()
    want = np.asarray(jcp._round_bf16_bits(jnp.asarray(x)))
    got = tseg.round_bf16_bits(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(_bits(got), want)
    for R in (9, 8, 5, 1):                  # odd widths get a zero column
        xr = np.ascontiguousarray(x[:, :R])
        pj = np.asarray(jseg._pack_bf16_pairs(jnp.asarray(xr)))
        pt = tseg.pack_bf16_pairs(torch.from_numpy(xr)).numpy()
        assert pt.shape == (64, (R + 1) // 2)
        np.testing.assert_array_equal(_bits(pt), _bits(pj))
        uj = np.asarray(jseg._unpack_bf16_pairs(jnp.asarray(pj), R))
        ut = tseg.unpack_bf16_pairs(torch.from_numpy(pt), R).numpy()
        np.testing.assert_array_equal(_bits(ut), _bits(uj))
        # unpacking the packed words gives each value's RNE bf16
        np.testing.assert_array_equal(_bits(ut), want[:, :R])
    # arbitrary words unpack as JAX unpacks them
    words = _values(rng, (32, 4))
    np.testing.assert_array_equal(
        _bits(tseg.unpack_bf16_pairs(torch.from_numpy(words), 7).numpy()),
        _bits(jseg._unpack_bf16_pairs(jnp.asarray(words), 7)))


def test_gather_rows_forward_and_adjoint_match_jax():
    """``grad_precision`` in {f32, bf16} x ``packed_tail`` in {0, 2}: the
    rows equal ``table[idx]``, the plain columns of the adjoint within
    rtol 1e-6 of the JAX package's (f32 sums of the same rounded rows in
    another order), the repacked tail within one bf16 ulp."""
    rng = np.random.default_rng(610)
    P, I, R = 300, 1024, 8
    idx = rng.integers(0, P, I).astype(np.int32)
    table = rng.standard_normal((P, R)).astype(np.float32)
    for prec in ("f32", "bf16"):
        for tail in (0, 2):
            cot = rng.standard_normal((I, R)).astype(np.float32)
            if tail:      # the tail's cotangent is packed, as the table's
                cot[:, R - tail:] = np.asarray(jseg._pack_bf16_pairs(
                    jnp.asarray(rng.standard_normal((I, 2 * tail))
                                .astype(np.float32))))

            def jloss(t):
                rows = jseg.gather_rows(t, jnp.asarray(idx), True, prec, tail)
                return jnp.sum(rows * jnp.asarray(cot)), rows

            (_, rows_j), vjp = jax.vjp(jloss, jnp.asarray(table))
            (g_j,) = vjp((jnp.float32(1.0), jnp.zeros_like(rows_j)))
            t = torch.from_numpy(table).requires_grad_(True)
            rows_t = tseg.gather_rows(t, torch.from_numpy(idx), prec, tail)
            np.testing.assert_array_equal(rows_t.detach().numpy(),
                                          table[idx])
            (g_t,) = torch.autograd.grad(rows_t, t, torch.from_numpy(cot))
            g_t, g_j = g_t.numpy(), np.asarray(g_j)
            n = R - tail
            np.testing.assert_allclose(g_t[:, :n], g_j[:, :n], rtol=1e-6,
                                       atol=1e-6, err_msg=f"{prec} {tail}")
            if tail:
                _within_bf16_ulp(
                    tseg.unpack_bf16_pairs(torch.from_numpy(
                        np.ascontiguousarray(g_t[:, n:])), 2 * tail).numpy(),
                    jseg._unpack_bf16_pairs(jnp.asarray(g_j[:, n:]),
                                            2 * tail))
            if prec == "bf16":     # the rounding happened
                g32 = np.zeros((P, n), np.float32)
                np.add.at(g32, idx, cot[:, :n])
                assert not np.allclose(g_t[:, :n], g32, rtol=1e-6, atol=0)


def test_pack_feats_adjoint_matches_jax():
    rng = np.random.default_rng(620)
    P, Cg = 40, 5
    feats = _values(rng, (P, Cg))
    d_packed = np.array(jseg._pack_bf16_pairs(jnp.asarray(
        rng.standard_normal((P, Cg)).astype(np.float32))))
    out_j, vjp = jax.vjp(lambda f: jcp.pack_feats(f, Cg), jnp.asarray(feats))
    (d_j,) = vjp(jnp.asarray(d_packed))
    f_t = torch.from_numpy(feats).requires_grad_(True)
    out_t = tcomp.pack_feats(f_t, Cg)
    np.testing.assert_array_equal(_bits(out_t.detach().numpy()),
                                  _bits(out_j))
    (d_t,) = torch.autograd.grad(out_t, f_t, torch.from_numpy(d_packed))
    np.testing.assert_array_equal(_bits(d_t.numpy()), _bits(d_j))


def test_nonfinite_instance_gradients_scrubbed_like_jax():
    """One pixel of T_final's cotangent is inf: the pairs composited there
    get non-finite d alpha, so their instances' geometry rows are
    non-finite.  The JAX backward zeroes non-finite per-instance values
    before the reduction (the packed feature words exempt), and so does
    the port: the input gradients of both are finite and agree at the
    gradient tolerance of tests/test_torch_composite_bwd.py (1e-3 of each
    input's largest), in the f32 and the packed form."""
    rng = np.random.default_rng(630)
    W, H = 64, 48
    g = make_gaussians_np(rng, n=220, num_class=2)
    c = cam_np(make_camera(W, H))
    bg = np.array([0.1, 0.2, 0.3], np.float32)
    wt = rng.uniform(size=(H, W)).astype(np.float32)
    wt[20, 30] = np.inf
    wseg = rng.uniform(size=(2, H, W)).astype(np.float32)
    names = list(GAUSS_KEYS) + ["segments"]
    for kw in (dict(), dict(feat_precision="bf16", grad_precision="bf16")):
        jcfg = JCfg(width=W, height=H, num_class=2, max_instances=1 << 13,
                    backend="pallas", **kw)
        tcfg = RasterizeConfig(width=W, height=H, num_class=2,
                               max_instances=1 << 13, **kw)

        def jloss(p):
            out = jrast(jcfg, *[p[k] for k in GAUSS_KEYS], **to_jax(c),
                        bg=jnp.asarray(bg), segments=p["segments"])
            return (jnp.sum(out["T_final"] * jnp.asarray(wt))
                    + jnp.sum(out["render"] ** 2)
                    + jnp.sum(out["segment"] * jnp.asarray(wseg)))

        gj = jax.grad(jloss)({k: jnp.asarray(g[k]) for k in names})
        pt = {k: torch.from_numpy(g[k]).requires_grad_(True) for k in names}
        out = rasterize(tcfg, *[pt[k] for k in GAUSS_KEYS], **c, bg=bg,
                        segments=pt["segments"], device="cpu")
        loss = (torch.sum(out["T_final"] * torch.from_numpy(wt))
                + torch.sum(out["render"] ** 2)
                + torch.sum(out["segment"] * torch.from_numpy(wseg)))
        gt = torch.autograd.grad(loss, [pt[k] for k in names])
        for k, v in zip(names, gt):
            want = np.asarray(gj[k])
            assert np.isfinite(want).all(), (kw, k)
            assert torch.isfinite(v).all(), (kw, k)
            scale = np.abs(want).max()
            assert scale > 0, (kw, k)
            np.testing.assert_allclose(v.numpy() / scale, want / scale,
                                       atol=1e-3, err_msg=f"{kw} {k}")
