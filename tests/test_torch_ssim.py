"""SSIM's plain versions on the CPU: ``ssim_backward_plain`` (K8's adjoint
written out) against autograd of ``ssim_plain`` in float64, both against
the JAX package's ``ssim`` and its ``jax.grad`` in float32, and ``ssim`` on
CPU tensors taking the plain version.  The kernels themselves (K7, K8) are
held to these on the card by ``tests/test_torch_ssim_card.py``."""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from gsplat_tpu.train import losses as jL
from gsplat_tpu_torch.train import losses as tL


def _pair(rng, shape, dtype=np.float32):
    """An image in [0, 1] and a noisy copy of it, as a render and its
    target are."""
    a = rng.uniform(size=shape)
    b = np.clip(a + rng.standard_normal(shape) * 0.1, 0, 1)
    return a.astype(dtype), b.astype(dtype)


def test_backward_plain_matches_autograd_float64():
    """At a ragged 3x37x53 and at 1x9x9 (smaller than the window), with the
    upstream gradient the loss gives (-lambda_dssim)."""
    rng = np.random.default_rng(21)
    for shape in ((3, 37, 53), (1, 9, 9)):
        a, b = _pair(rng, shape, np.float64)
        x = torch.from_numpy(a).requires_grad_(True)
        y = torch.from_numpy(b)
        grad = torch.tensor(-0.2, dtype=torch.float64)
        (want,) = torch.autograd.grad(tL.ssim_plain(x, y), x, grad)
        got = tL.ssim_backward_plain(x.detach(), y, grad)
        assert got.dtype == torch.float64 and got.shape == x.shape
        torch.testing.assert_close(
            got, want, rtol=1e-10, atol=1e-12 * float(want.abs().max()),
            msg=lambda m: f"{shape}: {m}")


def test_plain_versions_match_jax():
    """ssim_plain and ssim_backward_plain in float32 against the JAX ssim
    and jax.grad of it on the same numpy inputs."""
    rng = np.random.default_rng(22)
    a, b = _pair(rng, (3, 37, 53))
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    np.testing.assert_allclose(float(tL.ssim_plain(ta, tb)),
                               float(jL.ssim(ja, jb)), rtol=1e-6)
    g_j = np.asarray(jax.grad(lambda x: jL.ssim(x, jb))(ja))
    g_t = tL.ssim_backward_plain(ta, tb, torch.tensor(1.0)).numpy()
    assert g_t.dtype == np.float32
    np.testing.assert_allclose(g_t, g_j, rtol=1e-4,
                               atol=1e-5 * np.abs(g_j).max())


def test_ssim_on_cpu_takes_the_plain_version():
    """Value and autograd gradient bit for bit those of ssim_plain."""
    rng = np.random.default_rng(23)
    a, b = _pair(rng, (3, 40, 56))
    y = torch.from_numpy(b)
    x1 = torch.from_numpy(a).requires_grad_(True)
    x2 = torch.from_numpy(a).requires_grad_(True)
    v1, v2 = tL.ssim(x1, y), tL.ssim_plain(x2, y)
    assert torch.equal(v1, v2)
    (g1,) = torch.autograd.grad(v1, x1)
    (g2,) = torch.autograd.grad(v2, x2)
    assert torch.equal(g1, g2)
