"""Port segment sum (K4's plain version on the CPU) and ``gather_rows``
against ``numpy.add.at`` and the JAX package's Pallas kernel in interpret
mode, on the same numpy inputs."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gsplat_tpu.ops import segment_reduce as jseg
from gsplat_tpu_torch.ops import segment_reduce as tseg

import torch_helpers  # noqa: F401  (thread count)


def _case(rng, I, P, R, n_pad=0, n_empty=0):
    """Sorted ids over [0, P) with ``n_pad`` dropped pad ids (== P) and the
    last ``n_empty`` segments left without rows."""
    ids = rng.integers(0, P - n_empty, I - n_pad)
    sids = np.sort(np.concatenate([ids, np.full(n_pad, P)])).astype(np.int32)
    vals = rng.standard_normal((I, R)).astype(np.float32)
    return sids, vals


def _add_at(sids, vals, P):
    want = np.zeros((P, vals.shape[1]), np.float32)
    keep = (sids >= 0) & (sids < P)
    np.add.at(want, sids[keep], vals[keep])
    return want


@pytest.mark.parametrize("n_pad,n_empty", [(0, 0), (100, 0), (64, 40)])
def test_segment_sum_matches_add_at_and_jax(n_pad, n_empty):
    rng = np.random.default_rng(300 + n_pad)
    I, P, R = 2048, 700, 12
    sids, vals = _case(rng, I, P, R, n_pad, n_empty)
    got = tseg.segment_sum_sorted(torch.from_numpy(vals),
                                  torch.from_numpy(sids), P).numpy()
    # float32 sums of a handful of N(0,1) rows in another order
    np.testing.assert_allclose(got, _add_at(sids, vals, P), atol=1e-5)
    want_j = np.asarray(jseg.segment_sum_sorted(
        jnp.asarray(vals), jnp.asarray(sids), P, interpret=True))
    # the JAX tests' tolerance against add.at (tests/test_segment_reduce.py)
    np.testing.assert_allclose(got, want_j, atol=1e-4)
    if n_empty:
        assert np.abs(got[P - n_empty:]).max() == 0.0


def test_segment_sum_through_permutation():
    """Unsorted rows read through the sort's permutation: the form the
    gather adjoint uses (ids sorted, rows left where they are)."""
    rng = np.random.default_rng(310)
    I, P, R = 1500, 400, 7
    idx = rng.integers(0, P + 1, I).astype(np.int32)       # P = pad sentinel
    vals = rng.standard_normal((I, R)).astype(np.float32)
    sids, perm = torch.sort(torch.from_numpy(idx), stable=True)
    got = tseg.segment_sum_sorted(torch.from_numpy(vals), sids, P, perm)
    np.testing.assert_allclose(got.numpy(), _add_at(idx, vals, P), atol=1e-5)
    np.testing.assert_array_equal(
        tseg.scatter_add_rows(torch.from_numpy(vals), torch.from_numpy(idx),
                              P).numpy(), got.numpy())


def test_gather_rows_grad_matches_jax():
    rng = np.random.default_rng(320)
    P, I, R = 500, 1536, 12
    table = rng.standard_normal((P, R)).astype(np.float32)
    idx = rng.integers(0, P, I).astype(np.int32)
    cot = rng.standard_normal((I, R)).astype(np.float32)

    g_j = np.asarray(jax.grad(lambda t: jnp.sum(
        jseg.gather_rows(t, jnp.asarray(idx), True) * jnp.asarray(cot)))(
            jnp.asarray(table)))
    t = torch.from_numpy(table).requires_grad_(True)
    rows = tseg.gather_rows(t, torch.from_numpy(idx))
    np.testing.assert_array_equal(rows.detach().numpy(), table[idx])
    (g_t,) = torch.autograd.grad((rows * torch.from_numpy(cot)).sum(), t)
    # tests/test_segment_reduce.py::test_gather_rows_grad_matches_scatter
    np.testing.assert_allclose(g_t.numpy(), g_j, rtol=1e-5, atol=1e-4)


def test_unported_options_and_bad_inputs_raise():
    table = torch.zeros((4, 3))
    idx = torch.zeros(8, dtype=torch.int32)
    # the bf16 pair options reduce (tests/test_torch_precision.py holds them
    # to the JAX package); an unknown precision or a tail wider than the
    # table is refused
    for kw in (dict(grad_precision="bf16"), dict(packed_tail=2)):
        t = table.clone().requires_grad_(True)
        (g,) = torch.autograd.grad(tseg.gather_rows(t, idx, **kw).sum(), t)
        assert g.shape == (4, 3) and torch.isfinite(g).all()
    with pytest.raises(ValueError, match="grad_precision"):
        tseg.gather_rows(table, idx, grad_precision="fp16")
    with pytest.raises(ValueError, match="packed_tail"):
        tseg.gather_rows(table, idx, packed_tail=4)
    vals = torch.zeros((8, 3))
    with pytest.raises(ValueError, match="int32"):
        tseg.segment_sum_sorted(vals, idx.long(), 4)
    with pytest.raises(ValueError, match="float32"):
        tseg.segment_sum_sorted(vals.double(), idx, 4)
    with pytest.raises(ValueError, match="int64"):
        tseg.segment_sum_sorted(vals, idx, 4, perm=idx)
