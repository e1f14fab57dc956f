"""K3's merge-path partition and its plain versions on hand-built sources
(``tools/workload.py::k3_sources``): a run of empty sources across CTA
boundaries, a tie group cut by a diagonal, a source longer than several
CTAs, offsets past the capacity.  The partition's plain version is held CTA
by CTA to ``searchsorted``; ``expand_plain`` in both forms to the JAX
Pallas kernel (interpret mode) on the same sources."""
import numpy as np
import torch

from gsplat_tpu.ops import binning as jbin
from gsplat_tpu_torch.ops import binning as tbin
from gsplat_tpu_torch.tools import workload as wl

I = 8192


def _sources():
    return wl.k3_sources(I, n_empty=3000, long_len=5000)


def test_partition_plain_matches_searchsorted():
    src = _sources()
    off = src.offsets
    S = off.shape[0]
    # the merge's order, sources first on ties: source s sits at
    # s + min(offsets[s], I), strictly increasing in s
    place = torch.arange(S) + torch.clamp(off.long(), max=I)
    owner = torch.clamp(torch.searchsorted(
        off, torch.arange(I, dtype=torch.int32), right=True) - 1, min=0)
    assert int(off.max()) > I, "no offsets past the capacity"
    for items in (1, 7, 2048, 2044):
        part = tbin.expand_partition_plain(off, I, items)
        n = (S + I + items - 1) // items
        diag = torch.clamp(torch.arange(n + 1) * items, max=S + I)
        a = torch.searchsorted(place, diag)
        b = diag - a
        assert torch.equal(part.source_start.long(), a[:-1]), items
        assert torch.equal(part.slot_start.long(), b[:-1]), items
        assert int(b[-1]) == I and int(a[-1]) == S
        has = b[:-1] < b[1:]
        assert torch.equal(part.first_owner[has].long(),
                           owner[b[:-1][has]]), items
        assert part.probes > 0
    # the shapes the sources were built for, at K3's own CTA size (2044,
    # the last): a diagonal inside a tie group (the run of empty sources), a
    # CTA whose first slot that group's last source owns, a CTA inside one
    # source
    inner = a[1:-1][(a[1:-1] > 0) & (a[1:-1] < S)]
    assert bool((off[inner - 1] == off[inner]).any())
    assert bool((part.first_owner.long() >= a[:-1])[1:].any())
    assert bool((a[1:] == a[:-1]).any())


def test_expand_plain_matches_jax_kernel_on_handmade_sources():
    src = _sources()
    ty, gid, ext = tbin.expand_plain(*src.args(I), extras=src.extras)
    jt, jg = jbin._expand_pallas(
        src.offsets.numpy(), src.meta.numpy(), src.gid.numpy(), I,
        src.rw_bits, src.grid_x, src.num_tiles, interpret=True)
    np.testing.assert_array_equal(ty.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(gid.numpy(), np.asarray(jg))
    jt, jg, je = jbin._expand_pallas(
        src.offsets.numpy(), src.meta.numpy(), src.gid.numpy(), I,
        src.rw_bits, src.grid_x, src.num_tiles, interpret=True,
        extras=tuple(e for e in src.extras.numpy()))
    np.testing.assert_array_equal(ty.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(gid.numpy(), np.asarray(jg))
    np.testing.assert_array_equal(ext.numpy(), np.asarray(je))
    assert ext.shape == (8, I) and ext.dtype == torch.float32
