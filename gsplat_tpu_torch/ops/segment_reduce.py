"""Per-gaussian gradient reduction: kernel K4 (``csrc/segsum.cu``) and
``gather_rows``.

PyTorch + CUDA port of ``gsplat_tpu/ops/segment_reduce.py``.  The backward
pass leaves one gradient row per instance (one per (tile, gaussian) pair);
they reduce to per-gaussian rows by a stable sort of the gaussian ids (the
library sort, as the JAX package calls ``jax.lax.sort`` outside any kernel)
followed by K4, which sums the now contiguous segments in index order with
no atomics.  K4 reads its rows through the sort's permutation, so only the
ids are sorted and no sorted copy of the ``[I, R]`` rows is ever made.

Only ``grad_precision="f32"`` and ``packed_tail=0`` are ported; the bf16
pair options raise (ROADMAP.md, Queue 1).
"""
from __future__ import annotations

from typing import Optional

import torch

from gsplat_tpu_torch import _kernels


def segment_sum_sorted_plain(vals, sids, num_segments: int, perm=None):
    """Plain PyTorch version of K4: one ``index_add_`` with the dropped ids
    (outside ``[0, num_segments)``) masked to zero rows."""
    rows = vals if perm is None else vals[perm]
    keep = (sids >= 0) & (sids < num_segments)
    out = torch.zeros((num_segments, vals.shape[1]), dtype=vals.dtype,
                      device=vals.device)
    out.index_add_(0, torch.where(keep, sids, 0).long(),
                   torch.where(keep[:, None], rows, 0.0))
    return out


def segment_sum_sorted(vals: torch.Tensor, sids: torch.Tensor,
                       num_segments: int,
                       perm: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K4 wrapper: sum the rows of ``vals`` [I, R] f32 by SORTED segment id
    ``sids`` [I] int32 into [num_segments, R]; ids outside
    ``[0, num_segments)`` are dropped padding.  With ``perm`` [I] int64 (a
    permutation of ``range(I)``, as ``torch.sort`` returns it) row i of the
    sorted order is ``vals[perm[i]]``.  A CPU tensor goes to
    ``segment_sum_sorted_plain``; a CUDA tensor launches ``csrc/segsum.cu``."""
    dev = vals.device
    req = _kernels.require
    req(vals.dtype == torch.float32, f"vals must be float32, got {vals.dtype}")
    req(vals.dim() == 2, f"vals must be [I, R], got {tuple(vals.shape)}")
    req(vals.is_contiguous(), "vals must be contiguous")
    I, R = vals.shape
    _kernels.check_int32_vector("sids", sids, dev, I)
    req(num_segments >= 0, f"num_segments must be >= 0, got {num_segments}")
    if perm is not None:
        req(perm.dtype == torch.int64, f"perm must be int64, got {perm.dtype}")
        req(perm.shape == (I,) and perm.is_contiguous(),
            f"perm must be a contiguous [{I}] vector")
        req(perm.device == dev, f"perm is on {perm.device}, expected {dev}")
    if dev.type == "cpu":
        return segment_sum_sorted_plain(vals, sids, num_segments, perm)
    req(dev.type == "cuda", f"unsupported device {dev}")
    out = torch.empty((num_segments, R), dtype=torch.float32, device=dev)
    lib = _kernels.lib()
    with torch.cuda.device(dev):
        err = lib.gsplat_segment_sum(
            vals.data_ptr(), sids.data_ptr(),
            None if perm is None else perm.data_ptr(), I, R, num_segments,
            out.data_ptr(), _kernels.stream_of(vals))
    _kernels.check(err, "segment_sum_sorted")
    _kernels.launch_counts["segment_sum"] += 1
    return out


def scatter_add_rows(d_rows: torch.Tensor, idx: torch.Tensor,
                     num_rows: int) -> torch.Tensor:
    """The adjoint of ``table[idx]``: ``out[p] = sum of d_rows[i] over
    idx[i] == p``, [num_rows, R], as a stable sort of ``idx`` and K4 through
    the sort's permutation.  Ids outside ``[0, num_rows)`` (the pad
    sentinel) are dropped."""
    sids, perm = torch.sort(idx, stable=True)
    return segment_sum_sorted(d_rows, sids, num_rows, perm)


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table, idx):
        ctx.save_for_backward(idx)
        ctx.num_rows = table.shape[0]
        return table[idx.long()]

    @staticmethod
    def backward(ctx, d_out):
        (idx,) = ctx.saved_tensors
        d_table = scatter_add_rows(
            d_out.to(torch.float32).contiguous(), idx, ctx.num_rows)
        return d_table, None


def gather_rows(table: torch.Tensor, idx: torch.Tensor,
                grad_precision: str = "f32", packed_tail: int = 0):
    """``table[idx]`` (table [P, R] f32, idx [I] int32 in [0, P)) whose
    backward is the sort + K4 reduction instead of a scatter-add."""
    if grad_precision != "f32" or packed_tail != 0:
        raise NotImplementedError(
            f"gather_rows(grad_precision={grad_precision!r}, packed_tail="
            f"{packed_tail}): the bf16 pair options are not ported yet; see "
            "ROADMAP.md, Queue 1")
    return _GatherRows.apply(table, idx)
