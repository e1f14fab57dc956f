"""Per-gaussian gradient reduction: kernel K4 (``csrc/segsum.cu``) and
``gather_rows``.

PyTorch + CUDA port of ``gsplat_tpu/ops/segment_reduce.py``.  The backward
pass leaves one gradient row per instance (one per (tile, gaussian) pair);
they reduce to per-gaussian rows by a stable sort of the gaussian ids (the
library sort, as the JAX package calls ``jax.lax.sort`` outside any kernel)
followed by K4, which finds each segment's first row in one pass over the
sorted ids (``segment_bounds_plain``) and sums the now contiguous segments
in index order with no atomics.  K4 reads its rows through the sort's
permutation, so only the ids are sorted and no sorted copy of the
``[I, R]`` rows is ever made.

The bf16 pair options of ``gather_rows`` (``grad_precision="bf16"``,
``packed_tail``) are plain torch around K4, as in the JAX package: the
per-instance rows are rounded to bf16 and the packed columns unpacked
before the f32 sum, and the per-gaussian sums of the packed columns are
packed again (``reduce_rows``).  The bit arithmetic runs on
``Tensor.view(torch.int32)``, whose wrapping adds and masks give the bits of
the JAX package's uint32 forms.
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


def segment_bounds_plain(sids, num_segments: int):
    """Plain version of K4's first pass: ``seg_start`` [num_segments + 1]
    int64, the first row of each segment of the sorted ``sids`` [I] (and
    after the last, the end of the kept rows), built as the kernel builds it:
    row i in [0, I] starts every segment s in ``(sids[i-1], sids[i]]``
    (``sids[-1]`` = -inf, ``sids[I]`` = +inf) clipped to
    ``[0, num_segments]``.  The kernel leaves the two end runs to a clamp
    (``csrc/segsum.cu``); the values it writes are these."""
    dev = sids.device
    I = sids.shape[0]
    s = sids.long()
    big = torch.tensor([1 << 40], dtype=torch.long, device=dev)
    lo = torch.cat([-big, s]) + 1                 # first segment of row i
    hi = torch.cat([s, big])                      # last segment of row i
    lo = torch.clamp(lo, 0, num_segments + 1)
    hi = torch.clamp(hi, -1, num_segments)
    n = torch.clamp(hi - lo + 1, min=0)           # [I + 1]
    rows = torch.repeat_interleave(torch.arange(I + 1, device=dev), n)
    first = torch.repeat_interleave(lo, n)
    offs = torch.arange(rows.shape[0], device=dev) - torch.repeat_interleave(
        torch.cumsum(n, 0) - n, n)
    seg_start = torch.empty(num_segments + 1, dtype=torch.long, device=dev)
    seg_start[first + offs] = rows
    return seg_start


def segment_sum_sorted(vals: torch.Tensor, sids: torch.Tensor,
                       num_segments: int,
                       perm: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K4 wrapper: sum the rows of ``vals`` [I, R] f32 by SORTED segment id
    ``sids`` [I] int32 into [num_segments, R]; ids outside
    ``[0, num_segments)`` are dropped padding.  With ``perm`` [I] int64 (a
    permutation of ``range(I)``, as ``torch.sort`` returns it) row i of the
    sorted order is ``vals[perm[i]]``.  A CPU tensor goes to
    ``segment_sum_sorted_plain``; a CUDA tensor launches ``csrc/segsum.cu``
    (its segment bounds pass and its sums, counted as one launch)."""
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
    # the segment bounds of the kernel's first pass
    scratch = torch.empty(lib.gsplat_segment_sum_scratch(num_segments),
                          dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        err = lib.gsplat_segment_sum(
            vals.data_ptr(), sids.data_ptr(),
            None if perm is None else perm.data_ptr(), I, R, num_segments,
            scratch.data_ptr(), out.data_ptr(), _kernels.stream_of(vals))
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


def round_bf16_bits(x: torch.Tensor) -> torch.Tensor:
    """f32 -> its round-to-nearest-even bf16 in the top 16 bits, as the f32
    word (composite_pallas.py::_round_bf16_bits :207-211): exact for every
    finite value, one that rounds past the largest bf16 becoming inf."""
    u = x.to(torch.float32).contiguous().view(torch.int32)
    return ((u + 0x7FFF + ((u >> 16) & 1)) & -65536).view(torch.float32)


def pack_bf16_pairs(x: torch.Tensor) -> torch.Tensor:
    """[I, R] f32 -> [I, ceil(R/2)] f32 words of RNE bf16 pairs: element
    2j in the high half, 2j+1 in the low half, a zero column after an odd
    width (segment_reduce.py::_pack_bf16_pairs :138)."""
    if x.shape[1] % 2:
        x = torch.cat([x, x.new_zeros((x.shape[0], 1))], dim=1)
    bits = round_bf16_bits(x).view(torch.int32)
    lo = (bits[:, 1::2] >> 16) & 0xFFFF
    return (bits[:, 0::2] | lo).contiguous().view(torch.float32)


def unpack_bf16_pairs(p: torch.Tensor, R: int) -> torch.Tensor:
    """Inverse of ``pack_bf16_pairs``: [I, ceil(R/2)] -> [I, R] f32, each
    bf16 as the f32 it extends (segment_reduce.py::_unpack_bf16_pairs
    :153): hi = word & 0xFFFF0000, lo = word << 16."""
    u = p.contiguous().view(torch.int32)
    both = torch.stack([u & -65536, u << 16], dim=2).reshape(u.shape[0], -1)
    return both.view(torch.float32)[:, :R]


def _check_options(grad_precision: str, packed_tail: int, width: int):
    _kernels.require(grad_precision in ("f32", "bf16"),
                     f"grad_precision must be 'f32' or 'bf16', got "
                     f"{grad_precision!r}")
    _kernels.require(0 <= packed_tail <= width,
                     f"packed_tail={packed_tail} outside [0, {width}]")


def reduce_rows(d_rows: torch.Tensor, idx: torch.Tensor, num_rows: int,
                grad_precision: str = "f32",
                packed_tail: int = 0) -> torch.Tensor:
    """The adjoint of ``table[idx]`` in ``gather_rows``' conventions
    (segment_reduce.py::_gr_bwd :190-220): [num_rows, R] from the rows
    ``d_rows`` [I, R].  ``grad_precision="bf16"`` rounds each of the plain
    columns (all but the last ``packed_tail``) to bf16; the last
    ``packed_tail`` columns hold bf16 pairs, unpacked here; the rows are
    then summed in f32 (the id sort and K4) and the sums of the packed
    columns packed again.  The JAX package carries the rounded and packed
    rows through its sort; here K4 reads the rows through the sort's
    permutation, so rounding each row before K4 is the same."""
    R = d_rows.shape[1]
    _check_options(grad_precision, packed_tail, R)
    n_plain = R - packed_tail
    vals = d_rows.to(torch.float32)
    plain = vals[:, :n_plain]
    if grad_precision == "bf16":
        plain = round_bf16_bits(plain)
    if packed_tail:
        vals = torch.cat([plain, unpack_bf16_pairs(vals[:, n_plain:],
                                                   2 * packed_tail)], dim=1)
    else:
        vals = plain
    d_table = scatter_add_rows(vals.contiguous(), idx, num_rows)
    if packed_tail:
        d_table = torch.cat([d_table[:, :n_plain],
                             pack_bf16_pairs(d_table[:, n_plain:])], dim=1)
    return d_table


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table, idx, grad_precision, packed_tail):
        ctx.save_for_backward(idx)
        ctx.num_rows = table.shape[0]
        ctx.grad_precision, ctx.packed_tail = grad_precision, packed_tail
        return table[idx.long()]

    @staticmethod
    def backward(ctx, d_out):
        (idx,) = ctx.saved_tensors
        d_table = reduce_rows(d_out, idx, ctx.num_rows, ctx.grad_precision,
                              ctx.packed_tail)
        return d_table, None, None, None


def gather_rows(table: torch.Tensor, idx: torch.Tensor,
                grad_precision: str = "f32", packed_tail: int = 0):
    """``table[idx]`` (table [P, R] f32, idx [I] int32 in [0, P)) whose
    backward is ``reduce_rows``: the sort + K4 reduction instead of a
    scatter-add, with ``grad_precision="bf16"`` rounding the per-instance
    rows to bf16 and the last ``packed_tail`` columns carrying bf16 pairs,
    in the cotangent as in the table (the JAX package's
    ``gather_rows``)."""
    _check_options(grad_precision, packed_tail, table.shape[1])
    return _GatherRows.apply(table, idx, grad_precision, packed_tail)
