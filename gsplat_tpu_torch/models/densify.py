"""Adaptive density control: clone / split / prune / opacity reset.

PyTorch port of ``gsplat_tpu/models/densify.py``.  Behavioral spec:
reference scene/gaussian_model.py:438-526 (densify_and_clone,
densify_and_split, densify_and_prune, add_densification_stats,
reset_opacity) and the train-loop schedule (train.py:169-180).

As in the JAX package, parameters never change shape.  Clones and splits are
scattered into FREE SLOTS of the fixed-capacity tensors, candidates beyond
the free slots are dropped and counted; pruning clears the alive mask and
parks the row (opacity -> -30 logit, xyz -> 1e8) so the rasterizer's frustum
and alpha tests skip it.  Selection masks are all computed from the state at
entry, which reproduces the reference's clone-then-split-then-prune ordering
(clones never split in the same call because their grad stats are 0).

Every function returns new tensors and leaves its inputs as they were; none
reads a value back to the host.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from gsplat_tpu_torch.core import transforms as T
from gsplat_tpu_torch.models import adam
from gsplat_tpu_torch.models.gaussians import (
    DEAD_OPACITY_LOGIT, DEAD_XYZ, GaussianAux, GaussianParams,
)


class DensifyStats(NamedTuple):
    n_cloned: torch.Tensor
    n_split: torch.Tensor
    n_pruned: torch.Tensor
    n_dropped: torch.Tensor  # densify candidates lost to capacity overflow
    n_alive: torch.Tensor


def add_densification_stats(aux: GaussianAux, grad_means2d_ndc: torch.Tensor,
                            radii: torch.Tensor) -> GaussianAux:
    """Accumulate screen-space positional gradient norms for visible
    gaussians and track max screen radius (train.py:171-172,
    gaussian_model.py:523-526).

    ``grad_means2d_ndc`` is the pixel-space mean2d gradient already rescaled
    by (0.5*W, 0.5*H), the NDC units the 2e-4 threshold is calibrated for
    (backward.cu:627-628)."""
    vis = radii > 0
    g = grad_means2d_ndc[:, :2]
    gnorm = torch.sqrt(torch.sum(g * g, dim=-1))
    return aux._replace(
        xyz_gradient_accum=aux.xyz_gradient_accum + torch.where(vis, gnorm, 0.0),
        denom=aux.denom + vis.to(torch.float32),
        max_radii2d=torch.where(
            vis, torch.maximum(aux.max_radii2d, radii.to(torch.float32)),
            aux.max_radii2d),
    )


def _park_dead(params: GaussianParams, dead_mask) -> GaussianParams:
    m1 = dead_mask[:, None]
    return params._replace(
        xyz=torch.where(m1, DEAD_XYZ, params.xyz),
        opacity=torch.where(m1, DEAD_OPACITY_LOGIT, params.opacity),
    )


def _scatter_rows(tree, tgt, src_tree):
    """Write src row i to slot tgt[i]; tgt == capacity drops the row (it
    lands in a scratch row that is cut off again)."""
    def scatter(x, s):
        return torch.cat([x, x[:1]]).index_copy_(0, tgt, s)[:-1]
    return adam.tree_map(scatter, tree, src_tree)


def densify_and_prune(
    params: GaussianParams,
    aux: GaussianAux,
    opt_state: adam.AdamState,
    max_grad: float,
    min_opacity: float,
    extent,
    max_screen_size,
    percent_dense: float,
    use_screen_size: bool,
    vs_prune: bool = False,
    generator: Optional[torch.Generator] = None,
    noise: Optional[torch.Tensor] = None,
):
    """Returns (params, aux, opt_state, DensifyStats).  The split samples
    are standard normal draws [2, capacity, 3]: ``noise`` if given (a test
    hands both packages the same numbers), else drawn from ``generator``
    (or the default generator) on the parameters' device."""
    C = params.xyz.shape[0]
    dev = params.xyz.device
    alive = aux.alive

    grads = torch.where(aux.denom > 0, aux.xyz_gradient_accum / aux.denom, 0.0)
    grads = torch.where(torch.isnan(grads), 0.0, grads)

    scaling = T.scaling_activation(params.scaling)
    max_scale = torch.max(scaling, dim=1).values
    grad_ok = alive & (grads >= max_grad)
    sel_clone = grad_ok & (max_scale <= percent_dense * extent)
    sel_split = grad_ok & (max_scale > percent_dense * extent)

    # Free-slot list: stable ascending sort of alive (False first).
    free_slots = torch.argsort(alive.to(torch.uint8), stable=True)  # [C]
    n_free = C - torch.sum(alive)

    # --- clone (gaussian_model.py:491-507): exact copies -------------------
    rank_c = torch.cumsum(sel_clone, dim=0) - 1
    n_clone = torch.sum(sel_clone)
    ok_c = sel_clone & (rank_c < n_free)
    tgt_c = torch.where(ok_c, free_slots[torch.clamp(rank_c, 0, C - 1)], C)
    params = _scatter_rows(params, tgt_c, params)

    # --- split (gaussian_model.py:461-489): N=2 samples from own gaussian --
    N = 2
    rank_s = torch.cumsum(sel_split, dim=0) - 1
    n_split = torch.sum(sel_split)
    if noise is None:
        noise = torch.randn((N, C, 3), generator=generator, device=dev)
    R = T.quat_to_rotmat(params.rotation)  # [C,3,3]
    new_scaling = torch.log(scaling / (0.8 * N))

    def split_rows(which):
        samples = noise[which] * scaling
        new_xyz = torch.einsum("cij,cj->ci", R, samples) + params.xyz
        src = params._replace(xyz=new_xyz, scaling=new_scaling)
        base = n_clone + N * rank_s + which
        ok = sel_split & (base < n_free)
        tgt = torch.where(ok, free_slots[torch.clamp(base, 0, C - 1)], C)
        return tgt, src

    tgt_s1, src1 = split_rows(0)
    params = _scatter_rows(params, tgt_s1, src1)
    tgt_s2, src2 = split_rows(1)
    params = _scatter_rows(params, tgt_s2, src2)

    # new-slot bookkeeping
    newly = torch.zeros((C + 1,), dtype=torch.bool, device=dev)
    for tgt in (tgt_c, tgt_s1, tgt_s2):
        newly[tgt] = True
    newly = newly[:C]
    alive = alive | newly
    opt_state = adam.mask_rows(opt_state, newly)

    n_dropped = (
        torch.sum(sel_clone & ~(tgt_c < C))
        + torch.sum(sel_split & ~(tgt_s1 < C))
        + torch.sum(sel_split & ~(tgt_s2 < C))
    )

    # split originals are pruned (gaussian_model.py:485-488)
    prune = sel_split
    # opacity / size pruning (gaussian_model.py:507-519) on the updated set
    opacity = T.opacity_activation(params.opacity[:, 0])
    prune = prune | (alive & (opacity < min_opacity))
    if use_screen_size:
        # Reference-exact semantics: densification_postfix zeroes
        # max_radii2D for ALL points before the prune mask is computed
        # (gaussian_model.py:457-459), so the reference's screen-radius
        # prune (gaussian_model.py:516) never fires; only the world-size
        # prune (gaussian_model.py:517, scale > 0.1*extent) is live.
        big_ws = torch.max(T.scaling_activation(params.scaling),
                           dim=1).values > 0.1 * extent
        prune = prune | (alive & big_ws)
        if vs_prune:  # debug/ablation arm only, NOT reference semantics
            big_vs = aux.max_radii2d > max_screen_size
            # newly created rows have max_radii2d == 0: never screen-pruned
            prune = prune | (alive & big_vs & ~newly)

    n_pruned = torch.sum(prune & alive) - n_split  # excluding split originals
    alive = alive & ~prune
    params = _park_dead(params, ~alive)
    opt_state = adam.mask_rows(opt_state, ~alive)

    # densification_postfix resets all accumulators (gaussian_model.py:457-460)
    zeros = torch.zeros((C,), dtype=torch.float32, device=dev)
    aux = GaussianAux(alive=alive, max_radii2d=zeros,
                      xyz_gradient_accum=zeros.clone(), denom=zeros.clone())
    stats = DensifyStats(
        n_cloned=n_clone, n_split=n_split, n_pruned=n_pruned,
        n_dropped=n_dropped, n_alive=torch.sum(alive),
    )
    return params, aux, opt_state, stats


def reset_opacity(params: GaussianParams, aux: GaussianAux,
                  opt_state: adam.AdamState):
    """Clamp opacity to <= 0.01 and reset its Adam moments
    (gaussian_model.py:256-260 + replace_tensor_to_optimizer)."""
    op = T.opacity_activation(params.opacity)
    new_logit = T.inverse_sigmoid(torch.clamp(op, max=0.01))
    new_logit = torch.where(aux.alive[:, None], new_logit, params.opacity)
    params = params._replace(opacity=new_logit)

    def zero_opacity(tree):
        return tree._replace(opacity=torch.zeros_like(tree.opacity))

    opt_state = adam.AdamState(
        count=opt_state.count,
        mu=zero_opacity(opt_state.mu),
        nu=zero_opacity(opt_state.nu),
    )
    return params, opt_state
