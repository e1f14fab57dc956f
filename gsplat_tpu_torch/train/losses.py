"""Training losses (PyTorch port of ``gsplat_tpu/train/losses.py``).

Behavioral spec: reference utils/loss_utils.py:18-155 and the dispatch in
train.py:110-141 / train_segment.py:125-138.  All semantics are replicated,
including the reference's quirks (localrf zeroes the top-20% outliers but
still averages over the full array; continue_loss anchors GT at flat index 5
and pred at flat index 0; depth losses consume INVERSE rendered depth
``1/clamp(depth, 1e-6)``).

Where the JAX code draws from a key, the function here takes a
``torch.Generator`` and, for tests that hand both packages the same numbers,
the draws themselves (``draws``: a dict with ``rank_sample`` [1000],
``patch_rows`` [100] and ``patch_cols`` [100], integer tensors).
"""
from __future__ import annotations

import math
from typing import Optional

import torch


def l1_loss(x, y):
    return torch.mean(torch.abs(x - y))


def l2_loss(x, y):
    return torch.mean((x - y) ** 2)


def _gaussian_1d(window_size: int, sigma: float):
    """The window's taps as Python floats: made on the host, so the loss
    never reads a tensor back."""
    g = [math.exp(-((i - window_size // 2) ** 2) / (2 * sigma ** 2))
         for i in range(window_size)]
    return [v / sum(g) for v in g]


def ssim(img1, img2, window_size: int = 11):
    """Windowed SSIM, 11x11 gaussian sigma=1.5 (loss_utils.py:110-150).
    img: [C,H,W] in [0,1].

    The reference window is ``outer(g, g)`` of a 1D gaussian, exactly
    separable, so the 2D convolution runs as two 11-tap 1D passes of
    shift-multiply-adds in full float32, as in the JAX package (a library
    convolution would run in TF32 on the card by default)."""
    g = _gaussian_1d(window_size, 1.5)
    r = window_size // 2

    def conv(x):
        # x [N,H,W]; zero padding matches F.conv2d(padding=window//2)
        N, H, W = x.shape
        xp = torch.nn.functional.pad(x, (0, 0, r, r))
        x = sum(g[i] * xp[:, i:i + H] for i in range(window_size))
        xp = torch.nn.functional.pad(x, (r, r))
        return sum(g[i] * xp[:, :, i:i + W] for i in range(window_size))

    # one separable pass over all five conv inputs
    stacked = torch.cat(
        [img1, img2, img1 * img1, img2 * img2, img1 * img2], dim=0)
    out = conv(stacked)
    C = img1.shape[0]
    mu1, mu2 = out[0:C], out[C:2 * C]
    mu1_sq, mu2_sq, mu1_mu2 = mu1 ** 2, mu2 ** 2, mu1 * mu2
    sigma1_sq = out[2 * C:3 * C] - mu1_sq
    sigma2_sq = out[3 * C:4 * C] - mu2_sq
    sigma12 = out[4 * C:5 * C] - mu1_mu2
    C1, C2 = 0.01 ** 2, 0.03 ** 2
    ssim_map = ((2 * mu1_mu2 + C1) * (2 * sigma12 + C2)) / (
        (mu1_sq + mu2_sq + C1) * (sigma1_sq + sigma2_sq + C2))
    return torch.mean(ssim_map)


def segment_loss(segment_chw, gt_labels_hw):
    """Per-pixel cross-entropy on composited segment channels
    (train_segment.py:125-138; torch nn.CrossEntropyLoss semantics:
    log_softmax over the class axis + NLL)."""
    logits = segment_chw.permute(1, 2, 0)                       # [H,W,C]
    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, gt_labels_hw[..., None].long())[..., 0]
    return torch.mean(nll)


def compute_depth_loss(dyn_depth, gt_depth, lambda_depth):
    """'localrf' loss: median/MAD-normalized MSE with top-20% outliers zeroed
    (loss_utils.py:88-102)."""
    d = dyn_depth.reshape(-1)
    g = gt_depth.reshape(-1)
    # quantile(0.5) averages the two middle values of an even count, like
    # jnp.median; torch.median would take the lower one
    t_d = torch.quantile(d, 0.5)
    s_d = torch.mean(torch.abs(d - t_d))
    dn = (d - t_d) / s_d
    t_g = torch.quantile(g, 0.5)
    s_g = torch.mean(torch.abs(g - t_g))
    gn = (g - t_g) / s_g
    arr = (dn - gn) ** 2
    q = torch.quantile(arr, 0.8)
    arr = torch.where(arr > q, 0.0, arr)
    return torch.mean(arr) * lambda_depth


def _randint(high: int, n: int, generator, device):
    gdev = device if generator is None else generator.device
    return torch.randint(0, high, (n,), generator=generator,
                         device=gdev).to(device)


def compute_rank_loss(dyn_depth, gt_depth, lambda_depth, sample_nums=1000,
                      generator: Optional[torch.Generator] = None,
                      sample: Optional[torch.Tensor] = None):
    """Pairwise ordering hinge on 1000 random samples (loss_utils.py:20-40)."""
    pred = dyn_depth.reshape(-1) / torch.max(dyn_depth)
    gt = gt_depth.reshape(-1) / torch.max(gt_depth)
    if sample is None:
        sample = _randint(pred.shape[0], sample_nums, generator, pred.device)
    p = pred[sample.long()]
    g = gt[sample.long()]
    # mask[i,j]: gt_i > gt_j ; penalize pred_j - pred_i + 1e-4 clamped >= 0
    mask = (g[:, None] - g[None, :]) > 0
    diff = torch.clamp(p[None, :] - p[:, None] + 1e-4, min=0.0)
    cnt = torch.clamp(torch.sum(mask), min=1)
    return torch.sum(torch.where(mask, diff, 0.0)) / cnt * lambda_depth


def compute_continue_loss(dyn_depth, gt_depth, lambda_depth,
                          sample_nums=100, patch_size=3,
                          generator: Optional[torch.Generator] = None,
                          patch_rows: Optional[torch.Tensor] = None,
                          patch_cols: Optional[torch.Tensor] = None):
    """Continuity transfer on random 3x3 patches (loss_utils.py:44-86).
    dyn_depth/gt_depth: [1,H,W]."""
    gt = gt_depth / torch.max(gt_depth)
    pred = dyn_depth / torch.max(dyn_depth)
    dev = gt.device
    H, W = gt.shape[1], gt.shape[2]
    if patch_rows is None:
        patch_rows = _randint(H - patch_size, sample_nums, generator, dev)
    if patch_cols is None:
        patch_cols = _randint(W - patch_size, sample_nums, generator, dev)
    sw, sh = patch_rows.long(), patch_cols.long()
    n = sw.shape[0]

    dw = torch.arange(patch_size, device=dev)
    # patch [s, 3, 3] gathered at (sw+i, sh+j)
    wi = sw[:, None, None] + dw[None, :, None]
    hj = sh[:, None, None] + dw[None, None, :]
    g_p = gt[0][wi, hj].reshape(n, -1).T[None]              # [1, 9, S]
    p_p = pred[0][wi, hj].reshape(n, -1).T[None]

    anchor_idx = patch_size ** 2 // 2 + 1  # ref quirk: 5, not the center 4
    condition = torch.abs(g_p[:, anchor_idx, :][:, None, :] - g_p)
    mask = (condition <= 1e-3) & (condition > 0)
    cnt = torch.sum(mask)
    # ref quirk: pred anchored at flat index 0
    pen = torch.clamp(torch.abs(p_p[:, 0, :][:, None, :] - p_p) - 1e-3,
                      min=0.0)
    loss = torch.sum(torch.where(mask, pen, 0.0)) / torch.clamp(cnt, min=1)
    return torch.where(cnt > 0, loss, 0.0) * lambda_depth


def depth_loss_dispatch(choice: str, depth_hw, gt_depth, opt,
                        generator: Optional[torch.Generator] = None,
                        draws: Optional[dict] = None):
    """train.py:114-141: all depth losses consume inverse rendered depth."""
    draws = draws or {}
    inv = 1.0 / torch.clamp(depth_hw, min=1e-6)
    if inv.dim() == 2:
        inv = inv[None]
    gt = gt_depth if gt_depth.dim() == 3 else gt_depth[None]

    def continue_loss():
        return compute_continue_loss(
            inv, gt, opt.lambda_continue_depth, generator=generator,
            patch_rows=draws.get("patch_rows"),
            patch_cols=draws.get("patch_cols"))

    def rank_loss():
        return compute_rank_loss(inv, gt, opt.lambda_rank_depth,
                                 generator=generator,
                                 sample=draws.get("rank_sample"))

    if choice == "localrf":
        return compute_depth_loss(inv, gt, opt.lambda_depth)
    if choice == "rank_loss":
        return rank_loss()
    if choice == "continue_loss":
        return continue_loss()
    if choice == "hybrid_loss":
        return continue_loss() + rank_loss()
    if choice == "L1_loss":
        gt_n = gt / torch.max(gt)
        return l1_loss(inv, gt_n) * opt.lambda_depth
    raise ValueError(f"loss choice error! {choice}")


def psnr(img1, img2):
    """utils/image_utils.py:17-19."""
    mse = torch.mean((img1 - img2) ** 2)
    return 20.0 * torch.log10(1.0 / torch.sqrt(mse))
