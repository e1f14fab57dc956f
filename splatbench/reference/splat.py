"""Plain PyTorch reference of a 3D Gaussian Splatting render and train step.

Written from the published method (Kerbl et al. 2023, "3D Gaussian
Splatting for Real-Time Radiance Field Rendering", and its CUDA rasterizer's
semantics), independent of the code under test:

- preprocess: frustum cull at view z > 0.2, EWA projection of the 3D
  covariance R S S^T R^T with the 1.3 tan(fov) clamp and the 0.3 low-pass,
  the conic, the 3-sigma radius, the opacity-aware tile rectangle (a
  gaussian is binned to a tile only where its alpha can reach 1/255), and
  the colour from real spherical harmonics of degree 0 to 3 (+0.5, clamped
  at 0);
- binning: every (gaussian, tile) pair of the rectangle, sorted by tile and
  inside a tile by view depth;
- compositing, front to back per pixel: skip a pair whose power is above 0
  or whose alpha (capped at 0.99) is below 1/255, stop the pixel before the
  pair that would take its transmittance below 1e-4, and accumulate the
  colour, the view depth and the segment probabilities by alpha T.

Tiles are composited a block at a time as dense [tiles, pixels, instances]
tensors whose size ``budget`` bounds, so a 1080p frame fits on one card.  A
gradient runs the forward without autograd, takes the loss's cotangent of
the image, then recomputes each block with autograd to push it back to the
per-gaussian quantities, and ends in one autograd pass through the
preprocess.  Every function takes the dtype of its inputs, so the same code
runs in float32 (the reference) and in bfloat16 (the control), and runs
with TF32 off in cuDNN and in matrix products.

A step follows the numerics a configuration states (``numerics``):
``feat_precision="bf16"`` composites the features rounded to bfloat16
(round to nearest even; their gradient passes through the rounding), and
``grad_precision="bf16"`` rounds each instance's gradient row, the sum over
its tile's pixels, to bfloat16 before the rows of a gaussian are summed.
"""
from __future__ import annotations

import contextlib
import functools
import math
from typing import NamedTuple

import torch

TILE = 32
ALPHA_MIN = 1.0 / 255.0
ALPHA_MAX = 0.99
T_EPS = 1e-4
BUDGET = 1 << 26          # (pixel, instance) pairs of one block of tiles

SH_C0 = 0.28209479177387814
SH_C1 = 0.4886025119029199
SH_C2 = (1.0925484305920792, -1.0925484305920792, 0.31539156525252005,
         -1.0925484305920792, 0.5462742152960396)
SH_C3 = (-0.5900435899266435, 2.890611442640554, -0.4570457994644658,
         0.3731763325901154, -0.4570457994644658, 1.445305721320277,
         -0.5900435899266435)

FIELDS = ("xyz", "features_dc", "features_rest", "scaling", "rotation",
          "opacity", "segment")


@contextlib.contextmanager
def no_tf32():
    """TF32 off for cuDNN's convolutions and for matrix products, restored
    on leaving."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
            yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def exact(fn):
    """``fn`` run under ``no_tf32``."""
    @functools.wraps(fn)
    def wrapped(*a, **k):
        with no_tf32():
            return fn(*a, **k)
    return wrapped


def round_bf16(x):
    """``x`` rounded to bfloat16 (nearest even) in its own dtype; the
    gradient passes through unchanged."""
    return x + (x.to(torch.bfloat16).to(x.dtype) - x).detach()


class _Bf16Grad(torch.autograd.Function):
    """Identity whose gradient is rounded to bfloat16 (nearest even)."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.to(torch.bfloat16).to(g.dtype)


class Params(NamedTuple):
    """Raw gaussian parameters, one row a gaussian (3DGS's layout)."""
    xyz: torch.Tensor            # [P,3]
    features_dc: torch.Tensor    # [P,1,3]
    features_rest: torch.Tensor  # [P,15,3]
    scaling: torch.Tensor        # [P,3] log scale
    rotation: torch.Tensor       # [P,4] quaternion wxyz, unnormalised
    opacity: torch.Tensor        # [P,1] logit
    segment: torch.Tensor        # [P,S] logit


class Cam(NamedTuple):
    """A pinhole camera: ``view`` and ``proj`` are the 4x4 world-to-view and
    full projection matrices in row-vector form (a point p maps to
    [p, 1] @ M), as 3DGS stores them."""
    view: torch.Tensor
    proj: torch.Tensor
    campos: torch.Tensor
    tan_fovx: float
    tan_fovy: float
    width: int
    height: int


class Pre(NamedTuple):
    means2d: torch.Tensor   # [P,2] pixel coordinates
    conic: torch.Tensor     # [P,3] inverse 2D covariance (a, b, c)
    opacity: torch.Tensor   # [P]
    feats: torch.Tensor     # [P,4+S] rgb, view depth, segment probabilities
    depth: torch.Tensor     # [P] view z
    rect_min: torch.Tensor  # [P,2] int64 tiles, inclusive
    rect_max: torch.Tensor  # [P,2] int64 tiles, exclusive
    visible: torch.Tensor   # [P] bool


class Bins(NamedTuple):
    gid: torch.Tensor       # [I] gaussian of each instance, tile-major
    starts: torch.Tensor    # [T] first instance of each tile
    counts: torch.Tensor    # [T] instances of each tile
    grid_x: int


def eval_sh(deg: int, sh, d):
    """Real spherical harmonics up to degree 3 at unit directions ``d``."""
    out = SH_C0 * sh[:, 0]
    if deg < 1:
        return out
    x, y, z = d[:, 0:1], d[:, 1:2], d[:, 2:3]
    out = (out - SH_C1 * y * sh[:, 1] + SH_C1 * z * sh[:, 2]
           - SH_C1 * x * sh[:, 3])
    if deg < 2:
        return out
    xx, yy, zz, xy, yz, xz = x * x, y * y, z * z, x * y, y * z, x * z
    out = (out + SH_C2[0] * xy * sh[:, 4] + SH_C2[1] * yz * sh[:, 5]
           + SH_C2[2] * (2 * zz - xx - yy) * sh[:, 6]
           + SH_C2[3] * xz * sh[:, 7] + SH_C2[4] * (xx - yy) * sh[:, 8])
    if deg < 3:
        return out
    return (out + SH_C3[0] * y * (3 * xx - yy) * sh[:, 9]
            + SH_C3[1] * xy * z * sh[:, 10]
            + SH_C3[2] * y * (4 * zz - xx - yy) * sh[:, 11]
            + SH_C3[3] * z * (2 * zz - 3 * xx - 3 * yy) * sh[:, 12]
            + SH_C3[4] * x * (4 * zz - xx - yy) * sh[:, 13]
            + SH_C3[5] * z * (xx - yy) * sh[:, 14]
            + SH_C3[6] * x * (xx - 3 * yy) * sh[:, 15])


def rotation_matrix(q):
    """[P,4] quaternions (wxyz, normalised here) -> [P,3,3]."""
    q = q / q.norm(dim=1, keepdim=True).clamp_min(1e-12)
    w, x, y, z = q.unbind(1)
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                     2 * (x * z + w * y)], 1),
        torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                     2 * (y * z - w * x)], 1),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x),
                     1 - 2 * (x * x + y * y)], 1)], 1)


def _tile_index(v, n: int):
    """Truncation toward zero of a tile coordinate, held in [0, n]."""
    v = torch.nan_to_num(v.float(), nan=0.0).clamp(-1.0, n + 1.0)
    return v.to(torch.int64).clamp(0, n)


def preprocess(p: Params, cam: Cam, sh_degree: int) -> Pre:
    """Project every gaussian of ``p`` (differentiable in its floats)."""
    W, H = cam.width, cam.height
    gx, gy = -(-W // TILE), -(-H // TILE)
    V, M = cam.view, cam.proj
    xyz = p.xyz
    pv = xyz @ V[:3, :3] + V[3, :3]
    z = pv[:, 2]
    ph = xyz @ M[:3, :] + M[3, :]
    pp = ph[:, :2] / (ph[:, 3:4] + 1e-7)
    fx = W / (2.0 * cam.tan_fovx)
    fy = H / (2.0 * cam.tan_fovy)
    limx, limy = 1.3 * cam.tan_fovx, 1.3 * cam.tan_fovy
    tx = (pv[:, 0] / z).clamp(-limx, limx) * z
    ty = (pv[:, 1] / z).clamp(-limy, limy) * z
    zero = torch.zeros_like(z)
    J = torch.stack([torch.stack([fx / z, zero, -fx * tx / (z * z)], 1),
                     torch.stack([zero, fy / z, -fy * ty / (z * z)], 1)], 1)
    R = rotation_matrix(p.rotation)
    L = R * torch.exp(p.scaling)[:, None, :]
    sigma = L @ L.transpose(1, 2)                       # R S S^T R^T
    A = V[:3, :3] @ J.transpose(1, 2)                   # [P,3,2]
    cov = A.transpose(1, 2) @ sigma @ A                 # [P,2,2]
    a = cov[:, 0, 0] + 0.3
    b = cov[:, 0, 1]
    c = cov[:, 1, 1] + 0.3
    det = a * c - b * b
    ok = det != 0
    inv = torch.where(ok, 1.0 / torch.where(ok, det, torch.ones_like(det)),
                      zero)
    conic = torch.stack([c * inv, -b * inv, a * inv], 1)
    mid = 0.5 * (a + c)
    root = torch.sqrt((mid * mid - det).clamp_min(0.1))
    radius = torch.ceil(3.0 * torch.sqrt(torch.maximum(mid + root,
                                                       mid - root)))
    m2d = torch.stack([((pp[:, 0] + 1.0) * W - 1.0) * 0.5,
                       ((pp[:, 1] + 1.0) * H - 1.0) * 0.5], 1)
    opac = torch.sigmoid(p.opacity[:, 0])
    # the extent along each axis beyond which alpha stays under 1/255
    ln_op = torch.log((255.0 * opac).clamp_min(1.0))
    ex = torch.minimum(radius, torch.sqrt(2.0 * a * (ln_op + 1e-3)) + 1.0)
    ey = torch.minimum(radius, torch.sqrt(2.0 * c * (ln_op + 1e-3)) + 1.0)
    mx, my = m2d[:, 0].detach(), m2d[:, 1].detach()
    ex, ey = ex.detach(), ey.detach()
    rmin = torch.stack([_tile_index((mx - ex) / TILE, gx),
                        _tile_index((my - ey) / TILE, gy)], 1)
    rmax = torch.stack([_tile_index((mx + ex + TILE - 1) / TILE, gx),
                        _tile_index((my + ey + TILE - 1) / TILE, gy)], 1)
    area = (rmax - rmin).prod(1)
    visible = (z.detach() > 0.2) & ok.detach() & (area > 0)
    dirs = xyz - cam.campos
    dirs = dirs / dirs.norm(dim=1, keepdim=True).clamp_min(1e-12)
    shs = torch.cat([p.features_dc, p.features_rest], 1)
    rgb = (eval_sh(sh_degree, shs, dirs) + 0.5).clamp_min(0.0)
    feats = torch.cat([rgb, z[:, None], torch.sigmoid(p.segment)], 1)
    return Pre(m2d, conic, opac, feats, z, rmin, rmax, visible)


def bin_tiles(pre: Pre, width: int, height: int) -> Bins:
    """Instances (gaussian, tile) of the visible gaussians, tile-major,
    front to back inside a tile (ties by gaussian index)."""
    gx, gy = -(-width // TILE), -(-height // TILE)
    dev = pre.depth.device
    vis = torch.nonzero(pre.visible)[:, 0]
    order = vis[torch.argsort(pre.depth.detach()[vis], stable=True)]
    rmin, rmax = pre.rect_min[order], pre.rect_max[order]
    w = rmax[:, 0] - rmin[:, 0]
    n = w * (rmax[:, 1] - rmin[:, 1])
    total = int(n.sum())
    gid = torch.repeat_interleave(order, n, output_size=total)
    first = torch.cumsum(n, 0) - n
    k = torch.arange(total, device=dev) - torch.repeat_interleave(
        first, n, output_size=total)
    wr = torch.repeat_interleave(w, n, output_size=total)
    tile = ((torch.repeat_interleave(rmin[:, 1], n, output_size=total)
             + k // wr) * gx
            + torch.repeat_interleave(rmin[:, 0], n, output_size=total)
            + k % wr)
    srt = torch.argsort(tile, stable=True)
    counts = torch.bincount(tile, minlength=gx * gy)
    return Bins(gid[srt], torch.cumsum(counts, 0) - counts, counts, gx)


def tile_blocks(bins: Bins, budget: int = BUDGET):
    """Blocks of tiles (heaviest first) whose padded pairs fit ``budget``:
    a list of (tile ids, instances of the block's heaviest tile)."""
    counts = bins.counts.tolist()
    order = sorted((c, t) for t, c in enumerate(counts) if c > 0)[::-1]
    blocks, i = [], 0
    per_row = TILE * TILE
    while i < len(order):
        K = order[i][0]
        n = max(1, budget // (per_row * K))
        blocks.append(([t for _, t in order[i:i + n]], K))
        i += n
    return blocks


class Block(NamedTuple):
    out: torch.Tensor       # [n, TILE*TILE, C] composited features
    T: torch.Tensor         # [n, TILE*TILE] final transmittance
    pixel: torch.Tensor     # [n, TILE*TILE] flat pixel index (or -1 outside)


def composite_block(tiles, K: int, bins: Bins, m2d, conic, opac, feats,
                    width: int, height: int, counts: dict = None,
                    grad_bf16: bool = False) -> Block:
    """Front-to-back compositing of a block of tiles (differentiable in
    ``m2d``, ``conic``, ``opac`` and ``feats``; with ``grad_bf16`` each
    instance's gradient row is rounded to bfloat16)."""
    dev = m2d.device
    t = torch.as_tensor(tiles, device=dev)
    cnt = bins.counts[t]
    pos = torch.arange(K, device=dev)
    valid = pos[None] < cnt[:, None]                          # [n,K]
    inst = (bins.starts[t][:, None] + pos[None]).clamp(
        max=max(bins.gid.shape[0] - 1, 0))
    g = bins.gid[inst]                                        # [n,K]
    rows = [x[g] for x in (m2d, conic, opac, feats)]
    if grad_bf16:
        rows = [_Bf16Grad.apply(x) for x in rows]
    mg, cg, og, fg = rows
    lane = torch.arange(TILE * TILE, device=dev)
    px = (t % bins.grid_x)[:, None] * TILE + (lane % TILE)[None]
    py = (t // bins.grid_x)[:, None] * TILE + (lane // TILE)[None]
    inside = (px < width) & (py < height)
    dt = m2d.dtype
    dx = mg[..., 0][:, None, :] - px.to(dt)[:, :, None]      # [n,PIX,K]
    dy = mg[..., 1][:, None, :] - py.to(dt)[:, :, None]
    ca, cb, cc = (cg[..., j][:, None, :] for j in range(3))
    power = -0.5 * (ca * dx * dx + cc * dy * dy) - cb * dx * dy
    alpha = torch.clamp(og[:, None, :] * torch.exp(power),
                        max=ALPHA_MAX)
    ok = valid[:, None, :] & (power <= 0) & (alpha >= ALPHA_MIN)
    with torch.no_grad():
        a0 = torch.where(ok, alpha, torch.zeros_like(alpha))
        keep = ok & (torch.cumprod(1.0 - a0, -1) >= T_EPS)
    a = torch.where(keep, alpha, torch.zeros_like(alpha))
    t_after = torch.cumprod(1.0 - a, -1)
    t_before = torch.cat([torch.ones_like(t_after[..., :1]),
                          t_after[..., :-1]], -1)
    w = a * t_before
    out = torch.bmm(w, fg)                                    # [n,PIX,C]
    T = t_after[..., -1]
    if counts is not None:
        stop = (ok & ~keep).any(-1) & inside
        counts["composited"] += int((keep & inside[..., None]).sum())
        counts["stopping"] += int(stop.sum())
    pixel = torch.where(inside, py * width + px, -1)
    return Block(out, T, pixel)


def composite(pre: Pre, bins: Bins, width: int, height: int,
              budget: int = BUDGET, counts: dict = None):
    """The frame: (planes [C, H, W] with C = 4 + S plus the weight sum, and
    the final transmittance [H, W]); no autograd."""
    C = pre.feats.shape[1]
    dev, dt = pre.feats.device, pre.feats.dtype
    planes = torch.zeros((C + 1, height * width), dtype=dt, device=dev)
    T = torch.ones((height * width,), dtype=dt, device=dev)
    with torch.no_grad():
        feats = torch.cat([pre.feats, torch.ones_like(pre.feats[:, :1])], 1)
        for tiles, K in tile_blocks(bins, budget):
            b = composite_block(tiles, K, bins, pre.means2d, pre.conic,
                                pre.opacity, feats, width, height, counts)
            sel = b.pixel >= 0
            planes[:, b.pixel[sel]] = b.out[sel].T
            T[b.pixel[sel]] = b.T[sel]
    return planes.reshape(C + 1, height, width), T.reshape(height, width)


def composite_vjp(pre: Pre, bins: Bins, width: int, height: int, d_planes,
                  d_T, budget: int = BUDGET, grad_bf16: bool = False):
    """Cotangents of (means2d, conic, opacity, feats) from those of the
    feature planes [C, H, W] and of the final transmittance [H, W]; with
    ``grad_bf16`` each instance's row rounded to bfloat16 before the
    rows of a gaussian are summed."""
    leaves = [x.detach().requires_grad_(True)
              for x in (pre.means2d, pre.conic, pre.opacity, pre.feats)]
    C = pre.feats.shape[1]
    dp = d_planes.reshape(C, -1)
    dT = d_T.reshape(-1)
    for tiles, K in tile_blocks(bins, budget):
        b = composite_block(tiles, K, bins, *leaves, width, height,
                            grad_bf16=grad_bf16)
        sel = (b.pixel >= 0).to(b.out.dtype)
        idx = b.pixel.clamp_min(0)
        torch.autograd.backward(
            [b.out, b.T], [dp[:, idx].permute(1, 2, 0) * sel[..., None],
                           dT[idx] * sel])
    return [x.grad if x.grad is not None else torch.zeros_like(x)
            for x in leaves]


@exact
def render(p: Params, cam: Cam, sh_degree: int, bg, budget: int = BUDGET,
           counts: dict = None):
    """dict(image [3,H,W], depth [H,W], segment [S,H,W], alpha [H,W]) of
    the frame; ``counts`` (a dict) gains the pair counts the frame needs."""
    with torch.no_grad():
        pre = preprocess(p, cam, sh_degree)
        bins = bin_tiles(pre, cam.width, cam.height)
        if counts is not None:
            for k in ("composited", "stopping"):
                counts.setdefault(k, 0)
            counts["visible"] = int(pre.visible.sum())
            counts["instances"] = int(bins.gid.shape[0])
        planes, T = composite(pre, bins, cam.width, cam.height, budget,
                              counts)
    S = pre.feats.shape[1] - 4
    return dict(image=planes[:3] + T[None] * bg[:, None, None],
                depth=planes[3], segment=planes[4:4 + S],
                alpha=planes[4 + S], T=T)


# ---------------------------------------------------------------- losses ---

def gaussian_window(size: int = 11, sigma: float = 1.5):
    g = [math.exp(-((i - size // 2) ** 2) / (2 * sigma ** 2))
         for i in range(size)]
    return [v / sum(g) for v in g]


def ssim(x, y, size: int = 11):
    """Mean SSIM of two [C,H,W] images, 11x11 gaussian window (sigma 1.5)
    with zero padding, as 3DGS's loss_utils.ssim; the window is applied as
    its two 1-D factors with a depthwise convolution."""
    C = x.shape[0]
    g = torch.tensor(gaussian_window(size), dtype=x.dtype, device=x.device)
    kx = g.reshape(1, 1, 1, size).repeat(5 * C, 1, 1, 1)
    ky = g.reshape(1, 1, size, 1).repeat(5 * C, 1, 1, 1)
    stack = torch.cat([x, y, x * x, y * y, x * y], 0)[None]
    f = torch.nn.functional.conv2d(stack, ky, padding=(size // 2, 0),
                                   groups=5 * C)
    f = torch.nn.functional.conv2d(f, kx, padding=(0, size // 2),
                                   groups=5 * C)[0]
    mu1, mu2 = f[:C], f[C:2 * C]
    s1 = f[2 * C:3 * C] - mu1 * mu1
    s2 = f[3 * C:4 * C] - mu2 * mu2
    s12 = f[4 * C:] - mu1 * mu2
    c1, c2 = 0.01 ** 2, 0.03 ** 2
    m = ((2 * mu1 * mu2 + c1) * (2 * s12 + c2)) / (
        (mu1 * mu1 + mu2 * mu2 + c1) * (s1 + s2 + c2))
    return m.mean()


def image_loss(image, depth, segment, target: dict, hp: dict,
               rows: slice = slice(None)):
    """The 3DGS loss (1 - l) L1 + l (1 - SSIM), plus the depth term on
    inverse max-normalised depth against the max-normalised target
    ("L1_loss") and the segment cross-entropy, each with its weight from
    ``hp``.  ``rows`` restricts every term to those image rows."""
    gt = target["image"][:, rows]
    image, depth, segment = image[:, rows], depth[rows], segment[:, rows]
    loss = ((1.0 - hp["lambda_dssim"]) * (image - gt).abs().mean()
            + hp["lambda_dssim"] * (1.0 - ssim(image, gt)))
    d = depth / (depth.max() + 1e-5)
    inv = 1.0 / d.clamp_min(1e-6)
    gd = target["depth"][rows]
    loss = loss + (inv - gd / gd.max()).abs().mean() * hp["lambda_depth"]
    logp = torch.log_softmax(segment, 0)
    lab = target["segment"][rows].long()
    nll = -torch.gather(logp, 0, lab[None])[0]
    return loss + nll.mean() * hp["lambda_segment"]


# ------------------------------------------------------------------ Adam ---

class Moments(NamedTuple):
    count: int
    mu: tuple
    nu: tuple


def zero_moments(p: Params) -> Moments:
    return Moments(0, tuple(torch.zeros_like(x) for x in p),
                   tuple(torch.zeros_like(x) for x in p))


def adam(p: Params, grads, m: Moments, lrs: dict, b1=0.9, b2=0.999,
         eps=1e-15):
    """torch.optim.Adam's update with 3DGS's eps and one lr a field."""
    n = m.count + 1
    bc1, bc2 = 1.0 - b1 ** n, 1.0 - b2 ** n
    mu = tuple(b1 * a + (1 - b1) * g for a, g in zip(m.mu, grads))
    nu = tuple(b2 * v + (1 - b2) * g * g for v, g in zip(m.nu, grads))
    new = Params(*[x - lrs[f] * (a / bc1) / (torch.sqrt(v / bc2) + eps)
                   for f, x, a, v in zip(FIELDS, p, mu, nu)])
    return new, Moments(n, mu, nu)


# ------------------------------------------------------------ train step ---

F32 = {"grad_precision": "f32", "feat_precision": "f32"}


@exact
def train_step(p: Params, m: Moments, lrs: dict, cam: Cam, target: dict,
               hp: dict, sh_degree: int, bg, budget: int = BUDGET,
               rows: slice = slice(None), numerics: dict = F32):
    """One step in the stated ``numerics``: (loss, gradients as a Params,
    new params, new moments)."""
    leaves = Params(*[x.detach().requires_grad_(True) for x in p])
    pre = preprocess(leaves, cam, sh_degree)
    if numerics["feat_precision"] == "bf16":
        pre = pre._replace(feats=round_bf16(pre.feats))
    bins = bin_tiles(pre, cam.width, cam.height)
    planes, T = composite(pre, bins, cam.width, cam.height, budget)
    S = pre.feats.shape[1] - 4
    img = (planes[:3] + T[None] * bg[:, None, None]).requires_grad_(True)
    depth = planes[3].clone().requires_grad_(True)
    seg = planes[4:4 + S].clone().requires_grad_(True)
    loss = image_loss(img, depth, seg, target, hp, rows)
    d_img, d_depth, d_seg = torch.autograd.grad(loss, [img, depth, seg])
    d_planes = torch.cat([d_img, d_depth[None], d_seg], 0)
    d_T = (d_img * bg[:, None, None]).sum(0)
    g = composite_vjp(pre, bins, cam.width, cam.height, d_planes, d_T,
                      budget, numerics["grad_precision"] == "bf16")
    torch.autograd.backward([pre.means2d, pre.conic, pre.opacity,
                             pre.feats], g)
    grads = Params(*[x.grad if x.grad is not None else torch.zeros_like(x)
                     for x in leaves])
    new, m2 = adam(p, grads, m, lrs)
    return float(loss.detach()), grads, new, m2


# ----------------------------------------------------------------- split ---

@exact
def split(p: Params, generator: torch.Generator, n: int = 2,
          shrink: float = 1.6) -> Params:
    """3DGS's split (Kerbl et al. 2023, 5.2): each gaussian becomes ``n``
    whose centres are drawn from it, scales divided by ``shrink``, every
    other attribute copied.  Rows come out sample-major."""
    P = p.xyz.shape[0]
    s = torch.exp(p.scaling)
    draw = torch.randn((n, P, 3), generator=generator, device=p.xyz.device,
                       dtype=p.xyz.dtype)
    R = rotation_matrix(p.rotation)
    xyz = torch.cat([p.xyz + torch.einsum("pij,pj->pi", R, draw[k] * s)
                     for k in range(n)])
    scaling = torch.log(s / shrink).repeat(n, 1)
    rest = [x.repeat((n,) + (1,) * (x.dim() - 1)) for x in
            (p.features_dc, p.features_rest)]
    return Params(xyz, *rest, scaling, p.rotation.repeat(n, 1),
                  p.opacity.repeat(n, 1), p.segment.repeat(n, 1))
