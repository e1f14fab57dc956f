"""DPT (Dense Prediction Transformer) in PyTorch: the port of
``gsplat_tpu/depth/dpt.py``.

Architecture spec: the reference's vendored Intel DPT (dpt/vit.py,
blocks.py, models.py).  Supported backbones, as in the JAX module:

- ``vitl16_384``  (DPT-Large): ViT-L/16, hooks (5,11,17,23), reassemble to
  (256,512,1024,1024) channels at strides (4,8,16,32)
- ``vitb16_384``:  ViT-B/16, hooks (2,5,8,11), (96,192,384,768)
- ``vitb_rn50_384`` (DPT-Hybrid, the reference default): ResNetV2-50 stem
  (stages 0-1 tapped directly) + ViT-B over the stride-16 feature map,
  hooks (0,1,8,11) -> (256,512,768,768)

The model is a tree of ``nn.Module``s named after the official MiDaS/DPT
state dict (``pretrained.model.blocks.N.attn.qkv``,
``scratch.refinenet1.resConfUnit1.conv1`` and so on), so an official
checkpoint's keys are the model's own (``weights.load_torch``).  Inside,
activations are NCHW, conv weights OIHW and ``nn.Linear`` weights
[out, in].  At the boundary the JAX interface stays: ``dpt_forward(model,
x)`` takes [N, H, W, 3] NHWC and returns [N, H, W] inverse depth or
[N, H, W, C] logits.

The JAX module runs every conv and einsum at ``Precision.HIGHEST``; here the
forward runs in float32 with TF32 off for cuDNN's convolutions and for
matmuls, scoped inside ``dpt_forward``.  Plain torch throughout: the JAX
module is plain XLA (convolutions, einsums, a softmax) with no Pallas
kernel, so there is no CUDA kernel here.

Stated divergences: ``init_params`` draws N(0, 0.02) from a
``torch.Generator`` (the JAX function draws from a key, so the two random
models differ; ``params_from_numpy`` carries a JAX pytree across for
parity), and the model is a module where the JAX one is a pytree.
"""
from __future__ import annotations

import contextlib
import math
from dataclasses import dataclass
from typing import Sequence

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from gsplat_tpu_torch.device import resolve_device


# --------------------------------------------------------------------------
# configs (copies of gsplat_tpu/depth/dpt.py:41-76)
# --------------------------------------------------------------------------

@dataclass(frozen=True)
class DPTConfig:
    backbone: str = "vitb_rn50_384"
    features: int = 256                       # decoder width
    reassemble: Sequence[int] = (256, 512, 768, 768)
    hooks: Sequence[int] = (0, 1, 8, 11)
    vit_dim: int = 768
    vit_depth: int = 12
    vit_heads: int = 12
    vit_mlp: int = 3072
    patch: int = 16
    hybrid: bool = False                      # ResNetV2 stem, taps stages 0/1
    rn_layers: Sequence[int] = (3, 4, 9)      # hybrid ResNetV2 blocks/stage
    head: str = "depth"                       # "depth" | "segmentation"
    num_classes: int = 150                    # segmentation head
    use_bn: bool = False                      # fusion-block batchnorm (seg)
    non_negative: bool = True


def dpt_config(model_type: str = "dpt_hybrid", head: str = "depth",
               num_classes: int = 150) -> DPTConfig:
    """Mirror of the reference run_monodepth.py's model zoo (minus
    weights)."""
    base = dict(head=head, num_classes=num_classes,
                use_bn=(head == "segmentation"))
    if model_type in ("dpt_large", "vitl16_384"):
        return DPTConfig(backbone="vitl16_384", hooks=(5, 11, 17, 23),
                         reassemble=(256, 512, 1024, 1024), vit_dim=1024,
                         vit_depth=24, vit_heads=16, vit_mlp=4096, **base)
    if model_type in ("dpt_base", "vitb16_384"):
        return DPTConfig(backbone="vitb16_384", hooks=(2, 5, 8, 11),
                         reassemble=(96, 192, 384, 768), **base)
    if model_type in ("dpt_hybrid", "dpt_hybrid_kitti", "dpt_hybrid_nyu",
                      "vitb_rn50_384"):
        return DPTConfig(backbone="vitb_rn50_384", hybrid=True, **base)
    raise ValueError(f"unknown DPT model_type {model_type!r} "
                     "(use dpt_large | dpt_base | dpt_hybrid)")


# --------------------------------------------------------------------------
# primitives (NCHW; gsplat_tpu/depth/dpt.py:83-191)
# --------------------------------------------------------------------------

def _same_pad_amount(size: int, k: int, s: int):
    out = -(-size // s)
    pad = max((out - 1) * s + k - size, 0)
    return pad // 2, pad - pad // 2


def _pad_same(x, k: int, s: int, value: float = 0.0):
    """TF 'SAME' padding, asymmetric where the total is odd: the smaller
    half first (dpt.py:110-113)."""
    top, bottom = _same_pad_amount(x.shape[2], k, s)
    left, right = _same_pad_amount(x.shape[3], k, s)
    return F.pad(x, (left, right, top, bottom), value=value)


def std_conv_same(x, w, b=None, stride=1, eps=1e-8):
    """Weight-standardized conv with TF 'SAME' padding (timm
    StdConv2dSame, the hybrid ResNetV2 conv layer; dpt.py:116-129): each
    output channel's weights over (in, kh, kw), population variance."""
    mu = w.mean(dim=(1, 2, 3), keepdim=True)
    var = w.var(dim=(1, 2, 3), unbiased=False, keepdim=True)
    w = (w - mu) / torch.sqrt(var + eps)
    return F.conv2d(_pad_same(x, w.shape[2], stride), w, b, stride)


def max_pool_same(x, k=3, stride=2):
    """dpt.py:132-137: 'SAME' max pool, padded with -inf."""
    return F.max_pool2d(_pad_same(x, k, stride, -math.inf), k, stride)


def group_norm(x, norm: nn.GroupNorm, act=True):
    """dpt.py:140-147: 32 groups, eps 1e-5, ReLU fused."""
    y = F.group_norm(x, 32, norm.weight, norm.bias, eps=1e-5)
    return F.relu(y) if act else y


def batch_norm_inference(x, bn: "BatchNormInference", eps=1e-5):
    """Folded inference-mode BatchNorm2d from the running statistics
    (dpt.py:156-159)."""
    scale = bn.weight / torch.sqrt(bn.running_var + eps)
    shift = bn.bias - bn.running_mean * scale
    return x * scale[:, None, None] + shift[:, None, None]


def resize_bilinear_ac(x, out_h: int, out_w: int):
    """Bilinear resize with align_corners=True (dpt.py:162-188, the fusion
    blocks' and heads' upsampling)."""
    return F.interpolate(x, size=(out_h, out_w), mode="bilinear",
                         align_corners=True)


def resize_pos_embed(pos, gs_h: int, gs_w: int):
    """dpt.py:223-230: the grid part resized (half-pixel bilinear), the cls
    row kept.  ``jax.image.resize`` antialiases when it shrinks a grid, so
    ``antialias=True`` (the official torch DPT does not)."""
    tok, grid = pos[:, :1], pos[0, 1:]
    gs_old = int(round(math.sqrt(grid.shape[0])))
    grid = grid.reshape(1, gs_old, gs_old, -1).permute(0, 3, 1, 2)
    grid = F.interpolate(grid, size=(gs_h, gs_w), mode="bilinear",
                         align_corners=False, antialias=True)
    grid = grid.permute(0, 2, 3, 1).reshape(1, gs_h * gs_w, -1)
    return torch.cat([tok, grid], dim=1)


# --------------------------------------------------------------------------
# modules, named after the official state dict
# --------------------------------------------------------------------------

class BatchNormInference(nn.Module):
    """A BatchNorm2d's four tensors (no ``num_batches_tracked``: the JAX
    weight converter reads these four, dpt weights.py:39-43)."""

    def __init__(self, c: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(c))
        self.bias = nn.Parameter(torch.empty(c))
        self.register_buffer("running_mean", torch.empty(c))
        self.register_buffer("running_var", torch.empty(c))


def _children(module: nn.Module, names_and_modules):
    for name, child in names_and_modules:
        module.add_module(name, child)
    return module


class Attention(nn.Module):
    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.heads = heads
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x):
        """dpt.py:199-212: explicit matmuls, scale after the QK product,
        then a softmax."""
        n, t, c = x.shape
        d = c // self.heads
        qkv = self.qkv(x).reshape(n, t, 3, self.heads, d)
        q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
        att = torch.matmul(q, k.transpose(-2, -1)) * (1.0 / math.sqrt(d))
        att = torch.softmax(att, dim=-1)
        out = torch.matmul(att, v).transpose(1, 2).reshape(n, t, c)
        return self.proj(out)


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x)))   # exact erf GELU (dpt.py:191)


class Block(nn.Module):
    def __init__(self, dim: int, heads: int, hidden: int):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.attn = Attention(dim, heads)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        self.mlp = Mlp(dim, hidden)

    def forward(self, x):
        x = x + self.attn(self.norm1(x))
        return x + self.mlp(self.norm2(x))


class Bottleneck(nn.Module):
    """A ResNetV2 block of the hybrid (dpt.py:233-250)."""

    def __init__(self, cin: int, width: int, stride: int, downsample: bool):
        super().__init__()
        cout = width * 4
        self.stride = stride
        self.conv1 = nn.Conv2d(cin, width, 1, bias=False)
        self.norm1 = nn.GroupNorm(32, width)
        self.conv2 = nn.Conv2d(width, width, 3, bias=False)
        self.norm2 = nn.GroupNorm(32, width)
        self.conv3 = nn.Conv2d(width, cout, 1, bias=False)
        self.norm3 = nn.GroupNorm(32, cout)
        if downsample:
            self.downsample = _children(nn.Module(), (
                ("conv", nn.Conv2d(cin, cout, 1, bias=False)),
                ("norm", nn.GroupNorm(32, cout))))

    def forward(self, x):
        if hasattr(self, "downsample"):
            sc = std_conv_same(x, self.downsample.conv.weight,
                               stride=self.stride)
            sc = group_norm(sc, self.downsample.norm, act=False)
        else:
            sc = x
        h = group_norm(std_conv_same(x, self.conv1.weight), self.norm1)
        h = group_norm(std_conv_same(h, self.conv2.weight,
                                     stride=self.stride), self.norm2)
        h = group_norm(std_conv_same(h, self.conv3.weight), self.norm3,
                       act=False)
        return F.relu(h + sc)


class ResNetV2(nn.Module):
    """The hybrid's stem and three stages (stride 16, 1024 channels)."""

    def __init__(self, rn_layers):
        super().__init__()
        self.stem = _children(nn.Module(), (
            ("conv", nn.Conv2d(3, 64, 7, bias=False)),
            ("norm", nn.GroupNorm(32, 64))))
        stages = []
        cin, width = 64, 64
        for si, nblk in enumerate(rn_layers):
            blocks = []
            for bi in range(nblk):
                blocks.append(Bottleneck(cin, width,
                                         2 if (bi == 0 and si > 0) else 1,
                                         downsample=(bi == 0)))
                cin = width * 4
            stages.append(_children(nn.Module(),
                                    (("blocks", nn.ModuleList(blocks)),)))
            width *= 2
        self.stages = nn.ModuleList(stages)

    def forward(self, x):
        """Returns (stage 0, stage 1, stage 2) outputs."""
        h = group_norm(std_conv_same(x, self.stem.conv.weight, stride=2),
                       self.stem.norm)
        h = max_pool_same(h)
        taps = []
        for stage in self.stages:
            for blk in stage.blocks:
                h = blk(h)
            taps.append(h)
        return taps


class VisionTransformer(nn.Module):
    """timm vision_transformer semantics with the DPT hooks
    (``pretrained.model``; dpt.py:253-286)."""

    def __init__(self, cfg: DPTConfig, grid: int):
        super().__init__()
        C = cfg.vit_dim
        self.cfg = cfg
        self.cls_token = nn.Parameter(torch.empty(1, 1, C))
        self.pos_embed = nn.Parameter(torch.empty(1, grid * grid + 1, C))
        if cfg.hybrid:
            rn_out = 64 * 4 * 2 ** (len(cfg.rn_layers) - 1)
            self.patch_embed = _children(nn.Module(), (
                ("backbone", ResNetV2(cfg.rn_layers)),
                ("proj", nn.Conv2d(rn_out, C, 1))))
        else:
            self.patch_embed = _children(nn.Module(), (
                ("proj", nn.Conv2d(3, C, cfg.patch, stride=cfg.patch)),))
        self.blocks = nn.ModuleList(
            Block(C, cfg.vit_heads, cfg.vit_mlp) for _ in range(cfg.vit_depth))

    def forward(self, x):
        """x: [N,3,H,W].  Returns the 4 hooked activations (token sequences
        [N,T,C] for transformer hooks, NCHW maps for ResNet taps) and the
        token grid."""
        cfg = self.cfg
        n = x.shape[0]
        taps = {}
        pe = self.patch_embed
        if cfg.hybrid:
            taps[0], taps[1], h = pe.backbone(x)
            tokens = pe.proj(h)
        else:
            tokens = pe.proj(x)
        gh, gw = tokens.shape[2], tokens.shape[3]
        tokens = tokens.flatten(2).transpose(1, 2)
        cls = self.cls_token.expand(n, 1, tokens.shape[-1])
        tokens = torch.cat([cls, tokens], dim=1)
        tokens = tokens + resize_pos_embed(self.pos_embed, gh, gw)
        for i, blk in enumerate(self.blocks):
            tokens = blk(tokens)
            if i in cfg.hooks[2:] or (not cfg.hybrid and i in cfg.hooks):
                taps[i] = tokens
        layers = ([taps[0], taps[1], taps[cfg.hooks[2]], taps[cfg.hooks[3]]]
                  if cfg.hybrid else [taps[hk] for hk in cfg.hooks])
        return layers, (gh, gw)


class Reassemble(nn.Module):
    """``pretrained.act_postprocessN`` (dpt.py:289-315): the 'project'
    readout (``0.project.0``), a 1x1 conv (``3``) and the resample
    (``4``: a k = stride transpose conv, or a 3x3 stride-2 conv)."""

    def __init__(self, C: int, cout: int, kind: str):
        super().__init__()
        self.kind = kind
        self.add_module("0", _children(nn.Module(), (
            ("project", nn.Sequential(nn.Linear(2 * C, C))),)))
        self.add_module("3", nn.Conv2d(C, cout, 1))
        if kind in ("up4", "up2"):
            k = 4 if kind == "up4" else 2
            self.add_module("4", nn.ConvTranspose2d(cout, cout, k, stride=k))
        elif kind == "down2":
            self.add_module("4", nn.Conv2d(cout, cout, 3, stride=2,
                                           padding=1))

    def forward(self, tokens, grid):
        gh, gw = grid
        m = self._modules
        cls = tokens[:, :1].expand(-1, tokens.shape[1] - 1, -1)
        f = torch.cat([tokens[:, 1:], cls], dim=-1)   # [patches, cls]
        f = F.gelu(m["0"].project[0](f))
        f = f.transpose(1, 2).reshape(f.shape[0], f.shape[2], gh, gw)
        f = m["3"](f)
        return m["4"](f) if "4" in m else f


class ResidualConvUnit(nn.Module):
    def __init__(self, F_: int, use_bn: bool):
        super().__init__()
        self.use_bn = use_bn
        self.conv1 = nn.Conv2d(F_, F_, 3, padding=1, bias=not use_bn)
        self.conv2 = nn.Conv2d(F_, F_, 3, padding=1, bias=not use_bn)
        if use_bn:
            self.bn1 = BatchNormInference(F_)
            self.bn2 = BatchNormInference(F_)

    def forward(self, x):
        """dpt.py:318-327."""
        h = self.conv1(F.relu(x))
        if self.use_bn:
            h = batch_norm_inference(h, self.bn1)
        h = self.conv2(F.relu(h))
        if self.use_bn:
            h = batch_norm_inference(h, self.bn2)
        return h + x


class FeatureFusionBlock(nn.Module):
    def __init__(self, F_: int, use_bn: bool):
        super().__init__()
        self.resConfUnit1 = ResidualConvUnit(F_, use_bn)
        self.resConfUnit2 = ResidualConvUnit(F_, use_bn)
        self.out_conv = nn.Conv2d(F_, F_, 1)

    def forward(self, x, skip=None):
        """FeatureFusionBlock_custom (dpt.py:330-336)."""
        if skip is not None:
            x = x + self.resConfUnit1(skip)
        x = self.resConfUnit2(x)
        x = resize_bilinear_ac(x, x.shape[2] * 2, x.shape[3] * 2)
        return self.out_conv(x)


class DPT(nn.Module):
    """DPT with a depth or segmentation head; ``grid`` is the side of the
    pos-embed's square token grid (24 in the 384 checkpoints)."""

    def __init__(self, cfg: DPTConfig, grid: int = 24):
        super().__init__()
        self.cfg = cfg
        C, F_, ra = cfg.vit_dim, cfg.features, cfg.reassemble
        posts = [("act_postprocess3", Reassemble(C, ra[2], "none")),
                 ("act_postprocess4", Reassemble(C, ra[3], "down2"))]
        if not cfg.hybrid:
            posts = [("act_postprocess1", Reassemble(C, ra[0], "up4")),
                     ("act_postprocess2", Reassemble(C, ra[1], "up2"))
                     ] + posts
        self.pretrained = _children(nn.Module(), (
            ("model", VisionTransformer(cfg, grid)), *posts))
        scratch = _children(nn.Module(), (
            (f"layer{i}_rn", nn.Conv2d(cin, F_, 3, padding=1, bias=False))
            for i, cin in enumerate(ra, 1)))
        for i in range(1, 5):
            scratch.add_module(f"refinenet{i}",
                               FeatureFusionBlock(F_, cfg.use_bn))
        if cfg.head == "depth":
            head = (("0", nn.Conv2d(F_, F_ // 2, 3, padding=1)),
                    ("2", nn.Conv2d(F_ // 2, 32, 3, padding=1)),
                    ("4", nn.Conv2d(32, 1, 1)))
        else:
            head = (("0", nn.Conv2d(F_, F_, 3, padding=1, bias=False)),
                    ("1", BatchNormInference(F_)),
                    ("4", nn.Conv2d(F_, cfg.num_classes, 1)))
        scratch.add_module("output_conv", _children(nn.Module(), head))
        self.scratch = scratch

    def forward(self, x):
        """x: [N,3,H,W] normalized (H, W multiples of 32).  Returns [N,H,W]
        inverse depth or [N,C,H,W] logits (dpt.py:334-375)."""
        cfg = self.cfg
        pre, sc = self.pretrained, self.scratch
        layers, grid = pre.model(x)
        if cfg.hybrid:
            l1, l2 = layers[0], layers[1]
        else:
            l1 = pre.act_postprocess1(layers[0], grid)
            l2 = pre.act_postprocess2(layers[1], grid)
        l3 = pre.act_postprocess3(layers[2], grid)
        l4 = pre.act_postprocess4(layers[3], grid)
        r1, r2, r3, r4 = (getattr(sc, f"layer{i}_rn")(l)
                          for i, l in enumerate((l1, l2, l3, l4), 1))
        p = sc.refinenet4(r4)
        p = sc.refinenet3(p, r3)
        p = sc.refinenet2(p, r2)
        p = sc.refinenet1(p, r1)
        h = sc.output_conv._modules
        if cfg.head == "depth":
            y = h["0"](p)
            y = resize_bilinear_ac(y, y.shape[2] * 2, y.shape[3] * 2)
            y = h["4"](F.relu(h["2"](y)))
            if cfg.non_negative:
                y = F.relu(y)
            return y[:, 0]
        y = F.relu(batch_norm_inference(h["0"](p), h["1"]))
        y = h["4"](y)
        return resize_bilinear_ac(y, y.shape[2] * 2, y.shape[3] * 2)


@contextlib.contextmanager
def float32_exact():
    """float32 without TF32 in cuDNN's convolutions and in matmuls, for the
    block only (the JAX module's ``Precision.HIGHEST``).  cuDNN times its
    algorithms once per shape (``benchmark``): without TF32 its heuristics
    take an FFT convolution for some 3x3 convs at 192x192 (a 384x384
    input), 33,024 launches and a 17 GB workspace an image on an H100."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.backends.cudnn.flags(enabled=True, benchmark=True,
                                        allow_tf32=False):
            yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def dpt_forward(model: DPT, x):
    """x: [N,H,W,3] normalized (numpy or tensor).  Returns [N,H,W] inverse
    depth (head 'depth') or [N,H,W,num_classes] logits ('segmentation'),
    on the model's device."""
    dev = next(model.parameters()).device
    x = torch.as_tensor(x, dtype=torch.float32, device=dev)
    with torch.no_grad(), float32_exact():
        y = model(x.permute(0, 3, 1, 2))
    return y if model.cfg.head == "depth" else y.permute(0, 2, 3, 1)


# --------------------------------------------------------------------------
# building a model: official state dicts, random init, JAX pytrees
# --------------------------------------------------------------------------

def _grid_of(state_dict) -> int:
    n = state_dict["pretrained.model.pos_embed"].shape[1] - 1
    return int(round(math.sqrt(n)))


def from_state_dict(state_dict, cfg: DPTConfig, device="cuda") -> DPT:
    """A model on ``device`` (eval mode, no gradients) from an official
    state dict: exactly the keys the JAX converter reads are taken (a
    missing one raises ``KeyError``), every other key is ignored."""
    dev = resolve_device(device)
    with torch.device("meta"):
        model = DPT(cfg, _grid_of(state_dict))
    picked = {k: torch.as_tensor(state_dict[k],
                                 dtype=torch.float32).contiguous()
              for k in model.state_dict()}
    model.load_state_dict(picked, assign=True)
    return model.to(dev).eval().requires_grad_(False)


def init_params(cfg: DPTConfig, generator: torch.Generator, grid: int = 24,
                device="cuda") -> DPT:
    """A random model with the checkpoints' shapes: N(0, 0.02) weights,
    cls token and pos-embed drawn from ``generator`` in the module's order,
    zero biases, unit norm scales, BN statistics (0, 1), as JAX's
    ``init_params`` (dpt.py:386-499) sets them; the draws differ (a stated
    divergence)."""
    dev = resolve_device(device)
    with torch.device("meta"):
        model = DPT(cfg, grid)
    sd = {}
    for mname, mod in model.named_modules():
        for pname, t in list(mod.named_parameters(recurse=False)) + list(
                mod.named_buffers(recurse=False)):
            key = f"{mname}.{pname}" if mname else pname
            norm = isinstance(mod, (nn.LayerNorm, nn.GroupNorm,
                                    BatchNormInference))
            if pname in ("weight", "running_var") and norm:
                v = torch.ones(t.shape)
            elif pname in ("bias", "running_mean"):
                v = torch.zeros(t.shape)
            else:
                v = torch.randn(t.shape, generator=generator) * 0.02
            sd[key] = v
    model.load_state_dict(sd, assign=True)
    return model.to(dev).eval().requires_grad_(False)


def _official_state_dict(params, cfg: DPTConfig) -> dict:
    """A JAX ``dpt.py`` pytree as an official state dict: the inverse of
    the JAX ``weights.py`` transposes (HWIO -> OIHW, [in,out] -> [out,in],
    [k,k,in,out] -> [in,out,k,k])."""
    sd = {}

    def arr(v):
        return np.asarray(v, np.float32)

    def conv(key, w):
        sd[key] = arr(w).transpose(3, 2, 0, 1)

    def lin(key, w):
        sd[key] = arr(w).T

    def put(key, v):
        sd[key] = arr(v)

    def bn(prefix, p):
        put(prefix + ".weight", p["gamma"])
        put(prefix + ".bias", p["beta"])
        put(prefix + ".running_mean", p["mean"])
        put(prefix + ".running_var", p["var"])

    bb = params["backbone"]
    put("pretrained.model.cls_token", bb["cls_token"])
    put("pretrained.model.pos_embed", bb["pos_embed"])
    conv("pretrained.model.patch_embed.proj.weight", bb["patch_w"])
    put("pretrained.model.patch_embed.proj.bias", bb["patch_b"])
    for i, blk in enumerate(bb["blocks"]):
        p = f"pretrained.model.blocks.{i}."
        put(p + "norm1.weight", blk["norm1_g"])
        put(p + "norm1.bias", blk["norm1_b"])
        lin(p + "attn.qkv.weight", blk["attn"]["qkv_w"])
        put(p + "attn.qkv.bias", blk["attn"]["qkv_b"])
        lin(p + "attn.proj.weight", blk["attn"]["proj_w"])
        put(p + "attn.proj.bias", blk["attn"]["proj_b"])
        put(p + "norm2.weight", blk["norm2_g"])
        put(p + "norm2.bias", blk["norm2_b"])
        lin(p + "mlp.fc1.weight", blk["fc1_w"])
        put(p + "mlp.fc1.bias", blk["fc1_b"])
        lin(p + "mlp.fc2.weight", blk["fc2_w"])
        put(p + "mlp.fc2.bias", blk["fc2_b"])
    if cfg.hybrid:
        stem = "pretrained.model.patch_embed.backbone.stem."
        conv(stem + "conv.weight", bb["stem"]["conv_w"])
        put(stem + "norm.weight", bb["stem"]["norm_g"])
        put(stem + "norm.bias", bb["stem"]["norm_b"])
        for si, stage in enumerate(bb["stages"]):
            for bi, blk in enumerate(stage["blocks"]):
                p = (f"pretrained.model.patch_embed.backbone.stages.{si}"
                     f".blocks.{bi}.")
                for j in (1, 2, 3):
                    conv(p + f"conv{j}.weight", blk[f"conv{j}_w"])
                    put(p + f"norm{j}.weight", blk[f"norm{j}_g"])
                    put(p + f"norm{j}.bias", blk[f"norm{j}_b"])
                if "downsample" in blk:
                    ds = blk["downsample"]
                    conv(p + "downsample.conv.weight", ds["conv_w"])
                    put(p + "downsample.norm.weight", ds["norm_g"])
                    put(p + "downsample.norm.bias", ds["norm_b"])
    for n in (1, 2, 3, 4):
        if f"post{n}" not in params:
            continue
        d, p = params[f"post{n}"], f"pretrained.act_postprocess{n}."
        lin(p + "0.project.0.weight", d["readout"]["w"])
        put(p + "0.project.0.bias", d["readout"]["b"])
        conv(p + "3.weight", d["conv_w"])
        put(p + "3.bias", d["conv_b"])
        if "up_w" in d:
            sd[p + "4.weight"] = arr(d["up_w"]).transpose(2, 3, 0, 1)
            put(p + "4.bias", d["up_b"])
        elif "down_w" in d:
            conv(p + "4.weight", d["down_w"])
            put(p + "4.bias", d["down_b"])
    sc = params["scratch"]
    for i in (1, 2, 3, 4):
        conv(f"scratch.layer{i}_rn.weight", sc[f"layer{i}_w"])
        f, p = sc[f"refinenet{i}"], f"scratch.refinenet{i}."
        for r, name in (("rcu1", "resConfUnit1"), ("rcu2", "resConfUnit2")):
            for j in (1, 2):
                conv(p + f"{name}.conv{j}.weight", f[r][f"conv{j}_w"])
                if cfg.use_bn:
                    bn(p + f"{name}.bn{j}", f[r][f"bn{j}"])
                else:
                    put(p + f"{name}.conv{j}.bias", f[r][f"conv{j}_b"])
        conv(p + "out_conv.weight", f["out_w"])
        put(p + "out_conv.bias", f["out_b"])
    h, p = params["head"], "scratch.output_conv."
    conv(p + "0.weight", h["conv1_w"])
    if cfg.head == "depth":
        put(p + "0.bias", h["conv1_b"])
        conv(p + "2.weight", h["conv2_w"])
        put(p + "2.bias", h["conv2_b"])
        conv(p + "4.weight", h["conv3_w"])
        put(p + "4.bias", h["conv3_b"])
    else:
        bn(p + "1", h["bn"])
        conv(p + "4.weight", h["conv2_w"])
        put(p + "4.bias", h["conv2_b"])
    return sd


def params_from_numpy(jax_params, cfg: DPTConfig, device="cuda") -> DPT:
    """The model holding a JAX ``dpt.py`` param pytree (numpy or JAX
    arrays), for parity with ``dpt_forward`` of the JAX package."""
    return from_state_dict(_official_state_dict(jax_params, cfg), cfg,
                           device)
