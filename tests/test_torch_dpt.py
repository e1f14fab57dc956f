"""The port's DPT (``gsplat_tpu_torch/depth``) and its CLIs against the JAX
package on the CPU: the published DPT-Hybrid at a shrinking pos-embed
grid, the tiny configurations of ``tests/test_dpt.py``, the transforms'
bytes, and both inference CLIs.  Each forward is held to JAX's
``dpt_forward`` under ``jax.jit`` at ``tests/test_dpt.py``'s tolerance
(atol 2e-4, rtol 1e-3)."""
import dataclasses
import gc
import os

import numpy as np
import pytest
import torch
from PIL import Image

import jax
import jax.numpy as jnp
from gsplat_tpu.depth import dpt as jdpt
from gsplat_tpu.depth import transforms as jT
from gsplat_tpu.depth import weights as jweights
from gsplat_tpu.scripts import run_monodepth as jmono
from gsplat_tpu.scripts import run_segmentation as jseg
from gsplat_tpu_torch.depth import dpt as tdpt
from gsplat_tpu_torch.depth import transforms as tT
from gsplat_tpu_torch.depth import weights as tweights
from gsplat_tpu_torch.scripts import run_monodepth as tmono
from gsplat_tpu_torch.scripts import run_segmentation as tseg

import torch_helpers  # noqa: F401  (thread count)

ATOL, RTOL = 2e-4, 1e-3          # tests/test_dpt.py:430


def tiny_cfg(hybrid=False, head="depth", num_classes=7):
    """tests/test_dpt.py:22-31's tiny configurations."""
    reassemble = (256, 512, 32, 40) if hybrid else (16, 24, 32, 40)
    return jdpt.DPTConfig(
        backbone="tiny", features=32, reassemble=reassemble,
        hooks=(0, 1, 2, 3), vit_dim=48, vit_depth=4, vit_heads=4, vit_mlp=64,
        hybrid=hybrid, rn_layers=(1, 1, 1), head=head,
        num_classes=num_classes, use_bn=(head == "segmentation"))


def port_cfg(cfg):
    return tdpt.DPTConfig(**dataclasses.asdict(cfg))


class Recording(dict):
    """A state dict that records the keys a converter reads."""

    def __init__(self, *a):
        super().__init__(*a)
        self.read = set()

    def __getitem__(self, k):
        self.read.add(k)
        return super().__getitem__(k)


def official_sd(cfg, grid, seed):
    """An official-schema state dict drawn with numpy: the keys and shapes
    of the port's module (which JAX's ``convert_state_dict`` must find, key
    for key), weights N(0, 1/fan_in), norm scales and BN variances near 1,
    biases and means near 0, so that activations stay of order one."""
    with torch.device("meta"):
        shapes = {k: tuple(t.shape) for k, t in
                  tdpt.DPT(port_cfg(cfg), grid).state_dict().items()}
    rng = np.random.default_rng(seed)
    sd = {}
    for k, shape in shapes.items():
        z = rng.standard_normal(shape, dtype=np.float32)
        if k.endswith(("cls_token", "pos_embed")):
            v = z * 0.5
        elif len(shape) >= 2:
            v = z / np.float32(np.sqrt(np.prod(shape[1:])))
        elif k.endswith("running_var"):
            v = 1 + 0.1 * np.abs(z)
        elif k.endswith("weight"):
            v = 1 + 0.1 * z
        else:
            v = 0.1 * z
        sd[k] = v
    return sd


def jax_forward(params, cfg, x):
    params = jax.tree_util.tree_map(jnp.asarray, params)
    return np.asarray(jax.jit(lambda p, v: jdpt.dpt_forward(p, cfg, v))(
        params, jnp.asarray(x)))


def close(got, want):
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


def test_published_hybrid_matches_jax(tmp_path):
    """``dpt_config("dpt_hybrid")`` (122,376,449 parameters) at 64x96: the
    24x24 pos-embed shrinks to 4x6 and the SAME pads are asymmetric at
    full channel counts.  One official-schema state dict (plus keys JAX
    ignores) through JAX's ``convert_state_dict`` and the port's
    ``load_torch``; JAX reads exactly the port's keys."""
    cfg = jdpt.dpt_config("dpt_hybrid")
    sd = Recording(official_sd(cfg, 24, seed=0))
    n_params = sum(v.size for v in sd.values())
    assert n_params == 122376449
    x = np.random.default_rng(1).standard_normal((1, 64, 96, 3)).astype(
        np.float32)
    want = jax_forward(jweights.convert_state_dict(sd, cfg), cfg, x)
    assert sd.read == set(sd)
    extra = {"pretrained.model.norm.weight": np.ones(768, np.float32),
             "pretrained.model.head.weight": np.ones((2, 768), np.float32),
             "pretrained.model.blocks.0.attn.attn_mask": np.ones(3,
                                                                np.float32)}
    path = str(tmp_path / "dpt_hybrid.pt")
    torch.save({"state_dict": {k: torch.from_numpy(v) for k, v in
                               {**sd, **extra}.items()}}, path)
    del sd
    model = tweights.load_torch(path, port_cfg(cfg), device="cpu")
    os.remove(path)
    assert not model.training and model.pretrained.model.pos_embed.shape == (
        1, 577, 768)
    got = tdpt.dpt_forward(model, x).numpy()
    assert got.shape == (1, 64, 96) and float(np.abs(want).max()) > 1e-2
    close(got, want)
    del model
    gc.collect()


def jax_params(cfg, seed):
    """The pytree of JAX's ``init_params`` (its structure and shapes, from
    ``jax.eval_shape``: the eager draws take seconds a leaf shape) filled
    with numpy draws: weights (HWIO, [in, out]) N(0, 1/fan_in), vectors
    N(0, 0.1) around JAX's init value (1 for scales and variances)."""
    rng = np.random.default_rng(seed)
    tree = jax.eval_shape(lambda: jdpt.init_params(jax.random.PRNGKey(0),
                                                   cfg, grid=4))

    def draw(path, leaf):
        z = rng.standard_normal(leaf.shape).astype(np.float32)
        if len(leaf.shape) >= 2:
            return z / np.float32(np.sqrt(np.prod(leaf.shape[:-1])))
        name = jax.tree_util.keystr(path)
        base = 1.0 if any(s in name for s in ("_g'", "'gamma'", "'var'")) \
            else 0.0
        return base + 0.1 * z
    return jax.tree_util.tree_map_with_path(draw, tree)


def test_tiny_configs_match_jax():
    """The tiny ViT depth, hybrid depth and ViT segmentation models as
    JAX's ``init_params`` pytree (``jax_params``) through
    ``params_from_numpy``, at an input that shrinks the 4x4 grid (2x2, two
    images) and one that grows it (6x8); a missing key raises
    ``KeyError``, an extra key is ignored."""
    xs = [np.random.default_rng(s).standard_normal(shape).astype(np.float32)
          for s, shape in ((3, (2, 32, 32, 3)), (4, (1, 96, 128, 3)))]
    for i, (hybrid, head) in enumerate(((False, "depth"), (True, "depth"),
                                        (False, "segmentation"))):
        cfg = tiny_cfg(hybrid, head)
        params = jax_params(cfg, 10 + i)
        model = tdpt.params_from_numpy(params, port_cfg(cfg), device="cpu")
        for x in xs:
            want = jax_forward(params, cfg, x)
            got = tdpt.dpt_forward(model, x).numpy()
            assert got.shape == want.shape, (cfg, got.shape, want.shape)
            assert float(np.abs(want).max()) > 1e-2
            close(got, want)
        sd = tdpt._official_state_dict(params, port_cfg(cfg))
        again = tdpt.from_state_dict({**sd, "pretrained.model.norm.bias":
                                      np.zeros(48, np.float32)},
                                     port_cfg(cfg), device="cpu")
        assert torch.equal(tdpt.dpt_forward(again, xs[0]),
                           tdpt.dpt_forward(model, xs[0]))
        del sd["scratch.refinenet2.out_conv.bias"]
        with pytest.raises(KeyError, match="refinenet2.out_conv.bias"):
            tdpt.from_state_dict(sd, port_cfg(cfg), device="cpu")


def test_transforms_match_jax(tmp_path):
    """Every resize policy, ``prepare``, ``read_image``,
    ``resize_prediction`` and ``list_images`` equal to the JAX module's;
    ``write_depth`` at 1 and 2 bytes, normalized and absolute, and a flat
    map, byte for byte."""
    for args in ((1920, 1080, 384, 384), (640, 480, 1216, 352),
                 (500, 375, 640, 480), (100, 300, 384, 384)):
        for method in ("minimal", "lower_bound", "upper_bound"):
            for keep in (True, False):
                assert tT.compute_resize(*args, method=method,
                                         keep_aspect=keep) == \
                    jT.compute_resize(*args, method=method, keep_aspect=keep)
    with pytest.raises(ValueError):
        tT.compute_resize(10, 10, 32, 32, method="nearest")
    rng = np.random.default_rng(5)
    img = (rng.uniform(0, 1, (45, 70, 3)) * 255).astype(np.uint8)
    Image.fromarray(img).save(tmp_path / "b.png")
    Image.fromarray(img[::-1]).save(tmp_path / "a.jpg")
    (tmp_path / "notes.txt").write_text("")
    assert tT.list_images(str(tmp_path)) == jT.list_images(str(tmp_path))
    for name in tT.list_images(str(tmp_path)):
        im = tT.read_image(name)
        np.testing.assert_array_equal(im, jT.read_image(name))
        for method in ("minimal", "upper_bound"):
            np.testing.assert_array_equal(
                tT.prepare(im, 384, 384, method=method),
                jT.prepare(im, 384, 384, method=method))
    pred = rng.standard_normal((24, 40)).astype(np.float32)
    np.testing.assert_array_equal(tT.resize_prediction(pred, 45, 70),
                                  jT.resize_prediction(pred, 45, 70))
    depth = rng.uniform(0.5, 200.0, (30, 20)).astype(np.float32)
    for bits in (1, 2):
        for absolute in (False, True):
            for d, tag in ((depth, "d"), (np.full_like(depth, 3.0), "flat")):
                stem = f"{tag}_{bits}_{int(absolute)}"
                t = tT.write_depth(str(tmp_path / f"t_{stem}"), d, bits,
                                   absolute)
                j = jT.write_depth(str(tmp_path / f"j_{stem}"), d, bits,
                                   absolute)
                with open(t, "rb") as ft, open(j, "rb") as fj:
                    assert ft.read() == fj.read(), stem


def test_cli_depth_and_segmentation_match_jax(tmp_path, monkeypatch):
    """``run_monodepth`` (with and without ``--absolute_depth``) and
    ``run_segmentation`` of both packages on two 40x30 images, each model
    a tiny configuration loaded from one official-schema ``.pt``: depth
    PNGs within 8 of 65535, class maps and overlays equal wherever the top
    two logits differ by more than 1e-4."""
    rng = np.random.default_rng(7)
    src = tmp_path / "images"
    src.mkdir()
    for name in ("f0.png", "f1.png"):
        Image.fromarray((rng.uniform(0, 1, (30, 40, 3)) * 255).astype(
            np.uint8)).save(src / name)
    ncls = 5
    cfgs = {"depth": tiny_cfg(), "segmentation": tiny_cfg(
        head="segmentation", num_classes=ncls)}
    pts = {}
    for head, cfg in cfgs.items():
        pts[head] = str(tmp_path / f"{head}.pt")
        torch.save({k: torch.from_numpy(v) for k, v in
                    official_sd(cfg, 4, seed=len(head)).items()}, pts[head])

    def tiny(model_type="dpt_hybrid", head="depth", num_classes=150):
        return dataclasses.replace(cfgs[head], num_classes=num_classes)

    def tiny_port(*a, **kw):
        return port_cfg(tiny(*a, **kw))

    monkeypatch.setattr(jdpt, "dpt_config", tiny)
    monkeypatch.setattr(tdpt, "dpt_config", tiny_port)

    def png(path):
        return np.asarray(Image.open(path)).astype(np.int64)

    for flags in ([], ["--absolute_depth"]):
        outs = {}
        for pkg, main, extra in (("jax", jmono.main, []),
                                 ("port", tmono.main,
                                  ["--data_device", "cpu"])):
            outs[pkg] = tmp_path / f"depth_{pkg}{len(flags)}"
            main(["-i", str(src), "-o", str(outs[pkg]), "-m", pts["depth"],
                  "-t", "dpt_hybrid", *flags, *extra])
        names = sorted(os.listdir(outs["jax"]))
        assert names == sorted(os.listdir(outs["port"])) == ["f0.png",
                                                              "f1.png"]
        for n in names:
            a, b = png(outs["jax"] / n), png(outs["port"] / n)
            assert a.shape == (30, 40) and a.max() > 0
            assert int(np.abs(a - b).max()) <= 8, (flags, n)

    outs = {}
    for pkg, main, extra in (("jax", jseg.main, []),
                             ("port", tseg.main, ["--data_device", "cpu"])):
        outs[pkg] = tmp_path / f"seg_{pkg}"
        main(["-i", str(src), "-o", str(outs[pkg]), "-m",
              pts["segmentation"], "--num_classes", str(ncls), *extra])
    assert sorted(os.listdir(outs["jax"])) == sorted(os.listdir(
        outs["port"])) == ["f0.png", "f0_overlay.png", "f1.png",
                           "f1_overlay.png"]
    model = tweights.load_torch(pts["segmentation"], tiny_port(
        head="segmentation", num_classes=ncls), device="cpu")
    for name in ("f0", "f1"):
        img = tT.read_image(str(src / f"{name}.png"))
        logits = tdpt.dpt_forward(model, tT.prepare(img)[None])[0].numpy()
        up = np.stack([tT.resize_prediction(logits[..., c], 30, 40)
                       for c in range(ncls)], axis=-1)
        top2 = np.sort(up, axis=-1)[..., -2:]
        clear = (top2[..., 1] - top2[..., 0]) > 1e-4
        assert clear.mean() > 0.9
        a, b = png(outs["jax"] / f"{name}.png"), png(outs["port"] /
                                                      f"{name}.png")
        assert (a[clear] == b[clear]).all() and len(np.unique(a)) > 1
        oa = png(outs["jax"] / f"{name}_overlay.png")
        ob = png(outs["port"] / f"{name}_overlay.png")
        assert (oa[clear] == ob[clear]).all()
