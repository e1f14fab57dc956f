"""The port's data-prep half against the JAX package on the CPU: the
converters (``data/converters.py``), the COLMAP driver
(``scripts/convert.py``) with a stub ``colmap``, and the native I/O
(``data/native.py``, the native paths of ``data/ply.py`` and
``data/colmap.py``), byte for byte and dtype for dtype."""
import json
import os
import shutil
import struct
import sys

import numpy as np
import pytest
from PIL import Image

from gsplat_tpu.data import colmap as jcolmap
from gsplat_tpu.data import converters as jconv
from gsplat_tpu.data import native as jnative
from gsplat_tpu.data import ply as jply
from gsplat_tpu.scripts import convert as jconvert
from gsplat_tpu_torch.data import colmap as tcolmap
from gsplat_tpu_torch.data import converters as tconv
from gsplat_tpu_torch.data import native as tnative
from gsplat_tpu_torch.data import ply as tply
from gsplat_tpu_torch.data.readers import store_ply
from gsplat_tpu_torch.scripts import convert as tconvert

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _bytes(path):
    with open(path, "rb") as f:
        return f.read()


def _tree(root):
    """{relative path: bytes} of every file under ``root``."""
    out = {}
    for d, _, fs in os.walk(root):
        for f in fs:
            p = os.path.join(d, f)
            out[os.path.relpath(p, root)] = _bytes(p)
    return out


def _slam_root(root, rng):
    """Twelve SLAM poses along a bent path, their 16x12 images, a polycam
    export and a depth folder."""
    os.makedirs(os.path.join(root, "images"))
    lines = []
    for i in range(12):
        q = rng.standard_normal(4)
        R = jcolmap.qvec2rotmat(q / np.linalg.norm(q))
        t = np.array([i * 1.3, 0.2 * i * i, -0.5 * i]) + rng.normal(0, .1, 3)
        lines.append(f"{i} " + " ".join(repr(float(v)) for v in
                                        np.hstack([R, t[:, None]]).ravel()))
        Image.fromarray(rng.integers(0, 255, (12, 16, 3), dtype=np.uint8)
                        ).save(os.path.join(root, "images", f"{i}.jpg"))
    for name in ("KeyFramePose.txt", "Pose.txt"):
        with open(os.path.join(root, name), "w") as f:
            f.write("\n".join(lines) + "\n")
    cams = os.path.join(root, "poly", "keyframes", "cameras")
    os.makedirs(cams)
    for i in range(3):
        c = {f"t_{r}{k}": float(v) for r in range(3) for k, v in
             enumerate(rng.standard_normal(4))}
        c.update(fx=200.0 + i, width=64, height=48)
        with open(os.path.join(cams, f"{i:03d}.json"), "w") as f:
            json.dump(c, f)
    os.makedirs(os.path.join(root, "depth"))
    for i in range(2):
        Image.fromarray(rng.integers(0, 900, (10, 14)).astype(np.uint16)
                        ).save(os.path.join(root, "depth", f"{i}.png"))


def test_converters_match_jax(tmp_path):
    """slam_to_nerf, compute_block_seq, split_blocks, nerf_to_poses_bounds,
    polycam_to_poses_bounds and normalize_depth_folder: the same JSON text,
    ``.npy`` bytes, copied images and PNG bytes as the JAX module."""
    intr = dict(fl_x=500.0, fl_y=505.0, cx=8, cy=6, w=16, h=12, k1=0.01)
    roots = {}
    for tag, mod in (("jax", jconv), ("port", tconv)):
        root = str(tmp_path / tag)
        _slam_root(root, np.random.default_rng(3))
        tf = mod.slam_to_nerf(root, intr)
        blocks = mod.compute_block_seq(root, K=4.0)
        assert len(blocks) >= 3
        mod.split_blocks(root, intr, blocks)
        mod.nerf_to_poses_bounds(tf)
        mod.nerf_to_poses_bounds(tf, near=0.5, far=9.0,
                                 out_path=os.path.join(root, "pb2.npy"))
        mod.polycam_to_poses_bounds(os.path.join(root, "poly"))
        mod.normalize_depth_folder(os.path.join(root, "depth"),
                                   os.path.join(root, "depth_norm"))
        roots[tag] = (root, blocks)
    assert roots["jax"][1] == roots["port"][1]
    assert tconv.compute_block_seq(roots["port"][0], K=100.0) == \
        jconv.compute_block_seq(roots["jax"][0], K=100.0)
    jt, pt = _tree(roots["jax"][0]), _tree(roots["port"][0])
    assert sorted(jt) == sorted(pt) and len(jt) > 40
    for k in jt:
        assert jt[k] == pt[k], k
    poses = tconv.read_slam_poses(os.path.join(roots["port"][0],
                                               "KeyFramePose.txt"))
    for k, v in jconv.read_slam_poses(os.path.join(
            roots["jax"][0], "KeyFramePose.txt")).items():
        assert poses[k].dtype == v.dtype and np.array_equal(poses[k], v)


STUB = r'''#!{python}
"""A stand-in for colmap: logs its arguments and writes what the converter
reads next (a sparse model from the mapper, an undistorted scene)."""
import os, shutil, sys
args = sys.argv[1:]
with open(os.environ["COLMAP_STUB_LOG"], "a") as f:
    f.write(" ".join(args) + "\n")
opt = dict(zip(args[1::2], args[2::2]))
if args[0] == "mapper":
    os.makedirs(os.path.join(opt["--output_path"], "0"), exist_ok=True)
if args[0] == "image_undistorter":
    out = opt["--output_path"]
    os.makedirs(os.path.join(out, "sparse"), exist_ok=True)
    for name in ("cameras.bin", "images.bin", "points3D.bin"):
        with open(os.path.join(out, "sparse", name), "wb") as f:
            f.write(name.encode())
    shutil.copytree(opt["--image_path"], os.path.join(out, "images"),
                    dirs_exist_ok=True)
'''


def test_convert_cli_matches_jax(tmp_path, monkeypatch):
    """Both COLMAP drivers with a stub ``colmap`` on ``PATH`` and through
    ``--colmap_executable``: the same logged command lines, ``sparse/0``
    tree and ``--resize`` pyramid bytes; exit 1 where there is no colmap."""
    bindir = tmp_path / "bin"
    bindir.mkdir()
    stub = bindir / "colmap"
    stub.write_text(STUB.replace("{python}", sys.executable))
    stub.chmod(0o755)
    monkeypatch.setenv("PATH", str(bindir) + os.pathsep
                       + os.environ.get("PATH", ""))
    for extra in ([], ["--no_gpu", "--skip_matching"]):
        trees, logs = {}, {}
        for tag, main in (("jax", jconvert.main), ("port", tconvert.main)):
            rng = np.random.default_rng(4)
            src = tmp_path / f"{tag}{len(extra)}"
            (src / "input").mkdir(parents=True)
            for i in range(3):
                Image.fromarray(rng.integers(0, 255, (37, 50, 3),
                                             dtype=np.uint8)).save(
                    src / "input" / f"im{i}.png")
            if extra:          # --skip_matching: the model is there
                (src / "distorted" / "sparse" / "0").mkdir(parents=True)
            log = tmp_path / f"{tag}{len(extra)}.log"
            monkeypatch.setenv("COLMAP_STUB_LOG", str(log))
            flags = (["--colmap_executable", str(stub)] + extra if extra
                     else ["--resize"])
            main(["-s", str(src), *flags])
            logs[tag] = log.read_text().replace(str(src), "<src>")
            trees[tag] = _tree(src)
        assert logs["jax"] == logs["port"]
        assert len(logs["port"].splitlines()) == (1 if extra else 4)
        assert trees["jax"] == trees["port"]
        assert set(trees["port"]) >= {os.path.join("sparse", "0", n) for n in
                                      ("cameras.bin", "images.bin",
                                       "points3D.bin")}
        if not extra:
            assert os.path.join("images_8", "im2.png") in trees["port"]
    monkeypatch.setenv("PATH", str(tmp_path / "empty"))
    for main in (jconvert.main, tconvert.main):
        with pytest.raises(SystemExit) as e:
            main(["-s", str(tmp_path / "port0")])
        assert e.value.code == 1


def _write_points3d_bin(path, xyz, rgb, err):
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(xyz)))
        for i, (p, c, e) in enumerate(zip(xyz, rgb, err)):
            f.write(struct.pack("<q3d3BdQ", i, *p, *c, e, 1))
            f.write(struct.pack("<ii", 1, i))


def _write_images_bin(path):
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", 2))
        for iid, name in ((3, "a.jpg"), (8, "long_name_b.png")):
            f.write(struct.pack("<i7di", iid, 0.9, 0.1, 0.2, 0.3, 1.5, -2.0,
                                3.25, 1))
            f.write(name.encode() + b"\x00" + struct.pack("<Q", 1))
            f.write(struct.pack("<ddq", 10.5, 20.25, 7))


def _same(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k


def test_native_io_matches_jax(tmp_path, monkeypatch):
    """Each ctypes wrapper against the JAX module's; ``read_ply`` of a PLY
    over 1 MiB with ``uchar`` colours and ``read_points3D_binary`` equal to
    JAX's in keys, dtypes and values, through the library (counted) and,
    with no library, through the pure-python paths; the library built into
    the port's ``_build`` where the committed one does not load, and
    nothing written into ``native/``."""
    before = sorted(os.listdir(os.path.join(REPO, "native")))
    assert tnative.available() == jnative.available() is True
    lib = tnative.library_path()
    assert lib == os.path.join(REPO, "native", "libgsplat_io.so") or \
        lib.startswith(os.path.join(REPO, "gsplat_tpu_torch", "_build"))
    rng = np.random.default_rng(6)
    n = 50_000
    xyz = rng.standard_normal((n, 3)) * 3
    rgb = rng.integers(0, 256, (n, 3))
    big = str(tmp_path / "big.ply")
    store_ply(big, xyz, rgb)
    assert os.path.getsize(big) > (1 << 20)
    small = str(tmp_path / "small.ply")
    store_ply(small, xyz[:100], rgb[:100])
    pts = str(tmp_path / "points3D.bin")
    _write_points3d_bin(pts, xyz[:2000] + 1e-9, rgb[:2000],
                        rng.uniform(0, 2, 2000))
    imgs = str(tmp_path / "images.bin")
    _write_images_bin(imgs)

    tnative.reset_call_counts()
    got = tply.read_ply(big)
    assert got["red"].dtype == np.float32 and tnative.call_counts[
        "ply_read"] == 1
    _same(got, jply.read_ply(big))
    _same(tply.read_ply(small), jply.read_ply(small))   # python path
    assert tply.read_ply(small)["red"].dtype == np.uint8
    names = ["x", "red", "nz"]
    assert np.array_equal(tnative.ply_read_props(big, names),
                          jnative.ply_read_props(big, names))
    data = rng.standard_normal((300, 3)).astype(np.float32)
    assert tnative.ply_write_props(str(tmp_path / "t.ply"), names, data)
    assert jnative.ply_write_props(str(tmp_path / "j.ply"), names, data)
    assert _bytes(tmp_path / "t.ply") == _bytes(tmp_path / "j.ply")
    for a, b in zip(tcolmap.read_points3D_binary(pts),
                    jcolmap.read_points3D_binary(pts)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    for a, b in zip(tnative.read_images_binary_meta(imgs),
                    jnative.read_images_binary_meta(imgs)):
        assert np.array_equal(a, b)
    assert tnative.call_counts == {"points3d": 1, "images": 1,
                                   "ply_read": 2, "ply_write": 1}

    # no library at all: both packages' pure-python paths
    for mod in (tnative, jnative):
        monkeypatch.setattr(mod, "_lib", None)
        monkeypatch.setattr(mod, "_tried", True)
    assert not tnative.available()
    _same(tply.read_ply(big), jply.read_ply(big))
    assert tply.read_ply(big)["red"].dtype == np.uint8
    for a, b in zip(tcolmap.read_points3D_binary(pts),
                    jcolmap.read_points3D_binary(pts)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert tnative.call_counts["points3d"] == 1

    # the committed library does not load: the source built into _build
    built = str(tmp_path / "_build" / "libgsplat_io.so")
    monkeypatch.setattr(tnative, "_tried", False)
    monkeypatch.setattr(tnative, "_lib_path", None)
    monkeypatch.setattr(tnative, "_COMMITTED", str(tmp_path / "none.so"))
    monkeypatch.setattr(tnative, "_BUILT", built)
    if shutil.which("g++"):
        assert tnative.available() and tnative.library_path() == built
        _same(tply.read_ply(big), got)
    assert sorted(os.listdir(os.path.join(REPO, "native"))) == before
