"""The viewing half of the port on the CPU, with no render: the splat wire
format (``viz/webgl_viewer.py``), the scene editor (``viz/editor.py``),
the HTTP viewer's key handling (``viz/render_app.py``) and the ``core``
leftovers, each against the JAX package on the same numpy inputs."""
import struct

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gsplat_tpu.core import sh as jsh
from gsplat_tpu.core import transforms as jT
from gsplat_tpu.models import gaussians as jgauss
from gsplat_tpu.viz import editor as jeditor
from gsplat_tpu.viz import render_app as japp
from gsplat_tpu.viz import webgl_viewer as jwv
from gsplat_tpu_torch.core import sh as tsh
from gsplat_tpu_torch.core import transforms as tT
from gsplat_tpu_torch.models import gaussians as tgauss
from gsplat_tpu_torch.viz import editor as teditor
from gsplat_tpu_torch.viz import render_app as tapp
from gsplat_tpu_torch.viz import webgl_viewer as twv

from torch_helpers import make_camera, model_state_np

FIELDS = tgauss.GaussianParams._fields


def _jax_model(p, alive, num_class=2):
    m = jgauss.GaussianModel(3, num_class=num_class, capacity=len(alive))
    m.params = jgauss.GaussianParams(**{k: jnp.asarray(p[k]) for k in FIELDS})
    m.aux = m.aux._replace(alive=jnp.asarray(alive))
    return m


def test_pack_splats_and_scene_info_match_jax():
    """``pack_splats`` on a model with dead slots: the 16-byte header and
    ``pos`` equal, ``cov6`` within 2e-6 of each splat's largest entry (the
    activations are each package's own float32 exp and normalisation) and
    equal to JAX's arithmetic on the port's activated rows, ``rgba``
    within one level; ``unpack_splats`` reads the port's buffer
    back to the alive rows; ``scene_info`` equal with and without a
    camera."""
    rng = np.random.default_rng(50)
    p = model_state_np(rng, n=250, capacity=300)
    alive = p.pop("alive")
    alive[rng.choice(250, 20, replace=False)] = False
    jm = _jax_model(p, alive)
    tm = tgauss.params_from_numpy(dict(p, alive=alive), device="cpu",
                                  num_class=2)
    jbuf, tbuf = jwv.pack_splats(jm), twv.pack_splats(tm)
    n = int(alive.sum())
    assert len(tbuf) == len(jbuf) == 16 + n * 40
    assert tbuf[:16] == jbuf[:16] == struct.pack("<IIII", twv.MAGIC, 1, n, 0)
    jpos, jcov, jrgba = jwv.unpack_splats(jbuf)
    tpos, tcov, trgba = twv.unpack_splats(tbuf)
    np.testing.assert_array_equal(tpos, jpos)
    np.testing.assert_array_equal(tpos, p["xyz"][alive])
    # the activated rows differ from JAX's by up to 2 float32 ulps (exp 1,
    # the quaternion's normalisation 2) and a covariance entry multiplies
    # five of them: up to 10 ulps of the splat's largest entry seen, 2e-6
    # allowed
    scale = np.abs(jcov).max(axis=1, keepdims=True)
    np.testing.assert_allclose(tcov / scale, jcov / scale, atol=2e-6, rtol=0)
    # on the port's own activated rows the arithmetic is JAX's, bit for bit
    rows = {k: getattr(tm, g)[torch.from_numpy(alive)].numpy() for k, g in (
        ("rot", "get_rotation"), ("scale", "get_scaling"))}
    M = jwv._quat_to_rotmat(rows["rot"]) * rows["scale"][:, None, :]
    cov = np.einsum("nij,nkj->nik", M, M)
    np.testing.assert_array_equal(tcov, cov[:, [0, 0, 0, 1, 1, 2],
                                            [0, 1, 2, 1, 2, 2]])
    assert np.abs(trgba.astype(int) - jrgba.astype(int)).max() <= 1
    assert twv.VIEWER_HTML == jwv.VIEWER_HTML and twv.SH_C0 == jwv.SH_C0
    with pytest.raises(ValueError):
        twv.unpack_splats(struct.pack("<IIII", 0xDEAD, 1, 0, 0))
    cam = make_camera(64, 48)
    assert twv.scene_info(tm) == jwv.scene_info(jm)
    assert twv.scene_info(tm, cam) == jwv.scene_info(jm, cam)
    empty = tgauss.GaussianModel(3, num_class=2, capacity=8, device="cpu")
    assert twv.scene_info(empty) == jwv.scene_info(
        jgauss.GaussianModel(3, num_class=2, capacity=8))
    assert twv.unpack_splats(twv.pack_splats(empty))[0].shape == (0, 3)


def _assert_editors_equal(je, te, what):
    jm, tm = je.model, te.model
    assert tm.capacity == jm.capacity, what
    for k in FIELDS:
        np.testing.assert_array_equal(getattr(tm.params, k).numpy(),
                                      np.asarray(getattr(jm.params, k)),
                                      err_msg=f"{what}: {k}")
    np.testing.assert_array_equal(tm.aux.alive.numpy(),
                                  np.asarray(jm.aux.alive), err_msg=what)
    np.testing.assert_array_equal(te.instance, je.instance, err_msg=what)
    for part in ("mu", "nu"):
        for k in FIELDS:
            np.testing.assert_array_equal(
                getattr(getattr(tm.opt_state, part), k).numpy(),
                np.asarray(getattr(getattr(jm.opt_state, part), k)),
                err_msg=f"{what}: {part}.{k}")


def test_scene_editor_matches_jax(tmp_path):
    """The editing sequence of the chip check at 300 gaussians: a PLY
    loaded into 512 slots with warm Adam moments, merged into itself
    translated (the model grows to 1,024 slots, the moments kept), a
    rotated box and class 1 selected, copied, the copy moved and scaled,
    the box removed, a clip saved.  After every edit each parameter
    field, ``alive``, ``instance`` and the moments equal the JAX editor's;
    the clip is JAX's file byte for byte and reloads to the selected rows;
    the alive counts are what the masks say."""
    rng = np.random.default_rng(51)
    p = model_state_np(rng, n=300, capacity=300)
    p.pop("alive")
    ply = str(tmp_path / "scene.ply")
    _jax_model(p, np.ones(300, bool)).save_ply(ply)

    jm = jgauss.GaussianModel(3, num_class=2, capacity=512)
    jm.load_ply(ply)
    tm = tgauss.GaussianModel(3, num_class=2, capacity=512, device="cpu")
    tm.load_ply(ply)
    jm.training_setup()
    mu = {k: rng.standard_normal(np.shape(getattr(jm.params, k))).astype(
        np.float32) for k in FIELDS}
    nu = {k: np.abs(v) for k, v in mu.items()}
    jm.opt_state = jm.opt_state._replace(
        count=jnp.int32(7), mu=jgauss.GaussianParams(
            **{k: jnp.asarray(v) for k, v in mu.items()}),
        nu=jgauss.GaussianParams(**{k: jnp.asarray(v)
                                    for k, v in nu.items()}))
    tm.opt_state = tgauss.adam_state_from_numpy(7, mu, nu, device="cpu")
    je, te = jeditor.SceneEditor(jm), teditor.SceneEditor(tm)
    _assert_editors_equal(je, te, "load")

    assert te.merge_ply(ply, translate=(0.25, 0, -0.5), scale=1.5) == \
        je.merge_ply(ply, translate=(0.25, 0, -0.5), scale=1.5) == 1
    assert tm.capacity == 1024 and tm.num_alive == 600
    _assert_editors_equal(je, te, "merge")
    box = ([0.1, 0.0, 0.0], (10.0, 20.0, 5.0), (0.8, 1.0, 0.9))
    tbox, jbox = te.bbox_select(*box), je.bbox_select(*box)
    tcls, jcls = te.segment_select(1), je.segment_select(1)
    np.testing.assert_array_equal(tbox, jbox)
    np.testing.assert_array_equal(tcls, jcls)
    sel = tbox & tcls
    assert 0 < sel.sum() < tbox.sum() < 600
    assert te.copy(sel, translate=(2.0, 0.5, 0)) == \
        je.copy(sel, translate=(2.0, 0.5, 0)) == 2
    _assert_editors_equal(je, te, "copy")
    te.transform_instance(2, translate=(0.1, -0.2, 0.3), scale=0.7)
    je.transform_instance(2, translate=(0.1, -0.2, 0.3), scale=0.7)
    _assert_editors_equal(je, te, "transform")
    assert tm.num_alive == 600 + sel.sum()
    assert te.remove(tbox) == je.remove(jbox) == tbox.sum()
    _assert_editors_equal(je, te, "remove")
    assert tm.num_alive == 600 + sel.sum() - tbox.sum()
    clip_mask = te.instance == 1
    tclip, jclip = str(tmp_path / "t.ply"), str(tmp_path / "j.ply")
    te.save_clip(tclip, clip_mask)
    je.save_clip(jclip, clip_mask)
    with open(tclip, "rb") as a, open(jclip, "rb") as b:
        assert a.read() == b.read()
    back = tgauss.GaussianModel(3, num_class=2, capacity=1, device="cpu")
    back.load_ply(tclip)
    keep = np.nonzero(clip_mask & tm.aux.alive.numpy())[0]
    assert back.num_alive == len(keep) == 300 - int((tbox & clip_mask).sum())
    for k in FIELDS:
        np.testing.assert_array_equal(
            getattr(back.params, k)[:len(keep)].numpy(),
            getattr(tm.params, k)[keep].numpy(), err_msg=k)


def test_render_server_keys_match_jax(capsys):
    """A key script through both servers' ``handle_key``: every motion key,
    keyframes captured and dropped, the path preview toggled, the modes
    cycled, the overlay, the limit mode on, a move it rejects and the
    rotations it allows, off, on again, an unknown key; after every key the
    view, keyframes, mode, preview, overlay, limit, bounds and the rejected
    flag equal JAX's.  Without scene cameras ``b`` is refused in both."""
    cam = make_camera(64, 48)
    scene = []
    for t in ((0.0, 0.0, 4.0), (0.6, 0.3, 4.5), (-0.4, -0.2, 3.6)):
        c = make_camera(64, 48)
        c.T = np.array(t)
        c._build_matrices()
        scene.append(c)
    js = japp.RenderServer(None, cam, scene_cams=scene, n_path_frames=5)
    ts = tapp.RenderServer(None, cam, scene_cams=scene, n_path_frames=5)
    script = (list("wasdqejlikuo") + [",", "d", "d", "l", ",", ".", ",",
                                      "space", "m", "m", "p", "b"]
              + ["w"] * 12 + ["s", "j", "u", "b", "w", "b", "x", "m",
                              " ", "Space", "p", "none"])
    fields = ("mode", "preview", "overlay", "limit", "outbound",
              "_preview_i")
    rejected = 0
    for key in script:
        js.handle_key(key)
        ts.handle_key(key)
        np.testing.assert_array_equal(ts.world_view, js.world_view,
                                      err_msg=key)
        assert [getattr(ts, f) for f in fields] == \
            [getattr(js, f) for f in fields], key
        assert len(ts.keyframes) == len(js.keyframes)
        for a, b in zip(ts.keyframes, js.keyframes):
            np.testing.assert_array_equal(a, b)
        for a, b in zip(ts.cam_bounds or (), js.cam_bounds or ()):
            np.testing.assert_array_equal(a, b)
        rejected += ts.outbound
    assert 0 < rejected < 12 and len(ts.keyframes) == 2 and ts.mode == "rgb"
    np.testing.assert_array_equal(ts._path_poses(), js._path_poses())
    for srv in (japp.RenderServer(None, cam), tapp.RenderServer(None, cam)):
        srv.handle_key("b")
        assert not srv.limit
    assert capsys.readouterr().out.count("limit mode unavailable") == 2
    assert set(tapp.RenderServer.KEY_ACTIONS) == set(
        japp.RenderServer.KEY_ACTIONS)
    assert tapp._CLIENT_HTML == japp._CLIENT_HTML


def test_core_leftovers_match_jax():
    """``build_scaling_rotation``, ``strip_symmetric``, ``unpack_symmetric``
    and ``num_sh_bases`` against the JAX package's; ``L L^T`` packed equals
    the covariance the port's preprocess takes, and a symmetric matrix
    survives packing and unpacking."""
    rng = np.random.default_rng(52)
    q = rng.standard_normal((40, 4)).astype(np.float32)
    s = np.exp(rng.standard_normal((40, 3)).astype(np.float32) * 0.5)
    S = rng.standard_normal((40, 3, 3)).astype(np.float32)
    c6 = rng.standard_normal((5, 8, 6)).astype(np.float32)
    L_t = tT.build_scaling_rotation(torch.from_numpy(s), torch.from_numpy(q))
    np.testing.assert_allclose(
        L_t.numpy(), np.asarray(jT.build_scaling_rotation(
            jnp.asarray(s), jnp.asarray(q))), rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(
        tT.strip_symmetric(torch.from_numpy(S)).numpy(),
        np.asarray(jT.strip_symmetric(jnp.asarray(S))))
    np.testing.assert_array_equal(
        tT.unpack_symmetric(torch.from_numpy(c6)).numpy(),
        np.asarray(jT.unpack_symmetric(jnp.asarray(c6))))
    cov = L_t @ L_t.transpose(-1, -2)
    np.testing.assert_allclose(
        tT.strip_symmetric(cov).numpy(),
        tT.covariance_from_scaling_rotation(torch.from_numpy(s), 1.0,
                                            torch.from_numpy(q)).numpy(),
        rtol=1e-5, atol=1e-6)
    sym = torch.from_numpy(S + S.transpose(0, 2, 1))
    assert torch.equal(tT.unpack_symmetric(tT.strip_symmetric(sym)), sym)
    for deg in range(5):
        assert tsh.num_sh_bases(deg) == jsh.num_sh_bases(deg) == (deg + 1) ** 2
