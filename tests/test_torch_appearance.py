"""The appearance embedding and the pose optimizer of the port
(``gsplat_tpu_torch/models/appearance.py``, ``models/pose.py``) against the
JAX package on the CPU: the modules, the npz files across packages, one
``make_appearance_step`` step from a shared warm state (the JAX step, the
Pallas path in interpret mode, compiled once here), and the ``Trainer`` and
the training command line with ``use_appearance``."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gsplat_tpu import config as jconfig
from gsplat_tpu.models import adam as jadam
from gsplat_tpu.models import appearance as japp
from gsplat_tpu.models import gaussians as jgauss
from gsplat_tpu.models import pose as jpose
from gsplat_tpu.ops.rasterize import RasterizeConfig as JCfg
from gsplat_tpu.train import trainer as jtrainer
from gsplat_tpu_torch import config as tconfig
from gsplat_tpu_torch.models import adam as tadam
from gsplat_tpu_torch.models import appearance as tapp
from gsplat_tpu_torch.models import gaussians as tgauss
from gsplat_tpu_torch.models import pose as tpose
from gsplat_tpu_torch.ops.rasterize import RasterizeConfig
from gsplat_tpu_torch.scripts import train as ttrain
from gsplat_tpu_torch.train import schedules as tsched
from gsplat_tpu_torch.train import trainer as ttrainer

from torch_helpers import (SCENE_CLASSES, dataset_args, make_camera,
                           model_state_np, port_opt, scene_dir, tree_np)  # noqa: F401

AFIELDS = tapp.AppearanceParams._fields
PFIELDS = tgauss.GaussianParams._fields
RTOL, ATOL = 1e-5, 1e-6
# the JAX functions jitted: one compile each, where their eager ops would
# compile one by one (seconds in all)
j_init = jax.jit(japp.init_params, static_argnums=0)
j_apply = jax.jit(japp.apply)
j_so3 = jax.jit(jpose.so3_exp)
j_pose = jax.jit(jpose.apply_pose_delta)
j_adam = jax.jit(jadam.update)


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _close(got, want, what):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=RTOL,
                               atol=ATOL, err_msg=what)


def _japp(d):
    return japp.AppearanceParams(**{k: jnp.asarray(d[k]) for k in AFIELDS})


def test_modules_match_jax():
    """Frequency encoding, ``apply`` at several cameras, ``so3_exp``,
    ``apply_pose_delta`` and a few optimizer updates (the JAX classes'
    ``update`` is ``adam.update`` at their ``lr``), on the JAX
    ``init_params`` draws handed over."""
    rng = np.random.default_rng(600)
    x = rng.uniform(-5, 5, (7, 32)).astype(np.float32)
    _close(tapp.frequency_encoding(_t(x)), japp.frequency_encoding(
        jnp.asarray(x)), "frequency_encoding")

    d = tree_np(j_init(5))
    d["emb"] = rng.standard_normal(d["emb"].shape).astype(np.float32) * 0.3
    jp = _japp(d)
    tp = tgauss.appearance_params_from_numpy(d, device="cpu")
    vm = rng.standard_normal((4, 4)).astype(np.float32) * 0.3
    vm[3, :3] = [0.7, -3.9, 4.1]            # a translation near 4
    for uid in (0, 2, 4):
        _close(tapp.apply(tp, torch.tensor(uid), _t(vm)),
               j_apply(jp, jnp.int32(uid), jnp.asarray(vm)), f"uid {uid}")
    own = tapp.init_params(5, device="cpu")   # torch's stream, same shapes
    assert [tuple(v.shape) for v in own] == [v.shape for v in jp]
    lim = np.sqrt(6.0 / (256 + 32))
    assert float(own.w0.abs().max()) <= lim and float(own.emb.abs().max()) == 0

    for om in ([0.0, 0.0, 0.0], [3e-10, -2e-10, 1e-10],
               [0.3, -1.2, 0.5], [0.0, 0.0, np.pi / 2]):
        om = np.float32(om)
        R = tpose.so3_exp(_t(om))
        _close(R, j_so3(jnp.asarray(om)), f"so3_exp {om}")
        if np.linalg.norm(om) < 1e-9:
            assert torch.equal(R, torch.eye(3))
    deltas = rng.standard_normal((3, 6)).astype(np.float32) * 0.2
    for uid in (0, 2):
        _close(tpose.apply_pose_delta(tpose.PoseParams(_t(deltas)), uid,
                                      _t(vm)),
               j_pose(jpose.PoseParams(jnp.asarray(deltas)), uid,
                      jnp.asarray(vm)), f"pose {uid}")

    to = tapp.AppearanceOptimizer(5, device="cpu")
    to.params, to.opt_state = tp, tadam.init(tp)
    tc = tpose.CameraOptimizer(3, device="cpu")
    jc = jpose.PoseParams(jnp.zeros((3, 6)))
    ja_state, jc_state = jadam.init(jp), jadam.init(jc)
    for _ in range(3):
        g = {k: rng.standard_normal(d[k].shape).astype(np.float32) * 1e-2
             for k in AFIELDS}
        jp, ja_state = j_adam(_japp(g), ja_state, jp,
                              _japp(dict.fromkeys(AFIELDS, to.lr)))
        to.update(tgauss.appearance_params_from_numpy(g, device="cpu"))
        gd = rng.standard_normal((3, 6)).astype(np.float32) * 1e-2
        jc, jc_state = j_adam(jpose.PoseParams(jnp.asarray(gd)), jc_state,
                              jc, jpose.PoseParams(tc.lr))
        tc.update(tpose.PoseParams(_t(gd)))
    assert int(to.opt_state.count) == int(ja_state.count) == 3
    for k in AFIELDS:
        _close(getattr(to.params, k), getattr(jp, k), f"update {k}")
        _close(getattr(to.opt_state.nu, k), getattr(ja_state.nu, k),
               f"nu {k}")
    _close(tc.params.deltas, jc.deltas, "pose update")


def test_save_load_across_packages(tmp_path):
    """A JAX-written npz, with and without moments, loads into the port
    equal, and the other way round; a missing file gives False."""
    rng = np.random.default_rng(610)
    jo = japp.AppearanceOptimizer(3)

    def draw():
        return _japp({k: rng.standard_normal(v.shape).astype(np.float32)
                      for k, v in tree_np(jo.params).items()})

    g = draw()
    jo.params = draw()
    jo.opt_state = jadam.AdamState(jnp.int32(2), draw(), draw())
    to = tapp.AppearanceOptimizer(3, device="cpu")
    for with_opt in (False, True):
        path = str(tmp_path / f"jax_{with_opt}.npz")
        jo.save(path, with_opt=with_opt)
        assert to.load(path)
        for k in AFIELDS:
            np.testing.assert_array_equal(getattr(to.params, k).numpy(),
                                          np.asarray(getattr(jo.params, k)))
        want = jo.opt_state if with_opt else jadam.init(jo.params)
        assert int(to.opt_state.count) == int(want.count)
        for k in AFIELDS:
            for a, b in ((to.opt_state.mu, want.mu), (to.opt_state.nu,
                                                      want.nu)):
                np.testing.assert_array_equal(getattr(a, k).numpy(),
                                              np.asarray(getattr(b, k)))

    to.update(tgauss.appearance_params_from_numpy(
        tree_np(g), device="cpu"))
    back = japp.AppearanceOptimizer(3)
    for with_opt in (False, True):
        path = str(tmp_path / "port" / f"port_{with_opt}.npz")
        to.save(path, with_opt=with_opt)
        assert back.load(path)
        for k in AFIELDS:
            np.testing.assert_array_equal(np.asarray(getattr(back.params, k)),
                                          getattr(to.params, k).numpy())
        if with_opt:
            assert int(back.opt_state.count) == int(to.opt_state.count) == 3
            np.testing.assert_array_equal(np.asarray(back.opt_state.mu.w0),
                                          to.opt_state.mu.w0.numpy())
    assert not to.load(str(tmp_path / "missing.npz"))
    assert not back.load(str(tmp_path / "missing.npz"))


W, H, N_LIVE, CAP, N_CAM, UID = 64, 64, 200, 256, 4, 2
BG = np.array([0.1, 0.3, 0.2], np.float32)


@pytest.fixture(scope="module")
def app_step():
    """One JAX ``make_appearance_step`` step (compiled once) and the
    port's, both from one state with dead rows and warm Adam moments for
    the gaussians and the appearance (a cold JAX step gives the
    gradients' scale: the first moments are taken from it, the second set
    to the square of each group's largest gradient, the counts to 100)."""
    rng = np.random.default_rng(620)
    p0 = model_state_np(rng, n=N_LIVE, capacity=CAP)
    alive = p0.pop("alive")
    cam = make_camera(W, H)
    cam.uid = UID
    cam.image = rng.uniform(size=(3, H, W)).astype(np.float32)
    depth = rng.uniform(0.2, 2.0, (1, H, W)).astype(np.float32)
    seg = rng.integers(0, 2, (H, W)).astype(np.int32)
    topt = tconfig.OptimizationParams()
    lrs = tsched.make_lr_fn(topt, 1.0)(100)
    jlrs = {k: jnp.float32(v) for k, v in lrs.items()}
    jcfg = JCfg(width=W, height=H, num_class=2, max_instances=1 << 13,
                backend="pallas")
    jstep = jtrainer.make_appearance_step(
        jcfg, jconfig.OptimizationParams(), 3, "L1_loss", True,
        jnp.asarray(BG))
    tstep = ttrainer.make_appearance_step(
        RasterizeConfig(width=W, height=H, num_class=2,
                        max_instances=1 << 13),
        topt, 3, "L1_loss", True, BG, device="cpu")
    jbatch = jtrainer.camera_batch(cam, gt_depth=depth, gt_seg=seg)
    tbatch = ttrainer.camera_batch(cam, gt_depth=depth, gt_seg=seg,
                                   device="cpu")

    def jgp(d):
        return jgauss.GaussianParams(**{k: jnp.asarray(d[k])
                                        for k in PFIELDS})

    ja0 = j_init(N_CAM)
    key = jax.random.PRNGKey(0)
    jp0 = jgp(p0)
    jaux0 = jgauss.empty_aux(CAP)._replace(alive=jnp.asarray(alive))
    jp1, jo1, jx1, ja1, jao1, _ = jstep(jp0, jadam.init(jp0), jaux0, ja0,
                                        jadam.init(ja0), jbatch, jlrs, key)

    def warm(mu, fields, rows=None):
        gmax = {k: float(np.abs(mu[k]).max()) / 0.1 for k in fields}
        nu = {}
        for k in fields:
            v = np.full(mu[k].shape, np.float32(gmax[k] ** 2))
            if rows is not None:
                v *= rows.reshape((-1,) + (1,) * (v.ndim - 1))
            nu[k] = v.astype(np.float32)
        return gmax, nu

    params, mu = tree_np(jp1), tree_np(jo1.mu)
    gmax, nu = warm(mu, PFIELDS, alive)
    app, amu = tree_np(ja1), tree_np(jao1.mu)
    agmax, anu = warm(amu, AFIELDS)
    aux = tree_np(jx1)
    jout = jstep(jgp(params), jadam.AdamState(jnp.int32(100), jgp(mu),
                                              jgp(nu)),
                 jgauss.GaussianAux(**{k: jnp.asarray(v)
                                       for k, v in aux.items()}),
                 _japp(app), jadam.AdamState(jnp.int32(100), _japp(amu),
                                             _japp(anu)),
                 jbatch, jlrs, key)
    tin = (tgauss.params_from_numpy(dict(params, alive=alive), device="cpu",
                                    num_class=2).params,
           tgauss.adam_state_from_numpy(100, mu, nu, device="cpu"),
           tgauss.aux_from_numpy(aux, device="cpu"),
           tgauss.appearance_params_from_numpy(app, device="cpu"),
           tgauss.adam_state_from_numpy(100, amu, anu, device="cpu",
                                        tree_type=tapp.AppearanceParams))
    tout = tstep(*tin, tbatch, lrs)
    return dict(jout=jout, tout=tout, tin=tin, tbatch=tbatch, lrs=lrs,
                gmax=gmax, agmax=agmax, alive=alive, topt=topt)


def test_appearance_step_matches_jax(app_step):
    s = app_step
    (jp, jo, jx, ja, jao, jm), (tp, to, tx, ta, tao, tm) = s["jout"], \
        s["tout"]
    for k in ("num_rendered", "num_padded", "n_visible"):
        assert int(tm[k]) == int(jm[k]), k
    assert int(tm["num_rendered"]) > 100 and not bool(tm["overflow"])
    for k in ("loss", "l1", "depth_loss", "seg_loss"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=2e-5,
                                   err_msg=k)
    assert int(to.count) == int(jo.count) == int(tao.count) == 101

    # test_torch_train.py::test_train_step_matches_jax's tolerances, scaled
    # by each group's largest gradient, for both trees
    groups = ((PFIELDS, s["gmax"], s["lrs"], (tp, to), (jp, jo)),
              (AFIELDS, s["agmax"], dict.fromkeys(AFIELDS, 1e-4), (ta, tao),
               (ja, jao)))
    for fields, gmax, lrs, (p_t, o_t), (p_j, o_j) in groups:
        for k in fields:
            assert gmax[k] > 0.0, k
            np.testing.assert_allclose(
                getattr(o_t.mu, k).numpy(), np.asarray(getattr(o_j.mu, k)),
                rtol=0, atol=1e-4 * gmax[k], err_msg=f"mu.{k}")
            np.testing.assert_allclose(
                getattr(o_t.nu, k).numpy(), np.asarray(getattr(o_j.nu, k)),
                rtol=1e-6, atol=2e-6 * gmax[k] ** 2, err_msg=f"nu.{k}")
            np.testing.assert_allclose(
                getattr(p_t, k).numpy(), np.asarray(getattr(p_j, k)),
                rtol=1e-6, atol=1e-4 * lrs[k], err_msg=f"params.{k}")
    # only the camera's row of the embedding moves
    moved = (ta.emb != s["tin"][3].emb).any(dim=1)
    assert moved.tolist() == [i == UID for i in range(N_CAM)]
    np.testing.assert_allclose(tx.xyz_gradient_accum.numpy(),
                               np.asarray(jx.xyz_gradient_accum),
                               atol=1e-3 * np.abs(np.asarray(
                                   jx.xyz_gradient_accum)).max())

    # an overflowing step leaves all five trees as they were
    step = ttrainer.make_appearance_step(
        RasterizeConfig(width=W, height=H, num_class=2, max_instances=128),
        s["topt"], 3, "L1_loss", True, BG, device="cpu")
    out = step(*s["tin"], s["tbatch"], s["lrs"])
    assert bool(out[5]["overflow"])

    def leaves(tree):
        if isinstance(tree, torch.Tensor):
            return [tree]
        return [x for t in tree for x in leaves(t)]

    for new, old in zip(out[:5], s["tin"]):
        assert len(leaves(new)) == len(leaves(old)) > 0
        assert all(torch.equal(a, b)
                   for a, b in zip(leaves(new), leaves(old)))


def test_trainer_and_cli_with_appearance(scene_dir, tmp_path, capsys):
    """``Trainer(use_appearance=True)`` writes ``appearance_embedding.npz``
    beside the PLY and ``appearance_chkpnt<n>.npz`` beside the checkpoint;
    the command line resumes the appearance state from
    ``--start_checkpoint``."""
    from gsplat_tpu_torch.data.scene import Scene
    m = tgauss.GaussianModel(3, num_class=SCENE_CLASSES, capacity=512,
                             device="cpu")
    out = str(tmp_path / "trainer")
    scene = Scene(dataset_args(scene_dir, out), m)
    m.training_setup()
    tr = ttrainer.Trainer(m, scene, port_opt(), use_appearance=True,
                          max_instances=1 << 14, model_path=out)
    assert tr.appearance.num_cameras == len(scene.getTrainCameras())
    emb0 = tr.appearance.params.emb.clone()
    tr.train(4, log_every=2, save_iterations={4}, checkpoint_iterations={4})
    assert int(tr.appearance.opt_state.count) == 4
    moved = int((tr.appearance.params.emb != emb0).any(dim=1).sum())
    assert 1 <= moved <= 4
    saved = tapp.AppearanceOptimizer(1, device="cpu")
    assert saved.load(os.path.join(out, "point_cloud", "iteration_4",
                                   "appearance_embedding.npz"))
    assert torch.equal(saved.params.emb, tr.appearance.params.emb)
    assert int(saved.opt_state.count) == 0
    assert saved.load(os.path.join(out, "appearance_chkpnt4.npz"))
    assert int(saved.opt_state.count) == 4
    assert torch.equal(saved.opt_state.nu.w0, tr.appearance.opt_state.nu.w0)

    cli = str(tmp_path / "cli")
    base = ["-s", scene_dir, "-m", cli, "--data_device", "cpu",
            "--disable_gui_server", "--able_appearance_embedding",
            "--capacity", "512", "--max_instances", "16384",
            "--test_iterations", "99", "--densify_from_iter", "99"]
    ttrain.main(base + ["--iterations_override", "3",
                        "--checkpoint_iterations", "3"])
    first = tapp.AppearanceOptimizer(1, device="cpu")
    assert first.load(os.path.join(cli, "appearance_chkpnt3.npz"))
    capsys.readouterr()
    ttrain.main(base + ["--iterations_override", "5",
                        "--checkpoint_iterations", "5", "--start_checkpoint",
                        os.path.join(cli, "chkpnt3.npz")])
    said = capsys.readouterr().out
    assert "Resumed appearance embedding from" in said
    last = tapp.AppearanceOptimizer(1, device="cpu")
    assert last.load(os.path.join(cli, "appearance_chkpnt5.npz"))
    assert int(first.opt_state.count) == 3 and int(last.opt_state.count) == 5
    assert os.path.exists(os.path.join(cli, "point_cloud", "iteration_5",
                                       "appearance_embedding.npz"))
