"""The port's multi-device paths (``gsplat_tpu_torch/parallel``) on the CPU,
against the JAX package and the port's single-device oracles.

One module fixture starts four gloo ranks once (``torch_parallel_worker.py``,
which imports no JAX) and, while they run, takes the JAX side here on the 8
host devices of ``conftest.py``: one data-parallel train step at D = 2 (the
file's one JAX step compile) and the forward-only tile-sharded render.  The
ranks run every scenario over a 2x2 mesh and its 1-D sub-meshes, so that
each 1-D scenario runs twice, on two groups, and every rank's state must be
the same bit for bit.  Inputs: 64x64 images, 200 live gaussians in 256
slots, a warm Adam state from one single-device port step, and the JAX
draws of the continuity depth loss for each data coordinate.
"""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parallel_worker as wk
from torch_helpers import ATOL, make_scene_port

WORLD = 4
TIMEOUT_S = 240           # the ranks' join; each rank's group start: 120 s
PFIELDS = ("xyz", "features_dc", "features_rest", "scaling", "rotation",
           "opacity", "segment")
APP = ("emb", "w0", "b0", "w1", "b1", "w2", "b2")


def _warm_state(cfg, opt, p, alive, cams, draws):
    """A warm state from one single-device port step from cold moments:
    its parameters, first moments and statistics, second moments at the
    square of each group's largest gradient and a step count of 100
    (``torch_helpers.step_from_warm_state`` takes its first step with
    JAX)."""
    from gsplat_tpu_torch.models import adam
    from gsplat_tpu_torch.models import gaussians as tg
    from gsplat_tpu_torch.train import trainer as tt
    from gsplat_tpu_torch.train.schedules import make_lr_fn
    m = tg.params_from_numpy(dict(p, alive=alive), device="cpu",
                             num_class=2)
    step = tt.make_train_step(cfg, opt, 3, wk.DEPTH, True, wk.BG,
                              device="cpu")
    p1, o1, a1, _ = step(m.params, adam.init(m.params), m.aux,
                         wk.batches(cams)[0], make_lr_fn(opt, 1.0)(100),
                         draws=draws[0])
    out = {"count": np.int32(100)}
    gmax = {}
    for k in PFIELDS:
        mu = getattr(o1.mu, k).numpy()
        gmax[k] = float(np.abs(mu).max()) / 0.1
        out[f"p.{k}"] = getattr(p1, k).numpy()
        out[f"mu.{k}"] = mu
        out[f"nu.{k}"] = np.broadcast_to(
            np.float32(gmax[k] ** 2) * alive.reshape(
                (-1,) + (1,) * (mu.ndim - 1)), mu.shape).astype(np.float32)
    for k, v in a1._asdict().items():
        out[f"aux.{k}"] = v.numpy()
    return out, gmax


def _jax_draws(key, d):
    """The patches the JAX continuity loss draws on data coordinate ``d``
    (``jax.random.fold_in(key, d)``, as ``make_parallel_train_step``)."""
    kw, kh = jax.random.split(jax.random.fold_in(key, d))
    return {"patch_rows": np.asarray(jax.random.randint(
                kw, (100,), 0, wk.H - 3)),
            "patch_cols": np.asarray(jax.random.randint(
                kh, (100,), 0, wk.W - 3))}


def _jax_side(warm, cams, key):
    """JAX's data-parallel step at D = 2 from the warm state, and its
    tile-sharded render of camera 0 at D = 2."""
    from gsplat_tpu import config as jconfig
    from gsplat_tpu.core import transforms as jT
    from gsplat_tpu.models import adam as jadam
    from gsplat_tpu.models import gaussians as jgauss
    from gsplat_tpu.ops.rasterize import RasterizeConfig as JCfg
    from gsplat_tpu.parallel import data_parallel as jdp
    from gsplat_tpu.parallel import tile_parallel as jtp
    from gsplat_tpu.train import trainer as jtrainer
    from gsplat_tpu_torch.train.schedules import make_lr_fn

    def jtree(cls, prefix):
        return cls(**{k: jnp.asarray(warm[prefix + k]) for k in cls._fields})

    params = jtree(jgauss.GaussianParams, "p.")
    state = jadam.AdamState(jnp.int32(100),
                            jtree(jgauss.GaussianParams, "mu."),
                            jtree(jgauss.GaussianParams, "nu."))
    aux = jtree(jgauss.GaussianAux, "aux.")
    opt = jconfig.OptimizationParams()
    lrs = {k: jnp.float32(v) for k, v in make_lr_fn(opt, 1.0)(100).items()}
    cfg = JCfg(width=wk.W, height=wk.H, num_class=2, max_instances=1 << 13,
               backend="pallas")
    step = jdp.make_parallel_train_step(jdp.make_data_mesh(2), cfg, opt, 3,
                                        wk.DEPTH, True, jnp.asarray(wk.BG))
    stacked = jdp.stack_camera_batches([
        jtrainer.camera_batch(c, gt_depth=d, gt_seg=s) for c, d, s in cams])
    jp, jo, ja, jm = step(params, state, aux, stacked, lrs, key)
    out = {"params": {k: np.asarray(getattr(jp, k)) for k in PFIELDS},
           "mu": {k: np.asarray(getattr(jo.mu, k)) for k in PFIELDS},
           "nu": {k: np.asarray(getattr(jo.nu, k)) for k in PFIELDS},
           "aux": {k: np.asarray(v) for k, v in ja._asdict().items()},
           "m": {k: np.asarray(v) for k, v in jm.items()}}

    rcfg = JCfg(width=wk.W, height=wk.H, max_instances=1 << 13,
                backend="pallas")
    render = jtp.make_tile_sharded_render(jtp.make_tile_mesh(2), rcfg)
    r = render(params.xyz, jT.scaling_activation(params.scaling),
               params.rotation, jT.opacity_activation(params.opacity[:, 0]),
               jnp.concatenate([params.features_dc, params.features_rest],
                               axis=1),
               jtp.slice_camera(cams[0][0], 2), jnp.asarray(wk.BG))
    out["render"] = {k: np.asarray(v) for k, v in r.items()}
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("ranks"))
    cfg, opt = wk.configs()
    p, alive, cams, _ = wk.make_inputs()
    key = jax.random.PRNGKey(0)
    draws = [_jax_draws(key, d) for d in range(2)]
    warm, gmax = _warm_state(cfg, opt, p, alive, cams, [
        {k: torch.from_numpy(np.array(v)) for k, v in dr.items()}
        for dr in draws])
    for d, dr in enumerate(draws):
        warm.update({f"draws{d}.{k}": v for k, v in dr.items()})
    np.savez(os.path.join(root, "inputs.npz"), **warm)
    make_scene_port(os.path.join(root, "scene"), n_cams=4, width=wk.W,
                    height=wk.H)

    from gsplat_tpu_torch.parallel.multihost import free_port
    port = free_port()
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs, logs = [], []
    for r in range(WORLD):
        log = open(os.path.join(root, f"rank{r}.log"), "w")
        logs.append(log)
        procs.append(subprocess.Popen(
            [sys.executable, os.path.join(here, "torch_parallel_worker.py"),
             str(r), str(WORLD), str(port), root],
            stdout=log, stderr=subprocess.STDOUT, env=env))
    try:
        jout = _jax_side(warm, cams, key)
        for pr in procs:
            pr.wait(timeout=TIMEOUT_S)
    finally:
        for pr in procs:
            if pr.poll() is None:
                pr.kill()
                pr.wait()
        for log in logs:
            log.close()
    tails = ""
    for r, pr in enumerate(procs):
        with open(os.path.join(root, f"rank{r}.log")) as f:
            tails += f"--- rank {r} (rc {pr.returncode})\n{f.read()[-3000:]}"
    assert all(pr.returncode == 0 for pr in procs), tails
    ranks = [dict(np.load(os.path.join(root, f"rank{r}.npz")))
             for r in range(WORLD)]
    from gsplat_tpu_torch.train.schedules import make_lr_fn
    return dict(ranks=ranks, jax=jout, gmax=gmax,
                lrs=make_lr_fn(opt, 1.0)(100))


def _same_on_every_rank(ranks, prefix):
    keys = [k for k in ranks[0] if k.startswith(prefix)]
    assert keys, prefix
    for r in ranks[1:]:
        for k in keys:
            np.testing.assert_array_equal(r[k], ranks[0][k], err_msg=k)


def _assert_step_close(got, want, gmax, lrs, prefix, want_prefix):
    """``got``'s step at ``prefix`` against ``want``'s at ``want_prefix``,
    at ``tests/test_torch_train.py``'s step tolerances."""
    for k in PFIELDS:
        g = gmax[k]
        np.testing.assert_allclose(
            got[f"{prefix}opt.mu.{k}"], want[f"{want_prefix}opt.mu.{k}"],
            rtol=0, atol=1e-4 * g, err_msg=f"{prefix}mu.{k}")
        np.testing.assert_allclose(
            got[f"{prefix}opt.nu.{k}"], want[f"{want_prefix}opt.nu.{k}"],
            rtol=1e-6, atol=2e-6 * g ** 2, err_msg=f"{prefix}nu.{k}")
        np.testing.assert_allclose(
            got[f"{prefix}params.{k}"], want[f"{want_prefix}params.{k}"],
            rtol=1e-6, atol=1e-4 * lrs[k], err_msg=f"{prefix}params.{k}")
    for k in ("denom", "max_radii2d", "alive"):
        np.testing.assert_array_equal(got[f"{prefix}aux.{k}"],
                                      want[f"{want_prefix}aux.{k}"],
                                      err_msg=f"{prefix}aux.{k}")
    acc = want[f"{want_prefix}aux.xyz_gradient_accum"]
    np.testing.assert_allclose(got[f"{prefix}aux.xyz_gradient_accum"], acc,
                               atol=1e-3 * np.abs(acc).max())


def test_data_parallel_steps_match_jax(runs):
    """(a) The D = 2 data-parallel step against JAX's
    ``make_parallel_train_step``, and its appearance form against the
    single-device oracle; the replicated state is the same on every rank."""
    ranks, j = runs["ranks"], runs["jax"]
    _same_on_every_rank(ranks, "a.")
    _same_on_every_rank(ranks, "a_app.")
    got = ranks[0]
    want = {f"a.params.{k}": v for k, v in j["params"].items()}
    want.update({f"a.opt.mu.{k}": v for k, v in j["mu"].items()})
    want.update({f"a.opt.nu.{k}": v for k, v in j["nu"].items()})
    want.update({f"a.aux.{k}": v for k, v in j["aux"].items()})
    _assert_step_close(got, want, runs["gmax"], runs["lrs"], "a.", "a.")
    for k in ("num_rendered", "num_padded", "n_visible", "overflow"):
        assert int(got[f"a.m.{k}"]) == int(j["m"][k]), k
    assert int(got["a.m.num_rendered"]) > 100 and not got["a.m.overflow"]
    for k in ("loss", "l1", "depth_loss", "seg_loss"):
        np.testing.assert_allclose(got[f"a.m.{k}"], j["m"][k], rtol=2e-5,
                                   err_msg=k)
        assert float(got[f"a.m.{k}"]) > 0, k
    # the statistics took both cameras: two warm steps' worth somewhere
    assert got["a.aux.denom"].max() == 3.0

    ref = ranks[0]
    _assert_step_close(got, ref, runs["gmax"], runs["lrs"], "a_app.",
                       "ref.mean_app.")
    for k in APP:
        want_p = ref[f"ref.mean_app.app.{k}"]
        np.testing.assert_allclose(got[f"a_app.app.{k}"], want_p,
                                   rtol=1e-6, atol=1e-7, err_msg=k)
    # each camera's embedding row moved
    emb0 = wk.make_inputs()[3]
    assert (got["a_app.app.emb"] != emb0).any(axis=1).all()


def test_tile_sharded_render_and_step(runs):
    """(b) The D = 2 tile-sharded render bit-equal to the single-device
    render on every rank and close to JAX's; the tile-sharded step and its
    appearance form against the single-device full-image steps."""
    ranks, j = runs["ranks"], runs["jax"]["render"]
    for r in ranks:
        for k in ("render", "depth", "alpha", "radii", "visibility",
                  "overflow"):
            np.testing.assert_array_equal(r[f"b.tile.{k}"], r[f"b.full.{k}"],
                                          err_msg=k)
    got = ranks[0]
    for k in ("render", "depth", "alpha"):
        np.testing.assert_allclose(got[f"b.tile.{k}"], j[k], atol=ATOL[k],
                                   rtol=0, err_msg=k)
    for k in ("radii", "visibility", "overflow"):
        np.testing.assert_array_equal(got[f"b.tile.{k}"], j[k], err_msg=k)
    assert got["b.tile.alpha"].max() > 0.5

    _same_on_every_rank(ranks, "b.")
    _same_on_every_rank(ranks, "b_app.")
    _assert_step_close(got, got, runs["gmax"], runs["lrs"], "b.", "ref.b.")
    _assert_step_close(got, got, runs["gmax"], runs["lrs"], "b_app.",
                       "ref.b_app.")
    for k in APP:
        np.testing.assert_allclose(got[f"b_app.app.{k}"],
                                   got[f"ref.b_app.app.{k}"], rtol=1e-6,
                                   atol=1e-7, err_msg=k)
    for k in ("loss", "l1", "depth_loss", "seg_loss"):
        np.testing.assert_allclose(got[f"b.m.{k}"], got[f"ref.b.m.{k}"],
                                   rtol=1e-6, err_msg=k)
    for k in ("n_visible", "overflow"):
        assert int(got[f"b.m.{k}"]) == int(got[f"ref.b.m.{k}"]), k


def test_mesh2d_step_matches_oracle(runs):
    """(c) The 2x2 mesh step against the single-device mean over the two
    cameras' gradients (``tests/test_mesh2d.py``'s oracle); a 3x2 mesh over
    four ranks raises ``ValueError``."""
    ranks = runs["ranks"]
    _same_on_every_rank(ranks, "c.")
    got = ranks[0]
    _assert_step_close(got, got, runs["gmax"], runs["lrs"], "c.",
                       "ref.mean.")
    np.testing.assert_allclose(got["c.m.loss"], got["a.m.loss"], rtol=1e-6)
    assert "needs 6 devices, have 4" in str(got["c.error"])


def test_sampler_and_trainer_ranks(runs):
    """(d) ``ShardedCameraSampler``'s orders equal JAX's; a ``Trainer``
    with ``data_parallel=2`` (two replicas of two ranks) densifies at
    iteration 2 and its state is the same on every rank after 3
    iterations, and only rank 0 wrote files."""
    from gsplat_tpu.parallel.multihost import ShardedCameraSampler as JS
    from gsplat_tpu_torch.parallel.multihost import (ShardedCameraSampler,
                                                     make_global_batch)
    for n, per, count in ((7, 1, 2), (6, 2, 3), (5, 1, 4)):
        for p in range(count):
            a, b = JS(n, per, p, count, seed=3), ShardedCameraSampler(
                n, per, p, count, seed=3)
            for _ in range(9):
                assert b.sample_global() == a.sample_global()
                assert b.sample() == a.sample()
    assert make_global_batch(None, {"x": 1}) == {"x": 1}

    ranks = runs["ranks"]
    _same_on_every_rank(ranks, "d.params.")
    _same_on_every_rank(ranks, "d.aux.")
    it, n_cloned, n_split, _, n_alive = ranks[0]["d.densify"]
    assert it == 2 and n_cloned + n_split > 0
    assert int(ranks[0]["d.aux.alive"].sum()) == n_alive
    files = set(ranks[0]["d.files"].tolist())
    assert {"input.ply", "cameras.json", "chkpnt3.npz", "eval_log.jsonl",
            os.path.join("point_cloud", "iteration_3",
                         "point_cloud.ply")} <= files
    for r in ranks[1:]:
        assert r["d.files"].tolist() == [""]
