"""The training slice of the port on the CPU against the JAX package: Adam,
KNN initialisation, losses (the random ones with shared draws), schedules,
densification (shared split noise) and one ``make_train_step`` step from a
shared state, plus the overflow gate and a short synthetic fit."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gsplat_tpu import config as jconfig
from gsplat_tpu.models import adam as jadam
from gsplat_tpu.models import densify as jdensify
from gsplat_tpu.models import gaussians as jgauss
from gsplat_tpu.ops.knn import dist2_knn as jknn
from gsplat_tpu.train import losses as jL
from gsplat_tpu.train import schedules as jsched
from gsplat_tpu_torch import config as tconfig
from gsplat_tpu_torch.models import adam as tadam
from gsplat_tpu_torch.models import densify as tdensify
from gsplat_tpu_torch.models import gaussians as tgauss
from gsplat_tpu_torch.ops.knn import dist2_knn as tknn
from gsplat_tpu_torch.ops.rasterize import RasterizeConfig
from gsplat_tpu_torch.train import losses as tL
from gsplat_tpu_torch.train import schedules as tsched
from gsplat_tpu_torch.train import trainer as ttrainer

from torch_helpers import (make_camera, model_state_np, step_from_warm_state,
                           tree_np)

PFIELDS = tgauss.GaussianParams._fields


def _jparams(d):
    return jgauss.GaussianParams(**{k: jnp.asarray(d[k]) for k in PFIELDS})


def _tparams(d):
    return tgauss.GaussianParams(**{k: torch.from_numpy(np.array(d[k]))
                                    for k in PFIELDS})


def _assert_trees_close(got, want, rtol=1e-6, atol=1e-7, what=""):
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=rtol, atol=atol,
                                   err_msg=f"{what}{k}")


# --- Adam --------------------------------------------------------------------

def test_adam_update_and_mask_rows_match_jax():
    rng = np.random.default_rng(400)
    p = model_state_np(rng, n=20, capacity=24)
    lrs = dict(zip(PFIELDS, (1e-3, 2.5e-3, 1.25e-4, 2e-3, 1e-3, 0.05, 0.05)))
    jp, tp = _jparams(p), _tparams(p)
    js, ts = jadam.init(jp), tadam.init(tp)
    assert ts.count.dtype == torch.int32 and int(ts.count) == 0
    for _ in range(3):
        g = {k: rng.standard_normal(p[k].shape).astype(np.float32) * 1e-3
             for k in PFIELDS}
        jp, js = jadam.update(_jparams(g), js, jp, _jparams(
            {k: np.float32(v) for k, v in lrs.items()}))
        tp, ts = tadam.update(_tparams(g), ts, tp,
                              tgauss.GaussianParams(**lrs))
    assert int(ts.count) == int(js.count) == 3
    # one float32 rounding per operation in both; pow and sqrt may differ
    # by an ulp
    _assert_trees_close(tree_np(tp), tree_np(jp), rtol=2e-6, atol=1e-9,
                        what="params.")
    _assert_trees_close(tree_np(ts.mu), tree_np(js.mu), what="mu.")
    _assert_trees_close(tree_np(ts.nu), tree_np(js.nu), what="nu.")

    mask = rng.uniform(size=24) < 0.4
    jm = jadam.mask_rows(js, jp, jnp.asarray(mask))
    tm = tadam.mask_rows(ts, torch.from_numpy(mask))
    for a, b in ((tm.mu, jm.mu), (tm.nu, jm.nu)):
        for k in PFIELDS:
            got = getattr(a, k).numpy()
            np.testing.assert_array_equal(got, np.asarray(getattr(b, k)))
            assert np.abs(got[mask]).max() == 0.0


# --- KNN, point-cloud init, capacity growth ----------------------------------

def test_dist2_knn_and_create_from_pcd_match_jax():
    rng = np.random.default_rng(410)
    pts = rng.standard_normal((300, 3)).astype(np.float32)
    d_j = np.asarray(jknn(jnp.asarray(pts)))
    d_t = tknn(torch.from_numpy(pts)).numpy()
    # the same candidates in the same order; sums of three squares
    np.testing.assert_allclose(d_t, d_j, rtol=1e-5, atol=1e-9)
    # a windowed search: never below the brute-force 3-NN mean, and equal
    # to it for most points of a small cloud
    d2 = ((pts[:, None] - pts[None]) ** 2).sum(-1)
    brute = np.sort(d2, axis=1)[:, 1:4].mean(1)
    assert (d_t >= brute * (1 - 1e-5)).all()
    assert np.mean(np.abs(d_t - brute) < 1e-5 * brute + 1e-9) > 0.5

    cols = rng.uniform(size=(300, 3)).astype(np.float32)
    jm = jgauss.GaussianModel(3, num_class=2, capacity=320)
    jm.create_from_pcd(pts, cols, 2.5)
    tm = tgauss.GaussianModel(3, num_class=2, capacity=320, device="cpu")
    tm.create_from_pcd(pts, cols, 2.5)
    assert tm.spatial_lr_scale == 2.5 and tm.num_alive == jm.num_alive == 300
    _assert_trees_close(tree_np(tm.params), tree_np(jm.params), rtol=1e-5,
                        atol=1e-6)
    np.testing.assert_array_equal(tm.aux.alive.numpy(),
                                  np.asarray(jm.aux.alive))
    np.testing.assert_allclose(tm.get_opacity.numpy(),
                               np.asarray(jm.get_opacity), atol=1e-6)

    for m in (jm, tm):
        m.training_setup()
        m.oneup_sh_degree()
        m.grow_capacity(512)
    assert tm.capacity == 512 and tm.active_sh_degree == jm.active_sh_degree
    _assert_trees_close(tree_np(tm.params), tree_np(jm.params), rtol=1e-5,
                        atol=1e-6)
    for a, b in ((tm.aux, jm.aux), (tm.opt_state.mu, jm.opt_state.mu)):
        for k, v in tree_np(b).items():
            np.testing.assert_array_equal(tree_np(a)[k], v, err_msg=k)
    assert tm.params.xyz.shape == (512, 3) and tm.num_alive == 300


# --- losses ------------------------------------------------------------------

def _depth_inputs(rng, H=24, W=40):
    depth = rng.uniform(0.05, 1.0, (H, W)).astype(np.float32)
    gt = np.round(rng.uniform(0.1, 2.0, (1, H, W)), 3).astype(np.float32)
    return depth, gt


def _jax_draws(choice, key, n, H, W):
    """The numbers the JAX losses draw from ``key``, for the port."""
    def rank(k):
        return {"rank_sample": np.asarray(
            jax.random.randint(k, (1000,), 0, n))}

    def cont(k):
        kw, kh = jax.random.split(k)
        return {"patch_rows": np.asarray(
                    jax.random.randint(kw, (100,), 0, H - 3)),
                "patch_cols": np.asarray(
                    jax.random.randint(kh, (100,), 0, W - 3))}

    if choice == "rank_loss":
        return rank(key)
    if choice == "continue_loss":
        return cont(key)
    if choice == "hybrid_loss":
        k1, k2 = jax.random.split(key)
        return {**cont(k1), **rank(k2)}
    return {}


@pytest.mark.parametrize("choice", ["localrf", "rank_loss", "continue_loss",
                                    "hybrid_loss", "L1_loss"])
def test_depth_losses_match_jax(choice):
    rng = np.random.default_rng(420)
    depth, gt = _depth_inputs(rng)
    if choice in ("continue_loss", "hybrid_loss"):
        # plateaus with small steps, so the 1e-3 continuity mask is not empty
        gt = (np.round(gt, 1) + 5e-4 * rng.integers(0, 3, gt.shape)
              ).astype(np.float32)
    H, W = depth.shape
    key = jax.random.PRNGKey(3)
    jopt, topt = jconfig.OptimizationParams(), tconfig.OptimizationParams()
    val_j, grad_j = jax.value_and_grad(
        lambda d: jL.depth_loss_dispatch(choice, key, d, jnp.asarray(gt),
                                         jopt))(jnp.asarray(depth))
    draws = {k: torch.from_numpy(np.array(v))
             for k, v in _jax_draws(choice, key, H * W, H, W).items()}
    d = torch.from_numpy(depth).requires_grad_(True)
    val_t = tL.depth_loss_dispatch(choice, d, torch.from_numpy(gt), topt,
                                   draws=draws)
    assert float(val_j) > 0.0
    np.testing.assert_allclose(float(val_t.detach()), float(val_j), rtol=2e-5)
    (grad_t,) = torch.autograd.grad(val_t, d)
    scale = np.abs(np.asarray(grad_j)).max()
    np.testing.assert_allclose(grad_t.numpy() / scale,
                               np.asarray(grad_j) / scale, atol=1e-5)

    # without given draws the port draws from a generator: reproducible
    if draws:
        vals = [float(tL.depth_loss_dispatch(
            choice, d.detach(), torch.from_numpy(gt), topt,
            generator=torch.Generator().manual_seed(5))) for _ in range(2)]
        assert vals[0] == vals[1] and np.isfinite(vals[0])
    with pytest.raises(ValueError, match="loss choice"):
        tL.depth_loss_dispatch("nope", d, torch.from_numpy(gt), topt)


def test_image_losses_match_jax():
    rng = np.random.default_rng(430)
    a = rng.uniform(size=(3, 40, 56)).astype(np.float32)
    b = np.clip(a + rng.standard_normal(a.shape) * 0.1, 0, 1).astype(
        np.float32)
    ja, jb, ta, tb = jnp.asarray(a), jnp.asarray(b), torch.from_numpy(a), \
        torch.from_numpy(b)
    for name in ("l1_loss", "l2_loss", "ssim", "psnr"):
        np.testing.assert_allclose(float(getattr(tL, name)(ta, tb)),
                                   float(getattr(jL, name)(ja, jb)),
                                   rtol=1e-5, err_msg=name)
    g_j = np.asarray(jax.grad(lambda x: jL.ssim(x, jb))(ja))
    x = ta.clone().requires_grad_(True)
    (g_t,) = torch.autograd.grad(tL.ssim(x, tb), x)
    np.testing.assert_allclose(g_t.numpy(), g_j, atol=1e-5 * np.abs(g_j).max())

    seg = rng.standard_normal((4, 40, 56)).astype(np.float32)
    lab = rng.integers(0, 4, (40, 56)).astype(np.int32)
    np.testing.assert_allclose(
        float(tL.segment_loss(torch.from_numpy(seg), torch.from_numpy(lab))),
        float(jL.segment_loss(jnp.asarray(seg), jnp.asarray(lab))), rtol=1e-6)


# --- schedules, config -------------------------------------------------------

def test_schedules_and_optimization_params_match_jax():
    jopt, topt = jconfig.OptimizationParams(), tconfig.OptimizationParams()
    assert vars(topt) == vars(jopt)
    jf, tf = jsched.make_lr_fn(jopt, 3.0), tsched.make_lr_fn(topt, 3.0)
    for step in (0, 1, 500, 15_000, 30_000, 40_000):
        assert tf(step) == jf(step)
    for args in ((-1, 1e-2, 1e-4), (10, 0.0, 0.0), (50, 1e-2, 1e-4, 100, 0.1),
                 (5000, 1e-2, 1e-4, 0, 1.0, 10_000)):
        assert tsched.expon_lr(*args) == jsched.expon_lr(*args)


# --- densification -----------------------------------------------------------

def _densify_state(rng, n, capacity):
    p = model_state_np(rng, n=n, capacity=capacity)
    p["scaling"][:n] = np.log(rng.uniform(0.005, 0.08, (n, 3)))
    p["opacity"][:n // 10] = -7.0                   # below min_opacity
    alive = p.pop("alive")
    aux = dict(
        alive=alive,
        max_radii2d=(rng.uniform(0, 40, capacity) * alive).astype(np.float32),
        xyz_gradient_accum=(rng.uniform(0, 1e-3, capacity) * alive).astype(
            np.float32),
        denom=(rng.integers(0, 4, capacity) * alive).astype(np.float32))
    mom = [{k: (rng.standard_normal(p[k].shape) * 1e-3).astype(np.float32)
            for k in PFIELDS} for _ in range(2)]
    mom[1] = {k: v * v for k, v in mom[1].items()}
    return p, aux, mom


@pytest.mark.parametrize("n,capacity,use_screen_size,vs_prune", [
    (150, 512, False, False), (150, 512, True, True), (190, 200, True, False)])
def test_densify_and_prune_matches_jax(n, capacity, use_screen_size, vs_prune):
    rng = np.random.default_rng(440 + capacity)
    p, aux, (mu, nu) = _densify_state(rng, n, capacity)
    key = jax.random.PRNGKey(11)
    k1, k2 = jax.random.split(key)
    noise = np.stack([np.asarray(jax.random.normal(k, (capacity, 3)))
                      for k in (k1, k2)])
    args = (2e-4, 0.005, 3.0, 20.0, 0.01, use_screen_size, vs_prune)

    jstate = jadam.AdamState(jnp.int32(7), _jparams(mu), _jparams(nu))
    jaux = jgauss.GaussianAux(**{k: jnp.asarray(v) for k, v in aux.items()})
    jp, ja, jo, js = jdensify.densify_and_prune(_jparams(p), jaux, jstate,
                                                key, *args)
    tp0 = _tparams(p)
    taux = tgauss.aux_from_numpy(aux, device="cpu")
    tstate = tgauss.adam_state_from_numpy(7, mu, nu, device="cpu")
    before = [x.clone() for x in (*tp0, *taux, *tstate.mu, *tstate.nu)]
    tp, ta, to, ts = tdensify.densify_and_prune(
        tp0, taux, tstate, *args, noise=torch.from_numpy(noise))

    stats_j = {k: int(v) for k, v in js._asdict().items()}
    stats_t = {k: int(v) for k, v in ts._asdict().items()}
    assert stats_t == stats_j
    assert stats_t["n_cloned"] > 0 and stats_t["n_split"] > 0
    assert stats_t["n_pruned"] > 0
    assert (stats_t["n_dropped"] > 0) == (capacity == 200)
    for k, v in tree_np(ja).items():
        np.testing.assert_array_equal(tree_np(ta)[k], v, err_msg=k)
    assert int(ta.alive.sum()) == stats_t["n_alive"]
    # the same rows land in the same slots; exp, log and the rotation of the
    # split samples round differently
    _assert_trees_close(tree_np(tp), tree_np(jp), rtol=1e-5, atol=1e-6)
    for a, b in ((to.mu, jo.mu), (to.nu, jo.nu)):
        for k, v in tree_np(b).items():
            np.testing.assert_array_equal(tree_np(a)[k], v, err_msg=k)
    assert int(to.count) == 7
    # the inputs are left as they were
    for x, y in zip((*tp0, *taux, *tstate.mu, *tstate.nu), before):
        assert torch.equal(x, y)

    # drawn from a generator when no noise is given: reproducible, and the
    # masks do not depend on the draws
    runs = [tdensify.densify_and_prune(
        tp0, taux, tstate, *args,
        generator=torch.Generator().manual_seed(1)) for _ in range(2)]
    assert torch.equal(runs[0][0].xyz, runs[1][0].xyz)
    assert torch.equal(runs[0][1].alive, ta.alive)

    # reset_opacity on the densified state
    jp2, jo2 = jdensify.reset_opacity(jp, ja, jo)
    tp2, to2 = tdensify.reset_opacity(tp, ta, to)
    np.testing.assert_allclose(tp2.opacity.numpy(), np.asarray(jp2.opacity),
                               rtol=1e-5, atol=1e-5)
    live = ta.alive.numpy()
    assert torch.sigmoid(tp2.opacity).numpy()[live].max() <= 0.01 + 1e-6
    assert float(to2.mu.opacity.abs().max()) == 0.0 == float(
        to2.nu.opacity.abs().max())
    np.testing.assert_array_equal(to2.mu.xyz.numpy(), np.asarray(jo2.mu.xyz))


def test_add_densification_stats_matches_jax():
    rng = np.random.default_rng(450)
    C = 64
    aux = dict(alive=rng.uniform(size=C) < 0.8,
               max_radii2d=rng.uniform(0, 9, C).astype(np.float32),
               xyz_gradient_accum=rng.uniform(0, 1, C).astype(np.float32),
               denom=rng.integers(0, 5, C).astype(np.float32))
    g = rng.standard_normal((C, 2)).astype(np.float32)
    radii = (rng.integers(0, 12, C) * (rng.uniform(size=C) < 0.6)).astype(
        np.int32)
    ja = jdensify.add_densification_stats(
        jgauss.GaussianAux(**{k: jnp.asarray(v) for k, v in aux.items()}),
        jnp.asarray(g), jnp.asarray(radii))
    ta = tdensify.add_densification_stats(
        tgauss.aux_from_numpy(aux, device="cpu"), torch.from_numpy(g),
        torch.from_numpy(radii))
    _assert_trees_close(tree_np(ta), tree_np(ja), rtol=1e-6)


# --- one train step from a shared state --------------------------------------

W, H, N_LIVE, CAP = 64, 32, 150, 192
BG = np.array([0.1, 0.3, 0.2], np.float32)


@pytest.fixture(scope="module")
def shared_step():
    """One JAX train step (compiled once) and the port's, both from one
    state with dead rows and warm Adam moments."""
    return step_from_warm_state(460, W, H, N_LIVE, CAP, BG)


def test_train_step_matches_jax(shared_step):
    s = shared_step
    (jp, jo, ja, jm), (tp, to, ta, tm) = s["jout"], s["tout"]
    for k in ("num_rendered", "num_padded", "n_visible"):
        assert int(tm[k]) == int(jm[k]), k
    assert int(tm["num_rendered"]) > 100 and not bool(tm["overflow"])
    for k in ("loss", "l1", "depth_loss", "seg_loss"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=2e-5,
                                   err_msg=k)
        assert float(tm[k]) > 0.0
    assert int(to.count) == int(jo.count) == 101

    dead = ~s["alive"]
    for k in PFIELDS:
        gmax, lr = s["gmax"][k], s["lrs"][k]
        assert gmax > 0.0, k
        mu_t, mu_j = getattr(to.mu, k).numpy(), np.asarray(getattr(jo.mu, k))
        # mu = 0.9 mu + 0.1 g: the gradient tests' scaled tolerance (1e-3 of
        # the group's largest gradient) through the factor 0.1
        np.testing.assert_allclose(mu_t, mu_j, rtol=0, atol=1e-4 * gmax,
                                   err_msg=f"mu.{k}")
        # nu = 0.999 nu + 0.001 g^2: d(g^2) <= 2 gmax * 1e-3 gmax
        np.testing.assert_allclose(getattr(to.nu, k).numpy(),
                                   np.asarray(getattr(jo.nu, k)),
                                   rtol=1e-6, atol=2e-6 * gmax ** 2,
                                   err_msg=f"nu.{k}")
        # the update is lr * mhat / sqrt(vhat) with sqrt(vhat) ~ 3 gmax, so
        # a gradient error of 1e-3 gmax moves a parameter by ~3e-5 lr
        p_t, p_j = getattr(tp, k).numpy(), np.asarray(getattr(jp, k))
        np.testing.assert_allclose(p_t, p_j, rtol=1e-6, atol=1e-4 * lr,
                                   err_msg=f"params.{k}")
        # dead rows: finite, untouched, no moment
        assert np.isfinite(p_t).all() and np.isfinite(mu_t).all(), k
        np.testing.assert_array_equal(p_t[dead],
                                      getattr(s["tin"][0], k).numpy()[dead])
        assert np.abs(mu_t[dead]).max() == 0.0, k

    for k in ("alive", "denom", "max_radii2d"):
        np.testing.assert_array_equal(getattr(ta, k).numpy(),
                                      np.asarray(getattr(ja, k)), err_msg=k)
    acc_j = np.asarray(ja.xyz_gradient_accum)
    np.testing.assert_allclose(ta.xyz_gradient_accum.numpy(), acc_j,
                               atol=1e-3 * np.abs(acc_j).max())
    assert float(ta.denom.max()) == 2.0      # two steps of statistics
    # the step left its inputs as they were
    assert int(s["tin"][1].count) == 100
    np.testing.assert_array_equal(s["tin"][1].mu.xyz.numpy(), s["mu_in"]["xyz"])


def test_overflowing_step_leaves_state_unchanged(shared_step):
    s = shared_step
    cfg = RasterizeConfig(width=W, height=H, num_class=2, max_instances=128)
    step = ttrainer.make_train_step(cfg, s["topt"], 3, "L1_loss", True, BG,
                                    device="cpu")
    params, opt_state, aux = s["tin"]
    p2, o2, a2, m = step(params, opt_state, aux, s["tbatch"], s["lrs"])
    assert bool(m["overflow"]) and int(m["num_padded"]) > 128
    assert int(o2.count) == int(opt_state.count) == 100
    for new, old in ((p2, params), (o2.mu, opt_state.mu),
                     (o2.nu, opt_state.nu), (a2, aux)):
        for k in old._fields:
            assert torch.equal(getattr(new, k), getattr(old, k)), k
    # gate_on_overflow itself, both ways
    new = tuple(x + 1 for x in params)
    kept = ttrainer.gate_on_overflow(torch.tensor(True), new, tuple(params))
    taken = ttrainer.gate_on_overflow(torch.tensor(False), new, tuple(params))
    assert torch.equal(kept[0], params.xyz) and torch.equal(taken[0], new[0])


def test_synthetic_fit_loss_falls():
    """30 steps from perturbed parameters toward the unperturbed render."""
    from gsplat_tpu_torch import renderer
    rng = np.random.default_rng(470)
    Wf, Hf, n = 32, 32, 80
    p = model_state_np(rng, n=n, capacity=96)
    truth = tgauss.params_from_numpy(p, device="cpu", num_class=2)
    cam = make_camera(Wf, Hf)
    tgt = renderer.render(cam, truth, max_instances=1 << 12, device="cpu")
    batch = ttrainer.camera_batch(
        cam, gt_depth=tgt["depth_raw"][None],
        gt_seg=torch.argmax(tgt["segment"], dim=0), device="cpu")
    batch["gt_image"] = tgt["render"]
    for k, s in (("xyz", 0.03), ("features_dc", 0.3), ("opacity", 0.5),
                 ("scaling", 0.2), ("segment", 0.5)):
        p[k][:n] += rng.standard_normal(p[k][:n].shape).astype(np.float32) * s
    m = tgauss.params_from_numpy(p, device="cpu", num_class=2)
    m.training_setup()
    opt = tconfig.OptimizationParams()
    opt.lambda_depth = 1e-7        # uncovered pixels: see chip_smoke.py
    cfg = RasterizeConfig(width=Wf, height=Hf, num_class=2,
                          max_instances=1 << 12)
    step = ttrainer.make_train_step(cfg, opt, 3, "L1_loss", True,
                                    np.zeros(3, np.float32), device="cpu")
    lr_fn = tsched.make_lr_fn(opt, 5.0)
    state = (m.params, m.opt_state, m.aux)
    losses = []
    for it in range(1, 31):
        *state, metrics = step(*state, batch, lr_fn(it))
        losses.append(float(metrics["loss"]))
    assert np.isfinite(losses).all()
    assert losses[-1] < 0.7 * losses[0], losses
    assert int(state[1].count) == 30 and float(state[2].denom.max()) == 30.0
