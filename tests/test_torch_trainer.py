"""The port's ``Trainer`` on the CPU: capacity autosizing and management
against the JAX ``Trainer``'s methods on the same scene and model, a short
exact-cull run whose loss falls and whose densification fires, and an
undersized capacity that regrows (``make_synthetic_scene.make_scene``'s
scene written with the port, ``torch_helpers.make_scene_port``: 48x48,
150 gaussians, 6 cameras)."""
import json

import numpy as np

from gsplat_tpu.train.trainer import Trainer as JTrainer
from gsplat_tpu_torch.models import gaussians as tgauss
from gsplat_tpu_torch.train.trainer import Trainer as TTrainer

from torch_helpers import (SCENE_CLASSES, RecordSteps, model_pair,  # noqa: F401
                           port_opt, scene_dir, scenes)


def test_autosize_capacity_matches_jax(scenes):
    """On the scene's own model both size to the 2^18 floor; on a dense
    random cloud (120,000 gaussians) the measured demand decides, with the
    exact-cull row term, and both packages size alike."""
    js, ts = scenes
    jt = JTrainer(js.gaussians, js, port_opt(), cull="exact", use_seg=True)
    tt = TTrainer(ts.gaussians, ts, port_opt(), cull="exact", use_seg=True)
    assert tt.max_instances == jt.max_instances
    jt._autosize_capacity(js.getTrainCameras())
    tt._autosize_capacity(ts.getTrainCameras())
    assert tt.max_instances == jt.max_instances == 1 << 18

    jm, tm = model_pair(np.random.default_rng(92), capacity=1 << 17,
                        n=120_000)
    jt = JTrainer(jm, js, port_opt(), cull="exact")
    tt = TTrainer(tm, ts, port_opt(), cull="exact")
    jt._autosize_capacity(js.getTrainCameras())
    tt._autosize_capacity(ts.getTrainCameras())
    assert tt.max_instances == jt.max_instances > 1 << 18


def test_manage_capacity_matches_jax(scenes):
    """The same (iteration, padded demand, overflow) table through both
    methods gives the same capacities; the JAX trainer has no background
    compile pending (``_pending`` empty, ``_example_args`` None)."""
    js, ts = scenes
    jt = JTrainer(js.gaussians, js, port_opt(), max_instances=1 << 19)
    tt = TTrainer(ts.gaussians, ts, port_opt(), max_instances=1 << 19)
    assert not jt._pending and jt._example_args is None
    table = [
        (1, 100_000, False),       # low but within the shrink cooldown
        (150, 400_000, False),     # 0.72-0.9 band: no change
        (210, 480_000, False),     # above 90%: grow to 1.35x
        (220, 500_000, True),      # overflow: at least double
        (430, 100_000, False),     # shrink after the 200-iteration cooldown
        (440, 0, False),           # at the 2^18 floor: no shrink
        (450, 300_000, True),      # overflow again
        (700, 10_000, False),      # shrink...
        (900, 10_000, False),      # ...not within 500 of a reset
        (1500, 10_000, False),
    ]
    seq_j, seq_t = [], []
    for it, npad, ov in table:
        if it == 700:
            jt._reset_iter = tt._reset_iter = 650
        jt._manage_capacity(it, npad, ov)
        tt._manage_capacity(it, npad, ov)
        seq_j.append(jt.max_instances)
        seq_t.append(tt.max_instances)
    assert seq_t == seq_j
    assert len(set(seq_t)) >= 4 and not jt._pending


def test_trainer_exact_cull_trains_and_densifies(scenes, tmp_path):
    _, ts = scenes
    m = tgauss.GaussianModel(3, num_class=SCENE_CLASSES, capacity=1024,
                             device="cpu")
    pcd = ts.scene_info.point_cloud
    m.create_from_pcd(pcd.points, pcd.colors, ts.cameras_extent)
    m.training_setup()
    opt = port_opt(densify_from_iter=10, densification_interval=10,
               densify_until_iter=24, densify_grad_threshold=2e-5,
               opacity_reset_interval=1000, position_lr_max_steps=24)
    tr = TTrainer(m, ts, opt, cull="exact", use_seg=True, seed=3,
                  max_instances=1 << 14, model_path=str(tmp_path))
    rec = RecordSteps()
    tr.train(24, log_every=1, callback=rec, test_iterations={24})
    losses = [r[1] for r in rec.rows]
    assert len(losses) == 24 and np.isfinite(losses).all()
    assert np.mean(losses[-5:]) < 0.9 * np.mean(losses[:5])
    assert not any(r[2] for r in rec.rows)
    assert tr.last_densify["iter"] == 20
    assert m.num_alive > 150 and tr.last_densify["n_dropped"] == 0
    with open(tmp_path / "eval_log.jsonl") as f:
        recs = [json.loads(x) for x in f]
    assert [r["split"] for r in recs] == ["test", "train"]


def test_trainer_undersized_capacity_regrows(scenes):
    _, ts = scenes
    m = tgauss.GaussianModel(3, num_class=SCENE_CLASSES, capacity=512,
                             device="cpu")
    pcd = ts.scene_info.point_cloud
    m.create_from_pcd(pcd.points, pcd.colors, ts.cameras_extent)
    m.training_setup()
    tr = TTrainer(m, ts, port_opt(), max_instances=128)
    rec = RecordSteps()
    tr.train(6, log_every=1, callback=rec)
    assert rec.rows[0][2] and rec.rows[0][3] == 128     # overflowed
    assert tr.max_instances == 1 << 18                  # regrown (floor)
    assert not rec.rows[-1][2]
    # an overflowing step leaves the state as it was: only the steps after
    # the regrow count
    assert int(m.opt_state.count) == sum(not r[2] for r in rec.rows)
