"""The training command line of the port on the CPU: its parser against
the JAX CLI's, what it refuses, the ``Trainer``'s STOP file, and
``scripts/train.py`` end to end with exact cull on
``make_synthetic_scene.make_scene``'s NeRFstudio scene, written with the
port (``torch_helpers.make_scene_port``: 48x48, 150 gaussians, 6
cameras), writing the files the JAX CLI writes."""
import argparse
import json
import os

import numpy as np
import pytest

from gsplat_tpu.scripts import train as jtrain
from gsplat_tpu_torch import config as tconfig
from gsplat_tpu_torch.data import ply as tply
from gsplat_tpu_torch.models import gaussians as tgauss
from gsplat_tpu_torch.scripts import train as ttrain
from gsplat_tpu_torch.train.trainer import Trainer as TTrainer

from torch_helpers import (SCENE_CLASSES, RecordSteps, port_opt,  # noqa: F401
                           scene_dir, scenes)


def _jax_parse(argv):
    """The namespace the JAX CLI's own parser makes of ``argv``."""
    seen = {}

    class Stop(Exception):
        pass

    class Parser(argparse.ArgumentParser):
        def parse_args(self, args=None, namespace=None):
            seen["ns"] = super().parse_args(args, namespace)
            raise Stop

    orig = jtrain.ArgumentParser
    jtrain.ArgumentParser = Parser
    try:
        with pytest.raises(Stop):
            jtrain.main(argv)
    finally:
        jtrain.ArgumentParser = orig
    return seen["ns"]


def test_parser_matches_jax():
    argv = ["-s", "data", "-m", "out", "--cull", "exact", "-r", "2",
            "--eval", "--iterations", "100", "--test_iterations", "5", "10",
            "--densify_grad_threshold", "0.001", "--using_depth"]
    j = vars(_jax_parse(argv))
    t = vars(ttrain.build_parser()[0].parse_args(argv))
    assert set(t) == set(j)
    stated = {"data_device": ("cuda", "tpu")}
    for k in j:
        if k in stated:
            assert (t[k], j[k]) == stated[k], k
        else:
            assert t[k] == j[k], k
    assert t["cull"] == "exact" and t["resolution"] == 2


def test_unported_options_raise(scenes, tmp_path):
    _, ts = scenes
    m = ts.gaussians
    for kw in (dict(data_parallel=2), dict(tile_parallel=2)):
        with pytest.raises(NotImplementedError, match="item 7"):
            TTrainer(m, ts, port_opt(), **kw)
    base = ["-s", "x", "-m", str(tmp_path / "o"), "--data_device", "cpu"]
    with pytest.raises(NotImplementedError, match="item 7"):
        ttrain.main(base + ["--multihost"])
    assert not (tmp_path / "o").exists()     # refused before writing


def test_trainer_stop_file(scenes, tmp_path):
    _, ts = scenes
    m = tgauss.GaussianModel(3, num_class=SCENE_CLASSES, capacity=512,
                             device="cpu")
    pcd = ts.scene_info.point_cloud
    m.create_from_pcd(pcd.points, pcd.colors, ts.cameras_extent)
    m.training_setup()
    ts_model_path = ts.model_path
    ts.model_path = str(tmp_path)
    try:
        (tmp_path / "STOP").write_text("")
        tr = TTrainer(m, ts, port_opt(), max_instances=1 << 14,
                      model_path=str(tmp_path))
        rec = RecordSteps()
        tr.train(50, log_every=5, callback=rec)
    finally:
        ts.model_path = ts_model_path
    assert [r[0] for r in rec.rows] == [5]
    assert int(m.opt_state.count) == 5
    assert (tmp_path / "chkpnt5.npz").exists()
    assert (tmp_path / "point_cloud" / "iteration_5" / "point_cloud.ply"
            ).exists()


def test_cli_trains_with_exact_cull(scene_dir, tmp_path, monkeypatch):
    out = str(tmp_path / "out")
    ttrain.main([
        "-s", scene_dir, "-m", out, "--data_device", "cpu", "--cull", "exact",
        "--disable_gui_server", "--iterations_override", "20",
        "--test_iterations", "20", "--checkpoint_iterations", "20",
        "--capacity", "1024", "--max_instances", "16384",
        "--densify_from_iter", "5", "--densification_interval", "5",
        "--densify_until_iter", "20", "--densify_grad_threshold", "2e-5", "--eval", "--using_seg",
        "--num_class", str(SCENE_CLASSES)])
    # the files the JAX CLI writes for the same arguments
    for f in ("cfg_args", "input.ply", "cameras.json", "train_log.jsonl",
              "eval_log.jsonl", "chkpnt20.npz",
              os.path.join("point_cloud", "iteration_20", "point_cloud.ply")):
        assert os.path.exists(os.path.join(out, f)), f
    with open(os.path.join(out, "cfg_args")) as f:
        cfg = eval(f.read(), {"Namespace": argparse.Namespace})
    assert cfg.cull == "exact" and cfg.data_device == "cpu"
    with open(os.path.join(out, "train_log.jsonl")) as f:
        log = [json.loads(x) for x in f]
    assert [r["iter"] for r in log] == [10, 20]
    assert all(np.isfinite(r["loss"]) and "overflow" not in r for r in log)
    assert log[-1]["n_alive"] > 150                     # densify fired
    ply = tply.read_ply(os.path.join(out, "point_cloud", "iteration_20",
                                     "point_cloud.ply"))
    assert len(ply["x"]) == log[-1]["n_alive"]

    # a later command line reads the saved cfg_args back
    # (get_combined_args; flags registered as None take the saved values)
    parser = argparse.ArgumentParser()
    tconfig.ModelParams(parser, sentinel=True)
    monkeypatch.setattr("sys.argv", ["render", "-m", out])
    merged = tconfig.get_combined_args(parser)
    assert (merged.data_device, merged.source_path, merged.num_class) == \
        ("cpu", scene_dir, SCENE_CLASSES)
